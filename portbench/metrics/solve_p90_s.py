"""The 90th percentile of request latency over every request of the window
(host clock; numpy's linear interpolation)."""
import numpy as np


def read(run):
    lat = [r["latency_s"] for r in run.requests]
    return float(np.percentile(lat, 90)) if lat else None
