"""The median request latency over every request of the window (host clock):
a statistic that a few slow requests move less than ``solve_s``."""
import numpy as np


def read(run):
    lat = [r["latency_s"] for r in run.requests]
    return float(np.percentile(lat, 50)) if lat else None
