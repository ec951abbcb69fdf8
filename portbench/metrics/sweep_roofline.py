"""The sweep kernels' share of their roofline, in %: the least time the chip
could take for the forward (L and D) and backward (L') sweeps of every solve
in the traced requests, over the fronts that the family's own elimination of
the pattern needs, over the device time of every sweep kernel in the trace
(forward and backward, small fronts, wavefront and accumulation)."""
from portbench.roofline import counts, peaks

KERNELS = r"\bsweep_(fwd_small|bwd_small|wave|accumulate)\b"


def read(run):
    fronts = (run.shapes or {}).get("fronts")
    per = (run.calls or {}).get("sweep")
    if run.trace is None or fronts is None or not per:
        return None
    fwd = sum(r["launches"].get("sweep_fwd", 0) for r in run.traced)
    bwd = sum(r["launches"].get("sweep_bwd", 0) for r in run.traced)
    if fwd == 0 or fwd != bwd or fwd % per:
        return None
    itemsize = peaks.ITEMSIZE[run.dtype]
    bound = sum(peaks.bound_s(*counts.triangular_sweeps(
        fronts["nc"], fronts["nf"], run.shapes["rhs_rows"], itemsize, direction), run.dtype)
        for direction in ("fwd", "bwd"))
    device_s, _ = run.trace.device_seconds(KERNELS)
    return 100.0 * (fwd // per) * bound / device_s if device_s > 0 else None
