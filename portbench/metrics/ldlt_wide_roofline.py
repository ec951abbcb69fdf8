"""The wide-front factor kernel's share of its roofline, in %: the least time
the chip could take for the partial LDL' of every front of more than
``WIDE_ROWS`` rows that the family's own elimination of the pattern needs,
once per factorization of the traced requests, over the kernel's device time
in the trace."""
from portbench.roofline import counts, peaks

KERNEL = r"\bldlt_wide_kernel\b"
WIDE_ROWS = 128          # the fronts that the wide kernel is there for


def read(run):
    fronts = (run.shapes or {}).get("fronts")
    per = (run.calls or {}).get("ldlt_wide")
    if run.trace is None or fronts is None or not per:
        return None
    launches = sum(r["launches"].get("ldlt_wide", 0) for r in run.traced)
    if launches == 0 or launches % per:
        return None
    wide = fronts["nf"] > WIDE_ROWS
    ops, nbytes = counts.partial_ldlt(fronts["nc"][wide], fronts["nf"][wide],
                                      peaks.ITEMSIZE[run.dtype])
    bound = launches // per * peaks.bound_s(ops, nbytes, run.dtype)
    device_s, n = run.trace.device_seconds(KERNEL)
    if n != launches or device_s <= 0:
        return None
    return 100.0 * bound / device_s
