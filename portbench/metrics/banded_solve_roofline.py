"""The block-tridiagonal solve kernel's share of its roofline, in %: the least
time the chip could take for every solve of the traced requests (one
right-hand side of the family's k x b) over the kernel's device time in the
trace."""
from portbench.roofline import banded_solve, peaks

KERNEL = r"\bsolve_kernel\b"
OTHER = r"Ring"              # the tridiagonal library's kernel of the same name


def read(run):
    k = (run.shapes or {}).get("banded_k")
    if run.trace is None or not k:
        return None
    launches = sum(r["launches"].get("banded_solve", 0) for r in run.traced)
    device_s, n = run.trace.device_seconds(KERNEL, exclude=OTHER)
    if launches == 0 or n != launches or device_s <= 0:
        return None
    ops, nbytes = banded_solve.block_tridiagonal_solve(k, run.shapes["banded_b"],
                                                       peaks.ITEMSIZE[run.dtype])
    return 100.0 * launches * peaks.bound_s(ops, nbytes, run.dtype) / device_s
