"""The block-tridiagonal factor kernel's share of its roofline, in %: the least
time the chip could take for every factorization of the traced requests over
the kernel's device time in the trace."""
from portbench.roofline import counts, peaks

KERNEL = r"\bfactor_kernel\b"
OTHER = r"Ring"              # the tridiagonal library's kernel of the same name


def read(run):
    k = (run.shapes or {}).get("banded_k")
    if run.trace is None or not k:
        return None
    launches = sum(r["launches"].get("banded_factor", 0) for r in run.traced)
    device_s, n = run.trace.device_seconds(KERNEL, exclude=OTHER)
    if launches == 0 or n != launches or device_s <= 0:
        return None
    ops, nbytes = counts.block_tridiagonal_cholesky(k, run.shapes["banded_b"],
                                                    peaks.ITEMSIZE[run.dtype])
    return 100.0 * launches * peaks.bound_s(ops, nbytes, run.dtype) / device_s
