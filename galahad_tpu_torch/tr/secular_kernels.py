"""The secular Newton kernels of TRS and RQS: their wrappers, launch counts
and bounds.

The CUDA source is ``csrc/secular.cu``, built by ``nvcc`` and bound with
``ctypes`` at the first call on a CUDA tensor (see
``linalg/_cuda_build.py``); importing this module needs no card.  The plain
versions are ``tr/trs.py::secular_newton_plain`` and ``rqs_newton_plain``;
they count their calls here (:func:`count_plain`).  The wrappers take CUDA
tensors only: they launch the kernel on the current stream (and count the
launch) or raise.
"""
from __future__ import annotations

import ctypes

import torch

from ..linalg.ldlt_kernels import H100_BYTES_PER_S, H100_FLOPS, _launch

_counts = dict(trs=0, rqs=0, trs_plain=0, rqs_plain=0)


def secular_counts() -> dict:
    """Launches of the TRS and RQS kernels (``trs``, ``rqs``) and calls of
    their plain versions (``trs_plain``, ``rqs_plain``)."""
    return dict(_counts)


def reset_secular_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def count_plain(which: str) -> None:
    _counts[which + "_plain"] += 1


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _library():
    from ..linalg._cuda_build import load_cuda_library

    lib = load_cuda_library("secular.cu")
    if not getattr(lib, "_typed", False):
        for fn in (lib.trs_secular_newton_f32, lib.trs_secular_newton_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR]
            fn.restype = _INT
        for fn in (lib.rqs_secular_newton_f32, lib.rqs_secular_newton_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT,
                           ctypes.c_double, _INT, _PTR]
            fn.restype = _INT
        lib.secular_error_string.argtypes = [_INT]
        lib.secular_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _flat(name: str, t: torch.Tensor, shape, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``t`` broadcast to ``shape``, contiguous, checked to lie on ``like``'s
    CUDA device with ``dtype`` (default ``like``'s)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}): the plain version "
                         f"takes CPU tensors")
    if t.device != like.device or t.dtype != (dtype or like.dtype):
        raise ValueError(f"{name} must have {dtype or like.dtype} on {like.device}")
    return t.expand(shape).contiguous()


def _problems(lam: torch.Tensor):
    if lam.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the secular kernels take float32/float64, got {lam.dtype}")
    if lam.dim() < 1 or lam.shape[-1] < 1:
        raise ValueError(f"the secular kernels need n >= 1, got shape {tuple(lam.shape)}")
    n = lam.shape[-1]
    return lam.shape[:-1], lam.numel() // n, n


def trs_secular_newton(lam, ct2, radius, lam_lo, max_its: int) -> torch.Tensor:
    """s (...) of the TRS's secular Newton iteration (see
    ``tr/trs.py::secular_newton_plain``) on ``lam``, ``ct2`` (..., n),
    ``radius`` and ``lam_lo`` (broadcast to the batch): one launch, one warp
    per problem."""
    bshape, B, n = _problems(lam)
    lam = _flat("lam", lam, lam.shape, lam)
    ct2 = _flat("ct2", ct2, lam.shape, lam)
    radius = _flat("radius", radius, bshape, lam)
    lam_lo = _flat("lam_lo", lam_lo, bshape, lam)
    out = torch.empty(bshape, dtype=lam.dtype, device=lam.device)
    if B:
        lib = _library()
        fn = lib.trs_secular_newton_f64 if lam.dtype == torch.float64 \
            else lib.trs_secular_newton_f32
        _launch("trs_secular_newton", fn, lib.secular_error_string, lam.device,
                lam.data_ptr(), ct2.data_ptr(), radius.data_ptr(), lam_lo.data_ptr(),
                out.data_ptr(), B, n, int(max_its))
        _counts["trs"] += 1
    return out


def rqs_secular_newton(lam, ct2, excl, sigma, p: float, lam_lo, hi0,
                       max_its: int) -> torch.Tensor:
    """s (...) of RQS's bracket growth and Newton iteration (see
    ``tr/trs.py::rqs_newton_plain``): ``excl`` (..., n) bool marks the
    entries left out of the norm; ``sigma``, ``lam_lo`` and ``hi0`` are
    broadcast to the batch.  One launch, one warp per problem."""
    bshape, B, n = _problems(lam)
    lam = _flat("lam", lam, lam.shape, lam)
    ct2 = _flat("ct2", ct2, lam.shape, lam)
    excl = _flat("excl", excl, lam.shape, lam, dtype=torch.bool).view(torch.uint8)
    sigma = _flat("sigma", sigma, bshape, lam)
    lam_lo = _flat("lam_lo", lam_lo, bshape, lam)
    hi0 = _flat("hi0", hi0, bshape, lam)
    out = torch.empty(bshape, dtype=lam.dtype, device=lam.device)
    if B:
        lib = _library()
        fn = lib.rqs_secular_newton_f64 if lam.dtype == torch.float64 \
            else lib.rqs_secular_newton_f32
        _launch("rqs_secular_newton", fn, lib.secular_error_string, lam.device,
                lam.data_ptr(), ct2.data_ptr(), excl.data_ptr(), sigma.data_ptr(),
                lam_lo.data_ptr(), hi0.data_ptr(), out.data_ptr(), B, n, float(p) - 2.0,
                int(max_its))
        _counts["rqs"] += 1
    return out


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------

OPS_PER_ENTRY = 7        # lam + s, its square and cube, two divisions, two adds


def trs_bound_terms(B: int, n: int, max_its: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one TRS call on
    an H100 SXM.  Bytes: lam and ct2 read once, radius and lam_lo read and s
    written once.  Operations: the first sum of ct2, then per iteration and
    entry ``OPS_PER_ENTRY`` (a division counted as one operation)."""
    size = torch.finfo(dtype).bits // 8
    nbytes = (2.0 * B * n + 3.0 * B) * size
    ops = B * n * (1.0 + OPS_PER_ENTRY * max_its)
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def rqs_bound_terms(B: int, n: int, evaluations: int, dtype: torch.dtype):
    """The same for one RQS call whose problems evaluate theta
    ``evaluations`` times in all (the growth rounds this run's data needs,
    plus the Newton iterations): lam, ct2, the mask and three scalars per
    problem read once, s written once; ``OPS_PER_ENTRY`` + 2 (the mask's two
    selects) per entry and evaluation."""
    size = torch.finfo(dtype).bits // 8
    nbytes = 2.0 * B * n * size + B * n + 4.0 * B * size
    ops = float(evaluations) * n * (OPS_PER_ENTRY + 2)
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]
