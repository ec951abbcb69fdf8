"""The scalar tridiagonal LDL^T factor and solve kernels: their wrappers,
launch counts and bounds.

The CUDA source is ``csrc/tridiag.cu``, built by ``nvcc`` and bound with
``ctypes`` at the first call on a CUDA tensor (see ``_cuda_build.py``);
importing this module needs no card.  The plain versions are
``linalg/cholesky.py::tridiag_factor_plain`` and ``tridiag_solve_plain``;
they count their calls here (:func:`count_plain`), so that a run on the
card can show that it did not take them.  The wrappers take CUDA tensors
only: they launch the kernel on the current stream (and count the launch)
or raise.
"""
from __future__ import annotations

import ctypes

import torch

from .ldlt_kernels import H100_BYTES_PER_S, H100_FLOPS, _launch

_counts = dict(factor=0, solve=0, factor_plain=0, solve_plain=0)


def tridiag_counts() -> dict:
    """Launches of the factor and solve kernels (``factor``, ``solve``) and
    calls of their plain versions (``factor_plain``, ``solve_plain``)."""
    return dict(_counts)


def reset_tridiag_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def count_plain(which: str) -> None:
    _counts[which + "_plain"] += 1


_PTR = ctypes.c_void_p


def _library():
    from ._cuda_build import load_cuda_library

    lib = load_cuda_library("tridiag.cu")
    if not getattr(lib, "_typed", False):
        for fn in (lib.tridiag_factor_f32, lib.tridiag_factor_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, ctypes.c_longlong, ctypes.c_longlong, _PTR]
            fn.restype = ctypes.c_int
        for fn in (lib.tridiag_solve_f32, lib.tridiag_solve_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, ctypes.c_longlong, ctypes.c_longlong, _PTR]
            fn.restype = ctypes.c_int
        lib.tridiag_error_string.argtypes = [ctypes.c_int]
        lib.tridiag_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}): the plain version "
                         f"takes CPU tensors")
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name} must have {like.dtype} on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _systems(d: torch.Tensor):
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the tridiagonal kernels take float32/float64, got {d.dtype}")
    if d.dim() < 1 or d.shape[-1] < 1:
        raise ValueError(f"the tridiagonal kernels need k >= 1, got shape {tuple(d.shape)}")
    k = d.shape[-1]
    return d.numel() // k, k


def tridiag_factor(d: torch.Tensor, e: torch.Tensor):
    """(dhat, l) of the LDL' factorization of the tridiagonal matrices with
    diagonal ``d (..., k)`` and subdiagonal ``e (..., k-1)``: one launch on
    the current stream, one thread per system."""
    B, k = _systems(d)
    _check("d", d, d.shape, d)
    _check("e", e, tuple(d.shape[:-1]) + (k - 1,), d)
    d, e = d.contiguous(), e.contiguous()
    dhat = torch.empty_like(d)
    l = torch.empty_like(e)
    if B:
        lib = _library()
        fn = lib.tridiag_factor_f64 if d.dtype == torch.float64 else lib.tridiag_factor_f32
        _launch("tridiag_factor", fn, lib.tridiag_error_string, d.device,
                d.data_ptr(), e.data_ptr(), dhat.data_ptr(), l.data_ptr(), B, k)
        _counts["factor"] += 1
    return dhat, l


def tridiag_solve(dhat: torch.Tensor, l: torch.Tensor, b: torch.Tensor):
    """x with L diag(dhat) L' x = b for the factors of :func:`tridiag_factor`;
    ``b`` has the shape of ``dhat``: one launch, one thread per system."""
    B, k = _systems(dhat)
    _check("dhat", dhat, dhat.shape, dhat)
    _check("l", l, tuple(dhat.shape[:-1]) + (k - 1,), dhat)
    _check("b", b, dhat.shape, dhat)
    dhat, l, b = dhat.contiguous(), l.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    if B:
        lib = _library()
        fn = lib.tridiag_solve_f64 if dhat.dtype == torch.float64 else lib.tridiag_solve_f32
        _launch("tridiag_solve", fn, lib.tridiag_error_string, dhat.device,
                dhat.data_ptr(), l.data_ptr(), b.data_ptr(), x.data_ptr(), B, k)
        _counts["solve"] += 1
    return x


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


def factor_bound_terms(B: int, k: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one factorization
    of B systems of order k on an H100 SXM: d and e read once, dhat and l
    written once; a division, a product and a difference per step."""
    size = torch.finfo(dtype).bits // 8
    nbytes = 2.0 * B * (2 * k - 1) * size
    ops = 3.0 * B * (k - 1)
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def solve_bound_terms(B: int, k: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one solve: dhat,
    l and b read once, x written once; two products and two differences per
    step of the two sweeps and a division per row."""
    size = torch.finfo(dtype).bits // 8
    nbytes = B * (4 * k - 1) * size
    ops = B * (4.0 * (k - 1) + k)
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]
