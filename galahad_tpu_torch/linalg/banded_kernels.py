"""The block-tridiagonal factor and solve kernels: their wrappers, launch
counts and bounds.

The CUDA source is ``csrc/banded.cu``, built by ``nvcc`` and bound with
``ctypes`` at the first call on a CUDA tensor (see ``_cuda_build.py``);
importing this module needs no card.  The plain versions of both kernels are
``linalg/banded.py::block_tridiag_cholesky_plain`` and
``block_tridiag_solve_plain``; they count their calls here
(:func:`count_plain`), so that a run on the card can show that it did not
take them.  The wrappers here take CUDA tensors only: they launch the kernel
on the current stream (and count the launch) or raise.
"""
from __future__ import annotations

import ctypes

import torch

from .ldlt_kernels import H100_BYTES_PER_S, H100_FLOPS, _launch

MAX_BLOCK = 32           # blocks of 1..32: a lane of the kernels' warp per row

_counts = dict(factor=0, solve=0, factor_plain=0, solve_plain=0)


def banded_counts() -> dict:
    """Launches of the factor and solve kernels (``factor``, ``solve``) and
    calls of their plain versions (``factor_plain``, ``solve_plain``: 0 on a
    path that runs on the card)."""
    return dict(_counts)


def reset_banded_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def count_plain(which: str) -> None:
    _counts[which + "_plain"] += 1


_PTR = ctypes.c_void_p


def _library():
    from ._cuda_build import load_cuda_library

    lib = load_cuda_library("banded.cu")
    if not getattr(lib, "_typed", False):
        for fn in (lib.banded_factor_f32, lib.banded_factor_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int, _PTR]
            fn.restype = ctypes.c_int
        for fn in (lib.banded_solve_f32, lib.banded_solve_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           _PTR]
            fn.restype = ctypes.c_int
        lib.banded_error_string.argtypes = [ctypes.c_int]
        lib.banded_error_string.restype = ctypes.c_char_p
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
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_blocks(k: int, b: int, dtype) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the block-tridiagonal kernels take float32/float64, got {dtype}")
    if k < 1:
        raise ValueError("the block-tridiagonal kernels need at least one block row")
    if not 1 <= b <= MAX_BLOCK:
        raise ValueError(f"the block-tridiagonal kernels take blocks of 1..{MAX_BLOCK}, got {b}")


def block_tridiag_factor(D: torch.Tensor, L: torch.Tensor):
    """(Ld, Lo, ok) of the block Cholesky factorization of (D (k, b, b),
    L (k-1, b, b)): one launch of the factor kernel on the current stream."""
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"D must be (k, b, b), got {tuple(D.shape)}")
    k, b = D.shape[0], D.shape[1]
    _check_blocks(k, b, D.dtype)
    _check("D", D, (k, b, b), D)
    _check("L", L, (k - 1, b, b), D)
    Ld = torch.empty_like(D)
    Lo = torch.empty_like(L)
    ok = torch.empty((), dtype=torch.bool, device=D.device)
    lib = _library()
    fn = lib.banded_factor_f64 if D.dtype == torch.float64 else lib.banded_factor_f32
    _launch("block_tridiag_factor", fn, lib.banded_error_string, D.device,
            D.data_ptr(), L.data_ptr(), Ld.data_ptr(), Lo.data_ptr(), ok.data_ptr(), k, b)
    _counts["factor"] += 1
    return Ld, Lo, ok


def block_tridiag_solve(Ld: torch.Tensor, Lo: torch.Tensor, rhs: torch.Tensor):
    """x with A x = rhs for the factors (Ld, Lo); ``rhs`` (k, b) or (k, b, r):
    one launch of the solve kernel (forward and backward sweep, a warp per
    right-hand side) on the current stream."""
    if Ld.dim() != 3 or Ld.shape[1] != Ld.shape[2]:
        raise ValueError(f"Ld must be (k, b, b), got {tuple(Ld.shape)}")
    k, b = Ld.shape[0], Ld.shape[1]
    _check_blocks(k, b, Ld.dtype)
    _check("Ld", Ld, (k, b, b), Ld)
    _check("Lo", Lo, (k - 1, b, b), Ld)
    if rhs.dim() not in (2, 3):
        raise ValueError(f"rhs must be (k, b) or (k, b, r), got {tuple(rhs.shape)}")
    nrhs = rhs.shape[2] if rhs.dim() == 3 else 1
    _check("rhs", rhs, (k, b) + tuple(rhs.shape[2:]), Ld)
    out = torch.empty_like(rhs)
    if nrhs == 0:
        return out
    lib = _library()
    fn = lib.banded_solve_f64 if Ld.dtype == torch.float64 else lib.banded_solve_f32
    _launch("block_tridiag_solve", fn, lib.banded_error_string, Ld.device,
            Ld.data_ptr(), Lo.data_ptr(), rhs.data_ptr(), out.data_ptr(), k, b, nrhs)
    _counts["solve"] += 1
    return out


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


def factor_bound_terms(k: int, b: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one
    factorization on an H100 SXM.  Bytes: D and L read once, Ld and Lo
    written once.  Operations per block row: the triangular solve for Lo
    (b^3), the product Lo Lo' (b^3, one triangle), the Cholesky (b^3 / 3)."""
    size = torch.finfo(dtype).bits // 8
    nbytes = 2.0 * (k + max(k - 1, 0)) * b * b * size
    ops = (k - 1) * 2.0 * b ** 3 + k * b ** 3 / 3.0
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def solve_bound_terms(k: int, b: int, nrhs: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one solve with
    ``nrhs`` right-hand sides: Ld and Lo read once, the right-hand sides read
    and the solution written once; two triangular solves and two block
    products per block row and right-hand side."""
    size = torch.finfo(dtype).bits // 8
    nbytes = ((k + max(k - 1, 0)) * b * b + 2.0 * k * b * nrhs) * size
    ops = nrhs * (2.0 * k * b * b + 4.0 * max(k - 1, 0) * b * b)
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def bound_ms(terms):
    """(bound_ms, bound_by) of ``(seconds for bytes, seconds for operations)``."""
    t_bytes, t_ops = terms
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
