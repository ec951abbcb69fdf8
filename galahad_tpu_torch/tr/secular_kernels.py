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
import math

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

# ---------------------------------------------------------------------------
# The schedule: lanes per problem fitted to n
# ---------------------------------------------------------------------------

# (lanes per problem, entries per lane) of the register layouts, smallest
# first; the largest n each takes is their product
REG_LAYOUTS = ((16, 4), (32, 8))
REG_THREADS = 128            # threads per block of a register layout, at most
BLOCK_ENTRIES = 8            # entries per thread the block layout aims at
MAX_BLOCK_THREADS = 1024
SMEM_LIMIT = 232_448         # bytes of shared memory a block may use on sm_90 (227 KB)
BLOCK_PARTS = 32             # the block layout's warp sums: 2 buffers x 2 sums x 32


def secular_schedule(B: int, n: int, dtype: torch.dtype = torch.float64) -> dict:
    """The layout of one secular launch on B problems of n entries: ``lanes``
    per problem (16 for n <= 64, 32 for n <= 256; 0: a block per problem),
    ``entries_per_lane`` in registers, ``problems_per_block``, ``threads`` per
    block, ``blocks``, and for the block layout the entries kept in shared
    memory (``smem_entries``, the rest read from global memory at each
    iteration) and its ``smem_bytes`` (dynamic and static).  Block b takes
    problems b * problems_per_block + t // lanes (register layouts) or b
    (block layout).  The lanes depend on n only, so a problem's answer does
    not depend on B."""
    size = torch.finfo(dtype).bits // 8
    for lanes, per_lane in REG_LAYOUTS:
        if n <= lanes * per_lane:
            threads = min(REG_THREADS, -(-B * lanes // 32) * 32)
            ppb = threads // lanes
            return dict(layout="group" if lanes < 32 else "warp", lanes=lanes,
                        entries_per_lane=per_lane, problems_per_block=ppb, threads=threads,
                        blocks=-(-B // ppb), smem_entries=0, smem_bytes=0)
    warps = min(MAX_BLOCK_THREADS // 32, max(2, -(-n // (32 * BLOCK_ENTRIES))))
    static = 4 * BLOCK_PARTS * size
    n_sh = min(n, (SMEM_LIMIT - static) // (2 * size))
    return dict(layout="block", lanes=0, entries_per_lane=-(-n // (32 * warps)),
                problems_per_block=1, threads=32 * warps, blocks=B, smem_entries=n_sh,
                smem_bytes=2 * n_sh * size + static)


def _library():
    from ..linalg._cuda_build import load_cuda_library

    lib = load_cuda_library("secular.cu")
    if not getattr(lib, "_typed", False):
        for fn in (lib.trs_secular_newton_f32, lib.trs_secular_newton_f64):
            fn.argtypes = [_PTR] * 6 + [_INT] * 6 + [_PTR]
            fn.restype = _INT
        for fn in (lib.rqs_secular_newton_f32, lib.rqs_secular_newton_f64):
            fn.argtypes = [_PTR] * 9 + [_INT, _INT, ctypes.c_double] + [_INT] * 4 + [_PTR]
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


def _counts_out(bshape, lam, iterations: bool):
    return torch.empty(bshape, dtype=torch.int32, device=lam.device) if iterations else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def trs_secular_newton(lam, ct2, radius, lam_lo, max_its: int, iterations: bool = False):
    """s (...) of the TRS's secular Newton iteration (see
    ``tr/trs.py::secular_newton_plain``) on ``lam``, ``ct2`` (..., n),
    ``radius`` and ``lam_lo`` (broadcast to the batch): one launch, each
    problem stopping at convergence or after ``max_its`` iterations, laid out
    by :func:`secular_schedule`.  With ``iterations`` also each problem's
    iteration count (int32)."""
    bshape, B, n = _problems(lam)
    lam = _flat("lam", lam, lam.shape, lam)
    ct2 = _flat("ct2", ct2, lam.shape, lam)
    radius = _flat("radius", radius, bshape, lam)
    lam_lo = _flat("lam_lo", lam_lo, bshape, lam)
    out = torch.empty(bshape, dtype=lam.dtype, device=lam.device)
    its = _counts_out(bshape, lam, iterations)
    if B:
        sch = secular_schedule(B, n, lam.dtype)
        lib = _library()
        fn = lib.trs_secular_newton_f64 if lam.dtype == torch.float64 \
            else lib.trs_secular_newton_f32
        _launch("trs_secular_newton", fn, lib.secular_error_string, lam.device,
                lam.data_ptr(), ct2.data_ptr(), radius.data_ptr(), lam_lo.data_ptr(),
                out.data_ptr(), _ptr(its), B, n, int(max_its),
                sch["lanes"], sch["threads"], sch["smem_entries"])
        _counts["trs"] += 1
    return (out, its) if iterations else out


def rqs_secular_newton(lam, ct2, excl, sigma, p: float, lam_lo, hi0, max_its: int,
                       iterations: bool = False):
    """s (...) of RQS's bracket growth and Newton iteration (see
    ``tr/trs.py::rqs_newton_plain``): ``excl`` (..., n) bool marks the
    entries left out of the norm; ``sigma``, ``lam_lo`` and ``hi0`` are
    broadcast to the batch.  One launch, each problem stopping at
    convergence or after ``max_its`` Newton steps (always the cap in float32
    unless p is 3 or 4).  With ``iterations`` returns (s, its, growth): each problem's Newton
    steps and the theta evaluations of its bracket growth (1..60), int32."""
    bshape, B, n = _problems(lam)
    lam = _flat("lam", lam, lam.shape, lam)
    ct2 = _flat("ct2", ct2, lam.shape, lam)
    excl = _flat("excl", excl, lam.shape, lam, dtype=torch.bool).view(torch.uint8)
    sigma = _flat("sigma", sigma, bshape, lam)
    lam_lo = _flat("lam_lo", lam_lo, bshape, lam)
    hi0 = _flat("hi0", hi0, bshape, lam)
    out = torch.empty(bshape, dtype=lam.dtype, device=lam.device)
    its, growth = _counts_out(bshape, lam, iterations), _counts_out(bshape, lam, iterations)
    if B:
        sch = secular_schedule(B, n, lam.dtype)
        lib = _library()
        fn = lib.rqs_secular_newton_f64 if lam.dtype == torch.float64 \
            else lib.rqs_secular_newton_f32
        _launch("rqs_secular_newton", fn, lib.secular_error_string, lam.device,
                lam.data_ptr(), ct2.data_ptr(), excl.data_ptr(), sigma.data_ptr(),
                lam_lo.data_ptr(), hi0.data_ptr(), out.data_ptr(),
                _ptr(its), _ptr(growth), B, n, float(p) - 2.0, int(max_its),
                sch["lanes"], sch["threads"], sch["smem_entries"])
        _counts["rqs"] += 1
    return (out, its, growth) if iterations else out


# ---------------------------------------------------------------------------
# Bounds and the critical path
# ---------------------------------------------------------------------------

OPS_PER_ENTRY = 7        # lam + s, its reciprocal, two products, two adds (one fused)


def trs_bound_terms(B: int, n: int, iterations: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one TRS call on
    an H100 SXM whose problems take ``iterations`` Newton iterations in all
    (the sum of the kernel's counts: what this run's data needs).  Bytes:
    lam and ct2 read once, radius and lam_lo read and s written once.
    Operations: the first sum of ct2, then per iteration and entry
    ``OPS_PER_ENTRY`` (a reciprocal counted as one operation)."""
    size = torch.finfo(dtype).bits // 8
    nbytes = (2.0 * B * n + 3.0 * B) * size
    ops = B * n + float(iterations) * n * OPS_PER_ENTRY
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def rqs_bound_terms(B: int, n: int, evaluations: int, dtype: torch.dtype):
    """The same for one RQS call whose problems evaluate theta
    ``evaluations`` times in all (the kernel's counts: growth evaluations
    plus Newton steps): lam, ct2, the mask and
    three scalars per problem read once, s written once; ``OPS_PER_ENTRY`` +
    2 (the mask's two selects) per entry and evaluation."""
    size = torch.finfo(dtype).bits // 8
    nbytes = 2.0 * B * n * size + B * n + 4.0 * B * size
    ops = float(evaluations) * n * (OPS_PER_ENTRY + 2)
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def critical_path_steps(iterations, growth=None) -> int:
    """The dependent iterations of one launch: the largest count over its
    problems (Newton iterations, plus the growth rounds of ``growth`` for
    RQS), since the problems run side by side."""
    its = torch.as_tensor(iterations).to(torch.int64)
    if growth is not None:
        its = its + torch.as_tensor(growth).to(torch.int64)
    return int(its.max()) if its.numel() else 0


def iteration_percentiles(iterations) -> dict:
    """min / p50 / p90 / max of a launch's iteration counts (nearest rank)."""
    its = torch.as_tensor(iterations).flatten().to(torch.int64).sort().values
    if not its.numel():
        return {}
    def pick(q):
        return int(its[min(its.numel() - 1, max(0, math.ceil(q * its.numel()) - 1))])

    return dict(min=int(its[0]), p50=pick(0.5), p90=pick(0.9), max=int(its[-1]))
