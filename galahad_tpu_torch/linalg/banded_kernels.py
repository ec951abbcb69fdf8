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
import functools
import math

import torch

from .ldlt_kernels import H100_BYTES_PER_S, H100_FLOPS, _launch

MAX_BLOCK = 32           # blocks of 1..32: the factor's warp holds a block row a lane
CHUNKED_MAX_BLOCK = 16   # the factor runs in chunks for blocks of up to 16 (csrc/banded.cu)

_counts = dict(factor=0, factor_partitioned=0, solve=0, factor_plain=0, solve_plain=0)


def banded_counts() -> dict:
    """Launches of the factor and solve kernels (``factor``, ``solve``), the
    factor's launches in more than one chunk (``factor_partitioned``), and
    calls of their plain versions (``factor_plain``, ``solve_plain``: 0 on a
    path that runs on the card).  Counted as the host launches, so a graph
    counts its launches at capture."""
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
    _status_word()                       # before any graph capture: pinned host memory
    if not getattr(lib, "_typed", False):
        for fn in (lib.banded_factor_f32, lib.banded_factor_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           _PTR, _PTR, _PTR]
            fn.restype = ctypes.c_int
        for fn in (lib.banded_solve_f32, lib.banded_solve_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _PTR, _PTR, _PTR]
            fn.restype = ctypes.c_int
        lib.banded_error_string.argtypes = [ctypes.c_int]
        lib.banded_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# two int32 in pinned host memory: [0] set by a kernel whose wait gave up, [1] the
# factorizations rerun as the sequential chain after a failed pivot
_status = None


def _status_word() -> torch.Tensor:
    global _status
    if _status is None:
        _status = torch.zeros(2, dtype=torch.int32).pin_memory()
    return _status


def banded_check() -> None:
    """Synchronise the card and raise if a kernel gave up waiting for a chunk
    before its own (it then took NaN for what it waited for; the chunk order
    of the kernels makes every wait end, so this reports a fault).  The
    wrappers ask the same at each call, without synchronising."""
    torch.cuda.synchronize()
    _raise_if_a_wait_gave_up()


def banded_factor_reruns() -> int:
    """Chunked factorizations that a failed pivot sent back to the sequential
    chain (in the same launch), since the process started; synchronises."""
    torch.cuda.synchronize()
    return int(_status_word()[1])


def _raise_if_a_wait_gave_up() -> None:
    if _status is not None and int(_status[0]):
        raise RuntimeError("a block-tridiagonal kernel gave up waiting for the chunk before "
                           "its own: its result holds NaN")


# ---------------------------------------------------------------------------
# The solve's schedule: chunks of block rows
# ---------------------------------------------------------------------------


def block_tile(b: int) -> int:
    """The block size the kernels are compiled for that holds b: the next
    power of two (b < it is padded in shared memory)."""
    return 1 << (b - 1).bit_length()


def default_chunk(k: int) -> int:
    """Block rows per chunk of the solve kernel: about sqrt(1.5 k), which
    balances the 4 m row steps of a solve's critical path against its 2 P
    hops between chunks (P = k / m; on an H100 a row step of b = 8 costs
    about 0.35 us and a hop about 0.5 us, tools/banded_bench.py)."""
    return max(1, math.ceil(math.sqrt(1.5 * k)))


def solve_schedule(k: int, chunk: int) -> dict:
    """The solve kernel's schedule of k block rows in chunks of ``chunk``:
    ``chunks`` (P) and ``critical_path_steps``, the dependent steps of one
    solve (both directions) when a row step and a hop between chunks each
    count one.  Per direction: the first chunk runs its rows from no
    inflow; every other chunk first runs them from zero inflow (phase 1,
    from the start), then takes its inflow from the chunk before (one hop),
    then runs them again (phase 3).  The backward items start when their
    chunk's forward rows are written."""
    chunk = min(chunk, k)
    P = -(-k // chunk)
    lens = [min(chunk, k - j * chunk) for j in range(P)]
    pub = 0
    done_f = []
    for j, n in enumerate(lens):
        pub = n if j == 0 else max(n, pub) + 1
        done_f.append(pub if j == 0 else pub + n)
    end = 0
    for j in range(P - 1, -1, -1):
        n = lens[j]
        if j == P - 1:
            pub = done_f[j] + n
            end = max(end, pub)
        else:
            pub = max(done_f[j] + n, pub) + 1
            end = max(end, pub + n)
    return dict(chunk=chunk, chunks=P, critical_path_steps=end)


# ---------------------------------------------------------------------------
# The factor's schedule: chunks of block rows
# ---------------------------------------------------------------------------

# Device costs of the factor kernel on an H100 SXM (700 W), f64, in us, by the
# block size it is compiled for: (step, fold, hop, launch) = a step of the
# contract's chain (phase 3, chunk 0, the sequential chain), a step of phase 1
# (the chain's step with the spike), a hop of phase 2, and what a chunked
# launch costs besides.  Fitted by tools/banded_bench.py --factor-chunks auto
# at k = 20,000, launch at least the 4 us of b = 1's fit.
FACTOR_COSTS_US = {1: (0.291, 0.508, 0.445, 4.0), 2: (0.339, 0.451, 0.506, 8.4),
                   4: (0.423, 0.692, 0.734, 8.4), 8: (0.885, 1.358, 1.553, 4.0),
                   16: (2.32, 5.39, 5.22, 4.0)}


def factor_schedule(k: int, chunk: int, b: int) -> dict:
    """The factor kernel's schedule of k block rows in chunks of ``chunk``:
    ``chunks`` (P) and ``critical_path_us``, the model's device time of one
    factorization (FACTOR_COSTS_US of b's tile).  Chunk 0 runs its chain and
    gives Sigma_0; every middle chunk runs phase 1 at once and its hop as
    soon as Sigma of the chunk before and its own phase 1 are done; each
    chunk after the first then runs a Cholesky step and its rows."""
    step, fold, hop, launch = FACTOR_COSTS_US[block_tile(b)]
    chunk = min(chunk, k)
    P = -(-k // chunk)
    if P == 1:
        return dict(chunk=k, chunks=1, critical_path_us=k * step)
    sigma = chunk * step
    end = sigma
    for j in range(1, P):
        n = min(chunk, k - j * chunk)
        end = max(end, sigma + (n + 1) * step)
        if j < P - 1:
            sigma = max(sigma, n * fold) + hop
    return dict(chunk=chunk, chunks=P, critical_path_us=end + launch)


@functools.lru_cache(maxsize=None)
def default_factor_chunk(k: int, b: int) -> int:
    """Block rows per chunk of the factor kernel: the m that balances the
    ~(c1 + c3) m row steps of a chunk's two passes against the ~c2 P hops
    between chunks (P = k / m), m = sqrt(c2 k / (c1 + c3)) or the best of
    its neighbours in the model of :func:`factor_schedule`; k (one chunk:
    the sequential chain, no workspace) where the partition would not
    shorten the model's critical path, as at every k below ~20.  At b = 8,
    f64 on an H100 (tools/banded_bench.py --factor-chunks): c3 = 0.885 us a
    step of the chain, c1 = 1.358 us a step of phase 1, c2 = 1.553 us a hop;
    k = 125,000 gives m = 294, ~1.5 ms against the chain's 110.7 ms."""
    if block_tile(b) > CHUNKED_MAX_BLOCK:
        return k
    step, fold, hop, _ = FACTOR_COSTS_US[block_tile(b)]
    m0 = max(1, round(math.sqrt(hop * k / (fold + step))))
    best, best_us = k, factor_schedule(k, k, b)["critical_path_us"]
    for m in {max(1, m0 // 2), m0, 2 * m0}:
        us = factor_schedule(k, m, b)["critical_path_us"]
        if m < k and us < best_us:
            best, best_us = m, us
    return best


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


def block_tridiag_factor(D: torch.Tensor, L: torch.Tensor, chunk=None):
    """(Ld, Lo, ok) of the block Cholesky factorization of (D (k, b, b),
    L (k-1, b, b)): one launch of the factor kernel on the current stream,
    the rows in chunks of ``chunk`` on many blocks (default
    :func:`default_factor_chunk`; one chunk of k rows, and any chunk for
    blocks above CHUNKED_MAX_BLOCK, is the sequential chain), after one
    memset of its workspace where there is more than one chunk."""
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"D must be (k, b, b), got {tuple(D.shape)}")
    k, b = D.shape[0], D.shape[1]
    _check_blocks(k, b, D.dtype)
    _check("D", D, (k, b, b), D)
    _check("L", L, (k - 1, b, b), D)
    m = default_factor_chunk(k, b) if chunk is None else int(chunk)
    if m < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    m = min(m, k) if block_tile(b) <= CHUNKED_MAX_BLOCK else k
    P = -(-k // m)
    Ld = torch.empty_like(D)
    Lo = torch.empty_like(L)
    ok = torch.empty((), dtype=torch.bool, device=D.device)
    _raise_if_a_wait_gave_up()
    # the kernel's workspace: each chunk's Sigma, its ticket, counter and failure word
    size = torch.finfo(D.dtype).bits // 8
    work = (torch.empty(P * block_tile(b) ** 2 * size + 12, dtype=torch.uint8, device=D.device)
            if P > 1 else None)
    lib = _library()
    fn = lib.banded_factor_f64 if D.dtype == torch.float64 else lib.banded_factor_f32
    _launch("block_tridiag_factor", fn, lib.banded_error_string, D.device,
            D.data_ptr(), L.data_ptr(), Ld.data_ptr(), Lo.data_ptr(), ok.data_ptr(), k, b, m,
            None if work is None else work.data_ptr(), _status_word().data_ptr())
    _counts["factor"] += 1
    _counts["factor_partitioned"] += P > 1
    return Ld, Lo, ok


def block_tridiag_solve(Ld: torch.Tensor, Lo: torch.Tensor, rhs: torch.Tensor, chunk=None):
    """x with A x = rhs for the factors (Ld, Lo); ``rhs`` (k, b) or (k, b, r):
    one launch of the solve kernel (forward and backward sweep, the rows in
    chunks of ``chunk`` on many blocks; default :func:`default_chunk`; one
    chunk of k rows is the sequential solve) on the current stream, after
    one memset of its workspace."""
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
    m = default_chunk(k) if chunk is None else int(chunk)
    if m < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    m = min(m, k)
    out = torch.empty_like(rhs)
    if nrhs == 0:
        return out
    _raise_if_a_wait_gave_up()
    P = -(-k // m)
    # the kernel's workspace: each chunk's published rows, its ticket and flags
    size = torch.finfo(Ld.dtype).bits // 8
    work = torch.empty(nrhs * (2 * P * block_tile(b) * size + 4 * (1 + P)), dtype=torch.uint8,
                       device=Ld.device)
    lib = _library()
    fn = lib.banded_solve_f64 if Ld.dtype == torch.float64 else lib.banded_solve_f32
    _launch("block_tridiag_solve", fn, lib.banded_error_string, Ld.device,
            Ld.data_ptr(), Lo.data_ptr(), rhs.data_ptr(), out.data_ptr(), k, b, nrhs, m,
            work.data_ptr(), _status_word().data_ptr())
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
