"""The scalar tridiagonal LDL^T factor and solve kernels: their wrappers,
schedule, launch counts and bounds.

The CUDA source is ``csrc/tridiag.cu``, built by ``nvcc`` and bound with
``ctypes`` at the first call on a CUDA tensor (see ``_cuda_build.py``);
importing this module needs no card.  The plain versions are
``linalg/cholesky.py::tridiag_factor_plain`` and ``tridiag_solve_plain``;
they count their calls here (:func:`count_plain`), so that a run on the
card can show that it did not take them.  The wrappers take CUDA tensors
only: they launch the kernel on the current stream (and count the launch)
or raise.  :func:`tridiag_schedule` lays each call out (pure Python, the
same on the CPU).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ldlt_kernels import H100_BYTES_PER_S, H100_FLOPS, _launch

BATCH = 32               # systems of a block, at most (one warp of walkers)
MAX_SLOTS = 8            # slots of a ring, at most
HEADER = 128             # bytes of a block's shared memory before its slots
SMEM_MAX = 232_448       # an H100 block's dynamic shared memory, at most
THREADS = 64             # the walkers' warp and the IO warp
BATCH_ROWS = 32          # rows a stage, batch layout
CHAIN_ROWS = 512         # rows a stage, chain layout (a multiple of 4: bulk copies)
CHUNK_ROWS = 256         # rows a stage, chunked layout
RING = 4                 # slots of a streaming ring
CHAIN_MAX_B = 256        # the factor takes the chain layout below this many systems
CHUNKED_MIN_K = 1024     # the solve takes the chunked layout from this order ...
CHUNKED_MAX_B = 64       # ... for at most this many systems
SMS = 132                # an H100 SXM's streaming multiprocessors
WALKERS = 4 * SMS        # chunks of all systems in flight: a walker per warp scheduler
CHUNK_MIN = 64           # rows of a chunk, at least

FACTOR_LAYOUTS = ("batch", "chain")
SOLVE_LAYOUTS = ("batch", "chunked")

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


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


def _size(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def default_chunk(k: int, B: int = 1) -> int:
    """Rows per chunk of the chunked solve of B systems of order k: k / P
    with P = WALKERS / B chunks a system (at least CHUNK_MIN rows), so that
    the card holds about one walker per warp scheduler.  Fewer chunks make
    each walker's 4 m row steps longer; more make 2 P hops between chunks
    and put walkers on the same scheduler (tools/tridiag_bench.py --layouts,
    PERF.md section 6: the best of the chunks timed at 64 x 5,000 and at
    one chain of 10^6 rows both lie near B P = 528)."""
    P = max(1, WALKERS // max(B, 1))
    return max(CHUNK_MIN, -(-k // P))


@functools.lru_cache(maxsize=64)
def chunked_steps(k: int, m: int) -> int:
    """Dependent steps of one chunked solve of order k in chunks of m rows,
    a row step and a hop between chunks each counting one.  Per direction:
    the first chunk runs its rows from no inflow; every other chunk first
    runs them from zero inflow (phase 1, from the start), then takes its
    inflow from the chunk before (one hop), then runs them again (phase 3).
    The backward items start when their chunk's forward rows are written."""
    P = -(-k // m)
    lens = [min(m, k - j * m) for j in range(P)]
    pub, done_f = 0, []
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
    return end


def _array_bytes(S: int, size: int) -> int:
    """Bytes of one system's array in a slot: S rows and 16 bytes, so that
    every array starts 16-byte aligned and holds a bulk copy's shift."""
    return S * size + 16


def batch_systems(B: int) -> int:
    """Systems a block of the batch layout: B / (2 SMS), 1..BATCH, so that
    two blocks share an SM (one's copies overlap the other's walk) and each
    SM's copy engine moves few systems' rows (a bulk copy of a stage's row
    run takes ~50 ns of it: PERF.md section 6)."""
    return min(BATCH, max(1, -(-B // (2 * SMS))))


def factor_layout(B: int, k: int, dtype, layout: str) -> dict:
    """The factor laid out as ``layout`` ("batch" or "chain") for B systems
    of order k: systems a block, rows a stage S, ring slots, blocks, shared
    memory."""
    size = _size(dtype)
    if layout == "batch":
        per, S = batch_systems(B), BATCH_ROWS
    elif layout == "chain":
        per, S = 1, min(CHAIN_ROWS, _round4(k))
    else:
        raise ValueError(f"the factor's layouts are {FACTOR_LAYOUTS}, got {layout!r}")
    nslots = min(RING, -(-k // S))
    return dict(layout=layout, rows_per_stage=S, slots=nslots, stages=-(-k // S),
                systems_per_block=per, blocks=-(-B // per), threads=THREADS,
                smem_bytes=HEADER + nslots * 2 * per * _array_bytes(S, size),
                critical_path_steps=max(k - 1, 0))


def solve_layout(B: int, k: int, dtype, layout: str, chunk=None) -> dict:
    """The solve laid out as ``layout`` ("batch" or "chunked"; ``chunk``: the
    chunked layout's rows per chunk, default :func:`default_chunk`)."""
    size = _size(dtype)
    if layout == "batch":
        S, per = BATCH_ROWS, batch_systems(B)
        nseg = -(-k // S)
        slot = 3 * per * _array_bytes(S, size)
        resident = nseg <= min(MAX_SLOTS, (SMEM_MAX - HEADER) // slot)
        nslots = nseg if resident else min(RING, nseg)
        return dict(layout=layout, rows_per_stage=S, slots=nslots, stages=nseg,
                    resident=resident, systems_per_block=per, blocks=-(-B // per),
                    threads=THREADS, smem_bytes=HEADER + nslots * slot, chunk=k, chunks=1,
                    critical_path_steps=2 * k - 1)
    if layout != "chunked":
        raise ValueError(f"the solve's layouts are {SOLVE_LAYOUTS}, got {layout!r}")
    m = min(default_chunk(k, B) if chunk is None else int(chunk), k)
    if m < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    P = -(-k // m)
    S = min(CHUNK_ROWS, _round4(m))
    nslots = min(RING, 2 * -(-m // S))
    return dict(layout=layout, rows_per_stage=S, slots=nslots, resident=False,
                systems_per_block=1, blocks=P * B, grid=[P, B], threads=THREADS,
                smem_bytes=HEADER + nslots * 3 * _array_bytes(S, size), chunk=m, chunks=P,
                critical_path_steps=chunked_steps(k, m))


def tridiag_schedule(B: int, k: int, dtype=torch.float64) -> dict:
    """How the kernels lay out a call on B systems of order k: ``factor`` and
    ``solve``, each with its layout, rows a stage (the segment S), ring
    slots, blocks, shared memory, chunk rows and count (the solve), and
    ``critical_path_steps`` (the dependent steps of one call: a division and
    an fma per row of the factor; the solve's row steps and its hops between
    chunks).  The factor takes the chain layout (one walker a block) for
    fewer than CHAIN_MAX_B systems, else the batch layout
    (:func:`batch_systems` a block); the solve takes the chunked layout for at most
    CHUNKED_MAX_B systems of order at least CHUNKED_MIN_K, else the batch
    layout (z kept in shared memory when the system fits)."""
    if B < 0 or k < 1:
        raise ValueError(f"the tridiagonal kernels need B >= 0 and k >= 1, got {B}, {k}")
    f = "chain" if B < CHAIN_MAX_B else "batch"
    s = "chunked" if k >= CHUNKED_MIN_K and B <= CHUNKED_MAX_B else "batch"
    return dict(B=B, k=k, factor=factor_layout(B, k, dtype, f),
                solve=solve_layout(B, k, dtype, s))


@functools.lru_cache(maxsize=256)
def _plan(kind: str, B: int, k: int, dtype, layout, chunk):
    """The launch parameters of one call (``kind`` "factor" or "solve"):
    the layout dict of :func:`tridiag_schedule`, or of ``layout`` /
    ``chunk`` where given; cached, so a call does not lay itself out again."""
    if kind == "factor":
        return (tridiag_schedule(B, k, dtype)["factor"] if layout is None
                else factor_layout(B, k, dtype, layout))
    if layout is None and chunk is None:
        return tridiag_schedule(B, k, dtype)["solve"]
    return solve_layout(B, k, dtype, layout or "chunked", chunk)


# ---------------------------------------------------------------------------
# The library and its wrappers
# ---------------------------------------------------------------------------

_PTR = ctypes.c_void_p
_LL, _INT = ctypes.c_longlong, ctypes.c_int


def _library():
    from ._cuda_build import load_cuda_library

    lib = load_cuda_library("tridiag.cu")
    _status_word()                       # before any graph capture: pinned host memory
    if not getattr(lib, "_typed", False):
        for fn in (lib.tridiag_factor_f32, lib.tridiag_factor_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, _LL, _LL, _INT, _INT, _INT, _PTR]
            fn.restype = _INT
        for fn in (lib.tridiag_solve_f32, lib.tridiag_solve_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, _LL, _LL, _INT, _INT, _INT, _PTR]
            fn.restype = _INT
        for fn in (lib.tridiag_chunked_f32, lib.tridiag_chunked_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, _LL, _LL, _LL, _INT, _INT, _INT, _PTR, _PTR,
                           _PTR]
            fn.restype = _INT
        lib.tridiag_error_string.argtypes = [_INT]
        lib.tridiag_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


_status = None           # int32 in pinned host memory: set by a solve whose wait gave up


def _status_word() -> torch.Tensor:
    global _status
    if _status is None:
        _status = torch.zeros(1, dtype=torch.int32).pin_memory()
    return _status


def tridiag_check() -> None:
    """Synchronise the card and raise if a chunked solve gave up waiting for
    the chunk before its own (it then took NaN where it waited; the ticket
    order makes every wait end, so this reports a fault).  The wrapper asks
    the same at each call, without synchronising."""
    torch.cuda.synchronize()
    _raise_if_a_solve_gave_up()


def _raise_if_a_solve_gave_up() -> None:
    if _status is not None and int(_status[0]):
        raise RuntimeError("a chunked tridiagonal solve gave up waiting for the chunk before "
                           "its own: its result holds NaN")


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


def tridiag_factor(d: torch.Tensor, e: torch.Tensor, layout=None):
    """(dhat, l) of the LDL' factorization of the tridiagonal matrices with
    diagonal ``d (..., k)`` and subdiagonal ``e (..., k-1)``: one launch on
    the current stream, laid out by :func:`tridiag_schedule` (``layout``:
    "batch" or "chain" in its place)."""
    B, k = _systems(d)
    _check("d", d, d.shape, d)
    _check("e", e, tuple(d.shape[:-1]) + (k - 1,), d)
    d, e = d.contiguous(), e.contiguous()
    dhat = torch.empty_like(d)
    l = torch.empty_like(e)
    if B:
        sch = _plan("factor", B, k, d.dtype, layout, None)
        lib = _library()
        fn = lib.tridiag_factor_f64 if d.dtype == torch.float64 else lib.tridiag_factor_f32
        _launch("tridiag_factor", fn, lib.tridiag_error_string, d.device,
                d.data_ptr(), e.data_ptr(), dhat.data_ptr(), l.data_ptr(), B, k,
                sch["systems_per_block"], sch["rows_per_stage"], sch["slots"])
        _counts["factor"] += 1
    return dhat, l


def tridiag_solve(dhat: torch.Tensor, l: torch.Tensor, b: torch.Tensor, layout=None,
                  chunk=None):
    """x with L diag(dhat) L' x = b for the factors of :func:`tridiag_factor`;
    ``b`` has the shape of ``dhat``: one launch on the current stream (the
    chunked layout: one memset of its workspace before it), laid out by
    :func:`tridiag_schedule` (``layout``: "batch" or "chunked" in its place;
    ``chunk``: the chunked layout's rows per chunk)."""
    B, k = _systems(dhat)
    _check("dhat", dhat, dhat.shape, dhat)
    _check("l", l, tuple(dhat.shape[:-1]) + (k - 1,), dhat)
    _check("b", b, dhat.shape, dhat)
    dhat, l, b = dhat.contiguous(), l.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    if not B:
        return x
    sch = _plan("solve", B, k, dhat.dtype, layout, chunk)
    lib = _library()
    f64 = dhat.dtype == torch.float64
    if sch["layout"] == "batch":
        fn = lib.tridiag_solve_f64 if f64 else lib.tridiag_solve_f32
        _launch("tridiag_solve", fn, lib.tridiag_error_string, dhat.device,
                dhat.data_ptr(), l.data_ptr(), b.data_ptr(), x.data_ptr(), B, k,
                sch["systems_per_block"], sch["rows_per_stage"], sch["slots"])
    else:
        if B > 65535:
            raise ValueError(f"the chunked solve takes at most 65,535 systems, got {B}")
        _raise_if_a_solve_gave_up()
        P = sch["chunks"]
        work = torch.empty(B * (2 * P * _size(dhat.dtype) + 4 * (1 + P)), dtype=torch.uint8,
                           device=dhat.device)
        fn = lib.tridiag_chunked_f64 if f64 else lib.tridiag_chunked_f32
        _launch("tridiag_solve", fn, lib.tridiag_error_string, dhat.device,
                dhat.data_ptr(), l.data_ptr(), b.data_ptr(), x.data_ptr(), B, k, sch["chunk"],
                sch["rows_per_stage"], sch["slots"], P, work.data_ptr(),
                _status_word().data_ptr())
    _counts["solve"] += 1
    return x


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


def factor_bound_terms(B: int, k: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one factorization
    of B systems of order k on an H100 SXM: d and e read once, dhat and l
    written once; a division, a product and a difference per step."""
    size = _size(dtype)
    nbytes = 2.0 * B * (2 * k - 1) * size
    ops = 3.0 * B * (k - 1)
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def solve_bound_terms(B: int, k: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one solve: dhat,
    l and b read once, x written once; two products and two differences per
    step of the two sweeps and a division per row."""
    size = _size(dtype)
    nbytes = B * (4 * k - 1) * size
    ops = B * (4.0 * (k - 1) + k)
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]
