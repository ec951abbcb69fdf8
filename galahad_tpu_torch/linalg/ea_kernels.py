"""Extend-add of the flat LDL^T factorization, one call per tree level: the
hand-written CUDA kernel, its wrapper, its plain PyTorch version and the
per-level tables both read.

Counterpart of ``_ea_gather_blocks`` / ``_ea_onehot`` / ``_ea_slot_apply`` /
``_ea_q_apply`` of galahad_tpu/linalg/supernodal_flat.py (run there through the
jitted scans ``_k_ea_slot_scan`` / ``_k_ea_q_scan``, one step per bucket of
children of one padded shape).  The CUDA source is ``csrc/extend_add.cu``,
built by ``nvcc`` and bound with ``ctypes`` at the first call on a CUDA tensor
(see ``_cuda_build.py``); importing this module needs no card.

For every child of a front of the tree level, with Schur block ``C`` (``u x u``,
row stride ``fps``: the child's padded front width) and parent positions
``ppos`` (strictly increasing, ``< Fd``):

    P[ppos[i], ppos[j]] += C[i, j]        for all i, j < u

where ``P`` is the parent front (``Fd x Fd``, row-major in the flat store).  Both
triangles of ``C`` are read (a wide front's two triangles are computed
separately and need not agree in the last bit).  An entry of ``P`` that no child
reaches is neither read nor written, and nothing outside a child's Schur block
is read.

The children of a parent are added one at a time, in the order of the table:
stable-sorted by (``max(8, next power of 2 of u)``, ``fps``), then by their order
in the plan's records.  Each destination entry therefore receives its adds in
one fixed order, and the kernel and the plain version give the same bits (and
the bits of the bucketed composition this replaced, which ran the children of
a parent in that order).

:func:`extend_add` takes its plain version only for tensors on the CPU; on CUDA
tensors it launches the kernel (and counts the launch) or raises.
:func:`ea_bound_ms` is the least time an H100 SXM could take.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .ldlt_kernels import H100_BYTES_PER_S, H100_FLOPS, _launch

TILE = 32                  # columns of a tile of extend_add.cu (a lane each)
ROWS = 16                  # ROWS of extend_add.cu: rows of a tile (registers of a lane)
LANES = (8, 16, 32)        # lanes of a tile: fronts of 1..8 and 9..16 are packed 4 and 2 to a warp
INLINE = 2                 # INLINE of extend_add.cu: pair records a tile's row carries
TILE_WORDS = 4 + 2 * INLINE  # TILE_WORDS of extend_add.cu: int64 words of a tile's row

_counts = dict(calls=0, kernels=0, plain=0)

# bits set in each byte value, for counting the destinations of a tile
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def ea_counts() -> dict:
    """Calls of :func:`extend_add` that launched the kernel (``calls``), the
    kernel launches they made as the C launcher reports them (``kernels``) and
    calls of the plain version (``plain``, 0 on a path that runs on the
    card)."""
    return dict(_counts)


def reset_ea_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _runs(pp, cid, poff, size: int, n_children: int):
    """Runs of a child's positions ``pp`` (``cid``: each position's child,
    ``poff``: each child's first position) that fall in one block of ``size``
    parent rows or columns: each run's block, first child row and bit mask of
    the block's positions it reaches; each child's first run and run count."""
    blk = pp // size
    new = np.ones(len(pp), bool)
    new[1:] = (cid[1:] != cid[:-1]) | (blk[1:] != blk[:-1])
    rs = np.flatnonzero(new)
    run_cid = cid[rs]
    bit = np.left_shift(np.uint64(1), (pp % size).astype(np.uint64))
    n = np.bincount(run_cid, minlength=n_children)
    return blk[rs], rs - poff[run_cid], np.bitwise_or.reduceat(bit, rs), np.cumsum(n) - n, n


def _p2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length() if x > 1 else 1


@dataclasses.dataclass
class EaLevel:
    """Tables of one tree level's extend-add, built once per plan and device.

    ``children`` (host, int64, one row per child, in the order the children of a
    parent are applied, the children of a parent contiguous) holds the first
    store entry of the child's Schur block, ``fps`` (its row stride), ``u``, the
    parent front's first store entry, the parent's ``Fd`` and the offset of the
    child's positions in ``ppos`` (concatenated, int32, on the device).
    ``rank`` (host) is a child's place among its parent's children: the
    children of one rank have distinct parents, so their destinations are
    distinct (the plain version adds one rank at a time).

    The kernel's work list: ``tiles`` (int64, one row per tile, ``ROWS`` rows by
    up to ``TILE`` columns of a parent front that some child reaches: first
    store entry of the tile, ``Fd | pairs << 32``, first pair, 0, then the
    records of its first ``INLINE`` pairs, zero where it has fewer) and
    ``pairs`` (int64, one row per child that reaches a tile, a tile's rows in
    the children's order: the store entry of the first child row and column
    that land in the tile, and ``fps | row mask << 16 | column mask << 32``, the
    masks of the tile rows and columns the child reaches).  Since ``ppos`` is
    strictly increasing, the child rows that land in a tile are consecutive, and
    the k-th set bit of a mask is the k-th of them.  ``classes`` counts the
    tiles of fronts wider than 16, of 9..16 and of 1..8, which come in that
    order (each class with its longest chains of pairs first): the kernel gives
    them a warp each, two to a warp and four to a warp (:attr:`warps`).
    :meth:`tile_fields` reads the rows back.

    ``dest_entries`` counts the distinct destination entries (the union of
    ``ppos x ppos`` over a parent's children); ``store_end`` is one past the last
    store entry read or written; ``kernels`` the launches one call makes on the
    card."""
    children: np.ndarray
    rank: np.ndarray
    ppos: torch.Tensor
    child_table: torch.Tensor        # ``children`` on the device (plain version)
    tiles: torch.Tensor
    pairs: torch.Tensor
    classes: tuple                   # tiles of fronts > 16, 9..16, 1..8
    dest_entries: int
    store_end: int
    kernels: int = 0

    def __post_init__(self):
        self.kernels = int(self.tiles.shape[0] > 0)

    def tile_fields(self):
        """(first store entry, Fd, first pair, pairs) of every tile, int64
        numpy columns, from the packed rows of ``tiles``."""
        t = self.tiles.cpu().numpy()
        return t[:, 0], t[:, 1] & 0xFFFFFFFF, t[:, 2], t[:, 1] >> 32

    @property
    def warps(self) -> int:
        """Warps of the kernel's launch: one per tile of a front wider than 16,
        one per two of 9..16 and per four of 1..8."""
        n32, n16, n8 = self.classes
        return n32 + -(-n16 // 2) + -(-n8 // 4)

    @property
    def layers(self) -> list:
        """Child indices of each rank, the ranks in ascending order."""
        return [np.flatnonzero(self.rank == r) for r in range(int(self.rank.max()) + 1)]


def build_ea_level(batches, device) -> EaLevel:
    """Tables for ``batches``, a sequence of ``(offset, Fd, records)``: the
    parent fronts of one group start at element ``offset`` of the flat store and
    are ``Fd x Fd``; ``records`` are the plan's extend-add records of the group's
    children (``FlatGroup.ea``: dicts with ``sbase``, ``sncols``, ``fp_src``,
    ``u``, ``ppos``, ``ppar``)."""
    rows, keys, pos = [], [], []
    for gi, (off, Fd, records) in enumerate(batches):
        for k, o in enumerate(records):
            u, fps, nc = int(o["u"]), int(o["fp_src"]), int(o["sncols"])
            pp = np.asarray(o["ppos"], np.int64)
            if len(pp) != u or u == 0:
                raise ValueError("a child needs u > 0 parent positions")
            if pp[0] < 0 or pp[-1] >= Fd or np.any(np.diff(pp) <= 0):
                raise ValueError("ppos must be strictly increasing and inside the parent")
            if nc < 0 or nc + u > fps:
                raise ValueError("a child's Schur block must lie inside its front")
            pbase = int(off) + int(o["ppar"]) * Fd * Fd
            rows.append((int(o["sbase"]) + nc * fps + nc, fps, u, pbase, int(Fd)))
            keys.append((pbase, max(8, _p2(u)), fps, gi, k))
            pos.append(pp)
    if not rows:
        raise ValueError("a level's extend-add needs at least one child")
    keys = np.asarray(keys, np.int64)
    # children of a parent together, in the order the bucketed composition
    # applied them: by padded shape (Um, fps), then as recorded
    order = np.lexsort((keys[:, 4], keys[:, 3], keys[:, 2], keys[:, 1], keys[:, 0]))
    ch = np.asarray(rows, np.int64)[order]
    pos = [pos[i] for i in order]
    u = ch[:, 2]
    poff = np.cumsum(u) - u
    children = np.concatenate([ch, poff[:, None]], axis=1)
    first = np.ones(len(ch), bool)
    first[1:] = ch[1:, 3] != ch[:-1, 3]
    run = np.cumsum(first) - 1
    rank = np.arange(len(ch)) - np.flatnonzero(first)[run]

    # --- the kernel's work list ---------------------------------------------
    pp = np.concatenate(pos)
    cid = np.repeat(np.arange(len(ch)), u)
    r_blk, r_lo, r_mask, r_first, r_n = _runs(pp, cid, poff, ROWS, len(ch))
    c_blk, c_lo, c_mask, c_first, c_n = _runs(pp, cid, poff, TILE, len(ch))
    npair = r_n * c_n
    pc = np.repeat(np.arange(len(ch)), npair)      # each pair's child
    t = np.arange(int(npair.sum())) - np.repeat(np.cumsum(npair) - npair, npair)
    a = t // c_n[pc]
    ra = r_first[pc] + a
    rb = c_first[pc] + (t - a * c_n[pc])
    fps, fd = ch[pc, 1], ch[pc, 4]
    if len(fps) and fps.max() > 0xFFFF:
        raise ValueError("the extend-add kernel takes child fronts narrower than 65536")
    src = ch[pc, 0] + r_lo[ra] * fps + c_lo[rb]
    dst = ch[pc, 3] + r_blk[ra] * ROWS * fd + c_blk[rb] * TILE
    rmask, cmask = r_mask[ra], c_mask[rb]
    by_tile = np.lexsort((pc, dst))                # a tile's pairs in the children's order
    src, dst, fps, fd = src[by_tile], dst[by_tile], fps[by_tile], fd[by_tile]
    rmask, cmask = rmask[by_tile], cmask[by_tile]
    tstart = np.flatnonzero(np.concatenate([[True], dst[1:] != dst[:-1]]))
    tcount = np.diff(np.append(tstart, len(dst)))
    # distinct destinations: per tile column, the union of the rows reached
    r32, c32 = rmask.astype(np.uint32), cmask.astype(np.uint32)
    cols = np.where((c32[:, None] >> np.arange(TILE, dtype=np.uint32)) & np.uint32(1),
                    r32[:, None], np.uint32(0))
    union = np.bitwise_or.reduceat(cols, tstart, axis=0)
    dest_entries = int(_POP8[union.view(np.uint8)].sum())

    # the kernel's order of tiles: a warp each for fronts wider than 16, then two
    # to a warp (9..16), then four (1..8); within a class the longest chains first
    tfd = fd[tstart]
    cls = np.searchsorted(LANES, np.minimum(tfd, TILE))         # 0: 8, 1: 16, 2: 32 lanes
    order = np.lexsort((dst[tstart], -tcount, -cls))
    classes = tuple(int(x) for x in np.bincount(cls, minlength=3)[::-1])
    n_in = tcount[order]
    new_first = np.cumsum(n_in) - n_in
    pair_order = np.repeat(tstart[order] - new_first, n_in) + np.arange(int(n_in.sum()))
    word = (fps.astype(np.uint64) | (rmask << np.uint64(16)) | (cmask << np.uint64(32)))
    pairs = np.stack([src[pair_order], word[pair_order].view(np.int64)], axis=1)
    tiles = np.zeros((len(order), TILE_WORDS), np.int64)
    tiles[:, 0] = dst[tstart][order]
    tiles[:, 1] = tfd[order] | (n_in << 32)
    tiles[:, 2] = new_first
    for k in range(INLINE):                        # the first pairs' records, inline
        has = n_in > k
        tiles[has, 4 + 2 * k:6 + 2 * k] = pairs[new_first[has] + k]
    store_end = int(max((ch[:, 0] + (u - 1) * ch[:, 1] + u).max(),
                        (ch[:, 3] + ch[:, 4] * ch[:, 4]).max()))
    t64 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.int64), device=device)
    return EaLevel(
        children=children, rank=rank,
        ppos=torch.as_tensor(pp.astype(np.int32), device=device),
        child_table=t64(children), tiles=t64(tiles), pairs=t64(pairs), classes=classes,
        dest_entries=dest_entries, store_end=store_end)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _layer_indices(lvl: EaLevel, sel):
    """(source, destination) store indices of every entry of the Schur blocks of
    the children ``sel``."""
    dev = lvl.child_table.device
    ch = lvl.child_table[torch.as_tensor(sel, device=dev)]
    u = ch[:, 2]
    cid = torch.repeat_interleave(torch.arange(len(sel), device=dev), u * u)
    start = torch.cumsum(u * u, 0) - u * u
    t = torch.arange(cid.shape[0], device=dev) - start[cid]
    uc = u[cid]
    i = t // uc
    j = t - i * uc
    c = ch[cid]
    pp = lvl.ppos.long()
    src = c[:, 0] + i * c[:, 1] + j
    dst = c[:, 3] + pp[c[:, 5] + i] * c[:, 4] + pp[c[:, 5] + j]
    return src, dst


def extend_add_plain(store, lvl: EaLevel) -> None:
    """Plain version of the kernel, IN PLACE: per rank of children one gather
    and one ``index_add_`` over the real ``u x u`` entries; within a rank the
    destinations are distinct, so every destination receives its adds one at a
    time in the table's order."""
    _counts["plain"] += 1
    for sel in lvl.layers:
        src, dst = _layer_indices(lvl, sel)
        store.index_add_(0, dst, store.index_select(0, src))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

_PTR = ctypes.c_void_p


def _library():
    from ._cuda_build import load_cuda_library

    lib = load_cuda_library("extend_add.cu")
    if not getattr(lib, "_typed", False):
        for fn in (lib.extend_add_f32, lib.extend_add_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           _PTR, _PTR]
            fn.restype = ctypes.c_int
        lib.extend_add_attributes.argtypes = [ctypes.c_int, _PTR]
        lib.extend_add_attributes.restype = ctypes.c_int
        lib.extend_add_error_string.argtypes = [ctypes.c_int]
        lib.extend_add_error_string.restype = ctypes.c_char_p
        lib.extend_add_layout.argtypes = [_PTR]
        lib.extend_add_layout.restype = None
        layout = (ctypes.c_int * 4)()
        lib.extend_add_layout(layout)
        if tuple(layout) != (ROWS, TILE, INLINE, TILE_WORDS):
            raise RuntimeError(f"extend_add.cu reads tables of (ROWS, TILE, INLINE, "
                               f"TILE_WORDS) = {tuple(layout)}, build_ea_level writes "
                               f"{(ROWS, TILE, INLINE, TILE_WORDS)}")
        lib._typed = True
    return lib


def extend_add(store, lvl: EaLevel) -> None:
    """Add every child's Schur block of the level into its parent front, IN
    PLACE on the flat store (see the module's text).  On a CUDA tensor this
    launches the kernel of ``csrc/extend_add.cu`` on the current stream or
    raises; a CPU tensor takes the plain version."""
    if store.dim() != 1:
        raise ValueError("store must be a flat vector")
    if store.numel() < lvl.store_end:
        raise ValueError("the level's fronts reach outside the store")
    if lvl.tiles.device != store.device:
        raise ValueError("the level's tables must be on store's device")
    if store.device.type == "cpu":
        extend_add_plain(store, lvl)
        return
    if store.device.type != "cuda":
        raise ValueError(f"unsupported device {store.device}")
    if store.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the extend-add kernel takes float32/float64, got {store.dtype}")
    if not store.is_contiguous():
        raise ValueError("the extend-add kernel takes a contiguous store")
    if lvl.kernels == 0:
        return
    lib = _library()
    fn = lib.extend_add_f64 if store.dtype == torch.float64 else lib.extend_add_f32
    launched = ctypes.c_int(0)
    _launch("extend_add", fn, lib.extend_add_error_string, store.device,
            store.data_ptr(), lvl.tiles.data_ptr(), lvl.pairs.data_ptr(), *lvl.classes,
            ctypes.addressof(launched))
    _counts["calls"] += 1
    _counts["kernels"] += launched.value


def ea_attributes(dtype: torch.dtype) -> dict:
    """What the compiler and the card made of the kernel for ``dtype``
    (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``):
    registers per thread, local (spill) bytes per thread, threads per block,
    resident blocks and warps per SM.  Needs the card."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the extend-add kernel takes float32/float64, got {dtype}")
    lib = _library()
    out = (ctypes.c_int * 4)()
    err = lib.extend_add_attributes(int(dtype == torch.float64), out)
    if err:
        raise RuntimeError("extend_add_attributes: "
                           + lib.extend_add_error_string(err).decode())
    regs, local, threads, blocks = out
    return dict(registers=regs, spill_bytes=local, threads_per_block=threads,
                blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32)


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


def ea_bound_terms(levels, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of the extend-add of
    ``levels`` (an :class:`EaLevel` or a sequence of them) on an H100 SXM.
    Bytes: every child's ``u x u`` block read once, every distinct destination
    entry read and written once, ``ppos`` (int32) and the child rows of the
    table (int64) read once.  The kernel's own work list (tiles and pairs) is
    this design's traffic and does not count.  Operations: one addition per
    child entry."""
    if isinstance(levels, EaLevel):
        levels = [levels]
    size = torch.finfo(dtype).bits // 8
    nbytes = ops = 0.0
    for lvl in levels:
        u = lvl.children[:, 2].astype(np.float64)
        entries = float((u * u).sum())
        nbytes += (entries + 2.0 * lvl.dest_entries) * size + 4.0 * float(u.sum()) \
            + 8.0 * lvl.children.size
        ops += entries
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def ea_bound_ms(levels, dtype: torch.dtype):
    """(bound_ms, bound_by): the larger of the two bound terms."""
    t_bytes, t_ops = ea_bound_terms(levels, dtype)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
