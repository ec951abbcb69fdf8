"""Triangular sweeps of the flat LDL^T solve, one call per tree level: the
hand-written CUDA kernels, their wrappers, their plain PyTorch versions and
the per-level tables both read.

Counterpart of ``_fwd_one`` / ``_bwd_one`` of
galahad_tpu/linalg/supernodal_flat.py (run there through the jitted scans
``_k_fwd_scan`` / ``_k_bwd_scan``, one step per chunk of fronts).  The CUDA
source is ``csrc/sweep.cu``, built by ``nvcc`` and bound with ``ctypes`` at the
first call on a CUDA tensor (see ``_cuda_build.py``); importing this module
needs no card.

For every front ``F`` (``Fpad x Fpad``, row-major in the flat store) of a tree
level, with ``ncols`` eliminated columns, ``nf`` real rows and the row map
``fr`` (padded rows point at the spare slot ``y[n]``, which holds 0):

:func:`sweep_fwd`   ``z = L11^-1 y[fr[:ncols]]``; ``y[fr[:ncols]] = z / dsafe``
    (``dsafe_j = d_j``, or 1 where ``|d_j| <= 16 tiny``); the struct rows
    ``fr[ncols:nf]`` of ``y`` receive ``-L21 z``.  Several fronts of a level may
    add into one row: each writes its change into the scratch ``work`` (indexed
    like the level's row map) and the accumulation adds, per distinct
    destination row, the listed scratch entries in a fixed order.
:func:`sweep_bwd`   ``y[fr[:ncols]] = L11^-T (y[fr[:ncols]] - L21^T y[fr[ncols:nf]])``.

``L`` is the unit-lower triangle strictly below the diagonal of the columns
``< ncols`` and of the rows ``< nf`` only: both versions mask by ``ncols`` and
``nf`` and never rely on what the store holds in the Schur block, the upper
triangle or the padded rows.  Fronts of one level are never
ancestors of each other, so a level is one call in either direction.

Each wrapper takes its plain version only for tensors on the CPU; on CUDA
tensors it launches the kernels (and counts the launches) or raises.

:func:`sweep_bound_ms` is the least time an H100 SXM could take: the larger of
the bytes over the memory rate and the operations over the vector rate.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .._device import tiny16
from .ldlt_kernels import H100_BYTES_PER_S, H100_FLOPS, _launch

SMALL_FRONTS = (8, 16, 32)        # a lane per row / column, several fronts per warp
_BLOCK_THREADS = 256              # THREADS of sweep.cu
TABLE_WIDTH = 8                   # TW of sweep.cu
ITEM = 32                         # rows (forward) / columns (backward) of a wavefront item
# a front with at most ITEM eliminated columns and at most this many struct
# rows is one forward item (its triangle and its struct rows)
STRUCT_INLINE = 96
# polls of a flag after which a block of the wavefront kernel gives up, marks
# the call as failed and leaves (a wrong table must not hang the card)
SPIN_POLLS = 10 ** 8

_counts = dict(fwd=0, bwd=0, fwd_kernels=0, bwd_kernels=0, plain=0)


def sweep_launch_count() -> int:
    """Calls of :func:`sweep_fwd` and :func:`sweep_bwd` that launched kernels."""
    return _counts["fwd"] + _counts["bwd"]


def sweep_plain_count() -> int:
    """Calls of the plain sweeps (0 on a path that runs on the card)."""
    return _counts["plain"]


def sweep_counts() -> dict:
    """All counts: launching calls (``fwd``, ``bwd``), the kernel launches
    they made as the C launchers report them (``fwd_kernels``,
    ``bwd_kernels``) and plain calls (``plain``)."""
    return dict(_counts)


def reset_sweep_counts() -> None:
    for k in _counts:
        _counts[k] = 0


@dataclasses.dataclass
class SweepLevel:
    """Tables of one tree level, built once per plan and device.

    ``batches`` (host) lists the level's runs of equally sized fronts that are
    contiguous in the store: ``(store offset, Fpad, fronts, row-map offset,
    ncols offset, largest ncols)``.  ``fronts`` (host, one row per front) holds
    ``(Fpad, ncols, nf)``.  The device tensors are what the kernels read:
    ``rows`` the concatenated row maps (int32), ``ncols`` (int32), and the
    work-item tables (int64, ``TABLE_WIDTH`` columns):

    ``small``     a block's worth of fronts of 8 / 16 / 32: store offset,
                  row-map offset, ncols offset, Fpad, fronts
    ``fwd_wave``  the forward items of the fronts of 64 or more with
                  ``ncols > 0``, in ticket order: store offset, row-map offset,
                  Fpad, lo, hi, ncols, nf, flag base.  Rows ``lo .. hi``: the
                  rows below ``ncols`` are one triangle row block (``lo`` a
                  multiple of ``ITEM``), the rows from ``ncols`` on struct rows
                  (an item with both holds its front's last triangle block).
    ``bwd_wave``  the backward items, one per column block ``lo .. hi`` (the
                  same columns), in ticket order.

    Triangle block ``j`` of a front with ``blocks`` of them publishes flag
    ``flag base + j`` forward and ``flag base + blocks - 1 - j`` backward; an
    item waits on the flags of the blocks before its own in its direction
    (all of them for struct rows), and every item is listed after each item
    it waits on (:func:`item_waits`).  ``sync`` (int32, device) holds the
    ticket counter, the abort word and the ``n_flags`` flags, cleared at every
    call; ``status`` (int32, host memory the card writes) is set to 1 + the
    item's ticket by a block whose wait timed out, and stays set.

    Then the accumulation lists: destination rows ``acc_row`` (distinct,
    ascending), and per destination the scratch positions
    ``acc_pos[acc_ptr[k]:acc_ptr[k+1]]`` (ascending) whose sum it receives.
    ``work_size`` is the scratch length a call needs.  ``fwd_kernels`` /
    ``bwd_kernels`` are the kernel launches the tables call for in one
    :func:`sweep_fwd` / :func:`sweep_bwd` on the card (the counters add what
    the launchers report, not these)."""
    n: int
    batches: list
    fronts: np.ndarray
    rows: torch.Tensor
    ncols: torch.Tensor
    small: torch.Tensor
    fwd_wave: torch.Tensor
    bwd_wave: torch.Tensor
    n_flags: int
    sync: torch.Tensor
    status: torch.Tensor
    acc_row: torch.Tensor
    acc_ptr: torch.Tensor
    acc_pos: torch.Tensor
    acc_len: torch.Tensor        # int64 run lengths, for the plain accumulation
    work_size: int
    store_end: int               # one past the last store element a front covers

    fwd_kernels: int = 0
    bwd_kernels: int = 0
    _pointers: dict = None

    def __post_init__(self):
        self.bwd_kernels = int(self.small.shape[0] > 0) + int(self.bwd_wave.shape[0] > 0)
        self.fwd_kernels = (int(self.small.shape[0] > 0) + int(self.fwd_wave.shape[0] > 0)
                            + int(self.acc_row.shape[0] > 0))
        self._status = self.status.numpy() if self.status.device.type == "cpu" else None

    def pointers(self, direction: str) -> tuple:
        """The launchers' table arguments (the tables never move): rows,
        ncols, small, its items, the direction's wavefront items and their
        count, sync, flags, status; forward also the accumulation's rows,
        pointers, positions and count."""
        if self._pointers is None:
            common = (self.rows.data_ptr(), self.ncols.data_ptr(), self.small.data_ptr(),
                      self.small.shape[0])
            sync = (self.sync.data_ptr(), self.n_flags, self.status.data_ptr())
            self._pointers = dict(
                fwd=common + (self.fwd_wave.data_ptr(), self.fwd_wave.shape[0]) + sync
                + (self.acc_row.data_ptr(), self.acc_ptr.data_ptr(),
                   self.acc_pos.data_ptr(), self.acc_row.shape[0]),
                bwd=common + (self.bwd_wave.data_ptr(), self.bwd_wave.shape[0]) + sync)
        return self._pointers[direction]

    def failed_item(self):
        """The ticket of the wavefront item whose wait timed out in an earlier
        call on the card, or None.  Reads host memory: no synchronisation, so
        a call still running is not seen."""
        if self._status is None or not self._status[0]:
            return None
        return int(self._status[0]) - 1


def item_waits(item, direction: str):
    """(the flags a wavefront item waits on, in order; the flag it publishes,
    or None) for one row of ``fwd_wave`` / ``bwd_wave``."""
    _, _, _, lo, hi, nc, _, fb = (int(v) for v in item)
    blocks = -(-nc // ITEM)
    if direction == "fwd":
        if lo < nc:
            b = lo // ITEM
            return list(range(fb, fb + b)), fb + b
        return list(range(fb, fb + blocks)), None
    k = blocks - 1 - lo // ITEM
    return list(range(fb, fb + k)), fb + k


def _wave_items(o, r, Fpad, nc, nf, fb, order):
    """The forward and backward items of one front of 64 or more, each with
    its sort key: items that wait or are waited on by (wave, longest chain
    first, front), the others after them, heaviest first."""
    blocks = -(-nc // ITEM)
    head = (o, r, Fpad)
    fwd, bwd = [], []
    if blocks == 1 and nf - nc <= STRUCT_INLINE:
        fwd.append(((1, -nc * nf, order), head + (0, nf, nc, nf, fb)))
    else:
        for b in range(blocks):
            fwd.append(((0, b, -blocks, order),
                        head + (b * ITEM, min(b * ITEM + ITEM, nc), nc, nf, fb)))
        for r0 in range(nc, nf, ITEM):
            fwd.append(((0, blocks, -blocks, order),
                        head + (r0, min(r0 + ITEM, nf), nc, nf, fb)))
    if blocks == 1:
        bwd.append(((1, -nc * nf, order), head + (0, nc, nc, nf, fb)))
    else:
        for c in range(blocks - 1, -1, -1):
            bwd.append(((0, blocks - 1 - c, -blocks, order),
                        head + (c * ITEM, min(c * ITEM + ITEM, nc), nc, nf, fb)))
    return fwd, bwd


def build_sweep_level(batches, n: int, device) -> SweepLevel:
    """Tables for ``batches``, a sequence of ``(offset, Fpad, ncols, frows)``:
    ``len(ncols)`` fronts of ``Fpad`` start at element ``offset`` of the flat
    store, ``frows (nb, Fpad)`` are their global rows, padded with values
    ``>= n``.  ``n`` is the spare slot's index in ``y``."""
    if n + 1 >= 2 ** 31:
        raise ValueError("the sweep kernels index y with 32-bit integers")
    device = torch.device(device)
    host, fronts, rows_all, nc_all = [], [], [], []
    small, fwd, bwd = [], [], []
    acc_dest, acc_src = [], []
    fro = nco = n_flags = store_end = 0
    for off, Fpad, nco_b, frows in batches:
        nco_b = np.asarray(nco_b, np.int64)
        frows = np.asarray(frows, np.int64).reshape(len(nco_b), Fpad)
        nb = len(nco_b)
        if nb == 0:
            continue
        fr = np.where(frows < n, frows, n)
        nf = (fr < n).sum(axis=1)
        if np.any(nco_b > nf) or np.any(nco_b < 0):
            raise ValueError("ncols must lie between 0 and the front's real rows")
        if np.any((fr < n) != (np.arange(Fpad)[None, :] < nf[:, None])):
            raise ValueError("the padded rows of a front must follow its real rows")
        if Fpad not in SMALL_FRONTS and (Fpad < 64 or Fpad % 32):
            raise ValueError(f"the sweep kernels take fronts of {SMALL_FRONTS} or a "
                             f"multiple of 32 from 64 on, got {Fpad}")
        host.append((int(off), int(Fpad), nb, fro, nco, int(nco_b.max())))
        fronts.append(np.stack([np.full(nb, Fpad), nco_b, nf], axis=1))
        rows_all.append(fr.ravel())
        nc_all.append(nco_b)
        store_end = max(store_end, int(off) + nb * Fpad * Fpad)
        if Fpad in SMALL_FRONTS:
            per = _BLOCK_THREADS // Fpad
            for i in range(0, nb, per):
                if nco_b[i:i + per].max() > 0:
                    small.append((-Fpad, off + i * Fpad * Fpad, fro + i * Fpad, nco + i,
                                  Fpad, min(per, nb - i)))
        else:
            for i in np.flatnonzero(nco_b > 0):
                nc, nfi = int(nco_b[i]), int(nf[i])
                f_items, b_items = _wave_items(
                    int(off) + int(i) * Fpad * Fpad, fro + int(i) * Fpad, Fpad, nc, nfi,
                    n_flags, len(host) * 2 ** 32 + int(i))
                fwd += f_items
                bwd += b_items
                n_flags += -(-nc // ITEM)
        # scratch positions of the struct rows of fronts that eliminate something
        pos = np.arange(Fpad)[None, :]
        struct = (pos >= nco_b[:, None]) & (pos < nf[:, None]) & (nco_b[:, None] > 0)
        where = np.flatnonzero(struct.ravel())
        acc_dest.append(fr.ravel()[where])
        acc_src.append(fro + where)
        fro += nb * Fpad
        nco += nb
    if fro >= 2 ** 31:
        raise ValueError("the sweep kernels index a level's rows with 32-bit integers")
    small.sort(key=lambda r: r[0])

    def table(items, skip):
        out = np.zeros((len(items), TABLE_WIDTH), np.int64)
        for k, item in enumerate(items):
            out[k, :len(item) - skip] = item[skip:]
        return torch.as_tensor(out, device=device)

    def wave(items):
        items.sort(key=lambda r: r[0])
        return table([it[1] for it in items], 0)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    cat = lambda parts: np.concatenate(parts) if parts else np.zeros(0, np.int64)
    dest, src = cat(acc_dest), cat(acc_src)
    order = np.argsort(dest, kind="stable")      # sources stay ascending per destination
    uniq, counts = np.unique(dest, return_counts=True)
    status = torch.zeros(1, dtype=torch.int32)
    if device.type == "cuda":
        status = status.pin_memory()             # the card writes it, the host reads it
    return SweepLevel(
        n=int(n), batches=host,
        fronts=(np.concatenate(fronts) if fronts else np.zeros((0, 3), np.int64)),
        rows=i32(cat(rows_all)), ncols=i32(cat(nc_all)),
        small=table(small, 1), fwd_wave=wave(fwd), bwd_wave=wave(bwd),
        n_flags=n_flags, sync=torch.zeros(2 + n_flags, dtype=torch.int32, device=device),
        status=status,
        acc_row=i32(uniq), acc_ptr=i32(np.concatenate([[0], np.cumsum(counts)])),
        acc_pos=i32(src[order]),
        acc_len=torch.as_tensor(counts.astype(np.int64), device=device),
        work_size=fro, store_end=store_end)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _batch_views(store, lvl: SweepLevel, batch):
    """(fronts F, their first cmax columns masked to the strictly-lower L of the
    real rows, the mask of eliminated positions (nb, cmax), the row maps) of
    one batch."""
    off, Fpad, nb, fro, nco, cmax = batch
    F = store[off:off + nb * Fpad * Fpad].view(nb, Fpad, Fpad)
    fr = lvl.rows[fro:fro + nb * Fpad].view(nb, Fpad).long()
    nc = lvl.ncols[nco:nco + nb].long()
    elim = torch.arange(cmax, device=store.device)[None, :] < nc[:, None]
    keep = (fr < lvl.n)[:, :, None] & elim[:, None, :]
    L = torch.tril(torch.where(keep, F[:, :, :cmax], 0.0), -1)
    return F, L, elim, fr


def _write_eliminated(y, lvl: SweepLevel, fr_c, elim, vals) -> None:
    """y[fr] = vals on the eliminated positions; the others write the 0 that the
    spare slot holds."""
    y.index_copy_(0, torch.where(elim, fr_c, lvl.n).reshape(-1),
                  torch.where(elim, vals, 0.0).reshape(-1))


def sweep_fwd_plain(store, y, lvl: SweepLevel, work) -> None:
    """Plain version of the forward kernels: per batch one triangular solve and
    one batched product; fills ``work`` and the eliminated rows of ``y``."""
    _counts["plain"] += 1
    tiny = tiny16(store.dtype)
    for batch in lvl.batches:
        off, Fpad, nb, fro, nco, cmax = batch
        if cmax == 0:
            continue
        F, L, elim, fr = _batch_views(store, lvl, batch)
        fr_c = fr[:, :cmax]
        v = torch.where(elim, y.index_select(0, fr_c.reshape(-1)).view(nb, cmax), 0.0)
        # rows [ncols, cmax) of a front come out of the solve as -(L21 z)
        zc = torch.linalg.solve_triangular(
            L[:, :cmax, :], v[:, :, None], upper=False, unitriangular=True)[..., 0]
        z = torch.where(elim, zc, 0.0)
        below = -(L[:, cmax:, :] @ z[:, :, None])[..., 0]
        work[fro:fro + nb * Fpad] = torch.cat([zc, below], dim=1).reshape(-1)
        d = torch.diagonal(F, dim1=1, dim2=2)[:, :cmax]
        dsafe = torch.where(elim & (d.abs() > tiny), d, 1.0)
        _write_eliminated(y, lvl, fr_c, elim, z / dsafe)


def sweep_accumulate_plain(y, lvl: SweepLevel, work) -> None:
    """Plain version of the accumulation: per distinct destination row the sum
    of its scratch entries, in list order, added to ``y``."""
    if lvl.acc_row.shape[0] == 0:
        return
    sums = torch.segment_reduce(work.index_select(0, lvl.acc_pos.long()), "sum",
                                lengths=lvl.acc_len, unsafe=True)
    rows = lvl.acc_row.long()
    y.index_copy_(0, rows, y.index_select(0, rows) + sums)


def sweep_bwd_plain(store, y, lvl: SweepLevel) -> None:
    """Plain version of the backward kernels: per batch one batched product and
    one transposed triangular solve."""
    _counts["plain"] += 1
    for batch in lvl.batches:
        off, Fpad, nb, fro, nco, cmax = batch
        if cmax == 0:
            continue
        F, L, elim, fr = _batch_views(store, lvl, batch)
        yF = y.index_select(0, fr.reshape(-1)).view(nb, Fpad)
        rhs = yF[:, :cmax, None] - L[:, cmax:, :].transpose(-1, -2) @ yF[:, cmax:, None]
        # a row in [ncols, cmax) has an identity row in the masked L^T: it passes
        # its y through to the rows above it
        x = torch.linalg.solve_triangular(
            L[:, :cmax, :].transpose(-1, -2), rhs, upper=True, unitriangular=True)[..., 0]
        _write_eliminated(y, lvl, fr[:, :cmax], elim, x)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_PTR = ctypes.c_void_p


def _library():
    from ._cuda_build import load_cuda_library

    lib = load_cuda_library("sweep.cu")
    if not getattr(lib, "_typed", False):
        tables = [_PTR, ctypes.c_int, _PTR, ctypes.c_int, _PTR, ctypes.c_int, _PTR,
                  ctypes.c_longlong]
        for fn in (lib.sweep_fwd_f32, lib.sweep_fwd_f64):
            fn.argtypes = [_PTR] * 4 + tables + [_PTR, _PTR, _PTR, ctypes.c_int, _PTR,
                                                 ctypes.c_double, _PTR, _PTR]
            fn.restype = ctypes.c_int
        for fn in (lib.sweep_bwd_f32, lib.sweep_bwd_f64):
            fn.argtypes = [_PTR] * 4 + tables + [_PTR, ctypes.c_int, _PTR, _PTR]
            fn.restype = ctypes.c_int
        lib.sweep_error_string.argtypes = [ctypes.c_int]
        lib.sweep_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_operands(store, y, lvl: SweepLevel, work) -> None:
    """Raise on what the kernels do not take (devices, types, sizes)."""
    if store.dim() != 1 or y.dim() != 1:
        raise ValueError("store and y must be flat vectors")
    if y.dtype != store.dtype or y.device != store.device:
        raise ValueError("store and y must have one dtype and device")
    if y.numel() != lvl.n + 1:
        raise ValueError(f"y must have {lvl.n + 1} entries (the last is the spare slot)")
    if store.numel() < lvl.store_end:
        raise ValueError("the level's fronts reach outside the store")
    if (work.dim() != 1 or work.dtype != store.dtype or work.device != store.device
            or work.numel() < lvl.work_size):
        raise ValueError(f"work must be a vector of at least {lvl.work_size} entries "
                         f"of store's dtype and device")
    if lvl.rows.device != store.device:
        raise ValueError("the level's tables must be on store's device")
    if store.device.type == "cpu":
        return
    if store.device.type != "cuda":
        raise ValueError(f"unsupported device {store.device}")
    if store.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep kernels take float32/float64, got {store.dtype}")
    if not (store.is_contiguous() and y.is_contiguous() and work.is_contiguous()):
        raise ValueError("sweep kernels take contiguous vectors")
    item = lvl.failed_item()
    if item is not None:
        raise RuntimeError(
            f"an earlier sweep on this level gave up waiting in the wavefront kernel "
            f"(item {item} of its table): the table breaks the ticket order")


def sweep_check(levels, synchronize: bool = True) -> None:
    """Synchronise the card and raise if a call on any of ``levels`` (a
    :class:`SweepLevel` or a sequence of them) gave up waiting in the
    wavefront kernel.  The wrappers raise for it at their next call on the
    level; this asks at once.  ``synchronize=False`` is for a caller that
    has already waited for the calls it asks about (a replayed CUDA graph
    runs no wrapper, so its driver asks here after each read)."""
    if isinstance(levels, SweepLevel):
        levels = [levels]
    if synchronize and torch.cuda.is_available():
        torch.cuda.synchronize()
    for lvl in levels:
        item = lvl.failed_item()
        if item is not None:
            raise RuntimeError(f"a sweep gave up waiting in the wavefront kernel (item "
                               f"{item} of its table): the table breaks the ticket order")


def sweep_fwd(store, y, lvl: SweepLevel, work) -> None:
    """Forward sweep and diagonal scale of every front of the level, on ``y``
    IN PLACE (see the module's text).  ``store`` is the flat factor store,
    ``y (n + 1,)`` the right-hand side with its spare slot, ``work``
    scratch of at least ``lvl.work_size`` entries (its contents on entry do
    not matter).  On CUDA tensors this launches the kernels of
    ``csrc/sweep.cu`` on the current stream or raises; CPU tensors take the
    plain version."""
    _check_operands(store, y, lvl, work)
    if lvl.work_size == 0:
        return
    if store.device.type == "cpu":
        sweep_fwd_plain(store, y, lvl, work)
        sweep_accumulate_plain(y, lvl, work)
        return
    if lvl.fwd_kernels == 0:
        return
    lib = _library()
    fn = lib.sweep_fwd_f64 if store.dtype == torch.float64 else lib.sweep_fwd_f32
    launched = ctypes.c_int(0)
    _launch("sweep_fwd", fn, lib.sweep_error_string, store.device,
            store.data_ptr(), y.data_ptr(), *lvl.pointers("fwd")[:9], SPIN_POLLS,
            *lvl.pointers("fwd")[9:], work.data_ptr(), tiny16(store.dtype),
            ctypes.addressof(launched))
    _counts["fwd"] += 1
    _counts["fwd_kernels"] += launched.value


def sweep_bwd(store, y, lvl: SweepLevel, work) -> None:
    """Backward sweep (with L^T) of every front of the level, on ``y`` IN
    PLACE; operands as :func:`sweep_fwd`."""
    _check_operands(store, y, lvl, work)
    if lvl.work_size == 0:
        return
    if store.device.type == "cpu":
        sweep_bwd_plain(store, y, lvl)
        return
    if lvl.bwd_kernels == 0:
        return
    lib = _library()
    fn = lib.sweep_bwd_f64 if store.dtype == torch.float64 else lib.sweep_bwd_f32
    launched = ctypes.c_int(0)
    _launch("sweep_bwd", fn, lib.sweep_error_string, store.device,
            store.data_ptr(), y.data_ptr(), *lvl.pointers("bwd"), SPIN_POLLS,
            work.data_ptr(), lvl.n, ctypes.addressof(launched))
    _counts["bwd"] += 1
    _counts["bwd_kernels"] += launched.value


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


def sweep_bound_terms(levels, dtype: torch.dtype, direction: str):
    """(seconds for the bytes, seconds for the operations) of one sweep over
    ``levels`` (a :class:`SweepLevel` or a sequence of them) on an H100 SXM,
    ``direction`` ``"fwd"`` or ``"bwd"``.  Only fronts that eliminate a column
    count.  Bytes, every item once: the L entries strictly below the diagonal
    of the eliminated columns (and, forward, the diagonal); the front's row map
    (int32) and its ``ncols``; of ``y`` the eliminated rows read and written,
    backward the struct rows read, forward each distinct destination row read
    and written.  The kernels' own scratch (struct-row changes, the
    published z and x), the ready flags, the ticket counter and the
    accumulation lists are traffic of this design, not of the sweep, and do
    not count.  Operations: two per L entry, forward one division per eliminated column
    and one addition per accumulated entry."""
    if direction not in ("fwd", "bwd"):
        raise ValueError("direction is 'fwd' or 'bwd'")
    if isinstance(levels, SweepLevel):
        levels = [levels]
    size = torch.finfo(dtype).bits // 8
    nbytes = ops = 0.0
    for lvl in levels:
        fr = lvl.fronts[lvl.fronts[:, 1] > 0].astype(np.float64)
        nc, nf = fr[:, 1], fr[:, 2]
        entries = float((nc * nf - nc * (nc + 1) / 2).sum())
        nbytes += entries * size + 4.0 * float(nf.sum()) + 4.0 * len(fr)
        ops += 2.0 * entries
        if direction == "fwd":
            struct, dests = float((nf - nc).sum()), float(lvl.acc_row.shape[0])
            nbytes += (3.0 * float(nc.sum()) + 2.0 * dests) * size
            ops += float(nc.sum()) + struct
        else:
            nbytes += (float(nf.sum()) + float(nc.sum())) * size
    return nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[dtype]


def sweep_bound_ms(levels, dtype: torch.dtype, direction: str):
    """(bound_ms, bound_by): the larger of the two bound terms."""
    t_bytes, t_ops = sweep_bound_terms(levels, dtype, direction)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
