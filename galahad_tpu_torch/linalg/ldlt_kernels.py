"""Batched partial LDL^T of padded fronts: the hand-written CUDA kernels,
their wrappers and their plain PyTorch versions.

Counterpart of galahad_tpu/linalg/pallas_kernels.py (``partial_ldlt_pallas``)
and, for fronts wider than that kernel takes, of its XLA twin
``_partial_ldlt_dyn`` (run through ``_k_factor_scan``).  Two CUDA sources,
built by ``nvcc`` and bound with ``ctypes`` at the first call on a CUDA
tensor (see ``_cuda_build.py``); importing this module needs no card:

``csrc/partial_ldlt.cu``  :func:`partial_ldlt` (a uniform batch) and
    :func:`partial_ldlt_items` (every small front of a tree level in one
    call, through a table of work items), ``Fpad`` in 8..128: fronts of
    8, 16, 32 in registers with a lane per row, fronts of 64, 96, 128 in
    shared memory in panels of 8 columns.
``csrc/ldlt_wide.cu``     :func:`partial_ldlt_wide`, every front wider than
    128 of a tree level in one persistent cooperative launch (panels of 32
    columns; the trailing update of the lower triangle on the float64 tensor
    cores), through the work table of :func:`build_wide_level`.

Storage contract (consumed by the solves and the extend-add): column
``j < ncols[i]`` of front ``i`` holds ``d_j`` on the diagonal and the
unit-lower L below it; entries ABOVE the diagonal of eliminated columns
(and, for the wide fronts, entries above the diagonal in a row ``< ncols``)
are unspecified; the trailing square holds the Schur complement
``F22 - L21 D L21^T`` in both triangles.  A pivot with ``|d| <= 16 tiny``
is left in place and divided by 1 instead.  Fronts are symmetric on entry.

Each wrapper takes its plain version only for a tensor on the CPU; on a
CUDA tensor it launches its kernel (and counts the launch) or raises.

Bounds on the card: :func:`ldlt_bound_ms` and :func:`wide_bound_ms`
return the larger of the bytes (every input read once, every output
written once) over the memory rate and the operations over the rate of
the units the kernel uses.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .._device import tiny16

MAX_KERNEL_FRONT = 128
KERNEL_FRONTS = (8, 16, 32, 64, 96, 128)     # the sizes partial_ldlt.cu serves
PANEL = 32                                   # the panel width ldlt_wide.cu serves
_BLOCK_THREADS = 256                         # THREADS of partial_ldlt.cu

# wrapper calls of partial_ldlt / partial_ldlt_items that launched a kernel
_launches = 0

# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; 67 TFLOP/s float32 and
# 34 TFLOP/s float64 outside the tensor cores, 67 TFLOP/s float64 on them
# (dense, 700 W).
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
H100_F64_TENSOR_FLOPS = 67e12


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    """Set the counts of both kernels' wrappers to 0."""
    global _launches
    _launches = 0
    for k in _wide:
        _wide[k] = 0


def partial_ldlt_plain(F: torch.Tensor, ncols: torch.Tensor,
                       cmax: int = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a right-looking column
    loop over the whole batch.  Runs on any device; used by the CPU tests
    and, on the card, only to hold the kernel against.  ``cmax``, the
    largest of ``ncols`` if the caller knows it, spares a host read."""
    nb, Fpad, _ = F.shape
    F = F.clone()
    if nb == 0:
        return F
    ncols = ncols.to(device=F.device, dtype=torch.int64).clamp(max=Fpad)
    cmax = min(int(ncols.max()) if cmax is None else cmax, Fpad)
    tiny = tiny16(F.dtype)
    for j in range(cmax):
        active = ncols > j                                   # (nb,)
        d = F[:, j, j]
        dn = torch.where(active & (d.abs() > tiny), d, torch.ones_like(d))
        if j + 1 < Fpad:
            col = F[:, j + 1:, j]
            l = torch.where(active[:, None], col / dn[:, None],
                            torch.zeros_like(col))
            F[:, j + 1:, j + 1:] -= l[:, :, None] * (dn[:, None] * l)[:, None, :]
            F[:, j + 1:, j] = torch.where(active[:, None], l, col)
    return F


_PTR = ctypes.c_void_p


def _library():
    from ._cuda_build import load_cuda_library

    lib = load_cuda_library("partial_ldlt.cu")
    if not getattr(lib, "_typed", False):
        for fn in (lib.partial_ldlt_f32, lib.partial_ldlt_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int,
                           ctypes.c_double, _PTR]
            fn.restype = ctypes.c_int
        for fn in (lib.partial_ldlt_items_f32, lib.partial_ldlt_items_f64):
            fn.argtypes = [_PTR, _PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_double, _PTR]
            fn.restype = ctypes.c_int
        lib.partial_ldlt_error_string.argtypes = [ctypes.c_int]
        lib.partial_ldlt_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda_operands(name: str, F: torch.Tensor, ncols: torch.Tensor) -> None:
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    if F.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} kernel takes float32/float64, got {F.dtype}")
    if (ncols.device != F.device or ncols.dtype != torch.int32
            or not ncols.is_contiguous()):
        raise ValueError("ncols must be a contiguous int32 tensor on F's device")


def _launch(name: str, fn, error_string, device, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream and raise if it returns a CUDA error (a refused launch never
    runs, and a later synchronisation would not report it).  The device
    guard is taken only when another device is current: it costs more host
    time than the launch itself."""
    if torch.cuda.current_device() == device.index:
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")


def partial_ldlt(F: torch.Tensor, ncols: torch.Tensor,
                 inplace: bool = False) -> torch.Tensor:
    """Partial LDL^T of the fronts ``F (nb, Fpad, Fpad)``, eliminating the
    first ``ncols[i]`` columns of front ``i`` (``0 <= ncols[i] <= Fpad``).

    On a CUDA tensor this launches the hand-written kernel on the current
    stream (``Fpad`` in ``KERNEL_FRONTS``, float32 or float64, contiguous;
    ``ncols`` int32 on the same device) or raises; it never gives way to the
    plain version.  A CPU tensor takes :func:`partial_ldlt_plain`.  With
    ``inplace=True`` the result overwrites ``F`` (which may be a view of
    a larger buffer) and ``F`` is returned.
    """
    global _launches
    if F.dim() != 3 or F.shape[1] != F.shape[2]:
        raise ValueError(f"expected (nb, Fpad, Fpad) fronts, got {tuple(F.shape)}")
    nb, Fpad, _ = F.shape
    if ncols.shape != (nb,):
        raise ValueError("ncols must have one entry per front")
    if F.device.type == "cpu":
        out = partial_ldlt_plain(F, ncols)
        if inplace:
            F.copy_(out)
            return F
        return out
    _check_cuda_operands("partial_ldlt", F, ncols)
    if Fpad not in KERNEL_FRONTS:
        raise ValueError(f"partial_ldlt kernel takes Fpad in {KERNEL_FRONTS} "
                         f"(at most {MAX_KERNEL_FRONT}), got {Fpad}")
    if not F.is_contiguous():
        raise ValueError("partial_ldlt kernel takes contiguous fronts")
    out = F if inplace else torch.empty_like(F)
    if nb == 0:
        return out
    lib = _library()
    fn = lib.partial_ldlt_f64 if F.dtype == torch.float64 else lib.partial_ldlt_f32
    _launch("partial_ldlt", fn, lib.partial_ldlt_error_string, F.device,
            F.data_ptr(), out.data_ptr(), ncols.data_ptr(), nb, Fpad,
            tiny16(F.dtype))
    _launches += 1
    return out


# ---------------------------------------------------------------------------
# Several batches of different front sizes in one call
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LdltItems:
    """Work items of one call of :func:`partial_ldlt_items`: batches of
    fronts of the ladder sizes, each contiguous in one flat buffer.

    ``batches`` is the host-side list ``(offset, Fpad, nb, ncols offset)``
    and ``cmax`` the largest ncols of each batch;
    ``table`` is what the kernel reads, one row ``(offset of the first
    front, offset of its ncols, Fpad, number of fronts)`` per thread block:
    first the single fronts of 64..128 (heaviest first: the blocks that run
    longest start first), then the blocks' worths of fronts of 8..32."""
    batches: list
    cmax: list
    ncols: torch.Tensor          # int32, all batches' ncols, in batch order
    table: torch.Tensor          # (items, 4) int64
    n_medium: int
    medium_fpad_max: int
    n_small: int
    small_fpad_max: int
    start: int                   # first and one-past-last buffer element touched
    end: int

    @property
    def fronts(self) -> int:
        return sum(nb for _, _, nb, _ in self.batches)

    def shifted(self, delta: int) -> "LdltItems":
        """The same items with every buffer offset moved by ``delta`` (a
        multiple of 4): for a buffer that holds a window of the original."""
        if delta % 4:
            raise ValueError("offsets move by multiples of 4 elements")
        move = torch.tensor([delta, 0, 0, 0], dtype=torch.int64,
                            device=self.table.device)
        return dataclasses.replace(
            self, batches=[(o + delta, fp, nb, nco) for o, fp, nb, nco in self.batches],
            table=self.table + move, start=self.start + delta, end=self.end + delta)


def build_ldlt_items(batches, device) -> LdltItems:
    """Item table for ``batches``, a sequence of ``(offset, Fpad, ncols)``:
    ``len(ncols)`` fronts of ``Fpad`` (in ``KERNEL_FRONTS``) start at
    element ``offset`` (a multiple of 4, so that rows stay 16-byte aligned)
    of the flat buffer."""
    host, cmax, medium, small, nc_all = [], [], [], [], []
    nc_off = 0
    for off, Fpad, nco in batches:
        nco = np.asarray(nco, np.int64)
        nb = len(nco)
        if Fpad not in KERNEL_FRONTS:
            raise ValueError(f"partial_ldlt kernel takes Fpad in {KERNEL_FRONTS}, "
                             f"got {Fpad}")
        if off % 4:
            raise ValueError("batch offsets must be multiples of 4 elements")
        host.append((int(off), int(Fpad), nb, nc_off))
        cmax.append(int(nco.max()) if nb else 0)
        nc_all.append(nco)
        if Fpad > 32:
            for i in range(nb):
                medium.append((-Fpad, -int(nco[i]), off + i * Fpad * Fpad,
                               nc_off + i, Fpad, 1))
        else:
            per = _BLOCK_THREADS // Fpad
            for i in range(0, nb, per):
                small.append((-Fpad, 0, off + i * Fpad * Fpad, nc_off + i, Fpad,
                              min(per, nb - i)))
        nc_off += nb
    medium.sort()
    small.sort(key=lambda r: r[0])
    rows = [r[2:] for r in medium + small]
    return LdltItems(
        batches=host, cmax=cmax,
        ncols=torch.as_tensor(
            np.concatenate(nc_all).astype(np.int32) if nc_all
            else np.zeros(0, np.int32), device=device),
        table=torch.as_tensor(np.asarray(rows, np.int64).reshape(-1, 4),
                              device=device),
        n_medium=len(medium),
        medium_fpad_max=max((r[4] for r in medium), default=0),
        n_small=len(small),
        small_fpad_max=max((r[4] for r in small), default=0),
        start=min((o for o, _, _, _ in host), default=0),
        end=max((o + nb * fp * fp for o, fp, nb, _ in host), default=0))


def _items_plain_into(src, items: LdltItems, out) -> None:
    for (lo, Fpad, nb, nc_off), cmax in zip(items.batches, items.cmax):
        hi = lo + nb * Fpad * Fpad
        out[lo:hi] = partial_ldlt_plain(
            src[lo:hi].view(nb, Fpad, Fpad),
            items.ncols[nc_off:nc_off + nb], cmax).reshape(-1)


def partial_ldlt_items_plain(src: torch.Tensor, items: LdltItems) -> torch.Tensor:
    """Plain version of :func:`partial_ldlt_items`: :func:`partial_ldlt_plain`
    batch by batch, into a copy of ``src``."""
    out = src.clone()
    _items_plain_into(src, items, out)
    return out


def partial_ldlt_items(src: torch.Tensor, items: LdltItems, out=None) -> torch.Tensor:
    """Partial LDL^T of every batch of ``items`` in ONE call.  ``src`` is the
    flat contiguous buffer the items' offsets refer to.  The result
    overwrites ``src`` (``out=None``) or goes to the same places of ``out``,
    whose other elements are left as they are.  On a CUDA tensor it launches
    the kernel (at most one launch for the items of 64..128 and one for
    those of 8..32) or raises; a CPU tensor takes the plain version."""
    global _launches
    if out is None:
        out = src
    if src.dim() != 1 or out.shape != src.shape or out.dtype != src.dtype:
        raise ValueError("src and out must be flat buffers of one shape and type")
    if items.start < 0 or items.end > src.numel():
        raise ValueError("the items reach outside the buffer")
    if src.device.type == "cpu":
        _items_plain_into(src, items, out)
        return out
    _check_cuda_operands("partial_ldlt", src, items.ncols)
    if out.device != src.device or items.table.device != src.device:
        raise ValueError("src, out and the item table must be on one device")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("partial_ldlt kernel takes contiguous buffers")
    if items.table.shape[0] == 0:
        return out
    lib = _library()
    fn = (lib.partial_ldlt_items_f64 if src.dtype == torch.float64
          else lib.partial_ldlt_items_f32)
    _launch("partial_ldlt", fn, lib.partial_ldlt_error_string, src.device,
            src.data_ptr(), out.data_ptr(), items.ncols.data_ptr(),
            items.table.data_ptr(), items.n_medium, items.medium_fpad_max,
            items.n_small, items.small_fpad_max, tiny16(src.dtype))
    _launches += 1
    return out


# ---------------------------------------------------------------------------
# Every front wider than the kernel above takes, a tree level per call
# ---------------------------------------------------------------------------


def ldlt_panel_slab_plain(P: torch.Tensor, ncols: torch.Tensor, b: int):
    """One panel step of the blocked elimination in plain PyTorch, on the
    panel slab ``P = F[:, b:, b:b+B]`` (ch, Fpad-b, B) of a batch of fronts,
    IN PLACE: the B column steps of the right-looking elimination (column
    ``b+j`` is active iff ``b+j < ncols[f]``), then the masked panel ``Lm``
    (inactive columns and the diagonal zero) and ``W = Lm * dsafe``.
    Returns ``(W, Lm)``; the trailing update is ``F[:, b:, b+B:] -= W @
    Lm[:, B:, :]^T``.  Same numerics as the JAX package's
    ``_partial_ldlt_dyn``."""
    ch, rows, B = P.shape
    tiny = tiny16(P.dtype)
    ncols = ncols.to(torch.int64)
    one = torch.ones((), dtype=P.dtype, device=P.device)
    jB = torch.arange(B, device=P.device)
    for j in range(B):
        if j + 1 >= rows:
            break
        active = ncols > b + j
        d = P[:, j, j]
        dn = torch.where(active & (d.abs() > tiny), d, one)
        col = P[:, j + 1:, j]
        l = torch.where(active[:, None], col / dn[:, None], 0.0)
        if j + 1 < B:
            lrows = l[:, :B - j - 1]
            P[:, j + 1:, j + 1:] -= (
                l[:, :, None] * (dn[:, None] * lrows)[:, None, :])
        P[:, j + 1:, j] = torch.where(active[:, None], l, col)
    amask = (b + jB)[None, :] < ncols[:, None]              # (ch, B)
    dvec = torch.diagonal(P[:, :B, :], dim1=1, dim2=2)
    dsafe = torch.where(dvec.abs() > tiny, dvec, one)
    Lb = torch.where(amask[:, None, :], P, 0.0)
    Lb[:, jB, jB] = 0.0
    return Lb * dsafe[:, None, :], Lb


WIDE_STRIP, WIDE_TILE = 128, 64                    # STRIP, TM of ldlt_wide.cu

# cooperative launches of partial_ldlt_wide as the C launcher reports them (one
# per call on the card), and calls of the plain version (0 on a path that runs
# on the card)
_wide = dict(launches=0, plain=0)


def wide_launch_count() -> int:
    return _wide["launches"]


def wide_plain_count() -> int:
    return _wide["plain"]


def _cdiv(a, b):
    return np.maximum(a, 0) // b + (np.maximum(a, 0) % b > 0)


def _tri(t):
    return t * (t + 1) // 2


@dataclasses.dataclass
class WideLevel:
    """The work table of one call of :func:`partial_ldlt_wide`: the wide
    fronts of one tree level, built once per plan and device.

    ``fronts`` (host, int64, one row per front) holds the front's first store
    entry, ``Fpad``, ``ncols`` and ``nf`` (its real rows: the kernel reads and
    writes nothing at or beyond ``nf``); heaviest first (by panel count, then
    ``nf``), so that the fronts still active at a panel step are a prefix.
    ``table`` is the same on the device.  ``steps`` is the largest panel
    count, ``max_items`` the most work items of any phase of the kernel (no
    more blocks are launched), ``[start, end)`` the store entries the fronts
    span."""
    fronts: np.ndarray
    table: torch.Tensor
    steps: int
    max_items: int
    start: int
    end: int

    def shifted(self, delta: int) -> "WideLevel":
        """The same level with every store offset moved by ``delta`` (a
        multiple of 4): for a buffer that holds a window of the store."""
        if delta % 4:
            raise ValueError("offsets move by multiples of 4 elements")
        fr = self.fronts.copy()
        fr[:, 0] += delta
        move = torch.tensor([delta, 0, 0, 0], dtype=torch.int64,
                            device=self.table.device)
        return dataclasses.replace(self, fronts=fr, table=self.table + move,
                                   start=self.start + delta, end=self.end + delta)


def build_wide_level(fronts, device) -> WideLevel:
    """Work table for ``fronts``, a sequence of ``(offset, Fpad, ncols,
    nf)``: a front of ``Fpad x Fpad`` (row-major, ``Fpad`` a multiple of 32)
    starts at element ``offset`` (a multiple of 4, so that its rows stay
    16-byte aligned) of the flat store, has ``nf`` real rows and eliminates
    its first ``ncols`` columns."""
    rows = np.asarray(fronts, np.int64).reshape(-1, 4)
    if len(rows) == 0:
        raise ValueError("a wide level needs at least one front")
    off, fp, nc, nf = rows.T
    if (off < 0).any() or (nc < 0).any() or (nc > nf).any() or (nf > fp).any():
        raise ValueError("each front needs offset >= 0 and 0 <= ncols <= nf <= Fpad")
    if (off % 4).any() or (fp % PANEL).any():
        raise ValueError(f"offsets must be multiples of 4 elements and Fpad of {PANEL}")
    npan = _cdiv(nc, PANEL)
    order = np.lexsort((np.arange(len(rows)), -nf, -npan))
    off, fp, nc, nf, npan = off[order], fp[order], nc[order], nf[order], npan[order]
    steps = int(npan.max())

    def tiles(tR, tC):                  # tiles_of of ldlt_wide.cu
        return np.where(tC > 0, _tri(tC) + (tR - tC) * tC, 0)

    schur = (nc > 0) & (nc < nf)
    items = [int((nc > 0).sum()),                  # a block per first diagonal block
             int(_tri(_cdiv(nf - nc, WIDE_TILE))[schur].sum())]
    for k in range(steps):
        b = k * PANEL
        act = nc > b
        tR = _cdiv(nf[act] - b - PANEL, WIDE_TILE)
        tC = _cdiv(nc[act] - b - PANEL, WIDE_TILE)
        items += [int(_cdiv(nf[act] - b - PANEL, WIDE_STRIP).sum()),
                  int(act.sum() + (tiles(tR, tC) - (tC > 0)).sum())]
    table = np.stack([off, fp, nc, nf], axis=1)
    return WideLevel(
        fronts=table,
        table=torch.as_tensor(np.ascontiguousarray(table), device=device),
        steps=steps, max_items=max(1, max(items)),
        start=int(off.min()), end=int((off + fp * fp).max()))


def partial_ldlt_wide_plain(store: torch.Tensor, lvl: WideLevel) -> None:
    """Plain version of :func:`partial_ldlt_wide`, IN PLACE: front by front
    on its leading ``nf x nf`` block, per panel of 32 columns
    :func:`ldlt_panel_slab_plain` and one product for the trailing update
    (the whole rectangle right of the panel, both triangles)."""
    _wide["plain"] += 1
    for off, Fpad, nc, nf in lvl.fronts.tolist():
        if nc == 0:
            continue
        F = store[off:off + Fpad * Fpad].view(1, Fpad, Fpad)[:, :nf, :nf]
        ncols = torch.tensor([nc], device=store.device)
        for b in range(0, nc, PANEL):
            P = F[:, b:, b:b + PANEL]
            B = P.shape[2]
            W, Lm = ldlt_panel_slab_plain(P, ncols, b)
            if b + B < nf:
                F[:, b:, b + B:] -= W @ Lm[:, B:, :].transpose(-1, -2)


def _wide_library():
    from ._cuda_build import load_cuda_library

    lib = load_cuda_library("ldlt_wide.cu")
    if not getattr(lib, "_typed", False):
        for fn in (lib.ldlt_wide_f32, lib.ldlt_wide_f64):
            fn.argtypes = [_PTR, _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_double, _PTR, _PTR, _PTR]
            fn.restype = ctypes.c_int
        lib.ldlt_wide_error_string.argtypes = [ctypes.c_int]
        lib.ldlt_wide_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def partial_ldlt_wide(store: torch.Tensor, lvl: WideLevel) -> torch.Tensor:
    """Partial LDL^T of every front of ``lvl`` in ONE call, IN PLACE on the
    flat store (the storage contract of this module, on each front's
    leading ``nf x nf`` block; nothing at or beyond ``nf`` is read or
    written, nor any entry above the diagonal in a row ``< ncols``).

    On a CUDA tensor this makes one cooperative launch of the kernel of
    ``csrc/ldlt_wide.cu`` on the current stream (float32 or float64,
    contiguous, its first entry 16-byte aligned for the kernel's ``cp.async``
    copies) or raises, also when the card cannot hold the grid; it never
    gives way to the plain version.  A CPU tensor takes
    :func:`partial_ldlt_wide_plain`."""
    if store.dim() != 1:
        raise ValueError("store must be a flat vector")
    if lvl.end > store.numel():
        raise ValueError("the level's fronts reach outside the store")
    if lvl.table.device != store.device:
        raise ValueError("the level's table must be on store's device")
    if store.device.type == "cpu":
        partial_ldlt_wide_plain(store, lvl)
        return store
    if store.device.type != "cuda":
        raise ValueError(f"unsupported device {store.device}")
    if store.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ldlt_wide kernel takes float32/float64, got {store.dtype}")
    if not store.is_contiguous():
        raise ValueError("ldlt_wide kernel takes a contiguous store")
    if store.data_ptr() % 16:
        raise ValueError("ldlt_wide kernel takes a store whose first entry is "
                         "16-byte aligned")
    if lvl.steps == 0:
        return store
    lib = _wide_library()
    fn = lib.ldlt_wide_f64 if store.dtype == torch.float64 else lib.ldlt_wide_f32
    counters = torch.empty(3, dtype=torch.int64, device=store.device)   # work queues
    launched = ctypes.c_int(0)
    _launch("ldlt_wide", fn, lib.ldlt_wide_error_string, store.device,
            store.data_ptr(), lvl.table.data_ptr(), len(lvl.fronts), lvl.steps,
            lvl.max_items, tiny16(store.dtype), counters.data_ptr(),
            ctypes.addressof(launched))
    _wide["launches"] += launched.value
    return store


def ldlt_operations(ncols, Fpad: int) -> float:
    """Floating-point operations the elimination needs for these
    ``ncols`` (host sequence or tensor): per eliminated column ``j`` of a
    front, ``Fpad-1-j`` divisions and ``2 (Fpad-1-j)^2`` for the rank-1
    update of the trailing square."""
    nc = torch.as_tensor(ncols).to("cpu", torch.float64).clamp(max=Fpad)
    # sum_{j<c} r_j and sum_{j<c} r_j^2 with r_j = Fpad-1-j, in closed form
    a = float(Fpad - 1)
    s1 = nc * a - nc * (nc - 1) / 2
    s2 = (nc * a * a - a * nc * (nc - 1)
          + (nc - 1) * nc * (2 * nc - 1) / 6)
    return float((s1 + 2 * s2).sum())


def ldlt_bound_terms(ncols, Fpad: int, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of one call on
    an H100 SXM: the fronts read once and written once plus ``ncols``,
    over the memory rate; the operations over the vector rate."""
    nb = len(ncols)
    size = torch.finfo(dtype).bits // 8
    t_bytes = (2.0 * nb * Fpad * Fpad * size + 4.0 * nb) / H100_BYTES_PER_S
    t_ops = ldlt_operations(ncols, Fpad) / H100_FLOPS[dtype]
    return t_bytes, t_ops


def ldlt_bound_ms(ncols, Fpad: int, dtype: torch.dtype):
    """(bound_ms, bound_by): the larger of the two bound terms."""
    t_bytes, t_ops = ldlt_bound_terms(ncols, Fpad, dtype)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def wide_bound_terms(levels, dtype: torch.dtype):
    """(seconds for the bytes, seconds for the operations) of
    :func:`partial_ldlt_wide` over ``levels`` (a :class:`WideLevel` or a
    sequence of them) on an H100 SXM.  Bytes, per front with ``c = ncols >
    0`` and ``u = nf - c``: the lower triangle of its ``nf x nf`` block read
    once (``nf (nf+1) / 2`` entries), the eliminated columns' lower triangle
    and the whole Schur block written once (``c (c+1) / 2 + u c + u^2``), and
    every front's table row.  Operations: the
    plan's flop count of each front (``c^3/3 + c^2 u + c u^2`` for ``c =
    ncols``, ``u = nf - ncols``: the lower triangle of the elimination) over
    the float64 tensor-core rate or the float32 vector rate."""
    if isinstance(levels, WideLevel):
        levels = [levels]
    size = torch.finfo(dtype).bits // 8
    nbytes = ops = 0.0
    for lvl in levels:
        nc = lvl.fronts[:, 2].astype(np.float64)
        nf = lvl.fronts[:, 3].astype(np.float64)
        u = nf - nc
        entries = np.where(nc > 0, nf * (nf + 1) / 2 + nc * (nc + 1) / 2
                           + u * nc + u * u, 0.0)
        nbytes += float(entries.sum()) * size + 8.0 * lvl.fronts.size
        ops += float((nc ** 3 / 3 + nc * nc * u + nc * u * u).sum())
    rate = H100_F64_TENSOR_FLOPS if dtype == torch.float64 else H100_FLOPS[dtype]
    return nbytes / H100_BYTES_PER_S, ops / rate


def wide_bound_ms(levels, dtype: torch.dtype):
    """(bound_ms, bound_by): the larger of the two bound terms."""
    t_bytes, t_ops = wide_bound_terms(levels, dtype)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
