"""Flat-slab supernodal LDL^T on PyTorch tensors.

Counterpart of galahad_tpu/linalg/supernodal_flat.py (the SSIDS
numeric-phase equivalent, reference src/ssids/cpu/kernels/ldlt_app.cxx,
src/spral/dense_factor.cu / assemble.cu):

  * ALL fronts live in ONE flat device buffer; each (level, Fpad-bucket)
    group owns a contiguous slab, front sizes padded to a short ladder.
  * Analyse stays host-side (native C++ orderings + numpy maps) and
    gives the JAX package's plan for the same pattern.  The per-group index arrays are uploaded ONCE per plan and
    device (the SLS_analyse-once contract, reference src/sls/sls.f90:2178).
  * The numeric phases run eagerly, level by level: value assembly,
    extend-add of each child's Schur block into its parent front, the
    partial LDL^T of the level's fronts, and the forward / diagonal /
    backward sweeps.
  * Fronts with Fpad <= 128 are factored by the hand-written CUDA kernel
    (linalg/ldlt_kernels.py, csrc/partial_ldlt.cu), all of a tree level
    in one call: this is where the JAX flat path calls
    ``_partial_ldlt_dyn``.  Every larger front of a tree level is factored
    by one call of the wide-front kernel (csrc/ldlt_wide.cu, one
    cooperative launch: panels of 32 columns and the trailing update of
    the lower triangle, on each front's real rows only).
  * The extend-add of each level's children into their parent fronts is
    the hand-written CUDA kernel of linalg/ea_kernels.py
    (csrc/extend_add.cu), one call per tree level: this is where the JAX
    flat path scans ``_ea_slot_apply`` / ``_ea_q_apply`` over buckets of
    children of one padded shape.
  * The sweeps of a solve are the hand-written CUDA kernels of
    linalg/sweep_kernels.py (csrc/sweep.cu), one call per tree level and
    direction (the fronts of 64 or more of a level in one wavefront
    launch): this is where the JAX flat path scans ``_fwd_one`` /
    ``_bwd_one`` over the chunks.
  * Every sum with duplicate destinations (value assembly, the extend-add
    of the children of one parent, the forward sweep's updates of shared
    ancestor rows) runs in a fixed order (core/segsum.py; the extend-add's
    child order; the sweeps' own accumulation lists), so two runs give the
    same bits.

Not carried over from the JAX module, because it serves the XLA compiler
or the TPU's memory tiling and has no role here: the tile-padding caps,
the buffer-length ladders, the scan-run packing, the one-hot-matmul
extend-add with its window gather, ``warm_plan`` and the fused wrappers.

The factorization semantics are the JAX package's: signed LDL^T on
quasi-definite matrices, unit-lower L with d_j on the front diagonal,
a-posteriori |d|_min and inertia (SLS_enquire role).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core import trace
from ..core.segsum import SegmentSum
from .ea_kernels import build_ea_level, extend_add
from .ldlt_kernels import (
    MAX_KERNEL_FRONT,
    build_ldlt_items,
    build_wide_level,
    partial_ldlt_items,
    partial_ldlt_wide,
)
from .sweep_kernels import build_sweep_level, sweep_bwd, sweep_fwd

# Padded front-size ladder: powers of two and 1.5x powers of two: keeps
# padding waste <= 33% while bounding the number of distinct front shapes.
_FPAD_LADDER = sorted(
    {8, 16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
     1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384})
_CH_LADDER = (4096, 512, 64, 8, 1)
_CHUNK_ELEMS = 1 << 24           # cap CH * Fpad^2 elements per chunk


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _fpad_for(f: int) -> int:
    for v in _FPAD_LADDER:
        if v >= f:
            return v
    return _round_up(f, 1024)


def _chunks_of(nb: int, Fpad: int = 8, cap_elems: int = None):
    """Decompose nb into chunk-ladder pieces (largest first), capping
    each chunk's memory footprint at _CHUNK_ELEMS elements."""
    cap = (cap_elems if cap_elems is not None
           else max(1, _CHUNK_ELEMS // (Fpad * Fpad)))
    out = []
    off = 0
    for ch in _CH_LADDER:
        if ch > cap:
            continue
        while nb - off >= ch:
            out.append((off, ch))
            off += ch
    return out


def _etree_postorder(parent) -> np.ndarray:
    """Postorder permutation of an elimination tree (children before
    parents, subtrees contiguous).  Host-side numpy, O(n)."""
    n = len(parent)
    # build child lists (reversed so iterative DFS preserves order)
    head = np.full(n + 1, -1, np.int64)   # slot n = virtual root
    nxt = np.full(n, -1, np.int64)
    for v in range(n - 1, -1, -1):
        p = parent[v] if parent[v] >= 0 else n
        nxt[v] = head[p]
        head[p] = v
    post = np.empty(n, np.int64)
    k = 0
    stack = []
    v = head[n]
    while v != -1:
        stack.append((v, False))
        v = nxt[v]
    # stack holds roots in order; DFS each
    stack.reverse()
    while stack:
        v, expanded = stack.pop()
        if expanded:
            post[k] = v
            k += 1
            continue
        stack.append((v, True))
        c = head[v]
        children = []
        while c != -1:
            children.append(c)
            c = nxt[c]
        for c in reversed(children):
            stack.append((c, False))
    assert k == n
    return post


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlatGroup:
    goff: int                # slab offset in the flat store
    nb: int                  # fronts in group
    Fpad: int                # padded front size (ladder value)
    level: int
    ncols: np.ndarray        # (nb,) eliminated columns
    frows: np.ndarray        # (nb, Fpad) global rows, sentinel = n_total
    ea: list                 # raw extend-add records, one per child:
                             #   dict(sbase, sncols, fp_src, u, ppos,
                             #        ppar), tabled by ea_kernels


@dataclasses.dataclass
class FlatPlan:
    """Host-side static plan; identity-hashed (analyse-once contract)."""

    n: int
    S: int                   # flat store length (excl. sentinel slot)
    perm: np.ndarray
    iperm: np.ndarray
    groups: list             # list[FlatGroup], topological (level) order
    a_idx: np.ndarray        # A-entry scatter: flat store indices
    a_src: np.ndarray        #   entry index into the user's value array
    d_idx: np.ndarray        # flat indices of eliminated diagonal slots
    d_col: np.ndarray        #   original (unpermuted) column per slot
    nnz_L: int
    flops: float
    ns: int
    _dev: Any = None         # lazily-built device-resident index arrays,
                             # one set per device

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def flat_analyse(rows, cols, n, order: str = "amd",
                 relax_cols: int = 4) -> FlatPlan:
    """Symbolic analysis producing a flat-slab plan (reference
    src/ssids/anal.f90).  Host-side: native C++ orderings and numpy maps.
    Kept with the JAX package's ``flat_analyse`` so that both produce the
    same plan for the same pattern; only the grouping of the entries by
    supernode differs (one sort here, a scan of all entries per supernode
    there)."""
    import scipy.sparse as sp

    from ..native import (
        amd_order,
        nd_order,
        rcm_order,
        supernode_partition,
        symbolic_factor,
        tree_levels,
    )

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    ones = np.ones(len(rows), np.int8)
    A = sp.csr_matrix((ones, (rows, cols)), shape=(n, n))
    A = ((A + A.T) > 0).astype(np.int8).tocsr()
    if order == "amd":
        perm = amd_order(A.indptr, A.indices)
    elif order == "rcm":
        perm = rcm_order(A.indptr, A.indices)
    elif order == "nd":
        perm = nd_order(A.indptr, A.indices)
    else:
        perm = np.arange(n, dtype=np.int32)
    perm = perm.astype(np.int64)
    iperm = np.zeros(n, np.int64)
    iperm[perm] = np.arange(n)

    Al = sp.tril(A[perm][:, perm]).tocsc()
    parent, colcount, Lp, Li = symbolic_factor(
        Al.indptr.astype(np.int64), Al.indices.astype(np.int32), n)
    # POSTORDER the elimination tree, then redo the symbolic pass: a
    # postorder makes every supernode chain contiguous (parent[v-1]==v),
    # which is what lets the relaxed amalgamation actually fuse nodes
    # (SSIDS analyse does the same, src/ssids/anal.f90)
    post = _etree_postorder(parent)
    if not np.array_equal(post, np.arange(n)):
        perm = perm[post]
        iperm = np.zeros(n, np.int64)
        iperm[perm] = np.arange(n)
        Al = sp.tril(A[perm][:, perm]).tocsc()
        parent, colcount, Lp, Li = symbolic_factor(
            Al.indptr.astype(np.int64), Al.indices.astype(np.int32), n)
    snode, ns = supernode_partition(parent, colcount, relax_cols=relax_cols)
    snode = snode.astype(np.int64)
    sn_first = np.searchsorted(snode, np.arange(ns))
    sn_end = np.searchsorted(snode, np.arange(ns), side="right")

    sn_struct = []
    for s in range(ns):
        j0, j1 = int(sn_first[s]), int(sn_end[s])
        seg = Li[Lp[j0]:Lp[j1]]
        if len(seg):
            u = np.unique(seg)
            u = u[u >= j1]
        else:
            u = np.zeros(0, np.int32)
        sn_struct.append(u.astype(np.int64))
    struct_len = np.array([len(u) for u in sn_struct], np.int64)

    sparent = np.full(ns, -1, np.int32)
    for s in range(ns):
        if struct_len[s]:
            sparent[s] = snode[sn_struct[s][0]]
    level_of, nlev = tree_levels(sparent)

    nc_all = sn_end - sn_first
    nf_all = nc_all + struct_len
    nnz_L = int(np.sum(nc_all * nf_all - nc_all * (nc_all - 1) // 2))
    flops = float(np.sum(nc_all.astype(float) ** 3 / 3
                         + nc_all.astype(float) ** 2 * struct_len
                         + nc_all * struct_len.astype(float) ** 2))

    # --- group: (level, Fpad-ladder) only — ncols stays dynamic -------
    fpad_of = np.array([_fpad_for(int(f)) for f in np.maximum(nf_all, 1)],
                       np.int64)
    groups_nodes: list = []
    for lv in range(nlev):
        nodes = np.flatnonzero(level_of == lv)
        for fp in np.unique(fpad_of[nodes]):
            nd = nodes[fpad_of[nodes] == fp]
            # sort by ncols so chunks see homogeneous panel counts
            nd = nd[np.argsort(nc_all[nd], kind="stable")]
            groups_nodes.append((lv, int(fp), nd))

    node_pos = np.zeros(ns, np.int64)
    group_of = np.zeros(ns, np.int64)
    goffs = []
    off = 0
    for gi, (lv, fp, nd) in enumerate(groups_nodes):
        node_pos[nd] = np.arange(len(nd))
        group_of[nd] = gi
        goffs.append(off)
        off += len(nd) * fp * fp
    S = off

    def pos_in_front(s: int, g: np.ndarray) -> np.ndarray:
        incol = g < sn_end[s]
        p_col = g - sn_first[s]
        p_str = nc_all[s] + np.searchsorted(sn_struct[s], g)
        return np.where(incol, p_col, p_str)

    def front_base(s: int) -> int:
        gi = int(group_of[s])
        fp = groups_nodes[gi][1]
        return goffs[gi] + int(node_pos[s]) * fp * fp

    # --- A-entry scatter (both triangles; diagonal once) ---------------
    a_r = np.maximum(iperm[rows], iperm[cols])
    a_c = np.minimum(iperm[rows], iperm[cols])
    s_of = snode[a_c]
    fp_of_entry = np.array([groups_nodes[int(g)][1]
                            for g in group_of[s_of]], np.int64)
    base = np.array([goffs[int(g)] for g in group_of[s_of]], np.int64) \
        + node_pos[s_of] * fp_of_entry * fp_of_entry
    # one stable sort groups the entries by supernode (ascending, each
    # supernode's entries in their input order): O(nnz log nnz), not O(ns x nnz)
    fi = np.zeros(len(a_r), np.int64)
    by_sn = np.argsort(s_of, kind="stable")
    sns, starts = np.unique(s_of[by_sn], return_index=True)
    ends = np.append(starts[1:], len(by_sn))
    for s, lo, hi in zip(sns.tolist(), starts.tolist(), ends.tolist()):
        sel = by_sn[lo:hi]
        fi[sel] = pos_in_front(s, a_r[sel])
    fj = a_c - sn_first[s_of]
    idx_lower = base + fi * fp_of_entry + fj
    off_diag = a_r != a_c
    idx_upper = (base + fj * fp_of_entry + fi)[off_diag]
    a_idx = np.concatenate([idx_lower, idx_upper])
    a_src = np.concatenate([np.arange(len(a_r)),
                            np.flatnonzero(off_diag)]).astype(np.int64)

    # --- eliminated-diagonal positions (for shifts) --------------------
    d_idx = np.zeros(n, np.int64)
    d_col = np.zeros(n, np.int64)
    p = 0
    for s in range(ns):
        b = front_base(s)
        fp = groups_nodes[int(group_of[s])][1]
        for k in range(int(nc_all[s])):
            d_idx[p] = b + k * fp + k
            d_col[p] = perm[sn_first[s] + k]   # original column index
            p += 1

    # --- per-group frows / extend-add ----------------------------------
    # Extend-add is recorded as RAW per-child records here; the device
    # plan turns each level's records into the tables of its kernel (the
    # analogue of SSIDS's assembly kernels, reference src/spral/assemble.cu).
    groups: list = []
    ea_by_dst: dict = {}
    for s in range(ns):
        pnode = sparent[s]
        if pnode < 0 or struct_len[s] == 0:
            continue
        gi = int(group_of[pnode])
        fp_s = groups_nodes[int(group_of[s])][1]
        ea_by_dst.setdefault(gi, []).append(dict(
            sbase=front_base(s),
            sncols=int(nc_all[s]),
            fp_src=fp_s,
            u=int(struct_len[s]),
            ppos=pos_in_front(int(pnode), sn_struct[s]).astype(np.int64),
            ppar=int(node_pos[pnode]),
        ))

    for gi, (lv, fp, nd) in enumerate(groups_nodes):
        nb = len(nd)
        frows = np.full((nb, fp), n, np.int64)
        for k, s in enumerate(nd):
            fr = np.concatenate(
                [np.arange(sn_first[s], sn_end[s]), sn_struct[s]])
            frows[k, :len(fr)] = fr
        groups.append(FlatGroup(
            goff=goffs[gi], nb=nb, Fpad=fp, level=lv,
            ncols=nc_all[nd].astype(np.int64), frows=frows,
            ea=ea_by_dst.get(gi, [])))

    return FlatPlan(
        n=n, S=S, perm=perm, iperm=iperm, groups=groups,
        a_idx=a_idx, a_src=a_src,
        d_idx=d_idx, d_col=d_col,
        nnz_L=nnz_L, flops=flops, ns=ns,
    )


# ---------------------------------------------------------------------------
# Device-resident plan data (uploaded once per plan and device)
# ---------------------------------------------------------------------------


def _device_plan(plan: FlatPlan, device) -> dict:
    key = str(device)
    if plan._dev is None:
        plan._dev = {}
    hit = plan._dev.get(key)
    if hit is None:
        hit = _device_plan_build(plan, device)
        plan._dev[key] = hit
    return hit


def _device_plan_build(plan: FlatPlan, device) -> dict:
    """Index tensors for the numeric phases: the per-group chunking of the
    small fronts and, per tree level, the tables of the extend-add, small-
    and wide-front factor and sweep kernels."""
    n, S = plan.n, plan.S

    def t64(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)

    dev = dict(
        S=S,
        asm=SegmentSum(plan.a_idx, S, dense=False),
        a_src=t64(plan.a_src),
        d_idx=t64(plan.d_idx), d_col=t64(plan.d_col),
        perm=t64(plan.perm), iperm=t64(plan.iperm),
        levels=[],
    )
    by_level: dict = {}
    for g in plan.groups:
        by_level.setdefault(g.level, []).append(g)

    for lv in sorted(by_level):
        small: list = []
        wide: list = []
        for g in by_level[lv]:
            Fd = g.Fpad
            if Fd > MAX_KERNEL_FRONT:
                nf = (np.asarray(g.frows) < n).sum(axis=1)
                wide += [(g.goff + i * Fd * Fd, Fd, int(g.ncols[i]), int(nf[i]))
                         for i in range(g.nb)]
                continue
            small += [(int(g.goff + off * Fd * Fd), Fd,
                       np.asarray(g.ncols[off:off + ch], np.int64))
                      for off, ch in _chunks_of(g.nb, Fd)]
        ea = [(g.goff, g.Fpad, g.ea) for g in by_level[lv] if g.ea]
        dev["levels"].append(dict(
            # every child of the level is added into its parent by one call
            ea=build_ea_level(ea, device) if ea else None,
            # every small front of the level is factored by one kernel call
            ldlt=build_ldlt_items(small, device) if small else None,
            # and every wide front by one more
            wide=build_wide_level(wide, device) if wide else None,
            # every front of the level is swept by one call per direction
            sweep=build_sweep_level(
                [(g.goff, g.Fpad, g.ncols, g.frows) for g in by_level[lv]],
                n, device)))
    dev["sweep_scratch"] = max(
        (lvp["sweep"].work_size for lvp in dev["levels"]),
        default=0)
    return dev


@dataclasses.dataclass
class FlatFactors:
    store: Any               # flat slab buffer holding every front (+1 spare)
    dmin: Any
    inertia: Any


def flat_factorize(plan: FlatPlan, vals, shift=0.0,
                   capture: list = None) -> FlatFactors:
    """Numeric LDL^T on the flat plan.  ``vals`` (a tensor; its device and
    dtype are the factorization's) aligns with the COO entries given to
    flat_analyse; ``shift`` is a scalar or (n,) tensor in the ORIGINAL
    ordering, added to the diagonal.

    ``capture``, if a list, receives the input of every call of the two
    factor kernels (for measurement): per level ``("small", clone of the
    window of the store that holds the level's small fronts, the items
    moved to that window)`` and ``("wide", clone of the window that holds
    its wide fronts, their table moved to that window)``."""
    device, dt = vals.device, vals.dtype
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = _device_plan(plan, device)
    S = dev["S"]
    with trace.span("kkt.assemble"):
        store = torch.zeros(S + 1, dtype=dt, device=device)
        asm = dev["asm"]
        if asm.nnz:
            store.index_copy_(0, asm.index_on(device),
                              asm(vals.index_select(0, dev["a_src"])))
        if torch.is_tensor(shift) and shift.dim() == 1:
            store.index_add_(0, dev["d_idx"],
                             shift.to(dt).index_select(0, dev["d_col"]))
        elif not (isinstance(shift, (int, float)) and shift == 0.0):
            store.index_add_(0, dev["d_idx"], torch.full(
                (plan.n,), float(shift), dtype=dt, device=device))

    with trace.span("kkt.factor"):
        for lvp in dev["levels"]:
            if lvp["ea"] is not None:
                extend_add(store, lvp["ea"])
            items = lvp["ldlt"]
            if items is not None:
                if capture is not None:
                    capture.append(("small", store[items.start:items.end].clone(),
                                    items.shifted(-items.start)))
                partial_ldlt_items(store, items)
            wide = lvp["wide"]
            if wide is not None:
                if capture is not None:
                    capture.append(("wide", store[wide.start:wide.end].clone(),
                                    wide.shifted(-wide.start)))
                partial_ldlt_wide(store, wide)

        if plan.n:
            dvec = store.index_select(0, dev["d_idx"])
            dmin = dvec.abs().min()
            inertia = torch.stack([(dvec > 0).sum(), (dvec < 0).sum(),
                                   (dvec == 0).sum()]).to(torch.int32)
        else:
            dmin = torch.tensor(float("inf"), dtype=dt, device=device)
            inertia = torch.zeros(3, dtype=torch.int32, device=device)
    return FlatFactors(store=store, dmin=dmin, inertia=inertia)


def flat_solve(plan: FlatPlan, fac: FlatFactors, b):
    """Solve A x = b with the flat LDL^T factors: forward sweeps with the
    diagonal scale, tree level by tree level (bottom-up), then backward
    (top-down); one call of the sweep kernels per level and direction
    (linalg/sweep_kernels.py)."""
    store = fac.store
    if store.dtype != b.dtype:
        store = store.to(b.dtype)
    dev = _device_plan(plan, b.device)
    # one spare slot at the end: sentinel rows of padded fronts point there
    y = torch.zeros(plan.n + 1, dtype=b.dtype, device=b.device)
    y[:plan.n] = b.index_select(0, dev["perm"])
    work = torch.empty(dev["sweep_scratch"], dtype=b.dtype, device=b.device)
    for lvp in dev["levels"]:
        sweep_fwd(store, y, lvp["sweep"], work)
    for lvp in reversed(dev["levels"]):
        sweep_bwd(store, y, lvp["sweep"], work)
    return y[:plan.n].index_select(0, dev["iperm"])
