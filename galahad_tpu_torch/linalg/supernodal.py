"""Supernodal multifrontal LDL^T on PyTorch tensors: the "inline" backend.

Counterpart of galahad_tpu/linalg/supernodal.py (the SSIDS analyse /
factor / solve, reference src/ssids/ssids.f90: analyse :503, factor :736,
solve :1114):

  * ANALYSE (host, native C++ + numpy): :func:`supernodal_analyse` is the
    JAX package's, over the port's own copy of ``native/symbolic.cpp``, so
    both give the same plan: ``perm``, the groups ("levels": a tree level
    split into front-size buckets), their ``frows``, ``ncols``, ``Cmax``,
    ``B``, ``Fpad`` and the extend-add maps.
  * FACTOR (device): one group after another, its fronts held as one
    ``(nb, K, K)`` tensor.  ``K`` is the kernel's size: for ``Fpad <= 128``
    the next size of ``ldlt_kernels.KERNEL_FRONTS`` (rows and columns past
    the front are zero and leave the eliminated columns as they are), the
    fronts factored by ONE call of ``partial_ldlt`` (csrc/partial_ldlt.cu,
    where the JAX package reaches ``partial_ldlt_pallas``); for wider
    fronts ``Fpad`` rounded up to 32 and ONE call of ``partial_ldlt_wide``
    (csrc/ldlt_wide.cu, where the JAX package runs ``_blocked_partial_ldlt``).
    The value assembly is a sum in a fixed order (core/segsum.py); the
    extend-add of the children runs in rounds, round ``r`` taking the
    ``r``-th child of every parent, so that no two writes of a round meet
    and a parent sums its children in their order.  No atomics: two runs
    give the same bits.
  * SOLVE (device): per group the forward and backward triangular solves
    of the eliminated block (``torch.linalg.solve_triangular``) and one
    product for the rows below it, the updates of shared ancestor rows
    summed in a fixed order.

On a CUDA tensor the two factor wrappers launch their kernels or raise;
on the CPU they take their plain versions (ldlt_kernels.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import tiny16
from ..core.segsum import SegmentSum
from .ldlt_kernels import (KERNEL_FRONTS, MAX_KERNEL_FRONT, PANEL, build_wide_level,
                           partial_ldlt, partial_ldlt_wide)


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


# ---------------------------------------------------------------------------
# Symbolic analysis (host): the JAX package's, step for step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LevelPlan:
    """Static plan of one group of fronts (numpy)."""

    frows: np.ndarray        # (nb, Fpad) global rows of each front, -1 pad
    ncols: np.ndarray        # (nb,) eliminated columns per front
    nrows: np.ndarray        # (nb,) true front size
    Cmax: int                # max ncols in the group
    Fpad: int                # padded front size (multiple of 8, >= nblocks*B)
    B: int                   # panel width of the JAX package's blocked factor
    a_node: np.ndarray       # A-entry scatter: local node index
    a_fi: np.ndarray         #   row position in front
    a_fj: np.ndarray         #   col position in front
    a_src: np.ndarray        #   index into the user's value array
    ea: list                 # extend-add groups: dicts with src_level,
    #   src_nodes (nc,), dst_nodes (nc,), cpos (nc, Umax) child-front
    #   positions of update rows, ppos (nc, Umax) parent-front positions
    #   (pad -> Fpad), uvalid (nc, Umax)


@dataclasses.dataclass
class SupernodalSymbolic:
    """Static factorization plan (host side; identity-hashed, so the
    device tables built for it are reused)."""

    n: int
    perm: np.ndarray              # new <- old column index
    iperm: np.ndarray
    levels: list                  # list[LevelPlan], bottom-up
    nnz_L: int
    flops: float
    ns: int
    _dev: Any = None              # device tables, one set per device

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def supernodal_analyse(rows, cols, n, order: str = "amd",
                       relax_cols: int = 4) -> SupernodalSymbolic:
    """Analyse a symmetric sparsity pattern given in coordinate form
    (either triangle; duplicate entries are summed at numeric time).
    Host-side; the graph work runs in native C++ (native/symbolic.cpp)."""
    import scipy.sparse as sp

    from ..native import (amd_order, nd_order, rcm_order, supernode_partition,
                          symbolic_count, symbolic_factor, tree_levels)

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
    elif order == "best":
        # the sparser factor of AMD and nested dissection, by symbolic count
        best_perm, best_nnz = None, None
        for cand in (amd_order(A.indptr, A.indices), nd_order(A.indptr, A.indices)):
            c64 = cand.astype(np.int64)
            Alc = sp.tril(A[c64][:, c64]).tocsc()
            nnz = symbolic_count(Alc.indptr.astype(np.int64),
                                 Alc.indices.astype(np.int32), n)
            if best_nnz is None or nnz < best_nnz:
                best_perm, best_nnz = cand, nnz
        perm = best_perm
    else:
        perm = np.arange(n, dtype=np.int32)
    perm = perm.astype(np.int64)
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

    # each tree level split into front-size buckets (powers of two on the
    # front size and on the eliminated-column count)
    def _p2(x):
        x = np.maximum(np.asarray(x, np.int64), 1)
        return 2 ** np.ceil(np.log2(x)).astype(np.int64)

    groups: list = []
    for lv in range(nlev):
        nodes = np.flatnonzero(level_of == lv)
        key = _p2(np.maximum(nf_all[nodes], 8)) * (10 ** 6) + _p2(nc_all[nodes])
        for u in np.unique(key):
            groups.append(nodes[key == u])
    node_pos = np.zeros(ns, np.int64)
    group_of = np.zeros(ns, np.int64)
    for gi, nd in enumerate(groups):
        node_pos[nd] = np.arange(len(nd))
        group_of[nd] = gi

    def pos_in_front(s: int, g: np.ndarray) -> np.ndarray:
        incol = g < sn_end[s]
        p_col = g - sn_first[s]
        p_str = nc_all[s] + np.searchsorted(sn_struct[s], g)
        return np.where(incol, p_col, p_str)

    # A-entry scatter maps, grouped by owning supernode
    a_r = np.maximum(iperm[rows], iperm[cols])
    a_c = np.minimum(iperm[rows], iperm[cols])
    s_of = snode[a_c]
    ordr = np.argsort(s_of, kind="stable")
    e_node = np.zeros(len(a_r), np.int32)
    e_fi = np.zeros(len(a_r), np.int32)
    e_fj = np.zeros(len(a_r), np.int32)
    uniq, starts = np.unique(s_of[ordr], return_index=True)
    bounds = np.append(starts, len(ordr))
    for k, s in enumerate(uniq):
        sel = ordr[bounds[k]:bounds[k + 1]]
        e_node[sel] = node_pos[s]
        e_fi[sel] = pos_in_front(int(s), a_r[sel])
        e_fj[sel] = a_c[sel] - sn_first[s]
    e_group = group_of[s_of]

    # extend-add maps, grouped by (destination group, source group)
    ea_groups: dict = {}
    for s in range(ns):
        p = sparent[s]
        if p < 0 or struct_len[s] == 0:
            continue
        key = (int(group_of[p]), int(group_of[s]))
        g = ea_groups.setdefault(key, dict(src=[], dst=[], cpos=[], ppos=[]))
        g["src"].append(node_pos[s])
        g["dst"].append(node_pos[p])
        g["cpos"].append(nc_all[s] + np.arange(struct_len[s]))
        g["ppos"].append(pos_in_front(int(p), sn_struct[s]))

    levels: list = []
    for gi, nodes in enumerate(groups):
        nb = len(nodes)
        ncols = nc_all[nodes]
        nrows = nf_all[nodes]
        Cmax = int(ncols.max()) if nb else 1
        Fmax = int(nrows.max()) if nb else 1
        B = min(32, _round_up(Cmax, 8))
        Fpad = _round_up(max(Fmax, _round_up(Cmax, B)), 8)
        frows = np.full((nb, Fpad), -1, np.int32)
        for k, s in enumerate(nodes):
            fr = np.concatenate([np.arange(sn_first[s], sn_end[s]), sn_struct[s]])
            frows[k, :len(fr)] = fr
        sel = np.flatnonzero(e_group == gi)
        ea = []
        for (dl, sl), g in sorted(ea_groups.items()):
            if dl != gi:
                continue
            Umax = max(len(c) for c in g["cpos"])
            nc = len(g["src"])
            cpos = np.zeros((nc, Umax), np.int32)
            ppos = np.full((nc, Umax), Fpad, np.int32)
            uvalid = np.zeros((nc, Umax), bool)
            for k in range(nc):
                u = len(g["cpos"][k])
                cpos[k, :u] = g["cpos"][k]
                ppos[k, :u] = g["ppos"][k]
                uvalid[k, :u] = True
            ea.append(dict(src_level=sl, src_nodes=np.asarray(g["src"], np.int32),
                           dst_nodes=np.asarray(g["dst"], np.int32),
                           cpos=cpos, ppos=ppos, uvalid=uvalid))
        levels.append(LevelPlan(
            frows=frows, ncols=ncols.astype(np.int32), nrows=nrows.astype(np.int32),
            Cmax=Cmax, Fpad=Fpad, B=B,
            a_node=e_node[sel], a_fi=e_fi[sel], a_fj=e_fj[sel],
            a_src=sel.astype(np.int32), ea=ea))

    return SupernodalSymbolic(n=n, perm=perm, iperm=iperm, levels=levels,
                              nnz_L=nnz_L, flops=flops, ns=ns)


# ---------------------------------------------------------------------------
# Device tables (built once per plan and device)
# ---------------------------------------------------------------------------


def kernel_size(Fpad: int) -> int:
    """The front size a group is factored at: the next size the small-front
    kernel serves for ``Fpad <= 128``, else ``Fpad`` rounded up to 32."""
    if Fpad <= MAX_KERNEL_FRONT:
        return next(k for k in KERNEL_FRONTS if k >= Fpad)
    return _round_up(Fpad, PANEL)


def _rounds(dst: np.ndarray) -> list:
    """Split children into rounds: round r holds the r-th child (in the
    given order) of every parent, so that no parent appears twice."""
    rank = np.zeros(len(dst), np.int64)
    seen: dict = {}
    for i, d in enumerate(dst.tolist()):
        rank[i] = seen.get(d, 0)
        seen[d] = rank[i] + 1
    return [np.flatnonzero(rank == r) for r in range(int(rank.max()) + 1 if len(dst) else 0)]


def _device_plan(sym: SupernodalSymbolic, device) -> dict:
    key = str(device)
    if sym._dev is None:
        sym._dev = {}
    hit = sym._dev.get(key)
    if hit is None:
        hit = dict(groups=[_group_tables(sym, plan, device) for plan in sym.levels],
                   perm=torch.as_tensor(sym.perm, device=device),
                   iperm=torch.as_tensor(sym.iperm, device=device))
        sym._dev[key] = hit
    return hit


def _group_tables(sym, plan: LevelPlan, device) -> dict:
    def t64(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)

    nb, Fpad = plan.frows.shape
    K = kernel_size(Fpad)
    KK = K * K
    # value assembly: entry (fi, fj) and its mirror (fj, fi), one fixed-order sum
    an = plan.a_node.astype(np.int64)
    fi = plan.a_fi.astype(np.int64)
    fj = plan.a_fj.astype(np.int64)
    off = np.flatnonzero(fi != fj)
    dest = np.concatenate([an * KK + fi * K + fj, an[off] * KK + fj[off] * K + fi[off]])
    src = np.concatenate([plan.a_src, plan.a_src[off]]).astype(np.int64)
    # eliminated diagonal places and their columns in the original order
    ii = np.arange(Fpad)
    el = ii[None, :] < plan.ncols[:, None]
    fr_el = plan.frows[el].astype(np.int64)
    d_idx = (np.nonzero(el)[0] * KK + np.nonzero(el)[1] * (K + 1))
    ea = []
    for g in plan.ea:
        Ks = kernel_size(sym.levels[g["src_level"]].Fpad)
        for sel in _rounds(np.asarray(g["dst_nodes"], np.int64)):
            uv = g["uvalid"][sel]
            u = int(uv.sum(axis=1).max())
            ea.append(dict(
                src_level=g["src_level"], Ks=Ks,
                src=t64(g["src_nodes"][sel]), dst=t64(g["dst_nodes"][sel]),
                cpos=t64(g["cpos"][sel][:, :u]),
                ppos=t64(np.where(uv, g["ppos"][sel], 0)[:, :u]),
                valid=torch.as_tensor(uv[:, :u], device=device)))
    # the solve: eliminated rows are written, the other front rows summed
    mask = plan.frows >= 0
    frows_c = np.maximum(plan.frows, 0).astype(np.int64)
    flat_el = np.flatnonzero((el & mask).ravel())
    flat_st = np.flatnonzero((mask & ~el).ravel())
    tab = dict(
        nb=nb, Fpad=Fpad, K=K, Cmax=plan.Cmax,
        route="small" if Fpad <= MAX_KERNEL_FRONT else "wide",
        asm=SegmentSum(dest, nb * KK, dense=False) if len(dest) else None,
        a_src=t64(src),
        ncols32=torch.as_tensor(plan.ncols.astype(np.int32), device=device),
        ncols=t64(plan.ncols),
        d_idx=t64(d_idx), d_orig=t64(sym.perm[fr_el]),
        ea=ea,
        frows=t64(frows_c), mask=torch.as_tensor(mask, device=device),
        el_sel=t64(flat_el), el_rows=t64(frows_c.ravel()[flat_el]),
        st_sel=t64(flat_st),
        st_sum=SegmentSum(frows_c.ravel()[flat_st], sym.n, dense=False),
    )
    if tab["route"] == "wide":
        tab["wide"] = build_wide_level(
            [(i * KK, K, int(plan.ncols[i]), int(plan.nrows[i])) for i in range(nb)],
            device)
    return tab


# ---------------------------------------------------------------------------
# Numeric factorization (device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SupernodalFactors:
    """LDL^T factors: per group ``(nb, K, K)`` fronts (``levels``; the JAX
    package's ``(nb, Fpad, Fpad)`` front is the leading block).  Eliminated
    columns hold unit-lower L below the diagonal and d_j on it (entries
    above it are unspecified); the trailing square holds the Schur update.

    dmin    = min |d_j| over all eliminated columns (0-d tensor);
    inertia = (#pos, #neg, #zero) of D (int32 (3,) tensor, SLS_enquire)."""

    levels: list
    dmin: Any
    inertia: Any
    _solve: Any = None       # the masked factors the solve reads, made once

    def front(self, sym: SupernodalSymbolic, l: int) -> torch.Tensor:
        """Group ``l``'s fronts at the JAX package's ``(nb, Fpad, Fpad)``."""
        Fpad = sym.levels[l].Fpad
        return self.levels[l][:, :Fpad, :Fpad]


def supernodal_factorize(sym: SupernodalSymbolic, vals, shift=0.0,
                         capture: list = None) -> SupernodalFactors:
    """Numeric LDL^T.  ``vals`` (a tensor; its device and type are the
    factorization's) aligns with the coordinate entries given to analyse
    (duplicates summed).  ``shift`` is added to the diagonal: a number, or
    an (n,) tensor in the ORIGINAL ordering (the signed regularization of
    quasi-definite KKT systems).

    ``capture``, if a list, receives for every group the input of its
    factor kernel: ``(route, clone of the fronts, group index)``."""
    device, dt = vals.device, vals.dtype
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    tabs = _device_plan(sym, device)["groups"]
    shift_vec = shift.to(device=device, dtype=dt) if (
        torch.is_tensor(shift) and shift.dim() == 1) else None
    levels_out: list = []
    dmin = torch.full((), float("inf"), dtype=dt, device=device)
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    for tab in tabs:
        nb, K = tab["nb"], tab["K"]
        KK = K * K
        # one spare entry at the end: the extend-add's padded places land there
        buf = torch.zeros(nb * KK + 1, dtype=dt, device=device)
        if tab["asm"] is not None:
            buf.index_copy_(0, tab["asm"].index_on(device),
                            tab["asm"](vals.index_select(0, tab["a_src"])))
        if shift_vec is not None:
            buf.index_add_(0, tab["d_idx"], shift_vec.index_select(0, tab["d_orig"]))
        elif not (isinstance(shift, (int, float)) and shift == 0.0):
            buf.index_add_(0, tab["d_idx"], torch.full(
                (tab["d_idx"].numel(),), float(shift), dtype=dt, device=device))
        for r in tab["ea"]:
            U = levels_out[r["src_level"]].reshape(-1)
            Ks = r["Ks"]
            cp, pp, v = r["cpos"], r["ppos"], r["valid"]
            sidx = (r["src"][:, None, None] * (Ks * Ks) + cp[:, :, None] * Ks
                    + cp[:, None, :])
            didx = (r["dst"][:, None, None] * KK + pp[:, :, None] * K + pp[:, None, :])
            v2 = v[:, :, None] & v[:, None, :]
            didx = torch.where(v2, didx, nb * KK).reshape(-1)
            G = torch.where(v2, U.index_select(0, sidx.reshape(-1)).view(v2.shape), 0.0)
            buf.index_copy_(0, didx, buf.index_select(0, didx) + G.reshape(-1))
        F = buf[:nb * KK].view(nb, K, K)
        if capture is not None:
            capture.append((tab["route"], F.clone(), len(levels_out)))
        if tab["route"] == "small":
            partial_ldlt(F, tab["ncols32"], inplace=True)
        else:
            partial_ldlt_wide(buf, tab["wide"])
        # pivot statistics from the stored diagonal
        dvec = torch.diagonal(F, dim1=1, dim2=2)
        elim = torch.arange(K, device=device)[None, :] < tab["ncols"][:, None]
        dmin = torch.minimum(dmin, torch.where(elim, dvec.abs(), float("inf")).min())
        counts += torch.stack([(elim & (dvec > 0)).sum(), (elim & (dvec < 0)).sum(),
                               (elim & (dvec == 0)).sum()])
        levels_out.append(F)
    return SupernodalFactors(levels=levels_out, dmin=dmin,
                             inertia=counts.to(torch.int32))


def supernodal_inertia(fac: SupernodalFactors):
    """(#pos, #neg, #zero) eigenvalue counts from the LDL^T diagonal."""
    return fac.inertia


# ---------------------------------------------------------------------------
# Solve (device)
# ---------------------------------------------------------------------------


def _prepared(sym, fac: SupernodalFactors, dt, device):
    """Per group: the eliminated columns' strict lower part ``(nb, Fpad,
    Cmax)`` (everything else zero) and the safe pivots."""
    key = (dt, str(device))
    if fac._solve is not None and fac._solve[0] == key:
        return fac._solve[1]
    tabs = _device_plan(sym, device)["groups"]
    tiny = tiny16(dt)
    out = []
    for F, tab in zip(fac.levels, tabs):
        Fpad, C = tab["Fpad"], tab["Cmax"]
        Fc = F[:, :Fpad, :C].to(dt)
        r = torch.arange(Fpad, device=device)
        c = torch.arange(C, device=device)
        keep = (c[None, None, :] < tab["ncols"][:, None, None]) & (r[None, :, None] > c[None, None, :])
        L = torch.where(keep, Fc, 0.0)
        d = torch.diagonal(Fc[:, :C, :], dim1=1, dim2=2)
        dsafe = torch.where(d.abs() > tiny, d, 1.0)
        elim = torch.arange(Fpad, device=device)[None, :] < tab["ncols"][:, None]
        out.append((L, dsafe, elim))
    fac._solve = (key, out)
    return out


def supernodal_solve(sym: SupernodalSymbolic, fac: SupernodalFactors, b):
    """Solve A x = b with the LDL^T factors: forward (L w = b), scale
    (v = w / d), backward (L^T x = v), group by group."""
    device, dt = b.device, b.dtype
    dev = _device_plan(sym, device)
    tabs = dev["groups"]
    prep = _prepared(sym, fac, dt, device)
    y = b.index_select(0, dev["perm"])

    for tab, (L, dsafe, elim) in zip(tabs, prep):
        C = tab["Cmax"]
        yF0 = torch.where(tab["mask"], y[tab["frows"]], 0.0)
        y1 = torch.linalg.solve_triangular(L[:, :C, :], yF0[:, :C, None], upper=False,
                                           unitriangular=True)
        rest = yF0[:, C:] - (L[:, C:, :] @ y1)[..., 0]
        y1 = y1[..., 0]
        y1 = torch.where(elim[:, :C], y1 / dsafe, y1)
        yF = torch.cat([y1, rest], dim=1).reshape(-1)
        delta = (yF - yF0.reshape(-1)).index_select(0, tab["st_sel"])
        if delta.numel():
            idx = tab["st_sum"].index_on(device)
            y.index_copy_(0, idx, y.index_select(0, idx) + tab["st_sum"](delta))
        y.index_copy_(0, tab["el_rows"], yF.index_select(0, tab["el_sel"]))

    for tab, (L, dsafe, elim) in zip(reversed(tabs), reversed(prep)):
        C = tab["Cmax"]
        yF = torch.where(tab["mask"], y[tab["frows"]], 0.0)
        rhs = yF[:, :C] - (L[:, C:, :].mT @ yF[:, C:, None])[..., 0]
        x1 = torch.linalg.solve_triangular(L[:, :C, :].mT, rhs[..., None], upper=True,
                                           unitriangular=True)[..., 0]
        yF = torch.cat([x1, yF[:, C:]], dim=1).reshape(-1)
        y.index_copy_(0, tab["el_rows"], yF.index_select(0, tab["el_sel"]))

    return y.index_select(0, dev["iperm"])
