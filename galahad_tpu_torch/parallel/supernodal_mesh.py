"""Mesh-sharded SUPERNODAL KKT solve.

Counterpart of galahad_tpu/parallel/supernodal_mesh.py.  The sparse
augmented system is split along the elimination tree: the grid falls into D
strips (independent subtrees under the top separators, the SSIDS
per-NUMA-region subtree assignment, reference src/spral/hw_topology.f90,
src/ssids/ssids.f90:736), each slot runs the whole flat supernodal LDL^T of
its strip's local KKT block (linalg/supernodal_flat.py: on the card the hand
kernels of rows 1a, 1b, 3, 2a and 2b), and the only communication is ONE
fixed-order sum (parallel/mesh.py ``psum``) assembling the separator Schur
complement:

    K = [ K_1                B_1 ]      S = K_ss - sum_d B_d' K_d^-1 B_d
        [      ...           ... ]
        [           K_D      B_D ]
        [ B_1' ...  B_D'    K_ss ]

All strips share ONE symbolic plan (their local patterns are the same by
construction, and :func:`build_strip_grid_kkt` checks it, rows and
columns); the separator system is solved on every slot, and the
back-substitution is local again.  W = K_d^-1 B_d takes one solve per
separator column (the JAX package ``vmap``s its solve over them): on the card
the solve is captured once per strip as a CUDA graph and replayed per
column.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from ..linalg import supernodal_flat as _flat
from ..linalg import sweep_kernels
from ..linalg.supernodal_flat import flat_analyse, flat_factorize, flat_solve
from .mesh import Mesh, on_device, psum


def _grid_system(D: int, w: int, R: int, seed: int) -> dict:
    """The grid QP's augmented K (lower COO in the JAX package's entry
    order), its strip partition and the right-hand sides, drawn from one
    ``default_rng(seed)`` stream in the JAX package's order."""
    C = D * w + (D - 1)
    rng = np.random.default_rng(seed)
    nv = R * C
    mrows = (R - 1) * C
    N = nv + mrows
    dx = rng.uniform(0.5, 2.0, nv)
    cd = rng.uniform(0.1, 1.0, mrows)
    u = rng.uniform(0.8, 1.2, 2 * mrows).reshape(C, R - 1, 2)

    # variables, column by column: the diagonal, the neighbour below, the
    # neighbour to the right (vid(r, c) = c R + r)
    v = np.arange(nv).reshape(C, R)
    r_of, c_of = v % R, v // R
    i3 = np.stack([v, v, v], -1)
    j3 = np.stack([v, v + 1, v + R], -1)
    x3 = np.stack([4.0 + dx[v], np.full((C, R), -1.0), np.full((C, R), -1.0)], -1)
    ok3 = np.stack([np.ones((C, R), bool), r_of + 1 < R, c_of + 1 < C], -1)
    # constraints, column by column: the diagonal and the two vertical ends
    j = nv + np.arange(mrows).reshape(C, R - 1)
    top = np.arange(C)[:, None] * R + np.arange(R - 1)[None, :]
    i_c = np.stack([j, j, j], -1)
    j_c = np.stack([j, top, top + 1], -1)
    x_c = np.stack([-(0.1 + cd[j - nv]), u[..., 0], u[..., 1]], -1)
    ii = np.concatenate([i3[ok3], i_c.reshape(-1)])
    jj = np.concatenate([j3[ok3], j_c.reshape(-1)])
    vals = np.concatenate([x3[ok3], x_c.reshape(-1)])
    rows, cols = np.maximum(ii, jj), np.minimum(ii, jj)

    # strip d owns grid columns [d (w + 1), d (w + 1) + w); separators between
    def col_indices(cs):
        cs = np.asarray(cs, np.int64)
        vi = (cs[:, None] * R + np.arange(R)[None, :]).reshape(-1)
        ci = (nv + cs[:, None] * (R - 1) + np.arange(R - 1)[None, :]).reshape(-1)
        return np.concatenate([vi, ci])

    interior = [col_indices(range(d * (w + 1), d * (w + 1) + w)) for d in range(D)]
    sep = col_indices([d * (w + 1) + w for d in range(D - 1)]) if D > 1 else \
        np.zeros(0, np.int64)
    nd, ns = len(interior[0]), len(sep)
    b_loc = rng.normal(size=(D, nd))
    b_sep = rng.normal(size=ns)
    return dict(rows=rows, cols=cols, vals=vals, N=N, interior=interior, sep=sep,
                nd=nd, ns=ns, b_loc=b_loc, b_sep=b_sep)


def _strip_values(lr, lc, ld, lv, D: int):
    """The strips' local values in strip 0's canonical entry order (rows, then
    columns): (lrows, lcols, values (D, nnz)).  Every strip's sorted pattern
    must equal strip 0's in its rows AND its columns (the JAX package compares
    the rows only, galahad_tpu/parallel/supernodal_mesh.py:125): one plan
    serves every strip, so a strip whose columns differ would be factorized
    with another matrix's plan."""
    sel0 = ld == 0
    order0 = np.lexsort((lc[sel0], lr[sel0]))
    lrows, lcols = lr[sel0][order0], lc[sel0][order0]
    out = np.zeros((D, len(lrows)))
    for d in range(D):
        seld = ld == d
        od = np.lexsort((lc[seld], lr[seld]))
        if not (np.array_equal(lr[seld][od], lrows) and np.array_equal(lc[seld][od], lcols)):
            raise ValueError(f"strip {d}'s pattern differs from strip 0's: one plan cannot "
                             f"serve both")
        out[d] = lv[seld][od]
    return lrows, lcols, out


def strip_grid_reference(D: int, w: int, R: int, seed: int = 0, solve: bool = True) -> dict:
    """The monolithic system of :func:`build_strip_grid_kkt` and its solution
    by ``scipy.sparse.linalg.spsolve``, host only: dict(Kfull, rhs, x_ref;
    without ``solve`` no x_ref).  What ``build_strip_grid_kkt(...,
    reference=True)`` stores, apart so that a caller can compute it elsewhere
    (chip_smoke.py's CPU pool)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg  # noqa: F401

    g = _grid_system(D, w, R, seed)
    rows, cols, vals, N = g["rows"], g["cols"], g["vals"], g["N"]
    off = rows != cols
    Kfull = sp.csr_matrix(
        (np.concatenate([vals, vals[off]]),
         (np.concatenate([rows, cols[off]]), np.concatenate([cols, rows[off]]))),
        shape=(N, N))
    rhs = np.zeros(N)
    for d, I in enumerate(g["interior"]):
        rhs[I] = g["b_loc"][d]
    rhs[g["sep"]] = g["b_sep"]
    out = dict(Kfull=Kfull, rhs=rhs)
    if solve:
        out["x_ref"] = sp.linalg.spsolve(Kfull.tocsc(), rhs)
    return out


def build_strip_grid_kkt(D: int, w: int, R: int, seed: int = 0, reference: bool = True):
    """Build a grid-QP augmented KKT partitioned into D strips of w grid
    columns separated by single-column separators (grid = R rows x C = D w +
    (D - 1) columns; 5-point Laplacian H, one local linking constraint per
    vertical neighbour pair, barrier-like diagonals), on the host with numpy:
    the same (D, w, R, seed) gives the JAX package's arrays bit for bit.

    Returns (plan, parts): ``plan`` the one flat plan of every strip
    (``flat_analyse``, AMD, relax_cols 8); ``parts`` holds float64 CPU tensors
      vals   (D, nnz_local)  local KKT values in plan COO order
      B      (D, nd, ns)     strip <-> separator coupling (dense)
      Kss    (ns, ns)        separator block
      b      (D, nd)         local RHS;  bs (ns,) separator RHS
    and ``interior``, ``sep``, ``nd``, ``ns``; with ``reference`` also those of
    :func:`strip_grid_reference` (``Kfull``, ``rhs``, ``x_ref``)."""
    g = _grid_system(D, w, R, seed)
    rows, cols, vals, N = g["rows"], g["cols"], g["vals"], g["N"]
    interior, sep, nd, ns = g["interior"], g["sep"], g["nd"], g["ns"]

    # global -> (owner, local position); separators owner = -1
    owner = np.full(N, -1, np.int64)
    lpos = np.full(N, -1, np.int64)
    for d, I in enumerate(interior):
        owner[I] = d
        lpos[I] = np.arange(nd)
    spos = np.full(N, -1, np.int64)
    spos[sep] = np.arange(ns)

    o_r, o_c = owner[rows], owner[cols]
    local = (o_r >= 0) & (o_r == o_c)
    lrows, lcols, vstack = _strip_values(lpos[rows[local]], lpos[cols[local]], o_r[local],
                                         vals[local], D)
    plan = flat_analyse(lrows, lcols, nd, order="amd", relax_cols=8)

    # coupling B_d (nd, ns) and the separator block (each entry receives one value)
    B = np.zeros((D, nd, ns))
    cross = (o_r >= 0) & (o_c == -1) & (spos[cols] >= 0)
    np.add.at(B, (o_r[cross], lpos[rows[cross]], spos[cols[cross]]), vals[cross])
    cross2 = (o_c >= 0) & (o_r == -1) & (spos[rows] >= 0)
    np.add.at(B, (o_c[cross2], lpos[cols[cross2]], spos[rows[cross2]]), vals[cross2])
    Kss = np.zeros((ns, ns))
    ss = (o_r == -1) & (o_c == -1)
    a, c = spos[rows[ss]], spos[cols[ss]]
    np.add.at(Kss, (a, c), vals[ss])
    off = a != c
    np.add.at(Kss, (c[off], a[off]), vals[ss][off])

    parts = dict(vals=torch.from_numpy(vstack), B=torch.from_numpy(B),
                 Kss=torch.from_numpy(Kss), b=torch.from_numpy(g["b_loc"]),
                 bs=torch.from_numpy(g["b_sep"]), interior=interior, sep=sep, nd=nd, ns=ns)
    if reference:
        parts.update(strip_grid_reference(D, w, R, seed))
    return plan, parts


class ColumnSolve:
    """``flat_solve`` with one strip's factors, for many right-hand sides.
    On the card (unless ``GALAHAD_TPU_FUSED=0``) the solve runs once
    directly (it builds the kernels and uploads the plan's tables) and is then
    captured as a CUDA graph on a static input, which every later solve
    replays; ``replays`` counts them and ``launches_per_replay`` holds the
    kernel wrappers' counter moves during the capture."""

    def __init__(self, plan, fac, like: torch.Tensor):
        from ..qp.fused import fused_enabled, launch_counts

        self.plan, self.fac = plan, fac
        self.graph = None
        self.replays = 0
        self.launches_per_replay = {}
        self.levels = []
        if like.device.type != "cuda" or not fused_enabled():
            return
        self.levels = [lvp["sweep"] for lvp in _flat._device_plan(plan, like.device)["levels"]]
        self.inp = torch.zeros(plan.n, dtype=like.dtype, device=like.device)
        flat_solve(plan, fac, self.inp)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    self.out = flat_solve(plan, fac, self.inp)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream().wait_stream(side)
        after = launch_counts()
        self.launches_per_replay = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def into(self, r, dst) -> None:
        """``dst`` <- K^-1 ``r``."""
        if self.graph is None:
            dst.copy_(flat_solve(self.plan, self.fac, r))
            return
        self.inp.copy_(r)
        self.graph.replay()
        self.replays += 1
        dst.copy_(self.out)

    def __call__(self, r):
        out = torch.empty_like(r)
        self.into(r, out)
        return out

    def check(self) -> None:
        """Raise if a replayed sweep gave up waiting (the captured wrappers
        cannot raise for it; qp/fused.py asks the same at every fetch)."""
        if self.levels:
            sweep_kernels.sweep_check(self.levels)


def sharded_kkt_solve(mesh: Mesh, plan, vals, B, Kss, b, bs, axis: str = "batch",
                      stats: dict | None = None):
    """One supernodal factorize + Schur solve, sharded over the slots of
    ``axis`` (one strip a slot): the local flat LDL^T of each strip on its
    slot, W = K_d^-1 B_d column by column (:class:`ColumnSolve`), ONE
    fixed-order sum for the separator Schur complement and reduced
    right-hand side, the dense separator solve (``torch.linalg.solve``) on
    every slot, and the local back-substitution.  Returns (x_local (D, nd),
    x_sep (ns,)) on the axis's first device.  ``stats``, if a dict, receives
    the column solves' ``replays`` and ``launches_per_replay`` summed over the
    strips (the wrappers count a captured launch once, at the capture)."""
    slots = mesh.axis_devices(axis)
    if vals.shape[0] != len(slots):
        raise ValueError(f"{vals.shape[0]} strips for {len(slots)} slots of {axis!r}")
    strips = []
    for d, slot in enumerate(slots):
        with on_device(slot):
            v, Bd, bd = vals[d].to(slot), B[d].to(slot), b[d].to(slot)
            fac = flat_factorize(plan, v)
            solve = ColumnSolve(plan, fac, v)
            Bt = Bd.T.contiguous()
            Wt = torch.empty_like(Bt)
            for j in range(Bt.shape[0]):
                solve.into(Bt[j], Wt[j])                  # rows of (K_d^-1 B_d)'
            strips.append(dict(Bd=Bd, bd=bd, solve=solve, S=Bt @ Wt.T, r=Bt @ solve(bd)))
    S_all = psum([s["S"] for s in strips], slots)         # the ONE collective
    r_all = psum([s["r"] for s in strips], slots)
    xs, x_seps = [], []
    for s, S, r, slot in zip(strips, S_all, r_all, slots):
        with on_device(slot):
            x_s = torch.linalg.solve(Kss.to(slot) - S, bs.to(slot) - r)
            xs.append(s["solve"](s["bd"] - s["Bd"] @ x_s))
            x_seps.append(x_s)
            s["solve"].check()
    if stats is not None:
        stats["replays"] = sum(s["solve"].replays for s in strips)
        per = {}
        for s in strips:
            for k, n in s["solve"].launches_per_replay.items():
                per[k] = per.get(k, 0) + n * s["solve"].replays
        stats["launches_in_replays"] = per
        stats["launches_in_captures"] = {
            k: sum(s["solve"].launches_per_replay.get(k, 0) for s in strips) for k in per}
    home = slots[0]
    return torch.stack([x.to(home) for x in xs]), x_seps[0]


def sharded_kkt_residual(parts, xs, xsep) -> float:
    """Relative residual of the sharded solve against the monolithic sparse
    K (host check; needs ``parts`` built with ``reference=True``)."""
    x = np.zeros(parts["Kfull"].shape[0])
    for d, I in enumerate(parts["interior"]):
        x[I] = xs[d].cpu().numpy()
    x[parts["sep"]] = xsep.cpu().numpy()
    r = parts["Kfull"] @ x - parts["rhs"]
    return float(np.linalg.norm(r) / np.linalg.norm(parts["rhs"]))
