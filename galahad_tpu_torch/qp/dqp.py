"""Strictly convex QP by dual projection (DQP) and the CCQP crossover.

Counterpart of galahad_tpu/qp/dqp.py (reference src/dqp/dqp.f90:
DQP_solve :1111, exact arc search :306-310, dual gradient step :4362-4431;
src/ccqp/ccqp.f90: CCQP_solve :690).

For H SPD the Lagrange dual over w = (y_l, y_u, z_l, z_u) >= 0 is the smooth
concave quadratic

    theta(w) = -1/2 u' H^-1 u + b' w,   u(w) = B' w - g,
    B' w = A'(y_l - y_u) + (z_l - z_u),
    b = (c_l, -c_u, x_l, -x_u)

maximized over the nonnegative orthant (equality rows carry a free
multiplier).  Each iteration takes an exact arc search along the projected
dual gradient (the dual restricted to the projected ray is piecewise
quadratic; the search walks the sorted breakpoints, one H^-1 solve per
segment), then a subspace step on the free face by a fixed number of CG
iterations on B_F' H^-1 B_F, polished by a second arc search.

The JAX package runs both loops as ``lax.while_loop`` on the device.  Here
they are Python loops of tensor ops on the problem's device: the outer loop
reads its condition once per iteration, and an arc search reads its ``done``
flag once per block of ``SEGMENT_BLOCK`` segments.  Segments after ``done``
run with every carried value frozen by ``torch.where``, so the result is
bitwise what an early exit gives.  Breakpoints are sorted stably, as
``jnp.argsort`` does, and the breakpoint taken by a segment is read with
``index_select`` on a one-element index (indexing by a 0-d tensor on the
card would read the host).

H^-1 is one Cholesky up front (``linalg/cholesky.py``: cuSOLVER / LAPACK
calls, as the JAX package's are library calls), or a division by the
diagonal for the diagonal kinds.  ``exact_arc=False`` maximizes the dual by the
bound-constrained trust-region solver instead (``nlp/tru.trb_solve`` on the
negated dual, its dense Hessian from ``torch.func``), as the JAX package
does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, check_qp, classify_bounds, require_dense
from ..core.status import Status
from ..linalg.cholesky import chol_factor_shifted, chol_solve

BIG = 1.0e30
SEGMENT_BLOCK = 8        # arc-search segments between two reads of ``done``


@control_dc
class DQPControl:
    maxit: int = 200
    stop_d: float = 1.0e-8       # projected dual gradient stop
    exact_arc: bool = True       # exact piecewise-linear arc search
    max_arc_segments: int = 64   # breakpoints walked per arc search
    cg_maxit: int = 32           # subspace CG iterations
    infinity: float = INFINITY


@dataclasses.dataclass
class DQPInfo:
    """The result of ``dqp_solve``; scalars are host values.  ``host_reads``
    counts the reads of the iteration loop (its condition, the arc searches'
    ``done`` flags and the final convergence test); ``hinv_solves`` the H^-1
    applications of the whole solve."""

    x: Any
    y: Any
    z: Any
    obj: float
    iter: int
    converged: bool
    status: int
    norm_pg: float
    host_reads: int = 0
    hinv_solves: int = 0


def _dual_pieces(qp: QP, masks, ctl):
    """Static dual-space data: bounds (w_lo, w_hi), linear term b, and the
    B' / B actions (u = B'w - g)."""
    n, m = qp.n, qp.m
    zeros = lambda k: torch.zeros(k, dtype=qp.g.dtype, device=qp.g.device)  # noqa: E731

    def flag(mask, v):          # v where mask, else 0
        return zeros(mask.shape[0]).masked_fill(mask, v)

    yl_lo = flag(masks.c_equality, -BIG)
    yl_hi = flag(masks.has_cl | masks.c_equality, BIG)
    yu_hi = flag(masks.has_cu & ~masks.c_equality, BIG)
    zl_lo = flag(masks.x_fixed, -BIG)
    zl_hi = flag(masks.has_xl, BIG)
    zu_hi = flag(masks.has_xu & ~masks.x_fixed, BIG)
    w_lo = torch.cat([yl_lo, zeros(m), zl_lo, zeros(n)])
    w_hi = torch.cat([yl_hi, yu_hi, zl_hi, zu_hi])

    c_l = torch.where(masks.has_cl, qp.c_l, 0.0) if m else qp.c_l
    c_u = torch.where(masks.has_cu, qp.c_u, 0.0) if m else qp.c_u
    x_l = torch.where(masks.has_xl, qp.x_l, 0.0)
    x_u = torch.where(masks.has_xu, qp.x_u, 0.0)
    b = torch.cat([c_l, -c_u, x_l, -x_u])

    def Bt(w):          # (2m+2n,) -> (n,):  A'(y_l - y_u) + z_l - z_u
        y = w[:m] - w[m:2 * m]
        z = w[2 * m:2 * m + n] - w[2 * m + n:]
        return z + qp.Aty(y) if m else z

    def Bv(v):          # (n,) -> (2m+2n,): the adjoint
        Av = qp.Ax(v) if m else zeros(0)
        return torch.cat([Av, -Av, v, -v])

    return w_lo, w_hi, b, Bt, Bv


def bt_unit(qp: QP, j, dj):
    """B' of the vector that holds ``dj`` at index ``j`` of w and 0 elsewhere
    (``j`` a one-element index tensor, ``dj`` a 0-d tensor), read as one row
    of A and one entry instead of a whole A' matvec.  The matvec's other
    terms are exact zeros, so the bits are the same."""
    n, m = qp.n, qp.m
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    neg = ((j >= m) & (j < 2 * m)) | (j >= 2 * m + n)
    val = torch.where(neg, -dj, dj)
    in_z = j >= 2 * m
    col = torch.where(in_z, torch.remainder(j - 2 * m, n), 0)
    out = torch.zeros(n, **like).index_copy(0, col, torch.where(in_z, val, 0.0))
    if m:
        row = torch.where(in_z, 0, torch.remainder(j, m))
        out = out + qp.A.index_select(0, row)[0] * torch.where(in_z, 0.0, val)
    return out


def dqp_solve(qp: QP, y0=None, z0=None, ctl: DQPControl = DQPControl()) -> DQPInfo:
    """Solve a strictly convex QP through its dual.  H must be SPD (h_kind
    dense / diagonal / identity / scaled_identity with positive entries); a
    dense ``QP`` only (a ``SparseQP`` raises ``TypeError``).  ``y0``/``z0``
    warm-start the duals."""
    require_dense(qp, "dqp_solve")
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    n, m = qp.n, qp.m
    bad = check_qp(qp, ctl.infinity)           # -3 / -4 entry contract
    if bad != 0:
        zn = torch.zeros(n, **like)
        return DQPInfo(x=zn, y=torch.zeros(m, **like), z=zn, obj=float("nan"), iter=0,
                       converged=False, status=bad, norm_pg=float("inf"))
    masks = classify_bounds(qp, ctl.infinity)
    count = dict(solves=0, reads=0)

    # H^-1: one factorization up front
    if qp.h_kind in ("diagonal", "identity", "scaled_identity", "zero"):
        hd = qp.H_diag()

        def Hinv(v):
            count["solves"] += 1
            return v / hd
    else:
        L, _, _ = chol_factor_shifted(qp.H, 0.0)
        # row-major, as the JAX package's factor: the triangular solves then
        # run the same orientation (and round nearer to its bits) as its own
        L = L.contiguous()

        def Hinv(v):
            count["solves"] += 1
            return chol_solve(L, v)

    def read(flag) -> bool:
        count["reads"] += 1
        return bool(flag)

    w_lo, w_hi, b, Bt, Bv = _dual_pieces(qp, masks, ctl)

    def as_vec(v, k):
        if v is None:
            return torch.zeros(k, **like)
        return torch.as_tensor(v).to(**like)

    y0, z0 = as_vec(y0, m), as_vec(z0, n)
    w0 = torch.cat([torch.clamp(y0, min=0.0), torch.clamp(-y0, min=0.0),
                    torch.clamp(z0, min=0.0), torch.clamp(-z0, min=0.0)])
    w0 = torch.clamp(w0, w_lo, w_hi)

    if not ctl.exact_arc:
        return _dqp_by_trb(qp, ctl, w0, w_lo, w_hi, b, Bt, Hinv, count)

    def grad_theta(w):
        return b - Bv(Hinv(Bt(w) - qp.g))

    def proj_grad(w, g):
        d = torch.where(w <= w_lo, torch.clamp(g, min=0.0), g)
        return torch.where(w >= w_hi, torch.clamp(d, max=0.0), d)

    Hig = Hinv(qp.g)
    eps = 1e-30

    def arc_search(w, d):
        """Exact arc search along the projected ray w(t) = P(w + t d).

        The path is piecewise linear; between breakpoints theta is a concave
        quadratic whose slope p(t) = b'd - v'H^-1 u(t) and curvature
        q = -v'H^-1 v change across each breakpoint by that component's
        rank-one contribution: one H^-1 solve per segment."""
        neg, pos = d < 0, d > 0
        t_hit = torch.where(neg, (w_lo - w) / torch.where(neg, d, -1.0),
                            torch.where(pos, (w_hi - w) / torch.where(pos, d, 1.0), BIG))
        t_hit = torch.where(t_hit.abs() >= BIG, BIG, torch.clamp(t_hit, min=0.0))
        order = torch.argsort(t_hit, stable=True)
        K = min(ctl.max_arc_segments, int(t_hit.shape[0]))
        v = Bt(d)
        # unbounded-ray cap: theta increasing past every breakpoint means the
        # dual is unbounded (primal infeasible); move a large finite multiple
        # of the direction instead of BIG
        t_cap = ((1.0 + torch.linalg.norm(w)) * 1e10
                 / torch.clamp(torch.linalg.norm(d), min=eps))
        t_cur = torch.zeros((), **like)
        t_best = torch.zeros((), **like)
        done = torch.zeros((), dtype=torch.bool, device=like["device"])
        d_cur, Hiv, Hiu = d, Hinv(v), Hinv(Bt(w)) - Hig
        k = 0
        while k < K:
            for _ in range(min(SEGMENT_BLOCK, K - k)):
                j = order[k:k + 1]
                t_next = torch.clamp(t_hit.index_select(0, j)[0], max=BIG)
                p = torch.dot(b, d_cur) - torch.dot(v, Hiu)
                q = -torch.dot(v, Hiv)
                p_pos = p > eps          # a noise-level slope counts as converged
                t_star = torch.where(q < -eps, t_cur - p / q, BIG)
                inside = p_pos & (t_star < t_next)
                unbounded = p_pos & ~inside & (t_next >= BIG)
                t_take = torch.where(
                    ~p_pos, t_cur,
                    torch.where(inside, t_star,
                                torch.where(unbounded, torch.minimum(t_star, t_cap), t_next)))
                t_best = torch.where(done, t_best, t_take)
                dj = d_cur.index_select(0, j)[0]
                vj = bt_unit(qp, j, dj)
                # the segment's update, frozen once an earlier segment was done
                Hiu = torch.where(done, Hiu, Hiu + (t_next - t_cur) * Hiv)
                t_cur = torch.where(done, t_cur, t_next)
                d_cur = torch.where(done, d_cur, d_cur.index_fill(0, j, 0.0))
                v = torch.where(done, v, v - vj)
                Hiv = torch.where(done, Hiv, Hiv - Hinv(vj))
                done = done | inside | ~p_pos | (t_next >= BIG)
                k += 1
            if k < K and read(done):
                break
        t_best = torch.where(done, t_best, torch.minimum(t_cur, t_cap))
        return torch.clamp(w + t_best * d, w_lo, w_hi)

    def subspace_step(w):
        """CG on the free face: maximize theta over {i: w_i strictly inside}
        (the reference's subspace step, dqp.f90:312-322)."""
        gm = grad_theta(w)
        free = (w > w_lo) & (w < w_hi)
        gm = torch.where(free, gm, 0.0)

        def Kmul(p):
            return torch.where(free, Bv(Hinv(Bt(torch.where(free, p, 0.0)))), 0.0)

        # CG for K dw = gm (K PSD), a fixed number of iterations
        p, r, dw, rs = gm, gm, torch.zeros_like(w), torch.dot(gm, gm)
        for _ in range(ctl.cg_maxit):
            Kp = Kmul(p)
            alpha = rs / torch.clamp(torch.dot(p, Kp), min=1e-30)
            dw = dw + alpha * p
            r = r - alpha * Kp
            rs_new = torch.dot(r, r)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            p, rs = r + beta * p, rs_new
        # fraction to the boundary, then an exact arc polish along dw
        return arc_search(w, torch.where(free, dw, 0.0))

    def pg_norm(w):
        return torch.linalg.norm(proj_grad(w, grad_theta(w)))

    w, iters, npg = w0, 0, pg_norm(w0)
    while iters < ctl.maxit and read(npg > ctl.stop_d):
        w = arc_search(w, proj_grad(w, grad_theta(w)))
        w = subspace_step(w)
        iters += 1
        npg = pg_norm(w)
    conv = read(npg <= ctl.stop_d)

    y = w[:m] - w[m:2 * m]
    z = w[2 * m:2 * m + n] - w[2 * m + n:]
    u = z - qp.g + qp.Aty(y) if m else z - qp.g
    x = Hinv(u)
    return DQPInfo(x=x, y=y, z=z, obj=float(qp.objective(x)), iter=iters, converged=conv,
                   status=int(Status.OK) if conv else int(Status.MAX_ITERATIONS),
                   norm_pg=float(npg), host_reads=count["reads"],
                   hinv_solves=count["solves"])


def _dqp_by_trb(qp: QP, ctl: DQPControl, w0, w_lo, w_hi, b, Bt, Hinv, count) -> DQPInfo:
    """``exact_arc=False``: ``trb_solve`` on the negated dual over the box
    [w_lo, w_hi] (JAX qp/dqp.py:160-168), stopping at ||P(w - g) - w|| <=
    stop_d.  ``host_reads`` are trb_solve's reads of its flags."""
    from ..nlp.tru import TRBControl, trb_solve

    n, m = qp.n, qp.m

    def neg_dual(w):
        u = Bt(w) - qp.g
        return -(-0.5 * torch.dot(u, Hinv(u)) + torch.dot(b, w))

    st = trb_solve(neg_dual, w0, w_lo, w_hi,
                   TRBControl(maxit=ctl.maxit, stop_g_absolute=ctl.stop_d, stop_g_relative=0.0))
    w = st.x
    y = w[:m] - w[m:2 * m]
    z = w[2 * m:2 * m + n] - w[2 * m + n:]
    u = z - qp.g + qp.Aty(y) if m else z - qp.g
    x = Hinv(u)
    return DQPInfo(x=x, y=y, z=z, obj=float(qp.objective(x)), iter=int(st.iter),
                   converged=bool(st.converged), status=int(st.status),
                   norm_pg=float(st.norm_g), host_reads=st.host_reads,
                   hinv_solves=count["solves"])


def ccqp_solve(qp: QP, ipm_ctl=None, dqp_ctl: DQPControl = DQPControl()) -> DQPInfo:
    """CCQP: an interior-point solve, then the dual-projection refinement
    (reference src/ccqp/ccqp.f90:690).  The IPM supplies near-optimal duals;
    DQP sharpens them to an exact face, the basic solution the pure IPM
    cannot give."""
    from .ipm import IPMControl, ipm_solve

    require_dense(qp, "ccqp_solve")
    _, y, z, _ = ipm_solve(qp, ipm_ctl or IPMControl())
    return dqp_solve(qp, y0=y, z0=z, ctl=dqp_ctl)
