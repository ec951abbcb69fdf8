"""LP by the simplex method (vertex solutions).

Counterpart of galahad_tpu/qp/lpa.py (GALAHAD's LPA, reference
src/lpa/lpa.f90, a wrapper of HSL LA04's revised simplex).  The simplex
method is sequential and pivot-driven, so, as the reference delegates to
a host code and the JAX package runs numpy, this is the port's own copy of
that dense two-phase bounded-variable revised simplex (Bland's rule) on the
host.  The problem's arrays come from its device in one read; x, y and z
go back to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, check_qp
from ..core.status import Status


@control_dc
class LPAControl:
    maxit: int = 10000
    tol: float = 1.0e-9
    infinity: float = INFINITY


@dataclasses.dataclass
class LPAInfo:
    x: Any
    y: Any
    z: Any
    obj: float
    status: int
    iter: int
    basis: Any            # indices of basic variables (extended space)


def _bounded_simplex(g, A, b, lo, hi, basis, ctl, v=None, at_lo=None):
    """Bounded-variable revised simplex, min g'v, Av = b, lo<=v<=hi.
    ``basis``: initial basic index set (len m).  Nonbasic variables sit
    on a finite bound (at lo where finite, else hi, else 0).  ``v`` /
    ``at_lo`` carry the bound-flip state between phases; if omitted a
    cold nonbasic point is derived from the bounds."""
    m, n = A.shape
    if v is None:
        v = np.where(np.isfinite(lo), lo,
                     np.where(np.isfinite(hi), hi, 0.0))
    else:
        v = np.array(v, np.float64, copy=True)
    if at_lo is None:
        at_lo = np.isfinite(lo) | ~np.isfinite(hi)
    else:
        at_lo = np.array(at_lo, bool, copy=True)

    basis = list(basis)
    nonbasic = [j for j in range(n) if j not in set(basis)]
    for it in range(1, ctl.maxit + 1):
        B = A[:, basis]
        try:
            Binv_b = np.linalg.solve(B, b - A[:, nonbasic] @ v[nonbasic])
        except np.linalg.LinAlgError:
            return v, None, it, int(Status.FACTORIZATION), basis, at_lo
        v[basis] = Binv_b
        # duals & reduced costs
        yv = np.linalg.solve(B.T, g[basis])
        rc = g[nonbasic] - A[:, nonbasic].T @ yv
        # entering: Bland's rule — smallest eligible *variable index*
        # (not list order, which mutates under pivots) for anti-cycling
        enter_pos = None
        enter_var = n + 1
        for k, j in enumerate(nonbasic):
            free = not (np.isfinite(lo[j]) or np.isfinite(hi[j]))
            if (at_lo[j] or free) and rc[k] < -ctl.tol and j < enter_var:
                enter_pos, enter_var, direction = k, j, 1.0
            elif ((not at_lo[j]) or free) and rc[k] > ctl.tol \
                    and j < enter_var:
                enter_pos, enter_var, direction = k, j, -1.0
        if enter_pos is None:
            return v, yv, it, int(Status.OK), basis, at_lo
        j = nonbasic[enter_pos]
        d = np.linalg.solve(B, A[:, j]) * direction
        # ratio test on basic variables and the entering variable's
        # opposite bound
        alpha = hi[j] - lo[j] if np.isfinite(hi[j]) and np.isfinite(lo[j]) \
            else np.inf
        leave = None
        for i, bi in enumerate(basis):
            if d[i] > ctl.tol and np.isfinite(lo[bi]):
                a = (v[bi] - lo[bi]) / d[i]
                if a < alpha - 1e-15:
                    alpha, leave = a, (i, -1)
            elif d[i] < -ctl.tol and np.isfinite(hi[bi]):
                a = (v[bi] - hi[bi]) / d[i]
                if a < alpha - 1e-15:
                    alpha, leave = a, (i, 1)
        if not np.isfinite(alpha):
            return v, yv, it, int(Status.UNBOUNDED), basis, at_lo
        v[j] += direction * alpha
        v[basis] -= alpha * d
        if leave is not None:
            i, which = leave
            bi = basis[i]
            v[bi] = lo[bi] if which < 0 else hi[bi]
            at_lo[bi] = which < 0
            basis[i] = j
            nonbasic[enter_pos] = bi
        else:
            at_lo[j] = not at_lo[j]
    return v, None, ctl.maxit, int(Status.MAX_ITERATIONS), basis, at_lo


def lpa_solve(qp: QP, ctl: LPAControl = LPAControl()) -> LPAInfo:
    """Solve the LP min g'x s.t. c_l <= Ax <= c_u, x_l <= x <= x_u by the
    two-phase simplex; a vertex solution with its basis (LPA_solve,
    reference src/lpa/lpa.f90:712).  ``obj`` is a host float."""
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    n, m = qp.n, qp.m
    bad = check_qp(qp, ctl.infinity)
    if bad != 0:
        z = torch.zeros(n, **like)
        return LPAInfo(x=z, y=torch.zeros(m, **like), z=z, obj=float("nan"),
                       status=bad, iter=0, basis=np.zeros(0, np.int64))
    host = torch.cat([qp.g, qp.A.reshape(-1), qp.x_l, qp.x_u, qp.c_l, qp.c_u]
                     ).to(torch.float64).cpu().numpy()
    g = host[:n]
    A = host[n:n + m * n].reshape(m, n)
    xl, xu, cl, cu = np.split(host[n + m * n:], [n, 2 * n, 2 * n + m])
    inf = ctl.infinity
    xl = np.where(xl <= -inf, -np.inf, xl)
    xu = np.where(xu >= inf, np.inf, xu)
    cl = np.where(cl <= -inf, -np.inf, cl)
    cu = np.where(cu >= inf, np.inf, cu)
    out = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=like["device"]).to(
        like["dtype"])

    # m == 0: the LP separates per variable
    if m == 0:
        unb = ((g < 0) & ~np.isfinite(xu)) | ((g > 0) & ~np.isfinite(xl))
        x = np.where(g > 0, xl, np.where(g < 0, xu, np.where(np.isfinite(xl), xl, 0.0)))
        x = np.where(np.isfinite(x), x, 0.0)
        st = int(Status.UNBOUNDED) if unb.any() else int(Status.OK)
        return LPAInfo(x=out(x), y=torch.zeros(0, **like), z=out(g),
                       obj=float(g @ x) + float(qp.f), status=st, iter=0,
                       basis=np.zeros(0, np.int64))

    # extended: v = [x; s], A x - s = 0, cl <= s <= cu
    A_e = np.concatenate([A, -np.eye(m)], axis=1)
    g_e = np.concatenate([g, np.zeros(m)])
    lo = np.concatenate([xl, cl])
    hi = np.concatenate([xu, cu])
    b = np.zeros(m)

    # phase 1: artificials, a crash basis of them, their bounds chosen so
    # that the start is feasible
    A1 = np.concatenate([A_e, np.eye(m)], axis=1)
    v0 = np.where(np.isfinite(lo), lo, np.where(np.isfinite(hi), hi, 0.0))
    r0 = b - A_e @ v0
    lo1 = np.concatenate([lo, np.minimum(r0, 0.0)])
    hi1 = np.concatenate([hi, np.maximum(r0, 0.0)])
    g1 = np.concatenate([np.zeros(n + m), np.sign(r0) + (r0 == 0)])
    basis = list(range(n + m, n + 2 * m))
    v1, _, it1, st1, basis, at_lo1 = _bounded_simplex(g1, A1, b, lo1, hi1, basis, ctl)
    if st1 != int(Status.OK) or np.sum(np.abs(v1[n + m:])) > 1e-7:
        return LPAInfo(x=out(v1[:n]), y=torch.zeros(m, **like), z=torch.zeros(n, **like),
                       obj=np.inf, status=int(Status.PRIMAL_INFEASIBLE), iter=it1,
                       basis=np.asarray(basis))
    # phase 2 keeps phase 1's bound-flip state; the artificials are fixed at 0
    lo1[n + m:] = 0.0
    hi1[n + m:] = 0.0
    v1[n + m:] = 0.0
    g2 = np.concatenate([g_e, np.zeros(m)])
    v2, yv, it2, st2, basis, _ = _bounded_simplex(g2, A1, b, lo1, hi1, basis, ctl,
                                                  v=v1, at_lo=at_lo1)
    iters = it1 + it2
    if st2 == int(Status.OK):
        # guard: the claimed optimum is primal feasible
        ftol = 1e-6 * (1.0 + np.abs(b).max(initial=0.0) + np.abs(v2[:n + m]).max(initial=0.0))
        lo_ok = np.all(v2[:n + m] >= np.where(np.isfinite(lo), lo, -np.inf) - ftol)
        hi_ok = np.all(v2[:n + m] <= np.where(np.isfinite(hi), hi, np.inf) + ftol)
        res_ok = np.abs(A1 @ v2 - b).max(initial=0.0) <= ftol
        if not (lo_ok and hi_ok and res_ok):
            st2 = int(Status.PRIMAL_INFEASIBLE)

    x = v2[:n]
    y = yv if yv is not None else np.zeros(m)
    z = g - A.T @ y
    return LPAInfo(x=out(x), y=out(y), z=out(z), obj=float(g @ x) + float(qp.f),
                   status=st2, iter=iters,
                   basis=np.asarray([bi for bi in basis if bi < n + m]))
