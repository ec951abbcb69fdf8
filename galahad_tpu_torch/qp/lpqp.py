"""Reformulate a QP as an l1-penalty QP (elastic form).

Counterpart of galahad_tpu/qp/lpqp.py (GALAHAD's LPQP, reference
src/lpqp/lpqp.f90): over w = [x; u; v] with elastics u, v >= 0,

    min 1/2 x'Hx + g'x + rho 1'(u + v)   s.t.  c_l <= A x + u - v <= c_u,

always feasible (the exact-penalty property).  The result is a dense
``QP`` on the device of ``qp``; ``lpqp_restore`` maps a solution back.
"""
from __future__ import annotations

import torch

from ..core.problem import INFINITY, QP


def lpqp_formulate(qp: QP, rho: float, infinity: float = INFINITY) -> QP:
    """The elastic l1-QP over w = [x; u; v] (LPQP_formulate)."""
    n, m = qp.n, qp.m
    if m == 0:
        return qp
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    Hw = torch.zeros((n + 2 * m, n + 2 * m), **like)
    Hw[:n, :n] = qp.H_dense()
    eye = torch.eye(m, **like)
    x0 = qp.x if qp.x is not None else torch.zeros(n, **like)
    return QP(H=Hw, g=torch.cat([qp.g, torch.full((2 * m,), rho, **like)]),
              A=torch.cat([qp.A, eye, -eye], dim=1), c_l=qp.c_l, c_u=qp.c_u,
              x_l=torch.cat([qp.x_l, torch.zeros(2 * m, **like)]),
              x_u=torch.cat([qp.x_u, torch.full((2 * m,), 2 * infinity, **like)]),
              f=qp.f, x=torch.cat([x0, torch.zeros(2 * m, **like)]),
              name=(qp.name + "_l1") if qp.name else "", h_kind="dense")


def lpqp_restore(qp: QP, w, y=None, zw=None):
    """(x, u, v, y, z) from the elastic solution (LPQP_restore)."""
    n, m = qp.n, qp.m
    z = zw[:n] if zw is not None else None
    return w[:n], w[n:n + m], w[n + m:n + 2 * m], y, z


def lpqp_violation(qp: QP, w):
    """The l1 constraint violation the elastics absorb."""
    n, m = qp.n, qp.m
    return w[n:n + 2 * m].sum()
