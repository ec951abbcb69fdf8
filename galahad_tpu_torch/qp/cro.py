"""Crossover: interior-point solution -> basic (vertex-like) solution.

Counterpart of galahad_tpu/qp/cro.py (GALAHAD's CRO, reference
src/cro/cro.f90: CRO_crossover_main :710).  Given an IPM solution of a
convex QP, keep x, move it onto the detected active set, and rebuild the
multipliers on a linearly independent subset of the active constraints
(``uls_find_basis``, pivoted QR) by least squares, dropping wrong-signed
ones and re-solving.  As in the JAX package this is host work (numpy); the
problem's products run on its device, and x, y and z go back to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, classify_bounds
from ..core.status import Status
from ..linalg.uls import uls_find_basis


@control_dc
class CROControl:
    feas_tol: float = 1.0e-5      # activity detection tolerance
    sign_tol: float = 1.0e-9      # wrong-sign threshold
    max_sweeps: int = 50
    infinity: float = INFINITY


@dataclasses.dataclass
class CROInfo:
    x: Any
    y: Any
    z: Any
    c_stat: Any
    b_stat: Any
    status: int
    dependent: int      # active constraints dropped as dependent


def _np(t):
    return t.detach().to(torch.float64).cpu().numpy()


def cro_crossover(qp: QP, x, y, z, ctl: CROControl = CROControl()) -> CROInfo:
    """Purify (x, y, z): rebuild (y, z) supported on a linearly independent
    subset of the active constraints with correct signs; returns the
    C_stat / B_stat activity flags (cro.f90:710's output contract)."""
    masks = classify_bounds(qp, ctl.infinity)
    n, m = qp.n, qp.m
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    xh = _np(x)
    zh = _np(z) if z is not None else np.zeros(n)
    yh = _np(y) if (y is not None and m) else np.zeros(m)
    xl, xu = _np(qp.x_l), _np(qp.x_u)
    has_xl, has_xu = _np(masks.has_xl) != 0, _np(masks.has_xu) != 0
    # activity by the primal-dual indicator (CQP_indicators, cqp.f90:9885)
    # and an absolute tolerance for bounds attained exactly
    on_lo = has_xl & ((xh - xl <= ctl.feas_tol * (1 + np.abs(xl)))
                      | (np.maximum(zh, 0.0) > xh - xl))
    on_hi = has_xu & ((xu - xh <= ctl.feas_tol * (1 + np.abs(xu)))
                      | (np.maximum(-zh, 0.0) > xu - xh))
    b_sig = np.where(on_lo, -1, np.where(on_hi, 1, 0)).astype(np.int8)
    if m:
        ch = _np(qp.Ax(torch.as_tensor(xh, device=like["device"]).to(like["dtype"])))
        cl, cu = _np(qp.c_l), _np(qp.c_u)
        eq = _np(masks.c_equality) != 0
        on_cl = (_np(masks.has_cl) != 0) & ((ch - cl <= ctl.feas_tol * (1 + np.abs(cl)))
                                            | (np.maximum(yh, 0.0) > ch - cl))
        on_cu = (_np(masks.has_cu) != 0) & ((cu - ch <= ctl.feas_tol * (1 + np.abs(cu)))
                                            | (np.maximum(-yh, 0.0) > cu - ch))
        c_sig = np.where(eq | on_cl, -1, np.where(on_cu, 1, 0)).astype(np.int8)
    else:
        cl = cu = np.zeros(0)
        c_sig = np.zeros(0, np.int8)
        eq = np.zeros(0, bool)
    A = _np(qp.A) if m else np.zeros((0, n))

    # snap x onto the active set: bounds exactly, active general constraints
    # by a minimum-norm correction on the free variables
    xh = np.where(b_sig < 0, xl, np.where(b_sig > 0, xu, xh))
    act_c0 = np.nonzero(c_sig != 0)[0]
    if act_c0.size:
        target = np.where(c_sig[act_c0] < 0, cl[act_c0], cu[act_c0])
        free = b_sig == 0
        r_act = target - A[act_c0] @ xh
        if free.any():
            corr, *_ = np.linalg.lstsq(A[np.ix_(act_c0, np.nonzero(free)[0])], r_act,
                                       rcond=None)
            xh[free] += corr
    # back inside the box; the crossover fails if the active constraints can
    # then no longer be met (cro.f90 keeps the iterates primal feasible)
    purify_failed = False
    out_lo = has_xl & (xh < xl - ctl.feas_tol * (1 + np.abs(xl)))
    out_hi = has_xu & (xh > xu + ctl.feas_tol * (1 + np.abs(xu)))
    if out_lo.any() or out_hi.any():
        xh = np.where(has_xl, np.maximum(xh, xl), xh)
        xh = np.where(has_xu, np.minimum(xh, xu), xh)
        if act_c0.size:
            resid = np.abs(target - A[act_c0] @ xh)
            if resid.max(initial=0.0) > ctl.feas_tol * (1 + np.abs(target).max(initial=0.0)):
                purify_failed = True

    xt = torch.as_tensor(xh, device=like["device"]).to(like["dtype"])
    Hx_g = _np(qp.Hx(xt) + qp.g)
    fixed = _np(masks.x_fixed) != 0

    dependent = 0
    status = int(Status.TINY_STEP) if purify_failed else int(Status.OK)
    for _ in range(ctl.max_sweeps):
        act_c = np.nonzero(c_sig != 0)[0]
        act_b = np.nonzero(b_sig != 0)[0]
        G_T = np.concatenate([A[act_c].T, np.eye(n)[:, act_b]], axis=1)   # (n, k)
        k = G_T.shape[1]
        if k == 0:
            y_new = np.zeros(m)
            z_new = np.zeros(n)
            break
        basic, _, rank = uls_find_basis(G_T, tol=1e-10)
        keep = np.zeros(k, bool)
        keep[basic] = True
        dependent += int(k - rank)
        w, *_ = np.linalg.lstsq(G_T[:, keep], Hx_g, rcond=None)
        full_w = np.zeros(k)
        full_w[keep] = w
        y_new = np.zeros(m)
        y_new[act_c] = full_w[:len(act_c)]
        z_new = np.zeros(n)
        z_new[act_b] = full_w[len(act_c):]
        # signs: lower-active wants a multiplier >= 0, upper-active <= 0
        bad = False
        for i in act_c:
            if eq[i]:
                continue
            if y_new[i] * (1 if c_sig[i] < 0 else -1) < -ctl.sign_tol:
                c_sig[i] = 0
                bad = True
        for j in act_b:
            if fixed[j]:
                continue
            if z_new[j] * (1 if b_sig[j] < 0 else -1) < -ctl.sign_tol:
                b_sig[j] = 0
                bad = True
        if not bad:
            break
    else:
        status = int(Status.MAX_ITERATIONS)

    out = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=like["device"]).to(
        like["dtype"])
    return CROInfo(x=out(xh), y=out(y_new), z=out(z_new),
                   c_stat=torch.as_tensor(c_sig.astype(np.int32), device=like["device"]),
                   b_stat=torch.as_tensor(b_sig.astype(np.int32), device=like["device"]),
                   status=status, dependent=dependent)
