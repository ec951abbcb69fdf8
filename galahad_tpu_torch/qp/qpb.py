"""Nonconvex QP by an interior-point trust-region (Levenberg) method.

Counterpart of galahad_tpu/qp/qpb.py (GALAHAD's QPB, reference
src/qpb/qpb.f90: QPB_solve :1247).  The barrier Newton system

    [[H + D_bar + sigma I, A'], [A, 0]] [d; -y] = [-g_mu; -r_p]

is factorized by linalg/sbls.py, whose shifted Cholesky escalates the
shift until the (1,1) block is positive definite; a rejected step raises
sigma (the radius shrinks), acceptance is an Armijo test on the barrier
merit.  Slack form v = [x; c] with A x - c = 0.  The step is tensor code on
the device of ``qp``; the outer mu / sigma loop runs on the host and reads
each step's decisions (accepted, the residuals, mu) in ONE read, counted in
``QPBInfo.host_reads`` (the shifted Cholesky factorizations read their
success flag once each on top, two per step).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, check_qp, classify_bounds
from ..core.status import Status
from ..linalg.cholesky import chol_factor_shifted, chol_solve
from ..linalg.sbls import sbls_factorize, sbls_solve


@control_dc
class QPBControl:
    """QPB_control_type equivalent (reference src/qpb/qpb.f90)."""

    maxit: int = 200
    mu_init: float = -1.0         # <0: from initial complementarity
    mu_reduce: float = 0.2
    stop_p: float = 1.0e-6
    stop_d: float = 1.0e-6
    stop_c: float = 1.0e-6
    sigma_init: float = 0.0
    sigma_grow: float = 10.0
    sigma_shrink: float = 0.3
    prfeas: float = 1.0
    tau: float = 0.9995           # fraction to boundary
    armijo: float = 1.0e-4
    infinity: float = INFINITY


@dataclasses.dataclass
class QPBInfo:
    x: Any
    y: Any
    z: Any
    obj: Any
    status: int
    iter: int
    res_p: Any
    res_d: Any
    res_c: Any
    host_reads: int = 0


def qpb_solve(qp: QP, ctl: QPBControl = QPBControl()) -> QPBInfo:
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    n, m = qp.n, qp.m
    nv = n + m
    bad = check_qp(qp, ctl.infinity)
    if bad != 0:
        zn = torch.zeros(n, **like)
        inf_ = torch.full((), float("inf"), **like)
        return QPBInfo(x=zn, y=torch.zeros(m, **like), z=zn,
                       obj=torch.full((), float("nan"), **like), status=bad, iter=0,
                       res_p=inf_, res_d=inf_, res_c=inf_)
    masks = classify_bounds(qp, ctl.infinity)
    lo = torch.cat([qp.x_l, qp.c_l])
    hi = torch.cat([qp.x_u, qp.c_u])
    has_lo = torch.cat([masks.has_xl, masks.has_cl])
    has_hi = torch.cat([masks.has_xu, masks.has_cu])
    fixed = torch.cat([masks.x_fixed, masks.c_equality])
    ml = has_lo & ~fixed
    mh = has_hi & ~fixed

    H = qp.H_dense()
    E = torch.cat([qp.A, -torch.eye(m, **like)], dim=1)
    zero_m = torch.zeros(m, **like)

    def q_obj(v):
        x = v[:n]
        return 0.5 * x @ (H @ x) + qp.g @ x

    def q_grad(v):
        return torch.cat([H @ v[:n] + qp.g, zero_m])

    x0 = qp.x if qp.x is not None else torch.zeros(n, **like)
    v = torch.cat([x0, qp.Ax(x0)])
    gap = torch.where(has_lo & has_hi, hi - lo, float("inf"))
    xi = torch.clamp(0.4999 * gap, max=ctl.prfeas)
    v = torch.where(ml | fixed, torch.maximum(v, lo + torch.where(fixed, 0.0, xi)), v)
    v = torch.where(mh, torch.minimum(v, hi - xi), v)
    v = torch.where(fixed, lo, v)

    def dists(v):
        return torch.where(ml, v - lo, 1.0), torch.where(mh, hi - v, 1.0)

    def res_abs(v):
        return (E @ v).abs().sum() if m else 0.0

    def barrier_merit(v, mu, pen):
        s_l, s_u = dists(v)
        bar = -mu * (torch.where(ml, torch.log(torch.clamp(s_l, min=1e-300)), 0.0).sum()
                     + torch.where(mh, torch.log(torch.clamp(s_u, min=1e-300)), 0.0).sum())
        return q_obj(v) + bar + pen * res_abs(v)

    def step(v, mu, sigma, pen):
        s_l, s_u = dists(v)
        g_bar = -mu * (torch.where(ml, 1.0 / s_l, 0.0) - torch.where(mh, 1.0 / s_u, 0.0))
        d_bar = mu * (torch.where(ml, 1.0 / s_l ** 2, 0.0) + torch.where(mh, 1.0 / s_u ** 2, 0.0))
        g_mu = torch.where(fixed, 0.0, q_grad(v) + g_bar)
        Hv = torch.zeros((nv, nv), **like)
        Hv[:n, :n] = H
        B = Hv + torch.diag(d_bar + sigma + torch.where(fixed, 1.0 / 1e-12, 0.0))
        if m:
            r_p = E @ v
            f = sbls_factorize(B, E, zero_m, rho=0.0, delta=1e-10)
            d, w = sbls_solve(f, -g_mu, -r_p, apply_G=lambda u: B @ u, refine=1)
            y = -w
        else:
            L, _, _ = chol_factor_shifted(B, 0.0)
            d = chol_solve(L, -g_mu)
            y = zero_m
        d = torch.where(fixed, 0.0, d)
        # fraction to the boundary
        neg = ml & (d < 0)
        a1 = torch.where(neg, -ctl.tau * s_l / torch.where(neg, d, -1.0), float("inf")).min()
        pos = mh & (d > 0)
        a2 = torch.where(pos, ctl.tau * s_u / torch.where(pos, d, 1.0), float("inf")).min()
        alpha = torch.clamp(torch.minimum(a1, a2), max=1.0)
        phi0 = barrier_merit(v, mu, pen)
        slope = g_mu @ d - (pen * res_abs(v) if m else 0.0)
        # backtracking Armijo, eight trials, no host read
        accept = torch.zeros((), dtype=torch.bool, device=like["device"])
        vn = v
        for k in range(8):
            a = alpha * (0.5 ** k)
            good = ~accept & (barrier_merit(v + a * d, mu, pen) <= phi0 + ctl.armijo * a * slope)
            vn = torch.where(good, v + a * d, vn)
            accept = accept | good
        s_l2, s_u2 = dists(vn)
        z_l = torch.where(ml, mu / s_l2, 0.0)
        z_u = torch.where(mh, mu / s_u2, 0.0)
        g_new = q_grad(vn) - (E.T @ y if m else 0.0) - (z_l - z_u)
        res_d = torch.where(fixed, 0.0, g_new).abs().max()
        res_p = (E @ vn).abs().max() if m else torch.zeros((), **like)
        return vn, y, accept, res_d, res_p

    mu = torch.full((), 1.0 if ctl.mu_init <= 0 else ctl.mu_init, **like)
    sigma = ctl.sigma_init
    pen = 1.0e3
    y = zero_m
    status = int(Status.MAX_ITERATIONS)
    reads = 0
    it = 0
    for it in range(1, ctl.maxit + 1):
        v_new, y_new, accept, res_d, res_p = step(v, mu, sigma, pen)
        acc, rd, rp, mu_h = torch.stack([accept.to(like["dtype"]), res_d, res_p, mu]).tolist()
        reads += 1
        if acc:
            v, y = v_new, y_new
            sigma = max(sigma * ctl.sigma_shrink, 0.0)
            if rd <= max(10.0 * mu_h, ctl.stop_d):
                mu = mu * ctl.mu_reduce
                if mu.dtype == torch.float64:      # the same product on the host
                    mu_h = mu_h * ctl.mu_reduce
                else:
                    mu_h = float(mu)
                    reads += 1
        else:
            sigma = max(sigma * ctl.sigma_grow, 1e-8)
            if sigma > 1e12:
                # stalled: a successful exit if the accepted iterate already
                # meets the stopping tolerances at a small barrier parameter
                s_l0, s_u0 = dists(v)
                zf = torch.where(ml, mu / s_l0, 0.0) - torch.where(mh, mu / s_u0, 0.0)
                rr = q_grad(v) - (E.T @ y if m else 0.0) - zf
                rd_t = torch.where(fixed, 0.0, rr)[:n].abs().max()
                rp_t = (E @ v).abs().max() if m else torch.zeros((), **like)
                rd_t, rp_t = torch.stack([rd_t, rp_t]).tolist()
                reads += 1
                if mu_h < 1e-5 and rd_t < ctl.stop_d and rp_t < ctl.stop_p:
                    status = int(Status.OK)
                else:
                    status = int(Status.TINY_STEP)
                break
        if mu_h < 1e-10 and rd < ctl.stop_d and rp < ctl.stop_p:
            status = int(Status.OK)
            break

    x = v[:n]
    s_l, s_u = dists(v)
    z = (torch.where(ml, mu / s_l, 0.0) - torch.where(mh, mu / s_u, 0.0))[:n]
    r = qp.Hx(x) + qp.g - (qp.Aty(y) if m else 0.0)
    z = torch.where(masks.x_fixed, r, z)
    if m:
        ax = qp.Ax(x)
        res_p = (torch.clamp(ax - qp.c_u, min=0.0) + torch.clamp(qp.c_l - ax, min=0.0)).max()
    else:
        res_p = torch.zeros((), **like)
    res_d = torch.where(masks.x_fixed, 0.0, r - z).abs().max()
    return QPBInfo(x=x, y=y, z=z, obj=q_obj(v) + qp.f, status=status, iter=it,
                   res_p=res_p, res_d=res_d, res_c=mu, host_reads=reads)
