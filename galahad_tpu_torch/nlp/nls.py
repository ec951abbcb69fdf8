"""Nonlinear least squares by adaptive regularization (NLS).

Counterpart of galahad_tpu/nlp/nls.py (GALAHAD's NLS, reference
src/nls/nls.f90: NLS_solve :1287; the 8 model variants :115-123;
regularization norms :125-137; weight-update strategies :144-148;
Gauss-Newton-to-Newton switch :3118)::

    min_x  1/2 ||r(x)||^2     for a torch residual r: R^n -> R^m

Model menu (reference codes in parentheses): "first_order" (1, H = 0),
"diagonal" (2, H = I), "gauss_newton" (3, H = J'J), "newton" (4, H = J'J +
sum_i r_i Hess r_i), "gauss_to_newton" (5: Gauss-Newton until ||g|| <
switch_to_newton, then Newton), and the tensor models
"tensor_gauss_newton" (6), "tensor_newton" (7), "tensor_gauss_to_newton"
(8): the step approximately minimizes the regularized tensor model
1/2 ||r + J s + 1/2 D^2r(x)[s,s]||^2 + (sigma/p)||s||^p by a fixed number of
inner Gauss-Newton (6, 8) or Newton (7) steps.  Regularization norms
"euclidean" (-1), "diagonal_jtj" (1), "diagonal_hessian" (2), "band" (3),
passed as the M matrix of ``rqs_solve``; weight updates "basic" (1),
"zero_reset" (2), "imitate_tr" (3), "increase" (4).

:func:`nls_solve` takes one problem (x0 of shape (n,)); its loop is that of
nlp/_loop.py (decisions as 0-d tensors, model 8's armed Newton switch too).
:func:`nls_solve_sparse` is the sparse Gauss-Newton over BSC and the flat
LDL^T, a host loop as in the JAX package.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import hessian, jacfwd, jvp

from ..core.config import control as control_dc
from ..core.segsum import SegmentSum
from ..core.sparse import COOPattern
from ..core.status import Status
from ..tr.trs import rqs_solve
from ._loop import (TRUState, batch_start, full, initial_state, outer_loop, single_problem,
                    status_of, stop_threshold)

_TENSOR_MODELS = ("tensor_gauss_newton", "tensor_newton", "tensor_gauss_to_newton")


@control_dc
class NLSControl:
    """Mirrors NLS_control_type defaults where meaningful
    (reference src/nls/nls.f90 controls; model :213-217)."""

    maxit: int = 100
    initial_weight: float = 1.0
    minimum_weight: float = 1.0e-16
    weight_zero: float = 1.0e-14       # zero-reset target (~epsmch)
    stop_g_absolute: float = 1.0e-6
    stop_g_relative: float = 1.0e-8
    stop_c_absolute: float = 1.0e-12   # stop when 1/2 ||r||^2 below this
    eta_successful: float = 1.0e-2
    eta_very_successful: float = 0.9
    weight_decrease: float = 0.5
    weight_increase: float = 2.0
    power: float = 3.0
    model: str = "gauss_newton"
    # "first_order" | "diagonal" | "gauss_newton" | "newton" |
    # "gauss_to_newton" | "tensor_gauss_newton" | "tensor_newton" |
    # "tensor_gauss_to_newton"
    norm: str = "euclidean"
    # "euclidean" | "diagonal_jtj" | "diagonal_hessian" | "band"
    semi_bandwidth: int = 5            # for norm="band"
    min_diagonal: float = 1.0e-5       # PSLS_control%min_diagonal analogue
    switch_to_newton: float = 0.1      # nls.f90:320
    weight_update: str = "basic"
    # "basic" | "zero_reset" | "imitate_tr" | "increase"
    inner_its: int = 4                 # tensor-model inner iterations


def _reg_norm(ctl: NLSControl, J, Hfull):
    """The S matrix of the regularization norm (None = identity)."""
    if ctl.norm == "euclidean":
        return None
    if ctl.norm == "diagonal_jtj":
        return torch.diag(torch.clamp((J * J).sum(0), min=ctl.min_diagonal))
    if ctl.norm == "diagonal_hessian":
        return torch.diag(torch.clamp(torch.diagonal(Hfull), min=ctl.min_diagonal))
    if ctl.norm == "band":
        n = Hfull.shape[0]
        i = torch.arange(n, device=Hfull.device)
        band = (i[:, None] - i[None, :]).abs() <= ctl.semi_bandwidth
        S = torch.where(band, Hfull, 0.0)
        # definite safeguard: shift by the most negative Gershgorin bound
        off = S.abs().sum(1) - torch.diagonal(S).abs()
        shift = torch.clamp((off - torch.diagonal(S)).max(), min=0.0) + ctl.min_diagonal
        return S + shift * torch.eye(n, dtype=S.dtype, device=S.device)
    raise ValueError(f"unknown regularization norm '{ctl.norm}'")


def _second_order_term(residual, x, s):
    """D^2 r(x)[s, s] by one jvp tower."""
    return jvp(lambda xx: jvp(residual, (xx,), (s,))[1], (x,), (s,))[1]


def _tensor_step(residual, x, r, J, sigma, p, ctl: NLSControl, newton):
    """Approximate minimizer of the regularized tensor model by a
    fixed-length inner Gauss-Newton / Newton loop (reference models 6-8).
    ``newton`` is False, True or a 0-d bool tensor (model 8's switch)."""

    def T(s):
        return r + J @ s + 0.5 * _second_order_term(residual, x, s)

    def phi(s):
        t = T(s)
        return 0.5 * (t * t).sum() + (sigma / p) * torch.linalg.vector_norm(s) ** p

    s = torch.zeros_like(x)
    best = phi(s)
    for _ in range(ctl.inner_its):
        t = T(s)
        JT = jacfwd(T)(s)                  # J + D^2 r[s, .]
        g_in = JT.T @ t
        H_in = JT.T @ JT
        if newton is not False:
            # the s-Hessian of 1/2||T||^2 is JT'JT + sum_i T_i D^2 r_i, D^2 r_i
            # the x-Hessian of r_i (T is quadratic in s)
            Hw = hessian(lambda xx: t @ residual(xx))(x)
            H_in = H_in + torch.as_tensor(newton).to(device=x.device, dtype=H_in.dtype) * Hw
        sub = rqs_solve(H_in, g_in, sigma, p=p)
        s_try = s + sub.x
        phi_try = phi(s_try)
        better = phi_try < best
        s = torch.where(better, s_try, s)
        best = torch.minimum(phi_try, best)
    return s


def _weight(ctl: NLSControl, sigma, success, very, norm_s):
    """The four weight-update strategies (reference nls.f90:144-148)."""
    up = torch.where(success, sigma, ctl.weight_increase * sigma)
    if ctl.weight_update == "zero_reset":
        return torch.where(very, torch.full_like(sigma, ctl.weight_zero), up)
    if ctl.weight_update == "imitate_tr":
        # TR-style: grow the implied radius ~ ||s|| on very successful steps
        return torch.where(very, torch.clamp(
            torch.minimum(ctl.weight_decrease * sigma, sigma / torch.clamp(norm_s, min=1.0)),
            min=ctl.minimum_weight), up)
    if ctl.weight_update == "increase":
        return up
    return torch.where(very, torch.clamp(ctl.weight_decrease * sigma, min=ctl.minimum_weight), up)


def nls_solve(residual: Callable, x0, ctl: NLSControl = NLSControl(), device=None) -> TRUState:
    """Minimize 1/2||r(x)||^2 for one problem (x0 of shape (n,); a batch
    raises).  Returns a TRUState (f = 1/2||r||^2, g = J'r, radius = the
    current weight sigma)."""
    X, bshape, _ = batch_start(x0, device)
    single_problem(bshape, "nls_solve")
    p = ctl.power

    def obj(x):
        rr = residual(x)
        return 0.5 * (rr * rr).sum()

    full_hess = hessian(obj)
    jac = jacfwd(residual)
    x0 = X[0]
    r0 = residual(x0)
    J0 = jac(x0)
    g0 = J0.T @ r0
    ng0 = torch.linalg.vector_norm(g0)
    stop_g = stop_threshold(ctl, ng0)
    f0 = 0.5 * (r0 * r0).sum()
    st = initial_state(x0, f0, g0, full(f0, ctl.initial_weight), ng0, stop_g)
    # newton_on: on for the pure Newton models; armed later by the switch
    newton_on = torch.full((), ctl.model in ("newton", "tensor_newton"), dtype=torch.bool,
                           device=x0.device)
    r, J = r0, J0

    def step(st, r, J, newton_on):
        sigma = st.radius
        g = st.g
        if ctl.model in _TENSOR_MODELS:
            use_newton = {"tensor_newton": True, "tensor_gauss_to_newton": newton_on}.get(
                ctl.model, False)
            s = _tensor_step(residual, st.x, r, J, sigma, p, ctl, newton=use_newton)
            # the model value of the ratio test: the tensor model itself
            t = r + J @ s + 0.5 * _second_order_term(residual, st.x, s)
            pred = st.f - 0.5 * (t * t).sum()
            norm_s = torch.linalg.vector_norm(s)
        else:
            gn = J.T @ J
            if ctl.model == "first_order":
                H = torch.zeros_like(gn)
            elif ctl.model == "diagonal":
                H = torch.eye(st.x.shape[0], dtype=gn.dtype, device=gn.device)
            elif ctl.model == "newton":
                H = full_hess(st.x)
            elif ctl.model == "gauss_to_newton":
                H = torch.where(newton_on, full_hess(st.x), gn)
            else:                          # gauss_newton
                H = gn
            sub = rqs_solve(H, g, sigma, p=p, M=_reg_norm(ctl, J, H))
            s = sub.x
            pred = -(sub.obj - (sigma / p) * sub.norm_x ** p)
            norm_s = sub.norm_x

        r_t = residual(st.x + s)
        f_trial = 0.5 * (r_t * r_t).sum()
        tiny = torch.finfo(f_trial.dtype).tiny
        ratio = (st.f - f_trial) / torch.clamp(pred, min=tiny)
        success = ratio >= ctl.eta_successful
        very = ratio >= ctl.eta_very_successful
        x = torch.where(success, st.x + s, st.x)
        f = torch.where(success, f_trial, st.f)
        # r and J at the accepted point (the JAX package evaluates them at x)
        r_new = torch.where(success, r_t, r)
        J_new = torch.where(success, jac(st.x + s), J)
        g_new = J_new.T @ r_new
        sigma = _weight(ctl, sigma, success, very, norm_s)
        ng = torch.linalg.vector_norm(g_new)
        if ctl.model in ("gauss_to_newton", "tensor_gauss_to_newton"):
            newton_on = newton_on | (ng < ctl.switch_to_newton)
        conv = (ng <= stop_g) | (f <= ctl.stop_c_absolute)
        new = TRUState(x=x, f=f, g=g_new, radius=sigma, iter=st.iter, converged=conv,
                       status=status_of(conv), norm_g=ng)
        return new, r_new, J_new, newton_on

    def masked_step(carry, active):
        st, r, J, newton_on = carry
        new, r_n, J_n, on_n = step(st, r, J, newton_on)
        st = TRUState(**{f: torch.where(active, getattr(new, f), getattr(st, f))
                         for f in ("x", "f", "g", "radius", "converged", "status", "norm_g")},
                      iter=st.iter + active.to(torch.int32))
        return (st, torch.where(active, r_n, r), torch.where(active, J_n, J),
                torch.where(active, on_n, newton_on))

    (st, *_), reads = outer_loop((st, r, J, newton_on), masked_step,
                                 lambda c: ~c[0].converged & (c[0].iter < ctl.maxit), ctl.maxit)
    st.host_reads = reads
    return st


def nls_solve_sparse(residual: Callable, jac_vals: Callable, j_pat, x0,
                     ctl: NLSControl = NLSControl(), device=None) -> TRUState:
    """Sparse Gauss-Newton NLS for one problem: minimize 1/2||r(x)||^2 with a
    sparse Jacobian given as (pattern, value callback), the reference's
    eval_J contract (src/nls/nls.f90 J%row / J%col / J%val).  Nothing is
    densified: J'J is assembled on its analysed pattern (linalg/bsc.py,
    BSC_form, reference src/bsc/bsc.f90:372), and (J'J + sigma I) s = -g is
    factored by the flat supernodal LDL^T (analysed once; numeric per
    iteration, with the hand kernels on the card).  A host loop, as in the
    JAX package: it reads ||g|| and the ratio once per iteration (counted
    in ``host_reads``).

    ``jac_vals(x)`` -> (nnz,) Jacobian values aligned with ``j_pat`` (COO,
    m x n).  The gradient J'r is a fixed-order segment sum.  Returns a
    TRUState (f = 1/2||r||^2, g = J'r, radius = sigma)."""
    from ..linalg.bsc import bsc_analyse, bsc_form_sparse
    from ..linalg.supernodal_flat import flat_analyse, flat_factorize, flat_solve

    X, bshape, _ = batch_start(x0, device)
    single_problem(bshape, "nls_solve_sparse")
    x = X[0]
    dt, dev = x.dtype, x.device
    n = x.shape[0]
    jr = torch.as_tensor(np.asarray(j_pat.rows, np.int64), device=dev)
    grad_sum = SegmentSum(np.asarray(j_pat.cols, np.int64), n, dense=True)
    # J'J = (J') D (J')' with A := J' (n x m): the transposed pattern
    bplan = bsc_analyse(COOPattern(j_pat.cols, j_pat.rows, j_pat.n, j_pat.m))
    sp = bplan.s_pat
    # aggressive amalgamation: Gauss-Newton patterns are often long and thin;
    # bigger supernodes keep the level count down
    splan = flat_analyse(np.asarray(sp.rows), np.asarray(sp.cols), n, order="amd",
                         relax_cols=32)

    def eval_all(x):
        r = residual(x)
        jv = jac_vals(x).to(dt)
        g = grad_sum(jv * r.index_select(0, jr))
        return r, jv, g, 0.5 * (r * r).sum()

    r, jv, g, f = eval_all(x)
    reads = 1
    ng0 = float(torch.linalg.vector_norm(g))
    stop_g = max(ctl.stop_g_absolute, ctl.stop_g_relative * ng0)
    sigma = float(ctl.initial_weight)
    status = int(Status.MAX_ITERATIONS)
    it = 0
    for it in range(1, ctl.maxit + 1):
        reads += 1
        if float(torch.linalg.vector_norm(g)) <= stop_g:
            status = int(Status.OK)
            break
        fac = flat_factorize(splan, bsc_form_sparse(bplan, jv), shift=sigma)
        s = flat_solve(splan, fac, -g)
        xt = x + s
        rt, jvt, gt, ft = eval_all(xt)
        pred = -(torch.dot(g, s) + 0.5 * torch.dot(s, -g - sigma * s))
        reads += 1
        rho = float((f - ft) / torch.clamp(pred, min=1e-30))
        if rho >= ctl.eta_successful:
            x, r, jv, g, f = xt, rt, jvt, gt, ft
            if rho >= ctl.eta_very_successful:
                sigma = max(sigma * ctl.weight_decrease, 1e-12)
        else:
            sigma = sigma * ctl.weight_increase
    return TRUState(x=x, f=f, g=g, radius=torch.full((), sigma, dtype=dt, device=dev),
                    iter=torch.full((), it, dtype=torch.int32, device=dev),
                    converged=torch.full((), status == int(Status.OK), device=dev),
                    status=torch.full((), status, dtype=torch.int32, device=dev),
                    norm_g=torch.linalg.vector_norm(g), host_reads=reads)
