"""Trust-region unconstrained / bound-constrained minimization (TRU, TRB).

Counterpart of galahad_tpu/nlp/tru.py (GALAHAD's TRU, reference
src/tru/tru.f90: TRU_solve :1102, main loop :2041-3649, TRS call :2845,
GLTR call :2935, ratio/radius update :2623-2650; TRB, src/trb/trb.f90:
TRB_solve :1120, projection :2261).

The objective is the user's torch function of one point (n,) -> 0-d;
gradients, Hessians and Hessian-vector products come from ``torch.func``.
``x0`` of shape (..., n) is a batch of problems: each steps under its own
masks and stops at its own convergence, as the JAX package's vmapped
``while_loop`` does, with the objective evaluated through ``vmap`` and the
exact subproblem one batched ``trs_solve`` (so one launch of the secular
kernel for the whole batch on the card).  The matrix-free models (GLTR on
Hessian-vector products or on a limited-memory secant Hessian) take one
problem and raise on a batch.  The loop is described in ``_loop.py``.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.config import control as control_dc
from ..tr.gltr import GLTRControl, gltr_solve
from ..tr.trs import TRSControl, trs_solve
from ._loop import (TRUState, Objective, batch_start, full, initial_state, run,  # noqa: F401
                    single_problem, status_of, stop_threshold, unbatch)


@control_dc
class TRUControl:
    """Mirrors TRU_control_type defaults where meaningful
    (reference src/tru/tru.f90:226-440)."""

    maxit: int = 100
    initial_radius: float = 1.0e2
    maximum_radius: float = 1.0e8
    stop_g_absolute: float = 1.0e-5
    stop_g_relative: float = 1.0e-8
    eta_successful: float = 1.0e-2
    eta_very_successful: float = 0.9
    eta_too_successful: float = 2.0
    radius_increase: float = 2.0
    radius_reduce: float = 0.5
    subproblem_direct: bool = True
    gltr_itmax: int = 64
    model: str = "newton"       # "newton" | "bfgs" | "sr1" (LMS Hessians)
    lms_memory: int = 10


def _radius_update(radius, ratio, norm_s, ctl: TRUControl):
    """Reference tru.f90:2623-2650: shrink on failure, expand when very (but
    not 'too') successful."""
    very = (ratio >= ctl.eta_very_successful) & (ratio <= ctl.eta_too_successful)
    fail = ratio < ctl.eta_successful
    r = torch.where(fail, ctl.radius_reduce * norm_s, radius)
    return torch.where(very, torch.clamp(torch.maximum(radius, ctl.radius_increase * norm_s),
                                         max=ctl.maximum_radius), r)


def _ratio(f, f_trial, pred):
    """(f - f_trial) / max(pred, tiny): actual over predicted decrease."""
    tiny = torch.finfo(f.dtype).tiny
    return (f - f_trial) / torch.clamp(pred, min=tiny)


def tru_solve(objective: Callable, x0, ctl: TRUControl = TRUControl(), device=None) -> TRUState:
    """Minimize a smooth objective from x0 (..., n): a batch of problems
    where x0 has leading dimensions (model "newton" with
    ``subproblem_direct``), else one problem.

    model="newton" uses exact second derivatives (``torch.func.hessian`` and
    the exact TRS, or Hessian-vector products and GLTR); "bfgs" / "sr1" use a
    limited-memory secant Hessian (qn/lms.py) with GLTR subproblems.
    Returns a TRUState (status, iter, f, norm_g, ...)."""
    X, bshape, _ = batch_start(x0, device)
    use_qn = ctl.model in ("bfgs", "sr1")
    direct = ctl.subproblem_direct and not use_qn
    if not direct:
        single_problem(bshape, "tru_solve with GLTR subproblems")
    obj = Objective(objective)
    trs_ctl = TRSControl()
    gltr_ctl = GLTRControl(itmax=ctl.gltr_itmax)

    f0, g0 = obj.value_and_grad(X)
    ng0 = torch.linalg.vector_norm(g0, dim=-1)
    stop_g = stop_threshold(ctl, ng0)
    st0 = initial_state(X, f0, g0, full(f0, ctl.initial_radius), ng0, stop_g)
    qn = None
    if use_qn:
        from ..qn.lms import LMSControl, lms_operator, lms_select, lms_setup, lms_update

        qn = lms_setup(X.shape[-1], LMSControl(memory=ctl.lms_memory, method=ctl.model),
                       dtype=X.dtype, device=X.device)

    def step(st: TRUState) -> TRUState:
        nonlocal qn
        reads = st.krylov_reads
        if direct:
            tr = trs_solve(obj.hessian(st.x), st.g, st.radius, ctl=trs_ctl)
            s, pred, norm_s = tr.x, -tr.obj, tr.norm_x
        else:
            op = lms_operator(qn) if use_qn else obj.hvp(st.x[0])
            tr = gltr_solve(op, st.g[0], st.radius[0], ctl=gltr_ctl)
            reads += tr.iter
            s, pred, norm_s = tr.x[None], -tr.obj[None], tr.norm_x[None]
        f_trial = obj.value(st.x + s)
        ratio = _ratio(st.f, f_trial, pred)
        success = ratio >= ctl.eta_successful
        x = torch.where(success[:, None], st.x + s, st.x)
        f = torch.where(success, f_trial, st.f)
        g_new = obj.grad(x)
        g = torch.where(success[:, None], g_new, st.g)
        if use_qn:
            active = ~st.converged[0] & (st.iter[0] < ctl.maxit)
            qn = lms_select(success[0] & active, lms_update(qn, s[0], g_new[0] - st.g[0]), qn)
        radius = _radius_update(st.radius, ratio, norm_s, ctl)
        ng = torch.linalg.vector_norm(g, dim=-1)
        conv = ng <= stop_g
        return TRUState(x=x, f=f, g=g, radius=radius, iter=st.iter, converged=conv,
                        status=status_of(conv), norm_g=ng, krylov_reads=reads)

    return unbatch(run(st0, step, ctl.maxit), bshape)


# ---------------------------------------------------------------------------
# TRB: bound-constrained trust region (reference src/trb/trb.f90)
# ---------------------------------------------------------------------------


@control_dc
class TRBControl(TRUControl):
    """TRB adds the Cauchy-search controls (reference trb.f90 controls)."""

    cauchy_backtracks: int = 20


def _project(x, x_l, x_u):
    """TRB_projection (reference src/trb/trb.f90:50, :2261)."""
    return torch.minimum(torch.maximum(x, x_l), x_u)


def _dot(a, b):
    return (a * b).sum(-1)


def trb_solve(objective: Callable, x0, x_l, x_u, ctl: TRBControl = TRBControl(),
              device=None) -> TRUState:
    """Bound-constrained TR minimization from x0 (..., n), bounds
    broadcastable to it: a batch of problems with the dense Hessian
    (model "newton"), one problem with ``model="hvp"``.

    Structure (reference trb.f90): at each iterate a generalized Cauchy point
    by backtracking along the projected-gradient arc of the quadratic model
    (the 20 points evaluated at once, the first minimum taken); the active
    set fixed there (eps_b = 1e-10); a masked exact TRS (or, for "hvp", a
    masked GLTR) over the free variables within the radius left; the
    combined step projected, and the Cauchy step kept where the subspace step
    raised the model; accept / reject on the true objective.  Convergence on
    the projected-gradient norm ||P(x - g) - x||."""
    X, bshape, (XL, XU) = batch_start(x0, device, x_l, x_u)
    matrix_free = ctl.model == "hvp"
    if matrix_free:
        single_problem(bshape, 'trb_solve with model="hvp"')
    obj = Objective(objective)
    trs_ctl = TRSControl()
    gltr_ctl = GLTRControl(itmax=ctl.gltr_itmax)
    dt = X.dtype
    X = _project(X, XL, XU)
    f0, g0 = obj.value_and_grad(X)

    def pg_norm(x, g):
        return torch.linalg.vector_norm(_project(x - g, XL, XU) - x, dim=-1)

    ng0 = pg_norm(X, g0)
    stop_g = stop_threshold(ctl, ng0)
    st0 = initial_state(X, f0, g0, full(f0, ctl.initial_radius), ng0, stop_g)
    betas = 0.5 ** torch.arange(ctl.cauchy_backtracks, dtype=dt, device=X.device)

    def step(st: TRUState) -> TRUState:
        reads = st.krylov_reads
        if matrix_free:
            hv = obj.hvp(st.x[0])
            hv_many = torch.func.vmap(hv)

            def Hop(v):                    # (B=1, n) or (1, K, n)
                return hv(v[0])[None] if v.dim() == 2 else hv_many(v[0])[None]
        else:
            H = obj.hessian(st.x)

            def Hop(v):
                if v.dim() == 2:
                    return (H @ v[..., None])[..., 0]
                return (H[:, None] @ v[..., None])[..., 0]

        def model_q(s):
            g = st.g if s.dim() == 2 else st.g[:, None]
            return _dot(g, s) + 0.5 * _dot(s, Hop(s))

        # Cauchy point: t = t0 * beta^k, k = 0..K-1; the largest model decrease
        # among the arc points within the radius (monotone, Armijo-free
        # variant of trb.f90's TRB_cauchy_get)
        t0 = st.radius / torch.clamp(torch.linalg.vector_norm(st.g, dim=-1), min=1e-30)
        T = t0[:, None] * betas                                          # (B, K)
        xs = st.x[:, None, :]
        # x - t g as one fused multiply-add, as XLA contracts it
        ss = _project(torch.addcmul(xs, T[..., None], st.g[:, None, :], value=-1.0),
                      XL[:, None], XU[:, None]) - xs
        ok = torch.linalg.vector_norm(ss, dim=-1) <= st.radius[:, None]
        ms = torch.where(ok, model_q(ss), torch.inf)
        k = torch.argmin(ms, dim=-1, keepdim=True)
        s_c = torch.take_along_dim(ss, k[..., None], dim=1)[:, 0]
        m_c = torch.clamp(torch.take_along_dim(ms, k, dim=1)[:, 0], max=0.0)

        # active set at the Cauchy point: fix the variables at their bounds,
        # solve over the free ones
        x_c = st.x + s_c
        eps_b = 1e-10
        free = ~((x_c <= XL + eps_b) | (x_c >= XU - eps_b))
        mask = free.to(dt)
        g_f = torch.where(free, st.g + Hop(s_c), 0.0)
        rad_left = torch.sqrt(torch.clamp(st.radius ** 2 - (s_c * s_c).sum(-1), min=0.0))
        if matrix_free:
            m0 = mask[0]

            def op(v):                     # the free subspace; identity on the fixed
                return m0 * hv(m0 * v) + (1.0 - m0) * v

            tr = gltr_solve(op, g_f[0], rad_left[0], ctl=gltr_ctl)
            reads += tr.iter
            x_sub = tr.x[None]
        else:
            H_ff = H * mask[:, :, None] * mask[:, None, :] + torch.diag_embed(
                torch.where(free, 0.0, 1.0).to(dt))
            x_sub = trs_solve(H_ff, g_f, rad_left, ctl=trs_ctl).x
        s_f = torch.where(free, x_sub, 0.0)
        s_trial = _project(st.x + s_c + s_f, XL, XU) - st.x
        m_trial = model_q(s_trial)
        # fall back to the Cauchy step if the subspace step hurt the model
        use_sub = m_trial <= m_c
        s = torch.where(use_sub[:, None], s_trial, s_c)
        m_s = torch.where(use_sub, m_trial, m_c)

        f_trial = obj.value(st.x + s)
        ratio = _ratio(st.f, f_trial, -m_s)
        success = (ratio >= ctl.eta_successful) & (m_s < 0)
        x = torch.where(success[:, None], st.x + s, st.x)
        f = torch.where(success, f_trial, st.f)
        g = torch.where(success[:, None], obj.grad(x), st.g)
        norm_s = torch.linalg.vector_norm(s, dim=-1)
        radius = _radius_update(st.radius, torch.where(m_s < 0, ratio, 0.0),
                                torch.clamp(norm_s, min=1e-30), ctl)
        ng = pg_norm(x, g)
        conv = ng <= stop_g
        return TRUState(x=x, f=f, g=g, radius=radius, iter=st.iter, converged=conv,
                        status=status_of(conv), norm_g=ng, krylov_reads=reads)

    return unbatch(run(st0, step, ctl.maxit), bshape)
