"""Adaptive cubic regularization (ARC) for unconstrained minimization.

Counterpart of galahad_tpu/nlp/arc.py (GALAHAD's ARC, reference
src/arc/arc.f90: ARC_solve :1111; subproblems by RQS direct or GLRT
iterative; the weight update of the main loop).  Built as nlp/tru.py: a
batch of problems through the batched eigen-secular ``rqs_solve`` (one
launch of the RQS secular kernel for the batch on the card), or one
problem through GLRT on Hessian-vector products.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.config import control as control_dc
from ..tr.gltr import GLRTControl, glrt_solve
from ..tr.trs import rqs_solve
from ._loop import (TRUState, Objective, batch_start, full, initial_state, run,
                    single_problem, status_of, stop_threshold, unbatch)
from .tru import _ratio


@control_dc
class ARCControl:
    """Mirrors ARC_control_type defaults where meaningful
    (reference src/arc/arc.f90 controls)."""

    maxit: int = 100
    initial_weight: float = 1.0       # sigma_0 (regularization weight)
    minimum_weight: float = 1.0e-16
    stop_g_absolute: float = 1.0e-5
    stop_g_relative: float = 1.0e-8
    eta_successful: float = 1.0e-2
    eta_very_successful: float = 0.9
    weight_decrease: float = 0.5      # gamma on very successful
    weight_increase: float = 2.0      # gamma on failure
    power: float = 3.0                # p in (sigma/p)||s||^p
    subproblem_direct: bool = True
    glrt_itmax: int = 64


def weight_update(sigma, success, very, ctl):
    """The basic weight update (reference arc.f90): decrease on a very
    successful step (not below ``minimum_weight``), keep on a successful
    one, increase on failure."""
    return torch.where(very, torch.clamp(ctl.weight_decrease * sigma, min=ctl.minimum_weight),
                       torch.where(success, sigma, ctl.weight_increase * sigma))


def arc_solve(objective: Callable, x0, ctl: ARCControl = ARCControl(), device=None) -> TRUState:
    """Minimize a smooth objective by adaptive cubic regularization from x0
    (..., n): a batch of problems with ``subproblem_direct`` (RQS), one
    problem with GLRT.  Returns a TRUState whose ``radius`` carries sigma."""
    X, bshape, _ = batch_start(x0, device)
    if not ctl.subproblem_direct:
        single_problem(bshape, "arc_solve with GLRT subproblems")
    obj = Objective(objective)
    p = ctl.power
    glrt_ctl = GLRTControl(itmax=ctl.glrt_itmax)

    f0, g0 = obj.value_and_grad(X)
    ng0 = torch.linalg.vector_norm(g0, dim=-1)
    stop_g = stop_threshold(ctl, ng0)
    st0 = initial_state(X, f0, g0, full(f0, ctl.initial_weight), ng0, stop_g)

    def step(st: TRUState) -> TRUState:
        reads = st.krylov_reads
        sigma = st.radius
        if ctl.subproblem_direct:
            sub = rqs_solve(obj.hessian(st.x), st.g, sigma, p=p)
            s, sub_obj, norm_s = sub.x, sub.obj, sub.norm_x
        else:
            sub = glrt_solve(obj.hvp(st.x[0]), st.g[0], sigma[0], p=p, ctl=glrt_ctl)
            reads += sub.iter
            s, sub_obj, norm_s = sub.x[None], sub.obj[None], sub.norm_x[None]
        f_trial = obj.value(st.x + s)
        # the predicted decrease uses the model without the regularizer
        # (reference arc.f90's ratio)
        pred = -(sub_obj - (sigma / p) * norm_s ** p)
        ratio = _ratio(st.f, f_trial, pred)
        success = ratio >= ctl.eta_successful
        very = ratio >= ctl.eta_very_successful
        x = torch.where(success[:, None], st.x + s, st.x)
        f = torch.where(success, f_trial, st.f)
        g = torch.where(success[:, None], obj.grad(x), st.g)
        ng = torch.linalg.vector_norm(g, dim=-1)
        conv = ng <= stop_g
        return TRUState(x=x, f=f, g=g, radius=weight_update(sigma, success, very, ctl),
                        iter=st.iter, converged=conv, status=status_of(conv), norm_g=ng,
                        krylov_reads=reads)

    return unbatch(run(st0, step, ctl.maxit), bshape)
