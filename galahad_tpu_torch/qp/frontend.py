"""Generic QP front end, LSQP, WCP and L1QP.

Counterpart of galahad_tpu/qp/frontend.py:
  * QP  (reference src/qp/qp.f90: QP_solve dispatch :1220-1340 on
    control%quadratic_programming_solver, with scaling and presolve)
    -> :func:`qp_solve`;
  * LSQP (src/lsqp/lsqp.f90: LSQP_solve :1031) -> :func:`lsqp_solve`;
  * WCP (src/wcp/wcp.f90: WCP_solve :935) -> :func:`wcp_solve`;
  * L1QP (src/l1qp/l1qp.f90 with the src/lpqp reformulation)
    -> :func:`l1qp_solve`.

Solvers of ``qp_solve``: ``cqp`` (the IPM, with the DQP rescue), ``dqp``,
``ccqp``, ``qpa`` (active set), ``qpb`` (interior-point trust region),
``qpc`` (IPM then active set), ``lpa`` (simplex) and ``lpb``; with
``crossover=True`` CRO purifies the answer.

Two departures from the JAX package, both in how results are reported:
the fourth value of ``qp_solve`` is a :class:`QPInfo` on every branch (the
JAX package returns the IPM's state or a ``DQPInfo``), and the rescue is
tried only where ``dqp_solve`` takes the problem (a dense ``QP`` with a
Hessian), with no ``except`` around it: an error inside DQP propagates.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, require_dense
from ..pre import (PresolveControl, ScaleControl, presolve_apply, presolve_reduce,
                   presolve_restore, scale_apply, scale_get, scale_recover)
from .cro import cro_crossover
from .dqp import DQPControl, ccqp_solve, dqp_solve
from .ipm import IPMControl, ipm_solve
from .lpa import lpa_solve
from .qpa import qpa_solve, qpc_solve
from .qpb import qpb_solve
from .wrappers import lpb_solve

SOLVERS = ("cqp", "dqp", "ccqp", "qpa", "qpb", "qpc", "lpa", "lpb")
STALLED = (-13, -18)      # TINY_STEP, MAX_ITERATIONS: the IPM states the rescue takes


@control_dc
class QPControl:
    """QP_control_type equivalent (reference src/qp/qp.f90)."""

    quadratic_programming_solver: str = "cqp"   # one of SOLVERS
    scale: int = 0                              # 0 off; > 0 -> sinkhorn
    presolve_problem: bool = False              # mask presolve (shape-kept)
    presolve_reduce: bool = False               # eliminating presolve with
                                                # exact (x, y, z) restore
    crossover: bool = False                     # CRO after the IPM solve
                                                # (reference cqp.f90:2785-2813)
    crossover_on_stall: bool = True             # DQP rescue on IPM -13 / -18
                                                # (the QPC cqp -> qpa role)
    generate_qplib_file: str = ""               # write the problem before
                                                # solving (cqp.f90:376-395)
    infinity: float = INFINITY
    ipm: IPMControl = IPMControl()
    dqp: DQPControl = DQPControl()


@dataclasses.dataclass
class QPInfo:
    """What ``qp_solve`` reports, the same on every branch: ``status``,
    ``iter`` and ``obj`` of the solver that produced x (``solver``: "cqp" or
    "lpb" where the IPM answered, "dqp" for the dqp and ccqp branches and
    after a rescue, else the branch's own name: "qpa", "qpb", "qpc",
    "lpa").  ``inform`` is the IPM's ``IPMInform`` where the IPM answered,
    else None; ``ipm`` the IPM's state wherever it ran on the ``cqp`` /
    ``lpb`` branches (also when DQP rescued it); ``dqp`` the ``DQPInfo``
    where DQP answered; ``result`` the ``QPAInfo`` / ``QPBInfo`` /
    ``LPAInfo`` of the other branches; ``cro`` the ``CROInfo`` where the
    crossover ran (x, y and z are then its)."""

    status: int
    iter: int
    obj: float
    solver: str
    inform: Any = None
    ipm: Any = None
    dqp: Any = None
    result: Any = None
    cro: Any = None


def _from_ipm(solver, st) -> QPInfo:
    return QPInfo(status=int(st.status), iter=int(st.iter), obj=float(st.inform.obj),
                  solver=solver, inform=st.inform, ipm=st)


def _from_dqp(d, st=None) -> QPInfo:
    return QPInfo(status=d.status, iter=d.iter, obj=d.obj, solver="dqp", ipm=st, dqp=d)


def qp_solve(qp, ctl: QPControl = QPControl()):
    """Generic entry: optional scaling and presolve, then the solver named by
    ``ctl.quadratic_programming_solver`` (reference qp.f90:1220-1340).  Takes
    a dense ``QP``, or on the ``cqp`` branch without scaling or presolve a
    ``SparseQP`` or ``BandedQP`` too.  Runs on the device that holds ``qp``.
    Returns (x, y, z, info) in the original problem's variables, ``info`` a
    :class:`QPInfo`."""
    name = ctl.quadratic_programming_solver
    if name not in SOLVERS:
        raise ValueError(f"unknown QP solver {name!r}")
    if name in ("qpa", "qpb", "qpc", "lpa") or ctl.crossover:
        require_dense(qp, f"qp_solve with {name!r}" + (" and crossover" if ctl.crossover else ""))
    if ctl.generate_qplib_file:
        from ..io.qplib import write_qp

        write_qp(ctl.generate_qplib_file, qp)
    work = qp
    scaling = reduction = None
    if ctl.scale:
        scaling = scale_get(work, ScaleControl(method="sinkhorn"))
        work = scale_apply(work, scaling, ctl.infinity)
    if ctl.presolve_reduce:
        work, reduction = presolve_reduce(work, PresolveControl(infinity=ctl.infinity))
    elif ctl.presolve_problem:
        work = presolve_apply(work, PresolveControl(infinity=ctl.infinity)).qp

    if name == "cqp":
        x, y, z, st = ipm_solve(work, ctl.ipm)
        info = _from_ipm(name, st)
        # Degenerate-endgame rescue: where the IPM stalls on a degenerate
        # vertex (-13) or runs out of iterations with floored residuals
        # (-18), the dual projected-gradient solve does not need strict
        # complementarity (the reference's QPC cqp -> qpa crossover role,
        # src/qpc/qpc.f90).  DQP needs a dense QP with a Hessian; its
        # result is kept only if it converged.
        if (ctl.crossover_on_stall and info.status in STALLED
                and isinstance(work, QP) and work.h_kind != "zero"):
            d = dqp_solve(work, ctl=ctl.dqp)
            if d.status == 0:
                x, y, z, info = d.x, d.y, d.z, _from_dqp(d, st)
    elif name == "dqp":
        d = dqp_solve(work, ctl=ctl.dqp)
        x, y, z, info = d.x, d.y, d.z, _from_dqp(d)
    elif name == "ccqp":
        d = ccqp_solve(work, ipm_ctl=ctl.ipm, dqp_ctl=ctl.dqp)
        x, y, z, info = d.x, d.y, d.z, _from_dqp(d)
    elif name in ("qpa", "qpb", "qpc", "lpa"):
        if name == "qpa":
            d = qpa_solve(work)
        elif name == "qpb":
            d = qpb_solve(work)
        elif name == "qpc":
            d = qpc_solve(work, ipm_ctl=ctl.ipm)
        else:
            d = lpa_solve(work)
        x, y, z = d.x, d.y, d.z
        info = QPInfo(status=int(d.status), iter=int(d.iter), obj=float(d.obj), solver=name,
                      result=d)
    else:   # lpb
        x, y, z, st = lpb_solve(work, ctl.ipm)
        info = _from_ipm(name, st)

    if ctl.crossover:
        info.cro = cro_crossover(work, x, y, z)
        x, y, z = info.cro.x, info.cro.y, info.cro.z

    if reduction is not None:
        like = dict(dtype=qp.g.dtype, device=qp.g.device)
        x, y, z = (torch.as_tensor(v).to(**like)
                   for v in presolve_restore(reduction, x, y, z))
    if scaling is not None:
        x, y, z = scale_recover(scaling, x, y, z)
    return x, y, z, info


def lsqp_solve(qp: QP, ctl: IPMControl = IPMControl()):
    """LP / separable-QP IPM (LSQP equivalent).  Requires h_kind in {zero,
    diagonal, identity, scaled_identity}: the IPM's diagonal-H path."""
    if qp.h_kind not in ("zero", "diagonal", "identity", "scaled_identity"):
        raise ValueError("lsqp requires a separable (diagonal) Hessian")
    return ipm_solve(qp, ctl)


@control_dc
class WCPControl:
    maxit: int = 100
    mu_target: float = 1.0       # target complementarity at the centre
    gamma_c: float = 0.1         # centrality band [gamma mu, mu / gamma]
                                 # (WCP's gamma_c0, wcp.f90 controls)
    stop_p: float = 1.0e-8
    stop_d: float = 1.0e-6
    infinity: float = INFINITY


def wcp_solve(qp: QP, ctl: WCPControl = WCPControl()):
    """A well-centred strictly interior point of the polytope
    {x : c_l <= Ax <= c_u, x_l <= x <= x_u} (WCP equivalent, reference
    src/wcp/wcp.f90:935).

    Runs the primal-dual IPM on the zero objective with the barrier target
    held at mu_target; convergence requires primal and dual feasibility and
    every active complementarity pair inside [gamma_c mu_target, mu_target /
    gamma_c].  Returns (x, y, z, state); state.converged means centred."""
    work = dataclasses.replace(qp, H=None, h_kind="zero", g=torch.zeros_like(qp.g))
    ictl = IPMControl(maxit=ctl.maxit, stop_abs_p=ctl.stop_p, stop_abs_d=ctl.stop_d,
                      mu_target=ctl.mu_target, gamma_c=ctl.gamma_c, mu_min_factor=1.0,
                      infinity=ctl.infinity)
    return ipm_solve(work, ictl)


@control_dc
class L1QPControl:
    rho: float = 100.0           # l1 penalty weight
    ipm: IPMControl = IPMControl()
    infinity: float = INFINITY


def l1qp_solve(qp: QP, ctl: L1QPControl = L1QPControl()):
    """l1-penalty QP (L1QP / LPQP equivalent):

        min 1/2 x'Hx + g'x + rho (||(c_l - Ax)_+||_1 + ||(Ax - c_u)_+||_1)

    reformulated with elastic slacks s >= 0 (one per side) into a QP over
    [x; s_l; s_u]:  A x + s_l - s_u in [c_l, c_u], objective + rho 1's (the
    LPQP transformation, src/lpqp/lpqp.f90), then solved by the IPM."""
    n, m = qp.n, qp.m
    if m == 0:
        return ipm_solve(qp, ctl.ipm)
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    H_ext = torch.zeros((n + 2 * m, n + 2 * m), **like)
    H_ext[:n, :n] = qp.H_dense()
    eye = torch.eye(m, **like)
    ext = QP(
        H=H_ext, g=torch.cat([qp.g, torch.full((2 * m,), ctl.rho, **like)]),
        A=torch.cat([qp.A, eye, -eye], dim=1), c_l=qp.c_l, c_u=qp.c_u,
        x_l=torch.cat([qp.x_l, torch.zeros(2 * m, **like)]),
        x_u=torch.cat([qp.x_u, torch.full((2 * m,), 2 * ctl.infinity, **like)]),
    )
    x_ext, y, z_ext, st = ipm_solve(ext, ctl.ipm)
    return x_ext[:n], y, z_ext[:n], st
