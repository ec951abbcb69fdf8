"""Quadratically-constrained QP (QCQP).

Counterpart of galahad_tpu/qp/qcqp.py.  The reference's RPD reader accepts
the QCQP problem classes (reference src/rpd/rpd.f90:20-45: 'Q' in the
constraint class) and GALAHAD solves them through its general NLP packages
(LANCELOT, src/lancelot/lancelot.f90:499); here, as in the JAX package, the
QCQP has its own container and solver:

    min  1/2 x'Hx + g'x + f
    s.t. c_l <= A x + 1/2 <x, Q_i x> <= c_u,   x_l <= x <= x_u

  * ``method="al"`` (default): LANCELOT's augmented-Lagrangian outer loop
    (nlp/lancelot.py) with TRB inner solves; the constraint values come
    from one einsum over the stacked (m, n, n) ``Qc``;
  * ``method="filter"``: FILTRANE (nlp/filtrane.py) first drives the
    violation into the feasible region, then "al" polishes.

The bound duals are grad f - J'y at the solution, by ``torch.func.grad`` and
``torch.func.vjp``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.func import grad, vjp

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, classify_bounds
from ..nlp.filtrane import FiltraneControl, filtrane_solve
from ..nlp.lancelot import LancelotControl, clip, lancelot_solve


@control_dc
class QCQPControl:
    method: str = "al"            # "al" | "filter"
    maxit: int = 30               # outer AL iterations
    stop_c: float = 1.0e-7
    stop_g: float = 1.0e-7
    inner_maxit: int = 300
    infinity: float = INFINITY


@dataclasses.dataclass
class QCQP:
    """A QP plus stacked constraint Hessians ``Qc`` (m, n, n): the RPD H_c
    triples assembled dense, tensors on one device (``io.qplib.read_qcqp`` /
    ``QPLIBProblem.to_qcqp``, ``convert.qcqp_from_numpy``)."""

    g: torch.Tensor
    A: torch.Tensor
    Qc: torch.Tensor              # (m, n, n) symmetric constraint Hessians
    c_l: torch.Tensor
    c_u: torch.Tensor
    x_l: torch.Tensor
    x_u: torch.Tensor
    H: Any = None
    f: Any = 0.0
    x: Any = None
    y: Any = None
    z: Any = None
    name: str = ""
    h_kind: str = "dense"

    @property
    def n(self) -> int:
        return self.g.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    def Hx(self, v):
        return QP.Hx(self, v)

    def objective(self, x):
        return 0.5 * torch.dot(x, self.Hx(x)) + torch.dot(self.g, x) + self.f

    def constraints(self, x):
        """c(x) = A x + 1/2 <x, Q_i x> per row (one einsum)."""
        lin = self.A @ x
        if self.m == 0:
            return lin
        return lin + 0.5 * torch.einsum("mij,i,j->m", self.Qc, x, x)

    def to_qp(self) -> QP:
        """Drop the quadratic constraint terms (valid when Qc == 0)."""
        return QP(H=self.H, g=self.g, f=self.f, A=self.A, c_l=self.c_l, c_u=self.c_u,
                  x_l=self.x_l, x_u=self.x_u, x=self.x, y=self.y, z=self.z, name=self.name,
                  h_kind=self.h_kind)


@dataclasses.dataclass
class QCQPInfo:
    """The JAX package's fields, and LANCELOT's (and, for "filter",
    FILTRANE's) work: ``inner_iter``, ``host_reads``, ``krylov_reads``."""

    x: Any
    y: Any
    z: Any
    obj: Any
    infeas: Any
    norm_pg: Any
    iter: Any
    converged: Any
    status: Any
    inner_iter: int = 0
    host_reads: int = 0
    krylov_reads: int = 0


def qcqp_solve(p: QCQP, ctl: QCQPControl = QCQPControl()) -> QCQPInfo:
    """Solve the QCQP on its tensors' device: primal x, constraint multipliers
    y, bound duals z (the Lagrangian-gradient residual on the bounded
    variables, the QP solvers' convention for fixed variables)."""
    masks = classify_bounds(p, ctl.infinity)
    objective, constraints = p.objective, p.constraints
    x0 = p.x if p.x is not None else torch.zeros(p.n, dtype=p.g.dtype, device=p.g.device)

    reads = 0
    if ctl.method == "filter":
        # feasibility first (FILTRANE's role), then the AL polish
        fst = filtrane_solve(constraints, x0, p.c_l, p.c_u, p.x_l, p.x_u,
                             FiltraneControl(maxit=ctl.inner_maxit))
        x0 = clip(fst.x, p.x_l, p.x_u)
        reads = fst.host_reads

    st = lancelot_solve(objective, constraints, x0, p.c_l, p.c_u, p.x_l, p.x_u,
                        LancelotControl(maxit=ctl.maxit, stop_c=ctl.stop_c, stop_g=ctl.stop_g,
                                        inner_maxit=ctl.inner_maxit, infinity=ctl.infinity))
    x, y = st.x, st.y
    # bound dual z = grad_x L = grad f - J(x)' y on the bounds
    gL = grad(objective)(x) - vjp(constraints, x)[1](y)[0]
    z = torch.where(masks.has_xl | masks.has_xu, gL, 0.0)
    return QCQPInfo(x=x, y=y, z=z, obj=objective(x), infeas=st.infeas, norm_pg=st.norm_pg,
                    iter=st.iter, converged=st.converged, status=st.status,
                    inner_iter=st.inner_iter, host_reads=st.host_reads + reads,
                    krylov_reads=st.krylov_reads)
