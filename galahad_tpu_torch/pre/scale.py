"""Problem scalings (SCALE equivalent).

Counterpart of galahad_tpu/pre/scale.py (reference src/scale/scale.f90:
SCALE_get/apply/recover :397+, methods :585-591: Curtis-Reid, Sinkhorn-Knopp
equilibration, norm-based).  Every method is a fixed number of sweeps of
tensor ops on dense |A| and |H| on the problem's device, with no host read;
applying a scaling is an elementwise product and recovery maps a solution
back exactly.

Scaled problem (row scale r, column scale c):
    A~ = diag(r) A diag(c),  H~ = diag(c) H diag(c),  g~ = c*g,
    bounds x~ = x/c, constraint bounds scaled by r.
Solution recovery: x = c*x~, y = r*y~, z = z~/c.

Dense ``QP`` only, as in the JAX package: a ``SparseQP`` or a ``BandedQP``
raises ``TypeError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, require_dense


@control_dc
class ScaleControl:
    method: str = "sinkhorn"     # "sinkhorn" | "norm" | "curtis_reid"
    sweeps: int = 10
    infinity: float = INFINITY


@dataclasses.dataclass
class Scaling:
    row: Any     # (m,) constraint scale factors
    col: Any     # (n,) variable scale factors


def _colmax(M) -> torch.Tensor:
    """Column maxima of a non-negative (rows, n) tensor; 0 where there are no
    rows (the JAX package's ``max(..., initial=0.0)``)."""
    if M.shape[0] == 0:
        return torch.zeros(M.shape[1], dtype=M.dtype, device=M.device)
    return M.amax(dim=0)


def _sum_in_order(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` in index order (the last entry of a running sum), the
    order the JAX package's reduction takes on the host; 0 over an empty
    dimension."""
    if t.shape[dim] == 0:
        return t.sum(dim=dim)
    return t.cumsum(dim=dim).select(dim, -1)


def scale_get(qp: QP, ctl: ScaleControl = ScaleControl()) -> Scaling:
    """Compute scale factors from the problem data."""
    require_dense(qp, "scale_get")
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    n, m = qp.n, qp.m
    A = qp.A.abs() if m > 0 else torch.zeros((0, n), **like)
    Habs = qp.H_dense().abs()

    if ctl.method == "norm":
        r = (1.0 / torch.sqrt(torch.clamp(A.amax(dim=1), min=1e-10))
             if m > 0 else torch.ones((0,), **like))
        colmax = torch.maximum(_colmax(A), _colmax(Habs))
        c = 1.0 / torch.sqrt(torch.clamp(colmax, min=1e-10))
        return Scaling(row=r, col=c)

    if ctl.method == "curtis_reid":
        # least-squares log scaling: minimize sum (log|a_ij| + p_i + q_j)^2
        # over nonzeros, by a fixed number of Jacobi sweeps on the normal
        # equations (the reference's MC29-style algorithm)
        mask = A > 0
        logA = torch.where(mask, torch.log(torch.clamp(A, min=1e-30)), 0.0)
        cnt_r = torch.clamp(mask.sum(dim=1), min=1)
        cnt_c = torch.clamp(mask.sum(dim=0), min=1)
        p = torch.zeros((m,), **like)
        q = torch.zeros((n,), **like)
        for _ in range(ctl.sweeps):
            p = -_sum_in_order(logA + torch.where(mask, q[None, :], 0.0), 1) / cnt_r
            q = -_sum_in_order(logA + torch.where(mask, p[:, None], 0.0), 0) / cnt_c
        return Scaling(row=torch.exp(p), col=torch.exp(q))

    # sinkhorn: Ruiz-style alternating equilibration of the row and column
    # inf-norms of the stacked [A; H] operator (each sweep divides the current
    # scaled matrix's row / column norms by their square roots)
    r = torch.ones((m,), **like)
    c = torch.ones((n,), **like)
    for _ in range(ctl.sweeps):
        if m > 0:
            M = A * r[:, None] * c[None, :]
            r = r / torch.sqrt(torch.clamp(M.amax(dim=1), min=1e-10))
            M = A * r[:, None] * c[None, :]
        else:
            M = A
        Hs = Habs * c[None, :] * c[:, None]
        colmax = torch.maximum(_colmax(M), _colmax(Hs))
        c = c / torch.sqrt(torch.clamp(colmax, min=1e-10))
    return Scaling(row=r, col=c)


def scale_apply(qp: QP, s: Scaling, infinity: float = INFINITY) -> QP:
    """Return the scaled problem (SCALE_apply equivalent).  Infinite bounds
    stay infinite."""
    require_dense(qp, "scale_apply")
    r, c = s.row, s.col
    m = qp.m

    def sb(v, f):       # scale a bound, keeping the +-inf markers
        return torch.where(v.abs() >= infinity, v, v * f)

    H = qp.H_dense() * c[None, :] * c[:, None]
    A = (qp.A * r[:, None] * c[None, :]) if m > 0 else qp.A
    return dataclasses.replace(
        qp,
        H=H, h_kind="dense", g=qp.g * c, A=A,
        c_l=sb(qp.c_l, r) if m > 0 else qp.c_l,
        c_u=sb(qp.c_u, r) if m > 0 else qp.c_u,
        x_l=sb(qp.x_l, 1.0 / c),
        x_u=sb(qp.x_u, 1.0 / c),
        x=qp.x / c if qp.x is not None else None,
        y=qp.y / r if (qp.y is not None and m > 0) else qp.y,
        z=qp.z * c if qp.z is not None else None,
    )


def scale_recover(s: Scaling, x, y=None, z=None):
    """Map a solution of the scaled problem back (SCALE_recover)."""
    out = [x * s.col]
    if y is not None:
        out.append(y * s.row)
    if z is not None:
        out.append(z / s.col)
    return tuple(out) if len(out) > 1 else out[0]
