"""Equality-constrained QP (EQP) with an optional trust region.

Counterpart of galahad_tpu/qp/eqp.py (GALAHAD's EQP, reference
src/eqp/eqp.f90: EQP_solve :693, factorize :1613, nullspace solve :2013):

    min 1/2 x'Hx + g'x + f   s.t.  A x = c   (and ||x|| <= radius)

  * a particular solution x0 = A'(AA')^-1 c by one Cholesky of AA' + delta I
    (linalg/cholesky.py: ``chol_factor_shifted``, ``chol_solve``);
  * the nullspace projection P(v) = v - A'(AA')^-1 A v;
  * the reduced problem min 1/2 s'(PHP)s + (P(g + H x0))'s, ||s|| <= radius,
    handed to GLTR (tr/gltr.py; its boundary solve is the secular kernel of
    row 6a on the card) on the projected H that acts as the identity on
    range(A');
  * the multipliers by least squares, y = (AA')^-1 A (Hx + g).

On an exhausted Krylov space GLTR's stop test reads roundoff, so its count
can part from the JAX package's there while x agrees (ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.config import control as control_dc
from ..linalg.cholesky import chol_factor_shifted, chol_solve
from ..tr.gltr import GLTRControl, gltr_solve
from ..tr.trs import as_tensors


@control_dc
class EQPControl:
    gltr_itmax: int = 128
    radius: float = 0.0          # 0 -> effectively unconstrained (1e20)
    delta: float = 1.0e-12       # AA' regularization


@dataclasses.dataclass
class EQPInfo:
    """``iter`` GLTR's Lanczos steps (one host read each)."""

    x: Any
    y: Any
    obj: Any
    norm_x: Any
    multiplier: Any
    iter: Any


def eqp_solve(H, g, A, c, f=0.0, ctl: EQPControl = EQPControl(), device=None) -> EQPInfo:
    """Solve the (trust-region) equality-constrained QP: H (n, n) symmetric
    (need not be definite when a radius is active), A (m, n) of full row
    rank, c (m,); numpy goes to ``resolve_device(device)``."""
    g, A, H, c = as_tensors(g, A, H, c, device=device)
    m = A.shape[-2]

    AAt = A @ A.T + ctl.delta * torch.eye(m, dtype=A.dtype, device=A.device)
    L, _, _ = chol_factor_shifted(AAt, 0.0)

    def proj(v):
        return v - A.T @ chol_solve(L, A @ v)

    x0 = A.T @ chol_solve(L, c)          # min-norm particular solution
    g_red = proj(H @ x0 + g)
    radius = ctl.radius if ctl.radius > 0 else 1.0e20

    # P H P is singular along range(A'); acting as the identity there keeps
    # spurious near-zero Ritz values out of the Lanczos process without
    # touching the null(A) component the solve lives in
    def reduced_op(v):
        pv = proj(v)
        return proj(H @ pv) + (v - pv)

    tr = gltr_solve(reduced_op, g_red, radius, ctl=GLTRControl(itmax=ctl.gltr_itmax))
    s = proj(tr.x)
    x = x0 + s
    y = chol_solve(L, A @ (H @ x + g))
    obj = 0.5 * torch.dot(x, H @ x) + torch.dot(g, x) + f
    return EQPInfo(x=x, y=y, obj=obj, norm_x=torch.linalg.vector_norm(s),
                   multiplier=tr.multiplier, iter=tr.iter)
