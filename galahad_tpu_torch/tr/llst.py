"""LLST / LLS: trust-region-constrained linear least squares.

Counterpart of galahad_tpu/tr/llst.py (GALAHAD's LLST, reference
src/llst/llst.f90: min ||Ax - b||_2 s.t. ||Sx||_2 <= radius; LLS,
src/lls/lls.f90: the same by GLTR on the normal equations).

  * LLST: one SVD of A S^-1 (``torch.linalg.svd``, where the JAX package
    calls ``jnp.linalg.svd``) diagonalizes the whole lambda-path, and the
    secular equation ||x(lambda)|| = radius is solved by a safeguarded
    scalar Newton in the singular basis (plain torch, batched over leading
    dimensions as the JAX function is under vmap).
  * LLS: GLTR on the normal operator A'A (two matrix-vector products).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.config import control as control_dc
from .gltr import GLTRControl, gltr_solve
from .trs import as_tensors


@control_dc
class LLSTControl:
    max_newton: int = 64
    tol: float = 1.0e-12


@dataclasses.dataclass
class LLSTInfo:
    x: Any
    r_norm: Any
    x_norm: Any
    multiplier: Any


def llst_solve(A, b, radius, S=None, ctl: LLSTControl = LLSTControl(),
               device=None) -> LLSTInfo:
    """Exact solution of min ||Ax - b|| s.t. ||Sx|| <= radius; S is None
    (identity) or an (n,) diagonal scaling.  Batched over leading
    dimensions of (A, b, radius)."""
    A, b, radius, S = as_tensors(A, b, radius, S, device=device)
    dt = A.dtype
    As = A / S[..., None, :] if S is not None else A
    # min ||As w - b||, ||w|| <= radius, x = w / S
    U, sv, Vt = torch.linalg.svd(As, full_matrices=False)
    beta = (U.mT @ b[..., None])[..., 0]    # projections onto left vectors
    sv2 = sv * sv
    svb = sv * beta

    # interior solution (lambda = 0; pseudo-inverse for rank deficiency)
    tiny = torch.finfo(dt).eps * torch.clamp(sv[..., :1], min=1.0)
    big = sv > tiny
    w0_coeff = torch.where(big, beta / torch.where(big, sv, 1.0), 0.0)
    interior = torch.sqrt((w0_coeff ** 2).sum(-1)) <= radius

    # boundary: Newton on 1/||w(lambda)|| - 1/radius (convex, monotone)
    lam = torch.full(interior.shape, 1e-8, dtype=dt, device=A.device)
    for _ in range(ctl.max_newton):
        d = svb / (sv2 + lam[..., None])
        n2 = (d * d).sum(-1)
        norm = torch.sqrt(torch.clamp(n2, min=1e-300))
        # d/dlam ||w||^2 = -2 sum (sv beta)^2 / (sv^2 + lam)^3
        dn2 = -2.0 * (svb ** 2 / (sv2 + lam[..., None]) ** 3).sum(-1)
        f = 1.0 / norm - 1.0 / radius
        df = -0.5 * dn2 / (n2 * norm)
        step = f / torch.where(df.abs() > 0, df, 1.0)
        lam = torch.clamp(lam - step, min=0.0)
    lam = torch.where(interior, 0.0, lam)

    coeff = torch.where(interior[..., None], w0_coeff, svb / (sv2 + lam[..., None]))
    w = (Vt.mT @ coeff[..., None])[..., 0]
    x = w / S if S is not None else w
    r = (A @ x[..., None])[..., 0] - b
    return LLSTInfo(x=x, r_norm=torch.linalg.vector_norm(r, dim=-1),
                    x_norm=torch.linalg.vector_norm(w, dim=-1), multiplier=lam)


def lls_solve(A, b, radius, prec: Callable | None = None, ctl: GLTRControl = GLTRControl(),
              device=None):
    """Iterative TR least squares (LLS equivalent): GLTR on the normal
    equations 1/2 x'(A'A)x - (A'b)'x within ||x|| <= radius.  ``prec`` is
    an optional M^-1 apply.  Returns the GLTRInfo."""
    A, b, radius = as_tensors(A, b, radius, device=device)

    def matvec(v):
        return A.mT @ (A @ v)

    # model 1/2||Ax-b||^2 = 1/2 x'(A'A)x + (-A'b)'x + const
    return gltr_solve(matvec, -(A.mT @ b), radius, prec=prec, ctl=ctl)
