"""Unsymmetric linear-solver facade (ULS).

Counterpart of galahad_tpu/linalg/uls.py (GALAHAD's ULS / GLS, reference
src/uls/uls.f90, src/gls/gls.f90): a factorize / solve / enquire facade
over a partial-pivoting LU (``torch.linalg.lu_factor`` / ``lu_solve``, the
library's, as the JAX package calls XLA's), with transpose solves,
iterative refinement, a rank estimate from |U|'s diagonal, and
``uls_find_basis`` (the basis service of SBLS's null-space mode,
SBLS_find_A1_and_A2, src/sbls/sbls.f90:8082): pivoted QR on the host.

The factors live on the device of ``A``; ``uls_factorize`` takes a
``device`` for host input (``None``: the card).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import as_device_tensor
from ..core.config import control as control_dc


@control_dc
class ULSControl:
    refine: int = 1                  # iterative-refinement sweeps
    singular_tol: float = 1.0e-12    # |u_ii| relative threshold for rank


@dataclasses.dataclass
class ULSFactors:
    lu: Any            # packed LU (n, n)
    piv: Any           # pivot indices (int32, 1-based as LAPACK gives them)
    rank: Any          # numerical rank estimate (0-d tensor)
    u_min: Any         # min |u_ii|
    u_max: Any         # max |u_ii|


def uls_factorize(A, ctl: ULSControl = ULSControl(), device=None) -> ULSFactors:
    """Factorize square unsymmetric A = P L U (ULS_factorize)."""
    A = as_device_tensor(A, device)
    lu, piv = torch.linalg.lu_factor(A)
    d = torch.diagonal(lu, dim1=-2, dim2=-1).abs()
    u_max = d.max(dim=-1).values
    rank = (d > ctl.singular_tol * torch.clamp(u_max, min=1e-300)[..., None]).sum(dim=-1)
    return ULSFactors(lu=lu, piv=piv, rank=rank, u_min=d.min(dim=-1).values, u_max=u_max)


def _lu_solve(f: ULSFactors, b, trans: bool):
    vec = b.dim() == f.lu.dim() - 1
    x = torch.linalg.lu_solve(f.lu, f.piv, b[..., None] if vec else b, adjoint=trans)
    return x[..., 0] if vec else x


def uls_solve(f: ULSFactors, b, A=None, trans: bool = False,
              ctl: ULSControl = ULSControl()):
    """Solve A x = b (or A' x = b) with ``ctl.refine`` refinement sweeps
    against the original A when it is given (ULS_solve; ir.f90:334)."""
    b = as_device_tensor(b, f.lu.device, f.lu.dtype)
    x = _lu_solve(f, b, trans)
    if A is not None and ctl.refine > 0:
        A = as_device_tensor(A, f.lu.device, f.lu.dtype)
        Aop = A.mT if trans else A
        vec = b.dim() == A.dim() - 1
        for _ in range(ctl.refine):
            r = b - ((Aop @ x[..., None])[..., 0] if vec else Aop @ x)
            x = x + _lu_solve(f, r, trans)
    return x


def uls_enquire(f: ULSFactors):
    """(rank, min |u_ii|, max |u_ii|): the ULS_enquire contract."""
    return f.rank, f.u_min, f.u_max


def uls_find_basis(A, tol: float = 1.0e-10):
    """Select ``rank`` linearly independent columns of the m x n matrix A
    by QR with column pivoting on the host (the JAX package's loop).
    Returns (basic_cols, nonbasic_cols, rank), numpy index arrays."""
    if torch.is_tensor(A):
        A = A.detach().cpu().numpy()
    A = np.asarray(A)
    m = A.shape[0]
    R = A.copy().astype(np.float64)
    n = A.shape[1]
    perm = np.arange(n)
    rank = 0
    for k in range(min(m, n)):
        norms = np.linalg.norm(R[k:, k:], axis=0)
        j = int(np.argmax(norms))
        if norms[j] <= tol:
            break
        jj = k + j
        R[:, [k, jj]] = R[:, [jj, k]]
        perm[[k, jj]] = perm[[jj, k]]
        v = R[k:, k].copy()
        v[0] += np.sign(v[0] if v[0] != 0 else 1.0) * np.linalg.norm(v)
        v /= max(np.linalg.norm(v), 1e-300)
        R[k:, k:] -= 2.0 * np.outer(v, v @ R[k:, k:])
        rank += 1
    return perm[:rank].copy(), np.sort(perm[rank:]).copy(), rank
