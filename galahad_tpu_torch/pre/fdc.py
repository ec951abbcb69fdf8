"""Dependent equality-constraint detection (FDC).

Counterpart of galahad_tpu/pre/fdc.py (GALAHAD's FDC, reference
src/fdc/fdc.f90: FDC_find_dependent :517).  A pivoted Gram-Schmidt sweep
over the rows of A: each row is orthogonalized against the accepted ones
and is dependent when its residual falls below tol * ||row||; dependent
rows are masked, not deleted.  The JAX package's ``lax.scan`` over the
rows is a loop of tensor operations on the device with no host read.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._device import as_device_tensor
from ..core.config import control as control_dc


@control_dc
class FDCControl:
    tolerance: float = 0.5e-7    # relative pivot tolerance


@dataclasses.dataclass
class FDCInfo:
    independent: Any     # (m,) bool mask of independent rows
    n_dependent: Any     # 0-d tensor
    inconsistent: Any    # 0-d bool: a dependent row has an inconsistent rhs


def fdc_find_dependent(A, b, ctl: FDCControl = FDCControl(), device=None) -> FDCInfo:
    """Mask the linearly dependent rows of A (equality constraints A x = b).
    A tensor stays on its device; host input goes to ``device`` (``None``:
    the card)."""
    A = as_device_tensor(A, device)
    dt = A.dtype
    b = as_device_tensor(b, A.device, dt)
    m, n = A.shape
    tol = ctl.tolerance
    Q = torch.zeros((m, n), dtype=dt, device=A.device)
    qb = torch.zeros(m, dtype=dt, device=A.device)
    accepted = torch.zeros(m, dtype=torch.bool, device=A.device)
    incons = torch.zeros((), dtype=torch.bool, device=A.device)
    for i in range(m):
        row = A[i]
        coeff = Q @ row
        r = row - Q.T @ coeff
        rb = b[i] - torch.dot(coeff, qb)
        rn = torch.linalg.norm(r)
        scale = torch.clamp(torch.linalg.norm(row), min=1e-30)
        indep = rn > tol * scale
        rs = torch.where(rn > 0, rn, 1.0)
        Q[i] = torch.where(indep, r / rs, 0.0)
        qb[i] = torch.where(indep, rb / rs, 0.0)
        accepted[i] = indep
        bscale = torch.clamp(b[i].abs(), min=1.0)
        incons = incons | (~indep & (rb.abs() > tol * bscale * 100.0))
    return FDCInfo(independent=accepted, n_dependent=m - accepted.sum(),
                   inconsistent=incons)
