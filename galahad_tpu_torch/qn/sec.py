"""Dense secant Hessian updates (BFGS / SR1) with Powell damping.

Counterpart of galahad_tpu/qn/sec.py (GALAHAD's SEC, reference
src/sec/sec.f90: SEC_bfgs_update :309, SEC_sr1_update :412): pure functions
on dense (n, n) tensors, the rank-one/two updates as outer products, with
no host read.
"""
from __future__ import annotations

import torch

from .._device import resolve_device, resolve_dtype


def sec_initial(n: int, scale=1.0, dtype=None, device=None) -> torch.Tensor:
    return scale * torch.eye(n, dtype=resolve_dtype(dtype), device=resolve_device(device))


def bfgs_update(B, s, y, damping: float = 0.2):
    """Powell-damped BFGS update of B (reference sec.f90:309: the damped form
    keeps B positive definite with eta = damping)."""
    tiny = torch.finfo(B.dtype).tiny
    Bs = B @ s
    sBs = torch.dot(s, Bs)
    sty = torch.dot(s, y)
    theta = torch.where(sty >= damping * sBs, 1.0,
                        (1.0 - damping) * sBs / torch.clamp(sBs - sty, min=tiny))
    yb = theta * y + (1.0 - theta) * Bs
    styb = torch.dot(s, yb)
    return (B - torch.outer(Bs, Bs) / torch.clamp(sBs, min=tiny)
            + torch.outer(yb, yb) / torch.clamp(styb, min=tiny))


def sr1_update(B, s, y, skip_tol: float = 1.0e-8):
    """SR1 update with the standard skip safeguard (reference sec.f90:412):
    skip when |(y - Bs)'s| is tiny."""
    r = y - B @ s
    rs = torch.dot(r, s)
    denom_ok = rs.abs() > skip_tol * torch.linalg.norm(r) * torch.linalg.norm(s)
    upd = torch.outer(r, r) / torch.where(denom_ok, rs, 1.0)
    return torch.where(denom_ok, B + upd, B)
