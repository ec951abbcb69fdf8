"""Limited-memory secant Hessians (L-BFGS / L-SR1), compact form.

Counterpart of galahad_tpu/qn/lms.py (GALAHAD's LMS, reference
src/lms/lms.f90: LMS_setup/form/apply :283, :509; methods :332-348: 1 = BFGS,
2 = SR1, 3 = inverse BFGS, 4 = shifted BFGS), on the Byrd-Nocedal-Schnabel
compact representation.  The history is a ring buffer S, Y of shape
(mem, n) with a validity mask and ``head`` a 0-d tensor on the problem's
device, so an update and an apply read nothing on the host:

* :func:`lms_update` accepts or rejects a pair by a masked ``torch.where``;
* :func:`lms_operator` builds the (2 mem)^2 (BFGS) or mem^2 (SR1) middle
  matrix once, and each apply solves it with ``torch.linalg.solve_ex`` (no
  error check, so no synchronisation: a Krylov solver applies it once per
  Lanczos step);
* :func:`lms_apply_inverse` is the two-loop recursion, the JAX package's two
  ``lax.scan`` as loops of ``mem`` tensor steps over the slots sorted newest
  to oldest by ``argsort(age)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._device import resolve_device, resolve_dtype
from ..core.config import control as control_dc


@control_dc
class LMSControl:
    memory: int = 10            # reference default 10 (lms.f90)
    method: str = "bfgs"        # "bfgs" | "sr1"


@dataclasses.dataclass
class LMSData:
    """Persistent L-QN state (LMS_data_type equivalent)."""

    S: Any            # (mem, n) step history
    Y: Any            # (mem, n) gradient-difference history
    valid: Any        # (mem,) bool slot validity
    head: Any         # 0-d int64: next slot to overwrite (a count of updates)
    delta: Any        # 0-d: B0 = delta I scaling
    method: str = "bfgs"


def lms_setup(n: int, ctl: LMSControl = LMSControl(), dtype=None, device=None) -> LMSData:
    dt, dev = resolve_dtype(dtype), resolve_device(device)
    mem = ctl.memory
    return LMSData(S=torch.zeros((mem, n), dtype=dt, device=dev),
                   Y=torch.zeros((mem, n), dtype=dt, device=dev),
                   valid=torch.zeros(mem, dtype=torch.bool, device=dev),
                   head=torch.zeros((), dtype=torch.int64, device=dev),
                   delta=torch.ones((), dtype=dt, device=dev), method=ctl.method)


def lms_select(ok, new: LMSData, old: LMSData) -> LMSData:
    """Field by field ``torch.where(ok, new, old)`` (``ok`` a 0-d bool)."""
    return LMSData(**{f: torch.where(ok, getattr(new, f), getattr(old, f))
                      for f in ("S", "Y", "valid", "head", "delta")}, method=old.method)


def lms_update(data: LMSData, s, y, curvature_tol: float = 1.0e-8) -> LMSData:
    """Append a secant pair (s, y).  BFGS pairs with s'y too small are
    rejected (the reference's acceptance test); SR1 keeps every pair and
    relies on the apply-time safeguard.  delta = y'y / s'y (the B0 scaling of
    LMS_form)."""
    sty = torch.dot(s, y)
    ss = torch.dot(s, s)
    yy = torch.dot(y, y)
    ok = sty > curvature_tol * torch.sqrt(ss * yy) if data.method == "bfgs" else ss > 0
    idx = torch.remainder(data.head, data.S.shape[0]).reshape(1)
    new = LMSData(S=data.S.index_copy(0, idx, s[None]), Y=data.Y.index_copy(0, idx, y[None]),
                  valid=data.valid.index_fill(0, idx, True), head=data.head + 1,
                  delta=torch.where(sty > 0, yy / sty, data.delta), method=data.method)
    return lms_select(ok, new, data)


def _ages(data: LMSData):
    """Each slot's age (0 = newest) and ``older[i, j]``: slot i older than j."""
    mem = data.S.shape[0]
    age = torch.remainder(data.head - 1 - torch.arange(mem, device=data.S.device), mem)
    return age, age[:, None] > age[None, :]


def _strict_lower(data: LMSData, StY, older):
    """L: the strictly lower triangle of S'Y in chronological order, masked
    to valid pairs."""
    v = data.valid
    L = torch.where(~older & v[:, None] & v[None, :], StY, 0.0)
    return L - torch.diag(torch.diagonal(L))


def _bfgs_middle(data: LMSData):
    """Compact-form W and middle matrix for B = delta I - W M^-1 W', with
    B = delta I - [dS Y] [[dS'S, L], [L', -D]]^-1 [dS'; Y']; invalid slots
    get identity rows and columns (their W columns are zero)."""
    d = data.delta
    S, Y, v = data.S, data.Y, data.valid
    StS = S @ S.T
    StY = S @ Y.T
    _, older = _ages(data)
    L = _strict_lower(data, StY, older)
    D = torch.diagonal(StY)
    top = torch.cat([d * StS, L], dim=1)
    bot = torch.cat([L.T, -torch.diag(D)], dim=1)
    M = torch.cat([top, bot], dim=0)
    vv = torch.cat([v, v])
    M = torch.where(vv[:, None] & vv[None, :], M, 0.0)
    M = M + torch.diag(torch.where(vv, 0.0, 1.0).to(M.dtype))
    W = torch.where(vv[:, None], torch.cat([d * S, Y], dim=0), 0.0)
    return W, M


def _sr1_middle(data: LMSData):
    """Compact SR1: B = d I + U M^-1 U' with U = Y - d S and
    M = D + L + L' - d S'S, masked as the BFGS form, with tiny pivots
    regularized by eps (1 + max|M|)."""
    d = data.delta
    S, Y, vmask = data.S, data.Y, data.valid
    mem = S.shape[0]
    StY = S @ Y.T
    StS = S @ S.T
    _, older = _ages(data)
    L = _strict_lower(data, StY, older)
    D = torch.diagonal(StY)
    M = torch.diag(D) + L + L.T - d * StS
    M = torch.where(vmask[:, None] & vmask[None, :], M, 0.0)
    M = M + torch.diag(torch.where(vmask, 0.0, 1.0).to(M.dtype))
    eps = torch.finfo(M.dtype).eps
    M = M + torch.eye(mem, dtype=M.dtype, device=M.device) * eps * (1.0 + M.abs().max())
    U = torch.where(vmask[:, None], Y - d * S, 0.0)
    return U, M


def lms_operator(data: LMSData, shift=0.0):
    """v -> (B + shift I) v, the TR-shifted Hessian action (reference method
    4 / LMS_form_shift), with the middle matrix formed once here; each call
    is two products with W and one ``solve_ex`` of the small system."""
    if data.method == "sr1":
        U, M = _sr1_middle(data)
        scale = data.delta + shift

        def apply(v):
            return scale * v + U.T @ torch.linalg.solve_ex(M, U @ v)[0]

        return apply
    W, M = _bfgs_middle(data)
    scale = data.delta + shift

    def apply(v):
        return scale * v - W.T @ torch.linalg.solve_ex(M, W @ v)[0]

    return apply


def lms_apply(data: LMSData, v, shift=0.0):
    """w = (B + shift I) v (reference method 4 / LMS_form_shift)."""
    return lms_operator(data, shift)(v)


def lms_apply_inverse(data: LMSData, v):
    """H v with H = B^-1 by the two-loop recursion (method 3, inverse BFGS):
    ``mem`` masked steps over the slots from newest to oldest, then back."""
    if data.method != "bfgs":
        raise ValueError("inverse apply is defined for method='bfgs'")
    mem = data.S.shape[0]
    tiny = torch.finfo(v.dtype).tiny
    age, _ = _ages(data)
    order = torch.argsort(age)            # newest .. oldest
    S, Y, valid = (t.index_select(0, order) for t in (data.S, data.Y, data.valid))
    rho = torch.where(valid, 1.0 / torch.clamp((S * Y).sum(1), min=tiny), 0.0)
    q = v
    alphas = []
    for i in range(mem):
        a = torch.where(valid[i], rho[i] * torch.dot(S[i], q), 0.0)
        q = q - a * Y[i]
        alphas.append(a)
    r = q / data.delta
    for k in reversed(range(mem)):
        b = rho[k] * torch.dot(Y[k], r)
        r = r + torch.where(valid[k], alphas[k] - b, 0.0) * S[k]
    return r
