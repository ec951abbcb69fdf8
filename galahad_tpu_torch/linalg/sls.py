"""SLS: a uniform facade over symmetric factorization backends.

Counterpart of galahad_tpu/linalg/sls.py (GALAHAD's SLS, reference
src/sls/sls.f90: SLS_analyse :2178, SLS_factorize :3521, SLS_solve :4692;
backend dispatch by name :843-921).  Backends, by the same names:

  * "potr"  dense Cholesky (``torch.linalg.cholesky_ex``);
  * "sytr"  dense symmetric indefinite through LU with partial pivoting
    (``torch.linalg.lu_factor``); no inertia;
  * "eigh"  dense eigendecomposition: inertia and pseudo-inverse solves;
  * "pbtr"  block-tridiagonal Cholesky (linalg/banded.py: on the card the
    hand-written factor and solve kernels of csrc/banded.cu);
  * "cg"    matrix-free conjugate gradients;
  * "supernodal"  the inline multifrontal LDL^T (linalg/supernodal.py: on
    the card the hand-written kernels of csrc/partial_ldlt.cu and
    csrc/ldlt_wide.cu); ``A = (symbolic, values)`` from ``supernodal_analyse``.

Every factor object has ``.solve(rhs)``.  Results lie on the device of the
input; host input goes to ``device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._device import as_device_tensor, resolve_device
from ..core.config import control as control_dc
from .banded import block_tridiag_cholesky, block_tridiag_solve
from .cholesky import chol_factor_shifted, chol_solve

# the CG loop reads its stop test on the host once every CG_CHECK iterations
CG_CHECK = 16


@control_dc
class SLSControl:
    solver: str = "potr"
    shift: float = 0.0           # regularization added to the diagonal
    cg_maxit: int = 256
    cg_tol: float = 1.0e-12


@dataclasses.dataclass
class SLSFactors:
    data: Any
    aux: Any
    ok: Any
    inertia: Any       # (pos, neg, zero), or (-1, -1, -1) if unavailable
    kind: str = "potr"
    host_reads: int = 0    # host reads of the CG solves made with these factors

    def solve(self, rhs):
        return sls_solve(self, rhs)


def _none3(device):
    return torch.full((3,), -1, dtype=torch.int32, device=device)


def sls_factorize(A, ctl: SLSControl = SLSControl(), device=None) -> SLSFactors:
    """Factorize a symmetric matrix.  ``A`` is (n, n) dense for potr / sytr
    / eigh, a (D, L) block pair for pbtr, a matvec closure for cg and
    ``(symbolic, values)`` for supernodal."""
    kind = ctl.solver

    if kind == "pbtr":
        D, L = (as_device_tensor(t, device) for t in A)
        f = block_tridiag_cholesky(D, L)
        return SLSFactors(data=f, aux=None, ok=f.ok, inertia=_none3(D.device), kind=kind)

    if kind == "cg":
        return SLSFactors(data=A, aux=ctl, ok=True, inertia=_none3(resolve_device(device)),
                          kind=kind)

    if kind == "supernodal":
        from .supernodal import supernodal_factorize

        sym, vals = A
        vals = as_device_tensor(vals, device)
        fac = supernodal_factorize(sym, vals, shift=ctl.shift)
        return SLSFactors(data=fac, aux=sym, ok=torch.ones((), dtype=torch.bool,
                                                           device=vals.device),
                          inertia=_none3(vals.device), kind=kind)

    A = as_device_tensor(A, device)
    n = A.shape[-1]
    if ctl.shift:
        A = A + ctl.shift * torch.eye(n, dtype=A.dtype, device=A.device)

    if kind == "potr":
        L, _, ok = chol_factor_shifted(A, 0.0, max_tries=1)
        full = torch.tensor([n, 0, 0], dtype=torch.int32, device=A.device)
        return SLSFactors(data=L, aux=None, ok=ok,
                          inertia=torch.where(ok, full, _none3(A.device)), kind=kind)

    if kind == "sytr":
        lu, piv = torch.linalg.lu_factor(A)
        ok = (torch.diagonal(lu, dim1=-2, dim2=-1).abs() > 0).all()
        return SLSFactors(data=(lu, piv), aux=None, ok=ok, inertia=_none3(A.device),
                          kind=kind)

    if kind == "eigh":
        lam, Q = torch.linalg.eigh(A)
        tol = lam.abs().max() * torch.finfo(A.dtype).eps * n
        pos = (lam > tol).sum()
        neg = (lam < -tol).sum()
        zero = n - pos - neg
        return SLSFactors(data=(lam, Q), aux=tol, ok=zero == 0,
                          inertia=torch.stack([pos, neg, zero]).to(torch.int32), kind=kind)

    raise ValueError(f"unknown SLS solver {kind!r}")


def sls_solve(f: SLSFactors, rhs):
    """Solve A x = rhs with the factors (SLS_solve)."""
    if f.kind == "potr":
        return chol_solve(f.data, rhs)
    if f.kind == "sytr":
        lu, piv = f.data
        vec = rhs.dim() == 1
        x = torch.linalg.lu_solve(lu, piv, rhs[:, None] if vec else rhs)
        return x[:, 0] if vec else x
    if f.kind == "eigh":
        lam, Q = f.data
        safe = torch.where(lam.abs() > f.aux, lam, torch.inf)
        vec = rhs.dim() == 1
        w = Q.mT @ (rhs[:, None] if vec else rhs)
        x = Q @ (w / safe[:, None])
        return x[:, 0] if vec else x
    if f.kind == "pbtr":
        return block_tridiag_solve(f.data, rhs)
    if f.kind == "supernodal":
        from .supernodal import supernodal_solve

        return supernodal_solve(f.aux, f.data, rhs)
    if f.kind == "cg":
        x, reads = _cg_solve(f.data, rhs, f.aux)
        f.host_reads += reads
        return x
    raise ValueError(f"unknown SLS solver {f.kind!r}")


def sls_enquire(f: SLSFactors):
    """Inertia (pos, neg, zero): SLS_enquire; (-1, -1, -1) where the
    backend does not give it."""
    return f.inertia


def _cg_solve(matvec, b, ctl: SLSControl):
    """Plain CG (the matrix-free backend), the JAX package's while loop on
    the device: each iteration's test is a 0-d tensor, a finished loop
    leaves its state as it is, and the host reads the test once every
    ``CG_CHECK`` iterations.  Returns (x, host reads)."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.dot(r, r)
    tol2 = ctl.cg_tol ** 2 * torch.clamp(rs, min=1e-300)
    k = 0
    reads = 0
    live = rs > tol2
    while k < ctl.cg_maxit:
        Ap = matvec(p)
        alpha = rs / torch.clamp(torch.dot(p, Ap), min=1e-300)
        x = torch.where(live, x + alpha * p, x)
        r_new = r - alpha * Ap
        rs_new = torch.dot(r_new, r_new)
        p = torch.where(live, r_new + (rs_new / torch.clamp(rs, min=1e-300)) * p, p)
        r = torch.where(live, r_new, r)
        rs = torch.where(live, rs_new, rs)
        live = live & (rs > tol2)
        k += 1
        if k % CG_CHECK == 0:
            reads += 1
            if not bool(live):
                break
    return x, reads
