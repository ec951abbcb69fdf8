"""Definite preconditioners for trust-region methods (PSLS).

Counterpart of galahad_tpu/linalg/psls.py (GALAHAD's PSLS, reference
src/psls/psls.f90: preconditioner menu :89-130; PSLS_form_and_factorize
:711, PSLS_apply :4090, the SCU update on row/column removal).  Menu:

  * "none"              P = I
  * "diagonal"          P = diag(max(diag A, min_diagonal))
  * "band"              P = band(A), block-tridiagonal Cholesky (on the card
                        the hand-written kernels of csrc/banded.cu)
  * "reordered_band"    P = band(RCM(A)), the native RCM ordering
  * "full"              shifted Cholesky of A
  * "full_se"           Schnabel-Eskow-style modified Cholesky
  * "full_gmps"         P = Q max(|lam|, delta) Q'
  * "lin_more"          incomplete Cholesky keeping the ``icfs_fill``
                        largest entries per column, shift escalation
  * "mi28" / "munksgaard"  drop-tolerance incomplete Cholesky

Each build returns ``apply(v) ~ P^-1 v``.  The modified and incomplete
factorizations are column loops of tensor operations: no host read per
column (the shift escalation reads its success flag once per try).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._device import as_device_tensor, resolve_device
from ..core.config import control as control_dc
from .banded import block_tridiag_cholesky, block_tridiag_solve
from .cholesky import chol_factor_shifted, chol_solve


@control_dc
class PSLSControl:
    preconditioner: str = "diagonal"
    # "none" | "diagonal" | "band" | "reordered_band" | "full" |
    # "full_se" | "full_gmps" | "lin_more" | "mi28" | "munksgaard"
    semi_bandwidth: int = 5            # reference default
    min_diagonal: float = 1.0e-5       # diagonal floor (psls control)
    icfs_fill: int = 10                # Lin-More memory per column
    drop_tolerance: float = 1.0e-3     # mi28/munksgaard drop rule


# ---------------------------------------------------------------------------
# modified full factorizations


def _modified_cholesky_se(H, min_diag):
    """Schnabel-Eskow-flavoured modified Cholesky: a right-looking column
    loop; each pivot is floored at max(min_diag, tau * max|col|).  Returns
    L with L L' ~= H + E, E >= 0 diagonal.  The rank-1 update touches the
    trailing square only, as the JAX package's masked update does."""
    n = H.shape[-1]
    tau = torch.finfo(H.dtype).eps ** (1.0 / 3.0)
    A = H.clone()
    for j in range(n):
        colj = A[:, j]
        piv = torch.maximum(colj[j], torch.maximum(min_diag, tau * colj.abs().max()))
        sq = torch.sqrt(piv)
        l = colj[j + 1:] / sq
        A[j + 1:, j + 1:] -= torch.outer(l, l)
        A[:j, j] = 0.0
        A[j, j] = sq
        A[j + 1:, j] = l
    return torch.tril(A)


def _gmps_spectral(H, min_diag):
    """GMPS modification, spectrally: P = Q max(|lam|, delta) Q'."""
    lam, Q = torch.linalg.eigh(H)
    return Q, torch.maximum(lam.abs(), min_diag)


# ---------------------------------------------------------------------------
# incomplete Cholesky engines


def _ic_masked(H, pattern, shift):
    """Incomplete Cholesky restricted to ``pattern`` (bool, lower) of
    H + shift I.  Column loop; returns (L, ok), ``ok`` a 0-d tensor."""
    n = H.shape[-1]
    A = H + shift * torch.eye(n, dtype=H.dtype, device=H.device)
    ok = torch.ones((), dtype=torch.bool, device=H.device)
    for j in range(n):
        colj = A[:, j]
        piv = colj[j]
        good = piv > 0.0
        ok = ok & good
        sq = torch.sqrt(torch.where(good, piv, 1.0))
        l = torch.where(pattern[j + 1:, j], colj[j + 1:] / sq, 0.0)
        A[j + 1:, j + 1:] -= torch.outer(l, l)
        A[:j, j] = 0.0
        A[j, j] = sq
        A[j + 1:, j] = l
    return torch.tril(A), ok


def _ic_shifted(H, pattern, tries: int = 12):
    """Lin-More shift escalation: shift 0, then alpha grown 4x a try until
    the masked IC succeeds (icfs' alpha loop); one host read a try."""
    scale = torch.diagonal(H).abs().max() + 1.0
    L, ok = _ic_masked(H, pattern, 0.0)
    alpha = torch.full((), 1e-3, dtype=H.dtype, device=H.device)
    k = 0
    while k < tries and not bool(ok):
        L, ok = _ic_masked(H, pattern, alpha * scale)
        alpha = torch.where(ok, alpha, torch.clamp(alpha * 4.0, min=1e-8))
        k += 1
    return L, ok


def _pattern_lin_more(H, fill: int):
    """Keep the ``fill`` largest-|.| strictly-lower entries per column
    (plus the diagonal)."""
    n = H.shape[-1]
    idx = torch.arange(n, device=H.device)
    strict = idx[:, None] > idx[None, :]
    mag = torch.where(strict, H.abs(), -1.0)
    k = min(max(fill, 0) + 1, n)
    thresh = torch.sort(mag, dim=0, descending=True).values[k - 1, :]
    keep = strict & (mag >= torch.clamp(thresh, min=0.0)[None, :]) & (mag > 0.0)
    return keep | (idx[:, None] == idx[None, :])


def _pattern_drop_tol(H, tol):
    """Pattern of A with small entries dropped (mi28 / munksgaard rule)."""
    n = H.shape[-1]
    idx = torch.arange(n, device=H.device)
    lower = idx[:, None] >= idx[None, :]
    colnorm = torch.sqrt((H * H).sum(dim=0))
    keep = H.abs() > tol * torch.clamp(colnorm, min=1.0)[None, :]
    return (keep & lower) | (idx[:, None] == idx[None, :])


# ---------------------------------------------------------------------------


def _band_apply(H, b: int, min_diag):
    """Block-tridiagonal Cholesky apply for band(H): blocks of b, the
    factor of the band and of the band shifted, the shifted one's solve
    taken where the first factor failed."""
    n = H.shape[-1]
    b = max(b, 1)
    k = -(-n // b)
    npad = k * b
    i = torch.arange(npad, device=H.device)
    Hp = torch.zeros((npad, npad), dtype=H.dtype, device=H.device)
    Hp[:n, :n] = H
    Hp = torch.where((i[:, None] - i[None, :]).abs() > b, 0.0, Hp)
    Hp[i[n:], i[n:]] = 1.0
    blocks = Hp.view(k, b, k, b).permute(0, 2, 1, 3)          # (k, k, b, b)
    kk = torch.arange(k, device=H.device)
    D = blocks[kk, kk].contiguous()
    L = blocks[kk[1:], kk[:-1]].contiguous()
    f = block_tridiag_cholesky(D, L)
    shift = Hp.abs().sum(dim=1).max() * 1e-8 + 1e-8
    f2 = block_tridiag_cholesky(D + shift * torch.eye(b, dtype=H.dtype, device=H.device), L)

    def apply(v):
        vp = torch.zeros(npad, dtype=v.dtype, device=v.device)
        vp[:n] = v
        rhs = vp.view(k, b)
        x1 = block_tridiag_solve(f, rhs).reshape(npad)
        x2 = block_tridiag_solve(f2, rhs).reshape(npad)
        return torch.where(f.ok, x1, x2)[:n]

    return apply


def _rcm_perm(H) -> np.ndarray:
    """Host-side RCM ordering of the pattern of H (native C++)."""
    from ..native.wrappers import rcm_order

    pat = H.detach().cpu().numpy() != 0
    np.fill_diagonal(pat, True)
    n = pat.shape[-1]
    rowptr = np.zeros(n + 1, np.int32)
    rowptr[1:] = np.cumsum(pat.sum(axis=1))
    colind = np.nonzero(pat)[1].astype(np.int32)
    return np.asarray(rcm_order(rowptr, colind), dtype=np.int64)


def psls_build(H, ctl: PSLSControl = PSLSControl(), device=None) -> Callable:
    """Return apply(v) ~ P^-1 v for the selected preconditioner of the
    dense symmetric H (a tensor stays on its device; host input goes to
    ``device``, ``None``: the card)."""
    kind = ctl.preconditioner
    H = as_device_tensor(H, device)
    if kind == "none":
        return lambda v: v

    md = torch.full((), ctl.min_diagonal, dtype=H.dtype, device=H.device)

    if kind == "diagonal":
        d = torch.maximum(torch.diagonal(H, dim1=-2, dim2=-1), md)
        return lambda v: v / d

    if kind == "band":
        return _band_apply(H, ctl.semi_bandwidth, md)

    if kind == "reordered_band":
        perm = _rcm_perm(H)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        p = torch.as_tensor(perm, device=H.device)
        ip = torch.as_tensor(inv, device=H.device)
        inner = _band_apply(H[p][:, p], ctl.semi_bandwidth, md)
        return lambda v: inner(v[p])[ip]

    if kind == "full":
        L, _, _ = chol_factor_shifted(H, 0.0)
        return lambda v: chol_solve(L, v)

    if kind == "full_se":
        L = _modified_cholesky_se(H, md)
        return lambda v: chol_solve(L, v)

    if kind == "full_gmps":
        Q, d = _gmps_spectral(H, md)
        return lambda v: Q @ ((Q.T @ v) / d)

    if kind in ("lin_more", "mi28", "munksgaard"):
        if kind == "lin_more":
            pattern = _pattern_lin_more(H, ctl.icfs_fill)
        else:
            pattern = _pattern_drop_tol(H, ctl.drop_tolerance)
        L, _ = _ic_shifted(H, pattern)

        def apply(v):
            y = torch.linalg.solve_triangular(L, v[:, None], upper=False)
            return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]

        return apply

    raise ValueError(f"unknown preconditioner {kind!r}")


# ---------------------------------------------------------------------------
# SCU update on row/column removal (reference psls.f90 SCU usage)


def psls_remove(apply_full: Callable, n: int, removed, device=None) -> Callable:
    """Solve with P[keep, keep] through the FULL preconditioner's apply and
    a dense bordered correction (the reference's SCU update on removal,
    no refactorization):  x_keep = y_I - (P^-1)_{IR} ((P^-1)_{RR})^-1 y_R
    with y = P^-1 v_pad.  Removed components of the result are zero.
    ``removed``: indices; host input goes to ``device`` (``None``: the card)."""
    removed = (removed if torch.is_tensor(removed) else
               torch.as_tensor(np.asarray(removed, np.int64), device=resolve_device(device)))
    removed = removed.to(torch.int64)
    r = removed.shape[0]
    if r == 0:
        return apply_full
    E = torch.zeros((n, r), dtype=torch.float64, device=removed.device)
    E[removed, torch.arange(r, device=removed.device)] = 1.0
    Pinv_R = torch.stack([apply_full(E[:, i]) for i in range(r)], dim=1)     # (n, r)
    S = Pinv_R[removed, :]

    def apply(v):
        v = v.clone()
        v[removed] = 0.0
        y = apply_full(v)
        x = y - Pinv_R @ torch.linalg.solve(S, y[removed])
        x[removed] = 0.0
        return x

    return apply

