"""LQR / LQT: trust-region and regularized subproblems over the Lanczos
Krylov space, with the MINRES-style residual.

Counterpart of galahad_tpu/tr/lqr.py (GALAHAD's LQR / LQT, reference
src/lqr/lqr.f90, src/lqt/lqt.f90).  The Lanczos engine of tr/gltr.py builds
the tridiagonal T_k once; the model is then minimized exactly in the small
space (the eigen-secular TRS / RQS), and the residual ||Hx + b|| comes from
the Lanczos relation |beta_{k+1} e_k'h| without extra products.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.config import control as control_dc
from .gltr import _lanczos, padded_tridiagonal
from .trs import TRSControl, _eigh, _trs_from_eigen, as_tensors, rqs_solve


@control_dc
class LQRControl:
    itmax: int = 64
    stop_relative: float = 1.0e-8
    stop_absolute: float = 0.0


@dataclasses.dataclass
class LQRInfo:
    x: Any
    obj: Any
    multiplier: Any
    iter: int
    norm_x: Any
    resid: Any        # MINRES residual ||Hx + b|| estimate


def _krylov_setup(matvec, b, prec, ctl):
    if prec is None:
        prec = lambda v: v          # noqa: E731
    itmax = ctl.itmax
    V, alphas, betas, gamma0, k = _lanczos(matvec, -b, prec, itmax, ctl.stop_relative,
                                           ctl.stop_absolute)
    T = padded_tridiagonal(alphas, betas[:-1], k, itmax)
    # _lanczos runs on -b, so b = -gamma0 * v1 and the reduced linear term
    # is b'(V'h) = -gamma0 * h1 (gltr.py's convention)
    c_t = torch.zeros(itmax, dtype=b.dtype, device=b.device)
    c_t[0] = -gamma0
    active = torch.arange(itmax, device=b.device) < k
    return V, T, c_t, betas, k, active


def _finish(V, h, T, c_t, betas, k: int, active):
    h = torch.where(active, h, 0.0)
    x = V.mT @ h
    obj = 0.5 * h @ (T @ h) + c_t @ h
    # Lanczos relation: ||Hx + lam x + b|| = beta_k |h_{k-1}|
    last = min(max(k - 1, 0), h.shape[0] - 1)
    resid = (betas[last] * h[last]).abs()
    return x, obj, resid


def lqr_solve(matvec: Callable, b, radius, prec: Callable | None = None,
              ctl: LQRControl = LQRControl(), trs_ctl: TRSControl = TRSControl(),
              device=None) -> LQRInfo:
    """min 1/2 x'Hx + b'x s.t. ||x||_M <= radius over the Krylov space
    (LQR_solve equivalent, reference src/lqr/lqr.f90)."""
    b, radius = as_tensors(b, radius, device=device)
    V, T, c_t, betas, k, active = _krylov_setup(matvec, b, prec, ctl)
    lam, Q = _eigh(T)
    info = _trs_from_eigen(lam, Q.mT @ c_t, radius, lambda w: Q @ w, trs_ctl)
    x, obj, resid = _finish(V, info.x, T, c_t, betas, k, active)
    return LQRInfo(x=x, obj=obj, multiplier=info.multiplier, iter=k,
                   norm_x=torch.linalg.vector_norm(info.x), resid=resid)


def lqt_solve(matvec: Callable, b, sigma, p: float = 3.0, prec: Callable | None = None,
              ctl: LQRControl = LQRControl(), device=None) -> LQRInfo:
    """min 1/2 x'Hx + b'x + (sigma/p)||x||_M^p over the Krylov space
    (LQT_solve equivalent, reference src/lqt/lqt.f90)."""
    b, sigma = as_tensors(b, sigma, device=device)
    V, T, c_t, betas, k, active = _krylov_setup(matvec, b, prec, ctl)
    info = rqs_solve(T, c_t, sigma, p=p)
    x, obj, resid = _finish(V, info.x, T, c_t, betas, k, active)
    return LQRInfo(x=x, obj=obj, multiplier=info.multiplier, iter=k,
                   norm_x=torch.linalg.vector_norm(info.x), resid=resid)
