"""Golub-Kahan least-squares Krylov solvers: LSTR / LSRT / L2RT.

Counterpart of galahad_tpu/tr/lstr.py (GALAHAD's LSTR, reference
src/lstr/lstr.f90: LSTR_solve :538; LSRT, src/lsrt/lsrt.f90:541; L2RT,
src/l2rt/l2rt.f90:541)::

  LSTR:  min ||A x - b||_2          s.t. ||x|| <= radius
  LSRT:  min 1/2||A x - b||^2 + (sigma/p)||x||^p
  L2RT:  min   ||A x - b||_2  + mu/2||x||^2 + (sigma/p)||x||^p

The caller passes ``matvec`` (A v) and ``rmatvec`` (A' u).  The
bidiagonalization stops on the JAX package's test, read on the host once
per step; the projected problems on the padded tridiagonal A'A projection
are solved exactly through the eigen-secular machinery of tr/trs.py.
L2RT's scalar fixed-point iteration on 0-d tensors stays plain torch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.config import control as control_dc
from .gltr import padded_tridiagonal
from .trs import TRSControl, _eigh, _trs_from_eigen, as_tensors, rqs_solve


@control_dc
class LSTRControl:
    itmax: int = 64
    stop_relative: float = 1.0e-10


@dataclasses.dataclass
class LSTRInfo:
    x: Any
    obj: Any          # value of the solved subproblem objective
    multiplier: Any
    iter: int
    norm_x: Any
    r_norm: Any       # ||A x - b||


def _golub_kahan(matvec, rmatvec, b, itmax: int):
    """Lower bidiagonalization of A from b (Paige-Saunders):
    beta_1 u_1 = b,  alpha_i v_i = A'u_i - beta_i v_{i-1},
    beta_{i+1} u_{i+1} = A v_i - alpha_i u_i.

    Returns (V, alphas, betas, beta1, k): V is (itmax, n) with rows v_i; the
    (k+1) x k lower bidiagonal B_k is [alphas; betas].  Stops when an alpha
    or a beta is at most 1e-14, or at ``itmax``."""
    dt = b.dtype
    beta1 = torch.linalg.vector_norm(b)
    u = b / torch.where(beta1 > 0, beta1, 1.0)
    V = alphas = betas = v_prev = None
    k = 0
    done = False
    while not done and k < itmax:
        w = rmatvec(u)
        if V is None:
            n = w.shape[-1]
            V = torch.zeros((itmax, n), dtype=dt, device=b.device)
            alphas = torch.zeros(itmax, dtype=dt, device=b.device)
            betas = torch.zeros(itmax, dtype=dt, device=b.device)
        else:
            w = w - betas[k - 1] * v_prev
        alpha = torch.linalg.vector_norm(w)
        v = w / torch.where(alpha > 0, alpha, 1.0)
        p = matvec(v) - alpha * u
        beta = torch.linalg.vector_norm(p)
        u = p / torch.where(beta > 0, beta, 1.0)
        V[k] = v
        alphas[k] = alpha
        betas[k] = beta
        done = bool((alpha <= 1e-14) | (beta <= 1e-14))
        v_prev = v
        k += 1
    return V, alphas, betas, beta1, k


def _projected_normal(alphas, betas, beta1, k: int, itmax: int):
    """T = B'B (tridiagonal, padded) and c = -B'(beta1 e1) for the
    projected problem min 1/2 y'Ty + c'y [+ const]."""
    idx = torch.arange(itmax, device=alphas.device)
    active = idx < k
    a = torch.where(active, alphas, 0.0)
    be = torch.where(active, betas, 0.0)
    T = padded_tridiagonal(a * a + be * be, a[1:] * be[:-1], k, itmax)
    c = torch.zeros(itmax, dtype=alphas.dtype, device=alphas.device)
    c[0] = -alphas[0] * beta1
    return T, c


def lstr_solve(matvec: Callable, rmatvec: Callable, b, radius,
               ctl: LSTRControl = LSTRControl(), device=None) -> LSTRInfo:
    """min ||Ax - b|| s.t. ||x|| <= radius over the order-itmax Krylov
    space of A'A (exact for k >= rank)."""
    b, radius = as_tensors(b, radius, device=device)
    V, alphas, betas, beta1, k = _golub_kahan(matvec, rmatvec, b, ctl.itmax)
    T, c = _projected_normal(alphas, betas, beta1, k, ctl.itmax)
    lam, Q = _eigh(T)
    info = _trs_from_eigen(lam, Q.mT @ c, radius, lambda w: Q @ w, TRSControl())
    x = V.mT @ info.x
    # ||Ax-b||^2 = ||b||^2 + 2 (1/2 y'Ty + c'y)  (since T = B'B, c = -B'b)
    rn = torch.sqrt(torch.clamp(beta1 ** 2 + 2.0 * info.obj, min=0.0))
    return LSTRInfo(x=x, obj=rn, multiplier=info.multiplier, iter=k,
                    norm_x=info.norm_x, r_norm=rn)


@control_dc
class LSRTControl:
    itmax: int = 64


def lsrt_solve(matvec: Callable, rmatvec: Callable, b, sigma, p: float = 2.0,
               ctl: LSRTControl = LSRTControl(), device=None) -> LSTRInfo:
    """min 1/2||Ax - b||^2 + (sigma/p)||x||^p (reference lsrt.f90:541).

    p = 2 is plain Tikhonov (solved directly in eigen-coordinates); p > 2
    through the RQS secular solver on the projected problem."""
    b, sigma = as_tensors(b, sigma, device=device)
    V, alphas, betas, beta1, k = _golub_kahan(matvec, rmatvec, b, ctl.itmax)
    T, c = _projected_normal(alphas, betas, beta1, k, ctl.itmax)
    if p == 2.0:
        lam, Q = _eigh(T)
        ct = Q.mT @ c
        y_w = -ct / (lam + sigma)
        y = Q @ y_w
        obj = 0.5 * (lam * y_w ** 2).sum() + (ct * y_w).sum()
        nx = torch.linalg.vector_norm(y)
        mult = sigma
        reg = 0.5 * sigma * nx ** 2
    else:
        info = rqs_solve(T, c, sigma, p=p)
        y, nx, mult = info.x, info.norm_x, info.multiplier
        reg = (sigma / p) * nx ** p
        obj = info.obj - reg
    x = V.mT @ y
    rsq = torch.clamp(beta1 ** 2 + 2.0 * obj, min=0.0)
    return LSTRInfo(x=x, obj=0.5 * rsq + reg, multiplier=mult, iter=k, norm_x=nx,
                    r_norm=torch.sqrt(rsq))


@control_dc
class L2RTControl:
    itmax: int = 64
    newton_its: int = 48


def l2rt_solve(matvec: Callable, rmatvec: Callable, b, sigma, p: float = 3.0,
               mu: float = 0.0, ctl: L2RTControl = L2RTControl(), device=None) -> LSTRInfo:
    """min ||Ax - b||_2 + mu/2 ||x||^2 + (sigma/p)||x||^p
    (reference l2rt.f90:541).

    Optimality: (A'A + nu I) x = A'b with nu = mu ||r|| + sigma
    ||x||^{p-2} ||r||, r = Ax - b.  Solved on the projected tridiagonal by a
    damped fixed-point iteration on nu in eigen-coordinates, on 0-d
    tensors."""
    b, = as_tensors(b, device=device)
    V, alphas, betas, beta1, k = _golub_kahan(matvec, rmatvec, b, ctl.itmax)
    T, c = _projected_normal(alphas, betas, beta1, k, ctl.itmax)
    lam, Q = _eigh(T)
    ct = Q.mT @ c

    def norms_at(nu):
        yw = -ct / (lam + nu)
        nx = torch.linalg.vector_norm(yw)
        model = 0.5 * (lam * yw ** 2).sum() + (ct * yw).sum()
        rn = torch.sqrt(torch.clamp(beta1 ** 2 + 2.0 * model, min=0.0))
        return yw, nx, rn

    nu = mu * beta1 + sigma * beta1 + 1e-8
    for _ in range(ctl.newton_its):
        yw, nx, rn = norms_at(nu)
        target = mu * rn + sigma * torch.clamp(nx, min=1e-30) ** (p - 2.0) * rn
        nu = 0.5 * (nu + target)     # damped fixed point
    yw, nx, rn = norms_at(nu)
    x = V.mT @ (Q @ yw)
    obj = rn + 0.5 * mu * nx ** 2 + (sigma / p) * nx ** p
    return LSTRInfo(x=x, obj=obj, multiplier=nu, iter=k, norm_x=nx, r_norm=rn)
