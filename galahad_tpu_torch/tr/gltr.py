"""GLTR / GLRT: Krylov (Lanczos) trust-region and regularization solvers.

Counterpart of galahad_tpu/tr/gltr.py (GALAHAD's GLTR, reference
src/gltr/gltr.f90: GLTR_solve :611; GLRT, src/glrt/glrt.f90:555).  The
caller passes ``matvec`` (H v) and optionally ``prec`` (M^-1 v) as
callables on tensors.  The Lanczos recurrence fills a fixed (itmax, n)
basis; the JAX ``while_loop`` that stops on ``done`` becomes a Python loop
that reads ``done`` once per iteration (at most ``itmax`` reads), so the
iteration count is the JAX package's.  The boundary subproblem on the
accumulated tridiagonal T, padded to itmax with 1e12 on the diagonal as in
the JAX package (so that ``eigh`` orders the eigenvalues as there), is
solved exactly by the eigen-secular TRS / RQS of tr/trs.py, and so by the
secular kernels on the card.

The trust-region norm is the preconditioner norm ||x||_M (as in the
reference): in Lanczos coordinates it is the Euclidean norm of h.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.config import control as control_dc
from .trs import TRSControl, _eigh, _trs_from_eigen, as_tensors, rqs_solve

PAD = 1.0e12             # diagonal of T past the Krylov dimension


@control_dc
class GLTRControl:
    itmax: int = 64                # static Krylov-space cap
    stop_relative: float = 1.0e-8
    stop_absolute: float = 0.0
    steihaug_toint: bool = False   # if True, stop at first boundary hit


@dataclasses.dataclass
class GLTRInfo:
    x: Any
    obj: Any
    multiplier: Any
    iter: int
    norm_x: Any
    converged: Any
    negative_curvature: Any


def _lanczos(matvec, b, prec, itmax: int, tol_rel, tol_abs):
    """Run (preconditioned) Lanczos on H starting from b.

    Returns (V, alphas, betas, gamma0, k): T = tridiag(diag=alphas,
    off=betas[:k-1]) is k x k, the rows of V are the M^-1-orthonormal basis
    (premultiplied by M^-1), and b = gamma0 * M v1.  Stops when a beta is
    at most 1e-14 or at ``itmax`` (read on the host once per iteration)."""
    n = b.shape[-1]
    dt = b.dtype
    pb = prec(b)
    gamma0 = torch.sqrt(torch.dot(b, pb))
    g = torch.where(gamma0 > 0, gamma0, 1.0)
    V = torch.zeros((itmax, n), dtype=dt, device=b.device)   # w_j = M^-1 u_j
    U = torch.zeros((itmax, n), dtype=dt, device=b.device)   # u_j (M-side)
    V[0] = pb / g
    U[0] = b / g
    alphas = torch.zeros(itmax, dtype=dt, device=b.device)
    betas = torch.zeros(itmax, dtype=dt, device=b.device)
    k = 0
    done = False
    while not done and k < itmax:
        w, u = V[k], U[k]
        Hw = matvec(w)
        alpha = torch.dot(w, Hw)
        # three-term recurrence: r = H w - alpha u - beta_k u_{k-1}
        r = Hw - alpha * u
        if k > 0:
            r = r - betas[k - 1] * U[k - 1]
        pr = prec(r)
        beta = torch.sqrt(torch.clamp(torch.dot(r, pr), min=0.0))
        alphas[k] = alpha
        betas[k] = beta
        done, ok_next = torch.stack([beta <= 1e-14, beta > 1e-14]).tolist()
        k += 1
        if ok_next and k < itmax:
            V[k] = pr / beta
            U[k] = r / beta
    return V, alphas, betas, gamma0, k


def padded_tridiagonal(diag_k, off_k, k: int, itmax: int):
    """The (itmax, itmax) T of a Krylov dimension k: ``diag_k`` (itmax) on
    the first k diagonal entries and PAD after them, ``off_k`` (itmax - 1) on
    the first k - 1 off-diagonals and 0 after them."""
    idx = torch.arange(itmax, device=diag_k.device)
    diag = torch.where(idx < k, diag_k, PAD)
    off = torch.where(idx[:-1] < k - 1, off_k, 0.0)
    return torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)


def gltr_solve(matvec: Callable, b, radius, prec: Callable | None = None,
               ctl: GLTRControl = GLTRControl(), trs_ctl: TRSControl = TRSControl(),
               device=None) -> GLTRInfo:
    """Approximately minimize 1/2 x'Hx + b'x subject to ||x||_M <= radius
    over the order-``ctl.itmax`` Krylov space.  H enters only through
    ``matvec``; the preconditioner through ``prec`` (M^-1 action)."""
    if prec is None:
        prec = lambda v: v          # noqa: E731
    b, radius = as_tensors(b, radius, device=device)
    itmax = ctl.itmax
    V, alphas, betas, gamma0, k = _lanczos(matvec, -b, prec, itmax, ctl.stop_relative,
                                           ctl.stop_absolute)
    # model in h: 1/2 h'T h + gamma0 e1'h (since -b = gamma0 u1), with the
    # padded tail contributing nothing
    T = padded_tridiagonal(alphas, betas[:-1], k, itmax)
    lamT, Q = _eigh(T)
    e1 = torch.zeros(itmax, dtype=b.dtype, device=b.device)
    e1[0] = -gamma0
    info_h = _trs_from_eigen(lamT, Q.mT @ e1, radius, lambda w: Q @ w, trs_ctl)
    x = V.mT @ info_h.x
    return GLTRInfo(x=x, obj=info_h.obj, multiplier=info_h.multiplier, iter=k,
                    norm_x=info_h.norm_x, converged=True,
                    negative_curvature=~info_h.interior)


@control_dc
class GLRTControl:
    itmax: int = 64
    stop_relative: float = 1.0e-8


def glrt_solve(matvec: Callable, b, sigma, p: float = 3.0, prec: Callable | None = None,
               ctl: GLRTControl = GLRTControl(), device=None) -> GLTRInfo:
    """Regularized analogue (GLRT): min 1/2 x'Hx + b'x + (sigma/p)||x||_M^p
    over the Krylov space (reference src/glrt/glrt.f90:555)."""
    if prec is None:
        prec = lambda v: v          # noqa: E731
    b, sigma = as_tensors(b, sigma, device=device)
    itmax = ctl.itmax
    V, alphas, betas, gamma0, k = _lanczos(matvec, -b, prec, itmax, ctl.stop_relative, 0.0)
    T = padded_tridiagonal(alphas, betas[:-1], k, itmax)
    c1 = torch.zeros(itmax, dtype=b.dtype, device=b.device)
    c1[0] = -gamma0
    info_h = rqs_solve(T, c1, sigma, p=p)
    x = V.mT @ info_h.x
    return GLTRInfo(x=x, obj=info_h.obj, multiplier=info_h.multiplier, iter=k,
                    norm_x=info_h.norm_x, converged=True, negative_curvature=False)
