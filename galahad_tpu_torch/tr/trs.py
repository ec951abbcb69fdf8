"""Exact trust-region subproblem solver (batched): TRS, RQS and DPS.

Counterpart of galahad_tpu/tr/trs.py (GALAHAD's TRS, reference
src/trs/trs.f90: TRS_solve :802, TRS_solve_main :1218, hard case
:2398-2430; DPS, src/dps/dps.f90:578)::

    min  1/2 x'Hx + c'x   s.t.  ||x||_M <= radius

One batched ``torch.linalg.eigh`` diagonalizes H in the M-inner-product
(the library routine the JAX package calls too), after which the secular
equation is a scalar Newton iteration on the eigenvalue data.  That
iteration, and RQS's bracket growth and Newton loop, are one launch each of
the hand-written kernels of ``csrc/secular.cu`` on the card
(``tr/secular_kernels.py``); their plain versions here
(:func:`secular_newton_plain`, :func:`rqs_newton_plain`) are the JAX
package's loops as batched tensor ops, used on the CPU and to hold the
kernels against.  :func:`trs_solve_chol` is the reference's own
factorize-per-lambda iteration with batched ``cholesky_ex``.

Every function here is batched over leading dimensions, and
:func:`trs_solve`, :func:`rqs_solve`, :func:`dps_solve` and
:func:`trs_solve_chol` make no host read.  Entry points take tensors (which
keep their device) or numpy arrays and numbers (which go to
``resolve_device(device)``: the card unless ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..core.config import control as control_dc
from ..linalg.cholesky import chol_factor, chol_ok, chol_solve
from . import secular_kernels


@control_dc
class TRSControl:
    """Subset of TRS_control_type (reference src/trs/trs.f90:150+)."""

    stop_normal: float = 1.0e-12    # relative secular-equation accuracy
    max_newton_its: int = 64
    equality_problem: bool = False  # require ||x|| = radius exactly


@dataclasses.dataclass
class TRSInfo:
    """inform equivalent (reference trs.f90 TRS_inform_type)."""

    x: Any
    obj: Any
    multiplier: Any      # lambda >= 0 with (H + lambda M) x = -c
    norm_x: Any
    hard_case: Any
    interior: Any


def as_tensors(*args, device=None):
    """The arguments of an entry point as tensors of one floating type on
    one device.  The first tensor among them sets both (its type if it is
    floating, else float64); without one, numpy inputs go to
    ``resolve_device(device)`` in their own float32/float64 type (float64
    by default).  Numbers become 0-d tensors made by a fill on the device;
    ``None`` stays ``None``."""
    ref = next((a for a in args if torch.is_tensor(a)), None)
    if ref is not None:
        dev = ref.device
        dt = ref.dtype if ref.is_floating_point() else torch.float64
    else:
        dev = resolve_device(device)
        arr = next((a for a in args if isinstance(a, np.ndarray)), None)
        dt = torch.float32 if arr is not None and arr.dtype == np.float32 else torch.float64
    out = []
    for a in args:
        if a is None:
            out.append(None)
        elif torch.is_tensor(a):
            out.append(a.to(dtype=dt))
        elif np.ndim(a) == 0:
            out.append(torch.full((), float(a), dtype=dt, device=dev))
        else:
            out.append(torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dt))
    return out


def _eigh(A):
    """Eigendecomposition of the symmetrized A (``jnp.linalg.eigh``'s
    ``symmetrize_input=True``)."""
    return torch.linalg.eigh((A + A.mT) / 2)


def _eigh_M(H, c, M=None):
    """Generalized eigendecomposition H q = lam M q via the Cholesky factor
    of M.  Returns (lam, ct, back) with back(w) mapping eigen-coordinates to
    x and ct the transformed linear term.  M=None means the 2-norm."""
    if M is None:
        lam, Q = _eigh(H)
        ct = (Q.mT @ c[..., None])[..., 0]
        return lam, ct, lambda w: (Q @ w[..., None])[..., 0]
    L, _ = chol_factor(M)
    # Ht = L^-1 H L^-T
    Hs = torch.linalg.solve_triangular(L, H, upper=False)
    Ht = torch.linalg.solve_triangular(L, Hs.mT, upper=False)
    ctv = torch.linalg.solve_triangular(L, c[..., None], upper=False)
    lam, Q = _eigh(Ht)
    ct = (Q.mT @ ctv)[..., 0]

    def back(w):
        return torch.linalg.solve_triangular(L.mT, Q @ w[..., None], upper=True)[..., 0]

    return lam, ct, back


# ---------------------------------------------------------------------------
# The secular Newton iterations: plain versions and dispatch
# ---------------------------------------------------------------------------


def secular_newton_plain(lam, ct2, radius, lam_lo, max_its: int):
    """Safeguarded Newton on psi(s) = 1/||x(s)|| - 1/radius, where
    ||x(s)||^2 = sum ct2 / (lam + s)^2, for s in (lam_lo, inf): the JAX
    package's ``fori_loop`` (all ``max_its`` iterations) as batched tensor
    ops.  psi is monotone increasing and nearly linear in s (the
    Hebden/More-Sorensen formulation the reference's Taylor iteration
    refines, trs.f90:4719); the safeguard keeps s in the bracket."""
    secular_kernels.count_plain("trs")
    eps = torch.finfo(lam.dtype).eps

    s_hi0 = lam_lo + torch.sqrt(ct2.sum(-1)) / radius + 1.0
    s = 0.5 * (lam_lo + s_hi0)
    lo, hi = lam_lo, s_hi0
    for i in range(max_its):
        d = lam + s[..., None]
        n2 = (ct2 / d ** 2).sum(-1)
        nrm = torch.sqrt(n2)
        psi = 1.0 / nrm - 1.0 / radius
        # interval update: psi < 0 -> ||x|| > radius -> s too small
        lo = torch.where(psi < 0, torch.maximum(lo, s), lo)
        hi = torch.where(psi > 0, torch.minimum(hi, s), hi)
        # grow hi if still too small (psi(hi) must be > 0)
        hi = torch.where(hi <= lo, lo + (s_hi0 - lam_lo) * (2.0 ** i), hi)
        dpsi = -0.5 * (-2.0 * (ct2 / d ** 3).sum(-1)) / (n2 * nrm)
        step = -psi / torch.where(dpsi.abs() > eps, dpsi, 1.0)
        s_new = s + step
        bad = (s_new <= lo) | (s_new >= hi) | ~torch.isfinite(s_new)
        s = torch.where(bad, 0.5 * (lo + hi), s_new)
    return s


def _secular_newton(lam, ct2, radius, lam_lo, max_its: int):
    """s of :func:`secular_newton_plain`: the plain version for a CPU tensor,
    one launch of the kernel (or an error) for a CUDA one."""
    bshape = lam.shape[:-1]
    radius = radius.expand(bshape)
    if lam.device.type == "cpu":
        return secular_newton_plain(lam, ct2, radius, lam_lo, max_its)
    return secular_kernels.trs_secular_newton(lam, ct2, radius, lam_lo, max_its)


def _rqs_theta(lam, ct2, excl, sigma, pm2, s):
    eps = torch.finfo(lam.dtype).eps
    d = lam + s[..., None]
    d = torch.where(excl, math.inf, d)
    d = torch.where(d.abs() < eps, eps, d)
    nrm = torch.sqrt((ct2 / d ** 2).sum(-1))
    return (torch.clamp(s, min=0.0) / sigma) ** (1.0 / pm2) - nrm, nrm, d


def rqs_newton_plain(lam, ct2, excl, sigma, p: float, lam_lo, hi0, max_its: int):
    """RQS's two loops as batched tensor ops: hi grows to 2 hi + 1 while
    theta(hi) < 0 (60 rounds: a problem whose theta(hi) >= 0 stays, so
    this is the JAX ``while_loop``'s hi without its early exit, and no host
    read), then ``max_its`` safeguarded Newton steps on
    theta(s) = (s/sigma)^(1/(p-2)) - ||x(s)|| from (lam_lo + hi) / 2."""
    secular_kernels.count_plain("rqs")
    eps = torch.finfo(lam.dtype).eps
    pm2 = p - 2.0
    hi = hi0
    for _ in range(60):
        hi = torch.where(_rqs_theta(lam, ct2, excl, sigma, pm2, hi)[0] < 0, hi * 2.0 + 1.0, hi)
    lo = lam_lo
    s = 0.5 * (lo + hi)
    for _ in range(max_its):
        th, nrm, d = _rqs_theta(lam, ct2, excl, sigma, pm2, s)
        lo = torch.where(th < 0, torch.maximum(lo, s), lo)
        hi = torch.where(th > 0, torch.minimum(hi, s), hi)
        dn = -(ct2 / d ** 3).sum(-1) / torch.where(nrm > eps, nrm, 1.0)
        dth = (1.0 / (pm2 * sigma)) * (torch.clamp(s, min=eps) / sigma) ** (1.0 / pm2 - 1.0) - dn
        step = -th / torch.where(dth.abs() > eps, dth, 1.0)
        s_new = s + step
        bad = (s_new <= lo) | (s_new >= hi) | ~torch.isfinite(s_new)
        s = torch.where(bad, 0.5 * (lo + hi), s_new)
    return s


def _rqs_newton(lam, ct2, excl, sigma, p, lam_lo, hi0, max_its: int):
    bshape = lam.shape[:-1]
    sigma = sigma.expand(bshape)
    if lam.device.type == "cpu":
        return rqs_newton_plain(lam, ct2, excl, sigma, p, lam_lo, hi0, max_its)
    return secular_kernels.rqs_secular_newton(lam, ct2, excl, sigma, p, lam_lo, hi0, max_its)


# ---------------------------------------------------------------------------
# TRS
# ---------------------------------------------------------------------------


def trs_solve_diagonal(h_diag, c, radius, ctl: TRSControl = TRSControl(), device=None):
    """Diagonal-Hessian fast path (reference trs.f90:3335): H = diag(h).
    Batched over leading dims."""
    h_diag, c, radius = as_tensors(h_diag, c, radius, device=device)
    return _trs_from_eigen(h_diag, c, radius, lambda w: w, ctl)


def trs_solve(H, c, radius, M=None, ctl: TRSControl = TRSControl(), device=None):
    """Solve the trust-region subproblem exactly.  Batched: H (..., n, n),
    c (..., n), radius (...) broadcastable.  Returns TRSInfo."""
    H, c, radius, M = as_tensors(H, c, radius, M, device=device)
    lam, ct, back = _eigh_M(H, c, M)
    return _trs_from_eigen(lam, ct, radius, back, ctl)


def _min_eigen(lam, ct, ct2, eps):
    """lam_min, and the entries at it with no part of c there (the JAX
    package's at_min & ~c_in_min), and at_min itself."""
    lam_min = lam.min(-1).values
    scale = torch.clamp(ct.abs().max(-1).values, min=1.0)
    at_min = (lam - lam_min[..., None]).abs() <= (lam_min[..., None].abs() + 1.0) * (eps ** 0.5)
    c_in_min = torch.sqrt(torch.where(at_min, ct2, 0.0).sum(-1)) > scale * eps ** 0.75
    return lam_min, at_min, c_in_min


def _leftmost_unit(at_min):
    """The unit vector of the first entry at the leftmost eigenvalue."""
    first_min = torch.cumsum(at_min.to(torch.int32), -1) == 1
    return torch.where(first_min & at_min, 1.0, 0.0)


def _trs_from_eigen(lam, ct, radius, back, ctl: TRSControl):
    dt = lam.dtype
    eps = torch.finfo(dt).eps
    radius = radius.to(dt)
    ct2 = ct * ct
    lam_min, at_min, c_in_min = _min_eigen(lam, ct, ct2, eps)

    # --- interior candidate: x(0) = -H^-1 c, valid if H >= 0 (lam_min > 0)
    pd = lam_min > 0
    d0 = torch.where(pd[..., None], lam, 1.0)
    x0_w = -ct / d0
    norm0 = torch.sqrt((x0_w ** 2).sum(-1))
    interior = pd & (norm0 <= radius) & (not ctl.equality_problem)

    # --- boundary: s > max(0, -lam_min) with ||x(s)|| = radius; for
    # equality problems the root lives in (-lam_min, inf)
    lam_lo = -lam_min if ctl.equality_problem else torch.clamp(-lam_min, min=0.0)
    excl = at_min & ~c_in_min[..., None]
    d_at = lam + lam_lo[..., None]
    safe = torch.where(excl, math.inf, d_at)
    safe = torch.where(safe.abs() < eps, eps, safe)
    norm_pinv = torch.sqrt((ct2 / safe ** 2).sum(-1))
    boundary_active = torch.ones_like(pd) if ctl.equality_problem else lam_min < 0
    hard = ~c_in_min & (norm_pinv < radius) & boundary_active

    # secular Newton for the easy boundary case.  A hard case's s is not
    # used; it gets a problem whose root is its start, s = 1 (lam = 0, ct2 =
    # radius^2 e_1, lam_lo = 0), which stops at once.  The JAX package's
    # stand-in (lam + 1, ct2 = 1, lam_lo = 1) has poles inside the bracket
    # when lam_min < -2: there the loop wanders for all its iterations, and
    # its s is set by the last bit of a step below an ulp.
    # e_1 made on the device (a written Python number would be a host copy)
    e1 = (torch.arange(ct2.shape[-1], device=ct2.device) == 0).to(ct2.dtype).expand_as(ct2)
    s_b = _secular_newton(
        torch.where(hard[..., None], 0.0, lam),
        torch.where(hard[..., None], (radius * radius)[..., None] * e1, ct2),
        radius,
        torch.where(hard, 0.0, lam_lo),
        ctl.max_newton_its)

    # assemble the boundary solution in eigen-coordinates
    s_sol = torch.where(hard, lam_lo, s_b)
    d = lam + s_sol[..., None]
    d_safe = torch.where(excl & hard[..., None], math.inf, d)
    d_safe = torch.where(d_safe.abs() < eps, eps, d_safe)
    xw = -ct / d_safe
    # hard case: add tau * (leftmost eigenvector) to reach the boundary
    nx2 = (xw ** 2).sum(-1)
    tau = torch.sqrt(torch.clamp(radius ** 2 - nx2, min=0.0))
    xw = torch.where(hard[..., None], xw + tau[..., None] * _leftmost_unit(at_min), xw)

    # choose interior vs boundary
    w = torch.where(interior[..., None], x0_w, xw)
    mult = torch.where(interior, 0.0, s_sol)
    x = back(w)
    obj = 0.5 * (lam * w ** 2).sum(-1) + (ct * w).sum(-1)
    norm_x = torch.sqrt((w ** 2).sum(-1))
    return TRSInfo(x=x, obj=obj, multiplier=mult, norm_x=norm_x,
                   hard_case=hard & ~interior, interior=interior)


# ---------------------------------------------------------------------------
# RQS: regularized quadratic subproblem (reference src/rqs/rqs.f90:774)
# ---------------------------------------------------------------------------


@control_dc
class RQSControl:
    stop_normal: float = 1.0e-12
    max_newton_its: int = 96


def rqs_solve(H, c, sigma, p=3.0, M=None, ctl: RQSControl = RQSControl(), device=None):
    """min 1/2 x'Hx + c'x + (sigma/p) ||x||_M^p  (p > 2, typically 3).

    Optimality: (H + s M) x = -c with s = sigma ||x||^(p-2) >= 0 and
    H + s M >= 0.  The eigen-machinery of TRS; the secular equation
    theta(s) = (s/sigma)^(1/(p-2)) - ||x(s)|| = 0 is monotone increasing in
    s and solved by safeguarded Newton (one kernel launch on the card)."""
    H, c, sigma, M = as_tensors(H, c, sigma, M, device=device)
    lam, ct, back = _eigh_M(H, c, M)
    dt = lam.dtype
    eps = torch.finfo(dt).eps
    ct2 = ct * ct
    pm2 = p - 2.0
    lam_min, at_min, c_in_min = _min_eigen(lam, ct, ct2, eps)
    lam_lo = torch.clamp(-lam_min, min=0.0)
    excl = at_min & ~c_in_min[..., None]

    # hard case: at s = lam_lo (> 0) the target radius (s/sigma)^(1/(p-2))
    # exceeds the norm of the pseudo-inverse solution
    norm_lo = _rqs_theta(lam, ct2, excl, sigma, pm2, lam_lo)[1]
    target_lo = (lam_lo / sigma) ** (1.0 / pm2)
    hard = ~c_in_min & (lam_min < 0) & (norm_lo < target_lo)

    hi = lam_lo + sigma ** (1 / (p - 1)) * ct2.sum(-1) ** (pm2 / (2 * (p - 1))) \
        + torch.clamp(lam_lo, min=1.0)
    s = _rqs_newton(lam, ct2, excl, sigma, p, lam_lo, hi, ctl.max_newton_its)

    s_sol = torch.where(hard, lam_lo, s)
    _, _, d = _rqs_theta(lam, ct2, excl, sigma, pm2, s_sol)
    xw = -ct / d
    # hard case: extend along the leftmost eigenvector to radius (s/sigma)^(1/(p-2))
    target = (s_sol / sigma) ** (1.0 / pm2)
    tau = torch.sqrt(torch.clamp(target ** 2 - (xw ** 2).sum(-1), min=0.0))
    xw = torch.where(hard[..., None], xw + tau[..., None] * _leftmost_unit(at_min), xw)

    x = back(xw)
    norm_x = torch.sqrt((xw ** 2).sum(-1))
    obj = 0.5 * (lam * xw ** 2).sum(-1) + (ct * xw).sum(-1) + (sigma / p) * norm_x ** p
    return TRSInfo(x=x, obj=obj, multiplier=s_sol, norm_x=norm_x,
                   hard_case=hard, interior=torch.zeros_like(hard))


def dps_solve(H, c, radius=None, sigma=None, p=3.0, M=None, goldfarb: bool = False,
              ctl: TRSControl = TRSControl(), device=None):
    """DPS (reference src/dps/dps.f90:578): TRS or RQS in a DIAGONALIZING
    norm built from H itself, by default the modified absolute-value norm
    M = Q |Lambda|_mod Q' (small eigenvalues floored), or the Goldfarb
    variant (|Lambda| floored at a fraction of lambda_max) when
    ``goldfarb``.  In u = |Lambda|^{1/2} Q' x the problem is a unit-norm
    TRS/RQS with spectrum sign(lambda), solved by the same secular
    machinery.  ``M`` (a caller-supplied norm) overrides the built norm and
    falls back to plain TRS/RQS in that norm."""
    if M is not None:
        if radius is not None:
            return trs_solve(H, c, radius, M=M, ctl=ctl, device=device)
        return rqs_solve(H, c, sigma, p=p, M=M, device=device)

    H, c, radius, sigma = as_tensors(H, c, radius, sigma, device=device)
    lam, Q = _eigh(H)
    eps = torch.finfo(lam.dtype).eps
    if goldfarb:
        floor = torch.clamp(eps ** 0.5 * lam.abs().max(-1, keepdim=True).values, min=eps)
    else:
        floor = torch.full((), eps ** 0.5, dtype=lam.dtype, device=lam.device)
    a = torch.maximum(lam.abs(), floor)          # |Lambda|_mod
    rs = torch.sqrt(a)
    lam_u = lam / a                               # sign spectrum
    ct_u = torch.einsum("...ij,...i->...j", Q, c) / rs

    def back(w):
        return torch.einsum("...ij,...j->...i", Q, w / rs)

    if radius is not None:
        return _trs_from_eigen(lam_u, ct_u, radius, back, ctl)
    info = rqs_solve(torch.diag_embed(lam_u), ct_u, sigma, p=p)
    return dataclasses.replace(info, x=back(info.x))


# ---------------------------------------------------------------------------
# The factorization-based TRS (the reference's own algorithm)
# ---------------------------------------------------------------------------


def trs_solve_chol(H, c, radius, ctl: TRSControl = TRSControl(), iters: int = 26,
                   device=None):
    """Factorization-based More-Sorensen TRS, the reference TRS's own
    algorithm (factorize H + lambda I per candidate lambda, safeguarded
    Newton on 1/||x|| - 1/radius; reference src/trs/trs.f90:802), with
    batched Cholesky factorizations: every problem of the batch takes all
    ``iters`` steps, a finished one frozen by masks (the JAX package's vmap
    of a ``fori_loop``).

    Near-hard-case inputs get a LINPACK-style correction (two inverse
    iterations with the final factor and a boundary step along the
    approximate eigenvector); exactly-hard cases should use the
    eigen-secular :func:`trs_solve`, which resolves them exactly."""
    H, c, radius = as_tensors(H, c, radius, device=device)
    dt = H.dtype
    n = H.shape[-1]
    bshape = H.shape[:-2]
    Hb = H.reshape((-1, n, n))
    c = c.expand(bshape + (n,)).reshape(-1, n)
    radius = radius.expand(bshape).reshape(-1)
    I = torch.eye(n, dtype=dt, device=H.device)
    normc = torch.linalg.vector_norm(c, dim=-1)
    diag = torch.diagonal(Hb, dim1=-2, dim2=-1)
    offr = Hb.abs().sum(-1) - diag.abs()
    gersh_min = (diag - offr).min(-1).values          # lambda_min >= this
    lam_hi0 = torch.clamp(-gersh_min, min=0.0) + normc / radius + 1.0
    tol = 10 * torch.finfo(dt).eps

    def fac_solve(lam):
        L, info = chol_factor(Hb + lam[:, None, None] * I)
        ok = chol_ok(L, info)
        Ls = torch.where(ok[:, None, None], L, I)
        x = chol_solve(Ls, -c)
        w = torch.linalg.solve_triangular(Ls, x[..., None], upper=False)[..., 0]
        return ok, Ls, x, w

    zero = torch.zeros_like(radius)
    lam, lo, hi = zero, zero, lam_hi0
    xb, lamb = torch.zeros_like(c), zero
    done = torch.zeros_like(radius, dtype=torch.bool)
    for _ in range(iters):
        ok, L, x, w = fac_solve(lam)
        nx = torch.linalg.vector_norm(x, dim=-1)
        # interior optimum: lam == 0 feasible and ||x|| <= radius
        interior = ok & (lam <= tol) & (nx <= radius * (1 + tol))
        at_boundary = ok & ((nx - radius).abs() <= 1e-6 * radius)
        newly = ~done & (interior | at_boundary)
        xb = torch.where(newly[:, None], x, xb)
        lamb = torch.where(newly, lam, lamb)
        done = done | newly
        # bracket update
        lo = torch.where(~ok | (ok & (nx > radius)), lam, lo)
        hi = torch.where(ok & (nx < radius), torch.minimum(hi, lam), hi)
        nw2 = (w * w).sum(-1)
        dlam = (nx * nx / torch.clamp(nw2, min=1e-30)) * (nx - radius) / radius
        lam_n = lam + dlam
        inside = ok & (lam_n > lo) & (lam_n < hi)
        lam_next = torch.where(
            inside, lam_n,
            torch.maximum(torch.sqrt(torch.clamp(lo, min=1e-30) * hi), lo + 0.01 * (hi - lo)))
        lam = torch.where(done, lam, lam_next)
    # not converged -> near-hard case: accept the last feasible iterate and
    # push to the boundary along an approximate null eigenvector (LINPACK
    # correction)
    lam_out = torch.where(done, lamb, hi)
    _, L, xf, _ = fac_solve(lam_out)
    x = torch.where(done[:, None], xb, xf)
    u = chol_solve(L, torch.full_like(c, 1.0 / math.sqrt(n)))
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=1e-30)
    u = chol_solve(L, u)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=1e-30)
    xu = (x * u).sum(-1)
    rr = radius * radius - (x * x).sum(-1)
    root = torch.sqrt(torch.clamp(xu * xu + rr, min=0.0))
    tau_a, tau_b = -xu + root, -xu - root

    def mval(t):
        v = x + t[:, None] * u
        return 0.5 * (v * (Hb @ v[..., None])[..., 0]).sum(-1) + (c * v).sum(-1)

    tau = torch.where(mval(tau_a) <= mval(tau_b), tau_a, tau_b)
    hard = ~done & (rr > tol * radius * radius)
    x = torch.where(hard[:, None], x + tau[:, None] * u, x)
    nx = torch.linalg.vector_norm(x, dim=-1)
    obj = 0.5 * (x * (Hb @ x[..., None])[..., 0]).sum(-1) + (c * x).sum(-1)
    interior = done & (lam_out <= tol)
    return TRSInfo(x=x.reshape(bshape + (n,)), obj=obj.reshape(bshape),
                   multiplier=lam_out.reshape(bshape), norm_x=nx.reshape(bshape),
                   hard_case=hard.reshape(bshape), interior=interior.reshape(bshape))
