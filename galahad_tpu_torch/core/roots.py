"""Closed-form + Newton-polished real roots of low-degree polynomials.

Counterpart of galahad_tpu/core/roots.py (GALAHAD's ROOTS package,
reference src/roots/roots.f90: ROOTS_quadratic :396, ROOTS_cubic :519,
ROOTS_quartic :613, ROOTS_polynomial :913).  Every routine is plain
tensor code on coefficient tensors of any batch shape, with no host read,
so that the step-length polynomials of every component of an IPM iterate
are solved by one call inside a captured CUDA graph.

Conventions: coefficients are ordered low -> high (a0 + a1 x + ...).
Non-real roots are reported as +inf with ``nroots`` giving the count of
real ones; roots are sorted ascending with the +inf padding last.
Denominators are guarded (``torch.where`` on the divisor as well as the
result), so no NaN arises on a branch that is not selected.
"""
from __future__ import annotations

import math

import torch

_EPS = 1.0e-13


def _cbrt(x):
    """Real cube root (torch has no cbrt)."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _newton_polish(coeffs, x, iters: int = 2):
    """A couple of Newton steps on p(x) = sum coeffs[k] x^k (the
    reference polishes every closed-form root the same way,
    roots.f90:496-516)."""
    def horner(x):
        p = torch.zeros_like(x)
        dp = torch.zeros_like(x)
        for c in coeffs[::-1]:
            dp = dp * x + p
            p = p * x + c
        return p, dp

    for _ in range(iters):
        p, dp = horner(x)
        step = torch.where(dp.abs() > 0, p / torch.where(dp == 0, 1.0, dp), 0.0)
        x = torch.where(torch.isfinite(x), x - step, x)
    return x


def _as_tensors(*coeffs):
    ref = next((c for c in coeffs if torch.is_tensor(c)), None)
    dt = ref.dtype if ref is not None else torch.float64
    dev = ref.device if ref is not None else None
    ts = [c if torch.is_tensor(c) else torch.as_tensor(c, dtype=dt, device=dev)
          for c in coeffs]
    return torch.broadcast_tensors(*ts)


def roots_quadratic(a0, a1, a2, tol: float = _EPS):
    """Real roots of a0 + a1 x + a2 x^2 (reference roots.f90:396).

    Returns (nroots, roots[..., 2]): the stable formulation
    q = -(a1 + sign(a1) sqrt(disc)) / 2 avoids cancellation; the linear
    and constant cases are handled by masking."""
    a0, a1, a2 = _as_tensors(a0, a1, a2)
    inf = float("inf")

    disc = a1 * a1 - 4.0 * a2 * a0
    # degree classification is relative to the coefficient scale, so that
    # badly scaled polynomials are not demoted (roots.f90:396)
    scale = torch.maximum(torch.maximum(a0.abs(), a1.abs()), a2.abs())
    is_quad = a2.abs() > tol * scale
    is_lin = ~is_quad & (a1.abs() > tol * scale)
    # a discriminant that rounds slightly negative is a (near-)double
    # root, not "no real roots"
    disc_scale = a1 * a1 + 4.0 * (a2 * a0).abs()
    disc = torch.where(
        (disc < 0) & (disc >= -tol * torch.clamp(disc_scale, min=1.0)), 0.0, disc)

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (a1 + torch.where(a1 >= 0, sq, -sq))
    # guard the q == 0 (a0 == 0, a1 == 0) corner
    r1q = torch.where(q.abs() > 0, a0 / torch.where(q == 0, 1.0, q), 0.0)
    r2q = q / torch.where(is_quad, a2, 1.0)
    lo = torch.minimum(r1q, r2q)
    hi = torch.maximum(r1q, r2q)

    lin_root = -a0 / torch.where(is_lin, a1, 1.0)

    two = is_quad & (disc >= 0)
    r1 = torch.where(two, lo, torch.where(is_lin, lin_root, inf))
    r2 = torch.where(two, hi, inf)
    nroots = torch.where(two, 2, torch.where(is_lin, 1, 0)).to(torch.int32)
    return nroots, torch.stack([r1, r2], dim=-1)


def roots_cubic(a0, a1, a2, a3, tol: float = _EPS):
    """Real roots of a0 + a1 x + a2 x^2 + a3 x^3 (reference roots.f90:519,
    Nonweiler's trigonometric/Cardano scheme + Newton).

    Returns (nroots, roots[..., 3]) ascending, +inf padded."""
    a0, a1, a2, a3 = _as_tensors(a0, a1, a2, a3)
    inf = float("inf")

    is_cubic = a3.abs() > tol
    a3s = torch.where(is_cubic, a3, 1.0)
    # depressed cubic t^3 + p t + q via x = t - b/3
    b = a2 / a3s
    c = a1 / a3s
    d = a0 / a3s
    p = c - b * b / 3.0
    q = d - b * c / 3.0 + 2.0 * b ** 3 / 27.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # one-real-root branch (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = _cbrt(-q / 2.0 + sq)
    v = _cbrt(-q / 2.0 - sq)
    t_single = u + v

    # three-real-roots branch (disc <= 0): trigonometric.  Guard the
    # p -> 0 (triple-root) corner where 2 p r underflows to -0.
    pm = torch.clamp(p, max=-1e-300)  # p <= 0 here
    r = torch.sqrt(-pm / 3.0)
    denom = torch.clamp(2.0 * pm * r, max=-1e-300)
    arg = torch.clamp(3.0 * q / denom, -1.0, 1.0)
    phi = torch.arccos(arg)
    t0 = 2.0 * r * torch.cos(phi / 3.0)
    t1 = 2.0 * r * torch.cos((phi - 2.0 * math.pi) / 3.0)
    t2 = 2.0 * r * torch.cos((phi - 4.0 * math.pi) / 3.0)

    three = disc <= 0
    shift = b / 3.0
    x0 = torch.where(three, t0, t_single) - shift
    x1 = torch.where(three, t1, inf) - torch.where(three, shift, 0.0)
    x2 = torch.where(three, t2, inf) - torch.where(three, shift, 0.0)

    coeffs = (a0, a1, a2, a3)
    x0 = _newton_polish(coeffs, x0)
    x1 = torch.where(torch.isfinite(x1), _newton_polish(coeffs, x1), x1)
    x2 = torch.where(torch.isfinite(x2), _newton_polish(coeffs, x2), x2)

    roots3 = torch.sort(torch.stack([x0, x1, x2], dim=-1), dim=-1).values
    n3 = torch.where(three, 3, 1).to(torch.int32)

    # quadratic fallback when a3 ~ 0
    nq, rq = roots_quadratic(a0, a1, a2, tol)
    rq3 = torch.cat([rq, torch.full(rq.shape[:-1] + (1,), inf, dtype=rq.dtype,
                                    device=rq.device)], -1)
    nroots = torch.where(is_cubic, n3, nq)
    roots = torch.where(is_cubic[..., None], roots3, rq3)
    return nroots, roots


def roots_quartic(a0, a1, a2, a3, a4, tol: float = _EPS):
    """Real roots of the quartic (reference roots.f90:613, Ferrari via the
    resolvent cubic, + Newton polish).  Returns (nroots, roots[..., 4])."""
    a0, a1, a2, a3, a4 = _as_tensors(a0, a1, a2, a3, a4)
    inf = float("inf")

    is_quartic = a4.abs() > tol
    a4s = torch.where(is_quartic, a4, 1.0)
    b, c, d, e = a3 / a4s, a2 / a4s, a1 / a4s, a0 / a4s
    # depressed quartic y^4 + p y^2 + q y + r, x = y - b/4
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + b ** 3 / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * b ** 4 / 256.0

    # resolvent cubic: z^3 - p z^2 - 4 r z + (4 p r - q^2) = 0; take a
    # real root z >= p so the two quadratics below have real coefficients
    _, zc = roots_cubic(4.0 * p * r - q * q, -4.0 * r, -p, torch.ones_like(p))
    z = torch.where(torch.isfinite(zc), zc, -inf).amax(dim=-1)

    s2 = torch.clamp(z - p, min=0.0)
    s = torch.sqrt(s2)
    # (y^2 - s y + z/2 - t)(y^2 + s y + z/2 + t) expands with q = -2 t s,
    # r = z^2/4 - t^2; for s -> 0 (biquadratic) recover t from r
    safe = s > tol
    t = torch.where(safe, -q / torch.where(safe, 2.0 * s, 1.0),
                    torch.sqrt(torch.clamp(z * z / 4.0 - r, min=0.0)))
    n1, r1 = roots_quadratic(z / 2.0 - t, -s, torch.ones_like(s))
    n2, r2 = roots_quadratic(z / 2.0 + t, s, torch.ones_like(s))

    shift = b / 4.0
    cand = torch.cat([r1, r2], dim=-1) - shift[..., None]
    coeffs = tuple(c_[..., None] for c_ in (a0, a1, a2, a3, a4))
    cand = torch.where(torch.isfinite(cand), _newton_polish(coeffs, cand), cand)
    roots4 = torch.sort(cand, dim=-1).values
    n4 = (n1 + n2).to(torch.int32)

    nc, rc = roots_cubic(a0, a1, a2, a3, tol)
    rc4 = torch.cat([rc, torch.full(rc.shape[:-1] + (1,), inf, dtype=rc.dtype,
                                    device=rc.device)], -1)
    nroots = torch.where(is_quartic, n4, nc)
    roots = torch.where(is_quartic[..., None], roots4, rc4)
    return nroots, roots


def smallest_positive_root(nroots, roots, big: float = float("inf")):
    """Smallest strictly positive real root (the step-length question every
    ROOTS call in the IPM asks); ``big`` if there is none."""
    slot = torch.arange(roots.shape[-1], device=roots.device)
    pos = torch.where((roots > 0) & torch.isfinite(roots) & (slot < nroots[..., None]),
                      roots, big)
    return pos.amin(dim=-1)


def polynomial_roots_newton(coeffs, x0, iters: int = 30):
    """Arbitrary-degree real-root refinement by Newton from ``x0``
    (reference ROOTS_polynomial, roots.f90:913, polishes the same way)."""
    return _newton_polish(list(coeffs), torch.as_tensor(x0), iters)
