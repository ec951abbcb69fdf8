"""Hermite and Puiseux polynomial interpolation of path data.

Counterpart of galahad_tpu/core/fit.py (GALAHAD's FIT package, reference
src/fit/fit.f90: FIT_hermite_interpolation :318, FIT_puiseux_interpolation
:481).  The IPM's series arcs evaluate the central path x(alpha) as a
Taylor series sum_k x^k alpha^k (``polyval``); the rest turns series
coefficients at alpha = 0 into evaluable polynomials.  Coefficient tensors
carry the components on their leading axes and the coefficients on the
last, so one call covers a whole primal-dual vector.
"""
from __future__ import annotations

import torch


def _t(a):
    return a if torch.is_tensor(a) else torch.as_tensor(a)


def hermite_coefficients(derivs):
    """Coefficients (low -> high) of the degree-(k-1) truncated Taylor
    polynomial from derivatives at 0: ``derivs[..., j] / j!`` (the
    single-point case of FIT_hermite_interpolation, fit.f90:318)."""
    derivs = _t(derivs)
    k = derivs.shape[-1]
    fact = torch.cumprod(torch.cat([
        torch.ones(1, dtype=derivs.dtype, device=derivs.device),
        torch.arange(1, k, dtype=derivs.dtype, device=derivs.device)]), dim=0)
    return derivs / fact


def hermite_interpolation(alphas, values):
    """Divided-difference (Newton form) interpolation through distinct
    points (fit.f90:318 restricted to function values).  Returns the
    Newton coefficients; evaluate with :func:`newton_eval`."""
    alphas = _t(alphas)
    values = _t(values)
    k = alphas.shape[-1]
    table = values
    coeffs = [table[..., 0]]
    for level in range(1, k):
        num = table[..., 1:] - table[..., :-1]
        den = alphas[..., level:] - alphas[..., :-level]
        table = num / den
        coeffs.append(table[..., 0])
    return torch.stack(coeffs, dim=-1)


def newton_eval(alphas, coeffs, t):
    """Evaluate the Newton-form polynomial at ``t`` (broadcasts)."""
    alphas = _t(alphas)
    coeffs = _t(coeffs)
    k = coeffs.shape[-1]
    acc = coeffs[..., k - 1]
    for j in range(k - 2, -1, -1):
        acc = coeffs[..., j] + (t - alphas[..., j]) * acc
    return acc


def polyval(coeffs, t):
    """Evaluate sum_j coeffs[..., j] t^j (Horner, low -> high)."""
    coeffs = _t(coeffs)
    k = coeffs.shape[-1]
    acc = coeffs[..., k - 1]
    for j in range(k - 2, -1, -1):
        acc = acc * t + coeffs[..., j]
    return acc


def puiseux_coefficients(derivs):
    """Puiseux-series coefficients f(alpha) ~ sum_j c_j (sqrt alpha)^j from
    the same one-point derivative data (fit.f90:481): derivative j maps to
    the 2j-th coefficient in theta = sqrt(alpha), the odd ones are zero.
    Returns (..., 2k-1) coefficients, low -> high."""
    taylor = hermite_coefficients(derivs)
    k = taylor.shape[-1]
    coeffs = torch.zeros(taylor.shape[:-1] + (2 * k - 1,), dtype=taylor.dtype,
                         device=taylor.device)
    coeffs[..., 0::2] = taylor
    return coeffs


def puiseux_eval(coeffs, alpha):
    """Evaluate a Puiseux polynomial at alpha >= 0 (theta = sqrt alpha)."""
    coeffs = _t(coeffs)
    return polyval(coeffs, torch.sqrt(torch.as_tensor(alpha, dtype=coeffs.dtype,
                                                      device=coeffs.device)))
