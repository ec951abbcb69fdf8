"""Univariate global optimization (UGO).

Counterpart of galahad_tpu/go/ugo.py (GALAHAD's UGO, reference
src/ugo/ugo.f90: UGO_solve :641): the global minimum of a smooth f on [a, b]
by Lipschitz-bound interval branching (Piyavskii-Shubert with an adaptive
Lipschitz estimate), the evaluated points in a fixed (maxit + 2)-slot
buffer, one new evaluation per iteration at the minimizer of the piecewise
lower bound, then a safeguarded Newton polish (``torch.func.grad`` of
``grad`` on a 0-d input).  A Python loop of tensor operations that never
reads the host (the JAX package's ``lax.fori_loop``s).

The points are sorted by ``torch.argsort(stable=True)``, as ``jnp.argsort``
sorts: the unused slots hold b, the right endpoint's value, and an unstable
sort could put one of them (whose f is inf) before the endpoint, which would
void the last interval and change the point chosen.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.func import grad

from ..core.config import control as control_dc
from ..tr.trs import as_tensors


@control_dc
class UGOControl:
    maxit: int = 100
    lipschitz_inflation: float = 2.0   # global L estimate = inflation * max slope
    refine_newton_its: int = 5         # final local polish


@dataclasses.dataclass
class UGOInfo:
    x: Any
    f: Any
    iter: Any
    evals: Any


def _at(v, j):
    """v[j] for a (1,) index tensor j, as a 0-d tensor (no host read)."""
    return v.gather(0, j)[0]


def ugo_solve(f: Callable, a, b, ctl: UGOControl = UGOControl(), device=None) -> UGOInfo:
    """Globally minimize the scalar function f (0-d -> 0-d) on [a, b]
    (numbers go to ``resolve_device(device)``; a tensor keeps its device)."""
    a, b = as_tensors(a, b, device=device)
    dt, dev = a.dtype, a.device
    cap = ctl.maxit + 2

    xs = torch.full((cap,), 0.0, dtype=dt, device=dev) + b
    xs[0] = a
    fs = torch.full((cap,), torch.inf, dtype=dt, device=dev)
    fs[0] = f(a)
    fs[1] = f(b)
    slots = torch.arange(cap - 1, device=dev)
    for i in range(ctl.maxit):
        k = i + 2                           # number of points so far
        order = torch.argsort(xs, stable=True)
        xo = xs[order]
        fo = fs[order]
        # the padding collapses onto b: intervals beyond k - 1 are masked
        dx = xo[1:] - xo[:-1]
        df = torch.abs(fo[1:] - fo[:-1])
        iv_valid = (slots < k - 1) & (dx > 1e-14)
        slopes = torch.where(iv_valid, df / torch.clamp(dx, min=1e-14), 0.0)
        L = ctl.lipschitz_inflation * torch.clamp(torch.max(slopes), min=1e-8)
        # Piyavskii lower bound on each interval:
        #   min over [x_i, x_i+1] of max(f_i - L (x - x_i), f_i+1 - L (x_i+1 - x))
        lb = 0.5 * (fo[1:] + fo[:-1]) - 0.5 * L * dx
        lb = torch.where(iv_valid, lb, torch.inf)
        j = torch.argmin(lb).reshape(1)
        xj0, xj1, dxj = _at(xo, j), _at(xo, j + 1), _at(dx, j)
        xj = 0.5 * (xj0 + xj1) + 0.5 * (_at(fo, j) - _at(fo, j + 1)) / L
        xj = torch.minimum(torch.maximum(xj, xj0 + 0.25 * dxj), xj1 - 0.25 * dxj)
        xs[k] = xj
        fs[k] = f(xj)

    x = _at(xs, torch.argmin(fs).reshape(1))
    # local Newton polish (safeguarded into [a, b])
    df = grad(f)
    d2f = grad(df)
    for _ in range(ctl.refine_newton_its):
        g = df(x)
        h = d2f(x)
        step = -g / torch.where(torch.abs(h) > 1e-12, h, 1.0)
        x_new = torch.minimum(torch.maximum(x + step, a), b)
        x = torch.where(f(x_new) <= f(x), x_new, x)
    return UGOInfo(x=x, f=f(x), iter=torch.full((), ctl.maxit, dtype=torch.int32, device=dev),
                   evals=torch.full((), ctl.maxit + 2 + ctl.refine_newton_its,
                                    dtype=torch.int32, device=dev))
