"""Derivative verification (CHECK) and finite-difference sparse Hessian
estimation by column grouping (FDH).

Counterpart of galahad_tpu/nlp/check.py (GALAHAD's CHECK, reference
src/check/check.f90:35: verify user gradients / Hessians against finite
differences; FDH, src/fdh/fdh.f90:15: a sparse Hessian from gradient
differences over a graph colouring of the columns).  First derivatives come
from ``torch.func.grad`` and are exact, so CHECK verifies user-supplied
callables against central differences (or ``torch.func`` itself); every
probe is evaluated at once by ``torch.func.vmap`` over the unit vectors.
FDH's greedy colouring runs on the host once per pattern, and the group
differences are one batched gradient call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad as func_grad
from torch.func import hessian as func_hessian
from torch.func import vmap

from ..core.config import control as control_dc
from ..tr.trs import as_tensors


@control_dc
class CheckControl:
    h: float = 1.0e-6           # FD step (central differences)
    tol: float = 1.0e-4         # relative agreement threshold
    verify_gradient: bool = True
    verify_hessian: bool = True


@dataclasses.dataclass
class CheckInfo:
    ok: bool
    grad_ok: bool
    hess_ok: bool
    max_grad_error: float
    max_hess_error: float
    grad_bad_indices: Any
    hess_bad_indices: Any


def check_derivatives(f: Callable, x, grad: Callable | None = None,
                      hess: Callable | None = None,
                      ctl: CheckControl = CheckControl(), device=None) -> CheckInfo:
    """Verify ``grad`` (and optionally ``hess``) of the scalar ``f`` at x
    against central finite differences (CHECK_verify, reference
    check.f90:35); ``grad=None`` / ``hess=None`` verify ``torch.func``'s.
    The verdicts and errors are host values."""
    (x,) = as_tensors(x, device=device)
    n = x.shape[-1]
    dt = x.dtype
    h = ctl.h
    g_fun = grad if grad is not None else func_grad(f)
    E = torch.eye(n, dtype=dt, device=x.device)

    grad_ok, max_ge, g_bad = True, 0.0, np.zeros(0, np.int64)
    if ctl.verify_gradient:
        g = g_fun(x)
        fd = vmap(lambda e: (f(x + h * e) - f(x - h * e)) / (2 * h))(E)
        err = (g - fd).abs() / (1.0 + fd.abs())
        max_ge = float(err.max())
        g_bad = np.nonzero(err.cpu().numpy() > ctl.tol)[0]
        grad_ok = max_ge <= ctl.tol

    hess_ok, max_he, h_bad = True, 0.0, np.zeros((0, 2), np.int64)
    if ctl.verify_hessian:
        H = (hess if hess is not None else func_hessian(f))(x)
        fdH = vmap(lambda e: (g_fun(x + h * e) - g_fun(x - h * e)) / (2 * h))(E)
        fdH = (fdH + fdH.T) / 2
        err = (H - fdH).abs() / (1.0 + fdH.abs())
        max_he = float(err.max())
        h_bad = np.argwhere(err.cpu().numpy() > ctl.tol)
        hess_ok = max_he <= ctl.tol

    return CheckInfo(ok=grad_ok and hess_ok, grad_ok=grad_ok, hess_ok=hess_ok,
                     max_grad_error=max_ge, max_hess_error=max_he,
                     grad_bad_indices=g_bad, hess_bad_indices=h_bad)


# ---------------------------------------------------------------------------
# FDH: sparse Hessian by graph-coloured gradient differences
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FDHPattern:
    """Static analysis product (FDH_analyse, fdh.f90): column groups such
    that no two columns of a group share a row of the pattern."""
    n: int
    rows: np.ndarray
    cols: np.ndarray
    groups: np.ndarray          # (n,) group id per column
    ngroups: int


def fdh_analyse(n: int, rows, cols) -> FDHPattern:
    """Greedy distance-2 colouring of the column intersection graph (the
    Curtis-Powell-Reid grouping of fdh.f90's analyse phase), on the host,
    giving the JAX package's grouping."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    nbr = [set() for _ in range(n)]
    for i, j in zip(r, c):
        if i != j:
            nbr[j].add(i)
    # column j conflicts with column k if they share a row
    rowcols = {}
    for i, j in zip(r, c):
        rowcols.setdefault(int(i), set()).add(int(j))
    groups = -np.ones(n, np.int32)
    for j in range(n):
        used = set()
        for i in nbr[j] | {j}:
            for kcol in rowcols.get(int(i), ()):
                if groups[kcol] >= 0:
                    used.add(int(groups[kcol]))
        g = 0
        while g in used:
            g += 1
        groups[j] = g
    return FDHPattern(n=n, rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                      groups=groups, ngroups=int(groups.max()) + 1 if n else 0)


def fdh_estimate(pattern: FDHPattern, grad: Callable, x, h: float = 1.0e-6, device=None):
    """The sparse Hessian's entries (pattern order) from one batched gradient
    sweep over the group seed vectors (FDH_estimate, fdh.f90): for group g
    with seed s_g (the sum of its columns' unit vectors), (grad(x + h s_g) -
    grad(x)) / h stacks the group's Hessian columns; entry (i, j) is read
    from group(j)'s difference at row i, and averaged with the transposed
    read."""
    (x,) = as_tensors(x, device=device)
    dev = x.device
    seeds = torch.as_tensor(np.eye(pattern.ngroups)[pattern.groups].T, device=dev).to(x.dtype)
    g0 = grad(x)
    diffs = vmap(lambda s: (grad(x + h * s) - g0) / h)(seeds)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    vals = diffs[t(pattern.groups[pattern.cols]), t(pattern.rows)]
    vals_t = diffs[t(pattern.groups[pattern.rows]), t(pattern.cols)]
    return (vals + vals_t) / 2.0
