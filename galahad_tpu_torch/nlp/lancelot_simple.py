"""One-call dense LANCELOT wrapper.

Counterpart of galahad_tpu/nlp/lancelot_simple.py (GALAHAD's lancelot_simple,
reference src/lancelot_simple/: a flat entry point over LANCELOT B for small
dense problems): one function of plain callables and arrays; derivatives
come from ``torch.func``, the first ``c_eq`` constraints are equalities
( = 0 ) and the rest inequalities ( <= 0 ), and the default controls are
nlp/lancelot.py's.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..tr.trs import as_tensors
from .lancelot import LancelotControl, LancelotInfo, lancelot_solve


def lancelot_simple(objective: Callable, x0, constraints: Callable | None = None,
                    c_eq: int = 0, x_l=None, x_u=None, maxit: int = 100,
                    device=None) -> LancelotInfo:
    """Minimize ``objective`` with optional constraints: constraints(x) is a
    vector whose first ``c_eq`` components are equalities ( = 0 ) and the rest
    inequalities ( <= 0 ), the lancelot_simple convention; bounds optional.
    The JAX package's ``c_le`` argument, which nothing reads, is left out."""
    (x0,) = as_tensors(x0, device=device)
    dt, dev = x0.dtype, x0.device
    ctl = LancelotControl(maxit=maxit)
    if constraints is None:
        def cons(x):
            return torch.zeros(0, dtype=x.dtype, device=x.device)

        c_l = torch.zeros(0, dtype=dt, device=dev)
        c_u = torch.zeros(0, dtype=dt, device=dev)
    else:
        m = constraints(x0).shape[-1]
        cons = constraints
        big = 2 * ctl.infinity
        c_l = torch.where(torch.arange(m, device=dev) < c_eq, 0.0, -big).to(dt)
        c_u = torch.zeros(m, dtype=dt, device=dev)
    return lancelot_solve(objective, cons, x0, c_l, c_u, x_l=x_l, x_u=x_u, ctl=ctl)
