"""Stochastic multistart global optimization in a box (BGO).

Counterpart of galahad_tpu/go/bgo.py (GALAHAD's BGO, reference
src/bgo/bgo.f90: BGO_solve :653, random multistart + TRB local
minimization).  The JAX package vmaps ``trb_solve`` over the Latin-hypercube
starts; here the starts are one batched ``trb_solve`` of x0 (attempts, n):
each start is masked and stops at its own convergence, and each pass makes
one launch of the secular kernel (row 6a) for the whole batch.  The best
start is chosen by ``argmin`` on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.config import control as control_dc
from ..nlp.tru import TRBControl, trb_solve
from ..tr.trs import as_tensors
from .lhs import lhs_sample_box


@control_dc
class BGOControl:
    attempts: int = 16              # multistart batch size
    maxit_local: int = 100
    stop_g_absolute: float = 1.0e-6
    random_seed: int = 0
    include_given_start: bool = True


@dataclasses.dataclass
class BGOInfo:
    """The JAX package's fields; ``host_reads`` the batched TRB's."""

    x: Any
    f: Any
    norm_pg: Any
    starts_converged: Any
    host_reads: int = 0


def _multistart(objective: Callable, starts, x_l, x_u, ctl: BGOControl) -> BGOInfo:
    """TRB from every row of ``starts`` (attempts, n) at once; the best."""
    st = trb_solve(objective, starts, x_l, x_u,
                   TRBControl(maxit=ctl.maxit_local, stop_g_absolute=ctl.stop_g_absolute))
    ibest = torch.argmin(st.f).reshape(1)
    return BGOInfo(x=st.x.index_select(0, ibest)[0], f=st.f.index_select(0, ibest)[0],
                   norm_pg=st.norm_g.index_select(0, ibest)[0],
                   starts_converged=st.converged.sum(), host_reads=st.host_reads)


def bgo_solve(objective: Callable, x_l, x_u, x0=None, ctl: BGOControl = BGOControl(),
              device=None) -> BGOInfo:
    """Approximate global minimum of ``objective`` on [x_l, x_u] (numpy goes
    to ``resolve_device(device)``): ``ctl.attempts`` Latin-hypercube starts
    drawn from a host generator seeded with ``ctl.random_seed``, the first
    replaced by x0 (clipped into the box) where given."""
    x_l, x_u = as_tensors(x_l, x_u, device=device)
    starts = lhs_sample_box(torch.Generator().manual_seed(ctl.random_seed), ctl.attempts,
                            x_l, x_u)
    if x0 is not None and ctl.include_given_start:
        (x0,) = as_tensors(x0, device=x_l.device)
        starts[0] = torch.minimum(torch.maximum(x0.to(x_l.dtype), x_l), x_u)
    return _multistart(objective, starts, x_l, x_u, ctl)
