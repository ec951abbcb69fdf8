"""Deterministic global optimization in a box (DGO).

Counterpart of galahad_tpu/go/dgo.py (GALAHAD's DGO, reference
src/dgo/dgo.f90: DGO_solve :807, branch-and-refine with Lipschitz lower
bounds): DIRECT-style box trisection with an adaptive Lipschitz estimate in
fixed-capacity box arrays (the reference grows a hash of boxes, src/hash),
one box split (two new evaluations) per iteration, then a projected TR
polish from the best center.

The JAX package's ``lax.fori_loop`` of splits is a Python loop of tensor
operations that never reads the host: the chosen box ``j`` and its longest
side ``d`` stay 0-d tensors on the device, and rows are reached by
``index_select`` / ``gather`` / ``index_copy_`` (a 0-d tensor used as an
index would be read on the host).  ``argmin`` / ``argmax`` take the first of
equal values, as ``jnp``'s do; ties are the rule on a cube, where every side
of a box is equal after each trisection.  The host is read only by the final
TRB polish (``DGOInfo.host_reads``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.config import control as control_dc
from ..nlp.tru import TRBControl, trb_solve
from ..tr.trs import as_tensors


@control_dc
class DGOControl:
    maxit: int = 100                   # number of box splits
    lipschitz_inflation: float = 2.0
    maxit_local: int = 50
    stop_g_absolute: float = 1.0e-6


@dataclasses.dataclass
class DGOInfo:
    """The JAX package's fields; ``host_reads`` the polish's (the only ones)."""

    x: Any
    f: Any
    norm_pg: Any
    boxes: Any
    host_reads: int = 0


def dgo_boxes(objective: Callable, x_l, x_u, ctl: DGOControl):
    """The ``ctl.maxit`` box splits from the whole box: centers C, half-widths
    W (cap, n), center values F and the used slots ``valid`` (cap,), cap =
    1 + 2 maxit.  No host read."""
    dt, dev = x_l.dtype, x_l.device
    n = x_l.shape[-1]
    cap = 1 + 2 * ctl.maxit
    C = torch.zeros((cap, n), dtype=dt, device=dev)
    W = torch.zeros((cap, n), dtype=dt, device=dev)
    F = torch.full((cap,), torch.inf, dtype=dt, device=dev)
    valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    # a value written into a card's tensor is a tensor on the card: a Python
    # scalar would be copied from the host, and that copy synchronises
    on = torch.ones((), dtype=torch.bool, device=dev)
    C[0] = 0.5 * (x_l + x_u)
    W[0] = 0.5 * (x_u - x_l)
    F[0] = objective(0.5 * (x_l + x_u))
    valid[0] = on
    cols = torch.arange(n, device=dev)
    for i in range(ctl.maxit):
        k = 1 + 2 * i                       # boxes so far
        # adaptive Lipschitz estimate from the spread of the centers
        fbest = torch.min(torch.where(valid, F, torch.inf))
        r = torch.linalg.vector_norm(torch.where(valid[:, None], W, 0.0), dim=1)
        L = ctl.lipschitz_inflation * torch.max(
            torch.where(valid & (r > 1e-14), (F - fbest) / torch.clamp(r, min=1e-14), 0.0)
        ) + 1e-8
        # the box with the smallest Lipschitz lower bound, trisected along its
        # longest side
        lb = torch.where(valid, F - L * r, torch.inf)
        j = torch.argmin(lb).reshape(1)
        wj = W.index_select(0, j)[0]
        cj = C.index_select(0, j)[0]
        d = torch.argmax(wj).reshape(1)
        e = (cols == d).to(dt)
        wd = wj.gather(0, d)[0]
        shift = (2.0 / 3.0) * wd * e
        c_minus = cj - shift
        c_plus = cj + shift
        w_new = wj - (2.0 / 3.0) * wd * e
        C[k] = c_minus
        C[k + 1] = c_plus
        W.index_copy_(0, j, w_new[None])
        W[k] = w_new
        W[k + 1] = w_new
        F[k] = objective(c_minus)
        F[k + 1] = objective(c_plus)
        valid[k:k + 2] = on
    return C, W, F, valid


def dgo_solve(objective: Callable, x_l, x_u, ctl: DGOControl = DGOControl(),
              device=None) -> DGOInfo:
    """Deterministic global minimization on [x_l, x_u] (numpy goes to
    ``resolve_device(device)``)."""
    x_l, x_u = as_tensors(x_l, x_u, device=device)
    C, W, F, valid = dgo_boxes(objective, x_l, x_u, ctl)
    Fv = torch.where(valid, F, torch.inf)
    ibest = torch.argmin(Fv).reshape(1)
    c_best, f_best = C.index_select(0, ibest)[0], Fv.index_select(0, ibest)[0]
    st = trb_solve(objective, c_best, x_l, x_u,
                   TRBControl(maxit=ctl.maxit_local, stop_g_absolute=ctl.stop_g_absolute))
    better = st.f <= f_best
    return DGOInfo(x=torch.where(better, st.x, c_best), f=torch.where(better, st.f, f_best),
                   norm_pg=st.norm_g, boxes=valid.sum(), host_reads=st.host_reads)
