"""Filter trust-region method for nonlinear feasibility / least squares
(FILTRANE) and the filter acceptance mechanism (FILTER).

Counterpart of galahad_tpu/nlp/filtrane.py (GALAHAD's FILTRANE, reference
src/filtrane/filtrane.f90, and FILTER, src/filter/filter.f90): find x
(within bounds, kept by projection) with c_l <= c(x) <= c_u by decreasing
the violation r(x) = c(x) - clip(c(x), c_l, c_u).

Gauss-Newton trust-region steps on 1/2 ||r||^2: J by ``torch.func.jacfwd``,
the exact TRS on J'J (tr/trs.py: ``eigh``, then the secular kernel of row
6a on the card), accepted by the classical ratio test or by the filter, a
fixed-capacity pair of tensors (theta_inf, theta_2) whose acceptance test is
one masked comparison (the reference grows a linked list).  The outer loop
runs on the host, as in the JAX package, and reads the host once per
iteration: the predicted decrease, the trial's two measures and the filter's
verdict come back in one transfer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.func import jacfwd

from .._device import resolve_device
from ..core.config import control as control_dc
from ..core.problem import INFINITY
from ..core.status import Status
from ..tr.trs import as_tensors, trs_solve
from .lancelot import clip


@control_dc
class FiltraneControl:
    maxit: int = 100
    stop_c: float = 1.0e-8            # feasibility tolerance on theta_2
    initial_radius: float = 1.0
    filter_capacity: int = 40
    gamma_filter: float = 1.0e-4      # filter margin
    eta_successful: float = 0.01
    infinity: float = INFINITY


@dataclasses.dataclass
class Filter:
    """Fixed-capacity (theta_inf, theta_2) dominance filter: two (cap,)
    tensors and ``count`` a 0-d int32 tensor, the pairs ever added."""

    theta_inf: Any
    theta_2: Any
    count: Any
    cap: int = 0


def filter_init(cap: int, dtype=torch.float64, device=None) -> Filter:
    """An empty filter on ``resolve_device(device)``."""
    device = resolve_device(device)
    return Filter(theta_inf=torch.full((cap,), torch.inf, dtype=dtype, device=device),
                  theta_2=torch.full((cap,), torch.inf, dtype=dtype, device=device),
                  count=torch.zeros((), dtype=torch.int32, device=device), cap=cap)


def filter_acceptable(f: Filter, t_inf, t_2, gamma):
    """A 0-d bool: the point improves on EVERY filter entry in at least one
    measure, by the margin gamma (reference filter.f90 acceptance)."""
    active = torch.arange(f.cap, device=f.theta_inf.device) < f.count
    dominates = (t_inf >= (1 - gamma) * f.theta_inf) & (t_2 >= (1 - gamma) * f.theta_2)
    return ~torch.any(active & dominates)


def filter_add(f: Filter, t_inf, t_2) -> Filter:
    """Insert a pair into slot ``count % cap`` (a ring overwrite when full) by
    a masked write, so the slot stays on the device; ``count`` saturates at
    2^30."""
    slot = torch.arange(f.cap, device=f.theta_inf.device) == torch.remainder(f.count, f.cap)
    return dataclasses.replace(
        f, theta_inf=torch.where(slot, t_inf, f.theta_inf),
        theta_2=torch.where(slot, t_2, f.theta_2),
        count=torch.clamp(f.count + 1, max=2 ** 30))


@dataclasses.dataclass
class FiltraneInfo:
    """The JAX package's fields; ``host_reads`` the outer loop's reads."""

    x: Any
    theta: Any          # final 1/2||r||^2
    iter: Any
    converged: Any
    status: Any
    host_reads: int = 0


def _inf_norm(r):
    """max |r| (0 for an empty r), as a 0-d tensor."""
    if r.numel() == 0:
        return torch.zeros((), dtype=r.dtype, device=r.device)
    return r.abs().max()


def filtrane_solve(constraints: Callable, x0, c_l, c_u, x_l=None, x_u=None,
                   ctl: FiltraneControl = FiltraneControl(), device=None) -> FiltraneInfo:
    """Find a feasible point of c_l <= c(x) <= c_u (+ optional bounds on x,
    enforced by projection) from x0 (n,)."""
    x, c_l, c_u, x_l, x_u = as_tensors(x0, c_l, c_u, x_l, x_u, device=device)
    dt, dev = x.dtype, x.device
    n = x.shape[-1]
    lo = x_l if x_l is not None else torch.full((n,), -2 * ctl.infinity, dtype=dt, device=dev)
    hi = x_u if x_u is not None else torch.full((n,), 2 * ctl.infinity, dtype=dt, device=dev)

    def viol(xv):
        c = constraints(xv)
        return c - clip(c, c_l, c_u)

    def theta2(xv):
        r = viol(xv)
        return 0.5 * torch.sum(r * r)

    def gn_step(xv, radius):
        r = viol(xv)
        J = jacfwd(viol)(xv)
        tr = trs_solve(J.T @ J, J.T @ r, radius)
        return tr.x, -tr.obj

    filt = filter_init(ctl.filter_capacity, dt, dev)
    radius = float(ctl.initial_radius)
    status = int(Status.MAX_ITERATIONS)
    it = 0
    th2 = float(theta2(x))
    reads = 1
    for it in range(1, ctl.maxit + 1):
        if th2 <= ctl.stop_c:
            status = int(Status.OK)
            break
        s, pred_t = gn_step(x, radius)
        x_trial = clip(x + s, lo, hi)
        r_t = viol(x_trial)
        th2_t_t = 0.5 * torch.sum(r_t * r_t)
        thinf_t_t = _inf_norm(r_t)
        acceptable = filter_acceptable(filt, thinf_t_t, th2_t_t, ctl.gamma_filter)
        pred, th2_t, _, acc = torch.stack(
            [pred_t, th2_t_t, thinf_t_t, acceptable.to(dt)]).tolist()
        reads += 1
        ared = th2 - th2_t
        ratio = ared / max(pred, 1e-300)
        ok_ratio = ratio >= ctl.eta_successful and pred > 0
        ok_filter = acc > 0 and th2_t < th2
        if ok_ratio or ok_filter:
            if not ok_ratio:
                # filter-only acceptance: record the OLD point in the filter
                # (standard filter bookkeeping)
                filt = filter_add(filt, _inf_norm(viol(x)),
                                  torch.full((), th2, dtype=dt, device=dev))
            x = x_trial
            th2 = th2_t
            radius = min(radius * 2.0, 1e10) if ratio > 0.9 else radius
        else:
            radius = max(radius * 0.25, 1e-12)
    else:
        it = ctl.maxit
    if th2 <= ctl.stop_c:
        status = int(Status.OK)

    return FiltraneInfo(
        x=x, theta=torch.full((), th2, dtype=dt, device=dev),
        iter=torch.full((), it, dtype=torch.int32, device=dev),
        converged=torch.full((), status == int(Status.OK), dtype=torch.bool, device=dev),
        status=torch.full((), status, dtype=torch.int32, device=dev), host_reads=reads)
