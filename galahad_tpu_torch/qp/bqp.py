"""Bound-constrained convex QP (BQP) and linear least squares (BLLS).

Counterparts of galahad_tpu/qp/bqp.py (GALAHAD's BQP, reference
src/bqp/bqp.f90: BQP_solve :681, gradient projection + subspace CG; BLLS,
src/blls/blls.f90: BLLS_solve :786).  Both are projected trust-region
iterations on a quadratic model: nlp/tru.py's ``trb_solve`` (projected
Cauchy arc + masked exact TRS over the free variables, so the secular
kernel of row 6a on the card), with the QP surface added: explicit (H, g) /
(A, b) data, the duals z and QP-style status.  ``BQPControl`` and
``BLLSControl`` leave out the JAX package's ``infinity`` field, which
nothing reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.config import control as control_dc
from ..nlp.tru import TRBControl, trb_solve
from ..tr.trs import as_tensors


@control_dc
class BQPControl:
    maxit: int = 100
    stop_d: float = 1.0e-8       # projected-gradient stop (dual feasibility)


@dataclasses.dataclass
class BQPInfo:
    """``z`` = Hx + g (BLLS: A'(Ax - b) + weight x) at the solution;
    ``host_reads`` TRB's."""

    x: Any
    z: Any
    obj: Any
    iter: Any
    converged: Any
    status: Any
    norm_pg: Any
    host_reads: int = 0


def _trb(obj, x0, x_l, x_u, maxit, stop_d):
    n = x_l.shape[-1]
    if x0 is None:
        x0 = torch.minimum(torch.maximum(torch.zeros(n, dtype=x_l.dtype, device=x_l.device),
                                         x_l), x_u)
    return trb_solve(obj, x0, x_l, x_u,
                     TRBControl(maxit=maxit, stop_g_absolute=stop_d, stop_g_relative=0.0))


def bqp_solve(H, g, x_l, x_u, x0=None, f=0.0, ctl: BQPControl = BQPControl(),
              device=None) -> BQPInfo:
    """min 1/2 x'Hx + g'x + f  s.t.  x_l <= x <= x_u  (H PSD), from x0 or the
    projection of 0 (numpy goes to ``resolve_device(device)``)."""
    g, H, x_l, x_u, x0 = as_tensors(g, H, x_l, x_u, x0, device=device)

    def obj(x):
        return 0.5 * torch.dot(x, H @ x) + torch.dot(g, x) + f

    st = _trb(obj, x0, x_l, x_u, ctl.maxit, ctl.stop_d)
    return BQPInfo(x=st.x, z=H @ st.x + g, obj=st.f, iter=st.iter, converged=st.converged,
                   status=st.status, norm_pg=st.norm_g, host_reads=st.host_reads)


@control_dc
class BLLSControl:
    maxit: int = 100
    stop_d: float = 1.0e-8
    weight: float = 0.0          # optional ridge term (the reference's regularization)


def blls_solve(A, b, x_l, x_u, x0=None, ctl: BLLSControl = BLLSControl(),
               device=None) -> BQPInfo:
    """min 1/2||Ax - b||^2 + (weight/2)||x||^2  s.t.  x_l <= x <= x_u
    (reference src/blls/blls.f90:786)."""
    A, b, x_l, x_u, x0 = as_tensors(A, b, x_l, x_u, x0, device=device)
    w = ctl.weight

    def obj(x):
        r = A @ x - b
        out = 0.5 * torch.dot(r, r)
        if w > 0:
            out = out + 0.5 * w * torch.dot(x, x)
        return out

    st = _trb(obj, x0, x_l, x_u, ctl.maxit, ctl.stop_d)
    z = A.T @ (A @ st.x - b)
    if w > 0:
        z = z + w * st.x
    return BQPInfo(x=st.x, z=z, obj=st.f, iter=st.iter, converged=st.converged,
                   status=st.status, norm_pg=st.norm_g, host_reads=st.host_reads)
