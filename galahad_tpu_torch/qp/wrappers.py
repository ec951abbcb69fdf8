"""Named solvers that restrict the IPM, as the reference's menu has them.

Counterpart of galahad_tpu/qp/wrappers.py:
  * ``lpb_solve``  - LP by primal-dual IPM (reference src/lpb/lpb.f90,
    LPB_solve :1143): the IPM with H == 0;
  * ``dlp_solve``  - LP by dual gradient projection (src/dlp/dlp.f90): DQP
    on the LP regularized with (reg/2)||x||^2;
  * ``bqpb_solve`` - bound-constrained QP by IPM (src/bqpb/bqpb.f90,
    BQPB_solve :599): the IPM with m == 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.problem import QP, make_qp
from .dqp import DQPControl, dqp_solve
from .ipm import IPMControl, ipm_solve


def lpb_solve(qp: QP, ctl: IPMControl = IPMControl()):
    """LP interior-point solve of a dense ``QP``: its Hessian is dropped
    (h_kind "zero", the LPB contract)."""
    return ipm_solve(dataclasses.replace(qp, H=None, h_kind="zero"), ctl)


def dlp_solve(qp: QP, reg: float = 1.0e-6, ctl: DQPControl = DQPControl()):
    """LP by dual projection.  The dual method needs a strictly convex H
    (the dqp.f90 requirement), so the LP is regularized with (reg/2)||x||^2
    (h_kind "diagonal"), the proximal device of the reference's dlp."""
    H = torch.full((qp.n,), reg, dtype=qp.g.dtype, device=qp.g.device)
    return dqp_solve(dataclasses.replace(qp, H=H, h_kind="diagonal"), ctl=ctl)


def bqpb_solve(H, g, x_l, x_u, x0=None, f=0.0, ctl: IPMControl = IPMControl(), *,
               dtype=None, device=None):
    """Bound-constrained QP by IPM (BQPB): the m == 0 path of the IPM.  ``H``
    is (n, n) dense or (n,) diagonal; the arrays go to ``device`` (``None``:
    the CUDA device) in ``dtype`` (``None``: g's type if g is a tensor, else
    float64)."""
    if dtype is None and torch.is_tensor(g):
        dtype = g.dtype
    h_kind = "diagonal" if np.ndim(H) == 1 else "dense"
    n = int(np.shape(g)[0])
    qp = make_qp(g=g, H=H, h_kind=h_kind, A=np.zeros((0, n)), x_l=x_l, x_u=x_u, x=x0, f=f,
                 dtype=dtype, device=device)
    return ipm_solve(qp, ctl)
