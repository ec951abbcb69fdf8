"""The port's side of a sparse QP family: the ``SparseQP`` of the first
request, built once (its ``COOPattern`` objects, and so the analysed KKT plan,
are shared by every later request), each request's QP with the new values in
it, and how many kernel calls make one factorization and one solve."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from galahad_tpu_torch import make_sparse_qp


def _big(v):
    """Infinite bounds as the port's infinity (1e20)."""
    return np.where(np.isinf(v), np.sign(v) * 1e20, v)


def base_problem(st: dict, vals: dict, dtype: torch.dtype, device):
    """The first request's ``SparseQP`` in ``dtype`` on ``device``."""
    a_coo = (st["a_rows"], st["a_cols"], vals["a_vals"].cpu().numpy()) if st["m"] else None
    return make_sparse_qp(
        st["n"], st["m"], h_coo=(st["h_rows"], st["h_cols"], st["h_vals"]), a_coo=a_coo,
        g=vals["g"].cpu().numpy(), c_l=_big(st["c_l"]), c_u=_big(st["c_u"]),
        x_l=_big(st["x_l"]), x_u=_big(st["x_u"]), dtype=dtype, device=device)


def request_problem(base, vals: dict):
    """``base`` with one request's values: the same pattern objects."""
    dt = base.g.dtype
    return dataclasses.replace(base, **{k: v.to(dt) for k, v in vals.items()})


def analyse(qp) -> None:
    """The symbolic analysis of the KKT pattern, which the port caches per
    pattern pair (set-up: every request reuses it)."""
    from galahad_tpu_torch.linalg.sbls import sparse_kkt_plan

    sparse_kkt_plan(qp.h_pat, qp.a_pat, qp.n)


def calls_per(qp) -> dict:
    """Calls of the wide-front factor kernel in one factorization and of each
    sweep in one solve: the analysed plan's levels that hold a front wider
    than the small-front kernel's largest, and all its levels.  Only counts,
    which turn the launch counters into factorizations and solves; the work
    these need comes from the family's ``kernel_shapes``.  ``plan``: the
    plan's own size, for the log only."""
    from galahad_tpu_torch.linalg.ldlt_kernels import MAX_KERNEL_FRONT
    from galahad_tpu_torch.linalg.sbls import sparse_kkt_plan

    plan = sparse_kkt_plan(qp.h_pat, qp.a_pat, qp.n).sym
    wide = {grp.level for grp in plan.groups if grp.Fpad > MAX_KERNEL_FRONT}
    return dict(ldlt_wide=len(wide), sweep=len({grp.level for grp in plan.groups}),
                plan=dict(nnz_L=int(plan.nnz_L), flops=float(plan.flops), store=int(plan.S)))
