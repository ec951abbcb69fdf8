"""The port's side of a banded QP family: the ``BandedQP`` of the first
request and each request's QP with the new values."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from galahad_tpu_torch.qp.ipm_banded import make_banded_qp


def _big(v):
    """Infinite bounds as the port's infinity (1e20)."""
    return np.where(np.isinf(v), np.sign(v) * 1e20, v)


def base_problem(st: dict, vals: dict, dtype: torch.dtype, device):
    return make_banded_qp(
        g=vals["g"].to(dtype), a_val=vals["a_val"].to(dtype), a_offsets=st["a_offsets"],
        c_l=_big(st["c_l"]), c_u=_big(st["c_u"]), x_l=_big(st["x_l"]), x_u=_big(st["x_u"]),
        block=st["block"], dtype=dtype, device=device)


def request_problem(base, vals: dict):
    dt = base.g.dtype
    return dataclasses.replace(base, g=vals["g"].to(dt),
                               A_band=dataclasses.replace(base.A_band, val=vals["a_val"].to(dt)))


def analyse(qp) -> None:
    """A banded problem has no symbolic phase."""


def calls_per(qp) -> dict:
    """The banded factor is one launch a factorization: nothing to count."""
    return {}
