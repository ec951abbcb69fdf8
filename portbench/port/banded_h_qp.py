"""The port's side of a banded QP family with a banded H: the ``BandedQP`` of
the first request with H in it.  Each request replaces g and A's values as
in ``banded_qp.py``; H, the pattern and the bounds stay."""
from __future__ import annotations

import torch

from galahad_tpu_torch.qp.ipm_banded import make_banded_qp

from portbench.port.banded_qp import _big, analyse, calls_per, request_problem  # noqa: F401


def base_problem(st: dict, vals: dict, dtype: torch.dtype, device):
    return make_banded_qp(
        g=vals["g"].to(dtype), a_val=vals["a_val"].to(dtype), a_offsets=st["a_offsets"],
        c_l=_big(st["c_l"]), c_u=_big(st["c_u"]), x_l=_big(st["x_l"]), x_u=_big(st["x_u"]),
        h_diags=st["h_diags"], h_kind="banded", block=st["block"], dtype=dtype, device=device)
