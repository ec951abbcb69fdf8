"""The port's series arcs on the 20x20 grid QP (n = 400, m = 200), one case
per arc, against the JAX package: the same status and iteration count, the
objective within 1e-8 relative and x within 1e-6."""
import pytest

from galahad_tpu.qp import ipm as j_ipm

from galahad_tpu_torch.qp import ipm as t_ipm

from _torch_port_helpers import (arc_controls, check_same_solve, one_torch_thread,  # noqa: F401
                                 sparse_grid_pair)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_PAIR = []


@pytest.mark.parametrize("arc,order", [("taylor", 4), ("puiseux", 3), ("zhao_sun", 3)])
def test_grid20_matches_reference(arc, order):
    if not _PAIR:
        _PAIR.append(sparse_grid_pair(20))
    jq, tq = _PAIR[0]
    jctl, ctl = arc_controls(arc, order)
    st = check_same_solve(j_ipm.ipm_solve(jq, jctl), t_ipm.ipm_solve(tq, ctl))
    assert st.status == 0
