"""The port's series arcs step by step against the JAX package's
``ipm_step`` from the same state, on the 6x6 grid QP.

What is held: every iteration of the JAX solve, taken again by the port
from the JAX state before it, gives the same iteration, status and flags,
and iterates within 1e-10 relative (``check_steps_from_reference_states``)."""
import pytest

from _torch_port_helpers import (arc_controls, check_steps_from_reference_states,
                                 one_torch_thread, sparse_grid_pair)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ONE_PER_ARC = [("taylor", 4), ("puiseux", 3), ("zhao_sun", 3)]


@pytest.mark.parametrize("arc,order", ONE_PER_ARC)
def test_each_step_matches_reference_from_the_same_state(arc, order):
    jq, tq = sparse_grid_pair(6)
    js = check_steps_from_reference_states(jq, tq, *arc_controls(arc, order))
    assert bool(js.halt) and int(js.status) == 0
