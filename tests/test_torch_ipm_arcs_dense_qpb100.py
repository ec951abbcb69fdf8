"""The port's series arcs on a dense QP: the sweep fixture QPB100 read by
``read_qp`` in both packages, for every (arc, order) of
tests/test_ipm.py::TestTaylorArc (one file per fixture, so that the two
run on two workers).

What is held (``check_dense_fixture_arc``): the same status and the SAME
iteration count as the JAX package, the objective within 1e-8 relative and
x within 1e-6."""
import pytest

from _torch_port_helpers import ARC_CASES, check_dense_fixture_arc, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arc,order", ARC_CASES)
def test_qpb100_matches_reference(arc, order):
    check_dense_fixture_arc("QPB100", arc, order)
