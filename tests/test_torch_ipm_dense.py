"""The port's IPM on dense QPs (``make_qp``; the KKT solve by SBLS's Schur
complement, linalg/sbls.py, or by Cholesky without constraints) against the
JAX package's on the same numpy-seeded problems.

What is held, on every case: the same status and the same iteration count
as the JAX package; where the status is 0, the objective within 1e-8
relative and x within 1e-6.  Cases: tests/test_ipm.py::random_convex_qp
seeds 0-2 with and without equality rows, an LP (``h_kind="zero"``), a
diagonal H, and m = 0 with a dense and with a diagonal H."""
import numpy as np
import pytest

from galahad_tpu.qp import ipm as j_ipm

from galahad_tpu_torch.qp import ipm as t_ipm

from _torch_port_helpers import (check_same_solve, dense_pair, one_torch_thread,  # noqa: F401
                                 random_convex_qp_arrays)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def diagonal_qp(m, seed):
    """A separable QP: diagonal H (``h_kind="diagonal"``) with random
    inequality rows."""
    a = random_convex_qp_arrays(12, m, seed)
    a["H"] = np.random.default_rng(seed + 100).uniform(0.5, 2.0, 12)
    a["h_kind"] = "diagonal"
    return a


CASES = {
    **{f"random_s{s}_eq{e}": (lambda s=s, e=e: random_convex_qp_arrays(10, 6, s, equalities=e))
       for s in (0, 1, 2) for e in (0, 3)},
    "lp": lambda: random_convex_qp_arrays(10, 6, 4, lp=True),
    "diagonal": lambda: diagonal_qp(6, 5),
    "m0_dense": lambda: random_convex_qp_arrays(10, 0, 6),
    "m0_diagonal": lambda: diagonal_qp(0, 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_solve_matches_reference(case):
    jq, tq = dense_pair(CASES[case]())
    st = check_same_solve(j_ipm.ipm_solve(jq, j_ipm.IPMControl()),
                          t_ipm.ipm_solve(tq, t_ipm.IPMControl()))
    assert st.status == 0
    assert st.run.escalations == 0 and st.run.path == "direct"
