"""The port's banded IPM (qp/ipm_banded.py: ``ipm_solve_banded`` and
``ipm_solve_banded_compiled`` over the block-tridiagonal factorization of
linalg/banded.py, whose plain versions run on the CPU) against the JAX
package's ``ipm_solve_banded`` on the same problems.

The cases are those of tests/test_ipm_banded.py:63-128, one per KKT mode and
size: the LP at n = 24 (banded Schur complement), the banded QP at n = 24
(PCG on S), the bound-constrained banded H at n = 30 (block Cholesky of G),
the LP at n = 20 that the JAX test solves compiled and by the host loop, and
the LP at n = 400 with seed 3.  What is held on each: the port's host loop
and its compiled solve give the JAX package's status and iteration count,
and x, y, z and the objective within 1e-7 absolute (the JAX refinement
carries double-word pairs, the port's refines in float64: that tolerance
covers the difference); status 0 and the residuals of the state within the
stop tolerances.  The banded step makes no host read in any mode, and a step
on a halted state changes no bit."""
import dataclasses

import numpy as np
import pytest
import torch

from galahad_tpu.qp import ipm_banded as j_banded

from galahad_tpu_torch.core.problem import classify_bounds
from galahad_tpu_torch.qp import ipm as t_ipm
from galahad_tpu_torch.qp import ipm_banded as t_banded

from _torch_port_helpers import (banded_pair, banded_problem_fields,  # noqa: F401
                                 check_same_banded_solve, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def bound_constrained_fields():
    """tests/test_ipm_banded.py::test_bound_constrained_banded_h: m = 0."""
    n = 30
    f = banded_problem_fields(n, m=0, h_tridiagonal=True)
    f["g"] = np.full(n, -1.0)
    return f


CASES = {
    "lp_n24": lambda: banded_problem_fields(24, lp=True),
    "qp_n24_pcg": lambda: banded_problem_fields(24, lp=False),
    "bound_constrained_n30": bound_constrained_fields,
    "lp_n20_compiled": lambda: banded_problem_fields(20, lp=True),
    "lp_n400_seed3": lambda: banded_problem_fields(400, lp=True, seed=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_banded_solve_matches_reference(case):
    jq, tq = banded_pair(CASES[case]())
    jsolve = (j_banded.ipm_solve_banded_compiled if case == "lp_n20_compiled"
              else j_banded.ipm_solve_banded)(jq)
    st = check_same_banded_solve(jsolve, jq, t_banded.ipm_solve_banded(tq))
    assert st.status == 0 and st.run.path == "direct"
    ctl = t_ipm.IPMControl()
    assert st.res_p <= ctl.stop_abs_p and st.res_d <= ctl.stop_abs_d
    assert st.res_c <= ctl.stop_abs_c
    sc = check_same_banded_solve(jsolve, jq, t_banded.ipm_solve_banded_compiled(tq))
    assert sc.status == 0 and sc.inform is None


HOST_READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__float__", "__int__")


@pytest.mark.parametrize("case", ["lp_n24", "qp_n24_pcg", "bound_constrained_n30"])
def test_the_banded_step_makes_no_host_read(monkeypatch, case):
    """Every way a tensor reaches the host raises while the banded step runs,
    in each of the three KKT modes (a CUDA graph could not capture it)."""
    _, tq = banded_pair(CASES[case]())
    masks = classify_bounds(tq)
    ctl = t_ipm.IPMControl()
    st = t_ipm.ipm_init(tq, masks, ctl)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read (or a copy from the host) inside the step")

    with monkeypatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse)
        for name in ("tensor", "as_tensor"):
            mp.setattr(torch, name, refuse)
        for _ in range(2):
            st = t_ipm.ipm_step(tq, masks, st, ctl)
    assert int(st.iter) == 2


def bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def test_a_banded_step_on_a_halted_state_is_a_no_op():
    _, tq = banded_pair(CASES["lp_n24"]())
    masks = classify_bounds(tq)
    ctl = t_ipm.IPMControl()
    st = t_ipm.ipm_init(tq, masks, ctl)
    st = t_ipm.ipm_step(tq, masks, st, ctl)
    st = dataclasses.replace(st, halt=torch.tensor(True))
    again = t_ipm.ipm_step(tq, masks, st, ctl)
    for name in t_ipm.TENSOR_FIELDS:
        assert torch.equal(bits(getattr(again, name)), bits(getattr(st, name))), name


def test_the_banded_solvers_refuse_other_problems():
    from galahad_tpu_torch import make_qp

    qp = make_qp(g=np.zeros(3), device="cpu")
    for solver in (t_banded.ipm_solve_banded, t_banded.ipm_solve_banded_compiled):
        with pytest.raises(TypeError, match="BandedQP"):
            solver(qp)


def test_bad_banded_input_returns_a_banded_scaffold():
    f = banded_problem_fields(10, lp=True)
    f["x_l"] = np.full(10, 3.0)                 # x_l > x_u
    _, tq = banded_pair(f)
    x, y, z, st = t_banded.ipm_solve_banded(tq)
    assert st.status == -4 and st.iter == 0
    assert x.shape == (10,) and y.shape == (8,)
