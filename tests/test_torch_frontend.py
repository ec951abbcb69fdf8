"""The port's QP front end (galahad_tpu_torch/qp/frontend.py: ``qp_solve``,
``lsqp_solve``, ``wcp_solve``, ``l1qp_solve``) against the JAX package's on
the same numpy-seeded problems.

What is held, on every case: the same status and iteration count as the JAX
package (its ``IPMState`` or ``DQPInfo``), the objective within 1e-8 relative
and x within 1e-6 (where the IPM answered) or 1e-8 relative (where DQP
did).  Cases: each ported solver (cqp, dqp, ccqp, lpb) on one dense QP or LP,
cqp with scaling, with the masking presolve and with the reducing presolve
(and all three on DQP), a small ``SparseQP`` (solved and stalled: the rescue
is skipped and the result is ``ipm_solve``'s, bit for bit), a ``BandedQP``
(``ipm_solve``'s bits), LSQP, WCP and
L1QP (tests/test_constrained.py's feasible and infeasible cases), and the
qpa, qpb, qpc, lpa and crossover branches (status, iterations, objective).
Only dense QPs take those branches, and ``QPInfo`` reads the same on every
branch."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from galahad_tpu.core.problem import INFINITY, QP as JQP
from galahad_tpu.core.sparse import make_sparse_qp as j_make_sparse
from galahad_tpu.qp import frontend as j_fe
from galahad_tpu.qp.dqp import DQPInfo as JDQPInfo
from galahad_tpu.qp.ipm import IPMControl as JIPMControl

from galahad_tpu_torch import make_qp, make_sparse_qp
from galahad_tpu_torch.convert import banded_qp_from_numpy
from galahad_tpu_torch.io.qplib import read_qp
from galahad_tpu_torch.qp import frontend as t_fe
from galahad_tpu_torch.qp.ipm import IPMControl, IPMInform, ipm_solve

from _torch_port_helpers import (banded_problem_fields, dense_pair, grid_qp_arrays,  # noqa: F401
                                 one_torch_thread, random_convex_qp_arrays)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QP_ARRAYS = random_convex_qp_arrays(10, 6, 1, equalities=3)
LP_ARRAYS = random_convex_qp_arrays(10, 6, 4, lp=True)
_PAIRS = {}


def pair(which):
    if which not in _PAIRS:
        _PAIRS[which] = dense_pair(QP_ARRAYS if which == "qp" else LP_ARRAYS)
    return _PAIRS[which]


def check_front(jres, tres, dqp_answered):
    xj, _, _, ij = jres
    xt, yt, zt, it = tres
    assert isinstance(it, t_fe.QPInfo)
    assert isinstance(ij, JDQPInfo) == dqp_answered == (it.solver == "dqp")
    assert (it.status, it.iter) == (int(ij.status), int(ij.iter))
    obj_j = float(ij.obj) if dqp_answered else float(ij.inform.obj)
    assert abs(it.obj - obj_j) <= 1e-8 * max(1.0, abs(obj_j))
    xj = np.asarray(xj)
    tol = 1e-8 * max(1.0, np.abs(xj).max()) if dqp_answered else 1e-6
    assert np.abs(xj - xt.numpy()).max() <= tol
    assert xt.shape == (QP_ARRAYS["g"].size,) and zt.shape == xt.shape
    if dqp_answered:
        assert it.dqp is not None and it.inform is None
    else:
        assert isinstance(it.inform, IPMInform) and it.ipm.inform is it.inform
    return it


BRANCHES = {   # (problem, control fields, whether DQP answers)
    "cqp": ("qp", dict(), False),
    "cqp_scaled": ("qp", dict(scale=1), False),
    "cqp_presolve": ("qp", dict(presolve_problem=True), False),
    "cqp_reduce": ("qp", dict(presolve_reduce=True), False),
    "dqp": ("qp", dict(quadratic_programming_solver="dqp"), True),
    "dqp_scaled_reduced": ("qp", dict(quadratic_programming_solver="dqp", scale=1,
                                      presolve_reduce=True), True),
    "ccqp": ("qp", dict(quadratic_programming_solver="ccqp", presolve_problem=True), True),
    "lpb": ("lp", dict(quadratic_programming_solver="lpb"), False),
    "lpb_scaled": ("lp", dict(quadratic_programming_solver="lpb", scale=1), False),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_qp_solve_branch(branch):
    which, fields, dqp_answered = BRANCHES[branch]
    jq, tq = pair(which)
    it = check_front(j_fe.qp_solve(jq, j_fe.QPControl(**fields)),
                     t_fe.qp_solve(tq, t_fe.QPControl(**fields)), dqp_answered)
    assert it.status == 0


def test_sparse_qp_skips_the_rescue():
    """On a SparseQP the cqp branch is ipm_solve, bit for bit: solved, and
    stalled at maxit (status -18, where a dense QP would be rescued; the JAX
    package's rescue raises there and is swallowed)."""
    n, m, kw = grid_qp_arrays(6)
    jq, tq = j_make_sparse(n, m, **kw), make_sparse_qp(n, m, device="cpu", **kw)
    for maxit in (200, 3):
        ctl = t_fe.QPControl(ipm=IPMControl(maxit=maxit))
        x, y, z, info = t_fe.qp_solve(tq, ctl)
        xd, yd, zd, sd = ipm_solve(tq, ctl.ipm)
        assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in ((x, xd), (y, yd), (z, zd)))
        assert (info.solver, info.status, info.iter) == ("cqp", sd.status, sd.iter)
        xj, _, _, sj = j_fe.qp_solve(jq, j_fe.QPControl(ipm=JIPMControl(maxit=maxit)))
        assert (info.status, info.iter) == (int(sj.status), int(sj.iter))
        assert info.status == (0 if maxit == 200 else -18)
        assert np.abs(np.asarray(xj) - x.numpy()).max() <= 1e-6


def test_banded_qp_is_ipm_solve():
    """A BandedQP on the cqp branch: ipm_solve's result, bit for bit."""
    tq = banded_qp_from_numpy(banded_problem_fields(40), device="cpu")
    x, y, z, info = t_fe.qp_solve(tq)
    xd, yd, zd, sd = ipm_solve(tq)
    assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in ((x, xd), (y, yd), (z, zd)))
    assert (info.solver, info.status, info.iter) == ("cqp", sd.status, sd.iter)
    assert info.status == 0


@pytest.mark.parametrize("name", ["qpa", "qpb", "qpc", "lpa", "crossover"])
def test_active_set_branches_route_and_answer(name):
    """The branches that raised before the rest of the QP family was ported:
    each routes as the JAX package's ``qp_solve`` does and gives its status,
    iterations and objective (1e-8 relative) on a sweep fixture (QPMAX, the LP
    LPB100 for lpa; on this module's random QP QPB's count parts through
    rounding, tests/test_torch_qp_active.py); ``QPInfo.solver`` names the
    solver that answered."""
    from galahad_tpu.io.qplib import read_qp as j_read_qp

    from _torch_port_helpers import sweep_path

    path = sweep_path("LPB100" if name == "lpa" else "QPMAX")
    jq, tq = j_read_qp(path), read_qp(path, device="cpu")
    ctl = dict(crossover=True) if name == "crossover" else dict(
        quadratic_programming_solver=name)
    xj, _, _, ij = j_fe.qp_solve(jq, j_fe.QPControl(**ctl))
    x, _, _, info = t_fe.qp_solve(tq, t_fe.QPControl(**ctl))
    assert info.solver == ("cqp" if name == "crossover" else name)
    assert (info.status, info.iter) == (int(ij.status), int(ij.iter))
    objj = float(jq.objective(xj))
    assert abs(float(tq.objective(x)) - objj) <= 1e-8 * max(1.0, abs(objj))
    assert (info.cro is not None) == (name == "crossover")


def test_refusals():
    _, tq = pair("qp")
    n, m, kw = grid_qp_arrays(4)
    sq = make_sparse_qp(n, m, device="cpu", **kw)
    for name in ("qpa", "qpb", "qpc", "lpa"):
        with pytest.raises(TypeError, match="dense QP"):
            t_fe.qp_solve(sq, t_fe.QPControl(quadratic_programming_solver=name))
    with pytest.raises(TypeError, match="dense QP"):
        t_fe.qp_solve(sq, t_fe.QPControl(crossover=True))
    with pytest.raises(ValueError, match="unknown QP solver"):
        t_fe.qp_solve(tq, t_fe.QPControl(quadratic_programming_solver="nope"))
    with pytest.raises(TypeError, match="dense QP"):
        t_fe.qp_solve(sq, t_fe.QPControl(scale=1))
    with pytest.raises(TypeError, match="dense QP"):
        t_fe.qp_solve(sq, t_fe.QPControl(quadratic_programming_solver="dqp"))


def test_generate_qplib_file(tmp_path):
    _, tq = pair("qp")
    path = str(tmp_path / "out.qplib")
    x, _, _, info = t_fe.qp_solve(tq, t_fe.QPControl(generate_qplib_file=path))
    back = read_qp(path, device="cpu")
    assert (back.n, back.m) == (tq.n, tq.m)
    xb, _, _, ib = t_fe.qp_solve(back, t_fe.QPControl())
    assert (ib.status, ib.iter) == (info.status, info.iter)
    assert np.abs(xb.numpy() - x.numpy()).max() <= 1e-8


def test_lsqp():
    jq, tq = pair("lp")
    xj, _, _, sj = j_fe.lsqp_solve(jq)
    xt, _, _, st = t_fe.lsqp_solve(tq)
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter)) and st.status == 0
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-6
    with pytest.raises(ValueError, match="separable"):
        t_fe.lsqp_solve(pair("qp")[1])


def test_wcp():
    """tests/test_constrained.py::test_wcp's problem: the same iterations,
    the same centred point, and each active pair inside the band."""
    jq, tq = dense_pair(random_convex_qp_arrays(8, 4, 504))
    ctl = t_fe.WCPControl(mu_target=1.0, gamma_c=0.1)
    xj, _, _, sj = j_fe.wcp_solve(jq, j_fe.WCPControl(mu_target=1.0, gamma_c=0.1))
    xt, _, _, st = t_fe.wcp_solve(tq, ctl)
    assert st.converged and bool(sj.converged)
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter))
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-6
    prods = np.concatenate([((xt - tq.x_l) * st.z_l).numpy(), ((tq.x_u - xt) * st.z_u).numpy()])
    assert prods.min() >= ctl.gamma_c * ctl.mu_target * 0.99
    assert prods.max() <= ctl.mu_target / ctl.gamma_c * 1.01


def test_l1qp_feasible_and_infeasible():
    jq, tq = dense_pair(random_convex_qp_arrays(6, 3, 505))
    xj, _, _, sj = j_fe.l1qp_solve(jq, j_fe.L1QPControl(rho=1e4))
    xt, _, _, st = t_fe.l1qp_solve(tq, t_fe.L1QPControl(rho=1e4))
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter)) and st.status == 0
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-6
    n = 4      # sum(x) >= 2 and sum(x) <= 1: the penalty's minimizer
    A, c_l, c_u = np.ones((2, n)), [2.0, -INFINITY], [INFINITY, 1.0]
    jq = JQP(H=jnp.eye(n), g=jnp.zeros(n), A=jnp.asarray(A), c_l=jnp.asarray(c_l),
             c_u=jnp.asarray(c_u), x_l=jnp.zeros(n), x_u=jnp.ones(n))
    tq = make_qp(H=np.eye(n), g=np.zeros(n), A=A, c_l=c_l, c_u=c_u, x_l=np.zeros(n),
                 x_u=np.ones(n), device="cpu")
    xj, _, _, sj = j_fe.l1qp_solve(jq, j_fe.L1QPControl(rho=10.0))
    xt, _, _, st = t_fe.l1qp_solve(tq, t_fe.L1QPControl(rho=10.0))
    assert st.converged and (st.status, st.iter) == (int(sj.status), int(sj.iter))
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-6


def test_qpinfo_fields():
    assert [f.name for f in dataclasses.fields(t_fe.QPInfo)] == [
        "status", "iter", "obj", "solver", "inform", "ipm", "dqp", "result", "cro"]
