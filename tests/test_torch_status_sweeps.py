"""The per-solver error-status sweeps of tests/test_status_sweeps.py, run on
the port (on the CPU) and on the JAX package with the same inputs.

Every case forces one documented error status (the reference unit testers'
error-exit sections, e.g. src/cqp/cqpt.f90:45-70): bad bounds (-4) and bad
dimensions (-3) for cqp, dqp, qpa, qpb and lpa; a primal infeasible QP (-5);
an unbounded LP (-7, LPA's certificate); the iteration cap (-18); the clock
limit (-19); an unknown solver and an unknown SLS backend (ValueError); a
degenerate vertex that stalls the raw IPM (-13).  What is held: the port's
status equals the JAX package's, and both equal the status the original test
asks for (or both raise ValueError).
"""
import numpy as np
import pytest

from galahad_tpu.core.problem import INFINITY
from galahad_tpu.core.status import Status

INF = 2 * INFINITY
REPO_FIXTURE = "examples/sweep/QPDEGEN.qplib"


def _arrays(n=4, m=2, **over):
    rng = np.random.default_rng(0)
    B = rng.normal(size=(n, n))
    base = dict(H=B @ B.T + np.eye(n), g=rng.normal(size=n), A=rng.normal(size=(m, n)),
                c_l=np.full(m, -1.0), c_u=np.full(m, 1.0), x_l=np.zeros(n), x_u=np.ones(n))
    base.update(over)
    return base


def _jax_qp(arrays):
    import jax.numpy as jnp

    from galahad_tpu.core.problem import QP

    a = dict(arrays)
    kind = a.pop("h_kind", "dense")
    return QP(**{k: None if v is None else jnp.asarray(v) for k, v in a.items()}, h_kind=kind)


def _port_qp(arrays):
    from galahad_tpu_torch import make_qp

    return make_qp(**arrays, device="cpu")


def _jax_solve(solver, qp, **ctl):
    from galahad_tpu.qp import IPMControl, ipm_solve

    if solver == "cqp":
        return ipm_solve(qp, IPMControl(**ctl))[3]
    if solver == "dqp":
        from galahad_tpu.qp.dqp import dqp_solve

        return dqp_solve(qp)
    if solver == "qpa":
        from galahad_tpu.qp.qpa import qpa_solve

        return qpa_solve(qp)
    if solver == "qpb":
        from galahad_tpu.qp.qpb import qpb_solve

        return qpb_solve(qp)
    from galahad_tpu.qp.lpa import lpa_solve

    return lpa_solve(qp)


def _port_solve(solver, qp, **ctl):
    from galahad_tpu_torch.qp import IPMControl, ipm_solve

    if solver == "cqp":
        return ipm_solve(qp, IPMControl(**ctl))[3]
    if solver == "dqp":
        from galahad_tpu_torch.qp.dqp import dqp_solve

        return dqp_solve(qp)
    if solver == "qpa":
        from galahad_tpu_torch.qp.qpa import qpa_solve

        return qpa_solve(qp)
    if solver == "qpb":
        from galahad_tpu_torch.qp.qpb import qpb_solve

        return qpb_solve(qp)
    from galahad_tpu_torch.qp.lpa import lpa_solve

    return lpa_solve(qp)


def _statuses(solver, arrays, **ctl):
    """(JAX status, port status) of ``solver`` on the same arrays."""
    jax_st = int(_jax_solve(solver, _jax_qp(arrays), **ctl).status)
    port_st = int(_port_solve(solver, _port_qp(arrays), **ctl).status)
    return jax_st, port_st


BAD_BOUNDS = {
    "x": dict(x_l=np.ones(4), x_u=np.zeros(4)),              # x_l > x_u
    "c": dict(c_l=np.ones(2), c_u=np.full(2, -1.0)),         # c_l > c_u
}
QP_SOLVERS = ["cqp", "dqp", "qpa", "qpb", "lpa"]


@pytest.mark.parametrize("which", sorted(BAD_BOUNDS))
@pytest.mark.parametrize("solver", QP_SOLVERS)
def test_bad_bounds_minus4(solver, which):
    jax_st, port_st = _statuses(solver, _arrays(**BAD_BOUNDS[which]))
    assert port_st == jax_st == int(Status.BAD_BOUNDS), (solver, jax_st, port_st)


@pytest.mark.parametrize("solver", QP_SOLVERS)
def test_bad_dimensions_minus3(solver):
    # A with the wrong number of columns -> RESTRICTIONS
    jax_st, port_st = _statuses(solver, _arrays(A=np.ones((2, 3))))
    assert port_st == jax_st == int(Status.RESTRICTIONS), (solver, jax_st, port_st)


def test_primal_infeasible_minus5():
    """Contradictory linear constraints: x0 + x1 + x2 + x3 <= -1 with x >= 0."""
    arrays = _arrays(m=1, A=np.ones((1, 4)), c_l=np.full(1, -INF), c_u=np.full(1, -1.0),
                     x_l=np.zeros(4), x_u=np.full(4, INF))
    jax_st, port_st = _statuses("cqp", arrays)
    assert port_st == jax_st
    assert port_st in (int(Status.PRIMAL_INFEASIBLE), int(Status.ILL_CONDITIONED))


def test_unbounded_lp_detected():
    """min -sum(x), x >= 0, no upper bounds: LPA certifies unboundedness (-7)."""
    arrays = _arrays(H=None, h_kind="zero", m=1, g=np.full(4, -1.0), A=np.ones((1, 4)),
                     c_l=np.full(1, 1.0), c_u=np.full(1, INF), x_l=np.zeros(4),
                     x_u=np.full(4, INF))
    jax_st, port_st = _statuses("lpa", arrays)
    assert port_st == jax_st == int(Status.UNBOUNDED), (jax_st, port_st)


@pytest.mark.parametrize("ctl, status", [
    (dict(maxit=1), Status.MAX_ITERATIONS),
    (dict(clock_time_limit=1e-9), Status.CPU_LIMIT),
], ids=["max_iterations_minus18", "cpu_limit_minus19"])
def test_ipm_limits(ctl, status):
    jax_st, port_st = _statuses("cqp", _arrays(), **ctl)
    assert port_st == jax_st == int(status), (jax_st, port_st)


def test_unknown_solver_minus26():
    from galahad_tpu.qp.frontend import QPControl as JaxQPControl
    from galahad_tpu.qp.frontend import qp_solve as jax_qp_solve

    from galahad_tpu_torch.qp.frontend import QPControl, qp_solve

    with pytest.raises(ValueError):
        jax_qp_solve(_jax_qp(_arrays()), JaxQPControl(quadratic_programming_solver="nope"))
    with pytest.raises(ValueError):
        qp_solve(_port_qp(_arrays()), QPControl(quadratic_programming_solver="nope"))


def test_sls_unknown_backend():
    import jax.numpy as jnp
    import torch

    from galahad_tpu.linalg.sls import SLSControl as JaxSLSControl
    from galahad_tpu.linalg.sls import sls_factorize as jax_sls_factorize

    from galahad_tpu_torch.linalg.sls import SLSControl, sls_factorize

    with pytest.raises(ValueError):
        jax_sls_factorize(jnp.eye(3), JaxSLSControl(solver="does-not-exist"))
    with pytest.raises(ValueError):
        sls_factorize(torch.eye(3, dtype=torch.float64), SLSControl(solver="does-not-exist"),
                      device="cpu")


def test_tiny_step_reported():
    """A fully degenerate vertex stalls the raw IPM with -13 (rescued at the
    qp_solve level, but the raw code must stay honest)."""
    from galahad_tpu.io import qplib
    from galahad_tpu.qp import IPMControl as JaxIPMControl
    from galahad_tpu.qp import ipm_solve as jax_ipm_solve

    from galahad_tpu_torch.io.qplib import read_qp
    from galahad_tpu_torch.qp import IPMControl, ipm_solve

    jax_st = jax_ipm_solve(qplib.read_qp(REPO_FIXTURE), JaxIPMControl())[3]
    port_st = ipm_solve(read_qp(REPO_FIXTURE, device="cpu"), IPMControl())[3]
    assert int(port_st.status) == int(jax_st.status)
    assert int(jax_st.iter) == int(port_st.iter)
    assert int(port_st.status) in (int(Status.TINY_STEP), int(Status.MAX_ITERATIONS))
