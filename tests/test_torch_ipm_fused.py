"""The fused IPM iteration of the port (qp/ipm.py, qp/fused.py) on the CPU,
against the JAX package on the same numpy-seeded problems.

The step (``ipm_step``) is the function that the card captures as
a CUDA graph; here it runs directly.  What is held: the step makes no host
read and a solve reads the monitor once per fetch; step by step from the
same state, the JAX package's ``ipm_step`` and the port give the same
status, halt flag and stall count, and iterates and best infeasibility
within 1e-10 relative; the device tail's failure paths (rollback,
infeasibility, TINY_STEP) decide as the JAX tail does; a step on a halted
state changes no bit; ``steps_per_fetch=4`` and ``ipm_solve_compiled`` give
the JAX package's status, iterations and checkpoints, and x within
1e-10."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.core.problem import classify_bounds as j_classify
from galahad_tpu.core.sparse import make_sparse_qp as j_make
from galahad_tpu.io import qplib as j_qplib
from galahad_tpu.qp import ipm as j_ipm

from galahad_tpu_torch import Status, make_sparse_qp
from galahad_tpu_torch.convert import ipm_state_from_numpy
from galahad_tpu_torch.core.problem import classify_bounds
from galahad_tpu_torch.io import qplib as t_qplib
from galahad_tpu_torch.qp import ipm as t_ipm
from galahad_tpu_torch.qp import ipm_solve_compiled
from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve

from _torch_port_helpers import grid_qp_arrays, sweep_path

# the iterate and its double-word low word in the JAX package's state
FOLDED = dict(x="x_lo", c="c_lo", y="y_lo", z_l="zl_lo", z_u="zu_lo",
              y_l="yl_lo", y_u="yu_lo", s_l=None, s_u=None, t_l=None, t_u=None)


def grid_case(k):
    n, m, kw = grid_qp_arrays(k)
    return j_make(n, m, **kw), make_sparse_qp(n, m, device="cpu", **kw)


def fixture_case(name):
    return (j_qplib.read_sparse_qp(sweep_path(name)),
            t_qplib.read_sparse_qp(sweep_path(name), device="cpu"))


def compiled_case():
    """The problem of tests/test_sparse_qp.py::test_sparse_ipm_solve_compiled_while_loop."""
    rng = np.random.default_rng(0)
    n, m = 36, 18
    ii = jj = np.arange(n)
    ar = np.repeat(np.arange(m), 2)
    ac = np.stack([np.arange(m), np.arange(m) + n - m]).T.reshape(-1)
    kw = dict(h_coo=(ii, jj, np.full(n, 2.0)), a_coo=(ar, ac, rng.uniform(0.5, 1.5, 2 * m)),
              g=rng.normal(size=n), c_l=np.full(m, 1.0), c_u=np.full(m, 1e20),
              x_l=np.zeros(n), x_u=np.full(n, 2.0))
    return j_make(n, m, **kw), make_sparse_qp(n, m, device="cpu", **kw)


def to_port(js):
    """The JAX package's state as the port's (scalars as 0-d tensors)."""
    return ipm_state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                                 for f in dataclasses.fields(js)}, device="cpu")


def folded(js, name):
    lo = FOLDED[name]
    v = np.asarray(getattr(js, name), np.float64)
    return v + np.asarray(getattr(js, lo), np.float64) if lo else v


def rel_err(a, b):
    return np.abs(a - b).max() / max(1.0, np.abs(b).max()) if a.size else 0.0


def bits(t):
    t = torch.as_tensor(t)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


# ---------------------------------------------------------------------------
# No host read in the step; one per fetch in the driver
# ---------------------------------------------------------------------------


HOST_READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__float__", "__int__")


@pytest.mark.parametrize("case", ["grid4", "QPEQ"])
def test_the_step_makes_no_host_read(monkeypatch, case):
    """Every way a tensor reaches the host raises while the step runs (a
    CUDA graph could not capture it); three steps and a step on a halted
    state still finish.  The first step runs unwatched: it analyses the
    pattern and uploads the plan, as the direct first iteration does on the
    card before the capture."""
    _, tq = grid_case(4) if case == "grid4" else fixture_case(case)
    masks = classify_bounds(tq)
    ctl = IPMControl()
    st = t_ipm.ipm_step(tq, masks, t_ipm.ipm_init(tq, masks, ctl), ctl)

    def refuse(self, *args, **kwargs):
        raise AssertionError("a host read inside the step")

    with monkeypatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse)
        for _ in range(3):
            st = t_ipm.ipm_step(tq, masks, st, ctl)
        halted = t_ipm.ipm_step(
            tq, masks, dataclasses.replace(st, halt=torch.tensor(True)), ctl)
    assert int(st.iter) == 4 and int(halted.iter) == 4


@pytest.mark.parametrize("k", [1, 4])
def test_one_host_fetch_per_fetch(monkeypatch, k):
    """``ipm_solve`` reads the monitor once per fetch, a fetch every
    ``steps_per_fetch`` iterations, and makes no other ``tolist``."""
    _, tq = grid_case(4)
    shapes = []
    orig = torch.Tensor.tolist

    def counting(self):
        shapes.append(tuple(self.shape))
        return orig(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    _, _, _, st = ipm_solve(tq, IPMControl(steps_per_fetch=k))
    assert st.status == 0
    assert len(shapes) == st.run.fetches == -(-st.iter // k)
    assert set(shapes) == {(len(t_ipm.MONITOR),)}
    assert st.run.path == "direct" and st.run.direct_steps == st.run.fetches * k
    assert st.run.halted_replays == st.run.direct_steps - st.iter


# ---------------------------------------------------------------------------
# Step by step against the JAX package's ipm_step
# ---------------------------------------------------------------------------


STEP_CASES = {"grid6": lambda: grid_case(6), "QPB100": lambda: fixture_case("QPB100"),
              "LPB100": lambda: fixture_case("LPB100")}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_each_step_matches_reference_from_the_same_state(case):
    """Every iteration of the JAX package's solve, taken again by the port
    from the JAX package's state before it."""
    jq, tq = STEP_CASES[case]()
    jctl, ctl = j_ipm.IPMControl(), IPMControl()
    jm, tm = j_classify(jq), classify_bounds(tq)
    js = j_ipm.ipm_init(jq, jm, jctl)
    for _ in range(jctl.maxit):
        nxt = j_ipm._jitted_step(jq, jm, js, jctl, jq.h_kind)
        ts = t_ipm.ipm_step(tq, tm, to_port(js), ctl)
        for name in ("iter", "status", "halt", "converged", "stall"):
            assert int(getattr(ts, name)) == int(getattr(nxt, name)), name
        for name in ("best_infeas", "res_p", "res_d", "res_c"):
            ref = float(getattr(nxt, name))
            assert abs(float(getattr(ts, name)) - ref) <= 1e-10 * max(1.0, abs(ref)), name
        for name in FOLDED:
            assert rel_err(getattr(ts, name).numpy(), folded(nxt, name)) <= 1e-10, name
        js = nxt
        if bool(js.halt):
            break
    assert bool(js.halt) and int(js.status) == 0


# ---------------------------------------------------------------------------
# The device tail's failure paths against the JAX package's tail
# ---------------------------------------------------------------------------


def tail_inputs(case):
    """(JAX problem, masks, state; the port's; direction as numpy; a_p, a_d)
    for one failure path of the step's tail, from the starting point of the
    grid QP: ``rollback_far`` / ``rollback_near`` a direction with NaN and a
    best infeasibility above or below the far limit; ``infeasible`` a stall
    one short of ``infeas_max``; ``tiny_step`` step lengths of 1e-12."""
    jq, tq = grid_case(5)
    jm, tm = j_classify(jq), classify_bounds(tq)
    js = j_ipm.ipm_init(jq, jm, j_ipm.IPMControl())
    rng = np.random.default_rng(7)
    n, m = tq.n, tq.m
    d = {k: rng.normal(size=n) * 1e-3 for k in ("dx", "dz_l", "dz_u")}
    d.update({k: rng.normal(size=m) * 1e-3 for k in ("dc", "dy", "dy_l", "dy_u")})
    a_p = a_d = 0.5
    upd = {}
    if case.startswith("rollback"):
        d["dx"][3] = np.nan
        upd = dict(best_infeas=jnp.asarray(5.0 if case == "rollback_far" else 1e-9))
    elif case == "infeasible":
        upd = dict(stall=jnp.asarray(9, jnp.int32), best_infeas=jnp.asarray(1e-12))
    elif case == "tiny_step":
        a_p = a_d = 1e-12
    js = dataclasses.replace(js, **upd)
    return jq, jm, js, tq, tm, to_port(js), d, a_p, a_d


TAIL_STATUS = dict(rollback_far=int(Status.PRIMAL_INFEASIBLE),
                   rollback_near=int(Status.ILL_CONDITIONED),
                   infeasible=int(Status.PRIMAL_INFEASIBLE),
                   tiny_step=int(Status.TINY_STEP))


@pytest.mark.parametrize("case", sorted(TAIL_STATUS))
def test_failure_paths_decide_as_the_reference_tail(case):
    jq, jm, js, tq, tm, ts, d, a_p, a_d = tail_inputs(case)
    jctl, ctl = j_ipm.IPMControl(), IPMControl()
    ml_x = jm.has_xl & ~jm.x_fixed
    mu_x = jm.has_xu & ~jm.x_fixed
    ml_c = jm.has_cl & ~jm.c_equality
    mu_c = jm.has_cu & ~jm.c_equality
    jout = j_ipm._apply_direction(
        jq, jm, js, jctl, {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(a_p),
        jnp.asarray(a_d), js.s_l, js.s_u, js.t_l, js.t_u, ml_x, mu_x, ml_c, mu_c)
    tout = t_ipm._apply_direction(
        tq, tm, ts, ctl, {k: torch.as_tensor(v) for k, v in d.items()},
        torch.tensor(a_p, dtype=torch.float64), torch.tensor(a_d, dtype=torch.float64))
    assert int(tout.status) == int(jout.status) == TAIL_STATUS[case]
    for name in ("iter", "halt", "converged", "stall"):
        assert int(getattr(tout, name)) == int(getattr(jout, name)), name
    assert bool(tout.halt)
    if case.startswith("rollback"):      # back to the previous iterate, bit for bit
        for name in t_ipm.VECTOR_FIELDS + ("res_p", "best_infeas", "stall"):
            assert torch.equal(bits(getattr(tout, name)), bits(getattr(ts, name))), name
        assert int(tout.iter) == int(ts.iter) + 1
    else:
        for name in FOLDED:
            assert rel_err(getattr(tout, name).numpy(), folded(jout, name)) <= 1e-12, name


# ---------------------------------------------------------------------------
# A halted step changes nothing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("why", ["halted", "at_maxit"])
def test_a_step_on_a_halted_state_is_a_no_op(why):
    _, tq = grid_case(5)
    masks = classify_bounds(tq)
    ctl = IPMControl(maxit=2 if why == "at_maxit" else 200)
    st = t_ipm.ipm_init(tq, masks, ctl)
    for _ in range(2):
        st = t_ipm.ipm_step(tq, masks, st, ctl)
    if why == "halted":
        st = dataclasses.replace(st, halt=torch.tensor(True))
    again = t_ipm.ipm_step(tq, masks, st, ctl)
    for name in t_ipm.TENSOR_FIELDS:
        assert torch.equal(bits(getattr(again, name)), bits(getattr(st, name))), name


# ---------------------------------------------------------------------------
# steps_per_fetch and ipm_solve_compiled against the JAX package's
# ---------------------------------------------------------------------------


def test_steps_per_fetch_4_matches_reference():
    jq, tq = grid_case(6)
    xj, _, _, sj = j_ipm.ipm_solve(jq, j_ipm.IPMControl(steps_per_fetch=4))
    xt, yt, zt, st = ipm_solve(tq, IPMControl(steps_per_fetch=4))
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter)) == (0, st.iter)
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-10
    np.testing.assert_array_equal(st.inform.checkpoints_iter,
                                  np.asarray(sj.inform.checkpoints_iter))
    assert st.run.fetches == -(-st.iter // 4)
    # the fetches change when the host looks, not what the card computes
    x1, y1, z1, s1 = ipm_solve(tq, IPMControl())
    assert s1.iter == st.iter
    for a, b in ((x1, xt), (y1, yt), (z1, zt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["grid6", "compiled"])
def test_ipm_solve_compiled_matches_reference(case):
    jq, tq = grid_case(6) if case == "grid6" else compiled_case()
    ctl = dict(maxit=30) if case == "compiled" else {}
    xj, _, _, sj = j_ipm.ipm_solve_compiled(jq, j_ipm.IPMControl(**ctl))
    xt, yt, zt, st = ipm_solve_compiled(tq, IPMControl(**ctl))
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter)) == (0, st.iter)
    assert max(st.res_p, st.res_d, st.res_c) <= 1e-6
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-10
    assert st.inform is None and st.run.fetches == st.iter
    # the same iterations as the host loop, bit for bit
    x1, y1, z1, s1 = ipm_solve(tq, IPMControl(**ctl))
    assert s1.iter == st.iter
    for a, b in ((x1, xt), (y1, yt), (z1, zt)):
        assert torch.equal(a, b)
