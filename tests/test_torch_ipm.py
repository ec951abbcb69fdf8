"""The slice as a whole: the port's ``ipm_solve`` on the CPU against the
JAX package's on the same numpy-seeded problems.

What is held: the same status; the same iteration count (the JAX side
carries double-word iterates, the port plain float64, and on every case
here the counts agree); the objective within 1e-8 relative; x within
1e-6."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.core.sparse import make_sparse_qp as j_make
from galahad_tpu.io import qplib as j_qplib
from galahad_tpu.qp.ipm import IPMControl as JControl
from galahad_tpu.qp.ipm import ipm_solve as j_solve

from galahad_tpu_torch import Status, make_sparse_qp
from galahad_tpu_torch.convert import ipm_state_from_numpy
from galahad_tpu_torch.core.config import apply_specfile, read_specfile
from galahad_tpu_torch.core.problem import classify_bounds
from galahad_tpu_torch.core.residuals import kkt_residuals
from galahad_tpu_torch.io import qplib as t_qplib
from galahad_tpu_torch.qp import ipm as t_ipm
from galahad_tpu_torch.qp.ipm import IPMControl, IPMInform, ipm_solve

from _torch_port_helpers import grid_qp_arrays, sweep_path


def grid_case(k):
    n, m, kw = grid_qp_arrays(k)
    return j_make(n, m, **kw), make_sparse_qp(n, m, device="cpu", **kw)


def equality_fixed_case():
    """Equality rows (C = 0) and a fixed variable, as the JAX package's
    tests/test_sparse_qp.py::test_equality_and_fixed."""
    n, m, kw = grid_qp_arrays(5, seed=3)
    kw = dict(kw, c_l=np.full(m, 1.5), c_u=np.full(m, 1.5))
    kw["x_l"] = kw["x_l"].copy()
    kw["x_u"] = kw["x_u"].copy()
    kw["x_l"][0] = kw["x_u"][0] = 0.7
    return j_make(n, m, **kw), make_sparse_qp(n, m, device="cpu", **kw)


def sparse_lp_case():
    rng = np.random.default_rng(5)
    n, m = 40, 20
    ar = np.repeat(np.arange(m), 2)
    ac = np.stack([np.arange(m), np.arange(m) + n - m]).T.reshape(-1)
    kw = dict(a_coo=(ar, ac, rng.uniform(0.5, 1.5, 2 * m)),
              g=rng.uniform(-1, -0.1, n), c_l=np.full(m, -1e20), c_u=np.ones(m),
              x_l=np.zeros(n), x_u=np.full(n, 10.0))
    return j_make(n, m, **kw), make_sparse_qp(n, m, device="cpu", **kw)


def fixture_case(name):
    return (j_qplib.read_sparse_qp(sweep_path(name)),
            t_qplib.read_sparse_qp(sweep_path(name), device="cpu"))


CASES = {
    "grid6": lambda: grid_case(6),
    "grid12": lambda: grid_case(12),
    "grid20": lambda: grid_case(20),
    "grid40": lambda: grid_case(40),
    "equality_fixed": equality_fixed_case,
    "sparse_lp": sparse_lp_case,
    "QPB100": lambda: fixture_case("QPB100"),
    "LPB100": lambda: fixture_case("LPB100"),
    "BQP150": lambda: fixture_case("BQP150"),
    "QPEQ": lambda: fixture_case("QPEQ"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_reference(case):
    jq, tq = CASES[case]()
    xj, yj, zj, sj = j_solve(jq, JControl())
    xt, yt, zt, st = ipm_solve(tq, IPMControl())
    assert st.status == int(sj.status) == 0
    assert st.iter == int(sj.iter)
    obj_j, obj_t = float(sj.inform.obj), st.inform.obj
    assert abs(obj_j - obj_t) <= 1e-8 * max(1.0, abs(obj_j))
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-6
    assert max(float(r) for r in kkt_residuals(tq, xt, yt, zt)) < 1e-6
    inf = st.inform
    assert isinstance(inf, IPMInform)
    assert (inf.status, inf.iter, inf.nfacts) == (0, st.iter, st.iter)
    assert inf.nbacts == st.iter * 2 * 3
    assert inf.b_stat.shape == (tq.n,) and inf.c_stat.shape == (tq.m,)
    np.testing.assert_array_equal(inf.b_stat, np.asarray(sj.inform.b_stat))
    np.testing.assert_array_equal(inf.c_stat, np.asarray(sj.inform.c_stat))


def test_equality_and_fixed_are_honoured():
    _, tq = equality_fixed_case()
    x, y, z, st = ipm_solve(tq)
    assert st.status == 0
    assert abs(float(x[0]) - 0.7) < 1e-8
    assert float((tq.Ax(x) - 1.5).abs().max()) < 1e-6


def test_first_step_matches_reference_from_the_same_state():
    """One iteration from the JAX package's starting state, carried across
    by convert.ipm_state_from_numpy: same residuals to 1e-9 relative."""
    from galahad_tpu.core.problem import classify_bounds as j_classify
    from galahad_tpu.qp.ipm import _sparse_ipm_step as j_step
    from galahad_tpu.qp.ipm import ipm_init as j_init

    jq, tq = grid_case(6)
    jm = j_classify(jq)
    js0 = j_init(jq, jm, JControl())
    fields = {f.name: np.asarray(getattr(js0, f.name))
              for f in dataclasses.fields(js0)}
    ts0 = ipm_state_from_numpy(fields, device="cpu")
    tm = classify_bounds(tq)
    ti = t_ipm.ipm_init(tq, tm, IPMControl())
    for f in ("x", "c", "y", "z_l", "z_u", "y_l", "y_u", "s_l", "s_u", "t_l", "t_u"):
        np.testing.assert_array_equal(getattr(ts0, f).numpy(), getattr(ti, f).numpy())
    js1 = j_step(jq, jm, js0, JControl())
    ts1 = t_ipm.ipm_step(tq, tm, ts0, IPMControl())
    assert ts1.iter == int(js1.iter) == 1
    for name in ("res_p", "res_d", "res_c"):
        ref = float(getattr(js1, name))
        assert abs(getattr(ts1, name) - ref) <= 1e-9 * max(1.0, abs(ref))
    np.testing.assert_allclose(ts1.x.numpy(),
                               np.asarray(js1.x) + np.asarray(js1.x_lo),
                               rtol=0, atol=1e-10)


def test_maxit_one_gives_max_iterations():
    _, tq = grid_case(6)
    x, y, z, st = ipm_solve(tq, IPMControl(maxit=1))
    assert st.status == int(Status.MAX_ITERATIONS) == st.inform.status
    assert st.iter == 1 and not st.converged
    assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("which", ["x", "c"])
def test_bad_bounds(which):
    n, m, kw = grid_qp_arrays(4)
    if which == "x":
        kw["x_l"] = kw["x_l"].copy()
        kw["x_l"][2] = 5.0                      # above x_u = 2
    else:
        kw["c_u"] = np.full(m, 0.0)             # below c_l = 1
    x, y, z, st = ipm_solve(make_sparse_qp(n, m, device="cpu", **kw))
    assert st.status == int(Status.BAD_BOUNDS) == st.inform.status
    assert st.iter == 0 and x.shape == (n,) and y.shape == (m,)
    assert isinstance(st.inform, IPMInform)


@pytest.mark.parametrize("ctl", [
    IPMControl(arc="zhang"), IPMControl(series_order=0),
    IPMControl(arc="taylor", series_order=0)])
def test_unported_control_values_raise(ctl):
    """An arc that is none of mehrotra, taylor, puiseux and zhao_sun, and
    a series order below 1, raise (the series arcs themselves are held to
    the JAX package in tests/test_torch_ipm_arcs.py)."""
    _, tq = grid_case(4)
    with pytest.raises(NotImplementedError):
        ipm_solve(tq, ctl)


def test_wcp_mode_matches_reference():
    """``mu_target > 0`` (the WCP mode): the same status and iterations as
    the JAX package, x within 1e-6, and every active complementarity pair
    of the port's final iterate inside [gamma_c mu_t, mu_t / gamma_c]."""
    jq, tq = grid_case(6)
    xj, _, _, sj = j_solve(jq, JControl(mu_target=1e-3))
    ctl = IPMControl(mu_target=1e-3)
    xt, _, _, st = ipm_solve(tq, ctl)
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter)) == (0, st.iter)
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-6
    masks = classify_bounds(tq)
    ml_x, mu_x, ml_c, mu_c = t_ipm._active_masks(masks)
    lo, hi = ctl.gamma_c * ctl.mu_target, ctl.mu_target / ctl.gamma_c
    for prod, mask in ((st.z_l * st.s_l, ml_x), (st.z_u * st.s_u, mu_x),
                       (st.y_l * st.t_l, ml_c), (st.y_u * st.t_u, mu_c)):
        p = prod[mask]
        assert bool(((p >= lo) & (p <= hi)).all())
    assert int(ml_x.sum() + mu_x.sum() + ml_c.sum()) > 0


def test_control_fields_and_specfile_carry_over():
    jf = {f.name: f.default for f in dataclasses.fields(JControl)}
    tf = {f.name: f.default for f in dataclasses.fields(IPMControl)}
    assert jf == tf
    ctl = apply_specfile(IPMControl(), read_specfile("maxit 3\nstop-abs-p 1e-4"))
    assert ctl.maxit == 3 and ctl.stop_abs_p == 1e-4
    # accepted (endgame_f64 is then ignored)
    _, tq = grid_case(4)
    _, _, _, st = ipm_solve(tq, IPMControl(steps_per_fetch=4, endgame_f64=False))
    assert st.status == 0


def test_run_twice_bitwise_equal():
    _, tq = grid_case(8)
    a = ipm_solve(tq)
    b = ipm_solve(tq)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
    assert a[3].iter == b[3].iter


@pytest.mark.parametrize("order", [1, 3])
def test_other_series_orders_match_reference(order):
    """series_order 1 (pure Newton) converges; with 3 (an extra corrector)
    the JAX package stalls on this problem with TINY_STEP, and the port
    does exactly the same: same status, same iteration."""
    jq, tq = grid_case(6)
    _, _, _, sj = j_solve(jq, JControl(series_order=order))
    x, y, z, st = ipm_solve(tq, IPMControl(series_order=order))
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter))
    assert st.status == (0 if order == 1 else int(Status.TINY_STEP))
    if order == 1:
        assert max(float(r) for r in kkt_residuals(tq, x, y, z)) < 1e-6


def test_float32_solve_reaches_loose_tolerance():
    n, m, kw = grid_qp_arrays(6)
    tq = make_sparse_qp(n, m, device="cpu", dtype=torch.float32, **kw)
    ctl = IPMControl(stop_abs_p=1e-3, stop_abs_d=1e-3, stop_abs_c=1e-3)
    x, y, z, st = ipm_solve(tq, ctl)
    assert x.dtype == torch.float32 and st.status == 0
