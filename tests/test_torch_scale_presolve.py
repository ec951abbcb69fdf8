"""The port's scaling and presolve (galahad_tpu_torch/pre/) against the JAX
package's on the same numpy-seeded dense QPs.

What is held:
  * ``scale_get`` (sinkhorn, norm, curtis_reid), ``scale_apply`` and
    ``scale_recover``: every tensor within 1e-15 relative of the JAX
    package's (max |difference| <= 1e-15 x max(1, max |value|)), m = 0
    included;
  * ``presolve_apply``: the bounds and row bounds within 1e-12 relative, and
    ``infeasible``, ``n_tightened`` and ``n_forced_rows`` equal, on the cases
    of tests/test_pre.py::TestPresolve and a random QP;
  * ``presolve_reduce`` / ``presolve_restore``: bitwise equal (the same host
    numpy code) on the cases of tests/test_presolve_reduce.py (messy QP,
    singleton row, infeasible, dominated columns with duplicate rows, three
    parallel rows), the restore fed the same reduced solution;
  * a ``SparseQP`` is refused with ``TypeError``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.core.problem import INFINITY, QP as JQP
from galahad_tpu.pre import presolve as j_pre
from galahad_tpu.pre import scale as j_scale
from galahad_tpu.qp.ipm import ipm_solve as j_ipm_solve

from galahad_tpu_torch import make_sparse_qp
from galahad_tpu_torch.convert import presolve_transform_from_numpy, scaling_from_numpy
from galahad_tpu_torch.pre import presolve as t_pre
from galahad_tpu_torch.pre import scale as t_scale

from _torch_port_helpers import dense_pair, one_torch_thread, random_convex_qp_arrays  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

INF = 2 * INFINITY


def assert_close(ref, got, rel, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    assert ref.shape == got.shape, what
    if ref.size:
        assert np.abs(ref - got).max() <= rel * max(1.0, np.abs(ref).max()), what


def badly_scaled(m, seed, lp=False):
    a = random_convex_qp_arrays(9, m, seed, lp=lp)
    r = np.random.default_rng(seed + 50)
    a["A"] = a["A"] * 10.0 ** r.integers(-3, 4, size=a["A"].shape)
    a["g"] = a["g"] * 10.0 ** r.integers(-2, 3, size=9)
    a["x_u"] = np.where(np.arange(9) % 3 == 0, 1e20, a["x_u"])       # some infinite bounds
    return a


SCALE_CASES = {"qp": lambda: badly_scaled(5, 1), "lp": lambda: badly_scaled(4, 2, lp=True),
               "m0": lambda: badly_scaled(0, 3)}
METHODS = ("sinkhorn", "norm", "curtis_reid")
_PAIRS = {}


def pair(case):
    if case not in _PAIRS:
        _PAIRS[case] = dense_pair(SCALE_CASES[case]())
    return _PAIRS[case]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_scale_get_apply_recover(case, method):
    jq, tq = pair(case)
    js = j_scale.scale_get(jq, j_scale.ScaleControl(method=method))
    ts = t_scale.scale_get(tq, t_scale.ScaleControl(method=method))
    assert_close(js.row, ts.row, 1e-15, "row")
    assert_close(js.col, ts.col, 1e-15, "col")
    # apply the JAX package's own factors in both, so that apply is held alone
    ts = scaling_from_numpy(dict(row=np.asarray(js.row), col=np.asarray(js.col)), device="cpu")
    ja, ta = j_scale.scale_apply(jq, js), t_scale.scale_apply(tq, ts)
    assert ta.h_kind == ja.h_kind == "dense"
    for name in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u"):
        assert_close(getattr(ja, name), getattr(ta, name), 1e-15, name)
    r = np.random.default_rng(7)
    x, y, z = r.normal(size=jq.n), r.normal(size=jq.m), r.normal(size=jq.n)
    jr = j_scale.scale_recover(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    tr = t_scale.scale_recover(ts, *(torch.as_tensor(v) for v in (x, y, z)))
    for a, b in zip(jr, tr):
        assert_close(a, b, 1e-15)


def jqp(H, g, A, c_l, c_u, x_l, x_u):
    return JQP(H=jnp.asarray(H, jnp.float64), g=jnp.asarray(g, jnp.float64),
               A=jnp.asarray(A, jnp.float64), c_l=jnp.asarray(c_l, jnp.float64),
               c_u=jnp.asarray(c_u, jnp.float64), x_l=jnp.asarray(x_l, jnp.float64),
               x_u=jnp.asarray(x_u, jnp.float64))


def to_port(q):
    from galahad_tpu_torch import make_qp

    return make_qp(H=np.asarray(q.H), g=np.asarray(q.g), A=np.asarray(q.A),
                   c_l=np.asarray(q.c_l), c_u=np.asarray(q.c_u), x_l=np.asarray(q.x_l),
                   x_u=np.asarray(q.x_u), device="cpu")


PRESOLVE_CASES = {   # tests/test_pre.py::TestPresolve, and a random QP
    "tightening": lambda: jqp(np.eye(2), np.zeros(2), np.ones((1, 2)), [-INFINITY], [1.0],
                              np.zeros(2), np.full(2, INFINITY)),
    "forcing": lambda: jqp(np.eye(2), np.zeros(2), np.ones((1, 2)), [2.0], [INFINITY],
                           np.zeros(2), np.ones(2)),
    "infeasible": lambda: jqp(np.eye(2), np.zeros(2), np.ones((1, 2)), [5.0], [INFINITY],
                              np.zeros(2), np.ones(2)),
    "vacuous": lambda: jqp(np.eye(2), np.zeros(2), np.ones((1, 2)), [-100.0], [100.0],
                           np.zeros(2), np.ones(2)),
    "random": lambda: dense_pair(random_convex_qp_arrays(8, 4, 410))[0],
    "m0": lambda: dataclasses.replace(dense_pair(random_convex_qp_arrays(5, 0, 3))[0]),
}


@pytest.mark.parametrize("case", sorted(PRESOLVE_CASES))
def test_presolve_apply(case):
    jq = PRESOLVE_CASES[case]()
    ji, ti = j_pre.presolve_apply(jq), t_pre.presolve_apply(to_port(jq))
    for name in ("x_l", "x_u", "c_l", "c_u"):
        assert_close(getattr(ji.qp, name), getattr(ti.qp, name), 1e-12, name)
    assert bool(ti.infeasible) == bool(ji.infeasible)
    assert int(ti.n_tightened) == int(ji.n_tightened)
    assert int(ti.n_forced_rows) == int(ji.n_forced_rows)
    assert ti.n_tightened.dtype == ti.n_forced_rows.dtype == torch.int32


def messy_qp():
    """tests/test_presolve_reduce.py::_messy_qp."""
    n, m = 5, 5
    A = np.zeros((m, n))
    A[0, 1] = 2.0
    A[2, 2] = 1.0
    A[3, 1] = 1.0
    A[3, 2] = 1.0
    A[4, 2] = 1.0
    A[4, 3] = -1.0
    return jqp(np.diag([2.0, 1.0, 1.0, 2.0, 3.0]), [1.0, -2.0, 0.5, -1.0, 2.0], A,
               [1.0, -INF, -10.0, 1.2, -INF], [INF, INF, 10.0, 1.2, 0.3],
               [0.7, -INF, -2.0, -2.0, -1.0], [0.7, INF, 2.0, 2.0, 1.0])


def dominated_and_duplicates():
    """tests/test_presolve_reduce.py::test_dominated_columns_and_duplicate_rows."""
    n, m = 6, 5
    H = np.zeros((n, n))
    H[0, 0], H[1, 1] = 2.0, 1.0
    A = np.zeros((m, n))
    A[0, 0] = A[0, 1] = 1.0
    A[1, 0] = A[1, 1] = -2.0
    A[2, 2] = 1.0
    A[3, 3] = A[3, 1] = 1.0
    A[4, 4] = A[4, 5] = 1.0
    return jqp(H, [-1.0, -0.5, 3.0, -2.5, 1.0, 0.2], A, [0.1, -INF, -INF, -4.0, 0.5],
               [INF, -0.2, 5.0, INF, INF], [0.0, 0.0, 0.5, -1.0, 0.0, 0.0],
               [3.0, 3.0, 4.0, 2.0, 2.0, 2.0])


REDUCE_CASES = {
    "messy": messy_qp,
    "singleton_row": lambda: jqp(np.zeros((1, 1)), np.ones(1), [[3.0]], [6.0], [INF],
                                 [-INF], [INF]),
    "infeasible": lambda: jqp(np.zeros((1, 1)), np.ones(1), np.zeros((1, 1)), [1.0], [2.0],
                              [-1.0], [1.0]),
    "dominated_duplicates": dominated_and_duplicates,
    "three_parallel_rows": lambda: jqp(np.eye(2) * 0.1, [-1.0, -1.0],
                                       [[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]],
                                       [-INF] * 3, [10.0, 18.0, 24.0], np.zeros(2),
                                       np.full(2, 20.0)),
}


def transform_fields(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_presolve_reduce_and_restore_bitwise(case):
    jq = REDUCE_CASES[case]()
    jred, jtr = j_pre.presolve_reduce(jq)
    tred, ttr = t_pre.presolve_reduce(to_port(jq))
    jf = transform_fields(jtr)
    jf["empty"] = jtr.empty
    for name, ref in jf.items():
        got = getattr(ttr, name)
        if isinstance(ref, np.ndarray):
            assert np.array_equal(ref, got), name
        else:
            assert ref == got, name
    assert tred.h_kind == jred.h_kind and tred.f == float(jred.f)
    for name in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u"):
        assert np.array_equal(np.asarray(getattr(jred, name)), getattr(tred, name).numpy()), name
    if jtr.infeasible:
        return
    # the same reduced solution through both restores
    x_r, y_r, z_r, _ = j_ipm_solve(jred)
    jx = j_pre.presolve_restore(jtr, x_r, y_r, z_r)
    tx = t_pre.presolve_restore(ttr, *(torch.as_tensor(np.array(v)) for v in (x_r, y_r, z_r)))
    for a, b in zip(jx, tx):
        assert np.array_equal(a, b)
    # and the JAX package's own transform through the port's restore
    back = t_pre.presolve_restore(presolve_transform_from_numpy(jf), np.asarray(x_r),
                                  np.asarray(y_r), np.asarray(z_r))
    for a, b in zip(jx, back):
        assert np.array_equal(a, b)


def test_sparse_qp_is_refused():
    qp = make_sparse_qp(2, 1, h_coo=([0, 1], [0, 1], [1.0, 1.0]), a_coo=([0], [0], [1.0]),
                        g=np.zeros(2), device="cpu")
    for fn in (t_scale.scale_get, t_pre.presolve_apply, t_pre.presolve_reduce):
        with pytest.raises(TypeError, match="dense QP"):
            fn(qp)
