"""The port's sparse TRS (galahad_tpu_torch/tr/trs_sparse.py: a secular
Newton on lambda over the port's flat LDL' of H + lambda M, on the CPU)
against the JAX package's ``trs_solve_sparse`` / ``trs_contract`` on the
five cases of tests/test_trs_sparse.py, the same inputs.

What is held: ``n_factorizations`` equal, ``history_lambda`` within 1e-9
relative (the same trial sequence, indefinite trials included: the inertia
of an unpivoted LDL' below -lambda_min decides them), ``history_norm``
within 1e-9 relative (NaN where both found the trial indefinite), obj
within 1e-10 relative, ``hard_case`` and ``interior`` equal; x within 1e-8
unless the case is hard (there x depends on the inverse iteration's
vector, which is the same numpy draw in both packages, so it is held
too).  A JAX result warm-starts the port's ``trs_contract`` through
``convert.trs_sparse_info_from_numpy``; two runs give the same bits."""
import numpy as np
import pytest
import torch

from galahad_tpu.core.sparse import COOPattern as JPattern
from galahad_tpu.core.sparse import lower_triangle
from galahad_tpu.tr import trs_contract as j_contract
from galahad_tpu.tr import trs_solve_sparse as j_solve

from galahad_tpu_torch.convert import coo_pattern_from_numpy, trs_sparse_info_from_numpy
from galahad_tpu_torch.tr import trs_contract, trs_solve_sparse

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def laplacian_2d(k):
    """tests/test_trs_sparse.py::_laplacian_2d."""
    n = k * k
    rows, cols, vals = [], [], []
    for i in range(k):
        for j in range(k):
            p = i * k + j
            rows.append(p); cols.append(p); vals.append(4.0)     # noqa: E702
            if i + 1 < k:
                q = (i + 1) * k + j
                rows.append(max(p, q)); cols.append(min(p, q)); vals.append(-1.0)  # noqa: E702
            if j + 1 < k:
                q = i * k + j + 1
                rows.append(max(p, q)); cols.append(min(p, q)); vals.append(-1.0)  # noqa: E702
    return np.array(rows), np.array(cols), np.array(vals, float), n


def case(name):
    """(rows, cols, vals, n, g, radius, m_diag, contract radius) of a case."""
    if name == "hard_case":
        n = 16
        g = np.zeros(n)
        g[3] = 0.01
        return np.arange(n), np.arange(n), np.linspace(-1.0, 3.0, n), n, g, 5.0, None, None
    k, seed, radius = dict(boundary=(8, 3, 0.5), interior=(6, None, 100.0),
                           indefinite_m_norm=(6, 5, 1.5), contract=(8, 7, 0.5))[name]
    r, c, v, n = laplacian_2d(k)
    if name == "indefinite_m_norm":
        v[r == c] -= 3.0
    rr, cc, vv = lower_triangle(r, c, v)
    g = 0.001 * np.ones(n) if seed is None else np.random.default_rng(seed).standard_normal(n)
    m = np.full(n, 2.0) if name == "indefinite_m_norm" else None
    return rr, cc, vv, n, g, radius, m, (0.25 if name == "contract" else None)


CASES = ["boundary", "interior", "indefinite_m_norm", "hard_case", "contract"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max())) if a.size else 0.0


def check_same(j, t, x_tol=1e-8):
    assert t.n_factorizations == j.n_factorizations
    assert rel(j.history_lambda, t.history_lambda) <= 1e-9
    hn_j, hn_t = np.asarray(j.history_norm), np.asarray(t.history_norm)
    np.testing.assert_array_equal(np.isnan(hn_j), np.isnan(hn_t))
    ok = ~np.isnan(hn_j)
    assert rel(hn_j[ok], hn_t[ok]) <= 1e-9
    assert abs(t.obj - j.obj) <= 1e-10 * max(1.0, abs(j.obj))
    assert abs(t.multiplier - j.multiplier) <= 1e-9 * max(1.0, abs(j.multiplier))
    assert (t.hard_case, t.interior) == (j.hard_case, j.interior)
    assert rel(np.asarray(j.x), t.x.numpy()) <= x_tol


def patterns(rr, cc, n):
    return JPattern(rr, cc, n, n), coo_pattern_from_numpy(dict(rows=rr, cols=cc, m=n, n=n))


@pytest.mark.parametrize("name", CASES)
def test_matches_reference(name):
    rr, cc, vv, n, g, radius, m, shrink = case(name)
    jp, tp = patterns(rr, cc, n)
    j = j_solve(jp, vv, g, radius, m_diag=m)
    t = trs_solve_sparse(tp, vv, g, radius, m_diag=m, device="cpu")
    check_same(j, t)
    if shrink is not None:
        j2 = j_contract(jp, vv, g, shrink, j)
        t2 = trs_contract(tp, vv, g, shrink, t, device="cpu")
        check_same(j2, t2)
        assert t2.n_factorizations <= trs_solve_sparse(tp, vv, g, shrink,
                                                       device="cpu").n_factorizations


def test_contract_warm_started_by_a_reference_result():
    """A JAX TRSSparseInfo, carried across as numpy, warm-starts the port's
    trs_contract: the same trials as the JAX package's own contract."""
    rr, cc, vv, n, g, radius, _, shrink = case("contract")
    jp, tp = patterns(rr, cc, n)
    j = j_solve(jp, vv, g, radius)
    prev = trs_sparse_info_from_numpy(
        {f: np.asarray(getattr(j, f)) for f in ("x", "obj", "multiplier", "norm_x", "hard_case",
                                                "interior", "n_factorizations",
                                                "history_lambda", "history_norm")},
        device="cpu")
    check_same(j_contract(jp, vv, g, shrink, j), trs_contract(tp, vv, g, shrink, prev,
                                                               device="cpu"))


def test_two_runs_are_bitwise_equal():
    rr, cc, vv, n, g, radius, m, _ = case("indefinite_m_norm")
    tp = patterns(rr, cc, n)[1]
    a = trs_solve_sparse(tp, vv, g, radius, m_diag=m, device="cpu")
    b = trs_solve_sparse(tp, vv, g, radius, m_diag=m, device="cpu")
    assert torch.equal(a.x, b.x) and a.obj == b.obj
    np.testing.assert_array_equal(a.history_lambda, b.history_lambda)
