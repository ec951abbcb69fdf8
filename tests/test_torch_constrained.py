"""The port's LANCELOT, lancelot_simple, FILTRANE and the filter primitives
(galahad_tpu_torch/nlp/lancelot.py, lancelot_simple.py, filtrane.py) against
the JAX package's, on the cases of tests/test_constrained.py (TestLancelot,
TestFiltrane) and tests/test_tr2.py (TestLancelotSimple): the same functions
written once for both packages, the same numpy starts, float64, the port on
the CPU.

What is held: the same status and outer iteration count, x, y and the
infeasibility within 1e-10 relative (max |difference| <= 1e-10 x max(1, max
|value|)), f besides within 1e-10 |f| + 1e-13 sqrt(|f|) of the JAX package's
(``f_off``).  Found: x and y agree to 1e-13 or better, f exactly, on every
case but two, where the two packages' arithmetic parts at a decision that
exact arithmetic leaves on its edge (ROADMAP queue 3):

- ``lancelot_simple`` on the unconstrained Rosenbrock function: TRB's Cauchy
  search keeps its first arc point where ||s(t0)|| <= radius, and t0 =
  radius / ||g|| puts that point on the boundary in exact arithmetic; the
  JAX package's trust radius after the first rejected step differs from the
  port's by an ulp (its TRS's eigh rounds differently), the test falls the
  other way at the second TRB iteration, and the two converge in 4 and 8
  outer iterations to points 2e-7 apart (the stop is ||g|| <= 1e-6).
- FILTRANE on TestFiltrane's inequality system: J has a zero row wherever a
  constraint holds, so J'J is singular and the Gauss-Newton TRS has a
  segment of minimizers.  At the third iterate the eigenvector of the zero
  eigenvalue meets g in -3.5e-15 in the JAX package (XLA's dot) and in 0 in
  the port: the JAX step runs to the boundary along the null direction, the
  port's stays at the pseudo-inverse step, with the same model value; both
  reach a feasible point, in 12 and 7 iterations.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import galahad_tpu.nlp as J
from galahad_tpu.tr.trs import trs_solve as j_trs

import galahad_tpu_torch.nlp as T
from galahad_tpu_torch.convert import filter_from_numpy, lancelot_info_from_numpy
from galahad_tpu_torch.tr.trs import trs_solve as t_trs

from _torch_port_helpers import REPO, f_off, one_torch_thread, rel  # noqa: F401

sys.path.insert(0, os.path.join(REPO, "tools"))
import constrained_problems as CP  # noqa: E402  (tools/constrained_problems.py)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10
INF = 1e19


def hold(ij, it, what, counts=True):
    """The port's LancelotInfo against the JAX package's."""
    assert int(ij.status) == int(it.status), (what, int(ij.status), int(it.status))
    if counts:
        assert int(ij.iter) == int(it.iter), (what, int(ij.iter), int(it.iter))
        assert float(ij.mu) == float(it.mu), what
    assert rel(ij.x, it.x) <= TOL and rel(ij.y, it.y) <= TOL, what
    assert rel(ij.infeas, it.infeas) <= TOL, what
    assert f_off(ij.f, it.f, TOL) <= 1.0, what


# name: (objective, constraints (given the module), x0, c_l, c_u, x_l, x_u)
CASES = {
    "equality": (lambda xp: lambda x: (x ** 2).sum(),
                 lambda xp: lambda x: xp.stack([x[0] + x[1]]),
                 np.zeros(2), [1.0], [1.0], None, None),
    "inequality": (lambda xp: lambda x: ((x - 2.0) ** 2).sum(),
                   lambda xp: lambda x: xp.stack([x[0] + x[1]]),
                   np.zeros(2), [-INF], [2.0], None, None),
    "inactive_inequality": (lambda xp: lambda x: ((x - 0.2) ** 2).sum(),
                            lambda xp: lambda x: xp.stack([x[0] + x[1]]),
                            np.zeros(2), [-INF], [2.0], None, None),
    "with_bounds": (lambda xp: lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2,
                    lambda xp: lambda x: xp.stack([x[0] ** 2 + x[1] ** 2]),
                    np.array([0.5, 0.5]), [-INF], [1.0], np.zeros(2), np.ones(2)),
    "nonlinear_equality": (lambda xp: lambda x: x[0] + x[1],
                           lambda xp: lambda x: xp.stack([x[0] ** 2 + x[1] ** 2]),
                           np.array([0.1, -1.5]), [2.0], [2.0], None, None),
}


def test_lancelot_cases():
    """TestLancelot's five small cases (exact inner model): status, outer
    iterations, mu, x, y, f and the infeasibility; the work counters."""
    for name, (f, c, x0, cl, cu, xl, xu) in CASES.items():
        jb = lambda b: None if b is None else jnp.asarray(b)      # noqa: E731
        ij = J.lancelot_solve(f(jnp), c(jnp), jnp.asarray(x0), jnp.asarray(cl),
                              jnp.asarray(cu), jb(xl), jb(xu))
        it = T.lancelot_solve(f(torch), c(torch), x0, np.asarray(cl), np.asarray(cu), xl, xu,
                              device="cpu")
        hold(ij, it, name)
        assert int(it.status) == 0 and it.krylov_reads == 0, name
        # per outer iteration TRB's reads (one at least) and the infeasibility's
        assert it.inner_iter >= 1 and it.host_reads >= 2 * int(it.iter) + 1, name
    carried = lancelot_info_from_numpy({k: np.asarray(getattr(ij, k)) for k in (
        "x", "y", "f", "infeas", "norm_pg", "mu", "iter", "converged", "status")}, device="cpu")
    hold(ij, carried, "carried")
    assert carried.iter.dtype == torch.int32 and bool(carried.converged)


def test_lancelot_large_n_matrix_free():
    """test_large_n_matrix_free at n = 400: "auto" takes the Hessian-vector
    product model (n > 256), so each TRB iteration runs GLTR on products of
    the augmented Lagrangian's Hessian; the same outer and inner counts."""
    n = 400
    ij = J.lancelot_solve(CP.chain_objective, CP.chain_constraint(n), jnp.full(n, 0.5),
                          jnp.zeros(1), jnp.zeros(1), ctl=J.LancelotControl(maxit=20))
    it = T.lancelot_solve(CP.chain_objective, CP.chain_constraint(n), np.full(n, 0.5),
                          np.zeros(1), np.zeros(1), ctl=T.LancelotControl(maxit=20),
                          device="cpu")
    hold(ij, it, "n400")
    assert int(it.status) == 0 and float(it.infeas) < 1e-5
    assert it.krylov_reads > 0 and abs(float(it.x.sum()) - 10.0) < 1e-4


def test_lancelot_simple():
    """TestLancelotSimple: the equality-constrained case held in full; the
    unconstrained Rosenbrock function held in status and x within 1e-6 of
    the JAX package's and of (1, 1), its first outer iteration in full (the
    counts part at TRB's Cauchy boundary test, the module docstring)."""
    ij = J.lancelot_simple(lambda x: jnp.sum(x ** 2), jnp.zeros(2),
                           constraints=lambda x: jnp.array([x[0] + x[1] - 1.0]), c_eq=1)
    it = T.lancelot_simple(lambda x: (x ** 2).sum(), np.zeros(2),
                           constraints=lambda x: torch.stack([x[0] + x[1] - 1.0]), c_eq=1,
                           device="cpu")
    hold(ij, it, "constrained")
    np.testing.assert_allclose(it.x.numpy(), [0.5, 0.5], atol=1e-4)

    def rosen(x):
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    for maxit in (1, 200):
        ij = J.lancelot_simple(rosen, jnp.zeros(2), maxit=maxit)
        it = T.lancelot_simple(rosen, np.zeros(2), maxit=maxit, device="cpu")
        if maxit == 1:
            hold(ij, it, "rosenbrock, one outer iteration")
        else:
            assert int(ij.status) == int(it.status) == 0
            assert rel(ij.x, it.x) <= 1e-6 and rel(np.ones(2), it.x) <= 1e-6


FILTRANE = {
    "nonlinear_system": (lambda xp: lambda x: xp.stack([x[0] ** 2 + x[1] ** 2, x[0] - x[1] ** 2]),
                         np.array([0.5, 0.5]), [1.0, 0.0], [1.0, 0.0]),
    "already_feasible": (lambda xp: lambda x: x, np.array([0.5]), [0.0], [1.0]),
    "inequality_feasibility": (
        lambda xp: lambda x: xp.stack([x[0] + x[1], x[0] ** 2 + x[1] ** 2]),
        np.array([5.0, 5.0]), [1.0, -INF], [INF, 4.0]),
}


def test_filtrane_cases():
    """TestFiltrane's three systems: status, iterations, x and theta; the
    inequality system's counts part (the module docstring): there the first
    two iterations are held in full and both solves end feasible."""
    for name, (c, x0, cl, cu) in FILTRANE.items():
        ij = J.filtrane_solve(c(jnp), jnp.asarray(x0), jnp.asarray(cl), jnp.asarray(cu))
        it = T.filtrane_solve(c(torch), x0, np.asarray(cl), np.asarray(cu), device="cpu")
        assert int(ij.status) == int(it.status) == 0, name
        # one read before the loop and one per step; the loop stops at the
        # top of its iteration `iter`
        assert it.host_reads == int(it.iter), (name, it.host_reads, int(it.iter))
        if name != "inequality_feasibility":
            assert int(ij.iter) == int(it.iter), name
            assert rel(ij.x, it.x) <= TOL and f_off(ij.theta, it.theta, TOL) <= 1.0, name
            continue
        x = it.x.numpy()
        assert x[0] + x[1] >= 1 - 1e-4 and x[0] ** 2 + x[1] ** 2 <= 4 + 1e-4
        for k in (1, 2):
            jk = J.filtrane_solve(c(jnp), jnp.asarray(x0), jnp.asarray(cl), jnp.asarray(cu),
                                  ctl=J.FiltraneControl(maxit=k))
            tk = T.filtrane_solve(c(torch), x0, np.asarray(cl), np.asarray(cu),
                                  ctl=T.FiltraneControl(maxit=k), device="cpu")
            assert rel(jk.x, tk.x) <= TOL and f_off(jk.theta, tk.theta, TOL) <= 1.0, k


def test_filtrane_singular_gauss_newton_model():
    """The inequality system's third Gauss-Newton model (the iterate after two
    steps, radius 4): J'J is singular and g lies in its range, so the TRS has
    a segment of minimizers.  Both packages give the same model value; the
    JAX package's step reaches the boundary along the null direction, the
    port's is the pseudo-inverse step inside it."""
    c, x0, cl, cu = FILTRANE["inequality_feasibility"]
    x2 = np.asarray(J.filtrane_solve(c(jnp), jnp.asarray(x0), jnp.asarray(cl), jnp.asarray(cu),
                                     ctl=J.FiltraneControl(maxit=2)).x)

    def viol(x):
        v = c(jnp)(x)
        return v - jnp.clip(v, jnp.asarray(cl), jnp.asarray(cu))

    Jm = jax.jacfwd(viol)(jnp.asarray(x2))
    H, g = np.asarray(Jm.T @ Jm), np.asarray(Jm.T @ viol(jnp.asarray(x2)))
    assert np.linalg.eigvalsh(H)[0] == 0.0
    sj = j_trs(jnp.asarray(H), jnp.asarray(g), 4.0)
    st = t_trs(H, g, 4.0, device="cpu")
    assert abs(float(sj.obj) - float(st.obj)) <= 1e-12 * abs(float(sj.obj))
    assert abs(float(jnp.linalg.norm(sj.x)) - 4.0) <= 1e-8
    np.testing.assert_allclose(st.x.numpy(), -np.linalg.pinv(H) @ g, rtol=1e-10)


def test_filter_primitives():
    """filter_init / filter_acceptable / filter_add against the JAX package's
    on a random sequence of 60 pairs into a filter of capacity 8 (the ring
    overwritten), each candidate's verdict equal; the count saturates at
    2^30; a JAX filter carried over by ``filter_from_numpy``."""
    r = np.random.default_rng(0)
    fj, ft = J.filter_init(8), T.filter_init(8, device="cpu")
    for k in range(60):
        a, b = r.uniform(0.0, 2.0, 2)
        vj = bool(J.filter_acceptable(fj, a, b, 1e-4))
        vt = bool(T.filter_acceptable(ft, torch.tensor(a, dtype=torch.float64),
                                      torch.tensor(b, dtype=torch.float64), 1e-4))
        assert vj == vt, k
        if k % 3 == 0:
            fj = J.filter_add(fj, a, b)
            ft = T.filter_add(ft, torch.tensor(a, dtype=torch.float64),
                              torch.tensor(b, dtype=torch.float64))
            assert np.array_equal(np.asarray(fj.theta_inf), ft.theta_inf.numpy())
            assert np.array_equal(np.asarray(fj.theta_2), ft.theta_2.numpy())
            assert int(fj.count) == int(ft.count)
    assert int(ft.count) == 20 and bool(torch.isfinite(ft.theta_inf).all())
    carried = filter_from_numpy(dict(theta_inf=np.asarray(fj.theta_inf),
                                     theta_2=np.asarray(fj.theta_2), count=2 ** 30, cap=8),
                                device="cpu")
    full = T.filter_add(carried, torch.tensor(0.5, dtype=torch.float64),
                        torch.tensor(0.5, dtype=torch.float64))
    assert int(full.count) == 2 ** 30 and float(full.theta_2[0]) == 0.5
