"""The port's TRU, TRB and ARC (galahad_tpu_torch/nlp/tru.py, arc.py)
against the JAX package's, on the examples of tests/test_nlp.py and
tests/test_reference_parity.py: the same objective written once for each
package, the same numpy starts, float64, the port on the CPU.

What is held: the same status and iteration count (per problem for the
batch of starts the JAX package vmaps), and x and f within 1e-10 relative
(max |difference| <= 1e-10 x max(1, max |value|)); f besides within 1e-10 |f|
+ 1e-13 sqrt(|f|) of the JAX package's (``f_off``), which still holds it where
a converged f is near 0.  Found: x agrees to 1e-15 on every case here, f to
within 1e-8 |f| or 2e-15 sqrt(|f|), and the counts are equal on every case (the
Krylov models included, whose GLTR / GLRT run 64 Lanczos steps when the
space is exhausted, as the JAX package's do).  The outer loop reads the host
before each pass: max iter + 1 times, or maxit where the cap is reached."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import galahad_tpu.nlp as J

import galahad_tpu_torch.nlp as T
from galahad_tpu_torch.convert import tru_state_from_numpy
from galahad_tpu_torch.core.problem import unconstrained_nlp

from _torch_port_helpers import f_off, loop_reads, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10


def rosenbrock(xp):
    return lambda x: xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def quadratic(xp):
    def f(x):
        d = xp.arange(1, x.shape[0] + 1, dtype=x.dtype)
        return 0.5 * xp.sum(d * x * x) + xp.sum(x)
    return f


def quartic(xp, a=2.0, b=0.5):
    return lambda x: xp.sum(x ** 4 - a * x ** 2 + b * x)


def cos_example(xp):
    """reference src/tru/trus.f90 (and arcs.f90, trbs.f90)."""
    return lambda x: (x[0] + x[2] + 4.0) ** 2 + (x[1] + x[2]) ** 2 + xp.cos(x[0])


def coupled(xp):
    return lambda x: xp.sum((x - 2.0) ** 2) + xp.sum((x[1:] * x[:-1]) ** 2)


def rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max()))


def hold(sj, st, what, maxit=100):
    """The port's state against the JAX package's: status and iter equal, x
    and f within TOL, and the outer loop's reads those of a read per pass
    (``maxit`` the solve's cap)."""
    assert np.array_equal(np.asarray(sj.status), st.status.numpy()), what
    assert np.array_equal(np.asarray(sj.iter), st.iter.numpy()), (what, sj.iter, st.iter)
    assert rel(sj.x, st.x) <= TOL, what
    assert rel(sj.f, st.f) <= TOL and f_off(sj.f, st.f, TOL) <= 1.0, what
    assert rel(sj.norm_g, st.norm_g) <= 1e-8, what
    assert st.host_reads == loop_reads(int(st.iter.max()), maxit), (what, st.host_reads)


# name: (objective maker, x0, control fields)
TRU_CASES = {
    "rosenbrock_direct": (rosenbrock, np.full(4, -1.2), {}),
    "rosenbrock_gltr": (rosenbrock, np.full(6, -1.2), dict(subproblem_direct=False)),
    "quadratic_one_step": (quadratic, np.zeros(5), {}),
    "nonconvex_start": (quartic, np.zeros(3), {}),
    "maxit": (rosenbrock, np.full(10, -1.2), dict(maxit=2)),
    "reference_trus": (cos_example, np.ones(3), {}),
    "lbfgs_rosenbrock": (rosenbrock, np.full(4, -1.2), dict(model="bfgs", maxit=200)),
    "sr1_quadratic": (quadratic, np.zeros(5), dict(model="sr1", maxit=100)),
}


def test_tru_cases():
    """TRU in its three models (exact TRS, GLTR on Hessian-vector products,
    GLTR on an L-BFGS / L-SR1 Hessian) on test_nlp.py's TestTRU and
    TestTRUQuasiNewton examples and the reference's trus.f90."""
    for name, (make, x0, fields) in TRU_CASES.items():
        sj = J.tru_solve(make(jnp), jnp.asarray(x0), J.TRUControl(**fields))
        st = T.tru_solve(make(torch), x0, T.TRUControl(**fields), device="cpu")
        hold(sj, st, name, fields.get("maxit", 100))
        krylov = fields.get("model", "newton") != "newton" or "subproblem_direct" in fields
        assert (st.krylov_reads > 0) == krylov, name
        if name == "reference_trus":            # the record: f = -1 at the solution
            assert abs(float(st.f) + 1.0) < 1e-6


def test_tru_batch_of_starts():
    """The 8 x 4 batch that test_nlp.py vmaps: one call of the port, each
    problem stopping at its own count (14 to 33 iterations)."""
    starts = np.random.default_rng(0).normal(size=(8, 4))
    sj = jax.vmap(lambda x0: J.tru_solve(rosenbrock(jnp), x0))(jnp.asarray(starts))
    st = T.tru_solve(rosenbrock(torch), starts, device="cpu")
    hold(sj, st, "batch")
    assert st.x.shape == (8, 4) and st.iter.shape == (8,)
    assert len(set(st.iter.tolist())) > 1
    # a (2, 4, 4) batch: the same problems, the same bits
    st2 = T.tru_solve(rosenbrock(torch), starts.reshape(2, 4, 4), device="cpu")
    assert torch.equal(st2.x.reshape(8, 4), st.x) and torch.equal(st2.iter.reshape(8), st.iter)
    # one problem of the batch alone takes the batch's count and point
    one = T.tru_solve(rosenbrock(torch), starts[3], device="cpu")
    assert int(one.iter) == int(st.iter[3]) and rel(st.x[3], one.x) <= 1e-14


INF = 1e20
# name: (objective maker, x0, x_l, x_u, control fields)
TRB_CASES = {
    "bounds_inactive": (rosenbrock, np.full(4, -1.2), np.full(4, -10.0), np.full(4, 10.0), {}),
    "bounds_active": (lambda xp: lambda x: xp.sum((x - 2.0) ** 2), np.full(5, 0.5),
                      np.zeros(5), np.ones(5), {}),
    "infeasible_start": (lambda xp: lambda x: xp.sum(x ** 2), np.full(3, 9.0), np.ones(3),
                         np.full(3, 2.0), {}),
    "coupled_newton": (coupled, np.zeros(6), np.full(6, -0.5), np.full(6, 1.2), {}),
    "coupled_hvp": (coupled, np.zeros(6), np.full(6, -0.5), np.full(6, 1.2),
                    dict(model="hvp")),
    "reference_trbs": (cos_example, np.ones(3), np.array([-INF, -INF, 0.0]), np.full(3, 1.1), {}),
}


def mixed_case():
    """test_nlp.py::test_mixed_active: a convex quadratic on [-0.5, 0.5]^6."""
    r = np.random.default_rng(3)
    n = 6
    B = r.normal(size=(n, n))
    H = B @ B.T + n * np.eye(n)
    g = r.normal(size=n) * 5.0

    def make(xp):
        Hx, gx = (jnp.asarray(H), jnp.asarray(g)) if xp is jnp else (torch.as_tensor(H),
                                                                       torch.as_tensor(g))
        return lambda x: 0.5 * x @ (Hx @ x) + gx @ x

    return make, np.zeros(n), np.full(n, -0.5), np.full(n, 0.5), {}


def test_trb_cases():
    """TRB on test_nlp.py's TestTRB (inactive, active, mixed, infeasible
    start, hvp against newton) and the reference's trbs.f90."""
    cases = dict(TRB_CASES, mixed_active=mixed_case())
    xs = {}
    for name, (make, x0, lo, hi, fields) in cases.items():
        sj = J.trb_solve(make(jnp), jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi),
                         J.TRBControl(**fields))
        st = T.trb_solve(make(torch), x0, lo, hi, T.TRBControl(**fields), device="cpu")
        hold(sj, st, name)
        assert int(st.status) == 0, name
        xs[name] = st.x
    np.testing.assert_allclose(xs["coupled_hvp"].numpy(), xs["coupled_newton"].numpy(), atol=1e-5)
    np.testing.assert_allclose(xs["bounds_active"].numpy(), np.ones(5), atol=1e-6)


ARC_CASES = {
    "rosenbrock_direct": (rosenbrock, np.full(4, -1.2), {}),
    "rosenbrock_glrt": (rosenbrock, np.full(4, -1.2), dict(subproblem_direct=False)),
    "nonconvex": (lambda xp: quartic(xp, 8.0, 1.0), np.full(3, 0.1), {}),
    "reference_arcs": (cos_example, np.ones(3), {}),
}


def test_arc_cases():
    """ARC (RQS direct, GLRT) on test_nlp.py's TestARC and the reference's
    arcs.f90; a batch of the direct model against its problems one by one."""
    for name, (make, x0, fields) in ARC_CASES.items():
        sj = J.arc_solve(make(jnp), jnp.asarray(x0), J.ARCControl(**fields))
        st = T.arc_solve(make(torch), x0, T.ARCControl(**fields), device="cpu")
        hold(sj, st, name)
    starts = np.random.default_rng(1).normal(size=(5, 4))
    sb = T.arc_solve(rosenbrock(torch), starts, device="cpu")
    for i in range(5):
        si = J.arc_solve(rosenbrock(jnp), jnp.asarray(starts[i]))
        assert int(si.iter) == int(sb.iter[i]) and rel(si.x, sb.x[i]) <= TOL


def test_batches_and_the_nlp_container():
    """The matrix-free models take one problem and raise on a batch; the
    ``NLP`` container carries an objective to the solvers; a JAX state
    carries over by ``tru_state_from_numpy``."""
    f = rosenbrock(torch)
    starts = np.zeros((2, 4))
    for call in (lambda: T.tru_solve(f, starts, T.TRUControl(subproblem_direct=False),
                                     device="cpu"),
                 lambda: T.tru_solve(f, starts, T.TRUControl(model="bfgs"), device="cpu"),
                 lambda: T.arc_solve(f, starts, T.ARCControl(subproblem_direct=False),
                                     device="cpu"),
                 lambda: T.trb_solve(f, starts, -1.0, 1.0, T.TRBControl(model="hvp"),
                                     device="cpu")):
        with pytest.raises(ValueError, match="one problem"):
            call()
    nlp = unconstrained_nlp(f, np.full(4, -1.2), name="rosenbrock", device="cpu")
    assert nlp.n == 4 and float(nlp.x_u[0]) == 2e19
    st = T.tru_solve(nlp.objective, nlp.x)
    sj = J.tru_solve(rosenbrock(jnp), jnp.full(4, -1.2))
    hold(sj, st, "nlp")
    carried = tru_state_from_numpy({k: np.asarray(getattr(sj, k)) for k in
                                    ("x", "f", "g", "radius", "iter", "converged", "status",
                                     "norm_g")}, device="cpu")
    for k in ("x", "f", "g", "radius"):
        assert rel(getattr(carried, k), getattr(st, k)) <= TOL, k
    assert carried.iter.dtype == torch.int32 and bool(carried.converged)
