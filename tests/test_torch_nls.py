"""The port's NLS (galahad_tpu_torch/nlp/nls.py: ``nls_solve`` in its eight
models, four regularization norms and four weight updates, and the sparse
Gauss-Newton ``nls_solve_sparse``) against the JAX package's, on the
examples of tests/test_nlp.py::TestNLS, test_nls_sparse_gauss_newton_large
(at k = 30; at k = 100 against tests/nlp_oracle.json) and
tests/test_reference_parity.py: the same residual written
once for each package, the same numpy starts, float64, the port on the CPU.

What is held: the same status and iteration count, and x and f within
1e-10 relative (max |difference| <= 1e-10 x max(1, max |value|)); f besides
within 1e-10 |f| + 1e-13 sqrt(|f|) of the JAX package's (``f_off``), which
still holds it where a converged f is near 0; at k = 100 f within 1e-8 of
the oracle's relative, and x's norm and 32 entries within 1e-10.  Found: x
agrees to 2e-16 and f to 1e-21 or better on every case, and the counts are
equal on every case."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import galahad_tpu.nlp as J
from galahad_tpu.core.sparse import COOPattern as JCOO
from galahad_tpu.nlp.nls import nls_solve_sparse as j_sparse

import galahad_tpu_torch.nlp as T
from galahad_tpu_torch.core.sparse import COOPattern

from _torch_port_helpers import REPO, f_off, loop_reads, one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(REPO, "tools"))
from nlp_problems import grid_residual_arrays  # noqa: E402  (tools/nlp_problems.py)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10
MODELS = ("first_order", "diagonal", "gauss_newton", "newton", "gauss_to_newton",
          "tensor_gauss_newton", "tensor_newton", "tensor_gauss_to_newton")
NORMS = ("euclidean", "diagonal_jtj", "diagonal_hessian", "band")
WEIGHT_UPDATES = ("basic", "zero_reset", "imitate_tr", "increase")


def rosenbrock_residual(xp):
    cat = jnp.concatenate if xp is jnp else torch.cat
    return lambda x: cat([10.0 * (x[1:] - x[:-1] ** 2), 1.0 - x[:-1]])


T_FIT = np.linspace(0, 1, 20)
Y_FIT = 2.0 * np.exp(-1.5 * T_FIT)


def exponential_residual(xp):
    t, y = (jnp.asarray(T_FIT), jnp.asarray(Y_FIT)) if xp is jnp else (
        torch.as_tensor(T_FIT), torch.as_tensor(Y_FIT))
    return lambda x: x[0] * xp.exp(x[1] * t) - y


def nlss_residual(xp):
    """reference src/nls/nlss.f90."""
    stack = jnp.stack if xp is jnp else torch.stack
    return lambda x: stack([x[2] * x[0] ** 2 + 4.0, x[1] ** 2 + x[2]])


def rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max()))


def hold(sj, st, what):
    assert (int(sj.status), int(sj.iter)) == (int(st.status), int(st.iter)), (
        what, int(sj.status), int(sj.iter), int(st.status), int(st.iter))
    assert rel(sj.x, st.x) <= TOL, what
    assert rel(sj.f, st.f) <= TOL and f_off(sj.f, st.f, TOL) <= 1.0, what
    assert rel(sj.g, st.g) <= 1e-8, what
    maxit = what.get("maxit", T.NLSControl().maxit)
    assert st.host_reads == loop_reads(int(st.iter), maxit), (what, st.host_reads)


def both(make, x0, **fields):
    sj = J.nls_solve(make(jnp), jnp.asarray(x0), J.NLSControl(**fields))
    st = T.nls_solve(make(torch), x0, T.NLSControl(**fields), device="cpu")
    hold(sj, st, fields)
    return st


def test_model_menu():
    """The eight models of the reference's menu (nls.f90:115-123) on the
    Rosenbrock residuals of test_nlp.py (maxit 200; 50 for the two first-order
    models, which stop at it), the tensor models' inner loop and model 8's
    armed switch included."""
    for model in MODELS:
        first = model in ("first_order", "diagonal")
        st = both(rosenbrock_residual, np.full(3 if first else 4, -0.5 if first else -1.2),
                  model=model, maxit=50 if first else 200)
        if not first:
            assert int(st.status) == 0, model
            np.testing.assert_allclose(st.x.numpy(), np.ones(4), atol=1e-4, err_msg=model)


def test_norms_and_weight_updates():
    """The four regularization norms (nls.f90:125-137) and the four weight
    updates (:144-148) on the exponential fit, and the default solve of the
    fit and of the reference's nlss.f90."""
    for norm in NORMS:
        st = both(exponential_residual, np.array([1.0, 0.0]), norm=norm, maxit=200)
        np.testing.assert_allclose(st.x.numpy(), [2.0, -1.5], atol=1e-4, err_msg=norm)
    for wu in WEIGHT_UPDATES[1:]:
        both(exponential_residual, np.array([1.0, 0.0]), weight_update=wu, maxit=200)
    for wu in ("zero_reset", "imitate_tr"):
        both(rosenbrock_residual, np.full(4, -1.2), model="newton", weight_update=wu)
    st = both(exponential_residual, np.array([1.0, 0.0]))
    np.testing.assert_allclose(st.x.numpy(), [2.0, -1.5], atol=1e-5)
    st = both(nlss_residual, np.ones(3))
    assert float(st.f) < 1e-10
    with pytest.raises(ValueError, match="one problem"):
        T.nls_solve(rosenbrock_residual(torch), np.zeros((2, 4)), device="cpu")
    with pytest.raises(ValueError, match="norm"):
        T.nls_solve(rosenbrock_residual(torch), np.zeros(4), T.NLSControl(norm="bogus"),
                    device="cpu")


def sparse_run(k):
    """The port's nls_solve_sparse on grid_residual_arrays(k) from x = 1
    (maxit 40), on the CPU."""
    n, m, u, v, a, rows, cols = grid_residual_arrays(k)
    tu, tv, ta = (torch.as_tensor(w) for w in (u, v, a))
    return T.nls_solve_sparse(
        lambda x: x[tu] + x[tv] ** 2 - ta,
        lambda x: torch.stack([torch.ones(m, dtype=x.dtype), 2.0 * x[tv]]).T.reshape(-1),
        COOPattern(rows, cols, m, n), np.full(n, 1.0), T.NLSControl(maxit=40), device="cpu")


def test_nls_sparse_gauss_newton():
    """The sparse Gauss-Newton over BSC and the flat LDL^T at k = 30 (n =
    900, m = 1,740): the JAX package's count, f <= 1e-10, x within 1e-10;
    two runs bitwise equal; the outer loop's reads two per iteration."""
    n, m, u, v, a, rows, cols = grid_residual_arrays(30)
    ju, jv, ja = jnp.asarray(u), jnp.asarray(v), jnp.asarray(a)
    sj = j_sparse(lambda x: x[ju] + x[jv] ** 2 - ja,
                  lambda x: jnp.stack([jnp.ones(m, x.dtype), 2.0 * x[jv]]).T.reshape(-1),
                  JCOO(rows, cols, m, n), jnp.full(n, 1.0), J.NLSControl(maxit=40))
    st = sparse_run(30)
    assert bool(st.converged) and float(st.f) <= 1e-10
    assert (int(sj.iter), int(sj.status)) == (int(st.iter), int(st.status))
    assert abs(float(sj.f) - float(st.f)) <= TOL and f_off(sj.f, st.f, TOL) <= 1.0
    assert rel(sj.x, st.x) <= TOL
    assert st.host_reads == 2 * int(st.iter)
    again = sparse_run(30)
    assert torch.equal(again.x, st.x) and torch.equal(again.f, st.f)
    with pytest.raises(ValueError, match="one problem"):
        T.nls_solve_sparse(None, None, COOPattern(rows, cols, m, n), np.zeros((2, n)),
                           device="cpu")


def test_nls_sparse_against_the_oracle():
    """At k = 100 (test_nls_sparse_gauss_newton_large's size) the port on the
    CPU against the JAX package's run recorded in tests/nlp_oracle.json
    (tools/make_nlp_oracle.py): the same status and iterations, f within
    1e-8 of the oracle's relative (found: 1e-10), x's norm and its entries
    at ``x_at`` within 1e-10 (relative to max(1, |x|))."""
    with open(os.path.join(REPO, "tests", "nlp_oracle.json")) as fh:
        ref = json.load(fh)["nls_sparse_k100"]
    st = sparse_run(ref["k"])
    assert (int(st.status), int(st.iter)) == (ref["status"], ref["iter"])
    assert abs(float(st.f) - ref["f"]) <= 1e-8 * ref["f"] and float(st.f) <= 1e-10
    assert abs(float(torch.linalg.norm(st.x)) - ref["x_norm"]) <= TOL * ref["x_norm"]
    assert rel(ref["x"], st.x[ref["x_at"]]) <= TOL
