"""The port's BSC (galahad_tpu_torch/linalg/bsc.py) and CHECK / FDH
(galahad_tpu_torch/nlp/check.py) against the JAX package's, on the cases of
tests/test_linalg2.py::TestBSC, tests/test_nlp.py::test_bsc_sparse_matches_dense
and tests/test_tr2.py (TestCheck, TestFDH): the same numpy inputs, float64,
the port on the CPU.

What is held: BSC's dense and block forms within 1e-13 relative of the JAX
package's, the sparse analysis equal to its plan (pattern, product operands,
order) and the sparse values within 1e-13; CHECK's verdicts and flagged
indices equal, its largest errors within 1e-6 relative (they are
finite-difference errors, ~1e-9, whose last digits follow the rounding of
the differences); FDH's grouping equal and its estimates within 1e-8.  The
port's ``bsc_analyse`` raises on duplicate COO entries, where the JAX
package's sums their index payload (galahad_tpu/linalg/bsc.py:92)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.core.sparse import COOPattern as JCOO
from galahad_tpu.linalg import bsc as JB
from galahad_tpu.nlp import check as JC

from galahad_tpu_torch.convert import bsc_plan_from_numpy, fdh_pattern_from_numpy
from galahad_tpu_torch.core.sparse import COOPattern
from galahad_tpu_torch.linalg import bsc as TB
from galahad_tpu_torch.nlp import check as TC

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max())) if ref.size else 0.0


def test_bsc_dense_and_blocks():
    """bsc_form with and without d, on one matrix and a batch; the block
    form of a band-limited A (block 2, and block 4 with a padded last
    block)."""
    r = np.random.default_rng(0)
    A = r.normal(size=(4, 7))
    d = r.uniform(0.5, 2.0, 7)
    for dd in (d, None):
        Sj = JB.bsc_form(jnp.asarray(A), None if dd is None else jnp.asarray(dd))
        St = TB.bsc_form(torch.as_tensor(A), None if dd is None else torch.as_tensor(dd))
        assert rel(Sj, St) <= 1e-13
    Ab = r.normal(size=(3, 4, 7))
    assert rel(JB.bsc_form(jnp.asarray(Ab), jnp.asarray(d)),
               TB.bsc_form(torch.as_tensor(Ab), torch.as_tensor(d))) <= 1e-13
    r = np.random.default_rng(1)
    m, n = 6, 16
    A = np.zeros((m, n))
    for i in range(m):
        A[i, 2 * i:2 * i + 4] = r.normal(size=4)
    d = r.uniform(0.5, 2.0, n)
    S = A @ np.diag(d) @ A.T
    for block in (2, 4):
        Dj, Lj = JB.bsc_form_blocks(jnp.asarray(A), jnp.asarray(d), block=block)
        Dt, Lt = TB.bsc_form_blocks(torch.as_tensor(A), torch.as_tensor(d), block=block)
        assert rel(Dj, Dt) <= 1e-13 and rel(Lj, Lt) <= 1e-13
        for i in range(m // block):
            np.testing.assert_allclose(Dt[i].numpy(), S[block * i:block * (i + 1),
                                                         block * i:block * (i + 1)], atol=1e-10)


def sparse_cases():
    rng = np.random.default_rng(1)
    m, n = 15, 11
    r, c = np.nonzero(rng.random((m, n)) < 0.3)
    cases = {"random_15x11": (m, n, r, c, rng.normal(size=len(r)), rng.uniform(0.5, 2.0, n))}
    # shuffled entries, an empty column and a dense column
    rng = np.random.default_rng(2)
    m, n = 9, 6
    mask = rng.random((m, n)) < 0.4
    mask[:, 2] = False
    mask[:, 4] = True
    r, c = np.nonzero(mask)
    p = rng.permutation(len(r))
    cases["shuffled"] = (m, n, r[p], c[p], rng.normal(size=len(r)), None)
    return cases


def test_bsc_sparse():
    """The sparse analysis gives the JAX package's plan (pattern, product
    operands, their order and S-entry ids), also when carried over by
    ``bsc_plan_from_numpy``; the values within 1e-13 of its values and of
    the dense product's lower triangle."""
    for name, (m, n, r, c, vals, d) in sparse_cases().items():
        pj = JB.bsc_analyse(JCOO(r, c, m, n))
        pt = TB.bsc_analyse(COOPattern(r, c, m, n))
        for f in ("p1", "p2", "dcol", "sout"):
            assert np.array_equal(np.asarray(getattr(pj, f)), getattr(pt, f)), (name, f)
        assert np.array_equal(pj.s_pat.rows, pt.s_pat.rows)
        assert np.array_equal(pj.s_pat.cols, pt.s_pat.cols)
        sj = JB.bsc_form_sparse(pj, jnp.asarray(vals), None if d is None else jnp.asarray(d))
        carried = bsc_plan_from_numpy({"m": pj.m, "n": pj.n, "s_pat": pj.s_pat, "p1": pj.p1,
                                       "p2": pj.p2, "dcol": pj.dcol, "sout": pj.sout})
        for plan in (pt, carried):
            st = TB.bsc_form_sparse(plan, torch.as_tensor(vals),
                                    None if d is None else torch.as_tensor(d))
            assert rel(sj, st) <= 1e-13, name
        A = np.zeros((m, n))
        A[r, c] = vals
        S = A @ np.diag(np.ones(n) if d is None else d) @ A.T
        Sd = np.zeros((m, m))
        Sd[pt.s_pat.rows, pt.s_pat.cols] = st.numpy()
        assert np.abs(np.tril(S) - Sd).max() < 1e-12, name


def test_bsc_analyse_refuses_duplicates():
    """A COO pattern with a repeated (row, column) entry raises.  The JAX
    package sums the two entries' ids: here entries 0 and 1, both (0, 0),
    become id 2, which is entry (1, 1) of another column, and the analysis
    goes on without a word."""
    r = np.array([0, 0, 1, 2])
    c = np.array([0, 0, 1, 0])
    with pytest.raises(ValueError, match="duplicate"):
        TB.bsc_analyse(COOPattern(r, c, 3, 2))
    pj = JB.bsc_analyse(JCOO(r, c, 3, 2))
    col0 = np.asarray(pj.dcol) == 0
    assert 2 in np.asarray(pj.p1)[col0]                   # the fault it guards against


def test_check_derivatives():
    """CHECK on test_tr2.py's cases: a right gradient (torch.func's), a
    gradient off by e_0, a wrong Hessian, and the default Hessian."""
    cases = {
        "right": (lambda xp: lambda x: xp.sum(x ** 3) + x[0] * x[1], np.array([1.0, 2.0, 0.5]),
                  None, None),
        "bad_grad": (lambda xp: lambda x: xp.sum(x ** 2), np.ones(3),
                     lambda xp: lambda x: 2 * x + xp.eye(3, dtype=x.dtype)[0], None),
        "bad_hess": (lambda xp: lambda x: xp.sum(x ** 2), np.ones(2), None,
                     lambda xp: lambda x: 2 * xp.eye(2, dtype=x.dtype) + 0.5),
    }
    for name, (f, x, g, h) in cases.items():
        ij = JC.check_derivatives(f(jnp), jnp.asarray(x), grad=g and g(jnp), hess=h and h(jnp))
        it = TC.check_derivatives(f(torch), x, grad=g and g(torch), hess=h and h(torch),
                                  device="cpu")
        assert (ij.ok, ij.grad_ok, ij.hess_ok) == (it.ok, it.grad_ok, it.hess_ok), name
        assert np.array_equal(ij.grad_bad_indices, it.grad_bad_indices), name
        assert np.array_equal(ij.hess_bad_indices, it.hess_bad_indices), name
        for e in ("max_grad_error", "max_hess_error"):
            a, b = getattr(ij, e), getattr(it, e)
            assert abs(a - b) <= 1e-6 * max(abs(a), 1e-3), (name, e, a, b)
    assert it.hess_ok is False and list(TC.check_derivatives(
        cases["bad_grad"][0](torch), np.ones(3), grad=cases["bad_grad"][2](torch),
        device="cpu").grad_bad_indices) == [0]


def test_fdh():
    """FDH on test_tr2.py's tridiagonal (3 groups) and diagonal (1 group)
    patterns, and an arrowhead: the JAX package's grouping (also carried by
    ``fdh_pattern_from_numpy``) and its estimates within 1e-8, the
    tridiagonal's within 1e-4 of the Hessian."""
    n = 8
    rows, cols = [], []
    for i in range(n):
        rows.append(i)
        cols.append(i)
        if i + 1 < n:
            rows.append(i + 1)
            cols.append(i)

    def f(xp):
        return lambda x: xp.sum(x ** 2) + xp.sum(x[1:] * x[:-1]) + xp.sum(x ** 3)

    arrow_r = np.concatenate([np.arange(6), np.arange(1, 6)])
    arrow_c = np.concatenate([np.arange(6), np.zeros(5, int)])
    pats = {"tridiagonal": (n, rows, cols), "diagonal": (5, np.arange(5), np.arange(5)),
            "arrow": (6, arrow_r, arrow_c)}
    for name, (k, r, c) in pats.items():
        pj, pt = JC.fdh_analyse(k, r, c), TC.fdh_analyse(k, r, c)
        assert np.array_equal(pj.groups, pt.groups) and pj.ngroups == pt.ngroups, name
        x = np.random.default_rng(0).normal(size=k)
        vj = JC.fdh_estimate(pj, jax.grad(f(jnp)), jnp.asarray(x), h=1e-5)
        for pat in (pt, fdh_pattern_from_numpy(pj)):
            vt = TC.fdh_estimate(pat, torch.func.grad(f(torch)), x, h=1e-5, device="cpu")
            assert rel(vj, vt) <= 1e-8, name
        if name == "tridiagonal":
            assert pt.ngroups <= 3
            H = np.asarray(jax.hessian(f(jnp))(jnp.asarray(x)))
            np.testing.assert_allclose(vt.numpy(), H[pt.rows, pt.cols], atol=1e-4)
    assert TC.fdh_analyse(5, np.arange(5), np.arange(5)).ngroups == 1
