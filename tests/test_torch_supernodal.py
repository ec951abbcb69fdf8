"""The port's inline supernodal LDL^T (galahad_tpu_torch/linalg/supernodal.py)
against the JAX package's (galahad_tpu/linalg/supernodal.py) on the same
patterns and values, float64, the port on the CPU (its factor wrappers take
their plain versions there: ldlt_kernels.partial_ldlt_plain for fronts of
up to 128, partial_ldlt_wide_plain above).  Mirrors tests/test_supernodal.py.

What is held: the plan equals the JAX plan (perm, every group's frows,
ncols, nrows, Cmax, Fpad, B, the A-entry maps and the extend-add maps); the
factor's specified entries (the eliminated columns on and below the
diagonal, the trailing Schur square) within 1e-12 of the JAX package's
(relative to the largest entry), dmin within 1e-12 relative and the inertia
equal; the solve within 1e-10 relative of the JAX package's solve, and the
residual below 1e-10.  Cases: a grid QP's KKT matrix, a random SPD matrix, a
quasi-definite matrix with a signed shift vector, a disconnected pattern, and
one dense front wider than 128 (the wide route).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from galahad_tpu.linalg import supernodal as J
from galahad_tpu_torch.convert import supernodal_symbolic_from_numpy
from galahad_tpu_torch.core.sparse import COOPattern
from galahad_tpu_torch.linalg import sbls as t_sbls
from galahad_tpu_torch.linalg import supernodal as T
from galahad_tpu_torch.linalg.ldlt_kernels import wide_plain_count
from galahad_tpu_torch.linalg.sls import SLSControl, sls_factorize, sls_solve

from _torch_port_helpers import grid_qp_arrays, kkt_pattern, one_torch_thread, rel  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def grid_laplacian(k, shift=0.1):
    n = k * k
    idx = np.arange(n).reshape(k, k)
    r = [np.arange(n)]
    c = [np.arange(n)]
    v = [np.full(n, 4.0 + shift)]
    for a, b in ((idx[:, 1:], idx[:, :-1]), (idx[1:, :], idx[:-1, :])):
        r += [a.ravel(), b.ravel()]
        c += [b.ravel(), a.ravel()]
        v += [np.full(a.size, -1.0)] * 2
    return sp.csr_matrix((np.concatenate(v), (np.concatenate(r), np.concatenate(c))),
                         shape=(n, n))


def qd_kkt(n=40, m=15, delta=1e-2):
    G = sp.random(n, n, density=0.12, random_state=1)
    G = (G @ G.T).tocsr() + sp.eye(n) * 2.0
    A = sp.random(m, n, density=0.2, random_state=2).tocsr()
    return sp.bmat([[G, A.T], [A, -delta * sp.eye(m)]]).tocsr(), n, m


def grid_kkt(k=5):
    n, m, kw = grid_qp_arrays(k)
    ii, jj, vv = kw["h_coo"]
    ar, ac, av = kw["a_coo"]
    rows, cols, N = kkt_pattern(COOPattern(ii, jj, n, n), COOPattern(ar, ac, m, n), n)
    vals = np.concatenate([vv, av, np.full(n, 0.1), -np.full(m, 0.1)])
    K = sp.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()
    return K + sp.triu(K, 1).T + sp.tril(K, -1).T, (rows, cols, vals), (n, m)


def lower(M):
    Ml = sp.tril(sp.csr_matrix(M)).tocoo()
    return Ml.row, Ml.col, Ml.data


def dense_spd(n=150):
    r = np.random.default_rng(11)
    B = r.normal(size=(n, n))
    return B @ B.T / n + np.eye(n)


def cases():
    """name -> (full matrix as scipy, (rows, cols, vals), shift, expected inertia)."""
    out = {}
    K, coo, (n, m) = grid_kkt()
    out["grid_kkt"] = (K, coo, 0.0, [n, m, 0])
    M = sp.random(25, 25, density=0.15, random_state=7)
    A = sp.csr_matrix((M @ M.T).toarray() + 5 * np.eye(25))
    out["random_spd"] = (A, lower(A), 0.0, [25, 0, 0])
    Kq, n, m = qd_kkt(delta=0.0)
    shift = np.concatenate([np.full(n, 0.5), np.full(m, -0.5)])
    out["signed_shift"] = (Kq + sp.diags(shift), lower(Kq), shift, [n, m, 0])
    A1 = grid_laplacian(3).toarray()
    D = sp.csr_matrix(np.block([[A1, np.zeros((9, 9))], [np.zeros((9, 9)), 2 * A1]]))
    out["disconnected"] = (D, lower(D), 0.0, [18, 0, 0])
    W = dense_spd()
    out["wide"] = (sp.csr_matrix(W), lower(W), 0.0, [150, 0, 0])
    return out


CASES = cases()
_JAX = {}


def jax_run(name):
    """The JAX package's plan, factors and solve of one case (cached)."""
    if name not in _JAX:
        K, (r, c, v), shift, _ = CASES[name]
        sym = J.supernodal_analyse(r, c, K.shape[0])
        s = jnp.asarray(shift) if np.ndim(shift) else shift
        # jitted: one compile of the whole program (the eager inline path
        # compiles each group's loops on its own, several times slower)
        fac = jax.jit(lambda v: J.supernodal_factorize(sym, v, shift=s))(jnp.asarray(v))
        b = np.random.default_rng(3).normal(size=K.shape[0])
        x = np.asarray(jax.jit(lambda f, b: J.supernodal_solve(sym, f, b))(fac, jnp.asarray(b)))
        _JAX[name] = (sym, fac, b, x)
    return _JAX[name]


def port_run(name, sym=None):
    K, (r, c, v), shift, _ = CASES[name]
    sym = sym or T.supernodal_analyse(r, c, K.shape[0])
    fac = T.supernodal_factorize(sym, torch.as_tensor(v),
                                 shift=torch.as_tensor(shift) if np.ndim(shift) else shift)
    return sym, fac


def assert_same_plan(js, ts):
    assert np.array_equal(js.perm, ts.perm) and np.array_equal(js.iperm, ts.iperm)
    assert (js.n, js.nnz_L, js.ns, js.flops) == (ts.n, ts.nnz_L, ts.ns, ts.flops)
    assert len(js.levels) == len(ts.levels)
    for a, b in zip(js.levels, ts.levels):
        assert (a.Cmax, a.Fpad, a.B) == (b.Cmax, b.Fpad, b.B)
        for k in ("frows", "ncols", "nrows", "a_node", "a_fi", "a_fj", "a_src"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
        assert len(a.ea) == len(b.ea)
        for ea, eb in zip(a.ea, b.ea):
            assert ea["src_level"] == eb["src_level"]
            for k in ("src_nodes", "dst_nodes", "cpos", "ppos", "uvalid"):
                assert np.array_equal(ea[k], eb[k]), k


def specified(plan):
    """The entries of a (nb, Fpad, Fpad) group both packages define."""
    r = np.arange(plan.Fpad)
    nc = plan.ncols[:, None, None]
    col_elim = (r[None, None, :] < nc) & (r[None, :, None] >= r[None, None, :])
    schur = (r[None, :, None] >= nc) & (r[None, None, :] >= nc)
    return col_elim | schur


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_equals_jax(name):
    K, (r, c, v), _, _ = CASES[name]
    assert_same_plan(J.supernodal_analyse(r, c, K.shape[0]),
                     T.supernodal_analyse(r, c, K.shape[0]))


@pytest.mark.parametrize("order", ["amd", "rcm", "natural", "nd", "best"])
def test_plan_orders(order):
    """tests/test_supernodal.py's orderings, on the 6 x 6 grid."""
    r, c, _ = lower(grid_laplacian(6))
    assert_same_plan(J.supernodal_analyse(r, c, 36, order=order, relax_cols=4),
                     T.supernodal_analyse(r, c, 36, order=order, relax_cols=4))


@pytest.mark.parametrize("name", sorted(CASES))
def test_factor_and_solve_match_jax(name):
    K, _, _, inertia = CASES[name]
    jsym, jfac, b, xj = jax_run(name)
    # the JAX plan carried across: both factorizations on one plan
    tsym = supernodal_symbolic_from_numpy(jsym)
    plain0 = wide_plain_count()
    tsym, tfac = port_run(name, tsym)
    err = 0.0
    for l, plan in enumerate(tsym.levels):
        Fj = np.asarray(jfac.levels[l])
        Ft = tfac.front(tsym, l).numpy()
        mask = specified(plan)
        err = max(err, np.abs(np.where(mask, Fj - Ft, 0.0)).max() / max(1.0, np.abs(Fj).max()))
    assert err <= 1e-12, err
    assert abs(float(jfac.dmin) - float(tfac.dmin)) <= 1e-12 * abs(float(jfac.dmin))
    assert tfac.inertia.tolist() == np.asarray(jfac.inertia).tolist() == inertia
    xt = T.supernodal_solve(tsym, tfac, torch.as_tensor(b)).numpy()
    assert rel(xj, xt) <= 1e-10
    assert np.linalg.norm(K @ xt - b) / np.linalg.norm(b) <= 1e-10
    wide = any(p.Fpad > 128 for p in tsym.levels)
    assert (wide_plain_count() > plain0) == wide == (name == "wide")


def test_two_factorizations_bitwise():
    sym, f1 = port_run("grid_kkt")
    _, f2 = port_run("grid_kkt", sym)
    assert all(torch.equal(a, b) for a, b in zip(f1.levels, f2.levels))
    b = torch.as_tensor(np.random.default_rng(0).normal(size=sym.n))
    assert torch.equal(T.supernodal_solve(sym, f1, b), T.supernodal_solve(sym, f2, b))


def test_shift_regularization():
    """A singular diagonal matrix plus a scalar shift (tests/test_supernodal.py)."""
    n = 10
    r, c, v = np.arange(n), np.arange(n), np.arange(n, dtype=float)
    jsym = J.supernodal_analyse(r, c, n, order="natural")
    xj = np.asarray(J.supernodal_solve(jsym, J.supernodal_factorize(jsym, jnp.asarray(v),
                                                                   shift=1.0),
                                       jnp.ones(n)))
    tsym = T.supernodal_analyse(r, c, n, order="natural")
    xt = T.supernodal_solve(tsym, T.supernodal_factorize(tsym, torch.as_tensor(v), shift=1.0),
                            torch.ones(n, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(xt, 1.0 / (np.arange(n) + 1.0), atol=1e-12)
    assert rel(xj, xt) <= 1e-12


def test_indefinite_dense_vs_eigh():
    """A symmetric indefinite matrix in natural order: the inertia is the
    eigenvalue count, as in the JAX package."""
    rng = np.random.default_rng(7)
    n = 12
    B = rng.normal(size=(n, n))
    M = (B + B.T) / 2 + np.diag(10.0 * np.sign(rng.normal(size=n)))
    r, c, v = lower(M)
    jsym = J.supernodal_analyse(r, c, n, order="natural")
    jfac = J.supernodal_factorize(jsym, jnp.asarray(v))
    tsym = T.supernodal_analyse(r, c, n, order="natural")
    tfac = T.supernodal_factorize(tsym, torch.as_tensor(v))
    lam = np.linalg.eigvalsh(M)
    expect = [int((lam > 0).sum()), int((lam < 0).sum()), 0]
    assert tfac.inertia.tolist() == np.asarray(jfac.inertia).tolist() == expect
    b = rng.normal(size=n)
    x = T.supernodal_solve(tsym, tfac, torch.as_tensor(b)).numpy()
    assert np.linalg.norm(M @ x - b) < 1e-9
    assert rel(np.asarray(J.supernodal_solve(jsym, jfac, jnp.asarray(b))), x) <= 1e-10


def test_sls_facade_and_kkt_plan_inline():
    """``sls`` "supernodal" and ``sparse_kkt_plan(backend="inline")`` against
    the flat backend on the same KKT system."""
    K, (r, c, v), _, _ = CASES["grid_kkt"]
    sym = T.supernodal_analyse(r, c, K.shape[0])
    f = sls_factorize((sym, torch.as_tensor(v)), SLSControl(solver="supernodal"), device="cpu")
    b = np.random.default_rng(5).normal(size=K.shape[0])
    x = sls_solve(f, torch.as_tensor(b)).numpy()
    assert np.linalg.norm(K @ x - b) / np.linalg.norm(b) < 1e-10

    n, m, kw = grid_qp_arrays(5)
    hp, ap = COOPattern(*kw["h_coo"][:2], n, n), COOPattern(*kw["a_coo"][:2], m, n)
    args = (torch.as_tensor(kw["h_coo"][2]), torch.as_tensor(kw["a_coo"][2]),
            torch.full((n,), 0.3, dtype=torch.float64), torch.full((m,), 0.2, dtype=torch.float64))
    rhs = torch.as_tensor(np.random.default_rng(6).normal(size=n + m))
    out = {}
    for backend in ("inline", "flat"):
        plan = t_sbls.sparse_kkt_plan(hp, ap, n, backend=backend)
        fac = t_sbls.sparse_kkt_factorize(plan, *args, rho=1e-8, delta=1e-8)
        out[backend] = plan.solve(fac, rhs)
        assert fac[0].inertia.tolist() == [n, m, 0]
    assert isinstance(t_sbls.sparse_kkt_plan(hp, ap, n, backend="inline").sym,
                      T.SupernodalSymbolic)
    assert rel(out["flat"], out["inline"]) <= 1e-10
    with pytest.raises(ValueError, match="unknown sparse KKT backend"):
        t_sbls.sparse_kkt_plan(hp, ap, n, backend="nope")


def test_zero_padding_leaves_the_fronts_bitwise():
    """The inline path pads a group's fronts with zero rows and columns to the
    kernel's size: the plain factor of the padded fronts equals that of the
    unpadded ones bit for bit on every defined entry, and the padding stays 0."""
    from galahad_tpu_torch.linalg.ldlt_kernels import partial_ldlt_plain

    r = np.random.default_rng(4)
    for Fpad, K in ((24, 32), (40, 64), (104, 128)):
        G = r.normal(size=(5, Fpad, Fpad))
        F = torch.as_tensor(G @ G.transpose(0, 2, 1) / Fpad + np.eye(Fpad))
        ncols = torch.as_tensor([0, 1, Fpad // 2, Fpad - 1, Fpad], dtype=torch.int32)
        P = torch.zeros(5, K, K, dtype=torch.float64)
        P[:, :Fpad, :Fpad] = F
        a = partial_ldlt_plain(F, ncols)
        b = partial_ldlt_plain(P, ncols)
        plan = T.LevelPlan(frows=np.zeros((5, Fpad), np.int32), ncols=ncols.numpy(),
                           nrows=None, Cmax=Fpad, Fpad=Fpad, B=8, a_node=None, a_fi=None,
                           a_fj=None, a_src=None, ea=[])
        mask = torch.as_tensor(specified(plan))
        assert torch.equal(torch.where(mask, a, 0.0), torch.where(mask, b[:, :Fpad, :Fpad], 0.0))
        assert not bool(b[:, Fpad:, :].any())
