"""Numeric flat supernodal LDL^T of the port against the JAX package's
(``flat_factorize`` / ``flat_solve``) on the same plan and values: the
factor store on the entries the storage contract specifies, dmin, inertia
and the solution.  Mirrors the cases of tests/test_supernodal.py (grid,
tridiagonal, random SPD, disconnected, scalar shift, signed shift vector,
quasi-definite inertia).

Tolerance: 1e-12 relative to the largest specified entry of the store
(float64; the two sides sum the same products in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from galahad_tpu.linalg import supernodal_flat as J

from galahad_tpu_torch.linalg import supernodal_flat as T

from _torch_port_helpers import grid_laplacian


def specified_mask(plan):
    """Boolean mask over the flat store: lower triangle of eliminated
    columns and the trailing square of every front."""
    mask = np.zeros(plan.S, bool)
    for g in plan.groups:
        ar = np.arange(g.Fpad)
        nc = np.asarray(g.ncols)[:, None, None]
        r, c = ar[None, :, None], ar[None, None, :]
        mg = ((c < nc) & (r >= c)) | ((r >= nc) & (c >= nc))
        mask[g.goff:g.goff + g.nb * g.Fpad * g.Fpad] = mg.ravel()
    return mask


def both(A, order="amd", relax=4, shift=0.0, seed=1):
    """Factor and solve on both sides; returns the comparison record."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    Al = sp.tril(A).tocoo()
    pj = J.flat_analyse(Al.row, Al.col, n, order=order, relax_cols=relax)
    pt = T.flat_analyse(Al.row, Al.col, n, order=order, relax_cols=relax)
    jshift = jnp.asarray(shift) if np.ndim(shift) else shift
    tshift = torch.as_tensor(shift) if np.ndim(shift) else shift
    fj = J.flat_factorize(pj, jnp.asarray(Al.data), jshift)
    ft = T.flat_factorize(pt, torch.as_tensor(Al.data), tshift)
    b = np.random.default_rng(seed).normal(size=n)
    xj = np.asarray(J.flat_solve(pj, fj, jnp.asarray(b)))
    xt = T.flat_solve(pt, ft, torch.as_tensor(b)).numpy()
    mask = specified_mask(pt)
    sj = np.asarray(fj.store)[:pt.S][mask]
    st = ft.store.numpy()[:pt.S][mask]
    As = A + (sp.diags(shift) if np.ndim(shift) else shift * sp.eye(n))
    return dict(
        store_err=np.abs(sj - st).max() / max(np.abs(sj).max(), 1e-300),
        dmin=(float(fj.dmin), float(ft.dmin)),
        inertia=(np.asarray(fj.inertia).tolist(), ft.inertia.tolist()),
        x_err=np.abs(xj - xt).max() / max(np.abs(xj).max(), 1e-300),
        resid=np.linalg.norm(As @ xt - b) / np.linalg.norm(b),
        spare=float(ft.store[pt.S]), plan=pt)


def holds(rec, resid=1e-12):
    assert rec["store_err"] < 1e-12
    assert abs(rec["dmin"][0] - rec["dmin"][1]) <= 1e-12 * abs(rec["dmin"][0])
    assert rec["inertia"][0] == rec["inertia"][1]
    assert rec["x_err"] < 1e-10
    assert rec["resid"] < resid
    assert rec["spare"] == 0.0       # the sentinel slot of the store stays 0


def kkt_matrix(n=40, m=15, delta=1e-2):
    G = sp.random(n, n, density=0.12, random_state=1)
    G = (G @ G.T).tocsr() + sp.eye(n) * 2.0
    A = sp.random(m, n, density=0.2, random_state=2).tocsr()
    return sp.bmat([[G, A.T], [A, -delta * sp.eye(m)]]).tocsr(), n, m


@pytest.mark.parametrize("order", ["amd", "rcm", "natural", "nd"])
def test_grid(order):
    holds(both(grid_laplacian(6), order))


def test_grid_larger_with_wide_fronts():
    rec = both(grid_laplacian(20), "amd", relax=16)
    holds(rec)
    assert max(g.Fpad for g in rec["plan"].groups) >= 64


def test_front_wider_than_the_kernel_takes():
    """A dense 160 x 160 block hanging off a chain: its front is padded to
    192 > 128 and goes through the blocked composition and multi-panel
    sweeps."""
    rng = np.random.default_rng(11)
    n, nd = 200, 160
    A = np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1) \
        + np.diag(np.full(n - 1, -1.0), -1)
    B = rng.normal(size=(nd, nd)) / np.sqrt(nd)
    A[n - nd:, n - nd:] += B @ B.T + np.eye(nd)
    rec = both(A, "natural", relax=4)
    holds(rec)
    assert max(g.Fpad for g in rec["plan"].groups) > 128


def test_tridiagonal():
    n = 30
    A = (np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    holds(both(A, "natural", relax=0))


def test_random_spd():
    m = sp.random(25, 25, density=0.15, random_state=7)
    holds(both((m @ m.T).toarray() + 5 * np.eye(25), "amd"))


def test_disconnected_components():
    A1 = grid_laplacian(3).toarray()
    Z = np.zeros((9, 9))
    holds(both(np.block([[A1, Z], [Z, 2 * A1]]), "amd"))


def test_scalar_shift_regularization():
    """Singular matrix + shift solves the shifted system."""
    n = 10
    A = sp.csr_matrix(np.diag(np.arange(n, dtype=float)))
    Al = sp.tril(A).tocoo()
    pt = T.flat_analyse(Al.row, Al.col, n, order="natural")
    ft = T.flat_factorize(pt, torch.as_tensor(Al.data), shift=1.0)
    x = T.flat_solve(pt, ft, torch.ones(n, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(x, 1.0 / (np.arange(n) + 1.0), atol=1e-12)
    holds(both(A + sp.eye(n) * 0.0, "natural", shift=1.0))


def test_quasi_definite_inertia_and_solve():
    K, n, m = kkt_matrix()
    rec = both(K, "amd", seed=3)
    holds(rec, resid=1e-10)
    assert rec["inertia"][1] == [n, m, 0] and rec["dmin"][1] > 0


def test_signed_shift_vector():
    """(n,)-vector shift = signed quasi-definite regularization."""
    K, n, m = kkt_matrix(delta=0.0)      # singular (2,2) block
    shift = np.concatenate([np.full(n, 0.5), np.full(m, -0.5)])
    rec = both(K, "amd", shift=shift, seed=4)
    holds(rec, resid=1e-10)
    assert rec["inertia"][1] == [n, m, 0]


def test_indefinite_vs_eigenvalues():
    rng = np.random.default_rng(7)
    n = 12
    B = rng.normal(size=(n, n))
    M = (B + B.T) / 2 + np.diag(10.0 * np.sign(rng.normal(size=n)))
    rec = both(M, "natural", seed=5)
    holds(rec, resid=1e-9)
    lam = np.linalg.eigvalsh(M)
    assert rec["inertia"][1] == [int((lam > 0).sum()), int((lam < 0).sum()), 0]


def test_float32_factor_and_solve():
    """float32 works through the plain version of the kernel and the sweeps
    (tolerance 1e-4: float32 factors of a well-conditioned matrix)."""
    A = grid_laplacian(8)
    Al = sp.tril(A).tocoo()
    pt = T.flat_analyse(Al.row, Al.col, A.shape[0])
    ft = T.flat_factorize(pt, torch.as_tensor(Al.data, dtype=torch.float32))
    assert ft.store.dtype == torch.float32
    b = np.random.default_rng(2).normal(size=A.shape[0]).astype(np.float32)
    x = T.flat_solve(pt, ft, torch.as_tensor(b)).numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-4


def test_two_runs_give_the_same_bits():
    K, n, m = kkt_matrix(60, 25)
    Kl = sp.tril(K).tocoo()
    pt = T.flat_analyse(Kl.row, Kl.col, n + m, relax_cols=16)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=n + m))
    runs = []
    for _ in range(2):
        ft = T.flat_factorize(pt, torch.as_tensor(Kl.data))
        runs.append((ft.store, T.flat_solve(pt, ft, b)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_extend_add_layers_have_distinct_parents():
    """Within one rank of the extend-add's table (the children that the plain
    version adds in one gather-add) no two children share a parent front, so
    the gather-add needs no accumulation; every child record is in the table
    once, the children of a parent together."""
    A = grid_laplacian(20)
    Al = sp.tril(A).tocoo()
    pt = T.flat_analyse(Al.row, Al.col, A.shape[0], relax_cols=16)
    dev = T._device_plan(pt, torch.device("cpu"))
    n_layers = 0
    for lv in dev["levels"]:
        if lv["ea"] is None:
            continue
        pb = lv["ea"].children[:, 3]
        for sel in lv["ea"].layers:
            assert len(np.unique(pb[sel])) == len(sel)
            n_layers += 1
        starts = np.flatnonzero(np.concatenate([[True], pb[1:] != pb[:-1]]))
        assert len(np.unique(pb)) == len(starts)          # one run per parent
    assert n_layers > 0
    assert sum(len(g.ea) for g in pt.groups) == sum(
        len(lv["ea"].children) for lv in dev["levels"] if lv["ea"] is not None)
