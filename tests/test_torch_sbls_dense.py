"""The port's dense Cholesky utilities (linalg/cholesky.py) and SBLS's dense
Schur-complement mode (linalg/sbls.py) against the JAX package's, on the
same numpy-seeded matrices.

What is held: factors, solutions and residuals within 1e-12 relative; on a
matrix the first try cannot factorize, the same success flag and the same
escalated shift, and a factor that reproduces the shifted matrix to 1e-12
relative (the trailing block of a nearly singular matrix's factor is itself
ill-conditioned, so there the two factors are compared through what they
reproduce); ``chol_ok`` false where LAPACK reports failure."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg import cholesky as j_chol
from galahad_tpu.linalg import sbls as j_sbls

from galahad_tpu_torch.linalg import cholesky as t_chol
from galahad_tpu_torch.linalg import sbls as t_sbls

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12


def close(t, j, tol=TOL):
    j = np.asarray(j)
    assert np.abs(t.numpy() - j).max() <= tol * max(1.0, np.abs(j).max())


def spd(n, seed, rank=None):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(n, rank or n))
    return B @ B.T + (0.0 if rank else 0.5) * np.eye(n)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_factor_and_solve(rhs):
    M = spd(12, 0)
    b = np.random.default_rng(1).normal(size=(12,) if rhs == "vector" else (12, 3))
    Lj = j_chol.chol_factor(jnp.asarray(M))
    Lt, info = t_chol.chol_factor(torch.as_tensor(M))
    close(Lt, Lj)
    assert int(info) == 0 and bool(t_chol.chol_ok(Lt, info)) and bool(j_chol.chol_ok(Lj))
    close(t_chol.chol_solve(Lt, torch.as_tensor(b)), j_chol.chol_solve(Lj, jnp.asarray(b)))


@pytest.mark.parametrize("case", ["spd", "semidefinite", "indefinite"])
def test_factor_shifted(case):
    """The first try and the escalation give the JAX package's shift and
    flag; the first try alone (max_tries=0) reports the failure."""
    M = {"spd": spd(10, 2), "semidefinite": spd(10, 3, rank=6),
         "indefinite": spd(10, 4) - 30.0 * np.eye(10)}[case]
    Lj, sj, okj = j_chol.chol_factor_shifted(jnp.asarray(M), 0.0)
    Lt, shift, ok = t_chol.chol_factor_shifted(torch.as_tensor(M), 0.0)
    assert bool(ok) == bool(okj)
    assert float(shift) == float(sj)
    if bool(okj):
        target = M + float(sj) * np.eye(10)
        for L in (np.asarray(Lj), Lt.numpy()):
            assert np.abs(L @ L.T - target).max() <= TOL * np.abs(target).max()
    _, s0, ok0 = t_chol.chol_factor_shifted(torch.as_tensor(M), 0.0, max_tries=0)
    assert float(s0) == 0.0 and bool(ok0) == (case == "spd")


@pytest.mark.parametrize("g", ["diagonal", "dense"])
@pytest.mark.parametrize("m", [1, 5])
def test_sbls_factorize_solve_residual(g, m):
    rng = np.random.default_rng(m)
    n = 9
    A = rng.normal(size=(m, n))
    C = np.where(np.arange(m) % 2 == 0, 0.0, rng.uniform(0.1, 1.0, m))
    G = rng.uniform(0.5, 2.0, n) if g == "diagonal" else spd(n, m)
    b1, b2 = rng.normal(size=n), rng.normal(size=m)
    apply_j = (lambda v: jnp.asarray(G) * v) if g == "diagonal" else (lambda v: jnp.asarray(G) @ v)
    Gt = torch.as_tensor(G)
    apply_t = (lambda v: Gt * v) if g == "diagonal" else (lambda v: Gt @ v)
    fj = j_sbls.sbls_factorize(jnp.asarray(G), jnp.asarray(A), jnp.asarray(C),
                               g_is_diag=g == "diagonal", rho=1e-10, delta=1e-10)
    ft = t_sbls.sbls_factorize(Gt, torch.as_tensor(A), torch.as_tensor(C),
                               g_is_diag=g == "diagonal", rho=1e-10, delta=1e-10)
    assert bool(ft.ok) == bool(fj.ok) and bool(ft.chol_ok)
    close(ft.L_S, fj.L_S)
    if g == "dense":
        close(ft.L_G, fj.L_G)
    xj, yj = j_sbls.sbls_solve(fj, jnp.asarray(b1), jnp.asarray(b2), apply_G=apply_j)
    xt, yt = t_sbls.sbls_solve(ft, torch.as_tensor(b1), torch.as_tensor(b2), apply_G=apply_t)
    close(xt, xj, 1e-10)
    close(yt, yj, 1e-10)
    rj = j_sbls.sbls_residual(fj, apply_j, xj, yj, jnp.asarray(b1), jnp.asarray(b2))
    rt = t_sbls.sbls_residual(ft, apply_t, xt, yt, torch.as_tensor(b1), torch.as_tensor(b2))
    assert float(rt) <= 1e-12 and float(rj) <= 1e-12


def test_sbls_first_try_flags_a_singular_g():
    """A G that the first try cannot factorize: ``chol_ok`` is False with
    max_tries=0, and the escalated factorization gives the JAX package's
    regularization rho, with a factor of G + rho I that reproduces it to
    1e-12 relative in both packages.  (The Schur-complement solve with a G
    this close to singular is not backward stable in either package, so the
    solutions are not compared here; the solve is held on well-posed G
    above.)"""
    rng = np.random.default_rng(7)
    n, m = 8, 3
    G = spd(n, 8, rank=5)
    A = rng.normal(size=(m, n))
    C = np.full(m, 0.5)
    first = t_sbls.sbls_factorize(torch.as_tensor(G), torch.as_tensor(A), torch.as_tensor(C),
                                  max_tries=0)
    assert not bool(first.chol_ok) and not bool(first.ok)
    fj = j_sbls.sbls_factorize(jnp.asarray(G), jnp.asarray(A), jnp.asarray(C))
    ft = t_sbls.sbls_factorize(torch.as_tensor(G), torch.as_tensor(A), torch.as_tensor(C))
    assert bool(ft.chol_ok) and bool(ft.ok) and bool(fj.ok)
    assert float(ft.rho) == float(fj.rho) > 0
    target = G + float(fj.rho) * np.eye(n)
    for L in (np.asarray(fj.L_G), ft.L_G.numpy()):
        assert np.abs(L @ L.T - target).max() <= TOL * np.abs(target).max()
