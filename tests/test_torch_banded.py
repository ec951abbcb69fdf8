"""The port's block-tridiagonal factorization and solves (linalg/banded.py, on
the CPU: the plain versions of the kernels of csrc/banded.cu) against the
JAX package's, on the same numpy-seeded block-tridiagonal matrices.

What is held, at b in {1, 4, 8} x k in {1, 2, 9}: the factors Ld and Lo and
the solutions, of one right-hand side and of three, within 1e-12 relative to
the largest entry of the JAX result, the same ``ok`` flag, and the matvec
within 1e-14; a matrix whose third block is not positive definite gives
``ok`` False and the identity as that block's factor in both packages;
``band_to_blocks`` gives the JAX package's blocks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg import banded as J

from galahad_tpu_torch.linalg import banded as T
from galahad_tpu_torch.linalg import banded_kernels

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12
SHAPES = [(b, k) for b in (1, 4, 8) for k in (1, 2, 9)]


def close(t, j, tol=TOL):
    j = np.asarray(j)
    assert t.shape == j.shape
    if j.size == 0:
        return
    assert np.abs(t.numpy() - j).max() <= tol * max(1.0, np.abs(j).max())


def blocks(k, b, seed, bad_block=None):
    """(D, L) of a block-tridiagonal SPD matrix (block diagonally dominant);
    ``bad_block``: make that diagonal block negative definite."""
    rng = np.random.default_rng(seed)
    L = rng.uniform(-1.0, 1.0, (max(k - 1, 0), b, b))
    G = rng.uniform(-1.0, 1.0, (k, b, b))
    D = G @ G.transpose(0, 2, 1) + 3.0 * b * np.eye(b)
    if bad_block is not None:
        D[bad_block] = -D[bad_block]
    return D, L


def pair(D, L):
    return (J.block_tridiag_cholesky(jnp.asarray(D), jnp.asarray(L)),
            T.block_tridiag_cholesky(torch.as_tensor(D), torch.as_tensor(L)))


@pytest.mark.parametrize("b,k", SHAPES)
def test_cholesky_matches_reference(b, k):
    fj, ft = pair(*blocks(k, b, seed=10 * b + k))
    close(ft.Ld, fj.Ld)
    close(ft.Lo, fj.Lo)
    assert bool(ft.ok) == bool(fj.ok) is True
    assert ft.ok.dtype == torch.bool and ft.ok.dim() == 0


@pytest.mark.parametrize("b,k", SHAPES)
@pytest.mark.parametrize("r", [None, 3])
def test_solve_matches_reference(b, k, r):
    D, L = blocks(k, b, seed=100 + 10 * b + k)
    fj, ft = pair(D, L)
    rng = np.random.default_rng(b * k)
    rhs = rng.normal(size=(k, b) if r is None else (k, b, r))
    xt = T.block_tridiag_solve(ft, torch.as_tensor(rhs))
    close(xt, J.block_tridiag_solve(fj, jnp.asarray(rhs)))
    # and it solves the system
    back = T.block_tridiag_matvec(torch.as_tensor(D), torch.as_tensor(L), xt)
    assert np.abs(back.numpy() - rhs).max() <= 1e-12 * max(1.0, np.abs(rhs).max())


@pytest.mark.parametrize("b,k", SHAPES)
def test_matvec_matches_reference(b, k):
    D, L = blocks(k, b, seed=200 + 10 * b + k)
    x = np.random.default_rng(3).normal(size=(k, b, 2))
    for xx in (x[..., 0], x):
        close(T.block_tridiag_matvec(torch.as_tensor(D), torch.as_tensor(L), torch.as_tensor(xx)),
              J.block_tridiag_matvec(jnp.asarray(D), jnp.asarray(L), jnp.asarray(xx)), tol=1e-14)


@pytest.mark.parametrize("b", [1, 4, 8])
def test_a_block_that_is_not_positive_definite(b):
    """The third block fails: ok is False and its factor is the identity in
    both packages; the factorization goes on from it."""
    fj, ft = pair(*blocks(9, b, seed=7, bad_block=2))
    assert bool(fj.ok) is False and bool(ft.ok) is False
    eye = np.eye(b)
    assert np.array_equal(np.asarray(fj.Ld[2]), eye)
    assert torch.equal(ft.Ld[2], torch.eye(b, dtype=ft.Ld.dtype))
    close(ft.Ld, fj.Ld)
    close(ft.Lo, fj.Lo)


def test_plain_calls_are_counted():
    before = banded_kernels.banded_counts()
    D, L = blocks(3, 2, seed=1)
    f = T.block_tridiag_cholesky(torch.as_tensor(D), torch.as_tensor(L))
    T.block_tridiag_solve(f, torch.ones(3, 2, dtype=torch.float64))
    after = banded_kernels.banded_counts()
    assert after["factor_plain"] == before["factor_plain"] + 1
    assert after["solve_plain"] == before["solve_plain"] + 1
    assert (after["factor"], after["solve"]) == (before["factor"], before["solve"])


@pytest.mark.parametrize("n,b", [(10, 4), (12, 4), (7, 3)])
def test_band_to_blocks_matches_reference(n, b):
    band = np.random.default_rng(n).normal(size=(b, n))
    Dj, Lj = J.band_to_blocks(band, n, b)
    Dt, Lt = T.band_to_blocks(band, n, b, device="cpu")
    close(Dt, Dj, tol=0.0)
    close(Lt, Lj, tol=0.0)
