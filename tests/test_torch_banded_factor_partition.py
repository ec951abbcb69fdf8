"""The schedule of the port's block-tridiagonal factor kernel, on the CPU.

``linalg/banded.py::block_tridiag_cholesky_partitioned_plain`` runs the
kernel's schedule (csrc/banded.cu) in plain PyTorch: the block rows in
chunks, the interior of each middle chunk factored from no inflow and folded
onto its end rows (E, F, G), the separators' Schur complements Sigma resolved
in chunk order, and the contract's chain run again in each chunk from
chol(Sigma).  Only the inflows carry the partitioning's rounding; this is
where an unstable fold would show without a card.

What is held:
  * at chunk in {1, 7, 64, k} x k in {1, 2, 37, 300} x b in {1, 3, 8}, on
    block diagonally dominant matrices: Ld and Lo against the sequential
    plain factor and the JAX package's ``block_tridiag_cholesky``, each
    within 1e-12 relative to the largest |entry| of that reference (f64);
  * on the blocks that the port's CPU ``ipm_solve_banded`` factors at its
    last iteration (n = 2,000, block 8, k = 250; the banded LP's Schur
    complement, and G of the tridiagonal-H QP with no constraints): the
    relative residual of the sequential solve on the partitioned factor
    within 10 x the sequential factor's + 1e-15, at every chunk size;
  * a negative-definite block at P > 1, wherever it falls (chunk 0, a middle
    chunk's interior, a separator, the last chunk): ``ok`` False and the
    sequential plain factor exactly;
  * ``factor_schedule`` and ``default_factor_chunk``: one chunk where the
    partition would not shorten the model's critical path (and for blocks
    above 16), a far shorter path at the flagship band's k = 125,000.

About 7.5 s in the 6-worker run (its own worker; the JAX factor's compiles
and the two CPU solves of the late-iteration blocks are most of it).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg import banded as J

from galahad_tpu_torch.linalg import banded as T
from galahad_tpu_torch.linalg import banded_kernels

from _torch_port_helpers import one_torch_thread  # noqa: F401
from test_torch_banded_partition import KS, blocks, last_iteration_blocks, rel_residual

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12


def close(t, ref, tol=TOL):
    ref = np.asarray(ref)
    assert t.shape == ref.shape
    assert np.abs(t.numpy() - ref).max(initial=0.0) <= tol * max(1.0, np.abs(ref).max(initial=0.0))


@functools.lru_cache(maxsize=None)
def jax_factor():
    """The JAX package's factor as one compiled program a shape (~0.25 s
    each; called eagerly its ops compile one by one, ~2.5 x longer)."""
    return jax.jit(J.block_tridiag_cholesky)


@functools.lru_cache(maxsize=None)
def factors(k, b):
    """(D, L, the sequential plain factor, the JAX factor)."""
    D, L = blocks(k, b, seed=10 * k + b)
    f = T.block_tridiag_cholesky_plain(torch.as_tensor(D), torch.as_tensor(L))
    fj = jax_factor()(jnp.asarray(D), jnp.asarray(L))
    return torch.as_tensor(D), torch.as_tensor(L), f, fj


@pytest.mark.parametrize("b", [1, 3, 8])
def test_the_partitioned_factor_matches_the_sequential_and_jax_factors(b):
    for k in KS:
        D, L, f, fj = factors(k, b)
        for chunk in (1, 7, 64, k):
            g = T.block_tridiag_cholesky_partitioned_plain(D, L, chunk)
            assert bool(g.ok), (k, chunk)
            for got, seq, jax_ in ((g.Ld, f.Ld, fj.Ld), (g.Lo, f.Lo, fj.Lo)):
                close(got, seq.numpy())
                close(got, np.asarray(jax_))
            if -(-k // chunk) == 1:
                assert torch.equal(g.Ld, f.Ld) and torch.equal(g.Lo, f.Lo)


@pytest.mark.parametrize("problem", ["lp", "m0"])
def test_the_partitioned_factor_on_a_late_iteration_factor(problem):
    """Held by residual, not by forward error: the forward error of a
    late-iteration factor measures its conditioning, not the schedule."""
    D, L = last_iteration_blocks(problem)
    k, b, _ = D.shape
    assert (k, b) == (250, 8)
    f = T.block_tridiag_cholesky_plain(D, L)
    assert bool(f.ok)
    for r in (None, 3):
        rhs = torch.as_tensor(np.random.default_rng(6).normal(
            size=(k, b) if r is None else (k, b, r)))
        res_seq = rel_residual(D, L, T.block_tridiag_solve_plain(f, rhs), rhs)
        for chunk in (1, 7, 64, 250):
            g = T.block_tridiag_cholesky_partitioned_plain(D, L, chunk)
            assert bool(g.ok)
            x = T.block_tridiag_solve_plain(g, rhs)
            assert bool(torch.isfinite(x).all())
            assert rel_residual(D, L, x, rhs) <= 10.0 * res_seq + 1e-15, (chunk, r)


def test_a_failed_pivot_gives_the_sequential_factor():
    """k = 40 in chunks of 7 (separators 6, 13, ..., 34; the last chunk 35 ..
    39): the bad block in chunk 0, a middle interior, on a separator, in the
    last chunk; and chunks of one row."""
    for b in (1, 3, 8):
        for bad, chunk in ((2, 7), (9, 7), (13, 7), (37, 7), (20, 1)):
            D, L = blocks(40, b, seed=b)
            D = torch.as_tensor(D)
            D[bad] = -D[bad]
            L = torch.as_tensor(L)
            g = T.block_tridiag_cholesky_partitioned_plain(D, L, chunk)
            f = T.block_tridiag_cholesky_plain(D, L)
            assert not bool(g.ok) and not bool(f.ok)
            assert torch.equal(g.Ld, f.Ld) and torch.equal(g.Lo, f.Lo), (b, bad, chunk)


def test_the_factor_schedule():
    for k in (2, 300, 125_000):                 # blocks of 17..32 run the sequential chain
        assert banded_kernels.default_factor_chunk(k, 32) == k
    for b in (1, 8, 16):
        for k in (1, 2, 5):
            assert banded_kernels.default_factor_chunk(k, b) == k
        one = banded_kernels.factor_schedule(125_000, 125_000, b)
        assert one["chunks"] == 1
        m = banded_kernels.default_factor_chunk(125_000, b)
        s = banded_kernels.factor_schedule(125_000, m, b)
        assert s["chunk"] == m and s["chunks"] == -(-125_000 // m)
        assert 50 < m < 5_000
        assert s["critical_path_us"] < one["critical_path_us"] / 20
    for k in KS + (2500,):
        m = banded_kernels.default_factor_chunk(k, 8)
        assert 1 <= m <= k
        assert (banded_kernels.factor_schedule(k, m, 8)["critical_path_us"]
                <= banded_kernels.factor_schedule(k, k, 8)["critical_path_us"])
