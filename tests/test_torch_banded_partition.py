"""The schedule of the port's block-tridiagonal solve kernel, on the CPU.

``linalg/banded.py::block_tridiag_solve_partitioned_plain`` runs the kernel's
schedule (csrc/banded.cu) in plain PyTorch: the block rows in chunks, per
direction a pass from zero inflow that also pushes the unit inflows through
(the chunk's transfer T), the inflows resolved in chunk order, and a second
pass from the true inflow.  Only the inflows carry the partitioning's
rounding; this is where an unstable chunk boundary would show without a card.

What is held:
  * at chunk in {1, 7, 64, k} x k in {1, 2, 37, 300} x b in {1, 3, 8}, one
    right-hand side and three, on block diagonally dominant matrices: the
    sequential plain solve and the JAX package's ``block_tridiag_solve``, each
    within 1e-12 relative to the largest |entry| of that reference (f64);
  * on the blocks that the port's CPU ``ipm_solve_banded`` factors at its
    last iteration (n = 2,000, block 8, k = 250): the banded LP's Schur
    complement, and G = H + D_x of the tridiagonal-H QP with no constraints,
    whose diagonal spans six decades: the relative residual
    ||A x - r|| / (||A|| ||x||) (max norms) within 10 x the sequential
    solve's + 1e-15, at every chunk size;
  * ``solve_schedule``: one chunk is the sequential solve's 2 k steps, the
    default chunk's schedule is far shorter, and the step counts follow the
    phases.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg import banded as J

from galahad_tpu_torch.linalg import banded as T
from galahad_tpu_torch.linalg import banded_kernels

from _torch_port_helpers import banded_problem_fields, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12
KS = (1, 2, 37, 300)


def blocks(k, b, seed):
    """(D, L) of a block-tridiagonal SPD matrix (block diagonally dominant)."""
    rng = np.random.default_rng(seed)
    L = rng.uniform(-1.0, 1.0, (max(k - 1, 0), b, b))
    G = rng.uniform(-1.0, 1.0, (k, b, b))
    D = G @ G.transpose(0, 2, 1) + 3.0 * b * np.eye(b)
    return D, L


def rhs_of(k, b, r):
    return np.random.default_rng(1000 * k + b).normal(size=(k, b) if r is None else (k, b, r))


@functools.lru_cache(maxsize=None)
def references(k, b, r):
    """(the port's factors, the sequential plain solve, the JAX solve)."""
    D, L = blocks(k, b, seed=10 * k + b)
    rhs = rhs_of(k, b, r)
    f = T.block_tridiag_cholesky_plain(torch.as_tensor(D), torch.as_tensor(L))
    seq = T.block_tridiag_solve_plain(f, torch.as_tensor(rhs))
    fj = J.block_tridiag_cholesky(jnp.asarray(D), jnp.asarray(L))
    xj = np.asarray(J.block_tridiag_solve(fj, jnp.asarray(rhs)))
    return f, seq, xj


def close(t, ref, tol=TOL):
    ref = np.asarray(ref)
    assert t.shape == ref.shape
    assert np.abs(t.numpy() - ref).max() <= tol * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("chunk", [1, 7, 64, None])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("r", [None, 3])
def test_the_partitioned_schedule_matches_the_sequential_and_jax_solves(chunk, k, b, r):
    """chunk None: one chunk of all k rows."""
    f, seq, xj = references(k, b, r)
    x = T.block_tridiag_solve_partitioned_plain(f, torch.as_tensor(rhs_of(k, b, r)),
                                                k if chunk is None else chunk)
    close(x, seq.numpy())
    close(x, xj)


def rel_residual(D, L, x, rhs):
    """||A x - rhs|| / (||A|| ||x||), max norms, for the block-tridiagonal A."""
    Ax = T.block_tridiag_matvec(D, L, x)
    rows = D.abs().sum(-1)
    if D.shape[0] > 1:
        rows[1:] += L.abs().sum(-1)
        rows[:-1] += L.abs().sum(-2)
    return float((Ax - rhs).abs().max()) / (float(rows.max()) * float(x.abs().max()))


@functools.lru_cache(maxsize=None)
def last_iteration_blocks(problem):
    """The (D, L) that ``BandedQP.build_kkt`` factors at the last iteration
    of the port's CPU ``ipm_solve_banded`` at n = 2,000, block 8 (k = 250):
    "lp" the banded LP of the reference's bench_banded_lp family (the banded
    Schur complement A D_x^-1 A' + C), "m0" the tridiagonal H with no
    constraints (G = H + D_x, whose diagonal spans six decades there)."""
    from galahad_tpu_torch.convert import banded_qp_from_numpy
    from galahad_tpu_torch.qp import IPMControl, ipm_banded, ipm_solve_banded

    fields = (banded_problem_fields(2000, lp=True, block=8) if problem == "lp"
              else banded_problem_fields(2000, block=8, m=0))
    qp = banded_qp_from_numpy(fields, device="cpu")
    seen = []
    factor = ipm_banded.block_tridiag_cholesky

    def record(D, L):
        seen[:] = [(D.clone(), L.clone())]
        return factor(D, L)

    ipm_banded.block_tridiag_cholesky = record
    try:
        _, _, _, st = ipm_solve_banded(qp, IPMControl())
    finally:
        ipm_banded.block_tridiag_cholesky = factor
    assert st.status == 0 and st.iter > 1
    return seen[0]


@pytest.mark.parametrize("problem", ["lp", "m0"])
@pytest.mark.parametrize("chunk", [1, 7, 64, 250])
@pytest.mark.parametrize("r", [None, 3])
def test_the_partitioned_schedule_on_a_late_iteration_factor(problem, chunk, r):
    """Held by residual, not by forward error: the forward error of a
    late-iteration system measures its conditioning, not the schedule."""
    D, L = last_iteration_blocks(problem)
    k, b, _ = D.shape
    assert (k, b) == (250, 8)
    f = T.block_tridiag_cholesky_plain(D, L)
    assert bool(f.ok)
    rhs = torch.as_tensor(np.random.default_rng(5).normal(size=(k, b) if r is None else (k, b, r)))
    res_seq = rel_residual(D, L, T.block_tridiag_solve_plain(f, rhs), rhs)
    x = T.block_tridiag_solve_partitioned_plain(f, rhs, chunk)
    assert bool(torch.isfinite(x).all())
    assert rel_residual(D, L, x, rhs) <= 10.0 * res_seq + 1e-15


@pytest.mark.parametrize("k", KS + (2500, 125_000))
def test_the_solve_schedule(k):
    one = banded_kernels.solve_schedule(k, k)
    assert one == dict(chunk=k, chunks=1, critical_path_steps=2 * k)
    m = banded_kernels.default_chunk(k)
    s = banded_kernels.solve_schedule(k, m)
    P = -(-k // m)
    last = k - (P - 1) * m
    assert s["chunk"] == min(m, k) and s["chunks"] == P
    if P > 1:
        # each direction: the first chunk's rows, a hop per later chunk, the
        # last chunk's rows (the other chunks' first passes run meanwhile)
        assert s["critical_path_steps"] >= 2 * (m + (P - 1) + last)
    assert s["critical_path_steps"] <= 2 * k
    if k >= 2500:
        assert s["critical_path_steps"] < k / 5


def test_the_schedule_of_chunks_of_one_row():
    """Chunks of one row: a hop per row and two passes of one step each."""
    s = banded_kernels.solve_schedule(37, 1)
    assert s["chunks"] == 37
    assert 2 * (1 + 36 + 1) <= s["critical_path_steps"] <= 2 * (3 * 37)
