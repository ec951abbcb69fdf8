"""The port's scalar tridiagonal LDL' factor and solve
(galahad_tpu_torch/linalg/cholesky.py, on the CPU: the plain versions of the
kernels of csrc/tridiag.cu) against the JAX package's ``tridiag_factor`` /
``tridiag_solve`` (galahad_tpu/linalg/cholesky.py:87 / :109), on the same
numpy-seeded systems: dhat, l and x bitwise equal, in float64 and float32,
unbatched and batched, k = 1 and k = 2 included.  Each step is one fused
multiply-add in both packages (XLA contracts the scan's step, and torch's
addcmul is fused on the CPU), which is what keeps the bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg.cholesky import tridiag_factor as j_factor
from galahad_tpu.linalg.cholesky import tridiag_solve as j_solve

from galahad_tpu_torch.linalg import tridiag_factor, tridiag_solve, tridiag_kernels

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = [(1,), (2,), (5,), (64,), (3, 1), (3, 2), (4, 7), (2, 3, 64), (16, 64)]


def system(shape, seed):
    rng = np.random.default_rng(seed)
    k = shape[-1]
    d = rng.uniform(2.0, 4.0, shape) * np.where(rng.random(shape) < 0.2, -1.0, 1.0)
    e = rng.normal(size=shape[:-1] + (k - 1,))
    b = rng.normal(size=shape)
    return d, e, b


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_factor_and_solve_bitwise(shape, dtype):
    d, e, b = (a.astype(dtype) for a in system(shape, len(shape) * 100 + shape[-1]))
    jd, jl = j_factor(jnp.asarray(d), jnp.asarray(e))
    jx = j_solve(jd, jl, jnp.asarray(b))
    td, tl = tridiag_factor(torch.as_tensor(d), torch.as_tensor(e))
    tx = tridiag_solve(td, tl, torch.as_tensor(b))
    for t, j in ((td, jd), (tl, jl), (tx, jx)):
        assert tuple(t.shape) == tuple(np.shape(j))
        np.testing.assert_array_equal(bits(t.numpy()), bits(j))


def test_solution_solves_the_system():
    """x solves the tridiagonal system (a check of the recurrences beyond the
    parity with the JAX package)."""
    d, e, b = system((8, 40), 7)
    d = np.abs(d) + 2.0
    x = tridiag_solve(*tridiag_factor(torch.as_tensor(d), torch.as_tensor(e)),
                      torch.as_tensor(b)).numpy()
    Tx = d * x
    Tx[:, 1:] += e * x[:, :-1]
    Tx[:, :-1] += e * x[:, 1:]
    assert np.abs(Tx - b).max() <= 1e-13 * np.abs(b).max()


def test_cpu_tensors_take_the_plain_version():
    tridiag_kernels.reset_tridiag_counts()
    d, e, b = system((3, 5), 1)
    tridiag_solve(*tridiag_factor(torch.as_tensor(d), torch.as_tensor(e)), torch.as_tensor(b))
    assert tridiag_kernels.tridiag_counts() == dict(factor=0, solve=0, factor_plain=1,
                                                    solve_plain=1)
