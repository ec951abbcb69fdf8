"""The port's factorization-based TRS (galahad_tpu_torch/tr/trs.py::
trs_solve_chol: batched ``cholesky_ex`` and triangular solves, every problem
of the batch frozen by masks once it is done) against the JAX package's
(galahad_tpu/tr/trs.py:388, a vmap of a ``fori_loop``) on the 25 mixed
problems of tests/test_tr.py:248 and on a batch of 32: obj and multiplier
within 1e-10 relative, the flags equal, x within 1e-9 (test_torch_trs.py's
``check_same``).  Apart from test_torch_trs.py because the JAX package
compiles its loop once per order n (~1 s a problem)."""
import jax.numpy as jnp
import numpy as np
import pytest

from galahad_tpu.tr import trs as J

from galahad_tpu_torch.tr import trs as T

from _torch_port_helpers import one_torch_thread  # noqa: F401
from test_torch_trs import check_same

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def mixed_problems():
    """The 25 problems of tests/test_tr.py::test_trs_chol_matches_eigen_secular."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(25):
        n = int(rng.integers(3, 30))
        B = rng.normal(size=(n, n))
        H = (B + B.T) / 2
        if i % 3 == 0:
            H = H @ H.T * 0.2 + np.eye(n) * 0.1
        out.append((H, rng.normal(size=n), float(rng.uniform(0.05, 3.0))))
    return out


@pytest.mark.parametrize("i", range(25))
def test_trs_chol_matches_reference(i):
    H, c, radius = mixed_problems()[i]
    check_same(J.trs_solve_chol(jnp.asarray(H), jnp.asarray(c), radius),
               T.trs_solve_chol(H, c, radius, device="cpu"))


def test_trs_chol_batched_matches_reference():
    rng = np.random.default_rng(0)
    Bm = rng.normal(size=(32, 12, 12))
    H = (Bm + np.swapaxes(Bm, -1, -2)) / 2
    c = rng.normal(size=(32, 12))
    radius = rng.uniform(0.1, 2.0, 32)
    check_same(J.trs_solve_chol(jnp.asarray(H), jnp.asarray(c), jnp.asarray(radius)),
               T.trs_solve_chol(H, c, radius, device="cpu"))
