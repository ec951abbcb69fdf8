"""Problems of the NLP solvers' checks, generated from seeds with numpy, for
``chip_smoke.py``'s ``nlp`` phase, ``tools/make_nlp_oracle.py`` and
tests/test_torch_nls.py.  The objectives and residual builders work on JAX
arrays and torch tensors alike (indexing, arithmetic and ``.sum()``)."""
import numpy as np


def ext_rosenbrock(x):
    """The extended Rosenbrock function: sum over pairs i of
    100 (x_2i+1 - x_2i^2)^2 + (1 - x_2i)^2 (n even)."""
    a, b = x[0::2], x[1::2]
    return (100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2).sum()


def standard_start(n: int) -> np.ndarray:
    """(-1.2, 1, -1.2, 1, ...), the function's standard start."""
    return np.tile([-1.2, 1.0], n // 2)


def random_starts(batch: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(batch, n))


def grid_residual_arrays(k: int):
    """tests/test_nlp.py::test_nls_sparse_gauss_newton_large's problem at
    size k: residuals x_u + x_v^2 - a on the edges (u, v) of a k x k grid,
    a consistent (r(x*) = 0 with x* from default_rng(0) U(0.5, 1.5)).
    Returns (n, m, u, v, a, rows, cols), rows/cols the Jacobian's COO
    pattern (two entries a residual: d/dx_u = 1, d/dx_v = 2 x_v)."""
    n = k * k
    idx = np.arange(n).reshape(k, k)
    E = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()]).T,
                        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()]).T])
    m = len(E)
    xstar = np.random.default_rng(0).uniform(0.5, 1.5, n)
    u, v = E[:, 0], E[:, 1]
    a = xstar[u] + xstar[v] ** 2
    return n, m, u, v, a, np.repeat(np.arange(m), 2), E.reshape(-1)
