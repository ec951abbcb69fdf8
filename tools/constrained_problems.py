"""Problems of the constrained and global solvers' checks, generated from seeds
with numpy, for ``chip_smoke.py``'s ``constrained`` phase and the tests of the
port (tests/test_torch_constrained.py, test_torch_qcqp.py, test_torch_go.py,
test_torch_qp_family.py).  The functions take ``xp`` (``jax.numpy`` or
``torch``) where they need a module function; the others work on JAX arrays
and torch tensors alike.
"""
import numpy as np


def chain_objective(x):
    """tests/test_constrained.py::test_large_n_matrix_free's objective:
    sum (x - 1)^2 + 0.1 sum (x_i x_i-1)^2."""
    return ((x - 1.0) ** 2).sum() + 0.1 * ((x[1:] * x[:-1]) ** 2).sum()


def chain_constraint(n: int):
    """Its one equality, sum x = n / 40, as c(x) = sum x - n / 40 in [0, 0]
    (n = 400: the test's sum x = 10)."""
    target = n / 40.0
    return lambda x: (x.sum() - target).reshape(1)


def rastrigin(xp):
    """20 + sum (x^2 - 10 cos(2 pi x)) (test_go.py's, for n = 2 and up)."""
    return lambda v: 20.0 + (v ** 2 - 10.0 * xp.cos(2 * np.pi * v)).sum()


def camel6(v):
    """The six-hump camel function (test_go.py)."""
    x, y = v[0], v[1]
    return ((4.0 - 2.1 * x ** 2 + x ** 4 / 3.0) * x ** 2 + x * y
            + (-4.0 + 4.0 * y ** 2) * y ** 2)


def broyden_tridiagonal(xp):
    """The Broyden tridiagonal system, (3 - 2 x_i) x_i - x_i-1 - 2 x_i+1 + 1 =
    0 with x_0 = x_n+1 = 0 (More, Garbow and Hillstrom, problem 30)."""
    def c(x):
        z = xp.zeros(1, dtype=x.dtype) if xp.__name__.startswith("jax") else \
            xp.zeros(1, dtype=x.dtype, device=x.device)
        left = xp.concatenate([z, x[:-1]])
        right = xp.concatenate([x[1:], z])
        return (3.0 - 2.0 * x) * x - left - 2.0 * right + 1.0
    return c


# tests/test_qcqp.py::QCQP_FILE (that module imports JAX): the ball problem with
# H = 0.2 I, as QPLIB text
BALL_QCQP_FILE = """\
! toy QCQP fixture (QPLIB grammar, examples/QPBAND.qplib:1-15)
BALL2
QCQ
Minimize
2        ! n
1        ! m
2        ! Hobj nnz
1 1 0.2
2 2 0.2
1.0      ! g default
0        ! g exceptions
0.0      ! f
2        ! constraint Hessian nnz
1 1 1 1.0
1 2 2 1.0
0        ! A nnz
1.0E+20  ! infinity
-1.0E+20 ! c_l default
0
0.5      ! c_u default
0
-1.0E+20 ! x_l default
0
1.0E+20  ! x_u default
0
0.0      ! x0
0
0.0      ! y0
0
0.0      ! z0
0
0
0
"""


def convex_qcqp_text(n: int, m: int, seed: int = 0, q_nnz: int = 64) -> str:
    """A convex QCQP as QPLIB text ("QCQ"): H diagonally dominant
    tridiagonal (diagonal 4, off-diagonal -1), g ~ N(0, 1), A dense N(0, 1) /
    sqrt(n), each Q_i a PSD diagonal U(0.5, 2) on ``q_nnz`` variables drawn
    without replacement, c_l = -inf and c_u ~ U(0.5, 1.5) (so x = 0 is
    strictly feasible), bounds [-10, 10], x0 = 0."""
    from galahad_tpu_torch.io.qplib import QPLIBProblem, dumps

    r = np.random.default_rng(seed)
    hr = np.r_[np.arange(n), np.arange(1, n)]
    hc = np.r_[np.arange(n), np.arange(n - 1)]
    hv = np.r_[np.full(n, 4.0), np.full(n - 1, -1.0)]
    A = r.normal(size=(m, n)) / np.sqrt(n)
    ar, ac = np.nonzero(np.ones((m, n)))
    H_c = []
    for i in range(m):
        for j in np.sort(r.choice(n, q_nnz, replace=False)):
            H_c.append((i, int(j), int(j), float(r.uniform(0.5, 2.0))))
    inf = 1e20
    p = QPLIBProblem(
        name=f"QCQP{n}", ptype="QCQ", minimize=True, n=n, m=m, H_coo=(hr, hc, hv),
        g=r.normal(size=n), f=0.0, A_coo=(ar, ac, A[ar, ac]), c_l=np.full(m, -inf),
        c_u=r.uniform(0.5, 1.5, m), x_l=np.full(n, -10.0), x_u=np.full(n, 10.0),
        x0=np.zeros(n), y0=np.zeros(m), z0=np.zeros(n), infinity=inf,
        var_types=np.zeros(n, int), H_c=H_c, x_names={}, c_names={})
    return dumps(p)


def bqp_arrays(n: int, seed: int = 0):
    """BQP: H = I + B B' / n (B ~ N(0, 1)), g ~ N(0, 3^2), on [-1, 1]^n."""
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    return np.eye(n) + B @ B.T / n, 3.0 * r.normal(size=n), -np.ones(n), np.ones(n)


def blls_arrays(m: int, n: int, seed: int = 0):
    """BLLS: A ~ N(0, 1) (m, n), b = A x_out with x_out ~ U(-0.5, 1.5) (some
    of it outside the box), on [0, 1]^n."""
    r = np.random.default_rng(seed)
    A = r.normal(size=(m, n))
    return A, A @ r.uniform(-0.5, 1.5, n), np.zeros(n), np.ones(n)


def eqp_arrays(n: int, m: int, seed: int = 0):
    """EQP as test_qp_family.py's first case draws it: H = B B' + I, g, A
    (m, n), c all N(0, 1)."""
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    H = B @ B.T + np.eye(n)
    return H, r.normal(size=n), r.normal(size=(m, n)), r.normal(size=m)
