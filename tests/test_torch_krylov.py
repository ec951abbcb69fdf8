"""The port's Krylov subproblem solvers (galahad_tpu_torch/tr/: GLTR, GLRT,
LSTR, LSRT, L2RT, LQR, LQT, LLST, LLS) against the JAX package's, on the
problems of tests/test_tr.py, tests/test_tr2.py and tests/test_lstr.py, the
same numpy-seeded inputs, float64, the port on the CPU.

What is held: x, obj and the multiplier within 1e-9 relative (and the
other scalars the solver returns), and the Krylov iteration count ``iter``
equal.  One exception, where the two packages part by roundoff and not by
their code: when the Krylov space is exhausted (the count reaches the
order of the space: n for Lanczos, min(m, n) for Golub-Kahan), the next
beta (Lanczos) or alpha (Golub-Kahan) is roundoff, ~1e-15, and the stop
test compares it with 1e-14, so whether a run stops there or goes on to
``itmax`` depends on the last bits of the products.  There both counts
must reach the order of the space (and x, obj and the multiplier still
agree)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import galahad_tpu.tr as J

import galahad_tpu_torch.tr as T

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-9


def rand_sym(n, seed, shift=0.0):
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    return (B + B.T) / 2 + shift * np.eye(n)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))


def check(j, t, fields, dim=None):
    for f in fields:
        tv = getattr(t, f)
        assert rel(getattr(j, f), tv.numpy() if torch.is_tensor(tv) else tv) <= TOL, f
    if dim is not None:
        kj, kt = int(j.iter), int(t.iter)
        assert kj == kt or min(kj, kt) >= dim, (kj, kt, dim)


def sym_ops(H):
    """(JAX matvec, port matvec) of a dense symmetric H."""
    Hj, Ht = jnp.asarray(H), torch.as_tensor(H)
    return (lambda v: Hj @ v), (lambda v: Ht @ v)


def ls_ops(A):
    """((A v, A' u) of JAX, (A v, A' u) of the port)."""
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    return ((lambda v: Aj @ v), (lambda u: Aj.T @ u)), ((lambda v: At @ v), (lambda u: At.T @ u))


KRYLOV = ("x", "obj", "multiplier", "norm_x")

# name: (n, H seed, shift, c seed, radius, itmax, diagonal preconditioner seed)
GLTR_CASES = {
    "exact_small0": (8, 0, 1.0, 70, 0.5, 16, None),
    "exact_small1": (8, 1, 1.0, 71, 0.5, 16, None),
    "interior_cg": (10, 5, 8.0, 75, 1e3, 32, None),
    "preconditioned": (9, 6, 0.0, 76, 0.8, 32, 77),
}


@pytest.mark.parametrize("case", sorted(GLTR_CASES))
def test_gltr(case):
    n, hs, shift, cs, radius, itmax, ps = GLTR_CASES[case]
    H = rand_sym(n, hs, shift)
    c = np.random.default_rng(cs).normal(size=n)
    jm, tm = sym_ops(H)
    jkw, tkw = {}, {}
    if ps is not None:
        Md = np.random.default_rng(ps).uniform(1.0, 3.0, size=n)
        jkw["prec"] = lambda v: v / jnp.asarray(Md)
        tkw["prec"] = lambda v: v / torch.as_tensor(Md)
    j = J.gltr_solve(jm, jnp.asarray(c), radius, ctl=J.GLTRControl(itmax=itmax), **jkw)
    t = T.gltr_solve(tm, torch.as_tensor(c), radius, ctl=T.GLTRControl(itmax=itmax), **tkw)
    check(j, t, KRYLOV, dim=n)
    assert bool(j.negative_curvature) == bool(t.negative_curvature)


@pytest.mark.parametrize("i", range(8))
def test_gltr_batch_members(i):
    """The problems of test_tr.py::TestGLTR::test_batched, one at a time."""
    r = np.random.default_rng(80)
    Hs = [(lambda B: (B + B.T) / 2)(r.normal(size=(6, 6))) for _ in range(8)]
    cs = r.normal(size=(8, 6))
    jm, tm = sym_ops(Hs[i])
    j = J.gltr_solve(jm, jnp.asarray(cs[i]), 1.0, ctl=J.GLTRControl(itmax=12))
    t = T.gltr_solve(tm, torch.as_tensor(cs[i]), 1.0, ctl=T.GLTRControl(itmax=12))
    check(j, t, KRYLOV, dim=6)


@pytest.mark.parametrize("seed", [0, 3])
def test_glrt(seed):
    H = rand_sym(7, seed + 90)
    c = np.random.default_rng(seed + 95).normal(size=7)
    jm, tm = sym_ops(H)
    j = J.glrt_solve(jm, jnp.asarray(c), 0.9, p=3.0, ctl=J.GLRTControl(itmax=16))
    t = T.glrt_solve(tm, torch.as_tensor(c), 0.9, p=3.0, ctl=T.GLRTControl(itmax=16))
    check(j, t, KRYLOV, dim=7)


LS = KRYLOV + ("r_norm",)

# name: (solver, m, n, seed, b scale, parameter, keyword arguments)
LS_CASES = {
    "lstr_interior": ("lstr", 12, 6, 0, 1.0, 100.0, {}),
    "lstr_boundary": ("lstr", 10, 8, 1, 5.0, 0.3, {}),
    "lstr_underdetermined": ("lstr", 4, 9, 2, 1.0, 50.0, {}),
    "lsrt_tikhonov_p2": ("lsrt", 9, 5, 4, 1.0, 0.7, dict(p=2.0)),
    "lsrt_p3": ("lsrt", 10, 6, 5, 3.0, 0.5, dict(p=3.0)),
    "l2rt": ("l2rt", 12, 5, 6, 2.0, 0.8, dict(p=3.0)),
    "l2rt_mu": ("l2rt", 8, 4, 7, 1.0, 0.3, dict(p=3.0, mu=0.2)),
}


@pytest.mark.parametrize("case", sorted(LS_CASES))
def test_least_squares(case):
    solver, m, n, seed, scale, par, kw = LS_CASES[case]
    r = np.random.default_rng(seed)
    A = r.normal(size=(m, n))
    b = r.normal(size=m) * scale
    (jm, jr), (tm, tr) = ls_ops(A)
    j = getattr(J, f"{solver}_solve")(jm, jr, jnp.asarray(b), par, **kw)
    t = getattr(T, f"{solver}_solve")(tm, tr, torch.as_tensor(b), par, **kw)
    check(j, t, LS, dim=min(m, n))


@pytest.mark.parametrize("i", range(5))
def test_lstr_batch_members(i):
    """The problems of test_lstr.py::TestLSTR::test_batched, one at a time."""
    r = np.random.default_rng(3)
    As = r.normal(size=(5, 8, 4))
    bs = r.normal(size=(5, 8))
    (jm, jr), (tm, tr) = ls_ops(As[i])
    check(J.lstr_solve(jm, jr, jnp.asarray(bs[i]), 0.5),
          T.lstr_solve(tm, tr, torch.as_tensor(bs[i]), 0.5), LS, dim=4)


LQ = KRYLOV + ("resid",)

# name: (solver, seed, n, radius or sigma, itmax)
LQ_CASES = {
    "lqr_matches_trs": ("lqr", 0, 12, 0.7, 12),
    "lqr_early_truncation": ("lqr", 2, 30, 1.0, 8),
    "lqt_point": ("lqt", 5, 12, 2.0, 12),
    "lqt_obj": ("lqt", 1, 12, 2.0, 12),
}


@pytest.mark.parametrize("case", sorted(LQ_CASES))
def test_lqr_lqt(case):
    solver, seed, n, par, itmax = LQ_CASES[case]
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    H = (B + B.T) / 2
    c = r.normal(size=n)
    jm, tm = sym_ops(H)
    j = getattr(J, f"{solver}_solve")(jm, jnp.asarray(c), par, ctl=J.LQRControl(itmax=itmax))
    t = getattr(T, f"{solver}_solve")(tm, torch.as_tensor(c), par, ctl=T.LQRControl(itmax=itmax))
    check(j, t, LQ, dim=n)


LLST = ("x", "r_norm", "x_norm", "multiplier")


def lsq_problem(m=10, n=6, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=(m, n)), r.normal(size=m)


@pytest.mark.parametrize("case", ["interior", "boundary", "scaled_norm"])
def test_llst(case):
    A, b = lsq_problem(seed=1 if case == "scaled_norm" else 0)
    S = None
    if case == "scaled_norm":
        S = np.random.default_rng(2).uniform(0.5, 2.0, size=6)
        radius = 0.2
    else:
        x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
        radius = (10.0 if case == "interior" else 0.3) * float(np.linalg.norm(x_ls))
    j = J.llst_solve(jnp.asarray(A), jnp.asarray(b), radius,
                     S=None if S is None else jnp.asarray(S))
    t = T.llst_solve(A, b, radius, S=S, device="cpu")
    check(j, t, LLST)


def test_llst_batched():
    """test_tr2.py::TestLLST::test_batched: the JAX package vmaps, the port
    takes the batch as leading dimensions."""
    r = np.random.default_rng(3)
    A = r.normal(size=(5, 8, 4))
    b = r.normal(size=(5, 8))
    radii = r.uniform(0.05, 0.2, size=5)
    j = jax.vmap(lambda Ai, bi, ri: J.llst_solve(Ai, bi, ri))(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(radii))
    t = T.llst_solve(A, b, radii, device="cpu")
    assert tuple(t.x.shape) == (5, 4)
    check(j, t, LLST)


def test_lls():
    A, b = lsq_problem(seed=4)
    check(J.lls_solve(jnp.asarray(A), jnp.asarray(b), 0.25),
          T.lls_solve(A, b, 0.25, device="cpu"), KRYLOV, dim=6)
