"""The port's eigen-secular TRS, RQS and DPS and its factorization TRS
(galahad_tpu_torch/tr/trs.py, on the CPU: the plain versions of the kernels
of csrc/secular.cu) against the JAX package's (galahad_tpu/tr/trs.py), on
the same numpy-seeded problems, float64 unless stated.

What is held: the secular Newton iteration's s within 1e-12 relative; on the
problems of tests/test_tr.py (TestTRS, TestRQS) obj and multiplier within
1e-10 relative, ``interior`` and ``hard_case`` equal, and x within 1e-9
where the problem is not a hard case (there x is defined only up to the
sign of the leftmost eigenvector, which LAPACK and cuSOLVER choose freely:
then obj, ||x|| and the multiplier are held); a permuted batch gives the
permuted answers bitwise; float32 within the envelope of
test_determinism.py:105-121; no host read inside the four batched solvers;
and tests/trs_oracle.json against a fresh JAX run and the port.
``trs_solve_chol`` against the JAX package: test_torch_trs_chol.py."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.tr import trs as J

from galahad_tpu_torch.tr import secular_kernels
from galahad_tpu_torch.tr import trs as T

from _torch_port_helpers import REPO, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HOST_READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__float__", "__int__")


def rand_sym(n, seed, shift=0.0):
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    return (B + B.T) / 2 + shift * np.eye(n)


def hard_problem():
    """tests/test_tr.py::TestTRS::test_hard_case: c orthogonal to the
    leftmost eigenvector, the pseudo-inverse solution interior."""
    n = 6
    r = np.random.default_rng(9)
    Q, _ = np.linalg.qr(r.normal(size=(n, n)))
    H = Q @ np.diag([-2.0, 1.0, 2.0, 3.0, 4.0, 5.0]) @ Q.T
    c = Q @ np.array([0.0, 0.1, -0.05, 0.08, 0.02, -0.03])
    return H, c, 5.0


# name: (H, c, radius, M, equality_problem)
CASES = {
    "interior": lambda: (rand_sym(8, 0, 6.0), np.random.default_rng(1).normal(size=8), 100.0,
                         None, False),
    **{f"boundary_pd{s}": (lambda s=s: (rand_sym(10, s, 5.0),
                                        np.random.default_rng(s + 50).normal(size=10), 0.1,
                                        None, False)) for s in (2, 3, 4)},
    **{f"indefinite{s}": (lambda s=s: (rand_sym(10, s),
                                       np.random.default_rng(s + 60).normal(size=10), 1.0,
                                       None, False)) for s in (5, 6, 7)},
    "hard_case": lambda: hard_problem() + (None, False),
    "equality": lambda: (rand_sym(6, 11, 5.0), 0.01 * np.random.default_rng(12).normal(size=6),
                         0.5, None, True),
    "m_norm": lambda: (rand_sym(7, 13), np.random.default_rng(14).normal(size=7), 0.7,
                       rand_sym(7, 15, 4.0), False),
    "zero_c": lambda: (rand_sym(5, 30), np.zeros(5), 2.0, None, False),
    **{f"rqs{seed}": (lambda seed=seed, shift=shift: (
        rand_sym(8, seed, shift), np.random.default_rng(seed + 40).normal(size=8), 1.0, None,
        False)) for seed, shift in ((0, 4.0), (1, 0.0), (2, -1.0))},
    "rqs_brute": lambda: (rand_sym(5, 8), np.random.default_rng(17).normal(size=5), 1.0, None,
                          False),
}
SOLVERS = ("trs", "rqs", "dps_trs", "dps_rqs", "dps_goldfarb_trs", "dps_goldfarb_rqs")
SIGMA = 0.7


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max())) if a.size else 0.0


def run(solver, pkg, H, c, radius, M, eq):
    """One solver of one package on numpy inputs (the port on the CPU)."""
    port = pkg is T
    wrap = (lambda a: a) if port else (lambda a: None if a is None else jnp.asarray(a))
    kw = dict(device="cpu") if port else {}
    H, c, M = wrap(H), wrap(c), wrap(M)
    if solver == "trs":
        return pkg.trs_solve(H, c, radius, M=M, ctl=pkg.TRSControl(equality_problem=eq), **kw)
    if solver == "rqs":
        return pkg.rqs_solve(H, c, SIGMA, p=3.0, M=M, **kw)
    goldfarb = "goldfarb" in solver
    if solver.endswith("trs"):
        return pkg.dps_solve(H, c, radius=radius, M=M, goldfarb=goldfarb,
                             ctl=pkg.TRSControl(equality_problem=eq), **kw)
    return pkg.dps_solve(H, c, sigma=SIGMA, M=M, goldfarb=goldfarb, **kw)


def check_same(j, t, x_tol=1e-9):
    """obj and multiplier within 1e-10 relative, the flags equal, and x
    within ``x_tol`` unless the JAX result is a hard case."""
    assert rel(j.obj, t.obj.numpy()) <= 1e-10
    assert rel(j.multiplier, t.multiplier.numpy()) <= 1e-10
    assert rel(j.norm_x, t.norm_x.numpy()) <= 1e-10
    np.testing.assert_array_equal(np.asarray(j.hard_case), t.hard_case.numpy())
    np.testing.assert_array_equal(np.asarray(j.interior), t.interior.numpy())
    easy = ~np.asarray(j.hard_case)
    if easy.any():
        assert rel(np.asarray(j.x)[easy], t.x.numpy()[easy]) <= x_tol


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_reference(case, solver):
    H, c, radius, M, eq = CASES[case]()
    check_same(run(solver, J, H, c, radius, M, eq), run(solver, T, H, c, radius, M, eq))


def test_hard_case_flags_and_multiplier():
    H, c, radius = hard_problem()
    t = T.trs_solve(H, c, radius, device="cpu")
    assert bool(t.hard_case) and float(t.multiplier) == pytest.approx(2.0, abs=1e-6)
    assert float(t.norm_x) == pytest.approx(radius, rel=1e-6)


def test_diagonal_fast_path():
    h, c = np.array([-1.0, 2.0, 3.0]), np.array([0.3, -0.4, 0.5])
    check_same(J.trs_solve_diagonal(jnp.asarray(h), jnp.asarray(c), 1.0),
               T.trs_solve_diagonal(h, c, 1.0, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(6,), (5, 12), (3, 4, 9)])
def test_secular_newton_plain_matches_reference(shape, seed):
    """The plain secular iteration against JAX ``_secular_newton`` on random
    eigen-data with the bracket's lower end at max(-lam_min, 0): s within
    1e-12 relative."""
    rng = np.random.default_rng(seed)
    lam = np.sort(rng.normal(size=shape) * 3.0, axis=-1)
    ct2 = rng.uniform(0.01, 2.0, shape)
    radius = rng.uniform(0.1, 2.0, shape[:-1])
    lam_lo = np.maximum(-lam[..., 0], 0.0)
    s_j = J._secular_newton(jnp.asarray(lam), jnp.asarray(ct2), jnp.asarray(radius),
                            jnp.asarray(lam_lo), 64, 1e-12)
    s_t = T.secular_newton_plain(*(torch.as_tensor(a) for a in (lam, ct2, radius, lam_lo)), 64)
    assert rel(s_j, s_t.numpy()) <= 1e-12


def batch(nb=6, n=8, seed=7):
    rng = np.random.default_rng(seed)
    Bm = rng.standard_normal((nb, n, n))
    return ((Bm + np.swapaxes(Bm, 1, 2)) / 2, rng.standard_normal((nb, n)),
            rng.uniform(0.2, 2.0, nb))


def bits(t):
    a = t.numpy()
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("solver", ["trs", "rqs", "dps_trs", "chol"])
def test_batch_permutation_is_bitwise(solver):
    """Each problem's answer is independent of its place in the batch (the
    JAX package's test_determinism.py:68-84, for the port's batched path)."""
    H, c, radius = (torch.as_tensor(a) for a in batch())
    perm = torch.tensor([2, 0, 5, 3, 1, 4])
    f = dict(trs=lambda H, c, r: T.trs_solve(H, c, r),
             rqs=lambda H, c, r: T.rqs_solve(H, c, 1.0 / r),
             dps_trs=lambda H, c, r: T.dps_solve(H, c, radius=r),
             chol=lambda H, c, r: T.trs_solve_chol(H, c, r))[solver]
    a, b = f(H, c, radius), f(H[perm], c[perm], radius[perm])
    for field in ("x", "obj", "multiplier"):
        np.testing.assert_array_equal(bits(getattr(a, field)[perm]), bits(getattr(b, field)))


def test_f32_envelope():
    """float32 within the envelope the JAX package holds for itself
    (test_determinism.py:105-121): x32 within 5e-4 relative of x64, and of
    the JAX package's x32 too."""
    rng = np.random.default_rng(11)
    n = 24
    M = rng.standard_normal((n, n))
    H64 = M @ M.T - 2.0 * np.eye(n)
    g64 = rng.standard_normal(n)
    x64 = T.trs_solve(H64, g64, 1.5, device="cpu").x.numpy()
    x32 = T.trs_solve(H64.astype(np.float32), g64.astype(np.float32), 1.5, device="cpu").x
    assert x32.dtype == torch.float32
    assert np.linalg.norm(x32.numpy() - x64) / np.linalg.norm(x64) < 5e-4
    j32 = np.asarray(J.trs_solve(jnp.asarray(H64, jnp.float32), jnp.asarray(g64, jnp.float32),
                                 jnp.float32(1.5)).x, np.float64)
    assert np.linalg.norm(x32.numpy() - j32) / np.linalg.norm(x64) < 5e-4


def test_the_batched_solvers_make_no_host_read(monkeypatch):
    """Every way a tensor reaches the host raises while trs_solve, rqs_solve,
    dps_solve (both branches, with and without M) and trs_solve_chol run on
    tensor inputs."""
    H, c, radius = (torch.as_tensor(a) for a in batch())
    M = torch.as_tensor(np.eye(8) * 2.0)

    def refuse(self, *args, **kwargs):
        raise AssertionError("a host read inside a batched TRS solver")

    with monkeypatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse)
        outs = [T.trs_solve(H, c, radius), T.trs_solve(H, c, radius, M=M),
                T.rqs_solve(H, c, 1.0 / radius), T.rqs_solve(H, c, 0.5, M=M),
                T.dps_solve(H, c, radius=radius), T.dps_solve(H, c, sigma=0.5),
                T.dps_solve(H, c, radius=radius, goldfarb=True), T.trs_solve_chol(H, c, radius)]
    for info in outs:
        assert torch.isfinite(info.x).all()


def test_cpu_tensors_take_the_plain_versions():
    secular_kernels.reset_secular_counts()
    H, c, radius = batch()
    T.trs_solve(H, c, radius, device="cpu")
    T.rqs_solve(H, c, 0.5, device="cpu")
    assert secular_kernels.secular_counts() == dict(trs=0, rqs=0, trs_plain=1, rqs_plain=1)


# ---------------------------------------------------------------------------
# tests/trs_oracle.json
# ---------------------------------------------------------------------------

ORACLE = os.path.join(REPO, "tests", "trs_oracle.json")
FIRST = 16


def oracle_inputs(count=FIRST):
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_trs_oracle import headline_batch

    H, c, radius = headline_batch()
    return H[:count], c[:count], radius[:count]


def test_oracle_file_matches_a_fresh_reference_run():
    """The file's first 16 problems against a fresh JAX run: every value
    within 1e-12 relative, every flag equal."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_trs_oracle import jax_results

    with open(ORACLE) as fh:
        oracle = json.load(fh)
    assert (oracle["batch"], oracle["n"], oracle["p"]) == (1024, 64, 3.0)
    fresh = jax_results(*oracle_inputs())
    for key, vals in fresh.items():
        assert rel(oracle[key][:FIRST], vals) <= 1e-12, key


def test_port_matches_the_oracle():
    """The port on the CPU on the oracle's first 16 problems: obj within
    1e-10 relative, flags equal (the test chip_smoke.py makes on the card
    for the whole batch)."""
    with open(ORACLE) as fh:
        oracle = json.load(fh)
    H, c, radius = oracle_inputs()
    got = dict(trs=T.trs_solve(H, c, radius, device="cpu"),
               rqs=T.rqs_solve(H, c, 1.0 / radius, p=3.0, device="cpu"),
               chol=T.trs_solve_chol(H, c, radius, device="cpu"),
               dps=T.dps_solve(H, c, radius=radius, device="cpu"),
               dps_goldfarb=T.dps_solve(H, c, radius=radius, goldfarb=True, device="cpu"))
    for name, info in got.items():
        assert rel(oracle[f"{name}_obj"][:FIRST], info.obj.numpy()) <= 1e-10, name
        for flag in ("hard_case", "interior", "multiplier"):
            key = f"{name}_{flag}"
            if key in oracle:
                want = np.asarray(oracle[key][:FIRST])
                have = getattr(info, flag).numpy()
                if flag == "multiplier":
                    assert rel(want, have) <= 1e-10, key
                else:
                    np.testing.assert_array_equal(want.astype(bool), have, key)
    assert dataclasses.is_dataclass(got["trs"])
