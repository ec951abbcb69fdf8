"""The port's quasi-Newton kit (galahad_tpu_torch/qn/: LMS, SEC, SHA)
against the JAX package's, on the cases of tests/test_qn.py: the same
numpy-seeded pairs through both, float64, the port on the CPU.

What is held: every apply, update and estimate within 1e-12 relative of the
JAX package's (max |difference| <= 1e-12 x max(1, max |value|)), the ring
buffer's fields (valid, head) equal, and the properties test_qn.py checks
(the secant equations, the dense BFGS accumulation, the inverse) with its
own tolerances.  The port is also started from a JAX ``LMSData`` whose ring
buffer has wrapped (``convert.lms_data_from_numpy``) and held to one more
update and apply."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import galahad_tpu.qn as J

import galahad_tpu_torch.qn as T
from galahad_tpu_torch.convert import lms_data_from_numpy, sha_pattern_from_numpy

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12


def rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max())) if ref.size else 0.0


def spd_pairs(n, k, seed):
    r = np.random.default_rng(seed)
    A = r.normal(size=(n, n))
    H = A @ A.T + n * np.eye(n)
    return H, [(s, H @ s) for s in (r.normal(size=n) for _ in range(k))]


def both(n, mem, pairs, method="bfgs"):
    """(JAX LMSData, the port's LMSData) after the same updates."""
    dj = J.lms_setup(n, J.LMSControl(memory=mem, method=method))
    dt = T.lms_setup(n, T.LMSControl(memory=mem, method=method), device="cpu")
    for s, y in pairs:
        dj = J.lms_update(dj, jnp.asarray(s), jnp.asarray(y))
        dt = T.lms_update(dt, torch.as_tensor(s), torch.as_tensor(y))
    return dj, dt


def same_data(dj, dt):
    assert np.array_equal(np.asarray(dj.valid), dt.valid.numpy())
    assert int(dj.head) == int(dt.head)
    for f in ("S", "Y", "delta"):
        assert rel(getattr(dj, f), getattr(dt, f)) <= TOL, f


def dense_bfgs(pairs, n, delta):
    B = delta * np.eye(n)
    for s, y in pairs:
        Bs = B @ s
        B = B - np.outer(Bs, Bs) / (s @ Bs) + np.outer(y, y) / (s @ y)
    return B


# name: (n, pairs, memory, pair seed, vector seed)
LMS_CASES = {
    "compact_vs_dense": (7, 4, 6, 0, 10),
    "secant": (6, 3, 4, 2, 4),
    "shifted": (5, 3, 4, 3, 4),
    "inverse": (6, 4, 5, 5, 6),
    "ring_overwrite": (5, 4, 2, 7, 8),
}


def test_lms_bfgs_cases():
    """Every BFGS case of test_qn.py::TestLMS: the port's state, apply,
    shifted apply and two-loop inverse against the JAX package's, and the
    properties the JAX tests check."""
    for name, (n, k, mem, ps, vs) in LMS_CASES.items():
        H, pairs = spd_pairs(n, k, ps)
        dj, dt = both(n, mem, pairs)
        same_data(dj, dt)
        v = np.random.default_rng(vs).normal(size=n)
        vt = torch.as_tensor(v)
        for shift in (0.0, 2.5):
            wj = J.lms_apply(dj, jnp.asarray(v), shift=shift)
            wt = T.lms_apply(dt, vt, shift=shift)
            assert rel(wj, wt) <= TOL, (name, shift)
        assert rel(J.lms_apply_inverse(dj, jnp.asarray(v)), T.lms_apply_inverse(dt, vt)) <= TOL
        s, y = pairs[-1]
        np.testing.assert_allclose(T.lms_apply(dt, torch.as_tensor(s)).numpy(), y, rtol=1e-8)
        if name == "compact_vs_dense":
            B_ref = dense_bfgs(pairs, n, float(dt.delta))
            np.testing.assert_allclose(T.lms_apply(dt, vt).numpy(), B_ref @ v, rtol=1e-9,
                                       atol=1e-9)
        if name == "shifted":
            np.testing.assert_allclose(T.lms_apply(dt, vt, shift=2.5).numpy(),
                                       T.lms_apply(dt, vt).numpy() + 2.5 * v, rtol=1e-10)
        if name == "inverse":
            np.testing.assert_allclose(T.lms_apply_inverse(dt, T.lms_apply(dt, vt)).numpy(), v,
                                       rtol=1e-7)
        if name == "ring_overwrite":
            assert int(dt.valid.sum()) == mem and int(dt.head) == k


def test_lms_rejects_a_pair_and_sr1():
    """A pair with s'y < 0 is rejected (masked, not branched on); SR1 keeps
    its pairs and meets the secant equation; both as the JAX package."""
    n = 4
    dj, dt = both(n, 3, [(np.ones(n), -np.ones(n))])
    same_data(dj, dt)
    assert int(dt.valid.sum()) == 0 and int(dt.head) == 0

    n = 6
    r = np.random.default_rng(8)
    A = r.normal(size=(n, n))
    H = (A + A.T) / 2
    pairs = [(s, H @ s) for s in (r.normal(size=n) for _ in range(3))]
    dj, dt = both(n, 4, pairs, method="sr1")
    same_data(dj, dt)
    for s, y in pairs[-1:]:
        wt = T.lms_apply(dt, torch.as_tensor(s))
        assert rel(J.lms_apply(dj, jnp.asarray(s)), wt) <= TOL
        np.testing.assert_allclose(wt.numpy(), y, rtol=1e-6, atol=1e-8)
    v = np.random.default_rng(9).normal(size=n)
    assert rel(J.lms_apply(dj, jnp.asarray(v), shift=1.5),
               T.lms_apply(dt, torch.as_tensor(v), shift=1.5)) <= TOL
    with pytest.raises(ValueError, match="bfgs"):
        T.lms_apply_inverse(dt, torch.as_tensor(v))


def test_lms_from_a_wrapped_jax_ring():
    """The port started from the JAX package's state after seven updates of a
    ring of three slots (head 7, the newest pair in slot 0): the operator,
    the inverse, and one more update and apply as the JAX package's."""
    n, mem = 6, 3
    H, pairs = spd_pairs(n, 8, 11)
    dj = J.lms_setup(n, J.LMSControl(memory=mem))
    for s, y in pairs[:7]:
        dj = J.lms_update(dj, jnp.asarray(s), jnp.asarray(y))
    dt = lms_data_from_numpy({f: np.asarray(getattr(dj, f)) for f in
                              ("S", "Y", "valid", "head", "delta")} | {"method": dj.method},
                             device="cpu")
    assert int(dt.head) == 7
    v = np.random.default_rng(12).normal(size=n)
    assert rel(J.lms_apply(dj, jnp.asarray(v)), T.lms_apply(dt, torch.as_tensor(v))) <= TOL
    assert rel(J.lms_apply_inverse(dj, jnp.asarray(v)),
               T.lms_apply_inverse(dt, torch.as_tensor(v))) <= TOL
    s, y = pairs[7]
    dj = J.lms_update(dj, jnp.asarray(s), jnp.asarray(y))
    dt = T.lms_update(dt, torch.as_tensor(s), torch.as_tensor(y))
    same_data(dj, dt)
    op = T.lms_operator(dt)
    assert rel(J.lms_apply(dj, jnp.asarray(v)), op(torch.as_tensor(v))) <= TOL


def test_sec_updates():
    """SEC's damped BFGS and SR1 updates (test_qn.py::TestSEC) step for step
    against the JAX package's, with its secant, definiteness and limit
    checks."""
    n = 5
    r = np.random.default_rng(0)
    A = r.normal(size=(n, n))
    H = A @ A.T + n * np.eye(n)
    Bj, Bt = J.sec_initial(n), T.sec_initial(n, device="cpu")
    for _ in range(6):
        s = r.normal(size=n)
        Bj = J.bfgs_update(Bj, jnp.asarray(s), jnp.asarray(H @ s))
        Bt = T.bfgs_update(Bt, torch.as_tensor(s), torch.as_tensor(H @ s))
        assert rel(Bj, Bt) <= TOL
        np.testing.assert_allclose(Bt.numpy() @ s, H @ s, rtol=1e-8)
    assert np.linalg.eigvalsh(Bt.numpy())[0] > 0

    s = np.ones(4)                   # negative curvature: damping keeps B PD
    Bj = J.bfgs_update(J.sec_initial(4), jnp.asarray(s), jnp.asarray(-s))
    Bt = T.bfgs_update(T.sec_initial(4, device="cpu"), torch.as_tensor(s), torch.as_tensor(-s))
    assert rel(Bj, Bt) <= TOL and np.linalg.eigvalsh(Bt.numpy())[0] > 0

    r = np.random.default_rng(1)
    A = r.normal(size=(n, n))
    H = (A + A.T) / 2
    Bj, Bt = J.sec_initial(n), T.sec_initial(n, device="cpu")
    for _ in range(12):
        s = r.normal(size=n)
        Bj = J.sr1_update(Bj, jnp.asarray(s), jnp.asarray(H @ s))
        Bt = T.sr1_update(Bt, torch.as_tensor(s), torch.as_tensor(H @ s))
        assert rel(Bj, Bt) <= 1e-10
    np.testing.assert_allclose(Bt.numpy(), H, atol=1e-6)
    # a pair with (y - Bs)'s = 0 is skipped
    assert torch.equal(T.sr1_update(Bt, torch.as_tensor(s), Bt @ torch.as_tensor(s)), Bt)


def sha_cases():
    r = np.random.default_rng(2)
    n = 8
    H = np.diag(r.uniform(2, 3, size=n))
    off = r.normal(size=n - 1)
    H += np.diag(off, 1) + np.diag(off, -1)
    tri = (H, r, 1)
    r2 = np.random.default_rng(3)
    n = 6
    A = np.diag(r2.uniform(1, 2, size=n))
    A[0, :] = r2.normal(size=n)
    A[:, 0] = A[0, :]
    A[0, 0] = 5.0
    return {"tridiagonal": tri, "arrow": (A, r2, 2)}


def test_sha_recovery():
    """SHA on the tridiagonal and arrowhead Hessians of test_qn.py::TestSHA:
    the pattern equal to the JAX package's (also carried over by
    ``sha_pattern_from_numpy``), H within 1e-12 of its estimate and 1e-8 of
    the truth."""
    for name, (H, r, extra) in sha_cases().items():
        n = H.shape[0]
        rows, cols = np.nonzero(np.triu(H != 0))
        pj, pt = J.sha_analyse(n, rows, cols), T.sha_analyse(n, rows, cols)
        assert np.array_equal(np.asarray(pj.row_cols, np.int64).reshape(n, -1), pt.row_cols)
        assert np.array_equal(np.asarray(pj.row_deg), pt.row_deg) and pj.max_deg == pt.max_deg
        S = r.normal(size=(pt.max_deg + extra, n))
        Y = S @ H.T
        Hj = J.sha_estimate(pj, jnp.asarray(S), jnp.asarray(Y))
        for pat in (pt, sha_pattern_from_numpy(pj)):
            Ht = T.sha_estimate(pat, torch.as_tensor(S), torch.as_tensor(Y))
            assert rel(Hj, Ht) <= TOL, name
            np.testing.assert_allclose(Ht.numpy(), H, atol=1e-8, err_msg=name)
