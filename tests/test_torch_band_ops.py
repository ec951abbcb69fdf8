"""The port's banded operators in DIA storage (linalg/band_ops.py) against the
JAX package's, on the same numpy-seeded bands.

What is held: every function of the module (``BandMatrix.matvec`` /
``rmatvec`` / ``to_dense``, ``band_from_dense``, ``sym_band_matvec``,
``band_ADAt``, ``sym_band_add_diag``, ``sym_band_to_blocks``) within 1e-14
relative to the largest entry of the JAX result, for the offsets (0, 2) with
m = n - 2, (-1, 0, 3) with m = n and (-2, 0, 1) with m > n; the blocks of
``sym_band_to_blocks`` with and without padding to a multiple of the block
(the padding is the identity)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg import band_ops as J

from galahad_tpu_torch.linalg import band_ops as T

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-14
N = 13
BANDS = {"0_2": ((0, 2), N - 2), "m1_0_3": ((-1, 0, 3), N), "m_gt_n": ((-2, 0, 1), N + 3)}


def close(t, j):
    j = np.asarray(j)
    assert t.shape == j.shape
    if j.size == 0:
        return
    assert np.abs(t.numpy() - j).max() <= TOL * max(1.0, np.abs(j).max())


def band_pair(case, seed=0):
    offsets, m = BANDS[case]
    rng = np.random.default_rng(seed)
    val = rng.uniform(0.5, 1.5, (len(offsets), m))
    for p, off in enumerate(offsets):        # zero where the diagonal leaves A
        i = np.arange(m)
        val[p, (i + off < 0) | (i + off >= N)] = 0.0
    jb = J.BandMatrix(val=jnp.asarray(val), offsets=offsets, m=m, n=N)
    tb = T.BandMatrix(val=torch.as_tensor(val), offsets=offsets, m=m, n=N)
    return jb, tb, rng


def sym_band(w, n, seed):
    """Symmetric DIA (w+1, n), diagonally dominant, zero past the matrix."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1.0, 1.0, (w + 1, n))
    d[0] = 2.0 * (w + 1) + rng.uniform(0.0, 1.0, n)
    for s in range(1, w + 1):
        d[s, n - s:] = 0.0
    return d


@pytest.mark.parametrize("case", sorted(BANDS))
def test_matvec_rmatvec_to_dense(case):
    jb, tb, rng = band_pair(case)
    x = rng.normal(size=N)
    y = rng.normal(size=jb.m)
    close(tb.matvec(torch.as_tensor(x)), jb.matvec(jnp.asarray(x)))
    close(tb.rmatvec(torch.as_tensor(y)), jb.rmatvec(jnp.asarray(y)))
    close(tb.to_dense(), jb.to_dense())


@pytest.mark.parametrize("case", sorted(BANDS))
def test_band_from_dense(case):
    offsets, m = BANDS[case]
    A = np.random.default_rng(1).normal(size=(m, N))
    jb = J.band_from_dense(jnp.asarray(A), offsets)
    tb = T.band_from_dense(torch.as_tensor(A), offsets)
    assert tb.offsets == tuple(jb.offsets) and (tb.m, tb.n) == (jb.m, jb.n)
    close(tb.val, jb.val)


@pytest.mark.parametrize("case", sorted(BANDS))
def test_band_ADAt_and_add_diag(case):
    jb, tb, rng = band_pair(case, seed=2)
    d = rng.uniform(0.1, 3.0, N)
    c = rng.uniform(0.0, 1.0, jb.m)
    Sj = J.band_ADAt(jb, jnp.asarray(d))
    St = T.band_ADAt(tb, torch.as_tensor(d))
    close(St, Sj)
    close(T.sym_band_add_diag(St, torch.as_tensor(c)), J.sym_band_add_diag(Sj, jnp.asarray(c)))
    # and against the dense product
    Ad = np.asarray(jb.to_dense())
    S = Ad @ np.diag(d) @ Ad.T
    for s in range(St.shape[0]):
        ref = np.concatenate([np.diagonal(S, -s), np.zeros(s)])
        assert np.abs(St[s].numpy() - ref).max() <= 1e-13 * np.abs(S).max()


@pytest.mark.parametrize("w", [0, 1, 3])
def test_sym_band_matvec(w):
    d = sym_band(w, N, seed=w)
    x = np.random.default_rng(10 + w).normal(size=N)
    close(T.sym_band_matvec(torch.as_tensor(d), torch.as_tensor(x)),
          J.sym_band_matvec(jnp.asarray(d), jnp.asarray(x)))


@pytest.mark.parametrize("w,block", [(0, 1), (1, 1), (2, 4), (3, 3), (2, 13), (3, 8)])
def test_sym_band_to_blocks(w, block):
    d = sym_band(w, N, seed=20 + w)
    Dj, Lj = J.sym_band_to_blocks(jnp.asarray(d), block)
    Dt, Lt = T.sym_band_to_blocks(torch.as_tensor(d), block)
    close(Dt, Dj)
    close(Lt, Lj)
    k = -(-N // block)
    pad = k * block - N
    if pad:                          # the identity pads the last block
        tail = Dt[-1, block - pad:, block - pad:]
        assert torch.equal(tail, torch.eye(pad, dtype=tail.dtype))


def test_sym_band_to_blocks_refuses_a_narrow_block():
    with pytest.raises(ValueError, match="semibandwidth"):
        T.sym_band_to_blocks(torch.as_tensor(sym_band(3, N, 0)), 2)
