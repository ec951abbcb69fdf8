"""The factor kernel's plain PyTorch version (what the CPU tests can run of
linalg/ldlt_kernels.py) against the JAX package: the Pallas kernel in
interpret mode (float32) and the XLA composition ``_partial_ldlt_dyn``
(float64), on the entries the storage contract specifies: the lower
triangle of eliminated columns and the whole trailing square."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg.pallas_kernels import partial_ldlt_pallas
from galahad_tpu.linalg.supernodal_flat import _partial_ldlt_dyn

from galahad_tpu_torch.linalg import ldlt_kernels


def fronts(nb, Fpad, seed, ncols=None, extra=4):
    """Symmetric fronts, positive or negative definite, zero padded beyond
    each front's own size."""
    rng = np.random.default_rng(seed)
    if ncols is None:
        ncols = rng.integers(0, Fpad + 1, nb)
    ncols = np.asarray(ncols, np.int32)
    F = np.zeros((nb, Fpad, Fpad))
    for k in range(nb):
        nr = int(min(Fpad, ncols[k] + extra))
        B = rng.normal(size=(nr, nr))
        F[k, :nr, :nr] = (B @ B.T + 8 * np.eye(nr)) * (1.0 if k % 2 == 0 else -1.0)
    return F, ncols


def contract_err(ref, out, ncols):
    Fpad = ref.shape[1]
    worst = 0.0
    for k, nc in enumerate(ncols):
        nc = int(nc)
        low = np.tril(np.ones((Fpad, Fpad), bool))[:, :nc]
        if nc:
            worst = max(worst, np.abs((ref[k][:, :nc] - out[k][:, :nc])[low]).max())
        if nc < Fpad:
            worst = max(worst, np.abs(ref[k][nc:, nc:] - out[k][nc:, nc:]).max())
    return worst


@pytest.mark.parametrize("Fpad,nb", [(8, 9), (16, 5), (24, 5), (32, 3)])
def test_plain_matches_pallas_interpret_f32(Fpad, nb):
    # tolerance 1e-4 absolute on O(10) entries: float32 with a different
    # summation order (left-looking matmuls vs right-looking rank-1 updates)
    F, ncols = fronts(nb, Fpad, seed=Fpad)
    ncols[0], ncols[-1] = 0, Fpad            # both ends of the range
    F, _ = fronts(nb, Fpad, seed=Fpad, ncols=ncols)
    ref = np.asarray(partial_ldlt_pallas(
        jnp.asarray(F, jnp.float32), jnp.asarray(ncols), int(ncols.max()),
        interpret=True))
    out = ldlt_kernels.partial_ldlt_plain(
        torch.as_tensor(F, dtype=torch.float32), torch.as_tensor(ncols)).numpy()
    assert contract_err(ref, out, ncols) < 1e-4


@pytest.mark.parametrize("Fpad,nb", [(8, 16), (32, 6), (64, 4), (96, 3), (128, 2)])
def test_plain_matches_xla_composition_f64(Fpad, nb):
    # tolerance 1e-12 relative to the largest entry: float64, same
    # right-looking arithmetic up to the order inside a panel's product
    F, ncols = fronts(nb, Fpad, seed=100 + Fpad, extra=Fpad // 4)
    ncols[0], ncols[-1] = 0, Fpad
    F, _ = fronts(nb, Fpad, seed=100 + Fpad, ncols=ncols, extra=Fpad // 4)
    B = min(32, Fpad)
    nblocks = -(-int(ncols.max()) // B)
    ref, dmin, npos, nneg, nzero = _partial_ldlt_dyn(
        jnp.asarray(F), jnp.asarray(ncols), jnp.asarray(nblocks, jnp.int32), B)
    ref = np.asarray(ref)
    out_t = ldlt_kernels.partial_ldlt(torch.as_tensor(F), torch.as_tensor(ncols))
    out = out_t.numpy()
    assert contract_err(ref, out, ncols) < 1e-12 * np.abs(ref).max()
    # the stats the flat path derives from the stored diagonal afterwards
    elim = np.arange(Fpad)[None, :] < ncols[:, None]
    d = np.diagonal(out, axis1=1, axis2=2)
    assert abs(np.abs(d[elim]).min() - float(dmin)) <= 1e-12 * float(dmin)
    assert [(d[elim] > 0).sum(), (d[elim] < 0).sum(), (d[elim] == 0).sum()] \
        == [int(npos), int(nneg), int(nzero)]


@pytest.mark.parametrize("Fpad,nb", [(64, 3), (192, 2)])
def test_blocked_large_front_path_matches_xla_composition(Fpad, nb):
    """Fronts wider than the kernel takes use the blocked composition: the
    plain version of the wide-front call, one front after another."""
    F, ncols = fronts(nb, Fpad, seed=7 + Fpad, extra=Fpad // 3)
    ncols[-1] = Fpad
    F, _ = fronts(nb, Fpad, seed=7 + Fpad, ncols=ncols, extra=Fpad // 3)
    B = 32
    nblocks = -(-int(ncols.max()) // B)
    ref = np.asarray(_partial_ldlt_dyn(
        jnp.asarray(F), jnp.asarray(ncols), jnp.asarray(nblocks, jnp.int32), B)[0])
    out = torch.as_tensor(F).clone()
    lvl = ldlt_kernels.build_wide_level(
        [(k * Fpad * Fpad, Fpad, int(nc), Fpad) for k, nc in enumerate(ncols)], "cpu")
    ldlt_kernels.partial_ldlt_wide(out.view(-1), lvl)
    assert contract_err(ref, out.numpy(), ncols) < 1e-12 * np.abs(ref).max()
    plain = ldlt_kernels.partial_ldlt_plain(torch.as_tensor(F),
                                            torch.as_tensor(ncols)).numpy()
    assert contract_err(ref, plain, ncols) < 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tiny_pivot_is_divided_by_one(dtype):
    """|d| <= 16*tiny: the column is left unscaled (divide by 1) and d stays."""
    Fpad = 8
    F = np.zeros((2, Fpad, Fpad))
    F[0, :3, :3] = [[0.0, 1.0, 2.0], [1.0, 5.0, 0.5], [2.0, 0.5, 7.0]]
    F[1, :3, :3] = [[2.0, 1.0, 0.0], [1.0, 0.5, 0.25], [0.0, 0.25, 3.0]]
    ncols = np.array([1, 2], np.int32)
    npdt = np.dtype(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.float64
    out = ldlt_kernels.partial_ldlt_plain(
        torch.as_tensor(F.astype(npdt)), torch.as_tensor(ncols)).numpy()
    assert out.dtype == npdt and tdt is not None
    # front 0: d = 0 -> l = column itself, Schur = F22 - l * 1 * l^T
    np.testing.assert_allclose(out[0, 1:3, 0], [1.0, 2.0])
    np.testing.assert_allclose(out[0, 1:3, 1:3], [[5.0 - 1.0, 0.5 - 2.0],
                                                  [0.5 - 2.0, 7.0 - 4.0]])
    # front 1: second pivot 0.5 - 0.5 = 0 exactly
    assert out[1, 1, 1] == 0.0
    np.testing.assert_allclose(out[1, 2, 1], 0.25)
    # Held against the XLA composition in both types.  (The Pallas kernel
    # differs from it here: its Schur update multiplies by the stored d, 0,
    # where the composition and the port multiply by the guarded 1.)
    ref = np.asarray(_partial_ldlt_dyn(
        jnp.asarray(F.astype(npdt)), jnp.asarray(ncols),
        jnp.asarray(1, jnp.int32), 8)[0])
    assert contract_err(ref, out, ncols) < (1e-4 if dtype == "float32" else 1e-12)


def test_wrapper_checks_and_counts_nothing_on_cpu():
    F = torch.zeros(2, 8, 8, dtype=torch.float64)
    before = ldlt_kernels.launch_count()
    out = ldlt_kernels.partial_ldlt(F, torch.zeros(2, dtype=torch.int32))
    assert torch.equal(out, F) and out is not F
    assert ldlt_kernels.partial_ldlt(F, torch.zeros(2, dtype=torch.int32),
                                     inplace=True) is F
    assert ldlt_kernels.launch_count() == before     # no kernel ran on the CPU
    with pytest.raises(ValueError):
        ldlt_kernels.partial_ldlt(torch.zeros(2, 8, 4), torch.zeros(2))
    with pytest.raises(ValueError):
        ldlt_kernels.partial_ldlt(F, torch.zeros(3, dtype=torch.int32))


def test_bound_counts_bytes_and_operations():
    ncols = np.array([0, 8, 3])
    ops = ldlt_kernels.ldlt_operations(ncols, 8)
    want = sum((8 - 1 - j) + 2 * (8 - 1 - j) ** 2
               for nc in ncols for j in range(nc))
    assert ops == pytest.approx(want)
    ms, by = ldlt_kernels.ldlt_bound_ms(ncols, 8, torch.float64)
    assert by == "bytes" and ms == pytest.approx(
        (2 * 3 * 64 * 8 + 4 * 3) / ldlt_kernels.H100_BYTES_PER_S * 1e3)
