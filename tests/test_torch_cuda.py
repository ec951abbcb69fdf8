"""Tests of the PyTorch port that need a CUDA device: the hand-written
kernels against their plain versions, and the CUDA path against the CPU path
of the same code.  Each skips where there is no device.  On a machine with
one, run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: this file needs nothing of the JAX set-up in
tests/conftest.py and imports only torch and the port)."""
import numpy as np
import pytest
import torch

from galahad_tpu_torch import make_sparse_qp
from galahad_tpu_torch.linalg import ldlt_kernels
from galahad_tpu_torch.linalg import supernodal_flat as T
from galahad_tpu_torch.qp.ipm import ipm_solve

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def fronts(nb, Fpad, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(nb, Fpad, Fpad))
    F = G @ G.transpose(0, 2, 1) / Fpad + np.eye(Fpad)
    F *= np.where(np.arange(nb) % 2 == 0, 1.0, -1.0)[:, None, None]
    ncols = rng.integers(0, Fpad + 1, nb).astype(np.int32)
    ncols[-1] = Fpad
    ncols[0] = 0 if nb > 1 else Fpad
    return (torch.as_tensor(F, dtype=dtype, device=device).contiguous(),
            torch.as_tensor(ncols, device=device))


def grid_qp(k, device):
    rng = np.random.default_rng(0)
    n, m = k * k, k * k // 2
    idx = np.arange(n).reshape(k, k)
    ii, jj, vv = [np.arange(n)], [np.arange(n)], [np.full(n, 4.0)]
    for a, b in ((idx[:, 1:], idx[:, :-1]), (idx[1:, :], idx[:-1, :])):
        ii.append(a.ravel())
        jj.append(b.ravel())
        vv.append(np.full(a.size, -1.0))
    ar = np.repeat(np.arange(m), 2)
    ac = np.stack([np.arange(m), np.arange(m) + n - m]).T.reshape(-1)
    return make_sparse_qp(
        n, m, h_coo=tuple(map(np.concatenate, (ii, jj, vv))),
        a_coo=(ar, ac, rng.uniform(0.5, 1.5, 2 * m)), g=rng.normal(size=n),
        c_l=np.full(m, 1.0), c_u=np.full(m, 1e20), x_l=np.zeros(n),
        x_u=np.full(n, 2.0), device=device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("Fpad", [8, 16, 32, 64, 96, 128])
@pytest.mark.parametrize("nb", [1, 37, 1000])
def test_kernel_matches_plain(cuda, dtype, tol, Fpad, nb):
    F, ncols = fronts(nb, Fpad, dtype, cuda, seed=Fpad + nb)
    before = ldlt_kernels.launch_count()
    out = ldlt_kernels.partial_ldlt(F, ncols)
    assert ldlt_kernels.launch_count() == before + 1
    ref = ldlt_kernels.partial_ldlt_plain(F, ncols)
    ar = torch.arange(Fpad, device=cuda)
    nc = ncols.to(torch.int64)[:, None, None]
    r, c = ar[None, :, None], ar[None, None, :]
    mask = ((c < nc) & (r >= c)) | ((r >= nc) & (c >= nc))
    err = float(((out - ref).abs() * mask).max())
    assert err <= tol * max(1.0, float(ref.abs().max()))


def test_kernel_refuses_what_it_does_not_take(cuda):
    F, ncols = fronts(2, 8, torch.float64, cuda)
    with pytest.raises(ValueError):
        ldlt_kernels.partial_ldlt(torch.zeros(1, 192, 192, device=cuda),
                                  torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):                   # not a size of the ladder
        ldlt_kernels.partial_ldlt(torch.zeros(1, 24, 24, device=cuda),
                                  torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        ldlt_kernels.partial_ldlt(F, ncols.to(torch.int64))
    with pytest.raises(ValueError):
        ldlt_kernels.partial_ldlt(F.transpose(1, 2), ncols)
    with pytest.raises(TypeError):
        ldlt_kernels.partial_ldlt(F.to(torch.float16), ncols)


def wide_chunk(ch, Fpad, dtype, device, seed=0):
    """A chunk of wide fronts as a STRIDED view (rows 8 elements longer than
    the front, base off 16-byte alignment) of a larger buffer."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(ch, Fpad, Fpad))
    A = G @ G.transpose(0, 2, 1) / Fpad + np.eye(Fpad)
    A *= np.where(np.arange(ch) % 2 == 0, 1.0, -1.0)[:, None, None]
    big = torch.zeros(3 + ch * Fpad * (Fpad + 8), dtype=dtype, device=device)
    F = big[3:].view(ch, Fpad, Fpad + 8)[:, :, :Fpad]
    F.copy_(torch.as_tensor(A, dtype=dtype))
    return F


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("Fpad,ch", [(192, 1), (192, 8), (256, 1), (256, 8), (512, 1),
                                     (512, 8), (1024, 1), (1024, 8), (2048, 1),
                                     (2048, 8), (4096, 1)])
def test_panel_kernel_matches_plain(cuda, dtype, tol, Fpad, ch):
    # tolerance: float32 / float64 rounding of at most 32 fused updates per
    # entry, relative to the largest entry of the plain result
    B = ldlt_kernels.PANEL
    F = wide_chunk(ch, Fpad, dtype, cuda, seed=Fpad + ch)
    for b in (0, (Fpad // 2 // B) * B, Fpad - 2 * B):
        pool = [0, b + 5, b + B, Fpad, b + 17, b + 31, b + 1, Fpad - 1]
        ncols = torch.tensor(pool[4:5] if ch == 1 else pool[:ch],
                             dtype=torch.int32, device=cuda)
        F0 = F.clone()
        Fp = F.clone()
        W = torch.full((ch, Fpad - b, B), float("nan"), dtype=dtype, device=cuda)
        Lm = torch.full_like(W, float("nan"))
        before = ldlt_kernels.panel_launch_count()
        plain_before = ldlt_kernels.panel_plain_count()
        ldlt_kernels.ldlt_panel(F, ncols, b, B, W, Lm)
        assert ldlt_kernels.panel_launch_count() == before + 1
        assert ldlt_kernels.panel_plain_count() == plain_before
        Wp, Lp = ldlt_kernels.ldlt_panel_plain(Fp, ncols, b, B)
        scale = max(1.0, float(Fp[:, b:, b:b + B].abs().max()), float(Wp.abs().max()))
        for got, want in ((F, Fp), (W, Wp), (Lm, Lp)):
            assert bool(torch.isfinite(got).all())
            assert float((got - want).abs().max()) <= tol * scale
        outside = torch.ones_like(F, dtype=torch.bool)
        outside[:, b:, b:b + B] = False
        assert torch.equal(F[outside], F0[outside])      # nothing else is written
        # bitwise repeat
        F2 = F0.clone()
        W2, L2 = torch.empty_like(W), torch.empty_like(W)
        ldlt_kernels.ldlt_panel(F2, ncols, b, B, W2, L2)
        assert torch.equal(F2, F) and torch.equal(W2, W) and torch.equal(L2, Lm)
        F.copy_(F0)


def test_panel_kernel_refuses_what_it_does_not_take(cuda):
    B = ldlt_kernels.PANEL
    F = wide_chunk(2, 192, torch.float64, cuda)
    ncols = torch.tensor([40, 192], dtype=torch.int32, device=cuda)
    W = torch.empty(2, 192, B, dtype=torch.float64, device=cuda)
    Lm = torch.empty_like(W)
    ldlt_kernels.ldlt_panel(F, ncols, 0, B, W, Lm)            # this one is taken
    with pytest.raises(TypeError):                           # wrong dtype
        ldlt_kernels.ldlt_panel(F.half(), ncols, 0, B, W.half(), Lm.half())
    with pytest.raises(ValueError):                          # ncols not int32
        ldlt_kernels.ldlt_panel(F, ncols.to(torch.int64), 0, B, W, Lm)
    with pytest.raises(ValueError):                          # ncols not on the device
        ldlt_kernels.ldlt_panel(F, ncols.cpu(), 0, B, W, Lm)
    with pytest.raises(ValueError):                          # scratch of the wrong shape
        ldlt_kernels.ldlt_panel(F, ncols, B, B, W, Lm)
    with pytest.raises(ValueError):                          # scratch not contiguous
        ldlt_kernels.ldlt_panel(F, ncols, 0, B, W.transpose(1, 2).contiguous()
                                .transpose(1, 2), Lm)
    with pytest.raises(ValueError):                          # another panel width
        ldlt_kernels.ldlt_panel(F, ncols, 0, 16, W[:, :, :16].contiguous(),
                                Lm[:, :, :16].contiguous())
    with pytest.raises(ValueError):                          # no unit stride along a row
        ldlt_kernels.ldlt_panel(F.transpose(1, 2), ncols, 0, B, W, Lm)


def test_items_kernel_matches_batch_by_batch(cuda):
    batches, parts, off = [], [], 128
    for Fpad, nb in ((8, 300), (128, 3), (16, 77), (64, 11), (32, 29), (96, 5)):
        F, ncols = fronts(nb, Fpad, torch.float64, cuda, seed=Fpad)
        batches.append((off, Fpad, ncols.cpu().numpy()))
        parts.append((off, F, ncols))
        off += F.numel() + 64
    buf = torch.zeros(off, dtype=torch.float64, device=cuda)
    for o, F, _ in parts:
        buf[o:o + F.numel()] = F.reshape(-1)
    items = ldlt_kernels.build_ldlt_items(batches, cuda)
    before = ldlt_kernels.launch_count()
    ldlt_kernels.partial_ldlt_items(buf, items)
    assert ldlt_kernels.launch_count() == before + 1
    for o, F, ncols in parts:
        assert torch.equal(buf[o:o + F.numel()].view_as(F),
                           ldlt_kernels.partial_ldlt(F, ncols))
    with pytest.raises(ValueError):
        ldlt_kernels.partial_ldlt_items(buf[:-200], items)
    with pytest.raises(TypeError):
        ldlt_kernels.partial_ldlt_items(buf.half(), items)


def wide_block_matrix():
    """A dense 160 x 160 block hanging off a chain (lower COO): in the
    natural order its front is padded to 192 > 128."""
    rng = np.random.default_rng(11)
    n, nd = 200, 160
    A = np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1) \
        + np.diag(np.full(n - 1, -1.0), -1)
    B = rng.normal(size=(nd, nd)) / np.sqrt(nd)
    A[n - nd:, n - nd:] += B @ B.T + np.eye(nd)
    rows, cols = np.nonzero(np.tril(A))
    return rows, cols, A[rows, cols], n


def test_wide_front_factor_and_solve_match_the_cpu_path(cuda):
    # tolerance 1e-11 on an O(1) solution: float64, the card's fused updates
    # and cuBLAS product against the CPU's
    rows, cols, vals, n = wide_block_matrix()
    plan = T.flat_analyse(rows, cols, n, order="natural")
    assert max(g.Fpad for g in plan.groups) > ldlt_kernels.MAX_KERNEL_FRONT
    b = np.random.default_rng(1).normal(size=n)
    out = {}
    for dev in ("cpu", cuda):
        before = ldlt_kernels.panel_launch_count()
        plain_before = ldlt_kernels.panel_plain_count()
        fac = T.flat_factorize(plan, torch.as_tensor(vals, device=dev))
        x = T.flat_solve(plan, fac, torch.as_tensor(b, device=dev))
        out[str(dev)] = (fac.inertia.tolist(), x.cpu().numpy(), fac.store)
        if dev != "cpu":
            assert ldlt_kernels.panel_launch_count() > before
            assert ldlt_kernels.panel_plain_count() == plain_before
    assert out["cpu"][0] == out["cuda"][0] == [n, 0, 0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-11)
    fac2 = T.flat_factorize(plan, torch.as_tensor(vals, device=cuda))
    x2 = T.flat_solve(plan, fac2, torch.as_tensor(b, device=cuda))
    assert torch.equal(fac2.store, out["cuda"][2])           # bitwise repeat
    assert np.array_equal(x2.cpu().numpy(), out["cuda"][1])


def test_flat_factor_and_solve_match_the_cpu_path(cuda):
    import scipy.sparse as sp

    qp = grid_qp(16, "cpu")
    n, m = qp.n, qp.m
    rows = np.concatenate([qp.h_pat.rows, qp.a_pat.rows + n, np.arange(n + m)])
    cols = np.concatenate([qp.h_pat.cols, qp.a_pat.cols, np.arange(n + m)])
    vals = np.concatenate([qp.h_vals.numpy(), qp.a_vals.numpy(),
                           np.full(n, 1.0), np.full(m, -1.0)])
    plan = T.flat_analyse(rows, cols, n + m, relax_cols=16)
    b = np.random.default_rng(1).normal(size=n + m)
    out = {}
    for dev in ("cpu", cuda):
        fac = T.flat_factorize(plan, torch.as_tensor(vals, device=dev))
        x = T.flat_solve(plan, fac, torch.as_tensor(b, device=dev))
        out[str(dev)] = (fac.inertia.tolist(), x.cpu().numpy())
    assert out["cpu"][0] == out["cuda"][0] == [n, m, 0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-11)
    K = sp.csr_matrix((vals, (rows, cols)), shape=(n + m, n + m))
    K = K + sp.tril(K, -1).T
    assert np.linalg.norm(K @ out["cuda"][1] - b) <= 1e-11 * np.linalg.norm(b)


def test_ipm_on_the_card_matches_the_cpu_and_repeats_bitwise(cuda):
    xc, _, _, sc = ipm_solve(grid_qp(12, "cpu"))
    before = ldlt_kernels.launch_count()
    xg, yg, zg, sg = ipm_solve(grid_qp(12, cuda))
    assert ldlt_kernels.launch_count() > before
    assert (sg.status, sg.iter) == (sc.status, sc.iter) == (0, sc.iter)
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=0, atol=1e-8)
    xg2, yg2, zg2, _ = ipm_solve(grid_qp(12, cuda))
    assert torch.equal(xg, xg2) and torch.equal(yg, yg2) and torch.equal(zg, zg2)
