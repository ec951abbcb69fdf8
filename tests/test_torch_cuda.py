"""Tests of the PyTorch port that need a CUDA device: the hand-written
kernels against their plain versions, and the CUDA path against the CPU path
of the same code.  Each skips where there is no device.  On a machine with
one, run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: this file needs nothing of the JAX set-up in
tests/conftest.py and imports only torch and the port)."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from galahad_tpu_torch import make_sparse_qp
from galahad_tpu_torch.linalg import banded_kernels, ea_kernels, ldlt_kernels
from galahad_tpu_torch.core import trace
from galahad_tpu_torch.linalg import supernodal_flat as T
from galahad_tpu_torch.linalg import sweep_kernels
from galahad_tpu_torch.qp.ipm import ipm_solve

from _torch_port_helpers import ea_synthetic_level, inside, oracle_factorize, profiled_spans

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


def wide_specs(Fpad, count):
    """(ncols, nf) of the fronts of one synthetic level: 0, 1, 31, 33, partial
    and full elimination, nf below and at Fpad."""
    nf = Fpad - 29
    if count == 1:
        return [(nf - 45, nf)]
    return [(nf, nf), (nf - 45, nf), (33, nf - 7), (1, nf - 3), (31, nf), (0, nf - 1),
            (Fpad // 2, Fpad), (Fpad - 64, Fpad - 60)][:count]


WIDE_LEVELS = {f"{Fpad}x{count}": [(Fpad, nc, nf) for nc, nf in wide_specs(Fpad, count)]
               for Fpad in (192, 384, 1024, 4096) for count in (1, 8)}
WIDE_LEVELS["mixed"] = [(192, 150, 190), (1024, 700, 1000), (384, 1, 290), (256, 0, 200),
                        (384, 300, 384), (192, 33, 180), (4096, 200, 3000)]


def wide_level_store(specs, dtype, device, seed=0):
    """A flat store holding the fronts ``specs = [(Fpad, ncols, nf), ...]``
    (symmetric definite of either sign on the leading nf x nf block) with NaN
    in every entry the kernel may neither read nor write: rows and columns at
    or beyond nf, the upper triangle of rows < ncols, and the gaps between
    fronts.  Returns (store, level table, contract mask, untouchable mask)."""
    rng = np.random.default_rng(seed)
    rows, off = [], 40
    for Fpad, nc, nf in specs:
        rows.append((off, Fpad, nc, nf))
        off += Fpad * Fpad + 40
    store = torch.full((off,), float("nan"), dtype=dtype, device=device)
    contract = torch.zeros(off, dtype=torch.bool, device=device)
    for i, (o, Fpad, nc, nf) in enumerate(rows):
        G = torch.as_tensor(rng.normal(size=(nf, nf)), dtype=torch.float64, device=device)
        A = (G @ G.T / nf + torch.eye(nf, dtype=torch.float64, device=device)) \
            * (1.0 if i % 2 == 0 else -1.0)
        ar = torch.arange(nf, device=device)
        r, c = ar[:, None], ar[None, :]
        A[(r < c) & (r < nc)] = float("nan")
        F = store[o:o + Fpad * Fpad].view(Fpad, Fpad)
        F[:nf, :nf] = A.to(dtype)
        m = contract[o:o + Fpad * Fpad].view(Fpad, Fpad)
        m[:nf, :nf] = ((c < nc) & (r >= c)) | ((r >= nc) & (c >= nc))
        del G, A
    return store, ldlt_kernels.build_wide_level(rows, device), contract, torch.isnan(store)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("case", sorted(WIDE_LEVELS))
def test_wide_kernel_matches_plain(cuda, case, dtype, tol):
    # tolerance: float32 / float64 rounding of up to 4096-term sums taken in
    # another order, relative to the largest entry of the plain result
    store, lvl, contract, nan = wide_level_store(WIDE_LEVELS[case], dtype, cuda,
                                                 seed=len(case))
    got = store.clone()
    launches, plain = ldlt_kernels.wide_launch_count(), ldlt_kernels.wide_plain_count()
    ldlt_kernels.partial_ldlt_wide(got, lvl)
    torch.cuda.synchronize()
    assert ldlt_kernels.wide_launch_count() == launches + 1     # one launch per call
    assert ldlt_kernels.wide_plain_count() == plain
    ref = store.clone()
    ldlt_kernels.partial_ldlt_wide_plain(ref, lvl)
    assert bool(torch.isfinite(got[contract]).all())
    err = float((got[contract] - ref[contract]).abs().max())
    assert err <= tol * max(1.0, float(ref[contract].abs().max()))
    assert same_bits(got[nan], store[nan])               # never read, never written
    again = store.clone()
    ldlt_kernels.partial_ldlt_wide(again, lvl)
    assert same_bits(again, got)                         # bitwise repeat


def test_wide_kernel_refuses_what_it_does_not_take(cuda):
    store, lvl, _, _ = wide_level_store([(192, 40, 180), (256, 256, 256)], torch.float64,
                                        cuda)
    ldlt_kernels.partial_ldlt_wide(store.clone(), lvl)   # this one is taken
    with pytest.raises(TypeError):                       # wrong dtype
        ldlt_kernels.partial_ldlt_wide(store.half(), lvl)
    with pytest.raises(ValueError):                      # table on another device
        ldlt_kernels.partial_ldlt_wide(
            store, ldlt_kernels.build_wide_level(lvl.fronts, "cpu"))
    with pytest.raises(ValueError):                      # store on another device
        ldlt_kernels.partial_ldlt_wide(store.cpu(), lvl)
    with pytest.raises(ValueError):                      # not contiguous
        ldlt_kernels.partial_ldlt_wide(
            torch.zeros(2 * store.numel(), dtype=store.dtype, device=cuda)[::2], lvl)
    with pytest.raises(ValueError):                      # too short
        ldlt_kernels.partial_ldlt_wide(store[:lvl.end - 1], lvl)
    with pytest.raises(ValueError, match="aligned"):     # first entry off 16 bytes
        ldlt_kernels.partial_ldlt_wide(store[1:], lvl)
    with pytest.raises(ValueError):                      # not a flat store
        ldlt_kernels.partial_ldlt_wide(store[:lvl.end].view(1, -1), lvl)


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
    # and tensor-core products against the CPU's
    rows, cols, vals, n = wide_block_matrix()
    plan = T.flat_analyse(rows, cols, n, order="natural")
    assert max(g.Fpad for g in plan.groups) > ldlt_kernels.MAX_KERNEL_FRONT
    b = np.random.default_rng(1).normal(size=n)
    out = {}
    for dev in ("cpu", cuda):
        before = ldlt_kernels.wide_launch_count()
        plain_before = ldlt_kernels.wide_plain_count()
        fac = T.flat_factorize(plan, torch.as_tensor(vals, device=dev))
        x = T.flat_solve(plan, fac, torch.as_tensor(b, device=dev))
        out[str(dev)] = (fac.inertia.tolist(), x.cpu().numpy(), fac.store)
        if dev != "cpu":
            levels = sum(lvp["wide"] is not None
                         for lvp in T._device_plan(plan, cuda)["levels"])
            assert ldlt_kernels.wide_launch_count() - before == levels >= 1
            assert ldlt_kernels.wide_plain_count() == plain_before
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


def sweep_level(specs, dtype, device, seed):
    """A synthetic tree level for the sweep kernels: fronts
    ``specs = [(Fpad, [(ncols, nf), ...]), ...]`` with random unit-lower L and
    d (one pivot of a front is 0: divided by 1) and NaN in every other entry
    (the Schur block, the upper triangle, the padded rows); eliminated rows distinct over all fronts, struct rows drawn from one
    shared pool so that fronts add into the same rows.  Returns (store, level
    tables, y)."""
    rng = np.random.default_rng(seed)
    n_elim = sum(nc for _, fronts_ in specs for nc, _ in fronts_)
    pool = max(nf - nc for _, fronts_ in specs for nc, nf in fronts_) + 7
    n = n_elim + pool
    parts, batches = [], []
    off = next_row = 0
    for Fpad, fronts_ in specs:
        nb = len(fronts_)
        F = np.full((nb, Fpad, Fpad), np.nan)
        frows = np.full((nb, Fpad), n, np.int64)
        for i, (nc, nf) in enumerate(fronts_):
            L = rng.normal(size=(nf, nc)) * 0.5 / np.sqrt(max(nc, 1))
            below = np.arange(nf)[:, None] > np.arange(nc)[None, :]
            F[i, :nf, :nc] = np.where(below, L, np.nan)
            d = rng.uniform(0.5, 2.0, nc) * rng.choice([-1.0, 1.0], nc)
            if nc > 2:
                d[1] = 0.0
            F[i, np.arange(nc), np.arange(nc)] = d
            frows[i, :nc] = np.arange(next_row, next_row + nc)
            frows[i, nc:nf] = n_elim + np.sort(rng.choice(pool, nf - nc, replace=False))
            next_row += nc
        batches.append((off, Fpad, np.array([nc for nc, _ in fronts_], np.int64), frows))
        parts.append(F.ravel())
        off += F.size
    store = torch.as_tensor(np.concatenate(parts + [np.zeros(1)]), dtype=dtype,
                            device=device)
    y = rng.normal(size=n + 1)
    y[n] = 0.0
    return (store, sweep_kernels.build_sweep_level(batches, n, device),
            torch.as_tensor(y, dtype=dtype, device=device))


def ladder_fronts(Fpad, copies):
    """ncols of 0, 1, partial and full, with and without struct rows."""
    base = [(0, Fpad // 2), (1, Fpad), (1, 1), (Fpad // 3, Fpad), (Fpad // 3, Fpad // 2),
            (Fpad, Fpad), (Fpad - 5, Fpad - 2), (2, Fpad - 1), (Fpad // 2, Fpad // 2)]
    return base * copies


SWEEP_LEVELS = {
    "small": [(8, ladder_fronts(8, 40)), (16, ladder_fronts(16, 9)),
              (32, ladder_fronts(32, 5))],
    "medium": [(64, ladder_fronts(64, 3)), (96, ladder_fronts(96, 2)),
               (128, ladder_fronts(128, 2)), (8, ladder_fronts(8, 3))],
    "wide": [(192, ladder_fronts(192, 1)), (256, [(100, 256), (256, 256), (7, 250)]),
             (384, [(33, 384), (380, 383)]), (512, [(64, 512), (500, 512)])],
    "wider": [(768, [(31, 768), (700, 768)]), (1024, [(1024, 1024), (200, 1000)]),
              (1536, [(300, 1536)]), (2048, [(129, 2048), (2048, 2048)])],
    "widest": [(3072, [(500, 3072)]), (4096, [(1000, 4000), (4096, 4096)]),
               (16, ladder_fronts(16, 2))],
    # the flagship's root: one dense triangle of 112 steps
    "root": [(4096, [(3575, 3575)])],
    # the root beside 300 fronts of 64 with 1..22 columns
    "root_and_small": [(4096, [(3575, 3575)]),
                       (64, [(1 + k % 22, 1 + k % 22 + (7 * k) % (42 - k % 22))
                             for k in range(300)])],
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("case", sorted(SWEEP_LEVELS))
def test_sweep_kernels_match_plain(cuda, case, dtype, tol):
    # tolerance: rounding of the dot products of a front (up to 4096 terms,
    # taken in another order), relative to the largest entry of the plain result
    store, lvl, y0 = sweep_level(SWEEP_LEVELS[case], dtype, cuda, seed=len(case))
    if case != "small":
        assert lvl.fwd_wave.shape[0] > 0 and lvl.bwd_wave.shape[0] > 0
    assert lvl.fwd_kernels <= 3 and lvl.bwd_kernels <= 2      # per call, whatever the fronts
    work = torch.full((lvl.work_size,), float("nan"), dtype=dtype, device=cuda)
    before, plain_before = sweep_kernels.sweep_counts(), sweep_kernels.sweep_plain_count()
    yk = y0.clone()
    sweep_kernels.sweep_fwd(store, yk, lvl, work)
    after = sweep_kernels.sweep_counts()
    assert after["fwd"] == before["fwd"] + 1
    assert after["fwd_kernels"] == before["fwd_kernels"] + lvl.fwd_kernels
    assert sweep_kernels.sweep_plain_count() == plain_before
    yp = y0.clone()
    wp = torch.zeros_like(work)
    sweep_kernels.sweep_fwd_plain(store, yp, lvl, wp)
    sweep_kernels.sweep_accumulate_plain(yp, lvl, wp)
    assert bool(torch.isfinite(yk).all())
    assert float((yk - yp).abs().max()) <= tol * max(1.0, float(yp.abs().max()))
    assert float(yk[-1]) == 0.0
    yk2 = y0.clone()
    sweep_kernels.sweep_fwd(store, yk2, lvl, torch.zeros_like(work))   # other scratch
    assert torch.equal(yk2, yk)                              # bitwise repeat
    # backward, both from the plain forward result
    xk = yp.clone()
    sweep_kernels.sweep_bwd(store, xk, lvl, work)
    xp = yp.clone()
    sweep_kernels.sweep_bwd_plain(store, xp, lvl)
    assert bool(torch.isfinite(xk).all())
    assert float((xk - xp).abs().max()) <= tol * max(1.0, float(xp.abs().max()))
    xk2 = yp.clone()
    sweep_kernels.sweep_bwd(store, xk2, lvl, torch.zeros_like(work))
    assert torch.equal(xk2, xk)
    assert sweep_kernels.sweep_counts()["bwd_kernels"] == \
        before["bwd_kernels"] + 2 * lvl.bwd_kernels


def test_sweep_kernels_refuse_what_they_do_not_take(cuda):
    store, lvl, y = sweep_level([(16, [(4, 9), (16, 16)]), (64, [(10, 40)])],
                                torch.float64, cuda, seed=0)
    work = torch.empty(lvl.work_size, dtype=y.dtype, device=cuda)
    sweep_kernels.sweep_fwd(store, y, lvl, work)              # this one is taken
    for fn in (sweep_kernels.sweep_fwd, sweep_kernels.sweep_bwd):
        with pytest.raises(TypeError):                       # wrong dtype
            fn(store.half(), y.half(), lvl, work.half())
        with pytest.raises(ValueError):                      # y on another device
            fn(store, y.cpu(), lvl, work)
        with pytest.raises(ValueError):                      # tables on another device
            fn(store.cpu(), y.cpu(), lvl, work.cpu())
        with pytest.raises(ValueError):                      # not contiguous
            fn(store, torch.zeros(2 * y.numel(), dtype=y.dtype, device=cuda)[::2], lvl,
               work)
        with pytest.raises(ValueError):                      # scratch too small
            fn(store, y, lvl, torch.zeros(5, dtype=y.dtype, device=cuda))


def test_a_broken_wave_table_raises_and_does_not_hang(cuda, monkeypatch):
    """An item that waits on its own flag (a wait on no earlier ticket) can
    never go on: its block gives up after SPIN_POLLS polls, every other block
    leaves, the call ends, and the wrapper raises at the next call on the
    level (sweep_check at once).  The card stays usable."""
    monkeypatch.setattr(sweep_kernels, "SPIN_POLLS", 1 << 20)
    store, lvl, y = sweep_level([(256, [(256, 256)])], torch.float64, cuda, seed=3)
    work = torch.empty(lvl.work_size, dtype=y.dtype, device=cuda)
    wave = lvl.fwd_wave
    t = int(((wave[:, 3] == sweep_kernels.ITEM)).nonzero()[0, 0])   # triangle block 1
    wave[t, 7] += 1                                                 # waits on itself
    sweep_kernels.sweep_fwd(store, y, lvl, work)
    with pytest.raises(RuntimeError, match="gave up waiting"):
        sweep_kernels.sweep_check(lvl)
    for fn in (sweep_kernels.sweep_fwd, sweep_kernels.sweep_bwd):
        with pytest.raises(RuntimeError, match="ticket order"):
            fn(store, y, lvl, work)
    store, good, y = sweep_level([(256, [(256, 256)])], torch.float64, cuda, seed=3)
    sweep_kernels.sweep_fwd(store, y, good, work)
    sweep_kernels.sweep_check(good)
    assert bool(torch.isfinite(y).all())


def test_flat_solve_on_the_card_runs_only_the_sweep_kernels(cuda):
    qp = grid_qp(16, "cpu")
    n, m = qp.n, qp.m
    rows = np.concatenate([qp.h_pat.rows, qp.a_pat.rows + n, np.arange(n + m)])
    cols = np.concatenate([qp.h_pat.cols, qp.a_pat.cols, np.arange(n + m)])
    vals = np.concatenate([qp.h_vals.numpy(), qp.a_vals.numpy(),
                           np.full(n, 1.0), np.full(m, -1.0)])
    plan = T.flat_analyse(rows, cols, n + m, relax_cols=16)
    b = np.random.default_rng(1).normal(size=n + m)
    fac_c = T.flat_factorize(plan, torch.as_tensor(vals))
    x_c = T.flat_solve(plan, fac_c, torch.as_tensor(b)).numpy()
    fac = T.flat_factorize(plan, torch.as_tensor(vals, device=cuda))
    before, plain_before = sweep_kernels.sweep_counts(), sweep_kernels.sweep_plain_count()
    x = T.flat_solve(plan, fac, torch.as_tensor(b, device=cuda))
    after = sweep_kernels.sweep_counts()
    levels = len(T._device_plan(plan, cuda)["levels"])
    assert after["fwd"] - before["fwd"] == after["bwd"] - before["bwd"] == levels
    assert after["fwd_kernels"] - before["fwd_kernels"] <= 3 * levels
    assert after["bwd_kernels"] - before["bwd_kernels"] <= 2 * levels
    assert sweep_kernels.sweep_plain_count() == plain_before
    # the same factors through the plain sweeps on the card
    np.testing.assert_allclose(x.cpu().numpy(), x_c, rtol=0, atol=1e-11)
    assert torch.equal(x, T.flat_solve(plan, fac, torch.as_tensor(b, device=cuda)))
    # float32 on the card
    fac32 = T.flat_factorize(plan, torch.as_tensor(vals, dtype=torch.float32, device=cuda))
    x32 = T.flat_solve(plan, fac32, torch.as_tensor(b, dtype=torch.float32, device=cuda))
    assert x32.dtype == torch.float32
    assert np.abs(x32.cpu().numpy() - x_c).max() <= 1e-4 * np.abs(x_c).max()


def test_ipm_on_the_card_matches_the_cpu_and_repeats_bitwise(cuda):
    xc, _, _, sc = ipm_solve(grid_qp(12, "cpu"))
    before = ldlt_kernels.launch_count()
    xg, yg, zg, sg = ipm_solve(grid_qp(12, cuda))
    assert ldlt_kernels.launch_count() > before
    assert (sg.status, sg.iter) == (sc.status, sc.iter) == (0, sc.iter)
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=0, atol=1e-8)
    xg2, yg2, zg2, _ = ipm_solve(grid_qp(12, cuda))
    assert torch.equal(xg, xg2) and torch.equal(yg, yg2) and torch.equal(zg, zg2)


# ---------------------------------------------------------------------------
# The extend-add kernel (csrc/extend_add.cu)
# ---------------------------------------------------------------------------

EA_LEVELS = {
    "8": [(8, [1, 2, 4, 16])],
    "32": [(32, [1, 2, 4, 16]), (8, [3, 1])],
    "128": [(128, [1, 2, 4, 16]), (16, [2, 5])],
    "512": [(512, [1, 2, 4, 16])],
    "4096": [(4096, [1, 2]), (4096, [16], 512)],
    # more pairs in a tile than a warp has lanes
    "heavy": [(64, [40, 40, 33], 64)],
    # odd counts of parents of 8, 16 and 64: packed four and two to a warp
    "packed": [(8, [3, 1, 5, 2, 9]), (16, [2, 7, 1]), (64, [3, 1, 2, 1, 4], 40)],
}


def same_bits(a, b):
    """Bitwise equality, NaN included."""
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(EA_LEVELS))
def test_extend_add_kernel_matches_plain_bitwise(cuda, case, dtype):
    # NaN in every child entry outside its Schur block and in every parent
    # entry no child reaches: the kernel must neither read nor write them
    store_np, batches, reached = ea_synthetic_level(EA_LEVELS[case], seed=len(case))
    store = torch.as_tensor(store_np, dtype=dtype, device=cuda)
    lvl = ea_kernels.build_ea_level(batches, cuda)
    before = ea_kernels.ea_counts()
    got = store.clone()
    ea_kernels.extend_add(got, lvl)
    after = ea_kernels.ea_counts()
    assert after["calls"] == before["calls"] + 1
    assert after["kernels"] == before["kernels"] + lvl.kernels == before["kernels"] + 1
    assert after["plain"] == before["plain"]
    ref = store.clone()
    ea_kernels.extend_add_plain(ref, lvl)
    assert same_bits(got, ref)
    reached = torch.as_tensor(reached, device=cuda)
    assert bool(torch.isfinite(got[reached]).all())
    assert same_bits(got[~reached & torch.isnan(store)], store[~reached & torch.isnan(store)])
    again = store.clone()
    ea_kernels.extend_add(again, lvl)
    assert same_bits(again, got)                             # bitwise repeat


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_extend_add_kernel_spills_nothing_and_keeps_16_warps_per_sm(cuda, dtype):
    att = ea_kernels.ea_attributes(dtype)
    assert att["spill_bytes"] == 0
    assert att["warps_per_sm"] >= 16


def test_extend_add_kernel_refuses_what_it_does_not_take(cuda):
    store_np, batches, _ = ea_synthetic_level([(32, [2, 3])], seed=0)
    store = torch.as_tensor(store_np, device=cuda)
    lvl = ea_kernels.build_ea_level(batches, cuda)
    ea_kernels.extend_add(store.clone(), lvl)                # this one is taken
    with pytest.raises(TypeError):                           # wrong dtype
        ea_kernels.extend_add(store.half(), lvl)
    with pytest.raises(ValueError):                          # tables on another device
        ea_kernels.extend_add(store, ea_kernels.build_ea_level(batches, "cpu"))
    with pytest.raises(ValueError):                          # store on another device
        ea_kernels.extend_add(store.cpu(), lvl)
    with pytest.raises(ValueError):                          # not contiguous
        ea_kernels.extend_add(torch.zeros(2 * store.numel(), dtype=store.dtype,
                                          device=cuda)[::2], lvl)
    with pytest.raises(ValueError):                          # too short
        ea_kernels.extend_add(store[:10], lvl)


def test_flat_factorize_on_the_card_runs_only_the_extend_add_kernel(cuda):
    qp = grid_qp(16, "cpu")
    n, m = qp.n, qp.m
    rows = np.concatenate([qp.h_pat.rows, qp.a_pat.rows + n, np.arange(n + m)])
    cols = np.concatenate([qp.h_pat.cols, qp.a_pat.cols, np.arange(n + m)])
    vals = np.concatenate([qp.h_vals.numpy(), qp.a_vals.numpy(),
                           np.full(n, 1.0), np.full(m, -1.0)])
    plan = T.flat_analyse(rows, cols, n + m, relax_cols=16)
    levels = sum(lvp["ea"] is not None for lvp in T._device_plan(plan, cuda)["levels"])
    before = ea_kernels.ea_counts()
    fac = T.flat_factorize(plan, torch.as_tensor(vals, device=cuda))
    after = ea_kernels.ea_counts()
    assert 0 < after["calls"] - before["calls"] == after["kernels"] - before["kernels"] \
        == levels
    assert after["plain"] == before["plain"]
    # the bucketed composition this replaced, on the card: the same bits
    old, calls = oracle_factorize(T, plan, torch.as_tensor(vals, device=cuda))
    assert calls == levels
    assert torch.equal(fac.store, old.store)
    # the plain extend-add in the kernel's place: the same bits
    saved = T.extend_add
    T.extend_add = ea_kernels.extend_add_plain
    try:
        plain = T.flat_factorize(plan, torch.as_tensor(vals, device=cuda))
    finally:
        T.extend_add = saved
    assert torch.equal(fac.store, plain.store)
    assert torch.equal(T.flat_factorize(plan, torch.as_tensor(vals, device=cuda)).store,
                       fac.store)


# ---------------------------------------------------------------------------
# CUDA graphs: each launcher captured alone, and the fused IPM iteration
# ---------------------------------------------------------------------------


def launcher_case(kernel, dtype, device):
    """(inputs, fn, sweep levels): ``fn(buffers)`` runs one launcher on
    copies of ``inputs``, in place."""
    if kernel == "partial_ldlt":
        batches, parts, off = [], [], 128
        for Fpad, nb in ((8, 300), (128, 3), (16, 77), (64, 11), (32, 29), (96, 5)):
            F, ncols = fronts(nb, Fpad, dtype, device, seed=Fpad)
            batches.append((off, Fpad, ncols.cpu().numpy()))
            parts.append((off, F))
            off += F.numel() + 64
        buf = torch.zeros(off, dtype=dtype, device=device)
        for o, F in parts:
            buf[o:o + F.numel()] = F.reshape(-1)
        items = ldlt_kernels.build_ldlt_items(batches, device)
        return (buf,), lambda b: ldlt_kernels.partial_ldlt_items(b[0], items), []
    if kernel == "ldlt_wide":
        store, lvl, _, _ = wide_level_store(WIDE_LEVELS["mixed"], dtype, device, seed=5)
        return (store,), lambda b: ldlt_kernels.partial_ldlt_wide(b[0], lvl), []
    if kernel == "extend_add":
        store_np, batches, _ = ea_synthetic_level(EA_LEVELS["packed"], seed=6)
        lvl = ea_kernels.build_ea_level(batches, device)
        store = torch.as_tensor(store_np, dtype=dtype, device=device)
        return (store,), lambda b: ea_kernels.extend_add(b[0], lvl), []
    if kernel == "banded":
        D, L = banded_blocks(37, 8, dtype, device, seed=8)
        rhs = torch.as_tensor(np.random.default_rng(8).normal(size=(37, 8, 3)), dtype=dtype,
                              device=device)

        def banded(b):
            Ld, Lo, ok = banded_kernels.block_tridiag_factor(b[0], b[1])
            b[3].copy_(banded_kernels.block_tridiag_solve(Ld, Lo, b[2]))
            b[4].copy_(Ld)
            b[5].copy_(ok)
        return (D, L, rhs, torch.zeros_like(rhs), torch.zeros_like(D),
                torch.zeros((), dtype=dtype, device=device)), banded, []
    store, lvl, y = sweep_level(SWEEP_LEVELS["root_and_small"], dtype, device, seed=7)
    work = torch.empty(lvl.work_size, dtype=dtype, device=device)

    def sweeps(b):
        sweep_kernels.sweep_fwd(b[0], b[1], lvl, work)
        sweep_kernels.sweep_bwd(b[0], b[1], lvl, work)
    return (store, y), sweeps, [lvl]


def counted_launches():
    from galahad_tpu_torch.qp.fused import launch_counts

    return sum(launch_counts().values())


def equal_bits(a, b):
    return same_bits(a, b) if a.is_floating_point() else torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["partial_ldlt", "ldlt_wide", "extend_add", "sweeps",
                                    "banded"])
def test_a_captured_launcher_replays_the_direct_call_bitwise(cuda, kernel, dtype):
    """Each launcher captured alone in a CUDA graph (the wide kernel's
    cooperative launch and the sweeps' memset of their ticket and flags
    included): a replay on the call's inputs gives the direct call's bits,
    and a second replay the same bits again."""
    inputs, fn, levels = launcher_case(kernel, dtype, cuda)
    direct = [t.clone() for t in inputs]
    fn(direct)
    bufs = [t.clone() for t in inputs]
    before = counted_launches()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        fn(bufs)
    moved = counted_launches() - before
    assert moved > 0                          # the wrappers count once, at capture
    for _ in range(2):
        for b, t in zip(bufs, inputs):
            b.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        assert all(same_bits(b, d) for b, d in zip(bufs, direct))
        sweep_kernels.sweep_check(levels)
    assert counted_launches() - before == moved          # a replay runs no wrapper


def test_a_replay_on_a_halted_state_changes_nothing(cuda):
    from galahad_tpu_torch.core.problem import classify_bounds
    from galahad_tpu_torch.qp import ipm as t_ipm

    qp = grid_qp(12, cuda)
    ctl = t_ipm.IPMControl()
    masks = classify_bounds(qp)
    stepper = t_ipm._stepper(qp, masks, t_ipm.ipm_init(qp, masks, ctl), ctl)
    halt = t_ipm.MONITOR.index("halt")
    while True:
        stepper.advance(1)
        if stepper.fetch()[halt]:
            break
    assert stepper.stats.path == "graph" and stepper.stats.replays > 0
    done = stepper.snapshot()
    stepper.advance(2)
    stepper.fetch()
    for name in t_ipm.TENSOR_FIELDS:
        assert equal_bits(getattr(stepper.state, name), getattr(done, name)), name
def test_the_graph_solve_equals_the_direct_one_bitwise(cuda, monkeypatch):
    """grid k=20 through the captured iteration, with steps_per_fetch=4 and
    through ipm_solve_compiled: the bits of GALAHAD_TPU_FUSED=0's direct
    step, and a replay launches what a direct iteration launches."""
    from galahad_tpu_torch.qp import ipm_solve_compiled
    from galahad_tpu_torch.qp.fused import launch_counts
    from galahad_tpu_torch.qp.ipm import IPMControl

    qp = grid_qp(20, cuda)
    monkeypatch.setenv("GALAHAD_TPU_FUSED", "0")
    before = launch_counts()
    xd, yd, zd, sd = ipm_solve(qp)
    after = launch_counts()
    per_iteration = {k: (after[k] - before[k]) / sd.iter for k in after}
    assert sd.run.path == "direct" and sd.run.replays == 0
    assert min(per_iteration[k] for k in ("partial_ldlt", "extend_add", "sweep_fwd",
                                          "sweep_bwd")) > 0
    monkeypatch.setenv("GALAHAD_TPU_FUSED", "1")
    for solver, ctl in ((ipm_solve, IPMControl()), (ipm_solve, IPMControl(steps_per_fetch=4)),
                        (ipm_solve_compiled, IPMControl())):
        x, y, z, st = solver(qp, ctl)
        assert st.run.path == "graph" and st.run.direct_steps == 1
        assert (st.status, st.iter) == (sd.status, sd.iter) == (0, sd.iter)
        assert st.run.replays - st.run.halted_replays == st.iter - 1
        assert st.run.sweep_checks == st.run.fetches
        assert st.run.launches_per_replay == per_iteration
        for a, b in ((x, xd), (y, yd), (z, zd)):
            assert same_bits(a, b)


def test_spans_inside_a_capture_under_the_profiler(cuda):
    """A graph-path solve under the profiler records every stepper span, and
    the step's phase spans inside the capture (a synchronisation there would
    fail the capture); a span opened while CUDA refuses every synchronisation
    raises nothing."""
    qp = grid_qp(8, cuda)

    def solve():
        out = ipm_solve(qp)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with trace.span("no_sync"):
                pass
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out

    (_, _, _, st), spans = profiled_spans(solve)
    assert st.status == 0 and st.run.path == "graph" and st.run.direct_steps == 1
    names = [s[0] for s in spans]
    for name in ("ipm.solve", "ipm.prepare", "stepper.direct", "stepper.capture",
                 "stepper.instantiate", "stepper.replays", "stepper.fetch",
                 "stepper.release", "ipm.finish", "no_sync"):
        assert name in names, name
    root = next(s for s in spans if s[0] == "ipm.solve")
    assert all(inside(s, root) for s in spans if s[0] != "no_sync")
    capture = next(s for s in spans if s[0] == "stepper.capture")
    for name in ("kkt.assemble", "kkt.factor", "kkt.solve", "coo.matvec", "stepper.instantiate"):
        assert any(inside(s, capture) for s in spans if s[0] == name), name
    assert names.count("stepper.fetch") == st.run.fetches
    assert names.count("stepper.direct") == 1 and names.count("stepper.capture") == 1


# ---------------------------------------------------------------------------
# Series arcs and the dense QP on the card
# ---------------------------------------------------------------------------


def dense_qp(n, m, seed, device, equalities=0, shifted=False):
    """tests/test_ipm.py::random_convex_qp at (n, m); ``shifted``: the first
    row and column of H and the first column of A zeroed and the first
    variable free, so that every first Cholesky try fails (the escalation
    case of tests/test_torch_ipm_dense_steps.py)."""
    from galahad_tpu_torch import make_qp

    from _torch_port_helpers import random_convex_qp_arrays

    a = random_convex_qp_arrays(n, m, seed, equalities=equalities)
    if shifted:
        a["H"][0, :] = 0.0
        a["H"][:, 0] = 0.0
        a["A"][:, 0] = 0.0
        a["x_l"][0], a["x_u"][0], a["g"][0] = -1e20, 1e20, 0.0
    return make_qp(device=device, **a)


def graph_equals_direct(qp, ctl, monkeypatch):
    """Solve on the direct path, then on the graph path with a fetch every
    iteration, every 4 and through ipm_solve_compiled: every graph run gives
    the direct run's status, iterations, escalations and bits.  Returns the
    direct run's state."""
    from galahad_tpu_torch.qp import ipm_solve_compiled

    monkeypatch.setenv("GALAHAD_TPU_FUSED", "0")
    xd, yd, zd, sd = ipm_solve(qp, ctl)
    assert sd.run.path == "direct"
    monkeypatch.setenv("GALAHAD_TPU_FUSED", "1")
    for solver, c in ((ipm_solve, ctl), (ipm_solve, dataclasses.replace(ctl, steps_per_fetch=4)),
                      (ipm_solve_compiled, ctl)):
        x, y, z, st = solver(qp, c)
        assert st.run.path == "graph" and st.run.direct_steps == 1
        assert (st.status, st.iter) == (sd.status, sd.iter)
        assert st.run.escalations == sd.run.escalations
        for a, b in ((x, xd), (y, yd), (z, zd)):
            assert same_bits(a, b)
    return sd


def test_an_arc_on_the_graph_equals_the_direct_path(cuda, monkeypatch):
    from galahad_tpu_torch.qp.ipm import IPMControl

    sd = graph_equals_direct(grid_qp(20, cuda), IPMControl(arc="taylor", series_order=4),
                             monkeypatch)
    assert sd.status == 0


def test_a_dense_qp_on_the_graph_equals_the_direct_path(cuda, monkeypatch):
    from galahad_tpu_torch.qp.ipm import IPMControl

    sd = graph_equals_direct(dense_qp(300, 120, 0, cuda, equalities=30), IPMControl(),
                             monkeypatch)
    assert sd.status == 0 and sd.run.escalations == 0


def test_the_escalation_on_the_card(cuda, monkeypatch):
    """Every first Cholesky try fails: each iteration is taken again with the
    escalating shift and counted, on the graph as on the direct path."""
    from galahad_tpu_torch.qp.ipm import IPMControl

    for m in (0, 40):
        sd = graph_equals_direct(dense_qp(100, m, 0, cuda, shifted=True), IPMControl(),
                                 monkeypatch)
        assert sd.status == 0 and sd.run.escalations == sd.iter >= 1


@pytest.mark.parametrize("n", [64, 1000])
def test_cholesky_and_triangular_solves_replay_the_direct_bits(cuda, n):
    """``cholesky_ex`` (cuSOLVER potrf) and ``solve_triangular`` (cuBLAS trsm)
    captured in a CUDA graph, with no synchronisation, replay the direct
    call's bits twice; a failed factorization reports ``ok`` False inside
    the graph."""
    from galahad_tpu_torch.linalg.cholesky import chol_factor_shifted, chol_solve

    rng = np.random.default_rng(n)
    B = rng.normal(size=(n, n))
    M = torch.as_tensor(B @ B.T + n * np.eye(n), device=cuda)
    bad = M.clone()
    bad[3, 3] = -1.0
    b = torch.as_tensor(rng.normal(size=(n, 3)), device=cuda)

    def work(M_, bad_, b_):
        L, _, ok = chol_factor_shifted(M_, 0.0, max_tries=0)
        _, _, ok_bad = chol_factor_shifted(bad_, 0.0, max_tries=0)
        return chol_solve(L, b_), ok, ok_bad

    x_d, ok_d, bad_d = work(M, bad, b)
    sM, sbad, sb = M.clone(), bad.clone(), b.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = work(sM, sbad, sb)
    for _ in range(2):
        out[0].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert same_bits(out[0], x_d)
        assert bool(out[1]) and bool(ok_d) and not bool(out[2]) and not bool(bad_d)


# ---------------------------------------------------------------------------
# The block-tridiagonal kernels and the banded IPM on the card
# ---------------------------------------------------------------------------


def banded_blocks(k, b, dtype, device, seed=0, bad_block=None):
    """(D, L) of a block-tridiagonal SPD matrix; ``bad_block``: make that
    diagonal block negative definite."""
    rng = np.random.default_rng(seed)
    L = rng.uniform(-1.0, 1.0, (k - 1, b, b))
    G = rng.uniform(-1.0, 1.0, (k, b, b))
    D = G @ G.transpose(0, 2, 1) + 3.0 * b * np.eye(b)
    if bad_block is not None:
        D[bad_block] = -D[bad_block]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()   # noqa: E731
    return t(D), t(L)


def banded_plain(D, L, rhs):
    from galahad_tpu_torch.linalg.banded import (block_tridiag_cholesky_plain,
                                                 block_tridiag_solve_plain)

    f = block_tridiag_cholesky_plain(D, L)
    return f, block_tridiag_solve_plain(f, rhs)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("k", [1, 2, 37])
def test_banded_kernels_match_plain(cuda, dtype, tol, b, k):
    """Factor and solve (one right-hand side and three) against the plain
    versions on the same inputs, and a second run bitwise equal."""
    D, L = banded_blocks(k, b, dtype, cuda, seed=b * 100 + k)
    before = banded_kernels.banded_counts()
    Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L)
    assert bool(ok)
    rng = np.random.default_rng(k)
    for shape in ((k, b), (k, b, 3)):
        rhs = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
        x = banded_kernels.block_tridiag_solve(Ld, Lo, rhs)
        f, ref = banded_plain(D, L, rhs)
        for got, want in ((Ld, f.Ld), (Lo, f.Lo), (x, ref)):
            if want.numel():
                err = float((got - want).abs().max())
                assert err <= tol * max(1.0, float(want.abs().max()))
        assert same_bits(banded_kernels.block_tridiag_solve(Ld, Lo, rhs), x)
    Ld2, Lo2, _ = banded_kernels.block_tridiag_factor(D, L)
    assert same_bits(Ld2, Ld) and same_bits(Lo2, Lo)
    after = banded_kernels.banded_counts()
    assert after["factor"] - before["factor"] == 2 and after["solve"] - before["solve"] == 4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("k", [300, 2500])
def test_the_chunked_banded_factor_matches_plain(cuda, dtype, tol, k):
    """The factor kernel in chunks (the default, chunks of 1, 7 and 64 rows,
    one row short of k) against the plain sequential factor, each run twice
    bitwise equal; one chunk of k rows is the sequential chain, the same
    bits whatever chunk >= k is asked for, and so is any chunk at b = 32."""
    from galahad_tpu_torch.linalg.banded import block_tridiag_cholesky_plain

    D, L = banded_blocks(k, 8, dtype, cuda, seed=k)
    f = block_tridiag_cholesky_plain(D, L)
    whole = banded_kernels.block_tridiag_factor(D, L, chunk=k)
    for chunk in (None, 1, 7, 64, k - 1, k, 2 * k):
        before = banded_kernels.banded_counts()
        Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L, chunk=chunk)
        Ld2, Lo2, ok2 = banded_kernels.block_tridiag_factor(D, L, chunk=chunk)
        after = banded_kernels.banded_counts()
        m = banded_kernels.default_factor_chunk(k, 8) if chunk is None else min(chunk, k)
        assert bool(ok) and bool(ok2)
        assert same_bits(Ld, Ld2) and same_bits(Lo, Lo2)
        for got, want in ((Ld, f.Ld), (Lo, f.Lo)):
            assert float((got - want).abs().max()) <= tol * max(1.0, float(want.abs().max()))
        assert after["factor"] - before["factor"] == 2
        assert after["factor_partitioned"] - before["factor_partitioned"] == 2 * (m < k)
        if m == k:
            assert same_bits(Ld, whole[0]) and same_bits(Lo, whole[1])
    # blocks above CHUNKED_MAX_BLOCK run the sequential chain whatever the chunk
    D, L = banded_blocks(40, 32, dtype, cuda, seed=k)
    before = banded_kernels.banded_counts()
    Ld, Lo, _ = banded_kernels.block_tridiag_factor(D, L, chunk=7)
    Ld1, Lo1, _ = banded_kernels.block_tridiag_factor(D, L, chunk=40)
    assert banded_kernels.banded_counts()["factor_partitioned"] == before["factor_partitioned"]
    assert same_bits(Ld, Ld1) and same_bits(Lo, Lo1)
    banded_kernels.banded_check()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_a_failed_pivot_reruns_the_chunked_factor_as_the_chain(cuda, dtype, b):
    """A negative-definite block at P > 1 (chunks of 7 of k = 40: in chunk 0,
    a middle interior, a separator, the last chunk; chunks of one row): ok
    False and the sequential chain's bits (one chunk of k rows), one rerun
    counted for each such launch; an SPD matrix in chunks counts none."""
    k = 40
    for bad, chunk in ((2, 7), (9, 7), (13, 7), (37, 7), (20, 1)):
        D, L = banded_blocks(k, b, dtype, cuda, seed=b, bad_block=bad)
        Ld1, Lo1, ok1 = banded_kernels.block_tridiag_factor(D, L, chunk=k)
        reruns = banded_kernels.banded_factor_reruns()
        Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L, chunk=chunk)
        assert banded_kernels.banded_factor_reruns() == reruns + 1
        assert not bool(ok) and not bool(ok1)
        assert same_bits(Ld, Ld1) and same_bits(Lo, Lo1), (bad, chunk)
    D, L = banded_blocks(k, b, dtype, cuda, seed=b)
    reruns = banded_kernels.banded_factor_reruns()
    assert bool(banded_kernels.block_tridiag_factor(D, L, chunk=7)[2])
    assert banded_kernels.banded_factor_reruns() == reruns


def banded_case_check(D, L, rhs, dtype, tol, chunk=None):
    """Factor and solve against the plain versions (each tensor to ``tol``
    times its own largest |plain value|), the solve twice bitwise equal."""
    Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L)
    assert bool(ok)
    x = banded_kernels.block_tridiag_solve(Ld, Lo, rhs, chunk=chunk)
    f, ref = banded_plain(D, L, rhs)
    for got, want in ((Ld, f.Ld), (Lo, f.Lo), (x, ref)):
        if want.numel():
            err = float((got - want).abs().max())
            assert err <= tol * max(1.0, float(want.abs().max()))
    assert same_bits(banded_kernels.block_tridiag_solve(Ld, Lo, rhs, chunk=chunk), x)
    return Ld, Lo, x


# (k, chunk): one chunk, one chunk + 1 and - 1 row, a ragged last chunk,
# chunks of one row, whole chunks and one row over, the default chunk
BANDED_CHUNKS = [(64, 64), (65, 64), (63, 64), (100, 7), (37, 1), (2, 1), (247, 62), (248, 62),
                 (249, 62), (2500, None)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("b", [1, 3, 8, 32])
@pytest.mark.parametrize("k,chunk", BANDED_CHUNKS)
def test_the_banded_solve_at_chunk_boundaries(cuda, dtype, tol, b, k, chunk):
    """The solve kernel's chunks at and around their boundaries, one
    right-hand side and three, against the plain (sequential) solve."""
    D, L = banded_blocks(k, b, dtype, cuda, seed=7 * k + b)
    rng = np.random.default_rng(k + b)
    for shape in ((k, b), (k, b, 3)):
        rhs = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
        banded_case_check(D, L, rhs, dtype, tol, chunk=chunk)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("b", [3, 5, 12, 27])
def test_banded_kernels_pad_other_block_sizes(cuda, dtype, tol, b):
    """A b that is not a power of two runs in the next one, padded in shared
    memory with the identity: the same factors and solutions as the plain
    versions."""
    D, L = banded_blocks(40, b, dtype, cuda, seed=b)
    rhs = torch.as_tensor(np.random.default_rng(b).normal(size=(40, b, 3)), dtype=dtype,
                          device=cuda)
    banded_case_check(D, L, rhs, dtype, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [2, 8])
def test_banded_kernels_take_unaligned_blocks_bitwise(cuda, dtype, b):
    """Blocks whose address a bulk copy does not take (8 or 4 bytes off 16)
    are copied element by element: the same bits as the aligned call."""
    k = 50
    D, L = banded_blocks(k, b, dtype, cuda, seed=3)
    rhs = torch.as_tensor(np.random.default_rng(3).normal(size=(k, b)), dtype=dtype, device=cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L)
    Ld2, Lo2, ok2 = banded_kernels.block_tridiag_factor(shifted(D), shifted(L))
    assert same_bits(Ld, Ld2) and same_bits(Lo, Lo2) and bool(ok) and bool(ok2)
    x = banded_kernels.block_tridiag_solve(Ld, Lo, rhs)
    assert same_bits(banded_kernels.block_tridiag_solve(shifted(Ld), shifted(Lo), rhs), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 4, 8, 32])
def test_the_banded_factor_kernel_gives_the_identity_for_a_failed_block(cuda, dtype, b):
    D, L = banded_blocks(9, b, dtype, cuda, seed=b, bad_block=2)
    Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L)
    f, _ = banded_plain(D, L, torch.zeros(9, b, dtype=dtype, device=cuda))
    assert not bool(ok) and not bool(f.ok)
    eye = torch.eye(b, dtype=dtype, device=cuda)
    assert torch.equal(Ld[2], eye) and torch.equal(f.Ld[2], eye)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    assert float((Ld - f.Ld).abs().max()) <= tol * max(1.0, float(f.Ld.abs().max()))


def test_the_banded_kernels_refuse_what_they_do_not_take(cuda):
    D, L = banded_blocks(4, 33, torch.float64, cuda)
    with pytest.raises(ValueError, match="1..32"):
        banded_kernels.block_tridiag_factor(D, L)
    D, L = banded_blocks(4, 8, torch.float64, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        banded_kernels.block_tridiag_factor(D.cpu(), L.cpu())
    with pytest.raises(ValueError, match="shape"):
        banded_kernels.block_tridiag_factor(D, L[:2])
    with pytest.raises(TypeError, match="float32/float64"):
        banded_kernels.block_tridiag_factor(D.half(), L.half())
    with pytest.raises(ValueError, match="chunk"):
        banded_kernels.block_tridiag_factor(D, L, chunk=0)
    Ld, Lo, _ = banded_kernels.block_tridiag_factor(D, L)
    with pytest.raises(ValueError, match="contiguous"):
        banded_kernels.block_tridiag_solve(Ld, Lo, torch.zeros(8, 4, dtype=D.dtype,
                                                               device=cuda).T)
    with pytest.raises(ValueError, match="float"):
        banded_kernels.block_tridiag_solve(Ld, Lo, torch.zeros(4, 8, dtype=torch.float32,
                                                               device=cuda))


def banded_qp(n, mode, device):
    """The QPBAND family on the card: "lp" (Schur), "pcg" (banded H, m > 0),
    "m0" (banded H, no constraints)."""
    from galahad_tpu_torch.qp.ipm_banded import make_banded_qp

    r = np.random.default_rng(0)
    m = 0 if mode == "m0" else n - 2
    h = (np.stack([np.full(n, 2.0), np.concatenate([-np.ones(n - 1), [0.0]])])
         if mode != "lp" else None)
    a = np.stack([r.uniform(0.8, 1.2, m), r.uniform(0.8, 1.2, m)]) if m else None
    return make_banded_qp(g=-0.2 - 0.2 * (np.arange(n) % 5), a_val=a, a_offsets=(0, 2),
                          c_l=np.ones(m), c_u=np.full(m, 1e20), x_l=np.zeros(n),
                          x_u=np.full(n, 2.0), h_diags=h, block=8, device=device)


@pytest.mark.parametrize("mode", ["lp", "pcg", "m0"])
def test_the_banded_step_on_the_graph_equals_the_direct_path(cuda, monkeypatch, mode):
    """Each KKT mode captured: the graph path gives the direct path's status,
    iterations and bits (a fetch every iteration, every 4, compiled), and the
    CPU path's status and iterations; the captured step launches both banded
    kernels and no plain banded code."""
    from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve

    qp = banded_qp(200, mode, cuda)
    sd = graph_equals_direct(qp, IPMControl(), monkeypatch)
    assert sd.status == 0
    _, _, _, st = ipm_solve(qp, IPMControl())
    per = st.run.launches_per_replay
    assert per["banded_factor"] >= 1 and per["banded_solve"] >= 1
    assert per["banded_factor_plain"] == per["banded_solve_plain"] == 0
    _, _, _, sc = ipm_solve(banded_qp(200, mode, "cpu"), IPMControl())
    assert (sc.status, sc.iter) == (st.status, st.iter)


def test_a_qpband_request_at_n20000_on_the_graph(cuda, monkeypatch):
    """One request of the benchmark's QPBAND configuration (n = 20,000, the
    PCG mode) on the graph path: the direct path's status, iterations and
    bits, the benchmark's reference within the configuration's limits, and
    per replay two factor launches and 2 (1 + refine) S solves of
    2 + 3 + 2 cg_maxit solve launches each (four G solves around them)."""
    from galahad_tpu_torch.qp.ipm import IPMControl

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import harness, reference

    cell = harness.Cell.load(root, "qpband-20k.pcg")
    cfg = cell.config
    fam = cell.module("families", cfg["family"] + ".py")
    port = cell.module("port", fam.KIND + "_qp.py")
    st = fam.structure(cfg)
    vals = fam.values(cfg, st, harness.request_generator(2 ** 31 + 5, 0, cuda), cuda)
    qp = port.base_problem(st, vals, torch.float64, cuda)
    ctl = IPMControl()
    monkeypatch.setenv("GALAHAD_TPU_FUSED", "0")
    xd, yd, zd, sd = ipm_solve(qp, ctl)
    monkeypatch.setenv("GALAHAD_TPU_FUSED", "1")
    x, y, z, sg = ipm_solve(qp, ctl)
    assert (sd.run.path, sg.run.path) == ("direct", "graph")
    assert (sg.status, sg.iter) == (sd.status, sd.iter)
    assert all(same_bits(a, b) for a, b in ((x, xd), (y, yd), (z, zd)))
    per = sg.run.launches_per_replay
    assert per["banded_factor"] == 2
    assert per["banded_solve"] == 2 * (1 + ctl.refine) * (5 + 2 * qp.cg_maxit)
    assert per["banded_factor_plain"] == per["banded_solve_plain"] == 0
    p = fam.host_problem(st, {k: v.cpu().numpy() for k, v in vals.items()})
    verdict = reference.judge(p, dict(x=x.cpu().numpy(), y=y.cpu().numpy(), z=z.cpu().numpy(),
                                      status=int(sg.status)),
                              {k: float(v) for k, v in cfg["limits"].items()})
    assert verdict["ok"], verdict


# ---------------------------------------------------------------------------
# The trust-region kernels: csrc/tridiag.cu and csrc/secular.cu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (1024, 64), (3, 5, 17), (4, 1), (100_000,)])
def test_tridiag_kernels_match_plain(cuda, shape, dtype):
    """The tridiagonal factor and solve kernels against the plain versions:
    on the card within 1e-13 (f64) / 1e-5 (f32) of the largest value
    (torch's addcmul on CUDA rounds the product before the difference, the
    kernel's fma does not), and on the host, where addcmul is fused as the
    kernel's step, bitwise; a chain of 100,000 by its factor's first 300
    rows and the solve's residual.  The systems are diagonally dominant
    (|d| in [2, 4], |e| < 1), so that the unpivoted recurrence is stable and
    a rounding per step stays a rounding."""
    from galahad_tpu_torch.linalg import cholesky, tridiag_kernels

    g = torch.Generator(device="cuda").manual_seed(0)
    k = shape[-1]
    d = torch.rand(shape, generator=g, device=cuda, dtype=dtype) * 2.0 + 2.0
    d = torch.where(torch.rand(shape, generator=g, device=cuda) < 0.2, -d, d)
    e = torch.rand(shape[:-1] + (k - 1,), generator=g, device=cuda, dtype=dtype) * 2.0 - 1.0
    b = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    tridiag_kernels.reset_tridiag_counts()
    dh, l = cholesky.tridiag_factor(d, e)
    x = cholesky.tridiag_solve(dh, l, b)
    assert tridiag_kernels.tridiag_counts()["factor"] == 1
    assert tridiag_kernels.tridiag_counts()["solve"] == 1
    tol = 1e-13 if dtype == torch.float64 else 1e-5

    def close(got, ref, tol):
        assert float((got - ref).abs().max()) <= tol * max(float(ref.abs().max()), 1e-300)

    if k <= 64:
        pd, pl = cholesky.tridiag_factor_plain(d, e)
        px = cholesky.tridiag_solve_plain(pd, pl, b)
        for got, ref in ((dh, pd), (l, pl), (x, px)):
            if ref.numel():
                close(got, ref, tol)
        hd, hl = cholesky.tridiag_factor_plain(d.cpu(), e.cpu())
        hx = cholesky.tridiag_solve_plain(hd, hl, b.cpu())
        assert torch.equal(dh.cpu(), hd) and torch.equal(l.cpu(), hl) and torch.equal(x.cpu(), hx)
    else:
        hd, hl = cholesky.tridiag_factor_plain(d[:300].cpu(), e[:299].cpu())
        assert torch.equal(dh[:300].cpu(), hd) and torch.equal(l[:299].cpu(), hl)
        r = d * x
        r[1:] += e * x[:-1]
        r[:-1] += e * x[1:]
        assert float((r - b).abs().max()) <= (1e-10 if dtype == torch.float64 else 1e-3)


# (B, k) of the layout cases: k = 1 and 2, B not a multiple of 32, k not a
# multiple of the stage rows (32 batch, 512 chain, 256 chunked), one long system
TRIDIAG_LAYOUT_SHAPES = [(1, 1), (3, 1), (5, 2), (37, 2), (33, 33), (1, 64), (70, 97),
                         (2, 1031), (1, 4099), (40, 3001)]


def tridiag_case(B, k, dtype, offset, seed):
    """(d, e, b) on the card, diagonally dominant (|d| in [2, 4], a fifth of
    them negative; |e| < 1), each a contiguous view into a buffer: with
    ``offset`` at 1, 3 and 2 entries into it, so that rows start off the
    16-byte alignment a bulk copy takes (in f64 d and e by 8 bytes)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(2.0, 4.0, (B, k)) * np.where(rng.random((B, k)) < 0.2, -1.0, 1.0)
    e = rng.uniform(-1.0, 1.0, (B, k - 1))
    b = rng.normal(size=(B, k))

    def place(a, off):
        buf = torch.zeros(a.size + off, dtype=dtype, device="cuda")
        t = buf[off:].view(a.shape)
        t.copy_(torch.as_tensor(a, dtype=dtype))
        return t

    return place(d, offset), place(e, 3 * offset), place(b, 2 * offset)


def tridiag_rel_residual(d, e, b, x) -> float:
    """max |T x - b| / (||T||_inf max |x|), in float64 on the host."""
    d, e, b, x = (t.double().cpu() for t in (d, e, b, x))
    r = d * x - b
    r[:, 1:] += e * x[:, :-1]
    r[:, :-1] += e * x[:, 1:]
    norm = float(d.abs().max()) + (2.0 * float(e.abs().max()) if e.numel() else 0.0)
    return float(r.abs().max()) / (norm * max(float(x.abs().max()), 1e-300))


@pytest.mark.parametrize("B,k", TRIDIAG_LAYOUT_SHAPES)
def test_tridiag_every_layout(cuda, B, k):
    """Both tridiagonal kernels in every layout of tridiag_schedule, f64 and
    f32, inputs aligned and off the 16-byte alignment: the factor (batch and
    chain) bitwise equal to the plain version on the host (the JAX package's
    bits); the batch solve bitwise equal to it; the chunked solve (the
    default chunk and a third of k) bitwise equal to its plain mirror on the
    host (cholesky.py::tridiag_solve_chunked_plain) and within 10 x the
    sequential solve's relative residual + 1e-15; each call twice and on a
    permuted batch, bitwise; one launch per call and no plain call."""
    from galahad_tpu_torch.linalg import cholesky, tridiag_kernels as tk

    perm = torch.randperm(B, generator=torch.Generator().manual_seed(5)).to("cuda")
    for dtype in (torch.float64, torch.float32):
        for offset in (0, 1):
            what = f"B={B} k={k} {dtype} offset={offset}"
            d, e, b = tridiag_case(B, k, dtype, offset, seed=B * 7919 + k)
            hd, hl = cholesky.tridiag_factor_plain(d.cpu(), e.cpu())
            hx = cholesky.tridiag_solve_plain(hd, hl, b.cpu())
            seq = tridiag_rel_residual(d, e, b, hx)
            for layout in tk.FACTOR_LAYOUTS:
                tk.reset_tridiag_counts()
                dh, l = tk.tridiag_factor(d, e, layout=layout)
                assert tk.tridiag_counts() == dict(factor=1, solve=0, factor_plain=0,
                                                   solve_plain=0), what
                assert torch.equal(dh.cpu(), hd) and torch.equal(l.cpu(), hl), (what, layout)
                dh2, l2 = tk.tridiag_factor(d, e, layout=layout)
                assert same_bits(dh2, dh) and same_bits(l2, l), (what, layout)
                dhp, lp = tk.tridiag_factor(d[perm], e[perm], layout=layout)
                assert same_bits(dhp, dh[perm]) and same_bits(lp, l[perm]), (what, layout)
            dh, l = (t.to("cuda") for t in (hd, hl))
            for layout, chunk in (("batch", None), ("chunked", None),
                                  ("chunked", max(1, k // 3))):
                case = (what, layout, chunk)
                tk.reset_tridiag_counts()
                x = tk.tridiag_solve(dh, l, b, layout=layout, chunk=chunk)
                assert tk.tridiag_counts() == dict(factor=0, solve=1, factor_plain=0,
                                                   solve_plain=0), case
                assert same_bits(tk.tridiag_solve(dh, l, b, layout=layout, chunk=chunk), x), case
                xp = tk.tridiag_solve(dh[perm], l[perm], b[perm], layout=layout, chunk=chunk)
                assert same_bits(xp, x[perm]), case
                if layout == "batch":
                    assert torch.equal(x.cpu(), hx), case
                    continue
                m = tk.solve_layout(B, k, dtype, "chunked", chunk)["chunk"]
                mirror = cholesky.tridiag_solve_chunked_plain(hd, hl, b.cpu(), m)
                assert torch.equal(x.cpu(), mirror), case
                res = tridiag_rel_residual(d, e, b, x)
                assert res <= 10 * seq + 1e-15, (case, res, seq)
    tk.tridiag_check()


def secular_data(B, n, dtype, seed=0, hard_every=0):
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(B, n, n))
    H = (H + np.swapaxes(H, 1, 2)) / 2
    c = rng.normal(size=(B, n))
    if hard_every:
        w, Q = np.linalg.eigh(H)
        ct = np.einsum("bij,bi->bj", Q, c)
        ct[::hard_every, 0] = 0.0
        c = np.einsum("bij,bj->bi", Q, ct * 0.01)
    radius = rng.uniform(0.1, 2.0, B)
    return (torch.as_tensor(a, device="cuda").to(dtype) for a in (H, c, radius))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,hard", [(1024, 64, 0), (37, 200, 0), (64, 16, 3), (1, 1, 0)])
def test_secular_kernels_match_plain(cuda, B, n, hard, dtype):
    """Both secular kernels against their plain versions on the card, on
    the eigen-data trs_solve and rqs_solve give them: s within 1e-12 (f64)
    or 1e-5 (f32) relative; and the solvers' results on the card against
    the same calls on the CPU: obj within 1e-10 (f64) / 1e-4 (f32)
    relative, 1e-8 / 1e-2 on the batch of hard and near-hard cases (c cut
    to 0.01 of its size: there obj is a small difference of large terms, a
    change of 1e-16 in H moves it by ~2e-12 on the CPU, cuSOLVER's
    eigenvectors are not LAPACK's, and in f32 the card and the host parted
    by 2.7e-3 on one easy problem of it)."""
    from galahad_tpu_torch.tr import secular_kernels
    from galahad_tpu_torch.tr import trs as T

    H, c, radius = secular_data(B, n, dtype, hard_every=hard)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    lam, ct, _ = T._eigh_M(H, c)
    ct2 = ct * ct
    lam_lo = torch.clamp(-lam.min(-1).values, min=0.0)
    s_k = secular_kernels.trs_secular_newton(lam, ct2, radius, lam_lo, 64)
    s_p = T.secular_newton_plain(lam, ct2, radius, lam_lo, 64)
    assert float(((s_k - s_p).abs() / s_p.abs().clamp(min=1.0)).max()) <= tol
    eps = torch.finfo(dtype).eps
    _, at_min, c_in_min = T._min_eigen(lam, ct, ct2, eps)
    excl = at_min & ~c_in_min[..., None]
    sigma = 1.0 / radius
    hi = lam_lo + sigma ** 0.5 * ct2.sum(-1) ** 0.25 + torch.clamp(lam_lo, min=1.0)
    r_k = secular_kernels.rqs_secular_newton(lam, ct2, excl, sigma, 3.0, lam_lo, hi, 96)
    r_p = T.rqs_newton_plain(lam, ct2, excl, sigma, 3.0, lam_lo, hi, 96)
    # where rqs_solve flags a hard case it takes lam_lo, not s (there s is the
    # end of a bracket with no root, set by roundoff)
    norm_lo = T._rqs_theta(lam, ct2, excl, sigma, 1.0, lam_lo)[1]
    easy = ~(excl.any(-1) & (lam.min(-1).values < 0) & (norm_lo < lam_lo / sigma))
    assert float(((r_k - r_p).abs() / r_p.abs().clamp(min=1.0))[easy].max()) <= tol
    on_card = T.trs_solve(H, c, radius)
    on_host = T.trs_solve(H.cpu(), c.cpu(), radius.cpu())
    assert torch.equal(on_card.hard_case.cpu(), on_host.hard_case)
    obj_tol = (1e-8 if hard else 1e-10) if dtype == torch.float64 else (1e-2 if hard else 1e-4)
    err = (on_card.obj.cpu() - on_host.obj).abs() / on_host.obj.abs().clamp(min=1.0)
    i = int(err.argmax())
    assert float(err[i]) <= obj_tol, (
        f"problem {i}: obj {float(on_card.obj[i])!r} on the card, {float(on_host.obj[i])!r} on "
        f"the host; multiplier {float(on_card.multiplier[i])!r} / "
        f"{float(on_host.multiplier[i])!r}; hard {bool(on_host.hard_case[i])}; lam "
        f"{lam[i].cpu().tolist()[:3]} / {T._eigh_M(H.cpu()[i], c.cpu()[i])[0].tolist()[:3]}")


def secular_eigen_data(B, n, dtype, hard, seed=0):
    """Eigen-data as trs_solve and rqs_solve give it, drawn directly (no
    eigh, so that n may be large): lam sorted N(0, 9), ct = N(0, 1); with
    ``hard`` every third problem has no part of c at its leftmost eigenvalue
    and c is scaled by 0.01 (the hard batch of chip_smoke.py).  Returns lam,
    ct2, the RQS mask, radius, lam_lo = max(-lam_min, 0)."""
    from galahad_tpu_torch.tr import trs as T

    rng = np.random.default_rng(seed)
    lam = np.sort(rng.normal(size=(B, n)) * 3.0, axis=-1)
    ct = rng.normal(size=(B, n))
    if hard:
        ct[::3, 0] = 0.0
        ct *= 0.01
    radius = rng.uniform(0.1, 2.0, B)
    lam, ct, radius = (torch.as_tensor(a, device="cuda").to(dtype) for a in (lam, ct, radius))
    ct2 = ct * ct
    _, at_min, c_in_min = T._min_eigen(lam, ct, ct2, torch.finfo(dtype).eps)
    return lam, ct2, at_min & ~c_in_min[..., None], radius, torch.clamp(-lam[:, 0], min=0.0)


@pytest.mark.parametrize("B,n", [(1, 1), (37, 1), (1024, 8), (37, 16), (1, 64), (1024, 64),
                                 (37, 65), (1, 128), (37, 129), (1024, 200), (1, 1000),
                                 (37, 1000), (1, 20_000)])
def test_secular_kernels_every_layout(cuda, B, n):
    """Both secular kernels against their plain versions on the card in every
    layout of secular_schedule (16 lanes, a warp, a block, a block
    whose entries overflow shared memory at n = 20,000), f32 and f64, easy
    and hard data, RQS at p in {3, 4, 2.5}, caps 1, 2 and 64 (TRS) or 96
    (RQS): s within 1e-12 (f64) / 1e-5 (f32) relative (RQS where rqs_solve
    uses s, not its hard cases); every iteration count between 1 and the cap,
    every RQS growth count between 1 and 60; two runs and a permuted batch
    bitwise equal.  At n = 1 TRS's psi is linear, one step reaches the root
    and the plain version's second step is below an ulp: whether it takes it
    or bisects is decided by the last bit.  There the kernel stops at the
    root, so TRS at n = 1 and the cap 2 is held to the plain version at the
    cap 64 where the bracket holds the root (||x(lam_lo)|| > radius);
    elsewhere both bisect, and it is held at the cap 2."""
    from galahad_tpu_torch.tr import secular_kernels
    from galahad_tpu_torch.tr import trs as T

    perm = torch.randperm(B, generator=torch.Generator().manual_seed(3)).to("cuda")

    def close(got, ref, mask, tol, what):
        err = ((got - ref).abs() / ref.abs().clamp(min=1.0))[mask]
        assert err.numel() == 0 or float(err.max()) <= tol, f"{what}: {float(err.max()):.3e}"

    def same(a, b):
        return torch.equal(a, b) and bool((torch.signbit(a) == torch.signbit(b)).all())

    for dtype in (torch.float64, torch.float32):
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for hard in (False, True):
            lam, ct2, excl, radius, lam_lo = secular_eigen_data(B, n, dtype, hard)
            every = torch.ones(B, dtype=torch.bool, device="cuda")
            for cap in (1, 2, 64):
                what = f"trs {dtype} hard={hard} cap={cap}"
                s, its = secular_kernels.trs_secular_newton(lam, ct2, radius, lam_lo, cap,
                                                            iterations=True)
                ref = T.secular_newton_plain(lam, ct2, radius, lam_lo, cap)
                if n == 1 and cap == 2:
                    root = (ct2 / (lam + lam_lo[:, None]) ** 2).sum(-1).sqrt() > radius
                    ref = torch.where(root, T.secular_newton_plain(
                        lam, ct2, radius, lam_lo, 64), ref)
                close(s, ref, every, tol, what)
                assert int(its.min()) >= 1 and int(its.max()) <= cap, what
                s2, its2 = secular_kernels.trs_secular_newton(lam, ct2, radius, lam_lo, cap,
                                                              iterations=True)
                sp, itsp = secular_kernels.trs_secular_newton(
                    lam[perm], ct2[perm], radius[perm], lam_lo[perm], cap, iterations=True)
                assert same(s, s2) and same(s[perm], sp), what
                assert torch.equal(its, its2) and torch.equal(its[perm], itsp), what
            for p in (3.0, 4.0, 2.5):
                sigma = 1.0 / radius
                pm2 = p - 2.0
                hi = lam_lo + sigma ** (1 / (p - 1)) * ct2.sum(-1) ** (pm2 / (2 * (p - 1))) \
                    + torch.clamp(lam_lo, min=1.0)
                norm_lo = T._rqs_theta(lam, ct2, excl, sigma, pm2, lam_lo)[1]
                easy = ~(excl.any(-1) & (lam[:, 0] < 0) & (norm_lo < (lam_lo / sigma) ** (1 / pm2)))
                for cap in (1, 2, 96):
                    what = f"rqs p={p} {dtype} hard={hard} cap={cap}"
                    s, its, growth = secular_kernels.rqs_secular_newton(
                        lam, ct2, excl, sigma, p, lam_lo, hi, cap, iterations=True)
                    close(s, T.rqs_newton_plain(lam, ct2, excl, sigma, p, lam_lo, hi, cap), easy,
                          tol, what)
                    assert int(its.min()) >= 1 and int(its.max()) <= cap, what
                    assert int(growth.min()) >= 1 and int(growth.max()) <= 60, what
                    sp, itsp, growthp = secular_kernels.rqs_secular_newton(
                        lam[perm], ct2[perm], excl[perm], sigma[perm], p, lam_lo[perm], hi[perm],
                        cap, iterations=True)
                    assert same(s[perm], sp) and torch.equal(its[perm], itsp), what
                    assert torch.equal(growth[perm], growthp), what
                    if dtype == torch.float32 and p == 2.5:
                        assert int(its.min()) == cap, "f32 RQS at p = 2.5 runs to the cap"


@pytest.mark.parametrize("B,n", [(1024, 64), (37, 200), (1, 1000)])
def test_secular_kernels_with_a_pole_in_the_bracket(cuda, B, n):
    """Inputs whose bracket may hold a pole of ||x|| (most problems here do)
    and no root: TRS on the JAX package's stand-in for a hard case (lam + 1,
    ct2 = 1, lam_lo = 1, where lam_min < -2), RQS with lam_lo = 0 below the
    pole at -lam_min.  Both the kernels and the plain loops wander there, and their
    answers differ; the kernels promise a finite s no smaller than lam_lo
    (for TRS no larger than the bracket can grow to, lam_lo + width 2^cap),
    at most ``cap`` iterations and 60 growth evaluations, and the same bits
    in two runs and under a permutation of the batch."""
    from galahad_tpu_torch.tr import secular_kernels

    perm = torch.randperm(B, generator=torch.Generator().manual_seed(4)).to("cuda")
    for dtype in (torch.float64, torch.float32):
        lam, ct2, _, radius, lam_lo = secular_eigen_data(B, n, dtype, False)
        assert bool((lam[:, 0] < -2.0).all())
        lam_t, ct2_t, lo_t = lam + 1.0, torch.ones_like(ct2), torch.ones_like(lam_lo)
        width = torch.sqrt(ct2_t.sum(-1)) / radius + 1.0
        for cap in (1, 2, 64):
            what = f"trs {dtype} cap={cap}"
            s, its = secular_kernels.trs_secular_newton(lam_t, ct2_t, radius, lo_t, cap,
                                                        iterations=True)
            assert bool(torch.isfinite(s).all()) and bool((s >= lo_t).all()), what
            assert bool((s <= lo_t + width * 2.0 ** cap).all()), what
            assert int(its.min()) >= 1 and int(its.max()) <= cap, what
            s2, its2 = secular_kernels.trs_secular_newton(lam_t, ct2_t, radius, lo_t, cap,
                                                          iterations=True)
            sp, itsp = secular_kernels.trs_secular_newton(lam_t[perm], ct2_t[perm], radius[perm],
                                                          lo_t[perm], cap, iterations=True)
            assert torch.equal(s, s2) and torch.equal(s[perm], sp), what
            assert torch.equal(its, its2) and torch.equal(its[perm], itsp), what
        sigma, zero = 1.0 / radius, torch.zeros_like(lam_lo)
        excl = torch.zeros_like(lam, dtype=torch.bool)
        hi = sigma ** 0.5 * ct2.sum(-1) ** 0.25 + 1.0
        for cap in (1, 2, 96):
            what = f"rqs {dtype} cap={cap}"
            s, its, growth = secular_kernels.rqs_secular_newton(lam, ct2, excl, sigma, 3.0, zero,
                                                                hi, cap, iterations=True)
            assert bool(torch.isfinite(s).all()) and bool((s >= 0).all()), what
            assert int(its.min()) >= 1 and int(its.max()) <= cap, what
            assert int(growth.min()) >= 1 and int(growth.max()) <= 60, what
            sp, itsp, growthp = secular_kernels.rqs_secular_newton(
                lam[perm], ct2[perm], excl[perm], sigma[perm], 3.0, zero[perm], hi[perm], cap,
                iterations=True)
            assert torch.equal(s[perm], sp) and torch.equal(its[perm], itsp), what
            assert torch.equal(growth[perm], growthp), what


def test_secular_kernels_ignore_the_batch_position(cuda):
    from galahad_tpu_torch.tr import trs as T

    H, c, radius = secular_data(256, 64, torch.float64)
    perm = torch.randperm(256, generator=torch.Generator().manual_seed(0)).to("cuda")
    a = T.trs_solve(H, c, radius)
    b = T.trs_solve(H[perm], c[perm], radius[perm])
    lam, ct, _ = T._eigh_M(H, c)
    s1 = T._secular_newton(lam, ct * ct, radius, torch.zeros_like(radius), 64)
    s2 = T._secular_newton(lam[perm], (ct * ct)[perm], radius[perm], torch.zeros_like(radius), 64)
    assert torch.equal(s1[perm], s2)
    assert float((a.obj[perm] - b.obj).abs().max()) <= 1e-12 * float(a.obj.abs().max())


def nlp_problems():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    import nlp_problems as P
    return P


@pytest.mark.parametrize("solver", ["tru", "arc"])
def test_nlp_batch_goes_through_the_secular_kernels(cuda, solver):
    """TRU (exact TRS) and ARC (RQS) on a batch of 64 extended-Rosenbrock
    problems of n = 16 on the card: the secular kernel launched once per outer
    iteration for the whole batch, its plain version never; each problem's
    status and iterations those of the CPU run, x within 1e-8."""
    from galahad_tpu_torch import nlp
    from galahad_tpu_torch.tr import secular_kernels

    P = nlp_problems()
    starts = P.random_starts(64, 16, seed=3)
    call = nlp.tru_solve if solver == "tru" else nlp.arc_solve
    secular_kernels.reset_secular_counts()
    st = call(P.ext_rosenbrock, torch.as_tensor(starts, device=cuda))
    counts = secular_kernels.secular_counts()
    key = "trs" if solver == "tru" else "rqs"
    assert counts[key] > 0 and counts[key + "_plain"] == 0, counts
    ref = call(P.ext_rosenbrock, starts, device="cpu")
    assert torch.equal(st.status.cpu(), ref.status) and torch.equal(st.iter.cpu(), ref.iter)
    err = float((st.x.cpu() - ref.x).abs().max()) / max(1.0, float(ref.x.abs().max()))
    assert err <= 1e-8
    it = int(st.iter.max())
    assert st.host_reads == (it + 1 if it < 100 else 100)


def test_nls_sparse_goes_through_the_flat_kernels(cuda):
    """nls_solve_sparse at k = 30 on the card: rows 1a-3 launched, their plain
    code never; the CPU run's status and iterations, f <= 1e-10."""
    from galahad_tpu_torch import COOPattern
    from galahad_tpu_torch.nlp import NLSControl, nls_solve_sparse
    from galahad_tpu_torch.qp.fused import launch_counts

    P = nlp_problems()
    n, m, u, v, a, rows, cols = P.grid_residual_arrays(30)

    def run(device):
        tu, tv, ta = (torch.as_tensor(w, device=device) for w in (u, v, a))
        return nls_solve_sparse(
            lambda x: x[tu] + x[tv] ** 2 - ta,
            lambda x: torch.stack([torch.ones_like(x[tv]), 2.0 * x[tv]]).T.reshape(-1),
            COOPattern(rows, cols, m, n), torch.full((n,), 1.0, dtype=torch.float64,
                                                     device=device), NLSControl(maxit=40))

    ldlt_kernels.reset_launch_count()
    sweep_kernels.reset_sweep_counts()
    ea_kernels.reset_ea_counts()
    st = run(cuda)
    c = launch_counts()
    assert all(c[k] > 0 for k in ("partial_ldlt", "sweep_fwd", "sweep_bwd")), c
    assert all(c[k] == 0 for k in ("ldlt_wide_plain", "extend_add_plain", "sweep_plain")), c
    ref = run("cpu")
    assert (int(st.status), int(st.iter)) == (int(ref.status), int(ref.iter)) and int(st.status) == 0
    assert float(st.f) <= 1e-10


def test_lms_apply_on_the_card_is_repeatable(cuda):
    """An L-BFGS and an L-SR1 operator on the card (n = 99,856, memory 10,
    the ring wrapped): two applies bitwise equal, within 1e-10 of the CPU's."""
    from galahad_tpu_torch import qn

    n = 99_856
    rng = np.random.default_rng(5)
    d = torch.as_tensor(rng.uniform(1.0, 3.0, n))
    for method in ("bfgs", "sr1"):
        dc = qn.lms_setup(n, qn.LMSControl(memory=10, method=method), device="cpu")
        dg = qn.lms_setup(n, qn.LMSControl(memory=10, method=method), device=cuda)
        for _ in range(13):
            s = torch.as_tensor(rng.normal(size=n))
            y = d * s + 0.01 * torch.as_tensor(rng.normal(size=n))
            dc = qn.lms_update(dc, s, y)
            dg = qn.lms_update(dg, s.to(cuda), y.to(cuda))
        v = torch.as_tensor(rng.normal(size=n))
        op = qn.lms_operator(dg, shift=0.5)
        w1, w2 = op(v.to(cuda)), qn.lms_apply(dg, v.to(cuda), shift=0.5)
        assert torch.equal(w1, w2), method
        ref = qn.lms_apply(dc, v, shift=0.5)
        assert float((w1.cpu() - ref).abs().max()) <= 1e-10 * float(ref.abs().max()), method
        if method == "bfgs":
            i1, i2 = qn.lms_apply_inverse(dg, v.to(cuda)), qn.lms_apply_inverse(dg, v.to(cuda))
            assert torch.equal(i1, i2)


def constrained_problems():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    import constrained_problems as CP
    import sif_problems as S
    return CP, S


def test_bgo_batch_goes_through_the_secular_kernel(cuda):
    """BGO's multistart on the card: 64 Latin-hypercube starts on the camel
    function as one batched TRB, the secular kernel launched once per pass
    for the whole batch, its plain version never; the CPU run's best point;
    every start's first pass (status, iterations, x within 1e-8) and final
    status.  Later a few starts' trajectories part by roundoff (TRB's Cauchy
    boundary test, CUDA's fused multiply-adds in its reductions); those end
    converged on both devices."""
    from galahad_tpu_torch import go
    from galahad_tpu_torch.go.bgo import _multistart
    from galahad_tpu_torch.nlp import TRBControl, trb_solve
    from galahad_tpu_torch.tr import secular_kernels

    CP, _ = constrained_problems()
    lo, hi = np.array([-3.0, -2.0]), np.array([3.0, 2.0])
    S = go.lhs_sample_box(0, 64, lo, hi, device="cpu")
    ctl = go.BGOControl(attempts=64)
    secular_kernels.reset_secular_counts()
    best = _multistart(CP.camel6, S.to(cuda), torch.as_tensor(lo, device=cuda),
                       torch.as_tensor(hi, device=cuda), ctl)
    counts = secular_kernels.secular_counts()
    assert counts["trs"] > 0 and counts["trs_plain"] == 0, counts
    tctl = TRBControl(maxit=ctl.maxit_local, stop_g_absolute=ctl.stop_g_absolute)
    st = trb_solve(CP.camel6, S.to(cuda), lo, hi, tctl)
    ref = trb_solve(CP.camel6, S, lo, hi, tctl)
    assert torch.equal(st.status.cpu(), ref.status) and bool((ref.status == 0).all())
    one = trb_solve(CP.camel6, S.to(cuda), lo, hi, dataclasses.replace(tctl, maxit=1))
    one_ref = trb_solve(CP.camel6, S, lo, hi, dataclasses.replace(tctl, maxit=1))
    assert torch.equal(one.status.cpu(), one_ref.status) and torch.equal(one.iter.cpu(),
                                                                          one_ref.iter)
    assert float((one.x.cpu() - one_ref.x).abs().max()) <= 1e-8 * max(1.0, float(
        one_ref.x.abs().max()))
    assert abs(float(best.f) + 1.0316284534898774) <= 1e-12


def test_dgo_and_ugo_read_nothing_on_the_card(cuda):
    """DGO on Hartmann-6 over [0, 1]^6 (200 splits) and UGO on the card: no
    synchronising call in DGO's box splits or in UGO (CUDA's sync debug mode
    set to error), boxes, f and x (1e-10) of the CPU runs, two DGO runs
    bitwise."""
    from galahad_tpu_torch import go
    from galahad_tpu_torch.go.dgo import dgo_boxes

    _, S = constrained_problems()
    ctl = go.DGOControl(maxit=200)
    f_card = S.hartmann6(torch, cuda)
    lo, hi = torch.zeros(6, dtype=torch.float64, device=cuda), torch.ones(6, dtype=torch.float64,
                                                                          device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dgo_boxes(f_card, lo, hi, ctl)
        u = go.ugo_solve(lambda x: torch.sin(x) + torch.sin(10.0 * x / 3.0), 2.7, 7.5,
                         device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    uc = go.ugo_solve(lambda x: torch.sin(x) + torch.sin(10.0 * x / 3.0), 2.7, 7.5, device="cpu")
    assert abs(float(u.x) - float(uc.x)) <= 1e-10
    a = go.dgo_solve(f_card, lo, hi, ctl)
    b = go.dgo_solve(f_card, lo, hi, ctl)
    ref = go.dgo_solve(S.hartmann6(torch), np.zeros(6), np.ones(6), ctl, device="cpu")
    assert torch.equal(a.x, b.x) and torch.equal(a.f, b.f)
    assert int(a.boxes) == int(ref.boxes) == 401
    assert float((a.x.cpu() - ref.x).abs().max()) <= 1e-10
    assert abs(float(a.f) - float(ref.f)) <= 1e-10 * abs(float(ref.f))


def test_lancelot_hvp_path_on_the_card(cuda):
    """LANCELOT at n = 400 (the Hessian-vector product model: GLTR, whose
    boundary solve is the secular kernel): the CPU run's status, outer
    iterations and x (1e-8); the kernel launched, its plain version never."""
    from galahad_tpu_torch import nlp
    from galahad_tpu_torch.tr import secular_kernels

    CP, _ = constrained_problems()
    n = 400
    args = (CP.chain_objective, CP.chain_constraint(n))
    secular_kernels.reset_secular_counts()
    st = nlp.lancelot_solve(*args, torch.full((n,), 0.5, dtype=torch.float64, device=cuda),
                            np.zeros(1), np.zeros(1), ctl=nlp.LancelotControl(maxit=20))
    counts = secular_kernels.secular_counts()
    assert counts["trs"] > 0 and counts["trs_plain"] == 0, counts
    ref = nlp.lancelot_solve(*args, np.full(n, 0.5), np.zeros(1), np.zeros(1),
                             ctl=nlp.LancelotControl(maxit=20), device="cpu")
    assert (int(st.status), int(st.iter)) == (int(ref.status), int(ref.iter)) == (0, int(ref.iter))
    assert float((st.x.cpu() - ref.x).abs().max()) <= 1e-8


# ---------------------------------------------------------------------------
# The inline supernodal LDL^T, SLS "pbtr", PSLS's band preconditioner, TRS's e_1
# ---------------------------------------------------------------------------


def test_trs_from_eigen_reads_nothing_on_the_card(cuda):
    """``trs_solve`` on the card with CUDA's sync debug mode set to error
    everywhere but the eigendecomposition: no host copy (e_1 is made on the
    device); the result is the CPU run's (1e-12; x where the problem is not a
    hard case, where it is defined up to the eigenvector's sign) and two runs
    are bitwise."""
    from galahad_tpu_torch.tr import trs as TR

    r = np.random.default_rng(0)
    B = r.normal(size=(64, 12, 12))
    H = torch.as_tensor((B + B.transpose(0, 2, 1)) / 2, device=cuda)
    c = torch.as_tensor(r.normal(size=(64, 12)), device=cuda)
    c[::4] = 0.0                                  # hard cases among them
    radius = torch.full((64,), 1.5, dtype=torch.float64, device=cuda)
    ctl = TR.TRSControl()

    def run():
        lam, ct, back = TR._eigh_M(H, c, None)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return TR._trs_from_eigen(lam, ct, radius, back, ctl)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    a, b = run(), run()
    ref = TR.trs_solve(H.cpu(), c.cpu(), radius.cpu())
    assert torch.equal(a.x, b.x) and torch.equal(a.obj, b.obj)
    assert torch.equal(a.hard_case.cpu(), ref.hard_case) and bool(ref.hard_case.any())
    easy = ~ref.hard_case
    for got, want in ((a.x.cpu()[easy], ref.x[easy]), (a.obj.cpu(), ref.obj),
                      (a.multiplier.cpu(), ref.multiplier)):
        assert float((got - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("Fpad", [8, 24, 40, 64, 72, 104, 128, 136, 200])
def test_inline_padded_level_matches_plain_on_the_unpadded_fronts(cuda, Fpad):
    """A group of the inline LDL^T as ``supernodal_factorize`` lays it out: fronts
    of Fpad (a multiple of 8) padded with zeros to the kernel's size (the next
    of 8..128, or Fpad rounded up to 32 for the wide route), factored by the
    kernel; its leading Fpad block against ``partial_ldlt_plain`` on the
    unpadded fronts (TOL x max |plain|, float64)."""
    from galahad_tpu_torch.linalg import supernodal as S

    nb = 7
    F, ncols = fronts(nb, Fpad, torch.float64, cuda, seed=Fpad)
    K = S.kernel_size(Fpad)
    buf = torch.zeros(nb * K * K + 1, dtype=torch.float64, device=cuda)
    P = buf[:nb * K * K].view(nb, K, K)
    P[:, :Fpad, :Fpad] = F
    if Fpad <= ldlt_kernels.MAX_KERNEL_FRONT:
        n0 = ldlt_kernels.launch_count()
        ldlt_kernels.partial_ldlt(P, ncols, inplace=True)
        assert ldlt_kernels.launch_count() == n0 + 1
    else:
        n0, p0 = ldlt_kernels.wide_launch_count(), ldlt_kernels.wide_plain_count()
        lvl = ldlt_kernels.build_wide_level(
            [(i * K * K, K, int(ncols[i]), Fpad) for i in range(nb)], cuda)
        ldlt_kernels.partial_ldlt_wide(buf, lvl)
        assert ldlt_kernels.wide_launch_count() == n0 + 1
        assert ldlt_kernels.wide_plain_count() == p0
    ref = ldlt_kernels.partial_ldlt_plain(F, ncols)
    r = torch.arange(Fpad, device=cuda)
    nc = ncols.long()[:, None, None]
    spec = (((r[None, None, :] < nc) & (r[None, :, None] >= r[None, None, :]))
            | ((r[None, :, None] >= nc) & (r[None, None, :] >= nc)))
    err = torch.where(spec, P[:, :Fpad, :Fpad] - ref, 0.0).abs().max()
    assert float(err) <= 1e-11 * max(1.0, float(ref.abs().max()))
    if K > Fpad:                 # the padded rows stay zero
        assert not bool(P[:, Fpad:, :].any())


def inline_kkt(k, device):
    """The KKT matrix of the grid QP at k (lower COO) with D_x = 0.1,
    C = 0.1, as the inline tests factor it."""
    from galahad_tpu_torch.linalg import supernodal as S

    q = grid_qp(k, "cpu")
    n, m = q.n, q.m
    h, a = q.h_pat, q.a_pat
    rows = np.concatenate([h.rows, a.rows + n, np.arange(n), n + np.arange(m)])
    cols = np.concatenate([h.cols, a.cols, np.arange(n), n + np.arange(m)])
    vals = torch.cat([q.h_vals, q.a_vals, torch.full((n,), 0.1, dtype=torch.float64),
                      torch.full((m,), -0.1, dtype=torch.float64)])
    sym = S.supernodal_analyse(rows, cols, n + m)
    return sym, vals.to(device), (n, m)


def test_inline_factorize_on_the_card_is_bitwise_repeatable(cuda):
    """The inline LDL^T on the card (grid QP k = 40: small groups and one wide
    group): two runs bitwise equal, the small and wide kernels launched once
    per group of their route and no plain code, the inertia (n, m, 0), and the
    solve within 1e-10 of the CPU path's."""
    from galahad_tpu_torch.linalg import supernodal as S

    sym, vals, (n, m) = inline_kkt(40, cuda)
    routes = [S.kernel_size(p.Fpad) > ldlt_kernels.MAX_KERNEL_FRONT for p in sym.levels]
    assert any(routes) and not all(routes)
    ldlt_kernels.reset_launch_count()
    p0 = ldlt_kernels.wide_plain_count()
    f1 = S.supernodal_factorize(sym, vals)
    assert ldlt_kernels.launch_count() == routes.count(False)
    assert ldlt_kernels.wide_launch_count() == routes.count(True)
    assert ldlt_kernels.wide_plain_count() == p0
    f2 = S.supernodal_factorize(sym, vals)
    assert all(torch.equal(a, b) for a, b in zip(f1.levels, f2.levels))
    assert f1.inertia.tolist() == [n, m, 0]
    b = torch.as_tensor(np.random.default_rng(1).normal(size=n + m), device=cuda)
    x1, x2 = S.supernodal_solve(sym, f1, b), S.supernodal_solve(sym, f2, b)
    assert torch.equal(x1, x2)
    fc = S.supernodal_factorize(sym, vals.cpu())
    xc = S.supernodal_solve(sym, fc, b.cpu())
    assert float((x1.cpu() - xc).abs().max()) <= 1e-10 * max(1.0, float(xc.abs().max()))


def test_sls_pbtr_on_the_card_runs_the_banded_kernels(cuda):
    """SLS "pbtr" (rows 4a/4b): the CPU path's solve (1e-11), one factor and
    one solve launch, no plain call."""
    from galahad_tpu_torch.linalg.sls import SLSControl, sls_factorize

    r = np.random.default_rng(2)
    k, b = 300, 8
    G = r.normal(size=(k, b, b))
    D = G @ G.transpose(0, 2, 1) + 3 * b * np.eye(b)
    L = r.normal(size=(k - 1, b, b))
    rhs = r.normal(size=(k, b))
    banded_kernels.reset_banded_counts()
    f = sls_factorize((D, L), SLSControl(solver="pbtr"), device=cuda)
    x = f.solve(torch.as_tensor(rhs, device=cuda))
    counts = banded_kernels.banded_counts()
    assert counts["factor"] == 1 and counts["solve"] == 1, counts
    assert counts["factor_plain"] == 0 and counts["solve_plain"] == 0, counts
    ref = sls_factorize((D, L), SLSControl(solver="pbtr"), device="cpu").solve(
        torch.as_tensor(rhs))
    assert float((x.cpu() - ref).abs().max()) <= 1e-11 * max(1.0, float(ref.abs().max()))


def test_psls_band_on_the_card_matches_its_plain_version(cuda):
    """PSLS "band" and "reordered_band" at the default semi-bandwidth 5 (blocks
    of 5, rows 4a/4b): the CPU path's apply (1e-11); two factor and two solve
    launches per build and apply, no plain call."""
    from galahad_tpu_torch.linalg.psls import PSLSControl, psls_build

    r = np.random.default_rng(3)
    n = 400
    B = r.normal(size=(n, n)) * (np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 7)
    H = B @ B.T + n * np.eye(n)
    v = r.normal(size=n)
    for kind in ("band", "reordered_band"):
        banded_kernels.reset_banded_counts()
        apply = psls_build(torch.as_tensor(H, device=cuda), PSLSControl(preconditioner=kind))
        w = apply(torch.as_tensor(v, device=cuda))
        counts = banded_kernels.banded_counts()
        assert counts["factor"] == 2 and counts["solve"] == 2, (kind, counts)
        assert counts["factor_plain"] == 0 and counts["solve_plain"] == 0, (kind, counts)
        ref = psls_build(H, PSLSControl(preconditioner=kind), device="cpu")(torch.as_tensor(v))
        assert float((w.cpu() - ref).abs().max()) <= 1e-11 * max(1.0, float(ref.abs().max()))


# ---------------------------------------------------------------------------
# The multi-device layer with its slots on the one card, and the C interface
# ---------------------------------------------------------------------------


def _stacked(arrays):
    return {k: np.stack([a[k] for a in arrays]) for k in arrays[0] if k != "h_kind"}


@pytest.mark.parametrize("singular", [False, True], ids=["plain", "escalating"])
def test_batched_ipm_on_the_card_matches_each_single_solve(cuda, singular):
    """``ipm_solve_compiled`` of a stack on the card: one captured vmapped
    step, every problem the status and iterations of its single solve, x
    within 1e-8; with a free variable on a zero row of H and a zero column of
    A in every other problem, the flagged problems' steps taken again with the
    masked shift (escalations counted) and the others untouched."""
    from galahad_tpu_torch import make_qp
    from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve_compiled

    from _torch_port_helpers import random_convex_qp_arrays

    arrays = [random_convex_qp_arrays(24, 10, 40 + s) for s in range(8)]
    if singular:
        for a in arrays[::2]:
            a["H"][0, :] = a["H"][:, 0] = 0.0
            a["A"][:, 0] = 0.0
            a["x_l"][0], a["x_u"][0], a["g"][0] = -1e20, 1e20, 0.0
    ctl = IPMControl(maxit=80)
    xs, _, _, st = ipm_solve_compiled(make_qp(**_stacked(arrays), device=cuda), ctl)
    assert st.run.path == "graph" and st.run.replays > 0
    assert (st.run.escalations > 0) == singular
    for i, a in enumerate(arrays):
        x, _, _, one = ipm_solve_compiled(make_qp(**a, device=cuda), ctl)
        assert (int(st.status[i]), int(st.iter[i])) == (one.status, one.iter), i
        assert float((xs[i] - x).abs().max()) <= 1e-8 * max(1.0, float(x.abs().max())), i


def test_mesh_layer_on_one_card_matches_the_cpu(cuda):
    """``batch_ipm_solve`` over four slots of cuda:0, ``model_sharded_step``
    and ``block_angular_solve`` against the same calls on eight CPU slots."""
    from galahad_tpu_torch.parallel import (batch_ipm_solve, block_angular_solve, make_mesh,
                                            model_sharded_step)
    from galahad_tpu_torch.qp.ipm import TENSOR_FIELDS, IPMControl

    from _torch_port_helpers import random_convex_qp_arrays

    card, cpu = make_mesh(devices=[cuda] * 4), make_mesh(devices=["cpu"] * 8)
    s = _stacked([random_convex_qp_arrays(16, 6, 7 + i) for i in range(8)])
    cols = [s[k] for k in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u")]
    xg, _, _, sg = batch_ipm_solve(*cols, ctl=IPMControl(), mesh=card)
    xc, _, _, sc = batch_ipm_solve(*cols, ctl=IPMControl(), mesh=cpu)
    assert sg.iter.tolist() == sc.iter.tolist() and sg.status.tolist() == [0] * 8
    assert all(r.path == "graph" for r in sg.run)
    assert float((xg.cpu() - xc).abs().max()) <= 1e-8

    a = random_convex_qp_arrays(64, 24, 3)
    args = tuple(a[k] for k in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u"))
    stg = model_sharded_step(args, make_mesh(devices=[cuda] * 4, batch=1))
    stc = model_sharded_step(args, make_mesh(devices=["cpu"] * 8, batch=1))
    for f in TENSOR_FIELDS:
        ref = getattr(stc, f).double()
        err = float((getattr(stg, f).double().cpu() - ref).abs().max())
        assert err <= 1e-12 * max(1.0, float(ref.abs().max())), f

    r = np.random.default_rng(1)
    K, n, m = 16, 12, 5
    Bs = r.normal(size=(K, n, n))
    G = Bs @ np.swapaxes(Bs, -1, -2) + 4 * np.eye(n)
    arrays = (G, r.normal(size=(K, m, n)), r.normal(size=(K, n)), np.eye(m), r.normal(size=m))
    xg, yg = block_angular_solve(card, *(torch.as_tensor(v, device=cuda) for v in arrays))
    xc, yc = block_angular_solve(cpu, *(torch.as_tensor(v) for v in arrays))
    assert float((xg.cpu() - xc).abs().max()) <= 1e-10
    assert float((yg.cpu() - yc).abs().max()) <= 1e-10


def test_sharded_kkt_solve_on_the_card_replays_one_graph_per_strip(cuda):
    """The strip grid on four slots of cuda:0: the CPU run's x within 1e-12,
    two runs bitwise, each strip's column solves replays of one captured
    solve, rows 1a-3 launched and no plain call."""
    from galahad_tpu_torch.parallel import make_mesh
    from galahad_tpu_torch.parallel.supernodal_mesh import (build_strip_grid_kkt,
                                                            sharded_kkt_residual,
                                                            sharded_kkt_solve)
    from galahad_tpu_torch.qp.fused import launch_counts

    plan, parts = build_strip_grid_kkt(4, 5, 12)
    args = (parts["vals"], parts["B"], parts["Kss"], parts["b"], parts["bs"])
    xc, sc = sharded_kkt_solve(make_mesh(devices=["cpu"] * 4), plan, *args)
    mesh = make_mesh(devices=[cuda] * 4)
    before = launch_counts()
    stats = {}
    xg, sg = sharded_kkt_solve(mesh, plan, *args, stats=stats)
    after = launch_counts()
    assert stats["replays"] == 4 * (parts["ns"] + 2)
    for k in ("partial_ldlt", "extend_add", "sweep_fwd", "sweep_bwd"):
        assert after[k] > before[k], k
    for k in ("ldlt_wide_plain", "extend_add_plain", "sweep_plain"):
        assert after[k] == before[k], k
    assert sharded_kkt_residual(parts, xg, sg) < 1e-10
    assert float((xg.cpu() - xc).abs().max()) <= 1e-12
    assert float((sg.cpu() - sc).abs().max()) <= 1e-12
    xg2, sg2 = sharded_kkt_solve(mesh, plan, *args)
    assert torch.equal(xg, xg2) and torch.equal(sg, sg2)


def test_c_interface_on_the_card_matches_its_cpu_run(cuda, tmp_path):
    """tests/test_torch_capi.py's C program with every entry, run on the card
    (no GALAHAD_TPU_TORCH_DEVICE) and on the CPU: every printed number within
    1e-10 (relative to max(1, |value|))."""
    import shutil

    from test_torch_capi import C_FULL, _parse, _run_c

    from galahad_tpu_torch.interfaces.c.build import build_capi

    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    lib = build_capi()
    card = _run_c(tmp_path, lib, C_FULL, "full_card", device=None)
    host = _run_c(tmp_path, lib, C_FULL, "full_cpu", device="cpu")
    assert card.returncode == 0 and host.returncode == 0, (card.stderr[-1500:], host.stderr[-1500:])
    got, ref = _parse(card.stdout), _parse(host.stdout)
    assert sorted(got) == sorted(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert np.all(np.abs(g - r) <= 1e-10 * np.maximum(1.0, np.abs(r))), (k, g, r)
