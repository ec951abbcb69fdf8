"""The level-wise triangular sweeps of the port's flat solve
(galahad_tpu_torch/linalg/sweep_kernels.py), as far as the CPU can run them:
the plain PyTorch versions that the CUDA kernels of csrc/sweep.cu are held
against on the card, and the tables both read.

* the level-wise plain sweeps against the per-chunk sweeps they replaced in
  ``flat_solve`` (kept below, verbatim, as the oracle).  Tolerance 1e-13
  relative in float64: the two differ only in the order of the struct-row
  sums (per level here, per chunk and then across chunks there) and of the
  dot products inside a front;
* ``flat_solve`` against the JAX package's ``flat_solve`` on the SAME factor
  store (the JAX package's), so that only the sweeps differ: 1e-12 relative in
  float64, 1e-4 in float32 (the two sum the same products in other orders);
* synthetic levels of every ladder size against a dense numpy solve per
  front, with NaN in every entry of a front that is not L or d: the sweeps
  mask by ``ncols`` and the front's real rows, and no result depends on the
  Schur block, the upper triangle or the padded rows;
* the item tables, bitwise repeatability, the operand checks, no fallback for
  a tensor that is not on the CPU, and the bound function.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from galahad_tpu.linalg import supernodal_flat as J

from galahad_tpu_torch._device import tiny16
from galahad_tpu_torch.core.segsum import SegmentSum
from galahad_tpu_torch.linalg import supernodal_flat as T
from galahad_tpu_torch.linalg import sweep_kernels as K

from _torch_port_helpers import grid_laplacian, grid_qp_arrays

# ---------------------------------------------------------------------------
# The per-chunk sweeps that flat_solve ran before the level-wise kernels,
# verbatim, with the chunk tables they read: the oracle.
# ---------------------------------------------------------------------------


def oracle_chunks(plan):
    """The per-chunk index tensors of the old sweeps (CPU), in plan order."""
    n = plan.n
    t64 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int64))
    by_level = {}
    for g in plan.groups:
        by_level.setdefault(g.level, []).append(g)
    chunks = []
    for lv in sorted(by_level):
        for g in by_level[lv]:
            Fd = g.Fpad
            B = min(32, Fd)
            for off, ch in T._chunks_of(g.nb, Fd):
                nco = np.asarray(g.ncols[off:off + ch], np.int64)
                fr = np.where(g.frows[off:off + ch] < n, g.frows[off:off + ch], n)
                nf = (fr < n).sum(axis=1)
                pos = np.arange(Fd)[None, :]
                elim = pos < nco[:, None]
                struct = (~elim) & (pos < nf[:, None])
                elim_pos = np.flatnonzero(elim.ravel())
                struct_pos = np.flatnonzero(struct.ravel())
                cmax = int(nco.max(initial=0))
                chunks.append(dict(
                    goff=int(g.goff + off * Fd * Fd), ch=ch, Fpad=Fd, B=B,
                    nblocks=-(-cmax // B),
                    ncols=torch.as_tensor(nco.astype(np.int32)),
                    frows=t64(fr), elim_pos=t64(elim_pos),
                    elim_rows=t64(fr.ravel()[elim_pos]), struct_pos=t64(struct_pos),
                    upd=SegmentSum(fr.ravel()[struct_pos], n + 1, dense=False)))
    return chunks


def _chunk_L(store, c):
    ch, Fp, B = c["ch"], c["Fpad"], c["B"]
    F = store[c["goff"]:c["goff"] + ch * Fp * Fp].view(ch, Fp, Fp)
    ncB = min(c["nblocks"] * B, Fp)
    elim = (torch.arange(ncB, device=store.device)[None, :]
            < c["ncols"][:, None])
    Ls = torch.where(elim[:, None, :], F[:, :, :ncB], 0.0)
    return F, Ls, elim, ncB


def _fwd_one(store, y, c) -> None:
    B, nblocks = c["B"], c["nblocks"]
    if nblocks == 0:
        return
    F, Ls, elim, ncB = _chunk_L(store, c)
    tiny = tiny16(store.dtype)
    dvec = torch.diagonal(F, dim1=1, dim2=2)[:, :ncB]
    dsafe = torch.where(elim & (dvec.abs() > tiny), dvec, 1.0)
    yF0 = y.index_select(0, c["frows"].reshape(-1)).view(c["ch"], c["Fpad"])
    yF = yF0.clone()
    for bi in range(nblocks):
        bs, be = bi * B, bi * B + B
        y1 = torch.linalg.solve_triangular(
            Ls[:, bs:be, bs:be], yF[:, bs:be, None], upper=False,
            unitriangular=True)
        if be < c["Fpad"]:
            yF[:, be:] -= (Ls[:, be:, bs:be] @ y1)[..., 0]
        yF[:, bs:be] = y1[..., 0]
    yF[:, :ncB] = torch.where(elim, yF[:, :ncB] / dsafe, yF[:, :ncB])
    upd = c["upd"]
    if upd.nnz:
        delta = (yF - yF0).reshape(-1).index_select(0, c["struct_pos"])
        y.index_add_(0, upd.index_on(y.device), upd(delta))
    y.index_copy_(0, c["elim_rows"],
                  yF.reshape(-1).index_select(0, c["elim_pos"]))


def _bwd_one(store, y, c) -> None:
    B, nblocks = c["B"], c["nblocks"]
    if nblocks == 0:
        return
    F, Ls, elim, ncB = _chunk_L(store, c)
    yF = y.index_select(0, c["frows"].reshape(-1)).view(c["ch"], c["Fpad"])
    for k2 in range(nblocks):
        bs = (nblocks - 1 - k2) * B
        be = bs + B
        rhs = yF[:, bs:be, None]
        if be < c["Fpad"]:
            rhs = rhs - Ls[:, be:, bs:be].transpose(-1, -2) @ yF[:, be:, None]
        x1 = torch.linalg.solve_triangular(
            Ls[:, bs:be, bs:be].transpose(-1, -2), rhs, upper=True,
            unitriangular=True)
        yF[:, bs:be] = x1[..., 0]
    y.index_copy_(0, c["elim_rows"],
                  yF.reshape(-1).index_select(0, c["elim_pos"]))


def oracle_solve(plan, fac, b):
    """The old ``flat_solve``: a loop over all chunks forward, then backward.
    Also returns y after the forward pass."""
    dev = T._device_plan(plan, b.device)
    chunks = oracle_chunks(plan)
    y = torch.zeros(plan.n + 1, dtype=b.dtype)
    y[:plan.n] = b.index_select(0, dev["perm"])
    for c in chunks:
        _fwd_one(fac.store, y, c)
    y_fwd = y.clone()
    for c in reversed(chunks):
        _bwd_one(fac.store, y, c)
    return y[:plan.n].index_select(0, dev["iperm"]), y_fwd


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------


def grid_kkt(k):
    """KKT matrix [[H + I, A^T], [A, -I]] of the flagship family at size k."""
    n, m, kw = grid_qp_arrays(k)
    hi, hj, hv = kw["h_coo"]
    ai, aj, av = kw["a_coo"]
    H = sp.coo_matrix((hv, (hi, hj)), shape=(n, n)).tocsr()
    H = H + sp.tril(H, -1).T + sp.eye(n)
    A = sp.coo_matrix((av, (ai, aj)), shape=(m, n)).tocsr()
    return sp.bmat([[H, A.T], [A, -sp.eye(m)]]).tocsr()


def wide_block():
    """A dense 160 x 160 block hanging off a chain: in the natural order its
    front is padded to 192 > 128."""
    rng = np.random.default_rng(11)
    n, nd = 200, 160
    A = np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1) \
        + np.diag(np.full(n - 1, -1.0), -1)
    B = rng.normal(size=(nd, nd)) / np.sqrt(nd)
    A[n - nd:, n - nd:] += B @ B.T + np.eye(nd)
    return sp.csr_matrix(A)


def quasi_definite(n=40, m=15, delta=1e-2):
    G = sp.random(n, n, density=0.12, random_state=1)
    G = (G @ G.T).tocsr() + sp.eye(n) * 2.0
    A = sp.random(m, n, density=0.2, random_state=2).tocsr()
    return sp.bmat([[G, A.T], [A, -delta * sp.eye(m)]]).tocsr()


CASES = {
    "grid_kkt12": (lambda: grid_kkt(12), dict(order="amd", relax_cols=4)),
    "grid_kkt20": (lambda: grid_kkt(20), dict(order="amd", relax_cols=16)),
    "wide_front": (wide_block, dict(order="natural", relax_cols=4)),
    "quasi_definite": (quasi_definite, dict(order="amd", relax_cols=4)),
    "grid_laplacian_nd": (lambda: grid_laplacian(14), dict(order="nd", relax_cols=8)),
}


def scratch(store, lvl):
    """The scratch a sweep over ``lvl`` needs, filled with NaN: a result that
    read an entry no kernel wrote would show it."""
    return torch.full((lvl.work_size,), float("nan"), dtype=store.dtype,
                      device=store.device)


def analysed(case):
    make, kw = CASES[case]
    A = sp.csr_matrix(make())
    Al = sp.tril(A).tocoo()
    return A, Al, T.flat_analyse(Al.row, Al.col, A.shape[0], **kw)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_levelwise_plain_sweeps_match_the_per_chunk_oracle(case):
    A, Al, plan = analysed(case)
    fac = T.flat_factorize(plan, torch.as_tensor(Al.data))
    b = torch.as_tensor(np.random.default_rng(1).normal(size=plan.n))
    x_ref, yf_ref = oracle_solve(plan, fac, b)
    dev = T._device_plan(plan, b.device)
    y = torch.zeros(plan.n + 1, dtype=b.dtype)
    y[:plan.n] = b.index_select(0, dev["perm"])
    for lvp in dev["levels"]:
        K.sweep_fwd(fac.store, y, lvp["sweep"], scratch(fac.store, lvp["sweep"]))
    assert float((y[:plan.n] - yf_ref[:plan.n]).abs().max()) \
        <= 1e-13 * float(yf_ref.abs().max())
    assert float(y[plan.n]) == 0.0                      # the spare slot stays 0
    x = T.flat_solve(plan, fac, b)
    assert float((x - x_ref).abs().max()) <= 1e-13 * float(x_ref.abs().max())
    assert np.linalg.norm(A @ x.numpy() - b.numpy()) <= 1e-10 * float(b.norm())


@pytest.mark.parametrize("case,dtype,tol", [
    ("grid_kkt12", np.float64, 1e-12), ("grid_kkt20", np.float64, 1e-12),
    ("wide_front", np.float64, 1e-12), ("quasi_definite", np.float64, 1e-12),
    ("grid_kkt12", np.float32, 1e-4)])
def test_flat_solve_matches_the_jax_package_on_its_factors(case, dtype, tol):
    make, kw = CASES[case]
    A = sp.csr_matrix(make())
    Al = sp.tril(A).tocoo()
    n = A.shape[0]
    pj = J.flat_analyse(Al.row, Al.col, n, **kw)
    pt = T.flat_analyse(Al.row, Al.col, n, **kw)
    if case == "wide_front":
        assert max(g.Fpad for g in pt.groups) > 128
    fj = J.flat_factorize(pj, jnp.asarray(Al.data.astype(dtype)))
    b = np.random.default_rng(2).normal(size=n).astype(dtype)
    xj = np.asarray(J.flat_solve(pj, fj, jnp.asarray(b)))
    store = np.zeros(pt.S + 1, dtype)
    store[:pt.S] = np.asarray(fj.store)[:pt.S]
    ft = T.FlatFactors(store=torch.as_tensor(store), dmin=None, inertia=None)
    xt = T.flat_solve(pt, ft, torch.as_tensor(b)).numpy()
    assert xt.dtype == dtype
    assert np.abs(xj - xt).max() <= tol * np.abs(xj).max()


def test_item_tables_cover_every_front_and_struct_row_once():
    _, _, plan = analysed("grid_kkt20")
    dev = T._device_plan(plan, torch.device("cpu"))
    assert [g.level for g in plan.groups] == sorted(g.level for g in plan.groups)
    by_level = {}
    for g in plan.groups:
        by_level.setdefault(g.level, []).append(g)
    assert len(dev["levels"]) == len(by_level)
    seen_fronts = 0
    for lv, lvp in zip(sorted(by_level), dev["levels"]):
        s = lvp["sweep"]
        groups = by_level[lv]
        assert [(b[0], b[1], b[2]) for b in s.batches] == \
            [(g.goff, g.Fpad, g.nb) for g in groups]
        assert s.work_size == sum(g.nb * g.Fpad for g in groups)
        np.testing.assert_array_equal(
            s.rows.numpy(), np.concatenate([g.frows.ravel() for g in groups]))
        # every front that eliminates something is in exactly one work item
        offsets = []
        for off, fro, nco, Fpad, count in s.small[:, :5].tolist():
            offsets += [off + i * Fpad * Fpad for i in range(count)]
        small_with_cols = sum(int((g.ncols > 0).sum()) for g in groups if g.Fpad <= 32)
        assert len(offsets) >= small_with_cols
        want_big = sorted(g.goff + i * g.Fpad ** 2 for g in groups if g.Fpad > 32
                          for i in np.flatnonzero(g.ncols > 0))
        for wave in (s.fwd_wave, s.bwd_wave):
            assert sorted(set(wave[:, 0].tolist())) == want_big
        assert len(set(offsets)) == len(offsets)
        want_small = {g.goff + i * g.Fpad ** 2 for g in groups if g.Fpad <= 32
                      for i in np.flatnonzero(g.ncols > 0)}
        assert want_small <= set(offsets)
        seen_fronts += s.fronts.shape[0]
        # the accumulation lists: every struct row position exactly once,
        # destinations distinct and ascending, positions ascending per destination
        pos = s.acc_pos.numpy()
        ptr = s.acc_ptr.numpy()
        dest = s.acc_row.numpy()
        assert len(np.unique(pos)) == len(pos)
        assert np.all(np.diff(dest) > 0) and ptr[0] == 0 and ptr[-1] == len(pos)
        rows = s.rows.numpy()
        for k in range(len(dest)):
            seg = pos[ptr[k]:ptr[k + 1]]
            assert np.all(np.diff(seg) > 0) and np.all(rows[seg] == dest[k])
        fro, want = 0, []
        for g in groups:
            nf = (g.frows < plan.n).sum(axis=1)
            for i in range(g.nb):
                if g.ncols[i] > 0:
                    want += list(range(fro + i * g.Fpad + int(g.ncols[i]),
                                       fro + i * g.Fpad + int(nf[i])))
            fro += g.nb * g.Fpad
        assert sorted(pos.tolist()) == want
    assert seen_fronts == plan.ns
    assert dev["sweep_scratch"] == max(lvp["sweep"].work_size for lvp in dev["levels"])


def wave_levels():
    """The sweep tables of every level of the grid KKT k=20 plan and of the
    synthetic levels of the walk below."""
    _, _, plan = analysed("grid_kkt20")
    out = [lvp["sweep"] for lvp in T._device_plan(plan, torch.device("cpu"))["levels"]]
    for case in ("ladder", "wide", "root_and_small"):
        specs, pool = WALK_CASES[case]
        _, batches, n, _ = synthetic_level(specs, torch.float64, seed=1, pool=pool)
        out.append(K.build_sweep_level(batches, n, "cpu"))
    return out


def test_wave_items_tile_every_front():
    """Every front of 64 or more that eliminates a column has forward items
    whose rows tile 0..nf (triangle row blocks of 32 from 0, struct rows from
    ncols, at most one item holding both: the front's last triangle block)
    and backward items whose columns tile 0..ncols in blocks of 32; every
    flag is published by exactly one item per direction."""
    n_inline = n_split = 0
    for lvl in wave_levels():
        for direction, wave in (("fwd", lvl.fwd_wave), ("bwd", lvl.bwd_wave)):
            spans, pubs = {}, []
            for item in wave.tolist():
                off, fro, Fpad, lo, hi, nc, nf, fb = item
                assert 0 < nc <= nf <= Fpad >= 64 and lo < hi
                spans.setdefault((off, nc, nf, fb), []).append((lo, hi))
                pubs.append(K.item_waits(item, direction)[1])
                if direction == "fwd":
                    if lo < nc:
                        assert lo % K.ITEM == 0 and min(hi, nc) - lo <= K.ITEM
                        assert hi <= nc or nc - lo <= K.ITEM   # both: the last block
                    else:
                        assert hi - lo <= K.ITEM
                else:
                    assert lo % K.ITEM == 0 and hi == min(lo + K.ITEM, nc)
            for (off, nc, nf, fb), sp_ in spans.items():
                sp_.sort()
                end = nf if direction == "fwd" else nc
                assert sp_[0][0] == 0 and sp_[-1][1] == end
                assert all(a[1] == b[0] for a, b in zip(sp_, sp_[1:]))
                if direction == "fwd" and nc <= K.ITEM:
                    n_inline += len(sp_) == 1
                    n_split += len(sp_) > 1
            pubs = sorted(p for p in pubs if p is not None)
            assert pubs == list(range(lvl.n_flags))
            assert lvl.sync.shape == (2 + lvl.n_flags,)
        fronts = int(((lvl.fronts[:, 0] >= 64) & (lvl.fronts[:, 1] > 0)).sum())
        assert len(set(lvl.fwd_wave[:, 0].tolist())) == fronts
        assert lvl.bwd_kernels == int(lvl.small.shape[0] > 0) + int(lvl.bwd_wave.shape[0] > 0)
        assert lvl.fwd_kernels == lvl.bwd_kernels + int(lvl.acc_row.shape[0] > 0)
        assert lvl.fwd_kernels <= 3 and lvl.bwd_kernels <= 2
    assert n_inline > 0 and n_split > 0


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_every_wait_is_on_an_earlier_ticket(direction):
    """The kernel hands items out by ticket (table order); a wait that is on
    an item of a smaller ticket always ends, because that item is held by a
    running block.  So every flag an item waits on is published by an item
    listed before it, and the waits of an item go up the flags."""
    checked = 0
    for lvl in wave_levels():
        wave = (lvl.fwd_wave if direction == "fwd" else lvl.bwd_wave).tolist()
        publisher = {}
        for t, item in enumerate(wave):
            pub = K.item_waits(item, direction)[1]
            if pub is not None:
                publisher[pub] = t
        for t, item in enumerate(wave):
            waits, pub = K.item_waits(item, direction)
            assert waits == sorted(waits) and pub not in waits
            assert all(publisher[f] < t for f in waits)
            checked += len(waits)
    assert checked > 0


# --- the kernels' walk over the tables, in numpy -----------------------------


def _dsafe(d, tiny):
    return np.where(np.abs(d) > tiny, d, 1.0)


def walk_wave(st, y, lvl, work, direction, tiny=None):
    """The wavefront launch of csrc/sweep.cu, item by item in ticket order, in
    numpy float64.  An item may read z / x (in ``work``) only of blocks whose
    flags are published: asserted at every wait."""
    rows = lvl.rows.numpy()
    published = np.zeros(lvl.n_flags, bool)
    for item in (lvl.fwd_wave if direction == "fwd" else lvl.bwd_wave).tolist():
        waits, pub = K.item_waits(item, direction)
        assert published[waits].all()
        off, fro, ld, lo, hi, nc, nf, _ = item
        F = st[off:off + ld * ld].reshape(ld, ld)
        fr, z = rows[fro:fro + ld], work[fro:fro + ld]
        if direction == "fwd":
            for j in range(lo, min(hi, nc)):
                z[j] = y[fr[j]] - F[j, :j] @ z[:j]
                y[fr[j]] = z[j] / _dsafe(F[j, j], tiny)
            s0 = max(lo, nc)
            z[s0:hi] = -(F[s0:hi, :nc] @ z[:nc])
        else:
            acc = (y[fr[lo:hi]] - F[nc:nf, lo:hi].T @ y[fr[nc:nf]]
                   - F[hi:nc, lo:hi].T @ z[hi:nc])
            for j in range(hi - 1, lo - 1, -1):
                z[j] = acc[j - lo]
                acc[:j - lo] -= F[j, lo:j] * acc[j - lo]
            y[fr[lo:hi]] = z[lo:hi]
        if pub is not None:
            published[pub] = True


def tables_fwd(store, y, lvl, tiny):
    """What csrc/sweep.cu's forward launches compute, item by item in launch
    order, in numpy float64.  The scratch starts as NaN: reading an entry that
    no item wrote shows in the result."""
    st, rows, ncols = store.numpy(), lvl.rows.numpy(), lvl.ncols.numpy()
    work = np.full(lvl.work_size, np.nan)
    for off, fro, nco, N, count in lvl.small[:, :5].tolist():
        for f in range(count):
            nc = int(ncols[nco + f])
            if nc == 0:
                continue
            F = st[off + f * N * N:off + (f + 1) * N * N].reshape(N, N)
            fr = rows[fro + f * N:fro + (f + 1) * N]
            v = np.where(np.arange(N) < nc, y[fr], 0.0)
            for j in range(nc):
                v[j + 1:] -= F[j + 1:, j] * v[j]
            y[fr[:nc]] = v[:nc] / _dsafe(np.diag(F)[:nc], tiny)
            work[fro + f * N + nc:fro + (f + 1) * N] = v[nc:]
    walk_wave(st, y, lvl, work, "fwd", tiny)
    ptr, pos = lvl.acc_ptr.numpy(), lvl.acc_pos.numpy()
    for k, row in enumerate(lvl.acc_row.tolist()):
        y[row] += work[pos[ptr[k]:ptr[k + 1]]].sum()


def tables_bwd(store, y, lvl):
    """The backward launches of csrc/sweep.cu, item by item, in numpy."""
    st, rows, ncols = store.numpy(), lvl.rows.numpy(), lvl.ncols.numpy()
    walk_wave(st, y, lvl, np.full(lvl.work_size, np.nan), "bwd")
    for off, fro, nco, N, count in lvl.small[:, :5].tolist():
        for f in range(count):
            nc = int(ncols[nco + f])
            if nc == 0:
                continue
            F = st[off + f * N * N:off + (f + 1) * N * N].reshape(N, N)
            fr = rows[fro + f * N:fro + (f + 1) * N]
            v = y[fr].copy()
            for i in range(int((fr < lvl.n).sum()) - 1, 0, -1):
                k = min(i, nc)
                v[:k] -= F[i, :k] * v[i]
            y[fr[:nc]] = v[:nc]


# (specs, pool of shared struct rows): an int is ncols with a random number of
# struct rows, a pair (ncols, struct rows) fixes both
WALK_CASES = {
    "ladder": ([(8, [0, 3, 8, 1, 5]), (32, [32, 7, 0, 31]), (64, [0, 1, 64, 20, 33]),
                (128, [100, 128, 5]), (192, [150, 40])], 24),
    "wide": ([(256, [(20, 200), (33, 120), 256, 1]), (512, [(300, 150), (500, 0)]),
              (1024, [(1000, 24), 0, (31, 97)])], 300),
    "root": ([(4096, [(3575, 0)])], 24),
    "root_and_small": ([(4096, [(3575, 0)]),
                        (64, [(1 + k % 22, (7 * k) % (42 - k % 22)) for k in range(300)])],
                       64),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_the_tables_drive_the_sweeps_as_the_kernels_walk_them(case):
    """The kernels cannot run here, but the tables they read can be walked in
    their launch order (small fronts, the wavefront items by ticket, the
    accumulation; backward the wavefront, then the small fronts), honouring
    every wait.  Against the dense reference, with NaN wherever a front does
    not hold L or d and in the unwritten scratch."""
    specs, pool = WALK_CASES[case]
    store, batches, n, dense = synthetic_level(specs, torch.float64, seed=5, pool=pool)
    lvl = K.build_sweep_level(batches, n, "cpu")
    y0 = np.random.default_rng(4).normal(size=n + 1)
    y0[n] = 0.0
    ref_fwd, ref_bwd = dense_reference(dense, y0, tiny16(torch.float64))
    y = y0.copy()
    tables_fwd(store, y, lvl, tiny16(torch.float64))
    assert np.abs(y - ref_fwd).max() <= 1e-12 * np.abs(ref_fwd).max()
    tables_bwd(store, y, lvl)
    assert np.abs(y - ref_bwd).max() <= 1e-12 * np.abs(ref_bwd).max()
    assert y[n] == 0.0


def test_two_solves_give_the_same_bits():
    _, Al, plan = analysed("grid_kkt20")
    fac = T.flat_factorize(plan, torch.as_tensor(Al.data))
    b = torch.as_tensor(np.random.default_rng(0).normal(size=plan.n))
    assert torch.equal(T.flat_solve(plan, fac, b), T.flat_solve(plan, fac, b))


# --- synthetic levels of every ladder size -----------------------------------


def synthetic_level(specs, dtype, seed, garbage=float("nan"), pool=24):
    """A level of fronts ``specs = [(Fpad, [ncols, ...]), ...]`` (an entry may
    be a pair ``(ncols, struct rows)``; else the struct rows are drawn) with random L
    and d, eliminated rows distinct over all fronts and struct rows drawn from
    a shared pool of ``pool`` rows, so that fronts add into the same rows.
    Every entry of a front that is neither L nor d is ``garbage``, on the
    padded rows too.  Returns (store, batches, n, dense fronts)."""
    rng = np.random.default_rng(seed)
    specs = [(Fpad, [nc if isinstance(nc, tuple) else (nc, None) for nc in ncs])
             for Fpad, ncs in specs]
    n_elim = sum(nc for _, ncs in specs for nc, _ in ncs)
    n = n_elim + pool
    parts, batches, dense = [], [], []
    off, next_row = 0, 0
    for Fpad, ncs in specs:
        nb = len(ncs)
        F = np.empty((nb, Fpad, Fpad))
        frows = np.full((nb, Fpad), n, np.int64)
        for i, (nc, ns) in enumerate(ncs):
            if ns is None:
                ns = int(rng.integers(0, min(pool, Fpad - nc) + 1))
            nf = nc + ns
            F[i] = garbage
            L = np.tril(rng.normal(size=(nf, nc)) * 0.5 / np.sqrt(max(nc, 1)), -1)
            d = rng.uniform(0.5, 2.0, nc) * rng.choice([-1.0, 1.0], nc)
            if nc > 2:
                d[1] = 0.0                    # a tiny pivot: divided by 1
            for j in range(nc):
                F[i, j:nf, j] = L[j:, j]
                F[i, j, j] = d[j]
            frows[i, :nc] = np.arange(next_row, next_row + nc)
            frows[i, nc:nf] = n_elim + np.sort(rng.choice(pool, ns, replace=False))
            next_row += nc
            dense.append((L, d, frows[i, :nf].copy(), nc))
        batches.append((off, Fpad, np.asarray([nc for nc, _ in ncs], np.int64), frows))
        parts.append(F.ravel())
        off += F.size
    store = torch.as_tensor(np.concatenate(parts + [np.zeros(1)]), dtype=dtype)
    return store, batches, n, dense


def dense_reference(dense, y0, tiny):
    """Forward then backward over the level, front by front, in numpy float64."""
    y = y0.astype(np.float64).copy()
    add = np.zeros_like(y)
    for L, d, fr, nc in dense:
        if nc == 0:
            continue
        L11 = L[:nc] + np.eye(nc)
        z = np.linalg.solve(L11, y[fr[:nc]])
        add[fr[nc:]] -= L[nc:] @ z
        y[fr[:nc]] = z / np.where(np.abs(d) > tiny, d, 1.0)
    y += add
    y_fwd = y.copy()
    for L, d, fr, nc in dense:
        if nc == 0:
            continue
        L11 = L[:nc] + np.eye(nc)
        y[fr[:nc]] = np.linalg.solve(L11.T, y[fr[:nc]] - L[nc:].T @ y[fr[nc:]])
    return y_fwd, y


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("Fpad", [8, 16, 32, 64, 96, 128, 192, 256])
def test_plain_sweeps_on_a_synthetic_level(Fpad, dtype, tol):
    # tolerance relative to max|y|: rounding of at most Fpad products per entry
    ncs = [0, 1, Fpad // 3, Fpad - 5, Fpad, 2, Fpad // 2]
    specs = [(Fpad, ncs), (8, [0, 3, 8, 1])]
    store, batches, n, dense = synthetic_level(specs, dtype, seed=Fpad)
    lvl = K.build_sweep_level(batches, n, "cpu")
    y0 = np.random.default_rng(3).normal(size=n + 1)
    y0[n] = 0.0
    ref_fwd, ref_bwd = dense_reference(dense, y0, tiny16(dtype))
    y = torch.as_tensor(y0, dtype=dtype)
    before = K.sweep_counts()
    K.sweep_fwd(store, y, lvl, scratch(store, lvl))
    assert np.abs(y.numpy() - ref_fwd).max() <= tol * np.abs(ref_fwd).max()
    K.sweep_bwd(store, y, lvl, scratch(store, lvl))
    assert np.abs(y.numpy() - ref_bwd).max() <= tol * np.abs(ref_bwd).max()
    after = K.sweep_counts()
    assert after["plain"] == before["plain"] + 2          # plain code on the CPU,
    assert K.sweep_launch_count() == before["fwd"] + before["bwd"]   # no launch


def test_level_without_eliminated_columns_does_nothing():
    store, batches, n, _ = synthetic_level([(16, [0, 0]), (64, [0])], torch.float64, 0)
    lvl = K.build_sweep_level(batches, n, "cpu")
    assert lvl.fwd_kernels == 0 and lvl.bwd_kernels == 0
    y0 = torch.as_tensor(np.random.default_rng(0).normal(size=n + 1))
    y = y0.clone()
    K.sweep_fwd(store, y, lvl, scratch(store, lvl))
    K.sweep_bwd(store, y, lvl, scratch(store, lvl))
    assert torch.equal(y, y0)


def test_wrappers_check_their_operands():
    store, batches, n, _ = synthetic_level([(16, [4, 16]), (64, [10])], torch.float64, 1)
    lvl = K.build_sweep_level(batches, n, "cpu")
    y = torch.zeros(n + 1, dtype=torch.float64)
    work = scratch(store, lvl)
    K.sweep_fwd(store, y, lvl, work)                         # this one is taken
    for fn in (K.sweep_fwd, K.sweep_bwd):
        with pytest.raises(ValueError):                      # y without the spare slot
            fn(store, y[:-1], lvl, work)
        with pytest.raises(ValueError):                      # another dtype
            fn(store, y.float(), lvl, work)
        with pytest.raises(ValueError):                      # the store is too short
            fn(store[:100], y, lvl, work)
        with pytest.raises(ValueError):                      # scratch too small
            fn(store, y, lvl, torch.zeros(3, dtype=torch.float64))
        with pytest.raises(ValueError):                      # scratch of another dtype
            fn(store, y, lvl, work.float())
        with pytest.raises(ValueError):                      # not flat
            fn(store[:-1].view(-1, 4), y, lvl, work)
        with pytest.raises(TypeError):                       # the scratch is not optional
            fn(store, y, lvl)
    with pytest.raises(ValueError):                          # not a size of the ladder
        K.build_sweep_level([(0, 24, [3], np.arange(24)[None, :])], n, "cpu")
    bad = batches[0][3].copy()
    bad[0, 0], bad[0, -1] = n, 0                             # padding before a real row
    with pytest.raises(ValueError):
        K.build_sweep_level([(0, 16, [4, 16], bad)], n, "cpu")
    with pytest.raises(ValueError):                          # more columns than rows
        K.build_sweep_level([(0, 16, [17, 0], batches[0][3])], n, "cpu")


def test_sweep_wrappers_do_not_fall_back(monkeypatch):
    """Tensors that are not on the CPU must reach the kernel path (and fail
    here for want of a card), never the plain version."""
    called = []
    for name in ("sweep_fwd_plain", "sweep_bwd_plain", "sweep_accumulate_plain"):
        monkeypatch.setattr(K, name, lambda *a, **k: called.append(1))
    _, batches, n, _ = synthetic_level([(16, [4, 16]), (64, [10])], torch.float64, 1)
    lvl = K.build_sweep_level(batches, n, "meta")
    store = torch.zeros(16 * 16 * 2 + 64 * 64 + 1, dtype=torch.float64, device="meta")
    y = torch.zeros(n + 1, dtype=torch.float64, device="meta")
    before = K.sweep_plain_count()
    for fn in (K.sweep_fwd, K.sweep_bwd):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(store, y, lvl, scratch(store, lvl))
    assert called == [] and K.sweep_plain_count() == before


def test_sweep_bound_counts_bytes_and_operations():
    # one front of 64 with 10 columns and 30 real rows, one of 8 that is skipped
    fr64 = np.full((1, 64), 100, np.int64)
    fr64[0, :30] = np.arange(30)
    fr8 = np.full((1, 8), 100, np.int64)
    fr8[0, :4] = np.arange(40, 44)
    lvl = K.build_sweep_level([(0, 64, [10], fr64), (4096, 8, [0], fr8)], 100, "cpu")
    entries = 10 * 30 - 10 * 11 // 2                      # strictly below the diagonal
    tb, to = K.sweep_bound_terms(lvl, torch.float64, "bwd")
    assert to == pytest.approx(2 * entries / K.H100_FLOPS[torch.float64])
    assert tb == pytest.approx((entries * 8 + 30 * 4 + 4 + (30 + 10) * 8)
                               / K.H100_BYTES_PER_S)
    tbf, tof = K.sweep_bound_terms([lvl], torch.float64, "fwd")
    assert tof == pytest.approx((2 * entries + 10 + 20) / K.H100_FLOPS[torch.float64])
    # L, the row map, ncols; d and y's eliminated rows read and written; each
    # destination row read and written
    assert tbf == pytest.approx(
        (entries * 8 + 30 * 4 + 4 + (3 * 10 + 2 * 20) * 8) / K.H100_BYTES_PER_S)
    ms, by = K.sweep_bound_ms(lvl, torch.float64, "fwd")
    assert by == "bytes" and ms == pytest.approx(tbf * 1e3)
    assert K.sweep_bound_ms(lvl, torch.float32, "bwd")[0] < K.sweep_bound_ms(
        lvl, torch.float64, "bwd")[0]
    with pytest.raises(ValueError):
        K.sweep_bound_ms(lvl, torch.float64, "sideways")


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_sweep_bound_leaves_out_the_design_s_own_scratch(monkeypatch, direction):
    """The bound counts what the sweep must move, not this design's workspace:
    cutting the fronts into more wavefront items (more flags, more tickets,
    struct rows in items of their own) does not move it, and a destination
    row that several fronts add into counts once."""
    specs = [(192, [150, 40, (20, 150)]), (64, [20, 33]), (8, [3, 5])]
    _, batches, n, dense = synthetic_level(specs, torch.float64, seed=9, pool=160)
    whole = K.build_sweep_level(batches, n, "cpu")
    monkeypatch.setattr(K, "STRUCT_INLINE", 0)
    cut = K.build_sweep_level(batches, n, "cpu")
    assert cut.fwd_wave.shape[0] > whole.fwd_wave.shape[0]
    assert cut.n_flags == whole.n_flags > 0
    tb, to = K.sweep_bound_terms(whole, torch.float64, direction)
    assert K.sweep_bound_terms(cut, torch.float64, direction) == (tb, to)
    nc = sum(d[3] for d in dense)
    nf = sum(len(d[2]) for d in dense)
    entries = sum(d[3] * len(d[2]) - d[3] * (d[3] + 1) // 2 for d in dense)
    dests = len(set(np.concatenate([d[2][d[3]:] for d in dense]).tolist()))
    assert dests < nf - nc                                   # rows are shared
    moved = entries * 8 + 4 * nf + 4 * len(dense)
    moved += (3 * nc + 2 * dests) * 8 if direction == "fwd" else (nf + nc) * 8
    assert tb == pytest.approx(moved / K.H100_BYTES_PER_S)
