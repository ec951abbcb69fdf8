"""The panel step of the blocked partial LDL^T (fronts wider than 128) and
the per-level work-item table of the small-front kernel, as far as the CPU
can run them: the plain PyTorch versions that the CUDA kernels of
linalg/ldlt_kernels.py are held against on the card.

* the plain wide-front call (``ldlt_panel_slab_plain`` + one product per
  panel, front by front) gives the SAME BITS as the column loop it was
  moved out of (kept below as the oracle);
* it agrees with the JAX package's ``_partial_ldlt_dyn`` on the entries
  the storage contract specifies;
* ``W`` / ``Lm`` are the masked, scaled panel of that composition;
* the wrappers check their operands, count no launch on the CPU, and never
  give way to the plain version for a tensor that is not on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg.supernodal_flat import _partial_ldlt_dyn

from galahad_tpu_torch._device import tiny16
from galahad_tpu_torch.linalg import ldlt_kernels

from test_torch_ldlt_kernel import contract_err, fronts

B = 32


def blocked_oracle(F, ncols, nblocks, B):
    """The column loop of small tensor operations that factored wide fronts
    before the panel kernel existed, kept verbatim as the oracle.  Also
    returns the (W, Lm) of every panel that has rows below it."""
    ch, Fpad, _ = F.shape
    tiny = tiny16(F.dtype)
    ncols = ncols.to(torch.int64)
    one = torch.ones((), dtype=F.dtype, device=F.device)
    jB = torch.arange(B, device=F.device)
    panels = []
    for bi in range(nblocks):
        b = bi * B
        P = F[:, :, b:b + B]
        for j in range(B):
            gcol = b + j
            if gcol + 1 >= Fpad:
                break
            active = ncols > gcol
            d = P[:, gcol, j]
            dn = torch.where(active & (d.abs() > tiny), d, one)
            col = P[:, gcol + 1:, j]
            l = torch.where(active[:, None], col / dn[:, None], 0.0)
            if j + 1 < B:
                lrows = l[:, :B - j - 1]
                P[:, gcol + 1:, j + 1:] -= (
                    l[:, :, None] * (dn[:, None] * lrows)[:, None, :])
            P[:, gcol + 1:, j] = torch.where(active[:, None], l, col)
        if b + B >= Fpad:
            continue
        amask = (b + jB)[None, :] < ncols[:, None]
        Pb = F[:, b:, b:b + B]
        dvec = torch.diagonal(Pb[:, :B, :], dim1=1, dim2=2)
        dsafe = torch.where(dvec.abs() > tiny, dvec, one)
        Lb = torch.where(amask[:, None, :], Pb, 0.0)
        Lb[:, jB, jB] = 0.0
        panels.append(((Lb * dsafe[:, None, :]).clone(), Lb.clone()))
        T = (Lb * dsafe[:, None, :]) @ Lb[:, B:, :].transpose(-1, -2)
        F[:, b:, b + B:] -= T
    return panels


def wide_fronts(Fpad, dtype, seed):
    """Five fronts with ncols 0, inside the first panel, on a panel edge,
    inside a later panel, and full."""
    ncols = np.array([0, 7, 2 * B, Fpad - B - 5, Fpad], np.int32)
    F, _ = fronts(len(ncols), Fpad, seed=seed, ncols=ncols, extra=Fpad // 3)
    return torch.as_tensor(F, dtype=dtype), torch.as_tensor(ncols)


def wide_level(F, ncols, offset=0):
    """The work table of the fronts ``F (nb, Fpad, Fpad)`` laid out one after
    another from ``offset`` of a flat buffer, every row real."""
    nb, Fpad, _ = F.shape
    return ldlt_kernels.build_wide_level(
        [(offset + k * Fpad * Fpad, Fpad, int(nc), Fpad) for k, nc in enumerate(ncols)],
        "cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("Fpad", [192, 256])
def test_panels_give_the_bits_of_the_column_loop(Fpad, dtype):
    # bitwise: the panel function is the same tensor operations in the same
    # order, and the trailing update is the same product on the same
    # operands; the oracle runs one front at a time, as the plain call does
    F, ncols = wide_fronts(Fpad, dtype, seed=Fpad)
    want = F.clone()
    for k, nc in enumerate(ncols.tolist()):
        blocked_oracle(want[k:k + 1], ncols[k:k + 1], -(-nc // B), B)
    got = F.clone()
    before = ldlt_kernels.wide_plain_count()
    ldlt_kernels.partial_ldlt_wide(got.view(-1), wide_level(F, ncols))
    assert torch.equal(got, want)
    assert ldlt_kernels.wide_plain_count() == before + 1
    # a window of a larger buffer, as the flat store hands it over
    buf = torch.zeros(4 + F.numel(), dtype=dtype)
    buf[4:].copy_(F.view(-1))
    ldlt_kernels.partial_ldlt_wide(buf, wide_level(F, ncols, offset=4))
    assert torch.equal(buf[4:].view_as(F), want) and float(buf[:4].abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("Fpad", [192, 256])
def test_panel_scratch_is_the_masked_scaled_panel(Fpad, dtype):
    # bitwise, for the same reason
    F, ncols = wide_fronts(Fpad, dtype, seed=1 + Fpad)
    nblocks = Fpad // B
    want = blocked_oracle(F.clone(), ncols, nblocks, B)
    got = F.clone()
    for bi in range(nblocks):
        b = bi * B
        W, Lm = ldlt_kernels.ldlt_panel_slab_plain(got[:, b:, b:b + B], ncols, b)
        if b + B < Fpad:
            assert torch.equal(W, want[bi][0]) and torch.equal(Lm, want[bi][1])
            # zero diagonal, zero inactive columns
            assert not Lm[:, torch.arange(B), torch.arange(B)].any()
            inactive = (b + torch.arange(B))[None, :] >= ncols[:, None]
            assert not (Lm.abs().sum(dim=1) * inactive).any()
            got[:, b:, b + B:] -= W @ Lm[:, B:, :].transpose(-1, -2)


@pytest.mark.parametrize("Fpad", [192, 256])
def test_panels_match_xla_composition_f64(Fpad):
    # tolerance 1e-12 relative to the largest entry: float64, the same
    # right-looking arithmetic up to the order inside a panel's product
    F, ncols = wide_fronts(Fpad, torch.float64, seed=2 + Fpad)
    nblocks = Fpad // B
    ref = np.asarray(_partial_ldlt_dyn(
        jnp.asarray(F.numpy()), jnp.asarray(ncols.numpy()),
        jnp.asarray(nblocks, jnp.int32), B)[0])
    out = F.clone()
    ldlt_kernels.partial_ldlt_wide(out.view(-1), wide_level(F, ncols))
    assert contract_err(ref, out.numpy(), ncols.numpy()) < 1e-12 * np.abs(ref).max()


def test_panel_wrapper_checks_and_counts_nothing_on_cpu():
    F, ncols = wide_fronts(192, torch.float64, seed=3)
    lvl = wide_level(F, ncols)
    store = F.clone().view(-1)
    before = (ldlt_kernels.launch_count(), ldlt_kernels.wide_launch_count())
    ldlt_kernels.partial_ldlt_wide(store, lvl)
    assert (ldlt_kernels.launch_count(), ldlt_kernels.wide_launch_count()) == before
    with pytest.raises(ValueError):          # the fronts reach outside the store
        ldlt_kernels.partial_ldlt_wide(store[:-1], lvl)
    with pytest.raises(ValueError):          # not a flat store
        ldlt_kernels.partial_ldlt_wide(F.clone(), lvl)
    with pytest.raises(ValueError):          # the table on another device
        ldlt_kernels.partial_ldlt_wide(
            store, ldlt_kernels.build_wide_level(lvl.fronts, "meta"))
    with pytest.raises(ValueError):          # ncols beyond the front
        ldlt_kernels.build_wide_level([(0, 192, 193, 192)], "cpu")
    with pytest.raises(ValueError):          # a negative offset
        ldlt_kernels.build_wide_level([(-4, 192, 3, 192)], "cpu")


def test_panel_wrapper_does_not_fall_back(monkeypatch):
    """A tensor that is not on the CPU must reach the kernel path (and fail
    here for want of a card), never the plain version."""
    called = []
    monkeypatch.setattr(ldlt_kernels, "partial_ldlt_wide_plain",
                        lambda *a, **k: called.append(1))
    store = torch.zeros(192 * 192, device="meta")
    lvl = ldlt_kernels.build_wide_level([(0, 192, 40, 180)], "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ldlt_kernels.partial_ldlt_wide(store, lvl)
    src = torch.zeros(64, device="meta")
    items = ldlt_kernels.build_ldlt_items([(0, 8, [3])], "meta")
    monkeypatch.setattr(ldlt_kernels, "partial_ldlt_plain",
                        lambda *a, **k: called.append(1))
    with pytest.raises(ValueError, match="unsupported device"):
        ldlt_kernels.partial_ldlt_items(src, items)
    assert called == []


def level_batches(seed=0):
    """Batches of every ladder size at staggered offsets of one buffer."""
    rng = np.random.default_rng(seed)
    batches, data, off = [], [], 64
    for Fpad, nb in [(8, 70), (128, 2), (16, 17), (64, 3), (32, 9), (96, 2)]:
        F, ncols = fronts(nb, Fpad, seed=seed + Fpad, extra=Fpad // 4)
        ncols[0], ncols[-1] = 0, Fpad
        F, _ = fronts(nb, Fpad, seed=seed + Fpad, ncols=ncols, extra=Fpad // 4)
        batches.append((off, Fpad, ncols))
        data.append((off, F))
        off += F.size + 64 * int(rng.integers(0, 3))
    buf = rng.normal(size=off + 1)
    for o, F in data:
        buf[o:o + F.size] = F.ravel()
    return batches, torch.as_tensor(buf)


def test_items_table_covers_every_front_once():
    batches, _ = level_batches()
    items = ldlt_kernels.build_ldlt_items(batches, "cpu")
    table = items.table.numpy()
    assert items.n_medium + items.n_small == len(table)
    assert items.n_medium == 2 + 3 + 2 and items.medium_fpad_max == 128
    assert items.small_fpad_max == 32
    assert items.fronts == 70 + 2 + 17 + 3 + 9 + 2
    # heaviest first, the fronts of 64..128 before those of 8..32
    assert list(table[:items.n_medium, 2]) == sorted(table[:items.n_medium, 2],
                                                     reverse=True)
    assert list(table[items.n_medium:, 2]) == sorted(table[items.n_medium:, 2],
                                                     reverse=True)
    assert table[:items.n_medium, 2].min() > 32 >= table[items.n_medium:, 2].max()
    seen = []
    nc = items.ncols.numpy()
    by_off = {o: (fp, np.asarray(n)) for o, fp, n in batches}
    starts = sorted(by_off)
    for off, nc_off, Fpad, count in table:
        assert count <= max(1, 256 // Fpad) and off % 4 == 0
        base = max(o for o in starts if o <= off)
        fp, ncb = by_off[base]
        first = (off - base) // (fp * fp)
        assert fp == Fpad and (off - base) % (fp * fp) == 0
        assert list(nc[nc_off:nc_off + count]) == list(ncb[first:first + count])
        seen += [(base, first + i) for i in range(count)]
    assert len(seen) == len(set(seen)) == items.fronts
    assert items.start == 64 and items.end == max(
        o + len(n) * fp * fp for o, fp, n in batches)
    with pytest.raises(ValueError):
        ldlt_kernels.build_ldlt_items([(0, 24, [1])], "cpu")
    with pytest.raises(ValueError):
        ldlt_kernels.build_ldlt_items([(2, 8, [1])], "cpu")


def test_items_call_equals_batch_by_batch():
    batches, buf = level_batches(seed=5)
    items = ldlt_kernels.build_ldlt_items(batches, "cpu")
    want = buf.clone()
    for off, Fpad, ncols in batches:
        nb = len(ncols)
        want[off:off + nb * Fpad * Fpad] = ldlt_kernels.partial_ldlt_plain(
            buf[off:off + nb * Fpad * Fpad].view(nb, Fpad, Fpad),
            torch.as_tensor(ncols)).reshape(-1)
    assert torch.equal(ldlt_kernels.partial_ldlt_items_plain(buf, items), want)
    before = ldlt_kernels.launch_count()
    # out of place: the gaps between the batches keep what ``out`` held
    out = torch.full_like(buf, 7.0)
    assert ldlt_kernels.partial_ldlt_items(buf, items, out=out) is out
    touched = torch.zeros(len(buf), dtype=torch.bool)
    for off, Fpad, ncols in batches:
        touched[off:off + len(ncols) * Fpad * Fpad] = True
    assert torch.equal(out[touched], want[touched]) and bool((out[~touched] == 7).all())
    # a window of the buffer, with the items moved to it
    lo, hi = items.start, items.end
    win = buf[lo:hi].clone()
    moved = items.shifted(-lo)
    assert (moved.start, moved.end) == (0, hi - lo)
    ldlt_kernels.partial_ldlt_items(win, moved)
    assert torch.equal(win, want[lo:hi])
    with pytest.raises(ValueError):
        items.shifted(2)
    # in place
    got = buf.clone()
    assert ldlt_kernels.partial_ldlt_items(got, items) is got
    assert torch.equal(got, want)
    assert ldlt_kernels.launch_count() == before     # no kernel ran on the CPU
    with pytest.raises(ValueError):                  # items outside the buffer
        ldlt_kernels.partial_ldlt_items(buf[:hi - 1], items)
    with pytest.raises(ValueError):
        ldlt_kernels.partial_ldlt_items(buf, items.shifted(-lo - 4))


def test_panel_bound_counts_bytes_and_operations():
    # the wide-front call's bound: each front's lower triangle read once, its
    # eliminated columns' lower triangle and its whole Schur block written
    # once (nothing for a front with ncols = 0), every table row read, and the
    # plan's flop count over the float64 tensor-core rate
    lvl = ldlt_kernels.build_wide_level(
        [(0, 192, 40, 160), (192 * 192, 4096, 3575, 3575), (2 * 4096 ** 2, 256, 0, 200)],
        "cpu")
    tb, to = ldlt_kernels.wide_bound_terms(lvl, torch.float64)
    entries = (160 * 161 / 2 + 40 * 41 / 2 + 120 * 40 + 120 ** 2     # read + written
               + 2 * 3575 * 3576 / 2)
    assert tb == pytest.approx((8 * entries + 8 * 12) / ldlt_kernels.H100_BYTES_PER_S)
    ops = sum(c ** 3 / 3 + c * c * (nf - c) + c * (nf - c) ** 2
              for c, nf in ((40, 160), (3575, 3575), (0, 200)))
    assert to == pytest.approx(ops / 67e12)
    ms, by = ldlt_kernels.wide_bound_ms([lvl], torch.float64)
    assert ms == pytest.approx(max(tb, to) * 1e3)
    assert by == ("bytes" if tb >= to else "operations")
    tb32, _ = ldlt_kernels.wide_bound_terms(lvl, torch.float32)
    assert tb32 == pytest.approx(tb / 2, rel=1e-4)
