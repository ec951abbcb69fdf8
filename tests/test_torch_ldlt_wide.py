"""The partial LDL^T of the wide fronts (Fpad > 128) of a tree level, as far as
the CPU can run it: the level's work table and the plain PyTorch version that
the kernel of csrc/ldlt_wide.cu is held against on the card.

* the table lists every wide front of a plan's level once, ``nf`` taken from
  the front's real rows, heaviest first;
* the plain version against the JAX package's ``_partial_ldlt_dyn`` on the
  entries the storage contract specifies, for Fpad 192 and 256 and ncols of
  0, 1, 31, 33, partial and nf, with nf < Fpad (the rows beyond are absent);
* a level that mixes Fpad values gives, front by front, the bits of a level
  of that front alone, and nothing outside a front's leading nf x nf block
  is written;
* ``flat_factorize`` on the CPU against the JAX package's store on a matrix
  whose wide fronts carry struct rows (ncols < nf).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from galahad_tpu.linalg.supernodal_flat import _partial_ldlt_dyn

from galahad_tpu_torch.linalg import ldlt_kernels
from galahad_tpu_torch.linalg import supernodal_flat as T

from test_torch_flat_ldlt import both, holds
from test_torch_ldlt_kernel import contract_err

B = ldlt_kernels.PANEL


def wide_front(Fpad, nf, ncols, seed, sign=1.0):
    """A symmetric definite front with ``nf`` real rows, zero beyond."""
    rng = np.random.default_rng(seed)
    F = np.zeros((Fpad, Fpad))
    G = rng.normal(size=(nf, nf))
    F[:nf, :nf] = sign * (G @ G.T / nf + np.eye(nf))
    return F


def level_buffer(specs, seed, pad=24):
    """Fronts ``specs = [(Fpad, ncols, nf), ...]`` at staggered offsets of one
    flat buffer (NaN in the gaps and beyond every front's nf).  Returns
    (buffer, level fronts for ``build_wide_level``, dense fronts)."""
    rows, dense = [], []
    off = pad
    for i, (Fpad, nc, nf) in enumerate(specs):
        F = wide_front(Fpad, nf, nc, seed + i, sign=1.0 if i % 2 == 0 else -1.0)
        dense.append(F)
        rows.append((off, Fpad, nc, nf))
        off += Fpad * Fpad + pad
    buf = np.full(off + 1, np.nan)
    for (o, Fpad, _, nf), F in zip(rows, dense):
        G = np.full((Fpad, Fpad), np.nan)
        G[:nf, :nf] = F[:nf, :nf]
        buf[o:o + Fpad * Fpad] = G.ravel()
    return torch.as_tensor(buf), rows, dense


def wide_plan():
    """Two dense 150 x 150 blocks coupled through a 40-row separator (natural
    order): two fronts of Fpad 192 with ncols 150 and nf 190 in one level."""
    rng = np.random.default_rng(3)
    nb, ns = 150, 40
    n = 2 * nb + ns
    A = np.zeros((n, n))
    for lo in (0, nb):
        G = rng.normal(size=(nb, nb)) / np.sqrt(nb)
        A[lo:lo + nb, lo:lo + nb] = G @ G.T + np.eye(nb)
        C = rng.normal(size=(ns, nb)) * 0.05
        A[2 * nb:, lo:lo + nb] = C
        A[lo:lo + nb, 2 * nb:] = C.T
    A[2 * nb:, 2 * nb:] = 4.0 * np.eye(ns)
    return A


def test_level_table_lists_every_wide_front_once():
    A = sp.csr_matrix(wide_plan())
    Al = sp.tril(A).tocoo()
    plan = T.flat_analyse(Al.row, Al.col, A.shape[0], order="natural")
    dev = T._device_plan(plan, "cpu")
    want = set()
    for g in plan.groups:
        if g.Fpad > ldlt_kernels.MAX_KERNEL_FRONT:
            nf = (g.frows < plan.n).sum(axis=1)
            want |= {(g.goff + i * g.Fpad ** 2, g.Fpad, int(g.ncols[i]), int(nf[i]))
                     for i in range(g.nb)}
    got = [tuple(r) for lvp in dev["levels"] if lvp["wide"] is not None
           for r in lvp["wide"].fronts.tolist()]
    assert len(got) == len(set(got)) and set(got) == want
    assert (192, 150, 190) in {r[1:] for r in got}
    for lvp in dev["levels"]:
        lvl = lvp["wide"]
        if lvl is None:
            continue
        fr = lvl.fronts
        panels = -(-fr[:, 2] // B)
        assert list(panels) == sorted(panels, reverse=True)     # heaviest first
        assert lvl.steps == panels.max()
        assert lvl.steps >= 1 and lvl.max_items >= 1
        assert torch.equal(lvl.table, torch.as_tensor(fr))
    with pytest.raises(ValueError):                 # ncols beyond the real rows
        ldlt_kernels.build_wide_level([(0, 192, 100, 90)], "cpu")
    with pytest.raises(ValueError):                 # real rows beyond the front
        ldlt_kernels.build_wide_level([(0, 192, 10, 200)], "cpu")
    with pytest.raises(ValueError):                 # rows off 16-byte alignment
        ldlt_kernels.build_wide_level([(2, 192, 10, 100)], "cpu")
    with pytest.raises(ValueError):                 # not a multiple of the panel
        ldlt_kernels.build_wide_level([(0, 200, 10, 100)], "cpu")
    with pytest.raises(ValueError):
        ldlt_kernels.build_wide_level([], "cpu")


NCOLS = {"0": lambda nf: 0, "1": lambda nf: 1, "31": lambda nf: 31, "33": lambda nf: 33,
         "partial": lambda nf: nf - 45, "nf": lambda nf: nf}


@pytest.mark.parametrize("case", sorted(NCOLS))
@pytest.mark.parametrize("Fpad", [192, 256])
def test_plain_matches_xla_dyn(Fpad, case):
    # tolerance 1e-12 relative to the largest entry: float64, the same
    # right-looking arithmetic up to the order inside a panel's product
    nf = Fpad - 29
    nc = NCOLS[case](nf)
    F = wide_front(Fpad, nf, nc, seed=Fpad + nc)
    nblocks = -(-nc // B)
    ref = np.asarray(_partial_ldlt_dyn(
        jnp.asarray(F[None]), jnp.asarray(np.array([nc], np.int32)),
        jnp.asarray(nblocks, jnp.int32), B)[0])
    buf = torch.as_tensor(np.concatenate([np.zeros(8), F.ravel()]))
    lvl = ldlt_kernels.build_wide_level([(8, Fpad, nc, nf)], "cpu")
    before = ldlt_kernels.wide_plain_count()
    assert ldlt_kernels.partial_ldlt_wide(buf, lvl) is buf
    assert ldlt_kernels.wide_plain_count() == before + 1
    out = buf[8:].view(1, Fpad, Fpad).numpy()
    assert contract_err(ref, out, [nc]) < 1e-12 * np.abs(ref).max()
    assert not out[0, nf:, :].any() and not out[0, :, nf:].any()   # absent rows stay 0


def test_mixed_level_equals_single_front_calls():
    specs = [(192, 150, 190), (384, 300, 384), (256, 0, 200), (192, 33, 180),
             (1024, 40, 700), (256, 256, 256), (384, 1, 290)]
    buf, rows, _ = level_buffer(specs, seed=5)
    lvl = ldlt_kernels.build_wide_level(rows, "cpu")
    assert lvl.steps == 10 and lvl.fronts[0, 2] == 300      # heaviest first
    got = buf.clone()
    ldlt_kernels.partial_ldlt_wide(got, lvl)
    want = buf.clone()
    for r in rows:
        ldlt_kernels.partial_ldlt_wide(want, ldlt_kernels.build_wide_level([r], "cpu"))
    nan = torch.isnan(buf)
    assert torch.equal(got[~nan], want[~nan])
    assert bool(torch.isnan(got[nan]).all())          # nothing beyond nf is written
    for o, Fpad, nc, nf in rows:
        blk = got[o:o + Fpad * Fpad].view(Fpad, Fpad)[:nf, :nf]
        assert bool(torch.isfinite(blk).all())
        if 0 < nc < nf:                                # Schur block in both triangles
            S = blk[nc:, nc:]
            assert float((S - S.T).abs().max()) <= 1e-12 * float(S.abs().max())
    # a window of the buffer, with the table moved to it
    lo, hi = lvl.start, lvl.end
    win = buf[lo:hi].clone()
    ldlt_kernels.partial_ldlt_wide(win, lvl.shifted(-lo))
    assert torch.equal(win[~nan[lo:hi]], got[lo:hi][~nan[lo:hi]])


def test_flat_factorize_matches_the_jax_store():
    A = wide_plan()
    before = ldlt_kernels.wide_plain_count()
    rec = both(A, "natural", relax=4, shift=1e-3)
    holds(rec)
    levels = [lvp["wide"] for lvp in T._device_plan(rec["plan"], "cpu")["levels"]
              if lvp["wide"] is not None]
    assert ldlt_kernels.wide_plain_count() == before + len(levels) >= before + 1
    assert any(0 < nc < nf for lvl in levels for nc, nf in lvl.fronts[:, 2:4].tolist())
