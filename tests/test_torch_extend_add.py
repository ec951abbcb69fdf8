"""The level-wise extend-add of the port's flat factorization
(galahad_tpu_torch/linalg/ea_kernels.py), as far as the CPU can run it: the
plain PyTorch version that the CUDA kernel of csrc/extend_add.cu is held
against on the card, and the tables both read.

* the plain version against the JAX package's bucket functions
  ``_ea_slot_apply`` and ``_ea_q_apply``, called directly on one numpy-seeded
  store.  Tolerance 1e-12 relative in float64: the JAX side sums the children
  of a parent inside a one-hot matrix product;
* the plain version against the bucketed composition that ``flat_factorize``
  ran before (``oracle_ea_apply`` in _torch_port_helpers.py): the same bits
  after a whole factorization, since both add the children of a parent one at
  a time in the same order;
* NaN outside every child's Schur block and in every parent entry that no
  child reaches changes nothing;
* a numpy walk of the kernel's tiles and pairs, as the kernel's warps and
  lanes walk them, gives the plain version's bits and reads nothing off the
  contract; every destination entry is owned by one lane of one warp;
* the table's invariants, the operand checks, no fallback for a tensor that is
  not on the CPU, and the bound.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from galahad_tpu.linalg import supernodal_flat as J

from galahad_tpu_torch.io.qplib import read_sparse_qp
from galahad_tpu_torch.linalg import ea_kernels as E
from galahad_tpu_torch.linalg import supernodal_flat as T

from _torch_port_helpers import (ea_synthetic_level, grid_qp_arrays, oracle_factorize,
                                 sweep_path)


def grid_kkt(k):
    """KKT matrix [[H + I, A^T], [A, -I]] of the flagship family at size k."""
    n, m, kw = grid_qp_arrays(k)
    hi, hj, hv = kw["h_coo"]
    ai, aj, av = kw["a_coo"]
    H = sp.coo_matrix((hv, (hi, hj)), shape=(n, n)).tocsr()
    H = H + sp.tril(H, -1).T + sp.eye(n)
    A = sp.coo_matrix((av, (ai, aj)), shape=(m, n)).tocsr()
    return sp.bmat([[H, A.T], [A, -sp.eye(m)]]).tocsr()


def fixture_kkt(name):
    """KKT matrix [[H + I, A^T], [A, -I]] of a sweep fixture."""
    q = read_sparse_qp(sweep_path(name), device="cpu")
    n, m = q.n, q.m
    H = sp.coo_matrix((q.h_vals.numpy(), (q.h_pat.rows, q.h_pat.cols)), shape=(n, n)).tocsr()
    H = H + sp.tril(H, -1).T + sp.eye(n)
    A = sp.coo_matrix((q.a_vals.numpy(), (q.a_pat.rows, q.a_pat.cols)), shape=(m, n)).tocsr()
    return sp.bmat([[H, A.T], [A, -sp.eye(m)]]).tocsr()


CASES = {
    "grid_kkt20": (lambda: grid_kkt(20), 16),
    "QPEQ": (lambda: fixture_kkt("QPEQ"), 4),
    "LPTALL": (lambda: fixture_kkt("LPTALL"), 4),
}


def analysed(case):
    make, relax = CASES[case]
    A = sp.tril(sp.csr_matrix(make())).tocoo()
    return A, T.flat_analyse(A.row, A.col, A.shape[0], relax_cols=relax)


# ---------------------------------------------------------------------------
# (a) against the JAX package's bucket functions
# ---------------------------------------------------------------------------


def jax_extend_add(store, batches, kind):
    """The children of ``batches`` through the JAX package's ``_ea_q_apply``
    (every bucket of one padded shape in one call) or ``_ea_slot_apply`` (one
    call per occurrence layer of a bucket), bucketed as the JAX plan does."""
    s = jnp.asarray(store)
    i32 = lambda a: jnp.asarray(np.asarray(a, np.int64), jnp.int32)
    for goff, Fd, recs in batches:
        ch = 1 + max(o["ppar"] for o in recs)
        buckets = {}
        for o in recs:
            Um = max(8, E._p2(o["u"]))
            buckets.setdefault((Um, o["fp_src"]), []).append(o)
        for (Um, fps), olist in sorted(buckets.items()):
            start = lambda o: o["sbase"] + o["sncols"] * fps + o["sncols"]
            if kind == "q":
                pt = np.full((len(olist), Um), -1, np.int64)
                for k, o in enumerate(olist):
                    pt[k, :o["u"]] = o["ppos"]
                s = J._ea_q_apply(s, goff, i32([start(o) for o in olist]), i32(pt),
                                  i32([o["ppar"] for o in olist]), len(olist), ch, Fd,
                                  Um, fps, s.dtype)
                continue
            layers, seen = [], {}
            for o in olist:
                j = seen.get(o["ppar"], 0)
                seen[o["ppar"]] = j + 1
                if len(layers) <= j:
                    layers.append([])
                layers[j].append(o)
            for lay in layers:
                starts = np.zeros(ch, np.int64)
                pt = np.full((ch, Um), -1, np.int64)
                for o in lay:
                    starts[o["ppar"]] = start(o)
                    pt[o["ppar"], :o["u"]] = o["ppos"]
                s = J._ea_slot_apply(s, goff, i32(starts), i32(pt), ch, Fd, Um, fps,
                                     s.dtype)
    return np.asarray(s)


@pytest.mark.parametrize("kind", ["q", "slot"])
@pytest.mark.parametrize("Fd", [8, 32, 96, 192])
def test_plain_matches_the_jax_package_bucket_functions(Fd, kind):
    # finite values everywhere: the JAX side reads whole windows and masks them
    # by multiplying with zeros
    store, batches, _ = ea_synthetic_level([(Fd, [1, 2, 4, 16, 3])], seed=Fd, garbage=0.25)
    # room after the last child for the JAX side's window of Um x fps entries
    store = np.concatenate([store, np.zeros(2 * 4096 * 256)])
    ref = jax_extend_add(store, batches, kind)
    got = torch.as_tensor(store)
    E.extend_add(got, E.build_ea_level(batches, "cpu"))
    got = got.numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# (b) against the bucketed composition it replaced
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_is_bitwise_the_bucketed_composition(case):
    A, plan = analysed(case)
    vals = torch.as_tensor(A.data)
    levels = [lvp["ea"] for lvp in T._device_plan(plan, torch.device("cpu"))["levels"]]
    assert sum(lvl is not None for lvl in levels) >= 2
    before = E.ea_counts()
    fac = T.flat_factorize(plan, vals)
    after = E.ea_counts()
    old, calls = oracle_factorize(T, plan, vals)
    assert torch.equal(fac.store, old.store)
    assert calls == sum(lvl is not None for lvl in levels)
    assert after["plain"] - before["plain"] == calls
    assert after["calls"] == before["calls"]                 # no kernel on the CPU
    assert fac.inertia.tolist() == old.inertia.tolist()


# ---------------------------------------------------------------------------
# (c) NaN where no child block or destination lies
# ---------------------------------------------------------------------------


def dense_reference(store, batches):
    """Every child added in the table's order into a numpy copy, entry by entry
    in Python floats of the store's type."""
    out = store.copy()
    lvl = E.build_ea_level(batches, "cpu")
    pp = lvl.ppos.numpy().astype(np.int64)
    for sstart, fps, u, pbase, Fd, po in lvl.children:
        p = pp[po:po + u]
        C = out[sstart + np.arange(u)[:, None] * fps + np.arange(u)[None, :]]
        dst = pbase + p[:, None] * Fd + p[None, :]
        out[dst] = out[dst] + C
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nan_outside_the_blocks_changes_nothing(dtype):
    specs = [(8, [1, 2, 4, 16]), (32, [3, 1, 16]), (128, [2, 4])]
    nan_store, batches, reached = ea_synthetic_level(specs, seed=5)
    fin_store, batches2, reached2 = ea_synthetic_level(specs, seed=5, garbage=3.5)
    assert np.array_equal(reached, reached2)
    outs = []
    for store, b in ((nan_store, batches), (fin_store, batches2)):
        t = torch.as_tensor(store.astype(dtype))
        E.extend_add(t, E.build_ea_level(b, "cpu"))
        outs.append(t.numpy())
        ref = dense_reference(store.astype(dtype), b)
        assert np.array_equal(t.numpy(), ref, equal_nan=True)
    assert np.isfinite(outs[0][reached]).all()
    assert np.array_equal(outs[0][reached], outs[1][reached])
    # what is neither a destination nor a source keeps what it held
    untouched = ~reached & np.isnan(nan_store)
    assert np.isnan(outs[0][untouched]).all()
    assert (outs[1][untouched] == 3.5).all()


# ---------------------------------------------------------------------------
# The kernel's walk of its tables, in numpy
# ---------------------------------------------------------------------------


def warp_tiles(lvl):
    """The kernel's share-out of the tiles, as ``extend_add_kernel`` computes it
    from ``classes``: per warp, per lane, (tile or -1, lane's column)."""
    n32, n16, n8 = lvl.classes
    out = []
    for first, count, width in ((0, n32, 32), (n32, n16, 16), (n32 + n16, n8, 8)):
        per = 32 // width
        for w in range(-(-count // per)):
            lane = np.arange(32)
            t = first + w * per + lane // width
            out.append((np.where(t < first + count, t, -1), lane % width))
    return out


def tables_walk(store, lvl, reads=None):
    """What csrc/extend_add.cu computes, warp by warp and lane by lane: each
    tile's pair records taken once; a lane's touched rows from the records'
    masks; its column's 16 rows loaded with unreached rows clamped onto the
    first touched row; per pair, every row load issued (a row the child does
    not reach reads the child's next row in the tile, or its last) and only the
    reached ones added, in the pairs' order; each reached entry written once.
    ``reads``, if given, is a boolean mask of the store that every load marks."""
    rows_of = lvl.tiles.numpy()
    pairs = lvl.pairs.numpy()
    tiles = np.stack(lvl.tile_fields(), axis=1)
    R = E.ROWS
    below = lambda mask, k: bin(mask & ((1 << k) - 1)).count("1")

    def load(i):
        if reads is not None:
            reads[i] = True
        return store[i]

    for tile_of_lane, col in warp_tiles(lvl):
        for t, c in zip(tile_of_lane.tolist(), col.tolist()):
            if t < 0:
                continue
            dst, Fd, first, npairs = (int(x) for x in tiles[t])
            # the first INLINE records from the tile's row, the rest from pairs
            inline = rows_of[t, 4:4 + 2 * E.INLINE].reshape(E.INLINE, 2)[:npairs]
            recs = []
            for src, word in inline.tolist() + pairs[first + E.INLINE:first + npairs].tolist():
                word &= 0xFFFFFFFFFFFFFFFF
                recs.append((src, word & 0xFFFF, (word >> 16) & 0xFFFF, word >> 32))
            touched = 0
            for _, _, rows, cols in recs:
                if cols >> c & 1:
                    touched |= rows
            if not touched:
                continue
            t0 = (touched & -touched).bit_length() - 1
            acc = [load(dst + c + (r if touched >> r & 1 else t0) * Fd) for r in range(R)]
            for src, fps, rows, cols in recs:
                if not cols >> c & 1:
                    continue
                last = bin(rows).count("1") - 1
                base = src + below(cols, c)
                v = [load(base + min(below(rows, r), last) * fps) for r in range(R)]
                for r in range(R):
                    if rows >> r & 1:
                        acc[r] = acc[r] + v[r]
            for r in range(R):
                if touched >> r & 1:
                    store[dst + c + r * Fd] = acc[r]


def readable(store_size, lvl):
    """The store entries the contract lets the kernel read: every child's
    Schur block and every destination entry."""
    ok = np.zeros(store_size, bool)
    pp = lvl.ppos.numpy().astype(np.int64)
    for sstart, fps, u, pbase, Fd, po in lvl.children:
        p = pp[po:po + u]
        ok[(sstart + np.arange(u)[:, None] * fps + np.arange(u)[None, :]).ravel()] = True
        ok[(pbase + p[:, None] * Fd + p[None, :]).ravel()] = True
    return ok


WALK_SPECS = {
    "small": [(8, [1, 2, 4, 16, 0, 3]), (16, [2, 5])],
    "mid": [(32, [1, 16, 2]), (96, [4, 1])],
    "wide": [(192, [2, 16]), (512, [1, 4])],
    # more pairs in a tile than a warp has lanes
    "heavy": [(64, [40, 40, 33], 64)],
    # odd counts of parents of 8, 16 and 64 in one level
    "packed": [(8, [3, 1, 5, 2, 9]), (16, [2, 7, 1]), (64, [3, 1, 2, 1, 4], 40)],
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(WALK_SPECS))
def test_the_tables_drive_the_extend_add_as_the_kernel_walks_them(case, dtype):
    store, batches, reached = ea_synthetic_level(WALK_SPECS[case], seed=len(case))
    store = store.astype(dtype)
    lvl = E.build_ea_level(batches, "cpu")
    walked = store.copy()
    reads = np.zeros(len(store), bool)
    tables_walk(walked, lvl, reads)
    plain = torch.as_tensor(store.copy())
    E.extend_add(plain, lvl)
    assert np.array_equal(walked, plain.numpy(), equal_nan=True)
    assert np.isfinite(walked[reached]).all()
    assert not (reads & ~readable(len(store), lvl)).any()    # nothing off the contract


def test_the_tables_drive_a_factorization_as_the_kernel_walks_them():
    A, plan = analysed("grid_kkt20")
    dev = T._device_plan(plan, torch.device("cpu"))
    fac = T.flat_factorize(plan, torch.as_tensor(A.data))
    for lvp in dev["levels"]:
        if lvp["ea"] is None:
            continue
        walked = fac.store.numpy().copy()
        tables_walk(walked, lvp["ea"])
        plain = fac.store.clone()
        E.extend_add(plain, lvp["ea"])
        assert np.array_equal(walked, plain.numpy())


# ---------------------------------------------------------------------------
# (d) the table
# ---------------------------------------------------------------------------


def check_table(batches, lvl):
    """Each child appears once; the children of a parent are contiguous, in the
    order (Um, fps) then as recorded; ranks count them; the tiles are disjoint,
    hold their pairs in the children's order, and the pairs' masks are the
    child's positions in the tile."""
    expect = {}
    for goff, Fd, recs in batches:
        for k, o in enumerate(recs):
            pbase = goff + o["ppar"] * Fd * Fd
            key = (max(8, E._p2(o["u"])), o["fp_src"], k)     # the bucketed order
            start = o["sbase"] + o["sncols"] * o["fp_src"] + o["sncols"]
            expect.setdefault(pbase, []).append((key, start, o))
    ch = lvl.children
    assert len(ch) == sum(len(v) for v in expect.values())
    pp = lvl.ppos.numpy()
    seen_parents = []
    for k in range(len(ch)):
        if k == 0 or ch[k, 3] != ch[k - 1, 3]:
            assert ch[k, 3] not in seen_parents               # contiguous
            seen_parents.append(ch[k, 3])
            kids = sorted(expect[ch[k, 3]], key=lambda e: e[0])
            for r, (_, start, o) in enumerate(kids):
                row = ch[k + r]
                assert lvl.rank[k + r] == r
                assert tuple(row[:3]) == (start, o["fp_src"], o["u"])
                assert np.array_equal(pp[row[5]:row[5] + row[2]], o["ppos"])
    assert sorted(seen_parents) == sorted(expect)
    # the work list, rebuilt child by child: one pair per (child, tile reached),
    # a tile ROWS rows of the parent by TILE columns
    want = {}
    for k, (sstart, fps, u, pbase, Fd, po) in enumerate(ch):
        p = pp[po:po + u].astype(np.int64)
        for rb in np.unique(p // E.ROWS):
            for cb in np.unique(p // E.TILE):
                rows = np.flatnonzero(p // E.ROWS == rb)
                cols = np.flatnonzero(p // E.TILE == cb)
                rm = sum(1 << int(x % E.ROWS) for x in p[rows])
                cm = sum(1 << int(x % E.TILE) for x in p[cols])
                word = int(fps) | rm << 16 | cm << 32
                want.setdefault((pbase + rb * E.ROWS * Fd + cb * E.TILE, Fd), []).append(
                    (int(sstart + rows[0] * fps + cols[0]),
                     word - (1 << 64) if word >= 1 << 63 else word))
    lanes = lambda Fd: 8 if Fd <= 8 else 16 if Fd <= 16 else 32
    order = sorted(want, key=lambda key: (-lanes(key[1]), -len(want[key]), key[0]))
    assert lvl.classes == tuple(sum(lanes(Fd) == n for _, Fd in want) for n in (32, 16, 8))
    first = np.cumsum([0] + [len(want[key]) for key in order])
    rows = []
    for i, key in enumerate(order):
        inline = [x for r in (want[key] + [(0, 0)] * E.INLINE)[:E.INLINE] for x in r]
        rows.append([key[0], key[1] | len(want[key]) << 32, int(first[i]), 0] + inline)
    assert lvl.tiles.numpy().tolist() == rows
    assert [tuple(r) for r in lvl.pairs.numpy().tolist()] == \
        [r for key in order for r in want[key]]


def test_table_keeps_each_parent_s_children_together_in_order():
    specs = [(8, [1, 2, 4, 16, 0, 3]), (32, [16, 1]), (192, [3, 2])]
    _, batches, _ = ea_synthetic_level(specs, seed=3)
    check_table(batches, E.build_ea_level(batches, "cpu"))


@pytest.mark.parametrize("case", sorted(WALK_SPECS))
def test_every_destination_has_one_lane_and_packed_parents_share_none(case):
    """Over the kernel's share-out of the tiles (warp, lane -> tile, column):
    every destination entry is owned by exactly one lane of one warp, a lane
    owns entries of one parent only, and a tile's pairs never reach past its
    own lanes' columns or rows."""
    _, batches, reached = ea_synthetic_level(WALK_SPECS[case], seed=len(case))
    lvl = E.build_ea_level(batches, "cpu")
    tiles, pairs = np.stack(lvl.tile_fields(), axis=1), lvl.pairs.numpy()
    owners = np.zeros(len(reached), np.int64)
    parent_of = {}
    for goff, Fd, recs in batches:
        for o in recs:
            parent_of[goff + o["ppar"] * Fd * Fd] = (goff + o["ppar"] * Fd * Fd, Fd)
    share = warp_tiles(lvl)
    assert len(share) == lvl.warps
    seen = set()
    for w, (tile_of_lane, col) in enumerate(share):
        for lane, (t, c) in enumerate(zip(tile_of_lane.tolist(), col.tolist())):
            if t < 0:
                continue
            assert (t, c) not in seen                       # one lane per tile column
            seen.add((t, c))
            dst, Fd, first, n = (int(x) for x in tiles[t])
            width = 8 if Fd <= 8 else 16 if Fd <= 16 else 32
            assert (w < lvl.classes[0]) == (width == 32)
            base = max(b for b in parent_of if b <= dst)
            off = dst - base                                 # a tile of its own parent
            assert parent_of[base][1] == Fd and off < Fd * Fd
            assert (off // Fd) % E.ROWS == 0 and (off % Fd) % E.TILE == 0
            words = [int(x) & 0xFFFFFFFFFFFFFFFF for x in pairs[first:first + n, 1]]
            assert all(wd >> 32 < 1 << width for wd in words)    # the tile's own lanes
            touched = 0
            for wd in words:
                if wd >> 32 >> c & 1:
                    touched |= (wd >> 16) & 0xFFFF
            for r in range(E.ROWS):
                if touched >> r & 1:
                    owners[dst + c + r * Fd] += 1
    assert (owners[reached] == 1).all() and (owners[~reached] == 0).all()


def test_table_of_a_factorization_level():
    _, plan = analysed("QPEQ")
    by_level = {}
    for g in plan.groups:
        by_level.setdefault(g.level, []).append(g)
    dev = T._device_plan(plan, torch.device("cpu"))
    checked = 0
    for (lv, groups), lvp in zip(sorted(by_level.items()), dev["levels"]):
        batches = [(g.goff, g.Fpad, g.ea) for g in groups if g.ea]
        assert (lvp["ea"] is None) == (not batches)
        if batches:
            check_table(batches, lvp["ea"])
            checked += 1
    assert checked >= 2


def test_the_kernel_source_reads_the_layout_the_tables_write():
    """The table layout that csrc/extend_add.cu reports through
    ``extend_add_layout`` (held against these constants when the wrapper loads
    the library on the card) is the one ``build_ea_level`` writes."""
    path = Path(E.__file__).resolve().parents[1] / "csrc" / "extend_add.cu"
    src = path.read_text()
    defs = dict(re.findall(r"^#define (\w+) +(.+?)(?: +//.*)?$", src, re.M))
    body = re.search(r"extend_add_layout\(int\* out\)\s*\{(.*?)\}", src, re.S).group(1)
    reported = dict(re.findall(r"out\[(\d)\] = (\w+);", body))

    def value(expr):
        while re.search(r"[A-Z_]{2,}", expr):
            expr = re.sub(r"[A-Z_]{2,}", lambda m: f"({defs[m.group(0)]})", expr)
        return eval(expr, {})

    assert tuple(value(reported[str(i)]) for i in range(4)) == \
        (E.ROWS, E.TILE, E.INLINE, E.TILE_WORDS)
    _, batches, _ = ea_synthetic_level(WALK_SPECS["packed"], seed=1)
    assert E.build_ea_level(batches, "cpu").tiles.shape[1] == E.TILE_WORDS


# ---------------------------------------------------------------------------
# Operands, no fallback, bound
# ---------------------------------------------------------------------------


def test_extend_add_checks_its_operands():
    store, batches, _ = ea_synthetic_level([(16, [2, 3])], seed=1)
    lvl = E.build_ea_level(batches, "cpu")
    t = torch.as_tensor(store)
    E.extend_add(t, lvl)                                     # this one is taken
    with pytest.raises(ValueError):                          # not flat
        E.extend_add(t.view(1, -1), lvl)
    with pytest.raises(ValueError):                          # the store is too short
        E.extend_add(t[:100], lvl)
    with pytest.raises(ValueError):                          # tables on another device
        E.extend_add(t, E.build_ea_level(batches, "meta"))
    recs = batches[0][2]
    with pytest.raises(ValueError):                          # ppos not increasing
        E.build_ea_level([(0, 16, [dict(recs[0], u=2, ppos=np.array([5, 3]))])], "cpu")
    with pytest.raises(ValueError):                          # ppos outside the parent
        E.build_ea_level([(0, 16, [dict(recs[0], u=1, ppos=np.array([16]))])], "cpu")
    with pytest.raises(ValueError):                          # block outside the front
        E.build_ea_level(
            [(0, 16, [dict(recs[0], u=1, ppos=np.array([3]), sncols=8, fp_src=8)])], "cpu")
    with pytest.raises(ValueError):                          # u and ppos disagree
        E.build_ea_level([(0, 16, [dict(recs[0], u=2, ppos=np.array([3]))])], "cpu")
    with pytest.raises(ValueError):                          # no children
        E.build_ea_level([(0, 16, [])], "cpu")


def test_extend_add_does_not_fall_back(monkeypatch):
    """Tensors that are not on the CPU must reach the kernel path (and fail
    here for want of a card), never the plain version."""
    called = []
    monkeypatch.setattr(E, "extend_add_plain", lambda *a, **k: called.append(1))
    _, batches, _ = ea_synthetic_level([(16, [2, 3])], seed=1)
    lvl = E.build_ea_level(batches, "meta")
    store = torch.zeros(lvl.store_end + 1, dtype=torch.float64, device="meta")
    before = E.ea_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        E.extend_add(store, lvl)
    assert called == [] and E.ea_counts() == before


def test_ea_bound_counts_bytes_and_operations():
    # one parent of 8; child a reaches rows/columns {0, 2, 5}, child b {2, 3}:
    # 9 + 4 entries read, 9 + 4 - 1 distinct destinations
    recs = [dict(sbase=64, sncols=1, fp_src=8, u=3, ppos=np.array([0, 2, 5]), ppar=0),
            dict(sbase=128, sncols=0, fp_src=8, u=2, ppos=np.array([2, 3]), ppar=0)]
    lvl = E.build_ea_level([(0, 8, recs)], "cpu")
    assert lvl.dest_entries == 12
    tb, to = E.ea_bound_terms(lvl, torch.float64)
    assert to == pytest.approx(13 / E.H100_FLOPS[torch.float64])
    assert tb == pytest.approx(((13 + 2 * 12) * 8 + 5 * 4 + 2 * 6 * 8) / E.H100_BYTES_PER_S)
    ms, by = E.ea_bound_ms([lvl, lvl], torch.float64)
    assert by == "bytes" and ms == pytest.approx(2 * tb * 1e3)
    assert E.ea_bound_ms(lvl, torch.float32)[0] < E.ea_bound_ms(lvl, torch.float64)[0]
