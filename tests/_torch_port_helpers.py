"""Shared problem generators for the tests of the PyTorch port (tests/test_torch_*.py):
numpy-seeded inputs handed to both the JAX package and the port."""
import os

import numpy as np
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_DIR = os.path.join(REPO, "examples", "sweep")
SWEEP = sorted(f[:-6] for f in os.listdir(SWEEP_DIR) if f.endswith(".qplib"))


def sweep_path(name: str) -> str:
    return os.path.join(SWEEP_DIR, name + ".qplib")


def grid_laplacian(k: int):
    n = k * k
    idx = np.arange(n).reshape(k, k)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 4.0)]
    for a, b in ((idx[:, 1:], idx[:, :-1]), (idx[1:, :], idx[:-1, :])):
        rows += [a.ravel(), b.ravel()]
        cols += [b.ravel(), a.ravel()]
        vals += [np.full(a.size, -1.0)] * 2
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def grid_qp_arrays(k: int, seed: int = 0):
    """The flagship family at size k: (n, m, keyword arrays) for
    ``make_sparse_qp`` of either package."""
    rng = np.random.default_rng(seed)
    n = k * k
    m = n // 2
    idx = np.arange(n).reshape(k, k)
    ii = [np.arange(n)]
    jj = [np.arange(n)]
    vv = [np.full(n, 4.0)]
    for a, b in ((idx[:, 1:], idx[:, :-1]), (idx[1:, :], idx[:-1, :])):
        ii.append(np.maximum(a.ravel(), b.ravel()))
        jj.append(np.minimum(a.ravel(), b.ravel()))
        vv.append(np.full(a.size, -1.0))
    ii, jj, vv = map(np.concatenate, (ii, jj, vv))
    ar = np.repeat(np.arange(m), 2)
    ac = np.stack([np.arange(m), np.arange(m) + n - m]).T.reshape(-1)
    av = rng.uniform(0.5, 1.5, 2 * m)
    kw = dict(h_coo=(ii, jj, vv), a_coo=(ar, ac, av), g=rng.normal(size=n),
              c_l=np.full(m, 1.0), c_u=np.full(m, 1e20),
              x_l=np.zeros(n), x_u=np.full(n, 2.0))
    return n, m, kw


def kkt_pattern(h_pat, a_pat, n):
    """The combined KKT pattern both packages analyse (sbls.sparse_kkt_plan)."""
    m = a_pat.m
    rows = np.concatenate([np.asarray(h_pat.rows, np.int64),
                           np.asarray(a_pat.rows, np.int64) + n,
                           np.arange(n), n + np.arange(m)])
    cols = np.concatenate([np.asarray(h_pat.cols, np.int64),
                           np.asarray(a_pat.cols, np.int64),
                           np.arange(n), n + np.arange(m)])
    return rows, cols, n + m


def check_ipm_fixture(name: str, status: int):
    """Solve one sweep fixture with both packages' ``ipm_solve`` (default
    control) and hold the port to the reference: the same status (given,
    since not every fixture converges), the same iteration count and,
    where the status is 0, the objective within 1e-8 relative and x within
    1e-6."""
    from galahad_tpu.io import qplib as j_qplib
    from galahad_tpu.qp.ipm import IPMControl as JControl
    from galahad_tpu.qp.ipm import ipm_solve as j_solve

    from galahad_tpu_torch.io import qplib as t_qplib
    from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve

    xj, _, _, sj = j_solve(j_qplib.read_sparse_qp(sweep_path(name)), JControl())
    xt, _, _, st = ipm_solve(
        t_qplib.read_sparse_qp(sweep_path(name), device="cpu"), IPMControl())
    assert st.status == int(sj.status) == status
    assert st.iter == int(sj.iter)
    if st.status == 0:
        obj_j = float(sj.inform.obj)
        assert abs(obj_j - st.inform.obj) <= 1e-8 * max(1.0, abs(obj_j))
        assert np.abs(np.asarray(xj) - xt.numpy()).max() <= 1e-6


# ---------------------------------------------------------------------------
# The extend-add that flat_factorize ran before the level-wise kernel: the
# child records bucketed by padded shape (Um, fps) and split into occurrence
# layers of same-parent children, one gather-add per layer, padded positions
# routed to the store's spare slot.  Kept verbatim as the oracle (no JAX).
# ---------------------------------------------------------------------------

_EA_ELEMS = 1 << 24              # cap nc * Um^2 in one extend-add op


def _p2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def oracle_ea_ops(plan, device):
    """Per tree level (ascending), the bucket ops of the old extend-add."""
    import torch

    def t64(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)

    by_level = {}
    for g in plan.groups:
        by_level.setdefault(g.level, []).append(g)
    out = []
    for lv in sorted(by_level):
        ea_ops = []
        for g in by_level[lv]:
            Fd = g.Fpad
            if not g.ea:
                continue
            by_shape = {}
            for o in g.ea:
                Um = max(8, _p2(o["u"]))
                by_shape.setdefault((Um, o["fp_src"]), []).append(o)
            for (Um, fps), olist in sorted(by_shape.items()):
                layers = []
                seen = {}
                for o in olist:
                    j = seen.get(o["ppar"], 0)
                    seen[o["ppar"]] = j + 1
                    while len(layers) <= j:
                        layers.append([])
                    layers[j].append(o)
                cap = max(1, _EA_ELEMS // (Um * Um))
                for lay in layers:
                    for s0 in range(0, len(lay), cap):
                        sub = lay[s0:s0 + cap]
                        pt = np.full((len(sub), Um), -1, np.int64)
                        for k2, o in enumerate(sub):
                            pt[k2, :o["u"]] = o["ppos"]
                        ea_ops.append(dict(
                            Um=Um, fps=fps, Fd=Fd, nc=len(sub),
                            sstart=t64([o["sbase"] + o["sncols"] * fps
                                        + o["sncols"] for o in sub]),
                            pbase=t64([g.goff + o["ppar"] * Fd * Fd
                                       for o in sub]),
                            ppos=t64(pt)))
        out.append(ea_ops)
    return out


def oracle_ea_apply(store, o, S: int) -> None:
    """Extend-add of one bucket layer: each child's (u, u) Schur block is
    read from its front and added into its parent front at ``ppos``.
    Padded positions (ppos < 0) are routed to the spare slot ``S``, which
    holds 0 and receives 0.  Destinations are otherwise distinct, so the
    add is exact and ordered."""
    import torch

    Um, fps, Fd = o["Um"], o["fps"], o["Fd"]
    ar = torch.arange(Um, device=store.device)
    pp = o["ppos"]
    valid = pp >= 0
    mask = valid[:, :, None] & valid[:, None, :]
    src = (o["sstart"][:, None, None] + (ar * fps)[None, :, None]
           + ar[None, None, :])
    dst = (o["pbase"][:, None] + pp * Fd)[:, :, None] + pp[:, None, :]
    src = torch.where(mask, src, S).reshape(-1)
    dst = torch.where(mask, dst, S).reshape(-1)
    store.index_add_(0, dst, store.index_select(0, src))


def oracle_factorize(T, plan, vals):
    """``flat_factorize`` (module ``T``) with the old extend-add in place of
    the level-wise one; returns (factors, calls the new extend-add would
    have made)."""
    ops = iter(oracle_ea_ops(plan, vals.device))
    dev = T._device_plan(plan, vals.device)
    by_table = {id(lvp["ea"]): next(ops) for lvp in dev["levels"]}
    calls = []

    def old_extend_add(store, lvl):
        calls.append(lvl)
        for o in by_table[id(lvl)]:
            oracle_ea_apply(store, o, plan.S)

    saved = T.extend_add
    T.extend_add = old_extend_add
    try:
        fac = T.flat_factorize(plan, vals)
    finally:
        T.extend_add = saved
    return fac, len(calls)


def ea_synthetic_level(specs, seed, garbage=float("nan")):
    """A synthetic tree level for the extend-add: parents ``specs = [(Fd,
    [children per parent, ...][, umax]), ...]``, one group per ``Fd``; each
    child has ``u`` in 1..min(Fd, umax) drawn at random, a random strictly increasing ``ppos`` and a
    front of the smallest ladder size that holds ``sncols + u`` (``sncols`` in
    0..3), its Schur block random and ``garbage`` in every other entry of its
    front; parent entries that a child reaches are random, the others
    ``garbage``.  Returns (store as float64 numpy, batches for
    ``build_ea_level``, boolean mask of the reached parent entries)."""
    ladder = (8, 16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
              3072, 4096)
    rng = np.random.default_rng(seed)
    groups, kids = [], []
    off = 0
    for Fd, counts, *umax in specs:
        groups.append([off, Fd, []])
        for p, nkids in enumerate(counts):
            for _ in range(nkids):
                u = int(rng.integers(1, min([Fd] + umax) + 1))
                nc = int(rng.integers(0, 4))
                fps = next(f for f in ladder if f >= nc + u)
                ppos = np.sort(rng.choice(Fd, u, replace=False)).astype(np.int64)
                groups[-1][2].append(dict(sncols=nc, fp_src=fps, u=u, ppos=ppos, ppar=p))
                kids.append((groups[-1][2][-1], fps))
        off += len(counts) * Fd * Fd
    for o, fps in kids:
        o["sbase"] = off
        off += fps * fps
    store = np.full(off + 1, garbage)
    store[-1] = 0.0
    reached = np.zeros(off + 1, bool)
    for goff, Fd, recs in groups:
        for o in recs:
            pp = o["ppos"]
            dst = goff + o["ppar"] * Fd * Fd + pp[:, None] * Fd + pp[None, :]
            reached[dst.ravel()] = True
    store[reached] = rng.normal(size=int(reached.sum()))
    for o, fps in kids:
        nc, u = o["sncols"], o["u"]
        F = store[o["sbase"]:o["sbase"] + fps * fps].reshape(fps, fps)
        F[nc:nc + u, nc:nc + u] = rng.normal(size=(u, u))
    return store, [tuple(g) for g in groups], reached
