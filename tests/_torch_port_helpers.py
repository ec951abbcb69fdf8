"""Shared problem generators for the tests of the PyTorch port (tests/test_torch_*.py):
numpy-seeded inputs handed to both the JAX package and the port."""
import os

import numpy as np
import pytest
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


# ---------------------------------------------------------------------------
# Dense QPs for both packages
# ---------------------------------------------------------------------------


def random_convex_qp_arrays(n, m, seed, equalities=0, lp=False):
    """The arrays of tests/test_ipm.py::random_convex_qp (the same random
    stream, so the same problem): a dict for ``make_qp`` of the port and
    for the JAX ``QP``."""
    r = np.random.default_rng(seed)
    if lp:
        H, kind = None, "zero"
    else:
        B = r.normal(size=(n, n))
        H, kind = B @ B.T + 0.5 * np.eye(n), "dense"
    A = r.normal(size=(m, n))
    x_feas = r.uniform(0.2, 0.8, size=n)
    c_at = A @ x_feas
    c_l = np.where(np.arange(m) < equalities, c_at, c_at - r.uniform(0.5, 1.0, m))
    c_u = np.where(np.arange(m) < equalities, c_at, c_at + r.uniform(0.5, 1.0, m))
    return dict(H=H, h_kind=kind, g=r.normal(size=n), A=A, c_l=c_l, c_u=c_u,
                x_l=np.zeros(n), x_u=np.ones(n))


def dense_pair(arrays):
    """(JAX QP, the port's QP on the CPU) from ``random_convex_qp_arrays``-style
    arrays (``H`` may be None, ``A`` may have no rows)."""
    import jax.numpy as jnp
    from galahad_tpu.core.problem import QP as JQP

    from galahad_tpu_torch import make_qp

    a = dict(arrays)
    kind = a.pop("h_kind")
    j = JQP(H=None if a.get("H") is None else jnp.asarray(a["H"]), h_kind=kind,
            **{k: jnp.asarray(v) for k, v in a.items() if k != "H"})
    return j, make_qp(h_kind=kind, device="cpu", **a)


def check_same_solve(jsolve, tsolve, x_tol=1e-6):
    """Hold one port solve to the JAX package's: the same status and
    iteration count, the objective within 1e-8 relative and x within
    ``x_tol`` where the status is 0.  Each argument is an (x, y, z, state)
    tuple; the port's state is returned."""
    xj, _, _, sj = jsolve
    xt, _, _, st = tsolve
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter))
    if st.status == 0:
        obj_j = float(sj.inform.obj)
        assert abs(obj_j - st.inform.obj) <= 1e-8 * max(1.0, abs(obj_j))
        assert np.abs(np.asarray(xj) - xt.numpy()).max() <= x_tol
    return st


ARC_CASES = [("taylor", 2), ("taylor", 3), ("taylor", 4), ("puiseux", 2),
             ("puiseux", 3), ("zhao_sun", 2), ("zhao_sun", 3)]   # tests/test_ipm.py:268-271


def arc_controls(arc, order, **kw):
    """The same IPMControl in both packages: (JAX's, the port's)."""
    from galahad_tpu.qp.ipm import IPMControl as JControl

    from galahad_tpu_torch.qp.ipm import IPMControl

    return (JControl(arc=arc, series_order=order, **kw),
            IPMControl(arc=arc, series_order=order, **kw))


def sparse_grid_pair(k):
    """(JAX SparseQP, the port's on the CPU) of the grid QP of size k."""
    from galahad_tpu.core.sparse import make_sparse_qp as j_make

    from galahad_tpu_torch import make_sparse_qp

    n, m, kw = grid_qp_arrays(k)
    return j_make(n, m, **kw), make_sparse_qp(n, m, device="cpu", **kw)


def state_to_port(js):
    """The JAX package's IPMState as the port's (scalars as 0-d tensors)."""
    import dataclasses

    from galahad_tpu_torch.convert import ipm_state_from_numpy

    return ipm_state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                                 for f in dataclasses.fields(js)}, device="cpu")


FOLDED = dict(x="x_lo", c="c_lo", y="y_lo", z_l="zl_lo", z_u="zu_lo",
              y_l="yl_lo", y_u="yu_lo", s_l=None, s_u=None, t_l=None, t_u=None)


def check_steps_from_reference_states(jq, tq, jctl, ctl, tol=1e-10):
    """Every iteration of the JAX package's solve (its jitted ``ipm_step``),
    taken again by the port's ``ipm_step`` from the JAX state before it: the
    same iteration, status, halt flag, convergence flag and stall count,
    the residuals and every iterate (the JAX double-word pairs folded)
    within ``tol`` relative.  Returns the JAX package's last state."""
    from galahad_tpu.core.problem import classify_bounds as j_classify
    from galahad_tpu.qp import ipm as j_ipm

    from galahad_tpu_torch.core.problem import classify_bounds
    from galahad_tpu_torch.qp import ipm as t_ipm

    jm, tm = j_classify(jq), classify_bounds(tq)
    js = j_ipm.ipm_init(jq, jm, jctl)
    for _ in range(jctl.maxit):
        nxt = j_ipm._jitted_step(jq, jm, js, jctl, jq.h_kind)
        ts = t_ipm.ipm_step(tq, tm, state_to_port(js), ctl)
        for name in ("iter", "status", "halt", "converged", "stall"):
            assert int(getattr(ts, name)) == int(getattr(nxt, name)), name
        for name in ("res_p", "res_d", "res_c"):
            ref = float(getattr(nxt, name))
            assert abs(float(getattr(ts, name)) - ref) <= tol * max(1.0, abs(ref)), name
        for name, lo in FOLDED.items():
            ref = np.asarray(getattr(nxt, name), np.float64)
            if lo:
                ref = ref + np.asarray(getattr(nxt, lo), np.float64)
            got = getattr(ts, name).numpy()
            if ref.size:
                assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max()), name
        js = nxt
        if bool(js.halt):
            break
    return js



@pytest.fixture
def one_torch_thread():
    """Run a test with one torch thread (a module takes it with
    ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``): the suite
    runs several workers on the host's cores at once, and the dense
    LAPACK/BLAS calls of the port's CPU path slow down by an order of
    magnitude when every worker also starts a thread per core."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


_DENSE_FIXTURES = {}


def check_dense_fixture_arc(name, arc, order):
    """The sweep fixture ``name`` read by ``read_qp`` in both packages and
    solved with the series arc (arc, order): ``check_same_solve``, status 0."""
    from galahad_tpu.io import qplib as j_qplib
    from galahad_tpu.qp.ipm import ipm_solve as j_solve

    from galahad_tpu_torch.io import qplib as t_qplib
    from galahad_tpu_torch.qp.ipm import ipm_solve

    if name not in _DENSE_FIXTURES:
        _DENSE_FIXTURES[name] = (j_qplib.read_qp(sweep_path(name)),
                                 t_qplib.read_qp(sweep_path(name), device="cpu"))
    jq, tq = _DENSE_FIXTURES[name]
    jctl, ctl = arc_controls(arc, order)
    assert check_same_solve(j_solve(jq, jctl), ipm_solve(tq, ctl)).status == 0


# ---------------------------------------------------------------------------
# Banded QPs for both packages
# ---------------------------------------------------------------------------


def banded_problem_fields(n, lp=False, seed=0, block=4, h_tridiagonal=None, m=None):
    """tests/test_ipm_banded.py::make_banded_problem as numpy fields (the
    same random stream, so the same problem): tridiagonal H (2, -1) unless
    ``lp``, A with rows i -> variables {i, i+2} (values U(0.8, 1.2)),
    x in [0, 2], c_l = 1, g = -0.2 - 0.2 (i mod 5).  ``m=0``: no A."""
    r = np.random.default_rng(seed)
    m = n - 2 if m is None else m
    tri = not lp if h_tridiagonal is None else h_tridiagonal
    h_diags = (np.stack([np.full(n, 2.0), np.concatenate([-np.ones(n - 1), [0.0]])])
               if tri else None)
    fields = dict(g=-0.2 - 0.2 * (np.arange(n) % 5), x_l=np.zeros(n), x_u=np.full(n, 2.0),
                  c_l=np.ones(m), c_u=np.full(m, 1e20), h_diags=h_diags,
                  h_kind="banded" if tri else "zero", block=block, A_band=None)
    if m:
        a0 = r.uniform(0.8, 1.2, m)
        a2 = r.uniform(0.8, 1.2, m)
        fields["A_band"] = dict(val=np.stack([a0, a2]), offsets=(0, 2), m=m, n=n)
    return fields


def banded_pair(fields, dtype="float64"):
    """(JAX BandedQP, the port's BandedQP on the CPU) from
    ``banded_problem_fields``-style numpy fields."""
    import jax.numpy as jnp
    from galahad_tpu.linalg.band_ops import BandMatrix
    from galahad_tpu.qp.ipm_banded import BandedQP

    from galahad_tpu_torch.convert import banded_qp_from_numpy

    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    arr = lambda a: None if a is None else jnp.asarray(a, jdt)          # noqa: E731
    a = fields["A_band"]
    jq = BandedQP(
        g=arr(fields["g"]), c_l=arr(fields["c_l"]), c_u=arr(fields["c_u"]),
        x_l=arr(fields["x_l"]), x_u=arr(fields["x_u"]), h_diags=arr(fields["h_diags"]),
        h_kind=fields["h_kind"], block=fields["block"],
        A_band=None if a is None else BandMatrix(val=arr(a["val"]), offsets=tuple(a["offsets"]),
                                                 m=a["m"], n=a["n"]))
    return jq, banded_qp_from_numpy(fields, dtype=dtype, device="cpu")


def check_same_banded_solve(jsolve, jq, tsolve, tol=1e-7):
    """Hold a port banded solve to the JAX package's: the same status and
    iteration count, and x, y, z and the objective within ``tol`` absolute.
    Each solve is an (x, y, z, state) tuple; the port's state is returned."""
    xj, yj, zj, sj = jsolve
    xt, yt, zt, st = tsolve
    assert (st.status, st.iter) == (int(sj.status), int(sj.iter))
    for a, b in ((xj, xt), (yj, yt), (zj, zt)):
        assert np.asarray(a).shape == tuple(b.shape)
        if b.numel():
            assert np.abs(np.asarray(a, np.float64) - b.double().numpy()).max() <= tol
    obj_j = float(jq.objective(xj))
    if st.inform is not None:
        assert abs(st.inform.obj - obj_j) <= tol
    return st


F_ROUNDING = 1e-13


def f_off(ref, got, rel: float) -> float:
    """The largest |got - ref| over objective values, in units of the
    allowance rel |ref| + F_ROUNDING sqrt(|ref|): <= 1 holds.  Near a
    minimizer of a sum of squares f carries ~sqrt(2 f) times its residuals'
    own rounding (a few eps of their terms), so a relative check alone asks
    for bits that neither package has as f goes to 0 (F_ROUNDING is ~450
    eps; the NLP parity cases need up to ~9 eps)."""
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got, np.float64)
    allowance = rel * np.abs(ref) + F_ROUNDING * np.sqrt(np.abs(ref))
    return float(np.max(np.abs(got - ref) / np.maximum(allowance, np.finfo(np.float64).tiny)))


def loop_reads(iter_max: int, maxit: int) -> int:
    """The host reads of the NLP outer loop (``nlp/_loop.py::outer_loop``),
    which reads the flags before every pass: one per pass of the slowest
    problem plus the read that finds none active, or ``maxit`` where the cap
    ends the loop."""
    return maxit if iter_max >= maxit else iter_max + 1


def rel(ref, got) -> float:
    """max |ref - got| / max(1, max |ref|): ``ref`` array-like (the JAX
    package's value), ``got`` a tensor or array-like of the same shape."""
    import torch

    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max())) if ref.size else 0.0


def x_minus_tg_exact(x, t, g):
    """x - t g of float64 arrays, rounded once (exact rational arithmetic):
    the fused multiply-add that XLA contracts x - t * g into."""
    from fractions import Fraction

    return np.array([float(Fraction(a) - Fraction(b) * Fraction(c))
                     for a, b, c in zip(np.ravel(x), np.ravel(t), np.ravel(g))]).reshape(
                         np.shape(x))


def arc_inputs(size=4096, seed=0):
    """(x, t, g) float64 triples of the scale of a Cauchy arc's."""
    r = np.random.default_rng(seed)
    return r.uniform(-5.0, 5.0, size), r.uniform(0.0, 1.0, size), 10.0 * r.normal(size=size)

