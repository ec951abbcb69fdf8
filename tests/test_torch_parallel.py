"""The port's multi-device layer (galahad_tpu_torch/parallel/) against the
JAX package's (galahad_tpu/parallel/), on the CPU.

The JAX side runs on the conftest's eight host-platform devices; the port's
on ``make_mesh(devices=["cpu"] * 8)``: eight slots on one device, so each
shard's work and the fixed-order sums are checked, not traffic between
devices.  Mirrors tests/test_parallel.py, at its sizes:

- the mesh shapes, and the refusals (a batch axis that does not divide the
  devices; no CUDA device and no ``devices=``);
- ``batch_ipm_solve`` on test_parallel.py's 8 stacked QPs (one vmapped step
  per shard): status and iterations equal, x within 1e-10, on a mesh of one
  problem a slot, of two, and with no mesh;
- ``model_sharded_step`` on test_parallel.py's QP with the model axis 8:
  every state field within 1e-12 (relative to max(1, max |field|)) of the
  JAX package's and of the port's unsharded ``ipm_step``;
- both ``TestBlockAngularSchur`` problems: x and y within 1e-12;
- ``build_strip_grid_kkt(8, 3, 8)``: the same arrays bit for bit;
  ``sharded_kkt_solve`` within 1e-12 of the JAX package's, two runs bitwise;
- the strip check: a pattern whose rows agree with strip 0's and whose
  columns differ is refused (the JAX package compares the rows only,
  galahad_tpu/parallel/supernodal_mesh.py:125, and accepts it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.parallel import batch_ipm_solve as jax_batch_ipm_solve
from galahad_tpu.parallel import make_mesh as jax_make_mesh
from galahad_tpu.parallel import model_sharded_step as jax_model_sharded_step
from galahad_tpu.qp.ipm import IPMControl as JaxIPMControl

from galahad_tpu_torch.parallel import (batch_ipm_solve, block_angular_residual,
                                        block_angular_solve, make_mesh, model_sharded_step)
from galahad_tpu_torch.qp.ipm import TENSOR_FIELDS, IPMControl
from _torch_port_helpers import one_torch_thread  # noqa: F401
from test_ipm import random_convex_qp

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU8 = ["cpu"] * 8


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0) / max(1.0, np.max(np.abs(want),
                                                                            initial=0.0)))


@pytest.mark.parametrize("n, batch", [(8, 4), (8, 8), (8, 1), (4, 2)])
def test_mesh_shapes(n, batch):
    mesh = make_mesh(n, batch=batch, devices=CPU8)
    assert mesh.shape == jax_make_mesh(n, batch=batch).shape
    assert mesh.devices.shape == (batch, n // batch)
    assert mesh.axis_devices("model") == [torch.device("cpu")] * (n // batch)


def test_mesh_refusals():
    with pytest.raises(ValueError):
        jax_make_mesh(8, batch=3)
    with pytest.raises(ValueError):
        make_mesh(8, batch=3, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()                     # no card and no devices=: no CPU fallback


@pytest.fixture(scope="module")
def stacked_qps():
    """test_parallel.py's 8 stacked QPs, and the JAX package's batched solve."""
    n, m, batch = 6, 3, 8
    qps = [random_convex_qp(n, m, 200 + s) for s in range(batch)]
    cols = tuple(np.stack([np.asarray(getattr(q, f)) for q in qps])
                 for f in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u"))
    xs, _, _, st = jax_batch_ipm_solve(*(jnp.asarray(c) for c in cols),
                                       ctl=JaxIPMControl(maxit=60),
                                       mesh=jax_make_mesh(8, batch=8))
    return cols, np.array(xs), np.array(st.status), np.array(st.iter)


@pytest.mark.parametrize("layout", ["one_a_slot", "two_a_slot", "no_mesh"])
def test_batch_ipm_solve_matches_jax(stacked_qps, layout):
    cols, jax_x, jax_status, jax_iter = stacked_qps
    mesh = dict(one_a_slot=make_mesh(devices=CPU8), two_a_slot=make_mesh(8, batch=4,
                                                                         devices=CPU8),
                no_mesh=None)[layout]
    xs, ys, zs, st = batch_ipm_solve(*cols, ctl=IPMControl(maxit=60), mesh=mesh, device="cpu")
    assert st.status.tolist() == jax_status.tolist() == [0] * 8
    assert st.iter.tolist() == jax_iter.tolist()
    assert float((xs - torch.as_tensor(jax_x)).abs().max()) <= 1e-10
    runs = st.run if isinstance(st.run, list) else [st.run]
    assert len(runs) == (1 if mesh is None else mesh.shape["batch"])
    assert all(r.path == "direct" for r in runs)


def test_masked_shift_escalation_keeps_the_host_loops_bits():
    """``chol_factor_shifted(masked=True)`` (every try made, the first that
    succeeds kept by a select: the batched step's form) gives the host loop's
    factor, shift and flag bit for bit, on a matrix that a later try rescues
    (least eigenvalue -1e-12), one that needs none and one that no try
    rescues."""
    from galahad_tpu_torch.linalg.cholesky import chol_factor_shifted

    r = np.random.default_rng(4)
    Q, _ = np.linalg.qr(r.normal(size=(6, 6)))
    cases = [(Q @ np.diag([-1e-12, 1, 2, 3, 4, 5]) @ Q.T, True), (Q @ Q.T, True),
             (-np.eye(6), False)]
    for M, rescued in cases:
        M = torch.as_tensor(M)
        L, s, ok = chol_factor_shifted(M, 0.0, max_tries=4)
        Lm, sm, okm = chol_factor_shifted(M, 0.0, max_tries=4, masked=True)
        assert bool(ok) == bool(okm) == rescued
        assert torch.equal(L, Lm) and torch.equal(s, sm)
    assert float(chol_factor_shifted(torch.as_tensor(cases[0][0]), 0.0)[1]) > 0


def test_batched_solve_escalates_only_the_flagged_problems():
    """Every other problem has a free variable on a zero row of H and a zero
    column of A, so its first Cholesky try fails at every step: the batched
    solve takes those steps again with the masked shift, and every problem
    gets its single solve's status, iterations and x (1e-10)."""
    from galahad_tpu_torch import make_qp
    from galahad_tpu_torch.qp.ipm import ipm_solve_compiled

    from _torch_port_helpers import random_convex_qp_arrays

    arrays = [random_convex_qp_arrays(7, 3, 60 + s) for s in range(4)]
    for a in arrays:
        a.pop("h_kind")
    for a in arrays[::2]:
        a["H"][0, :] = a["H"][:, 0] = 0.0
        a["A"][:, 0] = 0.0
        a["x_l"][0], a["x_u"][0], a["g"][0] = -1e20, 1e20, 0.0
    ctl = IPMControl(maxit=40)
    xs, _, _, st = ipm_solve_compiled(
        make_qp(**{k: np.stack([a[k] for a in arrays]) for k in arrays[0]}, device="cpu"), ctl)
    assert st.run.escalations > 0
    for i, a in enumerate(arrays):
        x, _, _, one = ipm_solve_compiled(make_qp(**a, device="cpu"), ctl)
        assert (int(st.status[i]), int(st.iter[i])) == (one.status, one.iter), i
        assert (one.run.escalations > 0) == (i % 2 == 0)
        assert float((xs[i] - x).abs().max()) <= 1e-10, i


def _model_qp():
    """test_parallel.py:51-65's QP."""
    n, m = 32, 16
    r = np.random.default_rng(5)
    B = r.normal(size=(n, n))
    H = B @ B.T + np.eye(n)
    A = r.normal(size=(m, n))
    x_feas = r.uniform(0.2, 0.8, size=n)
    c_at = A @ x_feas
    return (H, r.normal(size=n), A, c_at - 1.0, c_at + 1.0, np.zeros(n), np.ones(n))


def test_model_sharded_step_matches_jax_and_the_whole_step():
    from galahad_tpu_torch import make_qp
    from galahad_tpu_torch.core.problem import classify_bounds
    from galahad_tpu_torch.qp.ipm import ipm_init, ipm_step

    args = _model_qp()
    jst = jax_model_sharded_step(tuple(jnp.asarray(a) for a in args),
                                 jax_make_mesh(8, batch=1))
    st = model_sharded_step(args, make_mesh(8, batch=1, devices=CPU8))
    H, g, A, c_l, c_u, x_l, x_u = args
    qp = make_qp(H=H, g=g, A=A, c_l=c_l, c_u=c_u, x_l=x_l, x_u=x_u, device="cpu")
    ctl = IPMControl()
    masks = classify_bounds(qp)
    whole = ipm_step(qp, masks, ipm_init(qp, masks, ctl), ctl)
    for f in TENSOR_FIELDS:
        if f == "needs_shift":           # the port's flag; the JAX step escalates inline
            continue
        got = getattr(st, f)
        assert _rel(got, np.asarray(getattr(jst, f))) <= 1e-12, f
        assert _rel(got, getattr(whole, f)) <= 1e-12, f
    assert st.x.shape == (32,) and bool(torch.isfinite(st.res_d))


def _angular(K=8, n=12, m=5, seed=0):
    """TestBlockAngularSchur._problem."""
    rng = np.random.default_rng(seed)
    Bs = rng.normal(size=(K, n, n))
    G = Bs @ np.swapaxes(Bs, -1, -2) + 4 * np.eye(n)
    A = rng.normal(size=(K, m, n))
    b = rng.normal(size=(K, n))
    Cb = rng.normal(size=(m, m))
    return G, A, b, Cb @ Cb.T + np.eye(m), rng.normal(size=m)


@pytest.mark.parametrize("case, use_psum", [
    (dict(), True), (dict(K=16, n=6, m=3, seed=2), True), (dict(), False)],
    ids=["matches_monolithic", "multiblock_per_device", "use_psum_false"])
def test_block_angular_matches_jax(case, use_psum):
    from galahad_tpu.parallel import block_angular_solve as jax_block_angular_solve

    arrays = _angular(**case)
    jx, jy = jax_block_angular_solve(jax_make_mesh(8, batch=8),
                                     *(jnp.asarray(a) for a in arrays), use_psum=use_psum)
    t = tuple(torch.as_tensor(a) for a in arrays)
    x, y = block_angular_solve(make_mesh(devices=CPU8), *t, use_psum=use_psum)
    assert _rel(x, np.asarray(jx)) <= 1e-12
    assert _rel(y, np.asarray(jy)) <= 1e-12
    if use_psum:
        assert float(block_angular_residual(*t, x, y)) < 1e-9


@pytest.fixture(scope="module")
def strip_grid():
    from galahad_tpu.parallel.supernodal_mesh import build_strip_grid_kkt as jax_build
    from galahad_tpu.parallel.supernodal_mesh import sharded_kkt_solve as jax_solve

    from galahad_tpu_torch.parallel.supernodal_mesh import build_strip_grid_kkt

    jplan, jparts = jax_build(8, 3, 8)
    jxs, jxsep = jax_solve(jax_make_mesh(8, batch=8), jplan, jparts["vals"], jparts["B"],
                           jparts["Kss"], jparts["b"], jparts["bs"])
    plan, parts = build_strip_grid_kkt(8, 3, 8)
    return dict(jplan=jplan, jparts=jparts, jxs=np.asarray(jxs), jxsep=np.asarray(jxsep),
                plan=plan, parts=parts)


def test_build_strip_grid_kkt_bitwise(strip_grid):
    jparts, parts = strip_grid["jparts"], strip_grid["parts"]
    for k in ("vals", "B", "Kss", "b", "bs"):
        a, b = np.asarray(jparts[k]), parts[k].numpy()
        assert a.shape == b.shape and np.array_equal(a, b), k
    assert parts["nd"] == jparts["nd"] and parts["ns"] == jparts["ns"]
    assert np.array_equal(strip_grid["plan"].perm, strip_grid["jplan"].perm)
    assert np.array_equal(parts["rhs"], jparts["rhs"])
    assert np.max(np.abs(parts["x_ref"] - jparts["x_ref"])) <= 1e-12


def test_sharded_kkt_solve_matches_jax_and_repeats(strip_grid):
    from galahad_tpu_torch.parallel.supernodal_mesh import (sharded_kkt_residual,
                                                            sharded_kkt_solve)

    plan, parts = strip_grid["plan"], strip_grid["parts"]
    mesh = make_mesh(devices=CPU8)
    args = (parts["vals"], parts["B"], parts["Kss"], parts["b"], parts["bs"])
    xs, xsep = sharded_kkt_solve(mesh, plan, *args)
    assert sharded_kkt_residual(parts, xs, xsep) < 1e-10
    assert _rel(xs, strip_grid["jxs"]) <= 1e-12
    assert _rel(xsep, strip_grid["jxsep"]) <= 1e-12
    x = np.concatenate([xs.numpy().ravel(), xsep.numpy()])
    ref = np.concatenate([parts["x_ref"][I] for I in parts["interior"]]
                         + [parts["x_ref"][parts["sep"]]])
    assert np.max(np.abs(x - ref)) < 1e-8
    xs2, xsep2 = sharded_kkt_solve(mesh, plan, *args)
    assert torch.equal(xs, xs2) and torch.equal(xsep, xsep2)


def test_strip_check_refuses_columns_that_differ():
    """Strip 1's sorted pattern has strip 0's rows and other columns: one
    plan cannot serve both.  The JAX package's check (the rows,
    galahad_tpu/parallel/supernodal_mesh.py:121-126, restated here) passes
    it; the port's refuses it."""
    from galahad_tpu_torch.parallel.supernodal_mesh import _strip_values

    lr = np.array([0, 1, 2, 2, 0, 1, 2, 2])
    lc = np.array([0, 1, 0, 2, 0, 1, 1, 2])
    ld = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    lv = np.arange(8.0)
    order0 = np.lexsort((lc[ld == 0], lr[ld == 0]))
    od = np.lexsort((lc[ld == 1], lr[ld == 1]))
    assert np.array_equal(lr[ld == 1][od], lr[ld == 0][order0])       # the JAX check passes
    with pytest.raises(ValueError, match="strip 1"):
        _strip_values(lr, lc, ld, lv, 2)
    _, _, same = _strip_values(lr[:4], lc[:4], ld[:4], lv[:4], 1)
    assert same.tolist() == [[0.0, 1.0, 2.0, 3.0]]


def test_jax_devices_are_eight():
    assert len(jax.devices()) == 8
