"""The port's DQP, CCQP and DLP (galahad_tpu_torch/qp/dqp.py,
qp/wrappers.py::dlp_solve) against the JAX package's on the same
numpy-seeded dense QPs and sweep fixtures.

What is held: the same status and iteration count, and x, y, z within 1e-8
relative (max |difference| <= 1e-8 x max(1, max |value|)) and the objective
within 1e-8 relative.  Found on these cases: x, y, z agree to 1e-15 on the
small random QPs and to 1e-10 on QPMIXB (16 iterations) and LPB100.

What was found beyond them, and is not held here: DQP's path is sensitive to
rounding, so on larger problems the two packages' iteration counts part
(random_convex_qp at n = 64: 46 against 43 iterations, both converged, x
within 1e-9), and its subspace CG has no guard against a vanishing curvature
p'Kp, so on some problems one package's iterate overflows to NaN and the
other's does not (random_convex_qp(10, 6, 0): the jitted JAX DQP at iteration
2, while its eager run and the port converge; seed 3: the port, not JAX;
random LPs through DLP: both).
``test_converges_where_the_jitted_reference_overflows`` holds the port to
the JAX package run op by op on the first of these."""
import jax
import numpy as np
import pytest
import torch

from galahad_tpu.io import qplib as j_qplib
from galahad_tpu.qp import dqp as j_dqp
from galahad_tpu.qp.ipm import ipm_solve as j_ipm_solve
from galahad_tpu.qp.wrappers import dlp_solve as j_dlp

from galahad_tpu_torch import make_sparse_qp
from galahad_tpu_torch.convert import dqp_info_from_numpy
from galahad_tpu_torch.io import qplib as t_qplib
from galahad_tpu_torch.qp import dqp as t_dqp
from galahad_tpu_torch.qp.wrappers import dlp_solve as t_dlp

from _torch_port_helpers import (dense_pair, loop_reads, one_torch_thread,  # noqa: F401
                                 random_convex_qp_arrays, sweep_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def diagonal(n, m, seed):
    a = random_convex_qp_arrays(n, m, seed)
    a["H"] = np.random.default_rng(seed + 100).uniform(0.5, 2.0, n)
    a["h_kind"] = "diagonal"
    return a


CASES = {
    "cold": lambda: random_convex_qp_arrays(10, 6, 5),
    "equalities": lambda: random_convex_qp_arrays(10, 6, 1, equalities=3),
    "equalities_n20": lambda: random_convex_qp_arrays(20, 8, 2, equalities=2),
    "diagonal": lambda: diagonal(12, 6, 3),
    "m0": lambda: random_convex_qp_arrays(10, 0, 4),
}
_PAIRS = {}
_JAX_COLD = {}


def pair(case):
    if case not in _PAIRS:
        _PAIRS[case] = dense_pair(CASES[case]())
    return _PAIRS[case]


def jax_cold(case):
    """The JAX package's cold DQP solve of a case (each call compiles its loops)."""
    if case not in _JAX_COLD:
        _JAX_COLD[case] = j_dqp.dqp_solve(pair(case)[0])
    return _JAX_COLD[case]


def rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy()
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / max(1.0, np.abs(ref).max()) if ref.size else 0.0


def check_same(dj, dt, tol=1e-8):
    assert (dt.status, dt.iter) == (int(dj.status), int(dj.iter))
    assert dt.converged == bool(dj.converged)
    for a in ("x", "y", "z"):
        assert rel(getattr(dj, a), getattr(dt, a)) <= tol, a
    assert abs(dt.obj - float(dj.obj)) <= tol * max(1.0, abs(float(dj.obj)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dqp_cold(case):
    dj, dt = jax_cold(case), t_dqp.dqp_solve(pair(case)[1])
    check_same(dj, dt)
    assert dt.status == 0
    # one read for the loop's test per iteration, one per block of arc
    # segments (two arc searches per iteration), and the final test
    blocks = -(-t_dqp.DQPControl().max_arc_segments // t_dqp.SEGMENT_BLOCK)
    assert dt.host_reads <= 2 + dt.iter * (1 + 2 * blocks)


@pytest.mark.parametrize("case", ["equalities", "diagonal"])
def test_dqp_warm_and_ccqp(case):
    """Warm start from the JAX package's IPM duals in both, and CCQP (each
    package's own IPM, then DQP from its duals)."""
    jq, tq = pair(case)
    _, y, z, _ = j_ipm_solve(jq)
    check_same(j_dqp.dqp_solve(jq, y0=y, z0=z),
               t_dqp.dqp_solve(tq, y0=np.array(y), z0=np.array(z)))
    check_same(j_dqp.ccqp_solve(jq), t_dqp.ccqp_solve(tq))


@pytest.mark.parametrize("name,status,iters", [("QPMIXB", 0, 16), ("QPDEGEN", 0, 0)])
def test_rescued_fixtures(name, status, iters):
    """The two sweep fixtures that qp_solve's default rescue answers."""
    dj = j_dqp.dqp_solve(j_qplib.read_qp(sweep_path(name)))
    dt = t_dqp.dqp_solve(t_qplib.read_qp(sweep_path(name), device="cpu"))
    check_same(dj, dt)
    assert (dt.status, dt.iter) == (status, iters)


def test_dlp_on_an_lp_fixture():
    dj = j_dlp(j_qplib.read_qp(sweep_path("LPB100")))
    dt = t_dlp(t_qplib.read_qp(sweep_path("LPB100"), device="cpu"))
    check_same(dj, dt)
    assert dt.status == 0


def test_converges_where_the_jitted_reference_overflows():
    """random_convex_qp(10, 6, 0): the jitted JAX DQP overflows to NaN at
    iteration 2 (status -18).  The JAX package run op by op converges (in 4
    iterations), and so does the port (in 8): the same status and
    objective, x, y, z within 1e-8; the iteration counts are not held."""
    jq, tq = dense_pair(random_convex_qp_arrays(10, 6, 0))
    jit = j_dqp.dqp_solve(jq)
    assert int(jit.status) == -18 and np.isnan(float(jit.obj))
    with jax.disable_jit():
        dj = j_dqp.dqp_solve(jq)
    dt = t_dqp.dqp_solve(tq)
    assert dt.status == int(dj.status) == 0
    for a in ("x", "y", "z"):
        assert rel(getattr(dj, a), getattr(dt, a)) <= 1e-8, a
    assert abs(dt.obj - float(dj.obj)) <= 1e-8 * max(1.0, abs(float(dj.obj)))


@pytest.mark.parametrize("case", ["equalities", "m0"])
def test_unit_column_read_is_the_matvec(case):
    """``bt_unit`` (one row of A) gives the bits of B' applied to the unit
    vector, for every index of w."""
    _, tq = pair(case)
    masks = t_dqp.classify_bounds(tq)
    *_, Bt, _ = t_dqp._dual_pieces(tq, masks, t_dqp.DQPControl())
    size = 2 * tq.m + 2 * tq.n
    vals = torch.as_tensor(np.random.default_rng(3).normal(size=size))
    for j in range(size):
        e = torch.zeros(size, dtype=torch.float64)
        e[j] = vals[j]
        assert torch.equal(t_dqp.bt_unit(tq, torch.tensor([j]), vals[j]), Bt(e)), j


def test_jax_info_converts():
    dj = jax_cold("cold")
    d = dqp_info_from_numpy({k: np.asarray(getattr(dj, k)) for k in
                             ("x", "y", "z", "obj", "iter", "converged", "status", "norm_pg")},
                            device="cpu")
    assert (d.status, d.iter, d.converged) == (0, int(dj.iter), True)
    check_same(dj, d, tol=0.0)


def test_exact_arc_false_by_trb():
    """``DQPControl(exact_arc=False)``: the dual by the port's ``trb_solve``
    against the JAX package's on tests/test_qp_family2.py's
    random_convex_qp(12, 6, 77) and on the "cold" case: the same status and
    iteration count (27, 42), x, y, z and the objective within 1e-8; the
    exact arc's x within 1e-6 (test_qp_family2.py's check)."""
    ctl_j, ctl_t = j_dqp.DQPControl(exact_arc=False), t_dqp.DQPControl(exact_arc=False)
    for jq, tq in (dense_pair(random_convex_qp_arrays(12, 6, 77)), pair("cold")):
        dj = j_dqp.dqp_solve(jq, ctl=ctl_j)
        dt = t_dqp.dqp_solve(tq, ctl=ctl_t)
        check_same(dj, dt)
        assert dt.status == 0 and dt.host_reads == loop_reads(dt.iter, ctl_t.maxit)
        exact = t_dqp.dqp_solve(tq)
        np.testing.assert_allclose(dt.x.numpy(), exact.x.numpy(), atol=1e-6)


def test_refusals():
    sq = make_sparse_qp(2, 1, h_coo=([0, 1], [0, 1], [1.0, 1.0]), a_coo=([0], [0], [1.0]),
                        g=np.zeros(2), device="cpu")
    for fn in (t_dqp.dqp_solve, t_dqp.ccqp_solve):
        with pytest.raises(TypeError, match="dense QP"):
            fn(sq)
