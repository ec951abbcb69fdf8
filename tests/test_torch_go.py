"""The port's global solvers (galahad_tpu_torch/go/: LHS, BGO, DGO, UGO)
against the JAX package's, on tests/test_go.py's cases, float64, the port on
the CPU.

- LHS: one sample per stratum per dimension, the box, and its seeding: the
  port draws from an explicit host ``torch.Generator``, so a seed gives the
  same points on every device, and not the JAX package's (threefry; ROADMAP
  queue 3).  BGO is therefore held through its multistart helper on the JAX
  package's own ``lhs_sample_box(PRNGKey(0), ...)`` starts.
- BGO on the six-hump camel function: x, f, norm_pg, starts_converged and
  every start's status, iterations and x (1e-10).  On Rastrigin (256
  starts) the best point, f and norm_pg; the JAX package's starts_converged
  is 254 here and the port's 250, as 74 starts' TRB trajectories part.  The
  test shows where, pass by pass (both packages' states recorded after
  every pass): each parted start runs bit for bit as the JAX package's
  until one pass, which begins from the same bits in both and ends at most
  1.9e-7 apart (relative).  That pass rounds differently: the JAX package's
  loop body is one fused XLA program, the port rounds op by op (the
  objective, norms and products; the TRS solve grows the difference where
  it is near its hard case).  On Rastrigin's many minima such a start then
  ends elsewhere.  Every start that does not part ends as the JAX
  package's, so the two starts_converged differ by parted starts only.
  The Cauchy arc's x - t g is one fused multiply-add, as XLA contracts it
  (torch.addcmul); without it one camel start takes 7 iterations, not 6.
- DGO: boxes, f and x (1e-10) on the camel function, the 1-D case and
  Hartmann-6 on the unit cube, where every side of a box is equal after each
  trisection and ``argmax`` takes the first (the JAX package's choice); no
  host read in the box splits.
- UGO: x and f on the three functions, the right endpoint's minimum kept by
  the stable sort; no host read in the loop.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import galahad_tpu.go as J

import galahad_tpu_torch.go as T
from galahad_tpu_torch.go.bgo import _multistart
from galahad_tpu_torch.go.dgo import dgo_boxes
from galahad_tpu_torch.nlp import TRBControl, trb_solve

from _torch_port_helpers import (REPO, arc_inputs, one_torch_thread, rel,  # noqa: F401
                                 x_minus_tg_exact)

sys.path.insert(0, os.path.join(REPO, "tools"))
import constrained_problems as CP  # noqa: E402  (tools/constrained_problems.py)
import sif_problems  # noqa: E402  (tools/sif_problems.py)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10


class HostReads(TorchDispatchMode):
    """Counts the operations that copy a tensor's value to the host
    (``.item()``, ``bool()``, ``float()``, ``tolist``)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.equal.default):
            self.reads += 1
        return func(*args, **(kwargs or {}))


def test_lhs():
    """Stratification, the box, and the host generator's seeding."""
    pts = T.lhs_sample(0, 16, 3, device="cpu")
    assert pts.shape == (16, 3) and pts.dtype == torch.float64
    for d in range(3):
        assert sorted(np.floor(pts[:, d].numpy() * 16).astype(int).tolist()) == list(range(16))
    again = T.lhs_sample(torch.Generator().manual_seed(0), 16, 3, device="cpu")
    assert torch.equal(pts, again)
    assert not torch.equal(pts, T.lhs_sample(1, 16, 3, device="cpu"))
    lo, hi = np.array([-2.0, 5.0]), np.array([-1.0, 9.0])
    box = T.lhs_sample_box(1, 8, lo, hi, device="cpu")
    assert bool((box >= torch.as_tensor(lo)).all() and (box <= torch.as_tensor(hi)).all())
    jpts = np.asarray(J.lhs_sample(jax.random.PRNGKey(0), 16, 3))
    assert not np.allclose(jpts, pts.numpy())         # another stream (queue 3)


def starts(att, lo, hi):
    return np.asarray(J.lhs_sample_box(jax.random.PRNGKey(0), att, jnp.asarray(lo),
                                       jnp.asarray(hi)))


def jax_trb_passes(monkeypatch, f, S, lo, hi, ctl):
    """The JAX package's TRB vmapped over the starts ``S`` as its BGO runs it
    (``jax.vmap``, not jitted: a jitted vmap fuses otherwise), with its state
    after every pass: the module's ``lax.while_loop`` wrapped so that the loop
    body hands each pass's (iter, x, f, g, radius) of every start to the host
    (a ``pure_callback`` vectorized over the starts, its zero result added to
    the radius so that it stays in the program).  Returns (final state,
    {start: {iteration: (x, f, g, radius)}})."""
    import galahad_tpu.nlp.tru as JT

    passes: dict = {}

    def record(it, x, fx, g, r):
        it, x, fx, g, r = map(np.asarray, (it, x, fx, g, r))
        for b in range(it.shape[0]):
            passes.setdefault(b, {}).setdefault(int(it[b]), (x[b], float(fx[b]), g[b],
                                                              float(r[b])))
        return np.zeros_like(r)

    class TappedLax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        @staticmethod
        def while_loop(cond, body, init):
            def tapped(st):
                out = body(st)
                zero = jax.pure_callback(record, jax.ShapeDtypeStruct(out.radius.shape,
                                                                      out.radius.dtype),
                                         out.iter, out.x, out.f, out.g, out.radius,
                                         vmap_method="expand_dims")
                return dataclasses.replace(out, radius=out.radius + zero)

            return jax.lax.while_loop(cond, tapped, init)

    def run():
        return jax.vmap(lambda s: JT.trb_solve(
            f, s, jnp.asarray(lo), jnp.asarray(hi),
            JT.TRBControl(maxit=ctl.maxit_local, stop_g_absolute=ctl.stop_g_absolute)))(
                jnp.asarray(S))

    plain = run()
    with monkeypatch.context() as m:
        m.setattr(JT, "lax", TappedLax())
        sj = run()
    # the tap leaves the computation as it was
    for name in ("x", "f", "iter", "status"):
        assert np.array_equal(np.asarray(getattr(sj, name)), np.asarray(getattr(plain, name)))
    return sj, passes


def port_trb_passes(monkeypatch, f, S, lo, hi, ctl):
    """The port's batched TRB from the starts ``S`` with its state before the
    first pass and after every pass (the outer loop's step wrapped)."""
    import galahad_tpu_torch.nlp.tru as PT

    passes = []
    run = PT.run

    def recorded(st, step, maxit):
        passes.append(st)

        def step_recorded(s):
            out = step(s)
            passes.append(out)
            return out

        return run(st, step_recorded, maxit)

    with monkeypatch.context() as m:
        m.setattr(PT, "run", recorded)
        st = trb_solve(f, S, np.array(lo), np.array(hi),
                       TRBControl(maxit=ctl.maxit_local, stop_g_absolute=ctl.stop_g_absolute),
                       device="cpu")
    return st, passes


def test_cauchy_arc_is_one_fused_multiply_add():
    """The Cauchy arc's point x - t g (``torch.addcmul`` in TRB) is rounded
    once, as the JAX package's, where XLA contracts x - t * g into a fused
    multiply-add; rounding the product first differs on some of the inputs."""
    x, t, g = arc_inputs()
    exact = x_minus_tg_exact(x, t, g)
    port = torch.addcmul(*map(torch.as_tensor, (x, t, g)), value=-1.0).numpy()
    xla = np.asarray(jax.jit(lambda x, t, g: x - t * g)(x, t, g))
    assert np.array_equal(port, exact) and np.array_equal(xla, exact)
    assert not np.array_equal(x - t * g, exact)


def test_bgo_on_the_jax_starts(monkeypatch):
    """BGO on camel (16 starts) in full, and start by start; on Rastrigin
    (256) the best point, and where each parted start parts (the module
    docstring)."""
    for name, fj, ft, lo, hi, att in (
            ("camel", CP.camel6, CP.camel6, [-3.0, -2.0], [3.0, 2.0], 16),
            ("rastrigin", CP.rastrigin(jnp), CP.rastrigin(torch), [-5.12] * 2, [5.12] * 2, 256)):
        S = starts(att, lo, hi)
        ctl = T.BGOControl(attempts=att)
        ij = J.bgo_solve(fj, jnp.asarray(lo), jnp.asarray(hi), ctl=J.BGOControl(attempts=att))
        it = _multistart(ft, torch.as_tensor(S), torch.tensor(lo, dtype=torch.float64),
                         torch.tensor(hi, dtype=torch.float64), ctl)
        assert rel(ij.x, it.x) <= TOL and rel(ij.f, it.f) <= TOL, name
        assert abs(float(ij.norm_pg) - float(it.norm_pg)) <= 1e-12, name
        sj, jp = jax_trb_passes(monkeypatch, fj, S, lo, hi, ctl)
        st, pp = port_trb_passes(monkeypatch, ft, S, lo, hi, ctl)
        ji, pi = np.asarray(sj.iter), st.iter.numpy()
        assert int(ij.starts_converged) == int((np.asarray(sj.status) == 0).sum())
        assert int(it.starts_converged) == int((st.status == 0).sum())
        same = ((ji == pi) & (np.asarray(sj.status) == st.status.numpy())
                & (np.abs(np.asarray(sj.x) - st.x.numpy()).max(-1) <= TOL))
        if name == "camel":
            assert bool(same.all()) and int(it.starts_converged) == 16
            continue
        parted = np.nonzero(~same)[0]
        assert 0 < len(parted) < att
        for b in parted:
            for k in range(min(ji[b], pi[b])):
                xj, fj_k, gj, rj = jp[b][k + 1]
                after = pp[k + 1]
                d = max(np.abs(xj - after.x[b].numpy()).max() / max(1.0, np.abs(xj).max()),
                        abs(fj_k - float(after.f[b])) / max(1.0, abs(fj_k)),
                        np.abs(gj - after.g[b].numpy()).max() / max(1.0, np.abs(gj).max()),
                        abs(rj - float(after.radius[b])) / rj)
                if d:
                    # passes 0..k-1 gave the same bits in both packages
                    assert d <= 1e-6, (b, k, d)
                    break
            else:
                raise AssertionError(f"start {b} parts with no pass that differs")
        conv_j, conv_p = np.asarray(sj.status) == 0, st.status.numpy() == 0
        assert not (conv_j != conv_p)[same].any()
    own = T.bgo_solve(CP.camel6, np.array([-3.0, -2.0]), np.array([3.0, 2.0]),
                      x0=np.array([0.0898, -0.7126]), ctl=T.BGOControl(attempts=4),
                      device="cpu")
    assert float(own.f) <= CP.camel6(torch.tensor([0.0898, -0.7126], dtype=torch.float64)) + 1e-9


def test_dgo():
    """boxes, f and x of the JAX package's DGO on camel (200 splits), the 1-D
    case (150) and Hartmann-6 on [0, 1]^6 (100); two runs bitwise; on the
    cube the first split is along the first of six equal sides; the splits
    read nothing on the host."""
    hj = lambda v: jnp.sin(v[0]) + jnp.sin(10.0 * v[0] / 3.0)       # noqa: E731
    ht = lambda v: torch.sin(v[0]) + torch.sin(10.0 * v[0] / 3.0)   # noqa: E731
    for name, fj, ft, lo, hi, maxit in (
            ("camel", CP.camel6, CP.camel6, [-3.0, -2.0], [3.0, 2.0], 200),
            ("1d", hj, ht, [2.7], [7.5], 150),
            ("hartmann6", sif_problems.hartmann6(jnp), sif_problems.hartmann6(torch), [0.0] * 6,
             [1.0] * 6, 100)):
        ij = J.dgo_solve(fj, jnp.asarray(lo), jnp.asarray(hi), ctl=J.DGOControl(maxit=maxit))
        it = T.dgo_solve(ft, lo, hi, ctl=T.DGOControl(maxit=maxit), device="cpu")
        assert int(ij.boxes) == int(it.boxes) == 1 + 2 * maxit, name
        assert rel(ij.x, it.x) <= TOL and rel(ij.f, it.f) <= TOL, name
        again = T.dgo_solve(ft, lo, hi, ctl=T.DGOControl(maxit=maxit), device="cpu")
        assert torch.equal(again.x, it.x) and torch.equal(again.f, it.f), name
    lo, hi = torch.zeros(6, dtype=torch.float64), torch.ones(6, dtype=torch.float64)
    with HostReads() as probe:
        C, W, F, valid = dgo_boxes(sif_problems.hartmann6(torch), lo, hi, T.DGOControl(maxit=100))
    assert probe.reads == 0
    shift = torch.zeros(6, dtype=torch.float64)
    shift[0] = 1.0 / 3.0
    assert torch.equal(C[1], 0.5 - shift) and torch.equal(C[2], 0.5 + shift)
    assert float(it.f) < -3.0


def test_ugo():
    """x and f of the JAX package's UGO on test_go.py's three functions and on
    -x (the minimum at the right endpoint b, which the padding slots repeat:
    the stable sort keeps the real endpoint first); no host read."""
    for name, fj, ft, a, b, maxit in (
            ("multimodal", lambda x: jnp.sin(x) + jnp.sin(10.0 * x / 3.0),
             lambda x: torch.sin(x) + torch.sin(10.0 * x / 3.0), 2.7, 7.5, 100),
            ("many_minima", lambda x: x ** 2 / 50.0 - jnp.cos(x) + 1.0,
             lambda x: x ** 2 / 50.0 - torch.cos(x) + 1.0, -20.0, 20.0, 200),
            ("monotone", lambda x: x, lambda x: x, -1.0, 3.0, 100),
            ("right_end", lambda x: -x, lambda x: -x, -1.0, 3.0, 100)):
        ij = J.ugo_solve(fj, a, b, J.UGOControl(maxit=maxit))
        with HostReads() as probe:
            it = T.ugo_solve(ft, a, b, T.UGOControl(maxit=maxit), device="cpu")
        assert probe.reads == 0, name
        assert rel(ij.x, it.x) <= TOL and rel(ij.f, it.f) <= TOL, (name, float(ij.x), float(it.x))
        assert (int(it.iter), int(it.evals)) == (int(ij.iter), int(ij.evals)), name
    assert float(it.x) == 3.0
