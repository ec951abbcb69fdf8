"""The QPBAND benchmark configuration on the CPU: the family
(portbench/families/qpband.py) and its port adapter
(portbench/port/banded_h_qp.py) solved by ``ipm_solve`` and judged by the
benchmark's plain reference; the PCG count that a request at n = 3,000
needs; one PCG-mode KKT solve of ``BandedQP.build_kkt`` against a dense
solve; the ``kkt.pcg`` span; the operation and byte counts of
the block-tridiagonal solve's roofline; and the two metric readers that the
configuration's cell adds."""
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from galahad_tpu_torch.core import trace
from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve
from galahad_tpu_torch.qp.ipm_banded import make_banded_qp

from _torch_port_helpers import inside, one_torch_thread, profiled_spans  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, reference  # noqa: E402
from portbench.roofline import banded_solve, peaks  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "qpband-20k.pcg"


def cell_at(n: int):
    """The cell's configuration at ``n`` variables, its family and adapter."""
    cell = harness.Cell.load(ROOT, CELL)
    cfg = dict(cell.config, n=n)
    fam = cell.module("families", cfg["family"] + ".py")
    return cfg, fam, cell.module("port", fam.KIND + "_qp.py")


def request(cfg, fam, port, st, seed, index):
    vals = fam.values(cfg, st, harness.request_generator(seed, index, "cpu"), "cpu")
    return vals, port.base_problem(st, vals, torch.float64, "cpu")


@pytest.mark.parametrize("n,seed", [(64, 2 ** 31 + 11), (64, 7), (200, 2 ** 31 + 11)])
def test_requests_pass_the_reference(n, seed):
    """Two requests of one structure (the first built from scratch, the
    second by ``request_problem`` from it) solved at status 0 within the
    configuration's limits, H judged as the family states it."""
    cfg, fam, port = cell_at(n)
    st = fam.structure(cfg)
    assert fam.KIND == "banded_h"
    vals0, base = request(cfg, fam, port, st, seed, 0)
    assert base.h_kind == "banded" and base.m == n - 2
    vals1 = fam.values(cfg, st, harness.request_generator(seed, 1, "cpu"), "cpu")
    limits = {k: float(v) for k, v in cfg["limits"].items()}
    for vals, qp in ((vals0, base), (vals1, port.request_problem(base, vals1))):
        x, y, z, state = ipm_solve(qp, IPMControl())
        p = fam.host_problem(st, {k: v.numpy() for k, v in vals.items()})
        assert np.array_equal(p["H"].diagonal(), np.full(n, 2.0))
        assert np.array_equal(p["H"].diagonal(1), np.full(n - 1, -1.0))
        verdict = reference.judge(p, dict(x=x.numpy(), y=y.numpy(), z=z.numpy(),
                                          status=int(state.status)), limits)
        assert verdict["ok"], verdict
    assert fam.kernel_shapes(cfg, st) == dict(banded_k=-(-n // 8), banded_b=8)


class BandedCholesky:
    """The block-tridiagonal factors of (D, L) as LAPACK's banded Cholesky
    (scipy), for :func:`test_the_pcg_count_converges_at_n3000`: exact as the
    port's plain block loop is, some hundred times faster on the CPU."""

    def __init__(self, D, L):
        import scipy.linalg as sl

        k, b, _ = D.shape
        ab = np.zeros((2 * b, k * b))
        i, r, c = np.meshgrid(np.arange(k), np.arange(b), np.arange(b), indexing="ij")
        low = r >= c
        ab[(r - c)[low], (i * b + c)[low]] = D.numpy()[low]
        i, r, c = i[:-1], r[:-1], c[:-1]
        ab[(b + r - c).ravel(), (i * b + c).ravel()] = L.numpy().ravel()
        self.cb = sl.cholesky_banded(ab, lower=True)

    def solve(self, v):
        import scipy.linalg as sl

        rhs = np.zeros(self.cb.shape[1])
        rhs[:v.shape[-1]] = v.numpy()
        return torch.as_tensor(sl.cho_solve_banded((self.cb, True), rhs)[:v.shape[-1]])


@pytest.mark.parametrize("cg_maxit,converges", [(None, True), (64, False)])
def test_the_pcg_count_converges_at_n3000(monkeypatch, cg_maxit, converges):
    """The PCG mode's default count (128) against the JAX package's 64 on a
    request of the configuration at n = 3,000 (seed 2, 2,998 rows): with 64
    iterations a sweep the directions are too inexact and the IPM does not
    converge in 60 iterations; the default converges in the 16 that an exact
    solve takes.  The banded G and preconditioner solves run as scipy's
    banded Cholesky: the count is what is held here."""
    from galahad_tpu_torch.qp import ipm_banded

    monkeypatch.setattr(ipm_banded, "block_tridiag_cholesky", BandedCholesky)
    monkeypatch.setattr(ipm_banded, "_padded_solve", lambda f, v: f.solve(v))
    cfg, fam, port = cell_at(3000)
    st = fam.structure(cfg)
    vals, qp = request(cfg, fam, port, st, 2, 0)
    if cg_maxit is not None:
        qp = dataclasses.replace(qp, cg_maxit=cg_maxit)
    x, y, z, state = ipm_solve(qp, IPMControl(maxit=60))
    if not converges:
        assert state.status != 0 and state.iter == 60
        return
    assert qp.cg_maxit == 128 and state.status == 0 and state.iter <= 18
    p = fam.host_problem(st, {k: v.numpy() for k, v in vals.items()})
    verdict = reference.judge(p, dict(x=x.numpy(), y=y.numpy(), z=z.numpy(),
                                      status=int(state.status)),
                              {k: float(v) for k, v in cfg["limits"].items()})
    assert verdict["ok"], verdict


def test_the_pcg_guard_holds_in_float32():
    """The PCG's guards against a zero denominator are the dtype's smallest
    normal number.  A floor of 1e-300 is 0 in float32: a CG step whose
    residual has vanished then divides by 0, and the IPM stops at its first
    iteration as ill-conditioned."""
    cfg, fam, port = cell_at(64)
    st = fam.structure(cfg)
    vals = fam.values(cfg, st, harness.request_generator(1618033988, 0, "cpu"), "cpu")
    qp = port.base_problem(st, vals, torch.float32, "cpu")
    x, y, z, state = ipm_solve(qp, IPMControl(dtype="float32"))
    assert state.status == 0 and state.iter > 1
    assert all(bool(torch.isfinite(v).all()) for v in (x, y, z))


def dense_kkt(qp, D_x, C_diag):
    """[[H + D_x, A'], [A, -C]] in plain torch."""
    n, m = qp.n, qp.m
    H = torch.diag(qp.h_diags[0]) + torch.diag(qp.h_diags[1, :-1], -1) \
        + torch.diag(qp.h_diags[1, :-1], 1)
    A = torch.zeros(m, n, dtype=torch.float64)
    for p, off in enumerate(qp.A_band.offsets):
        A[torch.arange(m), torch.arange(m) + off] = qp.A_band.val[p]
    return torch.cat([torch.cat([H + torch.diag(D_x), A.T], 1),
                      torch.cat([A, -torch.diag(C_diag)], 1)])


def test_a_pcg_kkt_solve_matches_a_dense_solve():
    """At n = 64 (m = 62 rows) the PCG mode's KKT solve against a dense LU
    solve of the same system.  Tolerance 1e-9 relative to the solution's
    largest entry: CG on the 62 rows converges well inside its fixed count,
    the G solves are direct, and the refinement sweeps take the result to
    the condition number (about 1e3 here, D_x and C drawn in [0.1, 2]) times
    the float64 rounding, some 1e-13."""
    cfg, fam, port = cell_at(64)
    st = fam.structure(cfg)
    _, qp = request(cfg, fam, port, st, 5, 0)
    r = np.random.default_rng(5)
    D_x = torch.as_tensor(r.uniform(0.1, 2.0, qp.n))
    C_diag = torch.as_tensor(r.uniform(0.1, 2.0, qp.m))
    b1 = torch.as_tensor(r.normal(size=qp.n))
    b2 = torch.as_tensor(r.normal(size=qp.m))
    x, minus_v = qp.build_kkt(D_x, C_diag, IPMControl())(b1, b2)
    want = torch.linalg.solve(dense_kkt(qp, D_x, C_diag), torch.cat([b1, b2]))
    got = torch.cat([x, -minus_v])
    assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max())


def mode_problem(mode: str):
    """A QPBAND problem of n = 24 in each banded KKT mode: "pcg" (banded H,
    rows; 24 CG iterations, enough for its 22 rows), "schur" (H = 0, rows),
    "m0" (banded H, no rows)."""
    n = 24
    r = np.random.default_rng(3)
    m = 0 if mode == "m0" else n - 2
    h = (np.stack([np.full(n, 2.0), np.concatenate([-np.ones(n - 1), [0.0]])])
         if mode != "schur" else None)
    return make_banded_qp(
        g=r.uniform(-1.0, 1.0, n), a_val=r.uniform(0.8, 1.2, (2, m)) if m else None,
        a_offsets=(0, 2), c_l=np.ones(m), c_u=np.full(m, 1e20), x_l=np.zeros(n),
        x_u=np.full(n, 2.0), h_diags=h, block=8, cg_maxit=24, device="cpu")


@pytest.mark.parametrize("mode", ["pcg", "schur", "m0"])
def test_kkt_pcg_span_per_direct_step(mode):
    """``kkt.pcg`` opens once per S solve: 2 (1 + refine) times in each
    direct step of the PCG mode, each inside a ``kkt.solve``; never in the
    Schur or m = 0 modes."""
    trace.reset()
    ctl = IPMControl()
    (_, _, _, state), spans = profiled_spans(lambda: ipm_solve(mode_problem(mode), ctl))
    trace.reset()
    assert state.status == 0 and state.run.path == "direct"
    direct = [s for s in spans if s[0] == "stepper.direct"]
    pcg = [s for s in spans if s[0] == "kkt.pcg"]
    solves = [s for s in spans if s[0] == "kkt.solve"]
    assert len(direct) == state.iter > 0
    want = 2 * (1 + ctl.refine) if mode == "pcg" else 0
    assert [sum(inside(s, d) for s in pcg) for d in direct] == [want] * len(direct)
    assert len(pcg) == want * len(direct)
    assert all(any(inside(s, k) for k in solves) for s in pcg)


@pytest.mark.parametrize("b,ops,entries", [
    # b = 1: per direction two divisions and one multiply-add (2 + 2 ops);
    # read the two 1 x 1 factors, the one off-diagonal entry and the two of
    # the right-hand side, write the two of the solution
    (1, 2 * (2 + 2), 2 + 1 + 2 + 2),
    # b = 8: per direction two triangular solves (28 multiply-adds and 8
    # divisions each: 64 ops) and one 8 x 8 product (128 ops); the factors'
    # lower triangles (36 each), one 8 x 8 block, 16 entries in and 16 out
    (8, 2 * (2 * 64 + 128), 2 * 36 + 64 + 16 + 16),
])
def test_banded_solve_counts_by_hand(b, ops, entries):
    assert banded_solve.block_tridiagonal_solve(2, b, 8) == (float(ops), float(entries * 8))
    assert banded_solve.block_tridiagonal_solve(2, b, 4)[1] == float(entries * 4)


def load_metric(name: str):
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeTrace:
    """A trace that holds ``count`` launches of one kernel over ``seconds``."""

    def __init__(self, name: str, seconds: float, count: int):
        self.kernels = {name: [seconds, count]}

    def device_seconds(self, pattern, exclude=None):
        import re

        hit = [(s, c) for k, (s, c) in self.kernels.items()
               if re.search(pattern, k) and not (exclude and re.search(exclude, k))]
        return sum(s for s, _ in hit), sum(c for _, c in hit)


KERNEL = "void solve_kernel<double, 8>(double const*, double const*, double const*, double*)"


def fake_run(trace_=None, solves=(798 * 12, 798 * 14), iterations=(12, 14)):
    run = harness.Run(cell=None, dtype="float64")
    run.requests = [dict(iterations=i, launches=dict(banded_solve=s))
                    for s, i in zip(solves, iterations)]
    run.traced = [dict(r) for r in run.requests] if trace_ is not None else []
    run.trace = trace_
    run.shapes = dict(banded_k=2500, banded_b=8) if trace_ is not None else None
    return run


@pytest.mark.parametrize("name", ["banded_solve_roofline", "banded_solves_per_iteration"])
def test_metrics_read_none_without_a_trace(name):
    assert load_metric(name).read(fake_run()) is None


@pytest.mark.parametrize("count,kernel,want", [
    (798 * 26, KERNEL, True),
    (798 * 26 - 1, KERNEL, False),              # a launch the counters did not see
    (798 * 26, KERNEL.replace("double*)", "double*, Ring)"), False),   # the library's
])
def test_banded_solve_roofline_counts_against_the_trace(count, kernel, want):
    seconds = 798 * 26 * 150e-6
    value = load_metric("banded_solve_roofline").read(fake_run(FakeTrace(kernel, seconds, count)))
    if not want:
        assert value is None
        return
    ops, nbytes = banded_solve.block_tridiagonal_solve(2500, 8, 8)
    assert value == pytest.approx(100.0 * peaks.bound_s(ops, nbytes, "float64") / 150e-6)
    assert 0 < value < 100


def test_banded_solves_per_iteration_reads_the_traced_requests():
    run = fake_run(FakeTrace(KERNEL, 1.0, 1))
    assert load_metric("banded_solves_per_iteration").read(run) == pytest.approx(798.0)
    run.traced = [dict(r, launches={}) for r in run.traced]
    assert load_metric("banded_solves_per_iteration").read(run) is None
