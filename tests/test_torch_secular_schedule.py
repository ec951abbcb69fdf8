"""The host side of the secular kernels (galahad_tpu_torch/tr/secular_kernels.py,
csrc/secular.cu), on the CPU: the schedule that fits the lanes per problem to
n, the bound and critical-path reckoning, the wrappers' refusal of CPU
tensors, and the premise of the kernels' stop test.

The kernels stop each problem at its first Newton step with |step| <= 4 eps
|s| taken where the relative residual is at most sqrt(eps); the plain
versions (tr/trs.py::secular_newton_plain, rqs_newton_plain: the JAX
package's loops) run every iteration.  A test-local mirror of the loops with
that stop (``mirror``: the plain arithmetic, or the kernels' own, one
reciprocal per entry and one division per step) is held here against the
plain versions, on a 128-problem slice of the reference's headline batch
(chip_smoke.py::headline_batch) and of its hard-case variant: the
kernels' tolerances (1e-12 relative in float64, 1e-5 in float32), and 2e-15
within at most 16 iterations for the plain arithmetic in float64.  The
kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import math

import numpy as np
import pytest
import torch

from galahad_tpu_torch.linalg.ldlt_kernels import H100_BYTES_PER_S, H100_FLOPS
from galahad_tpu_torch.tr import secular_kernels as S
from galahad_tpu_torch.tr import trs as T

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SLICE = 128
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

NS = (1, 8, 16, 32, 33, 64, 65, 128, 129, 200, 256, 257, 1000, 14_464, 20_000)


@pytest.mark.parametrize("n", NS)
def test_schedule_covers_every_problem_once(n):
    """For B in {1, 37, 1024}, f64 and f32: every problem has exactly one
    group of lanes (or one block); a register layout holds all n entries; a
    block fits in 227 KB of shared memory and holds as many entries there as
    fit."""
    for B in (1, 37, 1024):
        for dtype in (torch.float64, torch.float32):
            check_schedule(B, n, dtype)


def check_schedule(B, n, dtype):
    sch = S.secular_schedule(B, n, dtype)
    assert sch["threads"] % 32 == 0 and 32 <= sch["threads"] <= 1024
    seen = np.zeros(B, np.int64)
    if sch["lanes"]:
        lanes, ppb = sch["lanes"], sch["problems_per_block"]
        assert sch["layout"] == ("warp" if lanes == 32 else "group")
        assert ppb * lanes == sch["threads"] and 32 % lanes == 0
        assert n <= lanes * sch["entries_per_lane"]
        smaller = [ln * r for ln, r in S.REG_LAYOUTS if ln < lanes]
        assert all(n > cap for cap in smaller), "the fewest lanes that hold n"
        for b in range(sch["blocks"]):
            for g in range(ppb):
                if b * ppb + g < B:
                    seen[b * ppb + g] += 1
        assert (sch["blocks"] - 1) * ppb < B
        assert sch["smem_bytes"] == 0
    else:
        assert sch["layout"] == "block" and n > 32 * 8 and sch["blocks"] == B
        seen += 1
        size = torch.finfo(dtype).bits // 8
        assert sch["smem_bytes"] <= S.SMEM_LIMIT <= 227 * 1024
        assert sch["smem_entries"] == min(n, (S.SMEM_LIMIT - 4 * 32 * size) // (2 * size))
        assert sch["threads"] * sch["entries_per_lane"] >= n
        assert sch["threads"] // 32 <= S.BLOCK_PARTS
    assert (seen == 1).all()


@pytest.mark.parametrize("n", NS)
def test_schedule_lanes_depend_on_n_only(n):
    """A problem's answer may depend on its lanes, so they are a function of
    n: the same problem gives the same bits in any batch."""
    scheds = [S.secular_schedule(B, n) for B in (1, 2, 37, 1024, 5000)]
    assert len({(s["lanes"], s["entries_per_lane"] if s["lanes"] else s["threads"])
                for s in scheds}) == 1
    assert scheds[0]["lanes"] == (16 if n <= 64 else 32 if n <= 256 else 0)


# ---------------------------------------------------------------------------
# The bound and the critical path
# ---------------------------------------------------------------------------


def test_bound_terms():
    """Bytes: lam and ct2 read once and three values per problem; the
    operations of the iterations the problems took, not of the cap."""
    B, n = 1024, 64
    tb, to = S.trs_bound_terms(B, n, 6000, torch.float64)
    assert tb == pytest.approx((2 * B * n + 3 * B) * 8 / H100_BYTES_PER_S, rel=1e-15)
    assert to == pytest.approx((B * n + 6000 * n * S.OPS_PER_ENTRY) / H100_FLOPS[torch.float64],
                               rel=1e-15)
    assert S.trs_bound_terms(B, n, 12000, torch.float64)[1] > to
    rb, ro = S.rqs_bound_terms(B, n, 10000, torch.float32)
    assert rb == pytest.approx((2 * B * n * 4 + B * n + 4 * B * 4) / H100_BYTES_PER_S, rel=1e-15)
    assert ro == pytest.approx(10000 * n * (S.OPS_PER_ENTRY + 2) / H100_FLOPS[torch.float32],
                               rel=1e-15)


def test_critical_path_and_percentiles():
    its = torch.tensor([3, 7, 5, 16, 6], dtype=torch.int32)
    assert S.critical_path_steps(its) == 16
    assert S.critical_path_steps(its, growth=torch.tensor([9, 0, 0, 0, 0])) == 16
    assert S.critical_path_steps(its, growth=torch.tensor([0, 10, 0, 0, 0])) == 17
    assert S.critical_path_steps(torch.zeros(0, dtype=torch.int32)) == 0
    assert S.iteration_percentiles(its) == dict(min=3, p50=6, p90=16, max=16)
    assert S.iteration_percentiles(torch.arange(1, 11)) == dict(min=1, p50=5, p90=9, max=10)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def test_wrappers_refuse_cpu_tensors():
    """On the CPU the dispatch in tr/trs.py takes the plain versions; the
    wrappers themselves launch a kernel or raise, and count nothing."""
    S.reset_secular_counts()
    z = torch.zeros(4, 8, dtype=torch.float64)
    one = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        S.trs_secular_newton(z, z, one, one, 64)
    with pytest.raises(ValueError, match="CUDA"):
        S.trs_secular_newton(z, z, one, one, 64, iterations=True)
    with pytest.raises(ValueError, match="CUDA"):
        S.rqs_secular_newton(z, z, torch.zeros(4, 8, dtype=torch.bool), one, 3.0, one, one, 96)
    assert S.secular_counts() == dict(trs=0, rqs=0, trs_plain=0, rqs_plain=0)


# ---------------------------------------------------------------------------
# The premise of the stop
# ---------------------------------------------------------------------------


def headline_slice(hard: bool):
    """The first SLICE problems of chip_smoke.py::headline_batch (the
    reference's bench.py:94-97 data); with ``hard`` its hard-case variant
    (chip_smoke.py::hard_equality_batch: every third c without a part along
    the leftmost eigenvector, and c scaled by 0.01)."""
    rng = np.random.default_rng(0)
    Bm = rng.normal(size=(1024, 64, 64))[:SLICE]
    H = (Bm + np.swapaxes(Bm, -1, -2)) / 2
    radius = rng.uniform(0.1, 2.0, size=1024)[:SLICE]
    c = np.random.default_rng(1).normal(size=(1024, 64))[:SLICE]
    H, c, radius = (torch.as_tensor(a) for a in (H, c, radius))
    if hard:
        _, Q = torch.linalg.eigh(H)
        ct = (Q.mT @ c[..., None])[..., 0]
        ct[::3, 0] = 0.0
        c = (Q @ (0.01 * ct)[..., None])[..., 0]
    return H, c, radius


def trs_mirror(lam, ct2, radius, lam_lo, max_its, arith):
    """secular_newton_plain with the kernel's stop, per problem; ``arith``
    "plain" keeps the plain version's formulas, "kernel" takes csrc/
    secular.cu's (one reciprocal per entry, the step n2 (nrm/r - 1) / d3).
    Returns (s, iterations)."""
    eps = torch.finfo(lam.dtype).eps
    s_hi0 = lam_lo + torch.sqrt(ct2.sum(-1)) / radius + 1.0
    s = 0.5 * (lam_lo + s_hi0)
    lo, hi = lam_lo, s_hi0
    inv_r = 1.0 / radius
    done = torch.zeros_like(s, dtype=torch.bool)
    its = torch.zeros_like(s, dtype=torch.int32)
    for i in range(max_its):
        d = lam + s[..., None]
        if arith == "plain":
            n2, d3 = (ct2 / d ** 2).sum(-1), (ct2 / d ** 3).sum(-1)
        else:
            r = 1.0 / d
            u = ct2 * r * r
            n2, d3 = u.sum(-1), (u * r).sum(-1)
        nrm = torch.sqrt(n2)
        psi = 1.0 / nrm - 1.0 / radius
        if arith == "plain":
            up, down = psi < 0, psi > 0
        else:
            up, down = nrm > radius, nrm < radius
        nlo = torch.where(up, torch.maximum(lo, s), lo)
        nhi = torch.where(down, torch.minimum(hi, s), hi)
        nhi = torch.where(nhi <= nlo, nlo + (s_hi0 - lam_lo) * (2.0 ** i), nhi)
        res = nrm * inv_r - 1.0
        if arith == "plain":
            dpsi = d3 / (n2 * nrm)
            step = -psi / torch.where(dpsi.abs() > eps, dpsi, 1.0)
        else:
            step = torch.where(d3.abs() > eps * n2 * nrm, n2 * res / d3, inv_r - 1.0 / nrm)
        s_new = s + step
        bad = (s_new <= nlo) | (s_new >= nhi) | ~torch.isfinite(s_new)
        stop = torch.isfinite(step) & (step.abs() <= 4 * eps * s.abs()) & (res.abs() <= eps ** 0.5)
        ns = torch.where(bad & ~stop, 0.5 * (nlo + nhi), torch.where(bad, s, s_new))
        live = ~done
        s = torch.where(live, ns, s)
        lo, hi = torch.where(live, nlo, lo), torch.where(live, nhi, hi)
        its += live.to(torch.int32)
        done |= stop
    return s, its


def rqs_mirror(lam, ct2, excl, sigma, p, lam_lo, hi0, max_its):
    """rqs_newton_plain with the kernel's arithmetic and stop (none in
    float32 at p other than 3 and 4)."""
    dt = lam.dtype
    eps = torch.finfo(dt).eps
    pm2 = p - 2.0
    k = 1.0 / pm2
    inv_sigma, c1 = 1.0 / sigma, 1.0 / (pm2 * sigma)
    power = {1.0: lambda x: x, 2.0: torch.sqrt}.get(pm2, lambda x: x ** k)
    stops = dt == torch.float64 or pm2 in (1.0, 2.0)
    ct2 = torch.where(excl, 0.0, ct2)

    def theta(s):
        d = lam + s[..., None]
        d = torch.where(d.abs() < eps, eps, d)
        r = 1.0 / d
        u = ct2 * r * r
        nrm = torch.sqrt(u.sum(-1))
        v = power(torch.clamp(s, min=0.0) * inv_sigma)
        return v - nrm, v, nrm, (u * r).sum(-1)

    hi = hi0
    for _ in range(60):
        hi = torch.where(theta(hi)[0] < 0, hi * 2.0 + 1.0, hi)
    lo = lam_lo
    s = 0.5 * (lo + hi)
    done = torch.zeros_like(s, dtype=torch.bool)
    its = torch.zeros_like(s, dtype=torch.int32)
    for _ in range(max_its):
        th, v, nrm, d3 = theta(s)
        nlo = torch.where(th < 0, torch.maximum(lo, s), lo)
        nhi = torch.where(th > 0, torch.minimum(hi, s), hi)
        sn = s * nrm
        den = k * v * nrm + d3 * s
        fast = torch.where(den.abs() > eps * sn, -th * sn / den, -th)
        dpow = (torch.clamp(s, min=eps) / sigma) ** (k - 1.0)
        dth = c1 * dpow + d3 / torch.where(nrm > eps, nrm, 1.0)
        slow = -th / torch.where(dth.abs() > eps, dth, 1.0)
        step = torch.where((s >= eps) & (nrm > eps), fast, slow)
        s_new = s + step
        bad = (s_new <= nlo) | (s_new >= nhi) | ~torch.isfinite(s_new)
        stop = torch.isfinite(step) & (step.abs() <= 4 * eps * s.abs()) \
            & (th.abs() <= eps ** 0.5 * nrm) & stops
        ns = torch.where(bad & ~stop, 0.5 * (nlo + nhi), torch.where(bad, s, s_new))
        live = ~done
        s = torch.where(live, ns, s)
        lo, hi = torch.where(live, nlo, lo), torch.where(live, nhi, hi)
        its += live.to(torch.int32)
        done |= stop
    return s, its


def rel(a, b):
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) if b.numel() else 0.0


def test_stop_premise_on_the_plain_loop():
    """float64, the plain arithmetic: every problem of the slice stops within
    16 iterations, and s within 2e-15 of secular_newton_plain's 64."""
    H, c, radius = headline_slice(hard=False)
    lam, ct, _ = T._eigh_M(H, c)
    ct2 = ct * ct
    lam_lo = torch.clamp(-lam.min(-1).values, min=0.0)
    s, its = trs_mirror(lam, ct2, radius, lam_lo, 64, "plain")
    assert int(its.max()) <= 16
    assert rel(s, T.secular_newton_plain(lam, ct2, radius, lam_lo, 64)) <= 2e-15


def eigen_data(hard, dtype):
    H, c, radius = (a.to(dtype) for a in headline_slice(hard))
    lam, ct, _ = T._eigh_M(H, c)
    ct2 = ct * ct
    _, at_min, c_in_min = T._min_eigen(lam, ct, ct2, torch.finfo(dtype).eps)
    return H, c, radius, lam, ct2, at_min & ~c_in_min[..., None]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("cap", [1, 2, 64])
def test_trs_kernel_arithmetic_holds_the_tolerance(cap, hard, dtype):
    """The kernel's TRS arithmetic and stop against secular_newton_plain at
    the same cap, on the raw eigen-data (lam_lo = max(-lam_min, 0), hard
    cases included): within TOL, no count above the cap."""
    _, _, radius, lam, ct2, _ = eigen_data(hard, dtype)
    lam_lo = torch.clamp(-lam.min(-1).values, min=0.0)
    s, its = trs_mirror(lam, ct2, radius, lam_lo, cap, "kernel")
    assert int(its.max()) <= cap
    assert rel(s, T.secular_newton_plain(lam, ct2, radius, lam_lo, cap)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("p", [3.0, 4.0, 2.5])
def test_rqs_kernel_arithmetic_holds_the_tolerance(p, hard, dtype):
    """The kernel's RQS arithmetic and stop against rqs_newton_plain (96
    steps) where rqs_solve uses s (not its hard cases, where it takes lam_lo):
    within TOL, no count above the cap."""
    _, _, radius, lam, ct2, excl = eigen_data(hard, dtype)
    lam_lo = torch.clamp(-lam.min(-1).values, min=0.0)
    sigma, pm2 = 1.0 / radius, p - 2.0
    hi = lam_lo + sigma ** (1 / (p - 1)) * ct2.sum(-1) ** (pm2 / (2 * (p - 1))) \
        + torch.clamp(lam_lo, min=1.0)
    s, its = rqs_mirror(lam, ct2, excl, sigma, p, lam_lo, hi, 96)
    plain = T.rqs_newton_plain(lam, ct2, excl, sigma, p, lam_lo, hi, 96)
    norm_lo = T._rqs_theta(lam, ct2, excl, sigma, pm2, lam_lo)[1]
    easy = ~(excl.any(-1) & (lam.min(-1).values < 0) & (norm_lo < (lam_lo / sigma) ** (1 / pm2)))
    assert int(its.max()) <= 96
    assert rel(s[easy], plain[easy]) <= TOL[dtype]
    if not hard and (dtype == torch.float64 or p in (3.0, 4.0)):
        assert int(its.float().median()) <= 32, "the stop must cut the median problem short"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solver_inputs_hold_the_tolerance(dtype, monkeypatch):
    """On the inputs trs_solve (with and without equality_problem) and
    rqs_solve give the secular iterations on the hard slice, hard cases'
    stand-in problems included: the mirror within TOL of the plain versions
    on every TRS problem and every RQS problem whose s is used."""
    H, c, radius, *_ = eigen_data(True, dtype)
    got = dict(trs=[], rqs=[])
    orig_trs, orig_rqs = T._secular_newton, T._rqs_newton
    monkeypatch.setattr(T, "_secular_newton", lambda *a: (got["trs"].append(a), orig_trs(*a))[1])
    monkeypatch.setattr(T, "_rqs_newton", lambda *a: (got["rqs"].append(a), orig_rqs(*a))[1])
    T.trs_solve(H, c, radius)
    T.trs_solve(H, c, radius, ctl=T.TRSControl(equality_problem=True))
    info = T.rqs_solve(H, c, 1.0 / radius)
    assert len(got["trs"]) == 2 and len(got["rqs"]) == 1
    for lam, ct2, rad, lam_lo, its in got["trs"]:
        rad = rad.expand(lam.shape[:-1])
        s, n_its = trs_mirror(lam, ct2, rad, lam_lo, its, "kernel")
        assert int(n_its.max()) <= its
        assert rel(s, orig_trs(lam, ct2, rad, lam_lo, its)) <= TOL[dtype]
    lam, ct2, excl, sigma, p, lam_lo, hi0, its = got["rqs"][0]
    sigma = sigma.expand(lam.shape[:-1])
    s, _ = rqs_mirror(lam, ct2, excl, sigma, p, lam_lo, hi0, its)
    easy = ~info.hard_case
    assert rel(s[easy], orig_rqs(lam, ct2, excl, sigma, p, lam_lo, hi0, its)[easy]) <= TOL[dtype]


def test_hard_cases_stand_in_problem_stops_at_once(monkeypatch):
    """trs_solve hands a hard case's secular iteration a problem whose root
    is its start, s = 1 (its s is not used): it stops after one iteration,
    and trs_solve's multiplier there is lam_lo."""
    H, c, radius, *_ = eigen_data(True, torch.float64)
    got = []
    orig = T._secular_newton
    monkeypatch.setattr(T, "_secular_newton", lambda *a: (got.append(a), orig(*a))[1])
    info = T.trs_solve(H, c, radius)
    hard = info.hard_case
    assert int(hard.sum()) > 0
    lam, ct2, rad, lam_lo, its = got[0]
    s, n_its = trs_mirror(lam, ct2, rad.expand(lam.shape[:-1]), lam_lo, its, "kernel")
    assert (n_its[hard] == 1).all()
    assert float((s[hard] - 1.0).abs().max()) <= 4 * math.ulp(1.0)
    lam_lo = torch.clamp(-T._eigh(H)[0].min(-1).values, min=0.0)
    assert torch.equal(info.multiplier[hard], lam_lo[hard])
