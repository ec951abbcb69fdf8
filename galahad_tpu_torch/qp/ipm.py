"""Primal-dual interior-point method for convex QP / LP.

Counterpart of galahad_tpu/qp/ipm.py (the CQP-class solve: reference
src/cqp/cqp.f90, CQP_solve :1178, CQP_solve_main :2967).  Same infeasible
primal-dual framework: explicit slack variable c with two-sided bounds,
z = z_l - z_u, y = y_l - y_u, Mehrotra predictor-corrector (the
reference's Zhang arc at Taylor order 2) or a series arc ("taylor",
"puiseux", "zhao_sun": ROOTS step lengths along the truncated arcs), the
per-iteration KKT system

    [[H + D_x, A'], [A, -D_c^-1]] [dx; -dy] = [b1; b2]

solved, for a ``SparseQP``, by the supernodal LDL^T of
linalg/supernodal_flat.py, for a ``BandedQP`` (qp/ipm_banded.py) by the
block-tridiagonal Cholesky of linalg/banded.py and, for a dense ``QP``, by
SBLS's Schur-complement Cholesky pair (linalg/sbls.py), each with iterative
refinement instead of dynamic pivoting.

What differs from the JAX module, and why:

  * The iterate is plain float64 (the default) or float32.  The JAX
    package carries every iterate as a double-word (hi, lo) pair and has
    a float64 "island" for float32 hardware; a card with native float64
    needs neither, so ``IPMState`` has no ``*_lo`` fields.
  * One iteration (``ipm_step``) is plain tensor code with the
    KKT factorize and solves in between, and makes no host read: the
    convergence test, the failure guards, the WCP centrality test and the
    non-finite rollback are decided on the device (JAX ``ipm_step``'s
    tail), and a step on a halted state changes nothing.  On the card
    ``ipm_solve`` captures it once per solve as a CUDA graph and replays
    it (qp/fused.py, the counterpart of the JAX package's one fused jitted
    step per iteration); ``GALAHAD_TPU_FUSED=0`` runs it directly, as on
    the CPU.  The host reads one small monitor tensor per
    ``steps_per_fetch`` iterations.
  * ``clock_time_limit`` counts ALL wall time (the JAX host loop leaves its
    first, compile-dominated round out).
  * A dense factorization that fails at its first try is not retried
    inside the step (a replayed graph cannot branch on it): the step
    changes nothing and sets ``needs_shift``, and the driver takes the
    iteration again with the JAX package's escalating shift
    (``ipm_step(..., escalate=True)``, qp/fused.py), counted in
    ``RunStats.escalations``.
  * ``endgame_f64`` is accepted and ignored.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import numpy as np
import torch

from ..core.checkpoint import checkpoint_init, checkpoint_update
from ..core.config import control as control_dc
from ..core.problem import H_KINDS, INFINITY, QP, BoundMasks, check_qp, classify_bounds, make_qp
from ..core.sparse import make_sparse_qp
from ..core.status import Status
from ..linalg import supernodal_flat as _flat
from .fused import Stepper, fused_enabled

BIG = 1.0e20
ARCS = ("mehrotra", "taylor", "puiseux", "zhao_sun")
SERIES_ARCS = ARCS[1:]
CHOL_MAX_TRIES = 12          # shift escalations of a dense factorization (the JAX default)


@control_dc
class IPMControl:
    """Same fields and defaults as the JAX package's ``IPMControl``
    (mirroring CQP_control_type, reference src/cqp/cqp.f90:134-343), so
    specfiles carry over."""

    maxit: int = 200
    stop_abs_p: float = 1.0e-6
    stop_rel_p: float = 0.0
    stop_abs_d: float = 1.0e-6
    stop_rel_d: float = 0.0
    stop_abs_c: float = 1.0e-6
    stop_rel_c: float = 0.0
    prfeas: float = 1.0e2       # min initial distance from primal bounds
    dufeas: float = 1.0e2       # initial magnitude of dual variables
    rho: float = 0.0            # primal regularization (0 -> 1e-8)
    delta: float = 1.0e-8       # dual regularization on equality rows
    refine: int = 2             # iterative-refinement sweeps per solve
    steps_per_fetch: int = 1    # iterations per host read of the monitor
    tau: float = 0.995          # fraction-to-boundary factor
    series_order: int = 2       # 1 = pure Newton, 2 = Mehrotra PC, 3+ extra correctors
    arc: str = "mehrotra"       # | "taylor" | "puiseux" | "zhao_sun" (series arcs)
    print_level: int = 0        # >= 1: one line per iteration on stdout
    mu_min_factor: float = 1.0e-12
    mu_target: float = 0.0      # > 0: stop the barrier AT this value and
                                # converge to the centred point (WCP mode)
    gamma_c: float = 0.1        # centrality band [gamma*mu_t, mu_t/gamma]
    infeas_max: int = 10        # consecutive non-improving iterations before
                                # declaring infeasibility (cqp.f90:163-168)
    indicator_type: str = "pd_ratio"   # 'primal' | 'pd_ratio' | 'tapia'
    indicator_tol_p: float = 1.0e-5    # primal-distance activity cutoff
    indicator_tol_pd: float = 1.0      # dual/primal magnitude ratio cutoff
    indicator_tol_tapia: float = 0.9   # Tapia iterate-ratio cutoff
    reduce_infeas: float = 0.98  # required per-iteration infeasibility factor
    clock_time_limit: float = -1.0  # wall seconds, all phases; < 0 = no limit
    infinity: float = INFINITY
    dtype: str = "float64"
    endgame_f64: bool = True    # accepted and ignored: there is no
                                # float32-with-float64-island mode


def _check_control(ctl: IPMControl) -> None:
    if ctl.arc not in ARCS:
        raise NotImplementedError(
            f"IPMControl.arc={ctl.arc!r}: the arcs are {', '.join(ARCS)}")
    if ctl.series_order < 1:
        raise NotImplementedError("IPMControl.series_order must be >= 1")


@dataclasses.dataclass
class IPMState:
    x: Any
    c: Any
    y: Any            # (m,) full multiplier: y_l - y_u on inequality, free on equality
    z_l: Any
    z_u: Any
    y_l: Any
    y_u: Any
    s_l: Any          # carried bound distances x - x_l (DIST_X_l: the
    s_u: Any          # reference maintains these explicitly rather than
    t_l: Any          # recomputing x - x_l, which cancels near convergence)
    t_u: Any
    mu: Any           # 0-d tensor
    # 0-d tensors on the iterate's device while the solve runs (the step
    # decides them there); the state ipm_solve returns holds them as Python
    # values, read in its last fetch
    iter: Any = 0
    converged: Any = False
    halt: Any = False          # stop the loop (success OR declared failure)
    status: Any = int(Status.MAX_ITERATIONS)
    res_p: Any = float("inf")
    res_d: Any = float("inf")
    res_c: Any = float("inf")
    best_infeas: Any = float("inf")     # best primal infeasibility so far
    stall: Any = 0             # consecutive non-improving iterations
    needs_shift: Any = False   # the last step's dense factorization failed at
                               # its first try: it changed nothing else
    inform: Any = None         # IPMInform, set by ipm_solve
    run: Any = None            # fused.RunStats: how the iterations ran


VECTOR_FIELDS = ("x", "c", "y", "z_l", "z_u", "y_l", "y_u",
                 "s_l", "s_u", "t_l", "t_u", "mu")
# the scalar fields and their tensor types (None: the iterate's)
SCALAR_FIELDS = dict(iter=torch.int32, converged=torch.bool, halt=torch.bool,
                     status=torch.int32, res_p=None, res_d=None, res_c=None,
                     best_infeas=None, stall=torch.int32, needs_shift=torch.bool)
TENSOR_FIELDS = VECTOR_FIELDS + tuple(SCALAR_FIELDS)
# what the host reads of a state, in this order, as one tensor of the
# iterate's type (small integers and flags are exact in float32 too)
MONITOR = ("res_p", "res_d", "res_c", "mu", "halt", "iter", "status",
           "converged", "stall", "best_infeas", "needs_shift")


def device_state(st: IPMState) -> IPMState:
    """``st`` with every scalar field a 0-d tensor on the iterate's device
    (the form the step takes; a no-op for a state that already has it)."""
    like = st.x
    upd = {name: torch.tensor(getattr(st, name), dtype=dt or like.dtype,
                              device=like.device)
           for name, dt in SCALAR_FIELDS.items()
           if not torch.is_tensor(getattr(st, name))}
    return dataclasses.replace(st, **upd) if upd else st


def monitor(st: IPMState):
    """The monitor tensor of ``st`` (fields ``MONITOR``; of a batched state a
    row per problem)."""
    return torch.stack([getattr(st, f).to(st.x.dtype) for f in MONITOR], dim=-1)


def host_state(st: IPMState, values) -> IPMState:
    """``st`` with its scalar fields as Python values, from ``values``, the
    host copy of its monitor."""
    v = dict(zip(MONITOR, values))
    return dataclasses.replace(
        st, iter=int(v["iter"]), converged=bool(v["converged"]),
        halt=bool(v["halt"]), status=int(v["status"]), res_p=v["res_p"],
        res_d=v["res_d"], res_c=v["res_c"], best_infeas=v["best_infeas"],
        stall=int(v["stall"]), needs_shift=bool(v["needs_shift"]))


def _select(cond, a: IPMState, b: IPMState) -> IPMState:
    """Field by field ``a`` where the 0-d ``cond`` holds, else ``b``
    (a select: the chosen side's bits are kept)."""
    return dataclasses.replace(a, **{f: torch.where(cond, getattr(a, f), getattr(b, f))
                                     for f in TENSOR_FIELDS})


def _safe_div(a, b, mask):
    return torch.where(mask, a / torch.where(mask, b, 1.0), 0.0)


def _max0(t):
    """max of a possibly empty tensor, 0 when empty."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.dtype, device=t.device)
    return t.max()


def ipm_init(qp, masks: BoundMasks, ctl: IPMControl) -> IPMState:
    """Strictly interior starting point (reference cqp.f90:242-250: move
    the user point at least prfeas/dufeas inside the bounds)."""
    dt, device = qp.g.dtype, qp.g.device
    n, m = qp.n, qp.m
    x0 = qp.x if qp.x is not None else torch.zeros(n, dtype=dt, device=device)

    def interior(v, lo, hi, has_lo, has_hi, fixed, margin):
        gap = torch.where(has_lo & has_hi, hi - lo, float("inf"))
        xi = torch.clamp(0.4999 * gap, max=margin)
        v = torch.where(has_lo, torch.maximum(v, lo + xi), v)
        v = torch.where(has_hi, torch.minimum(v, hi - xi), v)
        return torch.where(fixed, lo, v)

    margin = float(ctl.prfeas)
    x = interior(x0, qp.x_l, qp.x_u, masks.has_xl, masks.has_xu,
                 masks.x_fixed, margin)
    if m > 0:
        c0 = qp.Ax(x)
        c = interior(c0, qp.c_l, qp.c_u, masks.has_cl, masks.has_cu,
                     masks.c_equality, margin)
    else:
        c = torch.zeros(0, dtype=dt, device=device)

    duf = float(ctl.dufeas)
    zero_n = torch.zeros(n, dtype=dt, device=device)
    zero_m = torch.zeros(m, dtype=dt, device=device)
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    z_l = torch.where(ml_x, duf, zero_n)
    z_u = torch.where(mu_x, duf, zero_n)
    y_l = torch.where(ml_c, duf, zero_m)
    y_u = torch.where(mu_c, duf, zero_m)
    y0 = qp.y if qp.y is not None else zero_m
    y = torch.where(masks.c_equality, y0, y_l - y_u)

    s_l, s_u, t_l, t_u = _distances(qp, masks, x, c)
    mu = _avg_complementarity(masks, s_l, s_u, t_l, t_u, z_l, z_u, y_l, y_u)
    return device_state(IPMState(x=x, c=c, y=y, z_l=z_l, z_u=z_u, y_l=y_l,
                                 y_u=y_u, s_l=s_l, s_u=s_u, t_l=t_l, t_u=t_u,
                                 mu=mu))


def _distances(qp, masks: BoundMasks, x, c):
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    s_l = torch.where(ml_x, x - qp.x_l, 1.0)
    s_u = torch.where(mu_x, qp.x_u - x, 1.0)
    t_l = torch.where(ml_c, c - qp.c_l, 1.0)
    t_u = torch.where(mu_c, qp.c_u - c, 1.0)
    return s_l, s_u, t_l, t_u


def _avg_complementarity(masks, s_l, s_u, t_l, t_u, z_l, z_u, y_l, y_u):
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    total = (
        torch.where(ml_x, z_l * s_l, 0.0).sum()
        + torch.where(mu_x, z_u * s_u, 0.0).sum()
        + torch.where(ml_c, y_l * t_l, 0.0).sum()
        + torch.where(mu_c, y_u * t_u, 0.0).sum()
    )
    count = (ml_x.sum() + mu_x.sum() + ml_c.sum() + mu_c.sum()).to(total.dtype)
    return total / torch.clamp(count, min=1.0)


def _residual_vectors(qp, masks: BoundMasks, st: IPMState):
    """Componentwise (r_d, r_p): r_d = Hx + g - z - A'y, r_p = Ax - c."""
    z = st.z_l - st.z_u
    if qp.m > 0:
        r_d = qp.Hx(st.x) + qp.g - z - qp.Aty(st.y)
        r_p = qp.Ax(st.x) - st.c
    else:
        r_d = qp.Hx(st.x) + qp.g - z
        r_p = torch.zeros(0, dtype=qp.g.dtype, device=qp.g.device)
    r_d = torch.where(masks.x_fixed, 0.0, r_d)
    return r_d, r_p


def _comp_inf(qp, masks: BoundMasks, st: IPMState):
    """inf-norm of the complementarity products (carried distances)."""
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    comp = torch.maximum(
        _max0(torch.where(ml_x, (st.z_l * st.s_l).abs(), 0.0)),
        _max0(torch.where(mu_x, (st.z_u * st.s_u).abs(), 0.0)))
    if qp.m > 0:
        comp = torch.maximum(comp, torch.maximum(
            _max0(torch.where(ml_c, (st.y_l * st.t_l).abs(), 0.0)),
            _max0(torch.where(mu_c, (st.y_u * st.t_u).abs(), 0.0))))
    return comp


def _fraction_to_boundary(v, dv, mask, tau):
    """max alpha <= 1 with v + alpha dv >= (1 - tau) v on masked entries."""
    one = torch.ones((), dtype=v.dtype, device=v.device)
    if v.numel() == 0:
        return one
    neg = mask & (dv < 0)
    ratio = torch.where(neg, -tau * v / torch.where(neg, dv, -1.0),
                        float("inf"))
    return torch.minimum(one, ratio.min())


def _active_masks(masks):
    return (masks.has_xl & ~masks.x_fixed, masks.has_xu & ~masks.x_fixed,
            masks.has_cl & ~masks.c_equality,
            masks.has_cu & ~masks.c_equality)


def _barrier_diagonals(qp, masks, st, ctl):
    """Primal-dual barrier diagonal terms (cqp.f90:4726-4740)."""
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    D_x = (
        torch.where(ml_x, st.z_l / st.s_l, 0.0)
        + torch.where(mu_x, st.z_u / st.s_u, 0.0)
        + torch.where(masks.x_fixed, BIG, torch.zeros_like(st.x))
    )
    if qp.m > 0:
        D_c = (torch.where(ml_c, st.y_l / st.t_l, 0.0)
               + torch.where(mu_c, st.y_u / st.t_u, 0.0))
        # (2,2) block of the augmented system: C = D_c^{-1}; equality rows
        # 0, vacuous (free) rows effectively infinite
        C_diag = torch.where(
            masks.c_equality, 0.0,
            torch.where(masks.c_free, BIG,
                        1.0 / torch.clamp(D_c, min=1.0 / BIG)))
    else:
        C_diag = torch.zeros(0, dtype=qp.g.dtype, device=qp.g.device)
    return D_x, C_diag


def _corr_terms(d_prev, affine):
    if affine:
        return dict(xl=0.0, xu=0.0, cl=0.0, cu=0.0)
    return dict(
        xl=d_prev["dz_l"] * d_prev["dx"],
        xu=-d_prev["dz_u"] * d_prev["dx"],
        cl=d_prev["dy_l"] * d_prev["dc"],
        cu=-d_prev["dy_u"] * d_prev["dc"],
    )


def _solve_direction(qp, masks, st, kkt_solve, C_diag, r_d, r_p, mu_t, corr,
                     first=True, res_scale=1.0):
    """Newton direction for target complementarity ``mu_t`` with the
    second-order correction terms ``corr`` (the JAX ``ipm_step``'s
    ``solve_direction``): the right-hand side, one KKT solve, and the
    recovery of the full direction.

    ``first=False`` computes a HIGHER-ORDER series coefficient: the linear
    (primal/dual) residuals are already removed by the order-1 term, so
    those blocks are zero and only the convolution ``corr`` drives the solve
    (one extra backsolve on the same factors, reference cqp.f90:345-349).
    ``res_scale`` scales the linear residuals and the SZ part of the
    complementarity base (the Puiseux arc puts 2x the residual at order 1,
    reference cqp.f90:5058-5095)."""
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    s_l, s_u, t_l, t_u = st.s_l, st.s_u, st.t_l, st.t_u
    scaled = res_scale != 1.0

    def base(v, dist):
        if not first:
            return mu_t
        return mu_t - (res_scale * v if scaled else v) * dist

    def linear(r):
        if not first:
            return torch.zeros_like(r)
        return res_scale * r if scaled else r

    r_cl = torch.where(ml_x, base(st.z_l, s_l) - corr["xl"], 0.0)
    r_cu = torch.where(mu_x, base(st.z_u, s_u) - corr["xu"], 0.0)
    b1 = -linear(r_d) + _safe_div(r_cl, s_l, ml_x) - _safe_div(r_cu, s_u, mu_x)
    b1 = torch.where(masks.x_fixed, 0.0, b1)
    if qp.m > 0:
        rp_k = linear(r_p)
        r_tl = torch.where(ml_c, base(st.y_l, t_l) - corr["cl"], 0.0)
        r_tu = torch.where(mu_c, base(st.y_u, t_u) - corr["cu"], 0.0)
        w = _safe_div(r_tl, t_l, ml_c) - _safe_div(r_tu, t_u, mu_c)
        b2 = torch.where(
            masks.c_free, 0.0,
            -rp_k + torch.where(masks.c_equality, 0.0, w * C_diag))
        dx, dy = kkt_solve(b1, b2)
        dc = qp.Ax(dx) + rp_k
        dy_l = _safe_div(r_tl - st.y_l * dc, t_l, ml_c)
        dy_u = _safe_div(r_tu + st.y_u * dc, t_u, mu_c)
    else:
        dc = torch.zeros(0, dtype=qp.g.dtype, device=qp.g.device)
        dx, _ = kkt_solve(b1, dc)
        dy = dy_l = dy_u = dc
    dz_l = _safe_div(r_cl - st.z_l * dx, s_l, ml_x)
    dz_u = _safe_div(r_cu + st.z_u * dx, s_u, mu_x)
    dx = torch.where(masks.x_fixed, 0.0, dx)
    return dict(dx=dx, dc=dc, dy=dy, dz_l=dz_l, dz_u=dz_u,
                dy_l=dy_l, dy_u=dy_u)


def _step_lengths(masks, st, d, tau):
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    s_l, s_u, t_l, t_u = st.s_l, st.s_u, st.t_l, st.t_u
    has_c = st.c.shape[-1] > 0
    a_p = torch.minimum(
        _fraction_to_boundary(s_l, d["dx"], ml_x, tau),
        _fraction_to_boundary(s_u, -d["dx"], mu_x, tau))
    # Dual-growth cap: the plain predictor-corrector has no central-path
    # neighborhood (the reference's gamma_f test, cqp.f90:4190-4229), so a
    # near-degenerate KKT solve can propose dual steps orders of magnitude
    # beyond the current duals.  Cap the dual step so the dual iterate
    # grows at most ~10x per iteration; inactive on healthy steps.
    dual_now = torch.maximum(
        _max0(torch.where(ml_x, st.z_l.abs(), 0.0)),
        _max0(torch.where(mu_x, st.z_u.abs(), 0.0)))
    step_max = torch.maximum(
        _max0(torch.where(ml_x, d["dz_l"].abs(), 0.0)),
        _max0(torch.where(mu_x, d["dz_u"].abs(), 0.0)))
    if has_c:
        dual_now = torch.maximum(dual_now, torch.maximum(
            _max0(torch.where(ml_c, st.y_l.abs(), 0.0)),
            _max0(torch.where(mu_c, st.y_u.abs(), 0.0))))
        step_max = torch.maximum(step_max, torch.maximum(
            _max0(torch.where(ml_c, d["dy_l"].abs(), 0.0)),
            _max0(torch.where(mu_c, d["dy_u"].abs(), 0.0))))
    a_cap = 10.0 * (dual_now + 1.0) / torch.clamp(step_max, min=1e-30)
    if has_c:
        a_p = torch.minimum(a_p, torch.minimum(
            _fraction_to_boundary(t_l, d["dc"], ml_c, tau),
            _fraction_to_boundary(t_u, -d["dc"], mu_c, tau)))
    a_d = torch.minimum(
        _fraction_to_boundary(st.z_l, d["dz_l"], ml_x, tau),
        _fraction_to_boundary(st.z_u, d["dz_u"], mu_x, tau))
    if has_c:
        a_d = torch.minimum(a_d, torch.minimum(
            _fraction_to_boundary(st.y_l, d["dy_l"], ml_c, tau),
            _fraction_to_boundary(st.y_u, d["dy_u"], mu_c, tau)))
    a_d = torch.minimum(a_d, a_cap)
    return a_p, a_d


def _centering(qp, masks, st, ctl, aff):
    """Centering (sigma, mu) from the affine predictor step: the target is
    sigma * mu."""
    s_l, s_u, t_l, t_u = st.s_l, st.s_u, st.t_l, st.t_u
    a_p, a_d = _step_lengths(masks, st, aff, ctl.tau)
    mu_now = _avg_complementarity(masks, s_l, s_u, t_l, t_u,
                                  st.z_l, st.z_u, st.y_l, st.y_u)
    mu_aff = _avg_complementarity(
        masks,
        s_l + a_p * aff["dx"], s_u - a_p * aff["dx"],
        t_l + a_p * aff["dc"], t_u - a_p * aff["dc"],
        st.z_l + a_d * aff["dz_l"], st.z_u + a_d * aff["dz_u"],
        st.y_l + a_d * aff["dy_l"], st.y_u + a_d * aff["dy_u"])
    mu_safe = torch.clamp(mu_now, min=1e-30)
    sigma = (mu_aff / mu_safe) ** 3
    sigma = torch.clamp(sigma, 1e-4, 1.0 - 1e-4)
    # Barrier floor: targeting mu below what the termination test needs
    # (comp <= stop_abs_c) only ill-conditions the KKT; floor the center
    # target a couple of orders under stop_abs_c (the mu_min role of the
    # reference's mu controls, cqp.f90:169-177,292-296).
    mu_floor = 3e-3 * ctl.stop_abs_c
    sigma = torch.minimum(torch.maximum(sigma, mu_floor / mu_safe),
                          torch.full_like(sigma, 10.0))
    if ctl.mu_target > 0:
        # WCP mode: the barrier target never drops below mu_target
        # (reference wcp.f90 drives pairs TO mu, not to zero)
        sigma = torch.clamp(torch.maximum(sigma, ctl.mu_target / mu_safe),
                            max=2.0)
    return sigma, mu_now


def _centred(qp, masks, st: IPMState, ctl):
    """WCP convergence: every active complementarity pair inside the band
    [gamma_c mu_t, mu_t / gamma_c] (the centred-point measures of
    WCP_solve, reference wcp.f90:935)."""
    lo, hi = ctl.gamma_c * ctl.mu_target, ctl.mu_target / ctl.gamma_c
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    pairs = [(st.z_l * st.s_l, ml_x), (st.z_u * st.s_u, mu_x)]
    if qp.m > 0:
        pairs += [(st.y_l * st.t_l, ml_c), (st.y_u * st.t_u, mu_c)]
    inside = [torch.where(mask, (p >= lo) & (p <= hi), True).all() for p, mask in pairs]
    return torch.stack(inside).all()


def _apply_direction(qp, masks, st: IPMState, ctl, d, a_p, a_d) -> IPMState:
    """Step tail: update, dual absorption, convergence test, failure
    guards and the non-finite rollback, all on the device (the tail of
    the JAX package's ``ipm_step``)."""
    dt = qp.g.dtype
    m = qp.m
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    s_l, s_u, t_l, t_u = st.s_l, st.s_u, st.t_l, st.t_u
    x = st.x + a_p * d["dx"]
    c = st.c + a_p * d["dc"]
    z_l = torch.where(ml_x, st.z_l + a_d * d["dz_l"], 0.0)
    z_u = torch.where(mu_x, st.z_u + a_d * d["dz_u"], 0.0)
    y_l = torch.where(ml_c, st.y_l + a_d * d["dy_l"], 0.0)
    y_u = torch.where(mu_c, st.y_u + a_d * d["dy_u"], 0.0)
    yf = st.y + a_d * d["dy"] if m > 0 else st.y
    y = torch.where(masks.c_equality, yf, y_l - y_u)
    # carried distances: incremental update at the DISTANCE's own scale
    # (never recomputed as x_u - x, which cancels near convergence: the
    # DIST_X/DIST_C state of cqp.f90).  The fraction-to-boundary rule keeps
    # s + a ds >= (1-tau) s > 0 up to rounding; the floor guards the rounding.
    dtiny = float(torch.finfo(dt).tiny) * 16.0
    ns_l = torch.where(ml_x, torch.clamp(s_l + a_p * d["dx"], min=dtiny), 1.0)
    ns_u = torch.where(mu_x, torch.clamp(s_u - a_p * d["dx"], min=dtiny), 1.0)
    nt_l = torch.where(ml_c, torch.clamp(t_l + a_p * d["dc"], min=dtiny), 1.0)
    nt_u = torch.where(mu_c, torch.clamp(t_u - a_p * d["dc"], min=dtiny), 1.0)

    new = dataclasses.replace(
        st, x=x, c=c, y=y, z_l=z_l, z_u=z_u, y_l=y_l, y_u=y_u,
        s_l=ns_l, s_u=ns_u, t_l=nt_l, t_u=nt_u,
        mu=_avg_complementarity(masks, ns_l, ns_u, nt_l, nt_u,
                                z_l, z_u, y_l, y_u),
        iter=st.iter + 1)
    # --- dual-residual absorption into bounded duals -------------------
    # z enters the dual residual linearly with coefficient -1, so wherever
    # a bound dual exists, z <- z + r_d zeroes that component EXACTLY while
    # perturbing complementarity by only s * |r_d|.  Guarded to fire only
    # when that perturbation is far below the stop tolerance and the dual
    # stays safely positive.
    r_d_vec, r_p_vec = _residual_vectors(qp, masks, new)
    tol_c = 0.1 * ctl.stop_abs_c
    take_l = (ml_x & (new.z_l >= new.z_u) & (r_d_vec >= -0.5 * new.z_l)
              & (new.s_l * r_d_vec.abs() <= tol_c))
    take_u = (mu_x & ~take_l & (r_d_vec <= 0.5 * new.z_u)
              & (new.s_u * r_d_vec.abs() <= tol_c))
    new = dataclasses.replace(
        new,
        z_l=new.z_l + torch.where(take_l, r_d_vec, 0.0),
        z_u=new.z_u + torch.where(take_u, -r_d_vec, 0.0))
    r_d_vec = torch.where(take_l | take_u, 0.0, r_d_vec)
    res_d = _max0(r_d_vec.abs())
    res_p = _max0(r_p_vec.abs())
    res_c = _comp_inf(qp, masks, new)
    feas_now = res_p <= ctl.stop_abs_p
    if ctl.mu_target > 0:
        conv = feas_now & (res_d <= ctl.stop_abs_d) & _centred(qp, masks, new, ctl)
    else:
        conv = feas_now & (res_d <= ctl.stop_abs_d) & (res_c <= ctl.stop_abs_c)
    # --- failure guards ------------------------------------------------
    # Divergence: infeas_max consecutive iterations without the primal
    # infeasibility improving by reduce_infeas -> declare infeasible
    # (reference cqp.f90:163-168 control semantics).
    improved = res_p <= ctl.reduce_infeas * st.best_infeas
    stall = torch.where(improved | feas_now, 0, st.stall + 1)
    # Stalled step lengths: with stubbornly large primal infeasibility
    # this IS the infeasibility certificate; on a feasible problem it is
    # a plain TINY_STEP stall (-13).
    tiny_step = (torch.maximum(a_p, a_d) < 1e-10) & ~conv
    infeasible = ((stall >= ctl.infeas_max) | (tiny_step & (stall >= 2))) & ~feas_now
    tiny = tiny_step & ~infeasible
    status = torch.where(
        conv, int(Status.OK),
        torch.where(infeasible, int(Status.PRIMAL_INFEASIBLE),
                    torch.where(tiny, int(Status.TINY_STEP), st.status)))
    out = dataclasses.replace(
        new, res_p=res_p, res_d=res_d, res_c=res_c, converged=conv,
        halt=conv | infeasible | tiny, status=status,
        best_infeas=torch.minimum(st.best_infeas, res_p), stall=stall)
    # --- non-finite guard: NEVER return NaN with a confident status ----
    # A non-finite step rolls the state back to the previous iterate and
    # halts with ILL_CONDITIONED (-12); a blow-up while the primal
    # infeasibility is still LARGE is the classic infeasibility
    # certificate (diverging duals), diagnosed as -5.
    bad = ~torch.isfinite(res_p + res_d + res_c + a_p + a_d
                          + x.sum() + z_l.sum() + z_u.sum())
    far = torch.isfinite(st.best_infeas) & (
        st.best_infeas > max(1e3 * ctl.stop_abs_p, 1e-3))
    bad_status = torch.where(far, int(Status.PRIMAL_INFEASIBLE),
                             int(Status.ILL_CONDITIONED)).to(torch.int32)
    return dataclasses.replace(
        _select(bad, st, out), iter=out.iter, halt=bad | out.halt,
        converged=torch.where(bad, st.converged, out.converged),
        status=torch.where(bad, bad_status, out.status))


def _arc_max_steps(fams, K: int, tau: float):
    """(K,) largest alpha <= 1 with v(alpha) >= (1 - tau) v0 componentwise
    along each truncated arc v(alpha) = v0 + sum_{k<=j} deltas[k-1] alpha^k,
    j = 1..K (the JAX package's ``_arc_max_step`` per family and order).

    Every family's components are concatenated and every order is a row,
    so ONE ``roots_quartic`` call covers the whole (K, components) batch
    (the JAX package makes one call per family and order); the minimum over
    the concatenation is the minimum of the per-family minima exactly."""
    from ..core.roots import roots_quartic, smallest_positive_root

    a0 = torch.cat([torch.where(mask, tau * v0, 1.0) for v0, _, mask in fams])
    order = torch.arange(1, K + 1, device=a0.device)[:, None]
    coef = [a0.expand(K, -1)]
    for k in range(K):
        dk = torch.cat([torch.where(mask, ds[k], 0.0) for _, ds, mask in fams])
        coef.append(torch.where(order > k, dk, 0.0))      # order j uses deltas[:j]
    while len(coef) < 5:
        coef.append(torch.zeros_like(coef[0]))
    nr, rts = roots_quartic(*coef)
    best = smallest_positive_root(nr, rts).amin(dim=-1)
    return torch.clamp(best, max=1.0)


def _series_arc(qp, masks, st: IPMState, ctl, solve, sigma, mu_now):
    """The direction and step of a series arc of order K = min(series_order,
    4) (the JAX ``ipm_step``'s arc block).  v(alpha) = v + sum_k alpha^k v^k
    follows the chosen path:
      "taylor"   (Zhang arc, cqp.f90:194-205): residual(alpha) =
          (1-alpha) residual, comp(alpha) = (1-alpha) SZ + alpha sigma mu;
      "puiseux"  (Zhang-Puiseux, cqp.f90:5058-5095, the theta^2 path in
          Taylor coefficients): residual(alpha) = (1-alpha)^2 residual,
          comp(alpha) = (1-alpha)^2 SZ + (1-(1-alpha)^2) sigma mu;
      "zhao_sun" (ZS arc, cqp.f90:5088-5095): comp(alpha) = (1-alpha) SZ +
          sigma (1-alpha) alpha (mu e - SZ).
    The order-k complementarity right-hand side is the convolution of the
    lower-order coefficients, one backsolve per order on the same factors
    (cqp.f90:4237-4247, 5862-5935).  Every truncation order's step is the
    smallest positive root of the per-component neighbourhood polynomials
    (ROOTS, cqp.f90:8996); the order with the longest step wins, the
    higher on ties (the every_order loop, cqp.f90:6512-6545).  Tensor code
    with no host read: the chosen order and alpha are 0-d tensors.
    Returns (d, alpha), the update being x + alpha d."""
    from ..core.fit import polyval

    dt, device = qp.g.dtype, qp.g.device
    K = min(ctl.series_order, 4)
    z0 = torch.zeros((), dtype=dt, device=device)
    zero_corr = _corr_terms(None, True)

    def conv_at(coefs, k):
        conv = dict(xl=z0, xu=z0, cl=z0, cu=z0)
        for j in range(1, k):
            a, b_ = coefs[j - 1], coefs[k - j - 1]
            conv = dict(xl=conv["xl"] + a["dx"] * b_["dz_l"],
                        xu=conv["xu"] - a["dx"] * b_["dz_u"],
                        cl=conv["cl"] + a["dc"] * b_["dy_l"],
                        cu=conv["cu"] - a["dc"] * b_["dy_u"])
        return conv

    if ctl.arc == "puiseux":
        coefs = [solve(2.0 * sigma * mu_now, zero_corr, res_scale=2.0)]
        if K >= 2:
            coefs.append(solve(sigma * mu_now, conv_at(coefs, 2)))
        for k in range(3, K + 1):
            coefs.append(solve(z0, conv_at(coefs, k), first=False))
    elif ctl.arc == "zhao_sun":
        # centre-pull term w = sigma (mu e - SZ), per family
        w = dict(xl=sigma * (mu_now - st.z_l * st.s_l),
                 xu=sigma * (mu_now - st.z_u * st.s_u),
                 cl=sigma * (mu_now - st.y_l * st.t_l),
                 cu=sigma * (mu_now - st.y_u * st.t_u))
        coefs = [solve(z0, {k2: -w[k2] for k2 in w})]
        if K >= 2:
            conv = conv_at(coefs, 2)
            coefs.append(solve(z0, {k2: w[k2] + conv[k2] for k2 in w}, first=False))
        for k in range(3, K + 1):
            coefs.append(solve(z0, conv_at(coefs, k), first=False))
    else:  # "taylor"
        coefs = [solve(sigma * mu_now, zero_corr)]
        for k in range(2, K + 1):
            coefs.append(solve(z0, conv_at(coefs, k), first=False))
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    fams = [(st.s_l, [c["dx"] for c in coefs], ml_x),
            (st.s_u, [-c["dx"] for c in coefs], mu_x),
            (st.z_l, [c["dz_l"] for c in coefs], ml_x),
            (st.z_u, [c["dz_u"] for c in coefs], mu_x)]
    if qp.m > 0:
        fams += [(st.t_l, [c["dc"] for c in coefs], ml_c),
                 (st.t_u, [-c["dc"] for c in coefs], mu_c),
                 (st.y_l, [c["dy_l"] for c in coefs], ml_c),
                 (st.y_u, [c["dy_u"] for c in coefs], mu_c)]
    alphas = _arc_max_steps(fams, K, ctl.tau) * 0.9999
    # prefer the higher order on (near-)ties
    jbest = (K - 1) - torch.argmax(alphas.flip(0))
    alpha = alphas.gather(0, jbest.reshape(1))[0]
    # the chosen truncated arc at alpha (FIT's polynomial evaluation,
    # fit.f90:318); the update x + alpha d then applies
    # sum_{k<=jbest} alpha^k v^k
    d = {key: polyval(torch.stack([torch.where(k <= jbest, 1.0, 0.0) * c[key]
                                   for k, c in enumerate(coefs)], dim=-1), alpha)
         for key in coefs[0]}
    return d, alpha


def _dense_kkt(qp, D_x, C_diag, ctl, escalate):
    """The KKT solve of a dense ``QP`` (the JAX ``ipm_step``'s dense
    branch): SBLS's Schur complement when there are constraints, else a
    Cholesky factorization of G (or a division by a diagonal G).  Returns
    (kkt_solve, chol_ok): ``chol_ok`` is a 0-d flag, False when a Cholesky
    factorization failed at its first try (None where there is none).
    ``escalate`` runs the JAX package's shift escalation instead, with one
    host read per try; ``escalate="masked"`` makes every try with no host
    read and keeps the first that succeeds (the batched step's form)."""
    from ..linalg.cholesky import chol_factor_shifted, chol_solve
    from ..linalg.sbls import sbls_factorize, sbls_solve

    tries = CHOL_MAX_TRIES if escalate else 0
    masked = escalate == "masked"
    diag_G = qp.h_kind != "dense"
    if diag_G:
        G = qp.H_diag() + D_x
        apply_G = lambda v: G * v          # noqa: E731
    else:
        G = qp.H + torch.diag(D_x)
        apply_G = lambda v: G @ v          # noqa: E731
    if qp.m > 0:
        f = sbls_factorize(G, qp.A, C_diag, g_is_diag=diag_G, rho=ctl.rho,
                           delta=ctl.delta, max_tries=tries, masked=masked)

        def kkt_solve(b1, b2):
            dx, v = sbls_solve(f, b1, b2, apply_G=apply_G, refine=ctl.refine)
            return dx, -v                  # the system is in terms of -dy

        return kkt_solve, f.chol_ok
    if diag_G:
        return (lambda b1, b2: (b1 / G, b2)), None
    L, _, ok = chol_factor_shifted(G, ctl.rho, max_tries=tries, masked=masked)
    return (lambda b1, b2: (chol_solve(L, b1), b2)), ok


def ipm_step(qp, masks, st: IPMState, ctl: IPMControl, escalate=False) -> IPMState:
    """One iteration on a ``SparseQP``, a ``BandedQP`` or a dense ``QP``:
    barrier diagonals -> KKT factorize -> predictor solve -> corrector
    solve(s) or a series arc on the same factors -> step -> update (the body
    of CQP_solve_main, reference cqp.f90:2967+; the JAX package's
    ``ipm_step``).  A structured problem supplies its KKT solve through
    ``qp.build_kkt`` (the supernodal LDL^T of a SparseQP, the
    block-tridiagonal Cholesky of a BandedQP), as in the JAX package; that of
    a QP comes from :func:`_dense_kkt`.

    Pure tensor code with no host read, so that the card can capture it in
    a CUDA graph.  A step on a halted state, or at ``ctl.maxit``, returns
    every field with the bits it had (the condition of the JAX package's
    ``_jitted_multi_step`` loop).  So does a dense step whose Cholesky
    factorization failed at its first try: it sets ``needs_shift``
    instead, and the driver (qp/fused.py) takes that iteration again with
    ``escalate=True``, the JAX package's escalating shift, which reads the
    host once per try (``escalate="masked"``: every try, no host read, the
    form :class:`BatchedSolve` maps over a batch)."""
    st = device_state(st)
    D_x, C_diag = _barrier_diagonals(qp, masks, st, ctl)
    if hasattr(qp, "build_kkt"):
        kkt_solve, chol_ok = qp.build_kkt(D_x, C_diag, ctl), None
    else:
        kkt_solve, chol_ok = _dense_kkt(qp, D_x, C_diag, ctl, escalate)
    r_d, r_p = _residual_vectors(qp, masks, st)
    zero = torch.zeros((), dtype=qp.g.dtype, device=qp.g.device)

    def solve(mu_t, corr, first=True, res_scale=1.0):
        return _solve_direction(qp, masks, st, kkt_solve, C_diag, r_d, r_p, mu_t, corr,
                                first, res_scale)

    d = solve(zero, _corr_terms(None, True))
    if ctl.series_order >= 2:
        sigma, mu_now = _centering(qp, masks, st, ctl, d)
        if ctl.arc in SERIES_ARCS:
            d, a_p = _series_arc(qp, masks, st, ctl, solve, sigma, mu_now)
            a_d = a_p
        else:
            mu_t = sigma * mu_now
            for _ in range(ctl.series_order - 1):
                d = solve(mu_t, _corr_terms(d, False))
            a_p, a_d = _step_lengths(masks, st, d, ctl.tau)
    else:
        a_p, a_d = _step_lengths(masks, st, d, ctl.tau)
    new = _apply_direction(qp, masks, st, ctl, d, a_p, a_d)
    active = ~st.halt & (st.iter < ctl.maxit)
    if chol_ok is None:
        new = _select(active, new, st)
    elif escalate:
        new = dataclasses.replace(_select(active, new, st), needs_shift=torch.zeros_like(active))
    else:
        new = dataclasses.replace(_select(active & chol_ok, new, st),
                                  needs_shift=active & ~chol_ok)
    _flat._tick("rest")
    return new


# ---------------------------------------------------------------------------
# Indicators (active-set prediction)
# ---------------------------------------------------------------------------


def ipm_indicators(qp, masks: BoundMasks, st: IPMState, ctl: IPMControl,
                   prev: IPMState | None = None):
    """Predict the optimal active set from the (near-)converged IPM
    iterate (CQP_indicators, reference src/cqp/cqp.f90:9885; controls
    :189-213).  Returns (b_stat, c_stat) int32 tensors with the reference
    convention: -1 active at lower, +1 active at upper, 0 inactive.
    Indicator types 'primal', 'pd_ratio' (default) and 'tapia' (needs
    ``prev``; falls back to pd_ratio without it)."""
    kind = ctl.indicator_type
    if kind == "tapia" and prev is None:
        kind = "pd_ratio"

    def decide(dist_l, dist_u, dual_l, dual_u, has_l, has_u,
               pdist_l=None, pdist_u=None):
        if kind == "primal":
            lo = has_l & (dist_l < ctl.indicator_tol_p)
            hi = has_u & (dist_u < ctl.indicator_tol_p)
        elif kind == "tapia":
            r_l = dist_l / torch.clamp(pdist_l, min=1e-30)
            r_u = dist_u / torch.clamp(pdist_u, min=1e-30)
            lo = has_l & (r_l < 1.0 - ctl.indicator_tol_tapia)
            hi = has_u & (r_u < 1.0 - ctl.indicator_tol_tapia)
        else:  # pd_ratio
            lo = has_l & (dual_l > ctl.indicator_tol_pd * dist_l)
            hi = has_u & (dual_u > ctl.indicator_tol_pd * dist_u)
        # ties: the side with the smaller distance wins
        both = lo & hi
        lo = torch.where(both, dist_l <= dist_u, lo)
        hi = torch.where(both, dist_u < dist_l, hi)
        return hi.to(torch.int32) - lo.to(torch.int32)

    if prev is not None:
        ps_l, ps_u, pt_l, pt_u = prev.s_l, prev.s_u, prev.t_l, prev.t_u
    else:
        ps_l = ps_u = pt_l = pt_u = None
    ml_x, mu_x, ml_c, mu_c = _active_masks(masks)
    b_stat = decide(st.s_l, st.s_u, st.z_l, st.z_u, ml_x, mu_x, ps_l, ps_u)
    b_stat = torch.where(masks.x_fixed, -1, b_stat).to(torch.int32)
    if qp.m > 0:
        c_stat = decide(st.t_l, st.t_u, st.y_l, st.y_u, ml_c, mu_c,
                        pt_l, pt_u)
        c_stat = torch.where(masks.c_equality, -1, c_stat).to(torch.int32)
    else:
        c_stat = torch.zeros(0, dtype=torch.int32, device=qp.g.device)
    return b_stat, c_stat


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


def extract_solution(qp, masks: BoundMasks, st: IPMState):
    """Final (x, y, z): bound dual z from z_l - z_u; fixed variables get
    the exact dual residual as their multiplier."""
    z = st.z_l - st.z_u
    r = qp.Hx(st.x) + qp.g
    if qp.m > 0:
        r = r - qp.Aty(st.y)
    z = torch.where(masks.x_fixed, r, z)
    return st.x, st.y, z


@dataclasses.dataclass
class PhaseTimes:
    """Per-phase wall clocks (the PKG_time_type contract,
    reference src/cqp/cqp.f90:429-473)."""

    total: float = 0.0
    preprocess: float = 0.0      # input check, bound classification, start point
    analyse: float = 0.0         # symbolic analysis of the KKT pattern
    solve: float = 0.0           # the iterations


@dataclasses.dataclass
class IPMInform:
    """Host-side inform record (reference CQP_inform_type,
    src/cqp/cqp.f90:484-575): status + statistics + per-phase times +
    convergence-history checkpoints.  The one inform type of
    ``ipm_solve``, whatever path ended the solve."""

    status: int = int(Status.MAX_ITERATIONS)
    iter: int = 0
    nfacts: int = 0              # KKT factorizations (one per iteration)
    nbacts: int = 0              # backsolves (series + refinement sweeps)
    obj: float = 0.0
    primal_infeasibility: float = float("inf")
    dual_infeasibility: float = float("inf")
    complementary_slackness: float = float("inf")
    time: PhaseTimes = dataclasses.field(default_factory=PhaseTimes)
    checkpoints_iter: Any = None   # (16,) first iter with res <= 10^-i
    checkpoints_time: Any = None   # (16,) first wall time with res <= 10^-i
    b_stat: Any = None             # (n,) predicted bound activity (-1/0/+1)
    c_stat: Any = None             # (m,) predicted constraint activity


def _steps_per_fetch(ctl: IPMControl) -> int:
    """Iterations between two host reads: ``steps_per_fetch``, but one
    when every iteration prints its line or when ``GALAHAD_TPU_FUSED=0``
    asks for the direct step (as the JAX package's host loop does)."""
    if ctl.print_level >= 1 or not fused_enabled():
        return 1
    return max(1, ctl.steps_per_fetch)


def _stepper(qp, masks, st: IPMState, ctl: IPMControl) -> Stepper:
    """The runner of this solve's iterations: on the card the captured
    step (unless ``GALAHAD_TPU_FUSED=0``), on the CPU the direct one.  A
    dense QP's steps are taken again with the escalating shift where they
    set ``needs_shift``; a structured problem's steps never set it."""
    levels = ()
    on_card = qp.g.device.type == "cuda"
    if on_card and qp.h_kind == "sparse":
        from ..linalg.sbls import sparse_kkt_plan

        plan = sparse_kkt_plan(qp.h_pat, qp.a_pat, qp.n)
        levels = [lvp["sweep"] for lvp in _flat._device_plan(plan.sym, qp.g.device)["levels"]]
    flag = MONITOR.index("needs_shift")
    escalate = None if hasattr(qp, "build_kkt") else (
        lambda v: bool(v[flag]), lambda s: ipm_step(qp, masks, s, ctl, escalate=True))
    return Stepper(lambda s: ipm_step(qp, masks, s, ctl), st, TENSOR_FIELDS,
                   monitor, graph=on_card and fused_enabled(), sweep_levels=levels,
                   escalate=escalate)


def _finish_stats(stepper: Stepper, iters: int):
    stats = stepper.stats
    stats.halted_replays = stats.direct_steps + stats.replays + stats.escalations - iters
    return stats


def _scaffold(qp):
    """A well-formed problem of the size and kind of ``qp``, on its device,
    whose state the solve returns when ``qp`` fails its input checks (its
    shapes may not even be consistent)."""
    n, m = max(qp.n, 0), max(qp.m, 0)
    if qp.h_kind == "sparse":
        return make_sparse_qp(n, m, g=np.zeros(n), dtype=qp.g.dtype, device=qp.g.device)
    if hasattr(qp, "scaffold"):
        return qp.scaffold()
    return make_qp(g=np.zeros(n), A=np.zeros((m, n)), h_kind="zero",
                   dtype=qp.g.dtype, device=qp.g.device)


def _check_kind(qp, where: str) -> None:
    kind = getattr(qp, "h_kind", None)
    if hasattr(qp, "build_kkt") or kind in H_KINDS:
        return
    raise NotImplementedError(
        f"{where}: takes a SparseQP, a BandedQP (also through ipm_solve_banded) or a "
        f"dense QP (h_kind {kind!r})")


def ipm_solve(qp, ctl: IPMControl = IPMControl()):
    """Host-loop solver of a ``SparseQP``, a ``BandedQP`` or a dense ``QP``.
    Runs on the device that holds ``qp`` (the constructors
    ``make_sparse_qp`` / ``make_banded_qp`` / ``make_qp`` /
    ``read_sparse_qp`` / ``read_qp`` place it: the CUDA device unless the
    caller asked for the CPU).  On the card the
    iteration is captured once as a CUDA graph and replayed (qp/fused.py);
    the host reads the monitor every ``steps_per_fetch`` iterations and
    updates the checkpoints, the printed lines, the best iterate and the
    clock limit at that granularity.

    Returns (x, y, z, state); ``state.inform`` (IPMInform) adds per-phase
    wall times, factorization/backsolve counts and residual-history
    checkpoints (the inform contract, reference cqp.f90:484-575)."""
    _check_kind(qp, "ipm_solve")
    _check_control(ctl)
    t_start = time.perf_counter()
    if qp.g.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    # entry restrictions (-3) / bound consistency (-4): the per-solver
    # input checks of the reference (src/cqp/cqp.f90)
    bad = check_qp(qp, ctl.infinity)
    if bad != 0:
        qp = _scaffold(qp)
    masks = classify_bounds(qp, ctl.infinity)
    st = ipm_init(qp, masks, ctl)
    if bad != 0:
        st = dataclasses.replace(host_state(st, monitor(st).tolist()),
                                 halt=True, status=bad)
    t_pre = time.perf_counter()
    t_analyse = 0.0
    if bad == 0 and qp.h_kind == "sparse":
        from ..linalg.sbls import sparse_kkt_plan

        t0 = time.perf_counter()
        sparse_kkt_plan(qp.h_pat, qp.a_pat, qp.n)   # cached per pattern
        t_analyse = time.perf_counter() - t0
    cp = checkpoint_init()
    timed_out = False
    prev_st = best_st = best_vals = vals = None
    best_kkt = float("inf")
    first = True
    k = _steps_per_fetch(ctl)
    t_loop = time.perf_counter()
    if bad == 0 and ctl.maxit > 0:
        stepper = _stepper(qp, masks, st, ctl)
        it_now = 0
        while it_now < ctl.maxit:
            if ctl.indicator_type == "tapia":   # the only reader of prev_st
                prev_st = stepper.snapshot()
            stepper.advance(min(k, ctl.maxit - it_now))
            vals = stepper.fetch()
            _flat._tick("fetch")
            mon = dict(zip(MONITOR, vals))
            it_now = int(mon["iter"])
            kkt_now = max(mon["res_p"], mon["res_d"], mon["res_c"])
            now = time.perf_counter() - t_start
            cp = checkpoint_update(cp, kkt_now, it_now, now)
            if ctl.print_level >= 1:
                if first:
                    print(" iter     p-feas     d-feas   com-slck"
                          "         mu    time")
                print(f"{it_now:5d} {mon['res_p']:10.2e} {mon['res_d']:10.2e}"
                      f" {mon['res_c']:10.2e} {mon['mu']:10.2e} {now:7.2f}")
            first = False
            if kkt_now < best_kkt:
                best_kkt, best_st, best_vals = kkt_now, stepper.snapshot(), vals
            if mon["halt"]:
                break
            if ctl.clock_time_limit >= 0 and now > ctl.clock_time_limit:
                timed_out = True
                break
        st = host_state(stepper.state, vals)
        st.run = _finish_stats(stepper, st.iter)
    elif bad == 0:
        st = host_state(st, monitor(st).tolist())
    t_solve = time.perf_counter() - t_loop
    if timed_out and not st.converged:
        st = dataclasses.replace(st, halt=True,
                                 status=int(Status.CPU_LIMIT))
    # Best-iterate recovery (cqp.f90:163-168 residual-monitoring
    # contract): if late iterations degraded the KKT residuals, report
    # the best iterate actually attained, keeping the diagnosed status.
    if (best_st is not None and not st.converged
            and best_kkt < max(st.res_p, st.res_d, st.res_c)):
        st = dataclasses.replace(
            host_state(best_st, best_vals), iter=st.iter, halt=st.halt,
            status=st.status, converged=st.converged, run=st.run)
    x, y, z = extract_solution(qp, masks, st)
    b_stat, c_stat = ipm_indicators(qp, masks, st, ctl, prev=prev_st)
    iters = st.iter
    st.inform = IPMInform(
        status=int(st.status), iter=iters,
        nfacts=iters,
        nbacts=iters * max(ctl.series_order, 1) * (1 + ctl.refine),
        obj=float(qp.objective(x)),
        primal_infeasibility=st.res_p,
        dual_infeasibility=st.res_d,
        complementary_slackness=st.res_c,
        time=PhaseTimes(
            total=time.perf_counter() - t_start,
            preprocess=t_pre - t_start,
            analyse=t_analyse,
            solve=t_solve,
        ),
        checkpoints_iter=np.asarray(cp.iters, np.int32),
        checkpoints_time=np.asarray(cp.times, np.float64),
        b_stat=b_stat.cpu().numpy(),
        c_stat=c_stat.cpu().numpy(),
    )
    return x, y, z, st


# the tensors of a dense QP that a batch stacks (those that are not None)
QP_TENSORS = ("H", "g", "A", "c_l", "c_u", "x_l", "x_u", "x", "y")
MASK_FIELDS = tuple(f.name for f in dataclasses.fields(BoundMasks))


def _fields(obj, names) -> tuple:
    return tuple(getattr(obj, f) for f in names)


def _rows_where(flag, a: tuple, b: tuple) -> tuple:
    """Per problem of a batch (``flag`` (B,)), the fields of ``a`` where it
    holds, else those of ``b``."""
    return tuple(torch.where(flag.view((-1,) + (1,) * (x.dim() - 1)), x, y)
                 for x, y in zip(a, b))


def is_batch(qp) -> bool:
    """True for a stack of same-shape dense QPs (``g`` of shape (B, n))."""
    return isinstance(qp, QP) and qp.g.dim() == 2


class BatchedSolve:
    """The compiled solve of a stack of same-shape dense QPs (``qp.g`` (B,
    n), ``qp.A`` (B, m, n), ...; ``h_kind`` and ``f`` shared): the JAX
    package's ``vmap`` of ``ipm_solve_compiled``.  One step is
    ``torch.func.vmap`` of :func:`ipm_step` over the batch, run by one
    :class:`~.fused.Stepper` (on the card captured once as a CUDA graph and
    replayed); a halted problem's step changes none of its bits, as the
    vmapped ``while_loop`` freezes it.  A step whose first Cholesky try
    failed on some problems is taken again at the fetch that reads their
    flags, by the vmapped step with every shift try made and the first that
    succeeds kept (``escalate="masked"``), and the result is kept for those
    problems only: no host read per problem.

    ``stepper.advance`` / ``stepper.fetch`` with :meth:`stop` run it a fetch
    at a time (parallel/mesh.py interleaves the shards of a mesh so);
    :meth:`run` runs it to the end.  :meth:`finish` gives (xs, ys, zs,
    state), the state's fields stacked per problem as tensors on the
    batch's device, and ``state.run`` the stepper's ``RunStats``."""

    def __init__(self, qp, ctl: IPMControl = IPMControl()):
        _check_control(ctl)
        if qp.g.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.ctl = ctl
        names = tuple(f for f in QP_TENSORS if getattr(qp, f) is not None)
        self.qts = _fields(qp, names)

        def one(qt):
            return dataclasses.replace(qp, **dict(zip(names, qt)))

        def init(qt):
            q = one(qt)
            masks = classify_bounds(q, ctl.infinity)
            return _fields(masks, MASK_FIELDS), _fields(ipm_init(q, masks, ctl), TENSOR_FIELDS)

        def step(qt, mt, sf, escalate):
            q = one(qt)
            st = ipm_step(q, BoundMasks(*mt), IPMState(**dict(zip(TENSOR_FIELDS, sf))), ctl,
                          escalate=escalate)
            return _fields(st, TENSOR_FIELDS)

        def extract(qt, mt, sf):
            return extract_solution(one(qt), BoundMasks(*mt),
                                    IPMState(**dict(zip(TENSOR_FIELDS, sf))))

        vmap = torch.func.vmap
        self.mts, sf = vmap(init)(self.qts)
        self._step = vmap(functools.partial(step, escalate=False))
        self._escalated = vmap(functools.partial(step, escalate="masked"))
        self._extract = vmap(extract)
        st = IPMState(**{f: v.contiguous() for f, v in zip(TENSOR_FIELDS, sf)})
        self.stepper = None
        self.state = st
        if ctl.maxit > 0:
            flag = MONITOR.index("needs_shift")
            self.stepper = Stepper(
                self.step, st, TENSOR_FIELDS, monitor,
                graph=qp.g.device.type == "cuda" and fused_enabled(),
                escalate=(lambda rows: any(r[flag] for r in rows), self.escalated_step))

    def _with(self, st: IPMState, fields: tuple) -> IPMState:
        return dataclasses.replace(st, **dict(zip(TENSOR_FIELDS, fields)))

    def step(self, st: IPMState) -> IPMState:
        """One vmapped iteration of the whole batch."""
        return self._with(st, self._step(self.qts, self.mts, _fields(st, TENSOR_FIELDS)))

    def escalated_step(self, st: IPMState) -> IPMState:
        """The flagged problems' iteration taken again with the escalating
        shift; every other problem keeps its bits."""
        cur = _fields(st, TENSOR_FIELDS)
        esc = self._escalated(self.qts, self.mts, cur)
        return self._with(st, _rows_where(st.needs_shift, esc, cur))

    def stop(self, rows) -> bool:
        """True when every problem of the batch has halted or reached maxit."""
        halt, it = MONITOR.index("halt"), MONITOR.index("iter")
        return all(r[halt] != 0 or r[it] >= self.ctl.maxit for r in rows)

    def run(self):
        if self.stepper is not None:
            self.stepper.run_to_halt(self.stop)
        return self.finish()

    def finish(self):
        if self.stepper is None:
            return self._extract(self.qts, self.mts, _fields(self.state, TENSOR_FIELDS)) + (
                self.state,)
        st = self.stepper.snapshot()
        st.run = _finish_stats(self.stepper, int(st.iter.max()))
        xs, ys, zs = self._extract(self.qts, self.mts, _fields(st, TENSOR_FIELDS))
        return xs, ys, zs, st


def ipm_solve_compiled(qp, ctl: IPMControl = IPMControl()):
    """The whole solve with no decision on the host: iterations until the
    state halts or reaches ``ctl.maxit`` (counterpart of the JAX package's
    ``ipm_solve_compiled``, a ``lax.while_loop``).  On the card it replays
    the same captured step as :func:`ipm_solve`, one replay ahead of the
    host's read of the halt flag.  Returns (x, y, z, state) without an
    inform; the state's scalar fields are Python values.

    A stack of same-shape dense QPs (``qp.g`` (B, n), the JAX version's
    ``vmap`` use; parallel/mesh.py ``batch_ipm_solve``) runs as one
    :class:`BatchedSolve`: one vmapped step for the batch, captured once, and
    stacked (xs, ys, zs, state) whose scalar fields are (B,) tensors."""
    if is_batch(qp):
        return BatchedSolve(qp, ctl).run()
    _check_kind(qp, "ipm_solve_compiled")
    _check_control(ctl)
    if qp.g.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    masks = classify_bounds(qp, ctl.infinity)
    st = ipm_init(qp, masks, ctl)
    if ctl.maxit > 0:
        stepper = _stepper(qp, masks, st, ctl)
        halt, it = MONITOR.index("halt"), MONITOR.index("iter")
        vals = stepper.run_to_halt(lambda v: v[halt] != 0 or v[it] >= ctl.maxit)
        st = host_state(stepper.state, vals)
        st.run = _finish_stats(stepper, st.iter)
    else:
        st = host_state(st, monitor(st).tolist())
    x, y, z = extract_solution(qp, masks, st)
    return x, y, z, st
