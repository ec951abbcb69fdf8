"""Exact trust-region subproblem for ONE LARGE SPARSE Hessian.

Counterpart of galahad_tpu/tr/trs_sparse.py (the reference TRS's
factorization path, src/trs/trs.f90: TRS_solve_main :1218, factorize loop
:1942/2260, inertia-driven interval updates :2260-2337, hard case
:2398-2430, TRS_contract :4100, solution history :2575)::

    min  1/2 x'Hx + c'x   s.t.  ||x||_M <= radius      (M diagonal SPD)

with H sparse (COO lower triangle).  A safeguarded secular Newton on
lambda, each trial factorizing H + lambda M with the port's flat
supernodal LDL^T (``flat_factorize(plan, vals, shift=lambda)``, and so the
hand-written factor, extend-add and sweep kernels on the card); the
symbolic analysis is done ONCE per pattern object and reused across every
trial lambda and across contract re-entries.  The inertia the factorization
derives from its stored diagonal drives the interval: a negative or zero
pivot at a trial lambda proves lambda < -lambda_min(H, M).

M != I is folded in by the diagonal similarity H' = M^-1/2 H M^-1/2,
c' = M^-1/2 c (pattern unchanged).  The loop is the JAX package's host
loop, including the hard case's ``np.random.default_rng(0)`` start vector,
so both packages take the same trial lambdas.  H x sums in a fixed order
(core/segsum.py), so two runs give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.config import control as control_dc
from ..linalg.supernodal_flat import flat_analyse, flat_factorize, flat_solve
from .trs import as_tensors


@control_dc
class TRSSparseControl:
    stop_normal: float = 1.0e-10     # relative |  ||x|| - radius  |
    max_factorizations: int = 40     # trial-lambda budget
    inverse_iterations: int = 4      # hard-case leftmost-eigenvector steps
    hard_case_shift: float = 1.0e-8
    order: str = "amd"


@dataclasses.dataclass
class TRSSparseInfo:
    """TRS_inform_type equivalent for the sparse path, with the per-trial
    history the reference returns (trs.f90:2575)."""

    x: Any
    obj: float
    multiplier: float
    norm_x: float
    hard_case: bool
    interior: bool
    n_factorizations: int
    history_lambda: np.ndarray    # trial lambdas, in order
    history_norm: np.ndarray      # ||x(lambda)||_M per trial (nan: indefinite)


def trs_sparse_plan(h_pat):
    """The flat plan of the H + lambda M pattern (the lower triangle of H
    plus a full diagonal), AMD-ordered as in the JAX package.  Cached on
    the pattern object: the analyse-once contract (reference
    trs.f90:1748)."""
    plan = h_pat._plans.get("trs_sparse")
    if plan is None:
        n = h_pat.n
        diag = np.arange(n, dtype=np.int64)
        plan = flat_analyse(np.concatenate([np.asarray(h_pat.rows, np.int64), diag]),
                            np.concatenate([np.asarray(h_pat.cols, np.int64), diag]), n,
                            order="amd")
        h_pat._plans["trs_sparse"] = plan
    return plan


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v))


def trs_solve_sparse(h_pat, h_vals, c, radius, m_diag=None,
                     ctl: TRSSparseControl = TRSSparseControl(),
                     lambda_init: float | None = None, device=None) -> TRSSparseInfo:
    """Solve the large sparse TRS.  ``h_pat`` is a core.sparse.COOPattern
    over the LOWER triangle of H; ``m_diag`` an optional (n,) SPD norm
    diagonal; ``lambda_init`` warm-starts the multiplier (used by
    :func:`trs_contract`)."""
    n = h_pat.n
    c, h_vals, m_diag = as_tensors(c, h_vals, m_diag, device=device)
    dt, dev = c.dtype, c.device
    radius = float(radius)

    # fold M into a similarity transform (pattern unchanged)
    if m_diag is not None:
        s = 1.0 / torch.sqrt(m_diag)
        r_idx = torch.as_tensor(h_pat.rows.astype(np.int64), device=dev)
        c_idx = torch.as_tensor(h_pat.cols.astype(np.int64), device=dev)
        h_work = h_vals * s[r_idx] * s[c_idx]
        c_work = c * s
    else:
        s = None
        h_work, c_work = h_vals, c

    sym = trs_sparse_plan(h_pat)
    # values of the analysed pattern (H, then the diagonal that takes lambda
    # through the factorization's shift)
    vals = torch.cat([h_work, torch.zeros(n, dtype=dt, device=dev)])

    # Gershgorin bounds on lambda_min(H') for the safeguard interval
    hn = h_work.cpu().numpy().astype(np.float64)
    rn = np.asarray(h_pat.rows)
    cn = np.asarray(h_pat.cols)
    diag = np.zeros(n)
    np.add.at(diag, rn[rn == cn], hn[rn == cn])
    offs = np.zeros(n)
    off = rn != cn
    np.add.at(offs, rn[off], np.abs(hn[off]))
    np.add.at(offs, cn[off], np.abs(hn[off]))
    gersh_min = float((diag - offs).min()) if n else 0.0
    norm_c = _norm(c_work)

    lam_lo = 0.0                       # lambda >= 0 always
    lam_hard = max(0.0, -gersh_min)    # upper bound for -lambda_min
    lam_hi = lam_hard + norm_c / radius + 1.0

    def attempt(lam):
        fac = flat_factorize(sym, vals, shift=float(lam))
        inert = fac.inertia.tolist()
        return fac, inert[1] == 0 and inert[2] == 0

    hist_lam: list = []
    hist_norm: list = []
    nfact = 0
    lam = float(lambda_init) if lambda_init is not None else 0.0
    lam = min(max(lam, lam_lo), lam_hi)
    x = None
    interior = hard_case = converged = False

    for _ in range(ctl.max_factorizations):
        fac, ok = attempt(lam)
        nfact += 1
        hist_lam.append(lam)
        if not ok:
            # indefinite: lambda < -lambda_min  ->  raise the floor
            hist_norm.append(np.nan)
            lam_lo = max(lam_lo, lam)
            lam_hard = max(lam_hard, lam)
            lam = 0.5 * (lam + lam_hi) if lam > 0 else min(
                lam_hard + 1e-3 * (1 + lam_hard), lam_hi)
            continue
        xl = flat_solve(sym, fac, -c_work)
        nx = _norm(xl)
        hist_norm.append(nx)
        if lam <= 0.0 and nx <= radius:
            x, interior, converged = xl, True, True
            lam = 0.0
            break
        if nx > radius:
            lam_lo = max(lam_lo, lam)
        else:
            lam_hi = min(lam_hi, lam)
        if abs(nx - radius) <= ctl.stop_normal * radius:
            x, converged = xl, True
            break
        # secular Newton on psi(lam) = 1/||x|| - 1/radius:
        #   psi' = (x' (H + lam M)^-1 x) / ||x||^3  (one extra solve, the
        #   reference's TRS_pi_derivs order-1 term, trs.f90:4719)
        w = flat_solve(sym, fac, xl)
        dpsi = float(torch.dot(xl, w)) / max(nx, 1e-300) ** 3
        psi = 1.0 / nx - 1.0 / radius
        step = -psi / dpsi if dpsi > 0 else 0.0
        lam_new = lam + step
        if not (lam_lo < lam_new < lam_hi) or not np.isfinite(lam_new):
            lam_new = 0.5 * (lam_lo + lam_hi)
        # hard-case detection: the interval pinches at the definiteness
        # boundary while ||x|| stays short of the radius
        if lam_hi - lam_lo <= 1e-14 * (1 + abs(lam_hi)) and nx < radius:
            x = xl
            hard_case = True
            break
        lam = lam_new
    else:
        # budget exhausted: keep the best definite iterate
        if x is None:
            fac, ok = attempt(max(lam_lo, lam_hard) + ctl.hard_case_shift)
            nfact += 1
            x = flat_solve(sym, fac, -c_work)

    if hard_case or (not converged and not interior and x is not None
                     and _norm(x) < radius * (1 - 1e-6)):
        # hard case: x(lam_hard) short of the boundary; complete along the
        # leftmost eigenvector by inverse iteration on a slightly shifted
        # factorization (reference trs.f90:2398-2430)
        hard_case = True
        lam = max(lam_lo, lam_hard)
        fac, ok = attempt(lam + ctl.hard_case_shift)
        nfact += 1
        rng = np.random.default_rng(0)
        u = torch.as_tensor(rng.standard_normal(n), device=dev).to(dt)
        for _ in range(ctl.inverse_iterations):
            u = flat_solve(sym, fac, u)
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-300)
        xb = flat_solve(sym, fac, -c_work)
        # alpha: ||xb + alpha u|| = radius (the root enlarging x)
        xu = float(torch.dot(xb, u))
        nx2 = float(torch.dot(xb, xb))
        disc = max(xu * xu + radius ** 2 - nx2, 0.0)
        alpha = -xu + np.sqrt(disc)
        x = xb + alpha * u

    nx = _norm(x)
    # objective in the ORIGINAL metric
    x_out = x * s if s is not None else x
    obj = float(0.5 * torch.dot(x_out, _h_mul(h_pat, h_vals, x_out)) + torch.dot(c, x_out))
    return TRSSparseInfo(
        x=x_out, obj=obj, multiplier=float(lam), norm_x=nx, hard_case=bool(hard_case),
        interior=bool(interior), n_factorizations=nfact,
        history_lambda=np.asarray(hist_lam), history_norm=np.asarray(hist_norm))


def trs_contract(h_pat, h_vals, c, new_radius, prev: TRSSparseInfo, m_diag=None,
                 ctl: TRSSparseControl = TRSSparseControl(), device=None) -> TRSSparseInfo:
    """Re-solve with a SMALLER radius (the TR-algorithm contraction
    re-entry, reference TRS_contract trs.f90:4100): the symbolic analysis is
    shared through the plan cache, and the previous multiplier (a LOWER
    bound for the new one, since ||x(lambda)|| decreases) warm-starts the
    secular iteration."""
    return trs_solve_sparse(h_pat, h_vals, c, new_radius, m_diag=m_diag, ctl=ctl,
                            lambda_init=max(prev.multiplier, 0.0), device=device)


def _h_mul(h_pat, h_vals, v):
    """H v for the lower-triangle COO H, summed in a fixed order."""
    seg, src, vsel = h_pat._dev("sym", v.device)
    return seg(h_vals.index_select(0, vsel) * v.index_select(0, src))
