"""QP presolver.

Counterpart of galahad_tpu/pre/presolve.py (reference
src/presolve/presolve.f90: PRESOLVE_apply :2836, analyze :4017).  Two
layers, as in the JAX package:

1. ``presolve_apply`` - *shape-preserving* transforms on the problem's
   device (masking, never deletion): interval bound tightening from
   constraint activity ranges, forcing rows, free-row relaxation and
   infeasibility detection.  Its sweeps are tensor ops with no host read;
   the counts it returns are 0-d tensors.  Restoration is the identity.

2. ``presolve_reduce`` / ``presolve_restore`` - *reducing* transforms on
   the host in numpy (the same code as the JAX package's, kept here as the
   port's own copy): they eliminate fixed variables, monotone (dual-test)
   columns, duplicate, vacuous and singleton rows, and return a smaller
   ``QP`` on the caller's device plus a record that restores (x, y, z) of
   the original problem exactly.  The duplicate-row scan first tests a few
   columns of each candidate pair, the same test ``np.allclose`` makes on
   every column, so it takes the decisions of the JAX package's scan
   without comparing every pair of rows in full.

Dense ``QP`` only: a ``SparseQP`` or a ``BandedQP`` raises ``TypeError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, make_qp, require_dense

_CLOSE = dict(rtol=1e-12, atol=1e-12)      # what makes two rows duplicates
_PROBE_COLUMNS = 8                         # columns tested before a full comparison


@control_dc
class PresolveControl:
    sweeps: int = 3
    infinity: float = INFINITY
    feas_tol: float = 1.0e-9


@dataclasses.dataclass
class PresolveInfo:
    qp: Any
    infeasible: Any         # 0-d bool tensor
    n_tightened: Any        # 0-d int32 tensor
    n_forced_rows: Any      # 0-d int32 tensor


def presolve_apply(qp: QP, ctl: PresolveControl = PresolveControl()) -> PresolveInfo:
    """Tighten bounds, fix the variables of forcing rows and free vacuous rows,
    keeping every shape; returns the presolved ``QP`` and what was found."""
    require_dense(qp, "presolve_apply")
    inf = ctl.infinity
    n, m = qp.n, qp.m
    big = 2.0 * inf
    izero = torch.zeros((), dtype=torch.int32, device=qp.g.device)

    x_l0 = torch.where(qp.x_l > -inf, qp.x_l, -big)
    x_u0 = torch.where(qp.x_u < inf, qp.x_u, big)

    if m == 0:
        return PresolveInfo(qp=qp, infeasible=torch.any(x_l0 > x_u0 + ctl.feas_tol),
                            n_tightened=izero, n_forced_rows=izero)

    A = qp.A
    Ap = torch.clamp(A, min=0.0)
    An = torch.clamp(A, max=0.0)
    c_l = torch.where(qp.c_l > -inf, qp.c_l, -big)
    c_u = torch.where(qp.c_u < inf, qp.c_u, big)
    pos = A > 0
    neg = A < 0
    A_pos = torch.where(pos, A, 1.0)
    A_neg = torch.where(neg, A, 1.0)

    def clampinf(v):
        return torch.clamp(v, -big, big)

    x_l, x_u, n_tight = x_l0, x_u0, izero
    for _ in range(ctl.sweeps):
        # activity range of each row given the current bounds
        act_lo = clampinf(Ap @ x_l + An @ x_u)
        act_hi = clampinf(Ap @ x_u + An @ x_l)
        # the row's activity without x_j's contribution at either extreme
        lo_wo = act_lo[:, None] - torch.where(pos, A * x_l[None, :], A * x_u[None, :])
        hi_wo = act_hi[:, None] - torch.where(pos, A * x_u[None, :], A * x_l[None, :])
        # a_ij x_j >= c_l_i - hi_wo  and  a_ij x_j <= c_u_i - lo_wo
        lhs = c_l[:, None] - hi_wo
        rhs = c_u[:, None] - lo_wo
        new_lo = torch.where(pos, lhs / A_pos, -big)
        new_lo = torch.where(neg, rhs / A_neg, new_lo)
        new_hi = torch.where(pos, rhs / A_pos, big)
        new_hi = torch.where(neg, lhs / A_neg, new_hi)
        # only rows with finite relevant data tighten
        new_lo = torch.where(new_lo.abs() < inf, new_lo, -big)
        new_hi = torch.where(new_hi.abs() < inf, new_hi, big)
        x_l_new = torch.maximum(x_l, new_lo.amax(dim=0))
        x_u_new = torch.minimum(x_u, new_hi.amin(dim=0))
        n_tight = n_tight + ((x_l_new > x_l + 1e-12)
                             | (x_u_new < x_u - 1e-12)).sum().to(torch.int32)
        x_l, x_u = x_l_new, x_u_new

    act_lo = clampinf(Ap @ x_l + An @ x_u)
    act_hi = clampinf(Ap @ x_u + An @ x_l)
    # forcing rows: the activity range is degenerate against a bound, so every
    # variable of the row sits at the extreme that attains it
    force_lo = act_hi <= c_l + ctl.feas_tol      # must sit at act_hi
    force_hi = act_lo >= c_u - ctl.feas_tol      # must sit at act_lo
    n_forced = (force_lo | force_hi).sum().to(torch.int32)
    nz = A != 0
    fl = force_lo[:, None] & nz
    fh = force_hi[:, None] & nz
    to_hi = torch.any(fl & pos, dim=0) | torch.any(fh & neg, dim=0)
    to_lo = torch.any(fl & neg, dim=0) | torch.any(fh & pos, dim=0)
    x_l = torch.where(to_hi, x_u, x_l)
    x_u = torch.where(to_lo, x_l, x_u)

    # vacuous rows: the activity range lies within [c_l, c_u], so relax to free
    vacuous = (act_lo >= c_l - ctl.feas_tol) & (act_hi <= c_u + ctl.feas_tol)
    infeasible = (torch.any(x_l > x_u + ctl.feas_tol)
                  | torch.any(act_lo > c_u + ctl.feas_tol)
                  | torch.any(act_hi < c_l - ctl.feas_tol))
    qp_out = dataclasses.replace(
        qp,
        x_l=torch.where(x_l.abs() < inf, x_l, qp.x_l),
        x_u=torch.where(x_u.abs() < inf, x_u, qp.x_u),
        c_l=torch.where(vacuous, -big, qp.c_l),
        c_u=torch.where(vacuous, big, qp.c_u),
    )
    return PresolveInfo(qp=qp_out, infeasible=infeasible, n_tightened=n_tight,
                        n_forced_rows=n_forced)


# ---------------------------------------------------------------------------
# Reducing presolve (host-side elimination with exact restoration)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PresolveTransform:
    """Record of the eliminations; restores solutions exactly
    (PRESOLVE_restore contract, reference src/presolve/presolve.f90)."""

    n: int                     # original sizes
    m: int
    keep_x: np.ndarray         # indices of kept variables
    keep_c: np.ndarray         # indices of kept rows
    x_fixed_val: np.ndarray    # (n,) values of eliminated variables (0 if kept)
    x_fixed: np.ndarray        # (n,) bool: variable eliminated
    # singleton-row bound transfers: for each side (0 lower, 1 upper) and
    # each variable, the row that now carries the binding bound (-1: none)
    # and its coefficient
    transfer_row: np.ndarray   # (2, n) int
    transfer_coef: np.ndarray  # (2, n) float
    # original variable bounds (to decide dual attribution on restore)
    x_l0: np.ndarray
    x_u0: np.ndarray
    infinity: float
    c_l0: Any = None           # original row bounds (merged-row restore)
    c_u0: Any = None
    merged_rows: Any = None    # [(kept_i, dropped_k, scale)] duplicates
    H: Any = None              # original problem data for dual recovery
    g: Any = None
    A: Any = None
    h_kind: str = "dense"
    n_fixed: int = 0
    n_rows_dropped: int = 0
    n_dual_fixed: int = 0
    infeasible: bool = False
    unbounded: bool = False
    empty: bool = False        # every variable eliminated


def _host(t) -> np.ndarray:
    """A float64 numpy copy of a tensor (writable, for in-place math)."""
    return np.array(t.detach().cpu().numpy(), np.float64)


def _parallel_to(A, i, ks, jref):
    """Of the rows ``ks``, those that ``np.allclose`` calls multiples of row
    ``i`` (scale fixed at column ``jref``), in the order given.  A few of row
    ``i``'s columns are tested on all candidates first: a pair that fails
    there fails ``np.allclose``, which tests the same inequality on every
    column."""
    ks = np.asarray(ks, np.int64)
    if len(ks) == 0:
        return []
    s = A[ks, jref] / A[i, jref]
    probe = np.flatnonzero(np.abs(A[i]) > 0)[:_PROBE_COLUMNS]
    ref = s[:, None] * A[i, probe][None, :]
    near = np.abs(A[np.ix_(ks, probe)] - ref) <= _CLOSE["atol"] + _CLOSE["rtol"] * np.abs(ref)
    return [int(k) for k in ks[near.all(axis=1)]
            if np.allclose(A[k], (A[k, jref] / A[i, jref]) * A[i], **_CLOSE)]


def presolve_reduce(qp: QP, ctl: PresolveControl = PresolveControl()):
    """Eliminate what can be eliminated; return (reduced QP, transform).  The
    reduced ``QP`` is on ``qp``'s device, in its type.

    Transforms (each with exact restoration):
      * fixed variables x_l == x_u substituted out
        (g += H[:, j] v, c bounds -= A[:, j] v, f += ...);
      * dual test on empty columns: A[:, j] == 0, H[:, j] == 0 off the
        diagonal -> x_j solves a separable 1-D problem, fixed at its bound
        or analytic minimum (presolve.f90 dual fixing);
      * dominated LP columns fixed at a bound, duplicate rows merged;
      * singleton rows -> variable bounds (the row is dropped; on restore
        the bound dual goes back to the row when the ORIGINAL variable bound
        was looser);
      * vacuous rows (activity range inside [c_l, c_u]) and empty rows
        dropped with y = 0.
    """
    require_dense(qp, "presolve_reduce")
    inf = ctl.infinity
    n, m = qp.n, qp.m
    H = _host(qp.H_dense())
    g = _host(qp.g)
    A = _host(qp.A) if m else np.zeros((0, n))
    f = float(qp.f)
    x_l = _host(qp.x_l)
    x_u = _host(qp.x_u)
    c_l = _host(qp.c_l) if m else np.zeros(0)
    c_u = _host(qp.c_u) if m else np.zeros(0)

    tr = PresolveTransform(
        n=n, m=m, keep_x=np.arange(n), keep_c=np.arange(m),
        x_fixed_val=np.zeros(n), x_fixed=np.zeros(n, bool),
        transfer_row=np.full((2, n), -1, np.int64),
        transfer_coef=np.zeros((2, n)),
        x_l0=x_l.copy(), x_u0=x_u.copy(), infinity=inf,
        c_l0=c_l.copy(), c_u0=c_u.copy(), merged_rows=[],
        H=H.copy(), g=g.copy(), A=A.copy(), h_kind=qp.h_kind,
    )

    feas = ctl.feas_tol
    drop_row = np.zeros(m, bool)
    for _ in range(max(ctl.sweeps, 1)):
        changed = False

        # ---- fixed variables -------------------------------------------
        newly = (~tr.x_fixed) & (x_u - x_l <= feas) & (x_l > -inf) & (x_u < inf)
        if newly.any():
            v = 0.5 * (x_l + x_u)
            for j in np.flatnonzero(newly):
                vj = v[j]
                f += g[j] * vj + 0.5 * H[j, j] * vj * vj
                g += H[:, j] * vj
                g[j] -= H[j, j] * vj        # no self-contribution
                if m:
                    act = A[:, j] * vj
                    c_l -= np.where(np.abs(c_l) < inf, act, 0.0)
                    c_u -= np.where(np.abs(c_u) < inf, act, 0.0)
                    A[:, j] = 0.0
                H[:, j] = 0.0
                H[j, :] = 0.0
                tr.x_fixed[j] = True
                tr.x_fixed_val[j] = vj
                g[j] = 0.0
                x_l[j] = x_u[j] = 0.0
            changed = True

        # ---- dual test: empty columns ----------------------------------
        active = ~tr.x_fixed
        col_empty = active & (np.abs(A).sum(axis=0) == 0.0 if m else True)
        offdiag = np.abs(H).sum(axis=0) - np.abs(np.diag(H))
        sep = col_empty & (offdiag == 0.0)
        for j in np.flatnonzero(sep):
            hj, gj = H[j, j], g[j]
            lo = x_l[j] if x_l[j] > -inf else -np.inf
            hi = x_u[j] if x_u[j] < inf else np.inf
            if hj > 0:
                vj = np.clip(-gj / hj, lo, hi)
            elif gj > 0:
                vj = lo
            elif gj < 0:
                vj = hi
            elif hj == 0:
                vj = np.clip(0.0, lo, hi)
            else:  # hj < 0: the better end
                ends = [e for e in (lo, hi) if np.isfinite(e)]
                if not ends:
                    tr.unbounded = True
                    break
                vj = min(ends, key=lambda e: 0.5 * hj * e * e + gj * e)
            if not np.isfinite(vj):
                tr.unbounded = True
                break
            f += gj * vj + 0.5 * hj * vj * vj
            tr.x_fixed[j] = True
            tr.x_fixed_val[j] = vj
            tr.n_dual_fixed += 1
            H[j, j] = 0.0
            g[j] = 0.0
            x_l[j] = x_u[j] = 0.0
            changed = True
        if tr.unbounded:
            break

        # ---- dual test: dominated columns (LP columns) -----------------
        # For a column with no Hessian entries, stationarity gives
        #   z_j = g_j - sum_i a_ij y_i
        # with known multiplier sign ranges per row (y_i >= 0 when only c_l
        # is finite, y_i <= 0 when only c_u, free otherwise).  If the range
        # of z_j is provably >= 0 the variable sits at its lower bound at
        # every optimum; provably <= 0 -> upper bound (the reference's dual
        # tests, src/presolve/presolve.f90:4017).
        if m:
            y_lo = np.where(c_l > -inf, np.where(c_u < inf, -np.inf, 0.0), -np.inf)
            y_hi = np.where(c_u < inf, np.where(c_l > -inf, np.inf, 0.0), np.inf)
            # equality rows (c_l == c_u) are free in both directions
            eqr = (c_l > -inf) & (c_u < inf) & (c_u - c_l <= feas)
            y_lo = np.where(eqr, -np.inf, y_lo)
            y_hi = np.where(eqr, np.inf, y_hi)
            hcol = np.abs(H).sum(axis=0)
            for j in np.flatnonzero((~tr.x_fixed) & (hcol == 0.0)):
                col = A[:, j]
                nzr = np.flatnonzero((np.abs(col) > 0) & (~drop_row))
                if len(nzr) == 0:
                    continue            # the separable test's case
                hi_terms = np.where(col[nzr] > 0, col[nzr] * y_hi[nzr], col[nzr] * y_lo[nzr])
                lo_terms = np.where(col[nzr] > 0, col[nzr] * y_lo[nzr], col[nzr] * y_hi[nzr])
                z_min = g[j] - np.sum(hi_terms)
                z_max = g[j] - np.sum(lo_terms)
                vj = None
                if np.isfinite(z_min) and z_min >= -feas:
                    if x_l[j] > -inf:
                        vj = x_l[j]
                    elif z_min > feas:
                        tr.unbounded = True
                        break
                elif np.isfinite(z_max) and z_max <= feas:
                    if x_u[j] < inf:
                        vj = x_u[j]
                    elif z_max < -feas:
                        tr.unbounded = True
                        break
                if vj is None:
                    continue
                f += g[j] * vj
                g += H[:, j] * vj
                act = A[:, j] * vj
                c_l -= np.where(np.abs(c_l) < inf, act, 0.0)
                c_u -= np.where(np.abs(c_u) < inf, act, 0.0)
                A[:, j] = 0.0
                tr.x_fixed[j] = True
                tr.x_fixed_val[j] = vj
                tr.n_dual_fixed += 1
                g[j] = 0.0
                x_l[j] = x_u[j] = 0.0
                changed = True
            if tr.unbounded:
                break

            # ---- duplicate (parallel) rows ------------------------------
            # row k = s * row i (s != 0): the pair is one constraint with
            # intersected bounds; the dropped row restores with y_k = 0 (all
            # of the multiplier lives on the kept row: the two KKT systems
            # are identical)
            live = np.flatnonzero(~drop_row)
            if len(live) > 1:
                nzl = np.abs(A[live]) > 0
                # group rows by support pattern to limit the pair scans
                sig = {}
                for ridx, i in enumerate(live):
                    sig.setdefault(hash(nzl[ridx].tobytes()), []).append(i)
                for rows_same in sig.values():
                    for a_i in range(len(rows_same)):
                        i = rows_same[a_i]
                        if drop_row[i] or not np.any(np.abs(A[i]) > 0):
                            continue
                        jref = int(np.argmax(np.abs(A[i])))
                        ks = [k for k in rows_same[a_i + 1:]
                              if not drop_row[k] and A[k, jref] != 0]
                        for k in _parallel_to(A, i, ks, jref):
                            s = A[k, jref] / A[i, jref]
                            # row k's bounds in units of row i
                            lo_k = c_l[k] if c_l[k] > -inf else -np.inf
                            hi_k = c_u[k] if c_u[k] < inf else np.inf
                            nlo, nhi = (lo_k / s, hi_k / s) if s > 0 else (hi_k / s, lo_k / s)
                            if np.isfinite(nlo) and nlo > c_l[i]:
                                c_l[i] = nlo
                            if np.isfinite(nhi) and nhi < c_u[i]:
                                c_u[i] = nhi
                            if c_l[i] > c_u[i] + feas:
                                tr.infeasible = True
                            drop_row[k] = True
                            A[k, :] = 0.0
                            tr.merged_rows.append((int(i), int(k), float(s)))
                            changed = True
                    if tr.infeasible:
                        break
                if tr.infeasible:
                    break

        if m:
            # ---- singleton rows -> variable bounds ---------------------
            nz = np.abs(A) > 0
            rownnz = nz.sum(axis=1)
            for i in np.flatnonzero((~drop_row) & (rownnz == 1)):
                j = int(np.flatnonzero(nz[i])[0])
                a = A[i, j]
                lo_i = c_l[i] if c_l[i] > -inf else -np.inf
                hi_i = c_u[i] if c_u[i] < inf else np.inf
                new_lo = lo_i / a if a > 0 else hi_i / a
                new_hi = hi_i / a if a > 0 else lo_i / a
                if new_lo > x_l[j] + feas or x_l[j] <= -inf:
                    if np.isfinite(new_lo) and new_lo > x_l[j]:
                        x_l[j] = new_lo
                        tr.transfer_row[0, j] = i
                        tr.transfer_coef[0, j] = a
                if new_hi < x_u[j] - feas or x_u[j] >= inf:
                    if np.isfinite(new_hi) and new_hi < x_u[j]:
                        x_u[j] = new_hi
                        tr.transfer_row[1, j] = i
                        tr.transfer_coef[1, j] = a
                drop_row[i] = True
                changed = True

            # ---- vacuous / empty rows ----------------------------------
            Ap, An = np.maximum(A, 0), np.minimum(A, 0)
            lo_b = np.where(x_l > -inf, x_l, -1e30)
            hi_b = np.where(x_u < inf, x_u, 1e30)
            act_lo = Ap @ lo_b + An @ hi_b
            act_hi = Ap @ hi_b + An @ lo_b
            ok_lo = (c_l <= -inf) | (act_lo >= c_l - feas)
            ok_hi = (c_u >= inf) | (act_hi <= c_u + feas)
            vac = (~drop_row) & ok_lo & ok_hi & np.isfinite(act_lo) & np.isfinite(act_hi)
            empty = (~drop_row) & (np.abs(A).sum(axis=1) == 0.0)
            bad = empty & (((c_l > feas) & (c_l > -inf)) | ((c_u < -feas) & (c_u < inf)))
            if bad.any():
                tr.infeasible = True
                break
            if (vac | empty).any():
                drop_row |= vac | empty
                changed = True

        if np.any((x_l > x_u + feas) & (x_l > -inf) & (x_u < inf)):
            tr.infeasible = True
            break
        if not changed:
            break

    tr.keep_x = np.flatnonzero(~tr.x_fixed)
    tr.keep_c = np.flatnonzero(~drop_row)
    tr.n_fixed = int(tr.x_fixed.sum())
    tr.n_rows_dropped = int(drop_row.sum())

    kx, kc = tr.keep_x, tr.keep_c
    on = dict(dtype=qp.g.dtype, device=qp.g.device)
    if len(kx) == 0:
        # everything eliminated: a 1-variable trivial QP keeps the
        # downstream shapes valid
        tr.empty = True
        return make_qp(H=np.zeros((1, 1)), g=np.zeros(1), f=f, A=np.zeros((0, 1)),
                       x_l=np.zeros(1), x_u=np.zeros(1), name=qp.name, **on), tr

    def sub(v, idx):
        return None if v is None else v.detach().cpu().numpy()[idx]

    red = make_qp(
        H=H[np.ix_(kx, kx)], g=g[kx], f=f, A=A[np.ix_(kc, kx)],
        c_l=c_l[kc], c_u=c_u[kc], x_l=x_l[kx], x_u=x_u[kx],
        x=sub(qp.x, kx), y=sub(qp.y, kc), z=sub(qp.z, kx), name=qp.name, **on)
    return red, tr


def presolve_restore(tr: PresolveTransform, x_r, y_r, z_r):
    """Map a reduced-problem solution back to the original problem, with exact
    dual recovery; returns float64 numpy arrays (x, y, z).

      * eliminated variables: z_j = (H x + g - A' y)_j (stationarity);
      * dropped rows: y_i = 0, except singleton rows whose transferred
        variable bound is active and strictly tighter than the original
        bound - there the bound dual moves back to the row:
        y_i = z_j / a_ij, z_j = 0 (both KKT systems are equivalent; the
        reference's restoration makes the same attribution).
    """
    def host(v):
        return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64)

    x = np.zeros(tr.n)
    x[tr.keep_x] = host(x_r)[: len(tr.keep_x)] if not tr.empty else 0.0
    x[tr.x_fixed] = tr.x_fixed_val[tr.x_fixed]
    y = np.zeros(tr.m)
    if len(tr.keep_c):
        y[tr.keep_c] = host(y_r)
    z = np.zeros(tr.n)
    if len(tr.keep_x):
        z[tr.keep_x] = host(z_r)

    # dual attribution for transferred singleton-row bounds: transfers are
    # recorded only when strictly tighter than the original bound, so a dual
    # resting on the transferred side moves back to the row for
    # original-problem complementarity to hold
    for side in (0, 1):
        for j in np.flatnonzero(tr.transfer_row[side] >= 0):
            i = int(tr.transfer_row[side, j])
            a = tr.transfer_coef[side, j]
            zj = z[j]
            active = zj > 0 if side == 0 else zj < 0
            if active:
                y[i] += zj / a
                z[j] = 0.0

    # merged duplicate rows: move the multiplier to whichever original row's
    # bound is attained (complementarity on the original problem; the rows
    # are parallel, so y_k = y_i / s keeps stationarity).  The winner is the
    # row with the smallest normalized gap to its sign-consistent bound
    # (y > 0 <-> lower bound active); groups sharing a kept row are taken
    # together, in reverse merge order, so that chained merges propagate.
    if tr.merged_rows:
        Ax = tr.A @ x if tr.m else np.zeros(0)
        groups: dict = {}
        order = []
        for i, k, sc in tr.merged_rows:
            if i not in groups:
                groups[i] = []
                order.append(i)
            groups[i].append((k, sc))

        def gap(row, ax_row, y_row):
            """Normalized distance from ax_row to the bound on the side that
            complementarity pairs with sign(y_row)."""
            b = tr.c_l0[row] if y_row > 0 else tr.c_u0[row]
            if abs(b) >= tr.infinity:
                return np.inf
            return abs(ax_row - b) / (1.0 + abs(ax_row))

        for i in reversed(order):
            yi = y[i]
            if yi == 0.0:
                continue
            best_row, best_sc, best_gap = i, 1.0, gap(i, Ax[i], yi)
            for k, sc in groups[i]:
                gk = gap(k, sc * Ax[i], yi / sc)
                if gk < best_gap:
                    best_row, best_sc, best_gap = k, sc, gk
            if best_row != i:
                y[best_row] += yi / best_sc
                y[i] = 0.0

    # stationarity dual for eliminated variables
    r = tr.H @ x + tr.g
    if tr.m:
        r -= tr.A.T @ y
    z[tr.x_fixed] = r[tr.x_fixed]
    return x, y, z
