"""Symmetric block (KKT) system solvers.

Counterpart of galahad_tpu/linalg/sbls.py (GALAHAD's SBLS, reference
src/sbls/sbls.f90: SBLS_form_and_factorize :1695, SBLS_solve :4937).  Both
solve K [x; y] = [b1; b2] with K = [[G, A'], [A, -C]], G symmetric
positive (semi)definite and C diagonal, the shape of every interior-point
KKT system (reference src/cqp/cqp.f90:4726-4740).

Dense Schur-complement mode (``sbls_factorize`` / ``sbls_solve``, SBLS's
mode of sbls.f90:176-184 generalized from diagonal G to any factorizable
G): with primal/dual regularization (rho, delta) the Schur complement
S = C + delta I + A (G + rho I)^-1 A' is SPD, so the solve is two
Cholesky factorizations plus matrix products, with iterative refinement
against the unregularized K (reference ir.f90:334).

Sparse augmented-system mode (``SparseKKTPlan``, ``sparse_kkt_plan``,
``sparse_kkt_factorize``): K is assembled in COO, its pattern is analysed
ONCE (reused across every IPM iteration, the flagship path
src/cqp/cqp.f90:4781 -> sbls.f90:1695 -> sls.f90:3521 -> SSIDS), and each
iteration only re-runs the numeric LDL^T.  Quasi-definite regularization
(+rho / -delta signed diagonal) replaces dynamic pivoting; the expected
inertia is (n, m, 0).  The inline supernodal backend is not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..core.segsum import SegmentSum
from .cholesky import chol_factor_shifted, chol_solve, scalar_like
from .supernodal_flat import _tick, flat_analyse, flat_factorize, flat_solve


# ---------------------------------------------------------------------------
# Dense Schur-complement mode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SBLSFactors:
    L_G: Any          # Cholesky factor of G + rho I (None if diagonal G)
    g_diag: Any       # diagonal of G + rho I (None unless diagonal G)
    L_S: Any          # Cholesky factor of S = C + delta I + A Ginv A'
    A: Any
    C_diag: Any
    rho: Any
    delta: Any
    ok: Any           # 0-d: G + rho I positive (diagonal G) or factorized, and S factorized
    chol_ok: Any      # 0-d: every Cholesky factorization succeeded at its
                      # last try (what a larger shift could change)
    g_is_diag: bool = False


def _g_solve(f: SBLSFactors, b):
    if f.g_is_diag:
        return b / f.g_diag
    return chol_solve(f.L_G, b)


def sbls_factorize(G, A, C_diag, *, g_is_diag: bool = False, rho=0.0, delta=0.0,
                   max_tries: int = 12) -> SBLSFactors:
    """Factorize K = [[G, A'], [A, -C]] via the SPD Schur complement.

    G is (n, n) dense, or (n,) diagonal when ``g_is_diag`` (the LP /
    separable fast path, SBLS's diagonal-G restriction sbls.f90:2243-2252,
    here merely an optimization).  C_diag is (m,); zero entries are
    equality rows.  ``max_tries``: the shift escalations of each Cholesky
    factorization (:func:`cholesky.chol_factor_shifted`); 0 makes the first
    try only, with no host read."""
    m = A.shape[-2]
    dt = A.dtype
    rho = scalar_like(rho, A)
    delta = scalar_like(delta, A)

    if g_is_diag:
        g_diag = G + rho
        L_G = None
        AGiAt = (A / g_diag[..., None, :]) @ A.mT
        ok_g = (g_diag > 0).all()
        chol_g = torch.ones((), dtype=torch.bool, device=A.device)
    else:
        L_G, rho, ok_g = chol_factor_shifted(G, rho, max_tries=max_tries)
        chol_g = ok_g
        g_diag = None
        W = chol_solve(L_G, A.mT)          # G^-1 A'
        AGiAt = A @ W

    S = AGiAt + torch.eye(m, dtype=dt, device=A.device) * delta
    S.diagonal(dim1=-2, dim2=-1).add_(C_diag)
    L_S, delta_extra, ok_s = chol_factor_shifted(S, 0.0, max_tries=max_tries)
    return SBLSFactors(L_G=L_G, g_diag=g_diag, L_S=L_S, A=A, C_diag=C_diag, rho=rho,
                       delta=delta + delta_extra, ok=ok_g & ok_s, chol_ok=chol_g & ok_s,
                       g_is_diag=g_is_diag)


def _solve_once(f: SBLSFactors, b1, b2):
    At = f.A.mT
    w = _g_solve(f, b1)
    y = chol_solve(f.L_S, f.A @ w - b2)
    x = _g_solve(f, b1 - At @ y)
    return x, y


def sbls_solve(f: SBLSFactors, b1, b2, *, apply_G=None, refine: int = 2):
    """Solve K [x; y] = [b1; b2].  ``apply_G(v)``: the action of the TRUE
    (unregularized) G; with it, ``refine`` sweeps of iterative refinement
    remove the (rho, delta) perturbation (reference src/ir/ir.f90:334)."""
    x, y = _solve_once(f, b1, b2)
    if apply_G is None or refine <= 0:
        return x, y
    At = f.A.mT
    for _ in range(refine):
        r1 = b1 - (apply_G(x) + At @ y)
        r2 = b2 - (f.A @ x - f.C_diag * y)
        dx, dy = _solve_once(f, r1, r2)
        x = x + dx
        y = y + dy
    return x, y


def sbls_residual(f: SBLSFactors, apply_G, x, y, b1, b2):
    At = f.A.mT
    r1 = b1 - (apply_G(x) + At @ y)
    r2 = b2 - (f.A @ x - f.C_diag * y)
    return torch.maximum(r1.abs().max(), r2.abs().max())


# ---------------------------------------------------------------------------
# Sparse augmented-system mode (supernodal LDL^T)
# ---------------------------------------------------------------------------


class SparseKKTPlan:
    """Static analysed KKT structure (identity-hashed; reused across
    factorizations of the same pattern)."""

    __slots__ = ("sym", "n", "m", "rows", "cols", "dsel", "dpos",
                 "analyse_seconds", "_diag", "_dev")

    def __init__(self, sym, n: int, m: int, rows, cols):
        self.sym = sym
        self.n = n
        self.m = m
        self.rows = rows            # combined K pattern (np), for scaling
        self.cols = cols
        dsel = np.flatnonzero(rows == cols)
        self.dsel = dsel            # positions of diagonal entries
        self.dpos = rows[dsel]
        self.analyse_seconds = 0.0
        # every diagonal position is listed twice where H has a diagonal
        # entry: sum them in a fixed order
        self._diag = SegmentSum(self.dpos, n + m)
        self._dev = {}              # per-device copies of the index arrays

    def device_indices(self, device):
        key = str(device)
        hit = self._dev.get(key)
        if hit is None:
            hit = tuple(
                torch.as_tensor(np.ascontiguousarray(a, np.int64),
                                device=device)
                for a in (self.rows, self.cols, self.dsel))
            self._dev[key] = hit
        return hit

    def solve(self, fac, b):
        """``fac``: the (factors, Jacobi scale S) pair of
        ``sparse_kkt_factorize``."""
        factors, S = fac
        return S * flat_solve(self.sym, factors, S * b)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


_sparse_plan_cache: dict = {}


def sparse_kkt_plan(h_pat, a_pat, n: int,
                    backend: str = "flat") -> SparseKKTPlan:
    """Analyse the augmented KKT pattern [[H, A'], [A, -C]] (H lower
    pattern + A + both diagonals).  Cached per (h_pat, a_pat) pair: the
    SLS_analyse-once contract (reference src/sls/sls.f90:2178)."""
    if backend != "flat":
        raise NotImplementedError(
            f"sparse_kkt_plan backend {backend!r}: only the flat supernodal "
            "backend is ported")
    key = (h_pat, a_pat, backend)
    plan = _sparse_plan_cache.get(key)
    if plan is not None:
        return plan
    t0 = time.perf_counter()
    m = a_pat.m
    rows = np.concatenate([
        np.asarray(h_pat.rows, np.int64),
        np.asarray(a_pat.rows, np.int64) + n,
        np.arange(n, dtype=np.int64),
        n + np.arange(m, dtype=np.int64),
    ])
    cols = np.concatenate([
        np.asarray(h_pat.cols, np.int64),
        np.asarray(a_pat.cols, np.int64),
        np.arange(n, dtype=np.int64),
        n + np.arange(m, dtype=np.int64),
    ])
    # aggressive supernode amalgamation: fewer/larger fronts cut the
    # group/chunk count at ~20-40% extra fill (the SSIDS amalgamation
    # tradeoff, src/ssids/anal.f90); the value is the JAX package's so
    # that both analyse the same plan
    sym = flat_analyse(rows, cols, n + m, order="amd", relax_cols=16)
    plan = SparseKKTPlan(sym, n, m, rows, cols)
    plan.analyse_seconds = time.perf_counter() - t0
    _sparse_plan_cache[key] = plan
    return plan


def sparse_kkt_factorize(plan: SparseKKTPlan, h_vals, a_vals, D_x, C_diag,
                         rho=0.0, delta=0.0):
    """Numeric LDL^T of K = [[H + D_x + rho I, A'], [A, -(C + delta I)]]
    on the pre-analysed pattern.  D_x is the (n,) barrier diagonal,
    C_diag the (m,) dual barrier diagonal (>= 0; 0 on equality rows).

    The matrix is SYMMETRICALLY JACOBI-SCALED before factorization
    (S K S with S = |diag K|^{-1/2}): the barrier diagonal spreads over
    many decades near convergence and the scaling collapses that spread.
    Returns (factors, S); plan.solve applies both."""
    dt = D_x.dtype
    _tick("rest")
    vals = torch.cat([
        h_vals.to(dt), a_vals.to(dt),
        D_x + rho,
        -(C_diag.to(dt) + delta),
    ])
    rows_d, cols_d, dsel_d = plan.device_indices(D_x.device)
    diag = plan._diag(vals.index_select(0, dsel_d))
    S = 1.0 / torch.sqrt(torch.clamp(diag.abs(), min=1e-30))
    vals_s = vals * S.index_select(0, rows_d) * S.index_select(0, cols_d)
    _tick("assembly")
    return flat_factorize(plan.sym, vals_s), S
