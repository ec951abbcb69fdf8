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
inertia is (n, m, 0).  Two backends: "flat" (linalg/supernodal_flat.py)
and "inline" (linalg/supernodal.py).

The G-block menu (``sbls_preconditioner``), the null-space mode
(``sbls_factorize_nullspace`` / ``sbls_solve_nullspace``), the projected
preconditioned CG (``sbls_solve_iterative``) and the Fredholm alternative
(``sbls_fredholm_alternative``) complete SBLS.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .._device import as_device_tensor
from ..core.segsum import SegmentSum
from .cholesky import chol_factor_shifted, chol_solve, scalar_like
from .supernodal import (SupernodalSymbolic, supernodal_analyse, supernodal_factorize,
                         supernodal_solve)
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
                   max_tries: int = 12, masked: bool = False) -> SBLSFactors:
    """Factorize K = [[G, A'], [A, -C]] via the SPD Schur complement.

    G is (n, n) dense, or (n,) diagonal when ``g_is_diag`` (the LP /
    separable fast path, SBLS's diagonal-G restriction sbls.f90:2243-2252,
    here merely an optimization).  C_diag is (m,); zero entries are
    equality rows.  ``max_tries``: the shift escalations of each Cholesky
    factorization (:func:`cholesky.chol_factor_shifted`); 0 makes the first
    try only, with no host read; ``masked`` makes them all, with none."""
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
        L_G, rho, ok_g = chol_factor_shifted(G, rho, max_tries=max_tries, masked=masked)
        chol_g = ok_g
        g_diag = None
        W = chol_solve(L_G, A.mT)          # G^-1 A'
        AGiAt = A @ W

    S = AGiAt + torch.eye(m, dtype=dt, device=A.device) * delta
    S.diagonal(dim1=-2, dim2=-1).add_(C_diag)
    L_S, delta_extra, ok_s = chol_factor_shifted(S, 0.0, max_tries=max_tries,
                                                masked=masked)
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
        if isinstance(self.sym, SupernodalSymbolic):
            return S * supernodal_solve(self.sym, factors, S * b)
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
    SLS_analyse-once contract (reference src/sls/sls.f90:2178).
    ``backend``: "flat" (the flat-slab plan) or "inline" (the supernodal
    plan of linalg/supernodal.py)."""
    if backend not in ("flat", "inline"):
        raise ValueError(f"unknown sparse KKT backend {backend!r}")
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
    if backend == "flat":
        sym = flat_analyse(rows, cols, n + m, order="amd", relax_cols=16)
    else:
        sym = supernodal_analyse(rows, cols, n + m, order="amd")
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
    if isinstance(plan.sym, SupernodalSymbolic):
        return supernodal_factorize(plan.sym, vals_s), S
    return flat_factorize(plan.sym, vals_s), S


# ---------------------------------------------------------------------------
# Preconditioner menu, null-space mode, projected PCG, Fredholm alternative
# ---------------------------------------------------------------------------


def sbls_preconditioner(H, kind: str = "full", *, semi_bandwidth: int = 5,
                        min_diagonal: float = 1.0e-8, D=None, device=None):
    """The G-block menu of SBLS_form_and_factorize (reference
    src/sbls/sbls.f90:1918-1926).  Returns (G, g_is_diag) for
    sbls_factorize: "identity" G = I, "full" G = H, "diag_h" G = diag(H)
    floored, "band_h" G = band(H), "user_d" G = D (a given diagonal)."""
    H = as_device_tensor(H, device)
    n = H.shape[-1]
    like = dict(dtype=H.dtype, device=H.device)
    if kind == "identity":
        return torch.ones(n, **like), True
    if kind == "full":
        return H, False
    if kind == "diag_h":
        return torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=min_diagonal), True
    if kind == "band_h":
        i = torch.arange(n, device=H.device)
        band = (i[:, None] - i[None, :]).abs() <= semi_bandwidth
        return torch.where(band, H, 0.0), False
    if kind == "user_d":
        return as_device_tensor(D, H.device, H.dtype), True
    raise ValueError(f"unknown SBLS preconditioner {kind!r}")


@dataclasses.dataclass
class NullspaceFactors:
    """Null-space factorization of K (reference SBLS null-space mode,
    sbls.f90:6861): with A = [A1 A2], A1 nonsingular (basis columns found
    by ULS on the host, SBLS_find_A1_and_A2 :8082) and C = 0,
    Z = [-A1^-1 A2; I] spans null(A), x = x_p + Z x_n with A x_p = b2,
    (Z' G Z) x_n = Z'(b1 - G x_p), and A1' y = (b1 - G x)_basic."""

    basic: Any
    nonbasic: Any
    A1_lu: Any
    Zmat: Any
    L_red: Any
    G: Any
    A: Any
    ok: Any


def sbls_factorize_nullspace(G, A, *, tol: float = 1.0e-10, max_tries: int = 12,
                             device=None) -> NullspaceFactors:
    """Null-space factorization of [[G, A'], [A, 0]] (C zero)."""
    from .uls import uls_find_basis

    G = as_device_tensor(G, device)
    A = as_device_tensor(A, G.device, G.dtype)
    m, n = A.shape
    basic, nonbasic, rank = uls_find_basis(A, tol=tol)
    if rank < m:
        raise ValueError(f"A is rank deficient ({rank} < {m}); run FDC first")
    bt = torch.as_tensor(basic, device=G.device)
    nt = torch.as_tensor(nonbasic, device=G.device)
    lu, piv = torch.linalg.lu_factor(A[:, bt])
    Y = torch.linalg.lu_solve(lu, piv, A[:, nt])               # A1^-1 A2
    Zmat = torch.zeros((n, n - m), dtype=G.dtype, device=G.device)
    Zmat[bt] = -Y
    Zmat[nt] = torch.eye(n - m, dtype=G.dtype, device=G.device)
    R = Zmat.T @ (G @ Zmat)
    L_red, _, ok = chol_factor_shifted(R, 0.0, max_tries=max_tries)
    return NullspaceFactors(bt, nt, (lu, piv), Zmat, L_red, G, A, ok)


def sbls_solve_nullspace(f: NullspaceFactors, b1, b2):
    """Solve [[G, A'], [A, 0]] [x; y] = [b1; b2] through the null-space
    factors."""
    lu, piv = f.A1_lu
    xp = torch.zeros(f.A.shape[1], dtype=b1.dtype, device=b1.device)
    xp[f.basic] = torch.linalg.lu_solve(lu, piv, b2[:, None])[:, 0]
    xn = chol_solve(f.L_red, f.Zmat.T @ (b1 - f.G @ xp))
    x = xp + f.Zmat @ xn
    res = (b1 - f.G @ x)[f.basic]
    y = torch.linalg.lu_solve(lu, piv, res[:, None], adjoint=True)[:, 0]
    return x, y


# the projected CG reads its stop test on the host once every PCG_CHECK iterations
PCG_CHECK = 8


def sbls_solve_iterative(f: SBLSFactors, apply_G, b1, b2, *,
                         maxit: int = 100, stop_rel: float = 1.0e-10):
    """Projected preconditioned CG on the G-system over null(A) (reference
    SBLS_solve_iterative, sbls.f90:8762), with the factorized K as the
    constraint preconditioner; ``apply_G`` is the action of the TRUE H.
    The JAX package's two while loops (the second a restart from the
    recomputed residual) run on the device: each iteration's test is a 0-d
    tensor, a finished loop leaves its state as it is, and the host reads
    the test once every ``PCG_CHECK`` iterations.  Returns (x, y, iters),
    ``iters`` a 0-d tensor."""
    m = f.A.shape[-2]
    zero_m = torch.zeros(m, dtype=b1.dtype, device=b1.device)
    tiny = torch.finfo(b1.dtype).tiny
    x0, _ = _solve_once(f, torch.zeros_like(b1), b2)
    r0 = apply_G(x0) - b1
    w0, _ = _solve_once(f, r0, zero_m)
    rw0 = r0 @ w0
    tol2 = stop_rel * stop_rel * rw0.abs() + tiny
    k = torch.zeros((), dtype=torch.int64, device=b1.device)

    def run(x, r, w, p, rw, k, done):
        for it in range(maxit):
            live = ~done & (k < maxit)
            Gp = apply_G(p)
            alpha = rw / torch.clamp(p @ Gp, min=tiny)
            x_new = x + alpha * p
            r_new = r + alpha * Gp
            w_new, _ = _solve_once(f, r_new, zero_m)
            rw_new = r_new @ w_new
            diverged = rw_new >= rw
            beta = rw_new / torch.clamp(rw, min=tiny)
            x = torch.where(live & ~diverged, x_new, x)
            r = torch.where(live & ~diverged, r_new, r)
            p = torch.where(live, -w_new + beta * p, p)
            w = torch.where(live, w_new, w)
            rw = torch.where(live, torch.minimum(rw_new, rw), rw)
            done = torch.where(live, (rw_new <= tol2) | diverged, done)
            k = k + live.to(k.dtype)
            if (it + 1) % PCG_CHECK == 0 and not bool(~done & (k < maxit)):
                break
        return x, k

    x, k = run(x0, r0, w0, -w0, rw0, k, rw0.abs() <= tol2)
    r1 = apply_G(x) - b1
    w1, _ = _solve_once(f, r1, zero_m)
    rw1 = r1 @ w1
    x, k = run(x, r1, w1, -w1, rw1, k, rw1.abs() <= tol2)
    _, y = _solve_once(f, b1 - apply_G(x), zero_m)
    return x, y, k


def sbls_fredholm_alternative(G, A, C_diag, b1, b2, *, tol: float = 1e-9, device=None):
    """Fredholm alternative for (possibly singular) K (reference
    SBLS_fredholm_alternative, sbls.f90:9254): (True, (x, y)) with
    K [x; y] = b, or (False, (v1, v2)) with K v = 0 and b' v != 0.  Dense
    and spectral, as in the JAX package; ``solvable`` is a 0-d tensor."""
    G = as_device_tensor(G, device)
    like = dict(dtype=G.dtype, device=G.device)
    A = as_device_tensor(A, G.device, G.dtype)
    C_diag = as_device_tensor(C_diag, G.device, G.dtype)
    b1 = as_device_tensor(b1, G.device, G.dtype)
    b2 = as_device_tensor(b2, G.device, G.dtype)
    n = G.shape[-1]
    m = A.shape[-2]
    K = torch.zeros((n + m, n + m), **like)
    K[:n, :n] = G
    K[n:, :n] = A
    K[:n, n:] = A.T
    K[n:, n:] = torch.diag(-C_diag)
    b = torch.cat([b1, b2])
    lam, Q = torch.linalg.eigh(K)
    scale = lam.abs().max()
    nz = lam.abs() > tol * scale
    bt = Q.T @ b
    u = torch.where(nz, bt / torch.where(nz, lam, 1.0), 0.0)
    sol = Q @ u
    r = b - K @ sol
    nr = torch.linalg.norm(r)
    solvable = nr <= tol * (1.0 + torch.linalg.norm(b))
    v = r / torch.where(nr > 0, nr, 1.0)
    x = torch.where(solvable, sol[:n], v[:n])
    y = torch.where(solvable, sol[n:], v[n:])
    return solvable, (x, y)
