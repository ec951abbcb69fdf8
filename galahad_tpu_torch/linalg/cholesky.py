"""Dense Cholesky utilities.

Counterpart of galahad_tpu/linalg/cholesky.py (the dense POTR path of SLS,
reference src/sls/sls.f90:843-921, and the foundation of the
Schur-complement KKT solver in sbls.py).  The factorization is
``torch.linalg.cholesky_ex`` with ``check_errors=False`` (cuSOLVER's
potrf on the card, LAPACK's on the host) and the solves are
``torch.linalg.solve_triangular``: no call here reads the host, so they
can be captured in a CUDA graph.

Dynamic threshold pivoting is replaced, as in the JAX package, by a
diagonal shift that grows until the factorization succeeds
(:func:`chol_factor_shifted`, the strategy of TRS for indefiniteness,
reference src/trs/trs.f90:2260-2337).  The JAX package escalates inside
one ``lax.while_loop``; a replayed graph cannot branch on the result, so
here the escalation is a host loop that only :func:`chol_factor_shifted`
with ``max_tries > 0`` runs (the IPM's step takes the first try alone
and reports whether it needs the shift, qp/ipm.py).
"""
from __future__ import annotations

import torch

from . import tridiag_kernels


def scalar_like(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s type and device, made by a fill
    on that device (a host-to-card copy could not be captured in a CUDA
    graph)."""
    if torch.is_tensor(v):
        return v.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def chol_factor(M: torch.Tensor):
    """Lower Cholesky factor of the symmetrized ``M`` (the JAX package's
    ``symmetrize_input=True``) and cuSOLVER/LAPACK's ``info`` (0 on
    success), as a 0-d (or batch-shaped) int32 tensor; no host read."""
    L, info = torch.linalg.cholesky_ex((M + M.mT) / 2, check_errors=False)
    return L, info


def chol_ok(L: torch.Tensor, info=None) -> torch.Tensor:
    """True where the factorization succeeded: ``info == 0`` and a finite,
    positive diagonal.  The JAX version tests the diagonal alone, since
    XLA's Cholesky fills NaN where it fails; LAPACK's and cuSOLVER's leave
    the factor part-computed and report the failure in ``info``."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (torch.isfinite(d) & (d > 0)).all(dim=-1)
    return ok if info is None else ok & (info == 0)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b given L = chol(M).  ``b`` is (..., n) or (..., n, k)."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False, left=True)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True, left=True)
    return x[..., 0] if vec else x


def chol_factor_shifted(M: torch.Tensor, shift0=0.0, growth: float = 100.0,
                        max_tries: int = 12, masked: bool = False):
    """Factorize M + shift I, escalating the shift by ``growth`` on failure.

    Returns (L, shift, ok) with ``shift`` and ``ok`` 0-d tensors.
    ``shift0`` = 0 tries the unshifted matrix first; the first fallback
    uses ``eps * max(max|M|, 1)``, then each try multiplies by ``growth``,
    at most ``max_tries`` fallbacks (the JAX package's sequence).  With
    ``max_tries=0`` only the first try is made and nothing is read on the
    host; each fallback reads ``ok`` once.  ``masked=True`` reads nothing:
    all ``max_tries`` fallbacks are made and a select keeps the first that
    succeeds (the same bits; the form a batched step under ``torch.func.vmap``
    takes, as the JAX package's vmapped ``while_loop`` does)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    shift = scalar_like(shift0, M)

    def try_factor(s):
        L, info = chol_factor(M + s * eye)
        return L, chol_ok(L, info)

    L, ok = try_factor(shift)
    if max_tries <= 0:
        return L, shift, ok
    eps = torch.finfo(M.dtype).eps
    base = eps * torch.clamp(M.abs().max(), min=1.0)
    if masked:
        for _ in range(max_tries):
            s_try = torch.where(shift == 0, base, shift * growth)
            L_try, ok_try = try_factor(s_try)
            L = torch.where(ok, L, L_try)
            shift = torch.where(ok, shift, s_try)
            ok = ok | ok_try
        return L, shift, ok
    tries = 0
    while not bool(ok) and tries < max_tries:
        shift = torch.where(shift == 0, base, shift * growth)
        L, ok = try_factor(shift)
        tries += 1
    return L, shift, ok


# ---------------------------------------------------------------------------
# Scalar tridiagonal LDL^T (the JAX package's tridiag_factor / tridiag_solve)
# ---------------------------------------------------------------------------


def tridiag_factor_plain(d: torch.Tensor, e: torch.Tensor):
    """LDL' factorization of the symmetric tridiagonal matrix with diagonal
    ``d (..., k)`` and subdiagonal ``e (..., k-1)`` (PTTRF equivalent,
    reference src/gltr/gltr.f90:50): ``(dhat, l)`` with M = L diag(dhat) L',
    L unit lower bidiagonal with subdiagonal ``l``.  The recurrence of the
    JAX package's ``lax.scan``, one step a batched tensor op:
    l_i = e_i / dhat_{i-1},  dhat_i = d_i - l_i e_i, the difference by
    ``addcmul``.  On the CPU torch's ``addcmul`` is one fused multiply-add,
    as XLA compiles the scan's step, so the bits are the JAX package's; on
    CUDA it rounds the product first, so there the plain version and the
    kernel (an fma) differ by a rounding per step.  Runs on any device; used
    on the CPU and, on the card, only to hold the kernel against."""
    tridiag_kernels.count_plain("factor")
    k = d.shape[-1]
    dp = d[..., 0]
    dhat, ls = [dp], []
    for i in range(1, k):
        li = e[..., i - 1] / dp
        dp = torch.addcmul(d[..., i], li, e[..., i - 1], value=-1)
        dhat.append(dp)
        ls.append(li)
    l = torch.stack(ls, -1) if ls else e[..., :0].clone()
    return torch.stack(dhat, -1), l


def tridiag_solve_plain(dhat: torch.Tensor, l: torch.Tensor, b: torch.Tensor):
    """x with L diag(dhat) L' x = b for the factors of
    :func:`tridiag_factor_plain`: forward y_i = b_i - l_{i-1} y_{i-1}, then
    z = y / dhat, backward x_i = z_i - l_i x_{i+1}, each step an
    ``addcmul`` (fused on the CPU, as the JAX package's scans compile: see
    :func:`tridiag_factor_plain`).  Runs on any device."""
    tridiag_kernels.count_plain("solve")
    k = b.shape[-1]
    y = [b[..., 0]]
    for i in range(1, k):
        y.append(torch.addcmul(b[..., i], l[..., i - 1], y[-1], value=-1))
    z = torch.stack(y, -1) / dhat
    x = [z[..., k - 1]]
    for i in range(k - 2, -1, -1):
        x.append(torch.addcmul(z[..., i], l[..., i], x[-1], value=-1))
    return torch.stack(x[::-1], -1)


def tridiag_factor(d: torch.Tensor, e: torch.Tensor):
    """``(dhat, l)`` of :func:`tridiag_factor_plain`, batched over leading
    dimensions.  A CPU tensor takes the plain version; on CUDA tensors this
    is one launch of the hand-written kernel (csrc/tridiag.cu, a thread per
    system walking its chain out of shared memory, laid out by
    ``tridiag_kernels.tridiag_schedule``) or an error."""
    if d.device.type == "cpu":
        return tridiag_factor_plain(d, e)
    return tridiag_kernels.tridiag_factor(d, e)


def tridiag_solve_chunked_plain(dhat: torch.Tensor, l: torch.Tensor, b: torch.Tensor,
                                chunk: int):
    """The chunked layout of the solve kernel (csrc/tridiag.cu) in plain
    PyTorch, for the tests: the k rows in chunks of ``chunk``, per direction
    in three phases.  (1) Each chunk with an inflow (every chunk but the first
    in the direction) runs its substitution from zero inflow, giving its last
    value vh, and the product T of -l over its rows (the transfer: v_last =
    vh + T v_inflow); (2) in chunk order, fma(T, v_inflow, vh) from the value
    the chunk before published, published in turn; (3) the chunk runs its
    substitution again from that inflow, with the operations and order of
    :func:`tridiag_solve_plain`.  The first chunk of a direction runs once and
    publishes its last value.  Same contract as :func:`tridiag_solve_plain`;
    the two differ only by the rounding the published inflows carry, and
    agree bitwise with one chunk."""
    k = b.shape[-1]
    m = min(int(chunk), k)
    starts = list(range(0, k, m))

    def sweep(rows_of, coef, src):
        out = [None] * k
        published = None
        for j, rows in enumerate(rows_of):
            if j > 0:                            # phase 1, from zero inflow
                vh, T = src(rows[0]), -coef(rows[0])
                for i in rows[1:]:
                    vh = torch.addcmul(src(i), coef(i), vh, value=-1)
                    T = T * -coef(i)
                inflow, published = published, torch.addcmul(vh, T, published)
                v = inflow
                for i in rows:                   # phase 3
                    v = out[i] = torch.addcmul(src(i), coef(i), v, value=-1)
            else:
                v = out[rows[0]] = src(rows[0])
                for i in rows[1:]:
                    v = out[i] = torch.addcmul(src(i), coef(i), v, value=-1)
                published = v
        return out

    fwd = [list(range(s, min(s + m, k))) for s in starts]
    y = sweep(fwd, lambda i: l[..., i - 1], lambda i: b[..., i])
    z = torch.stack(y, -1) / dhat
    bwd = [r[::-1] for r in fwd[::-1]]
    x = sweep(bwd, lambda i: l[..., i], lambda i: z[..., i])
    return torch.stack(x, -1)


def tridiag_solve(dhat: torch.Tensor, l: torch.Tensor, b: torch.Tensor):
    """Solve with the tridiagonal LDL' factors of :func:`tridiag_factor`;
    ``b (..., k)``.  A CPU tensor takes the plain version; on CUDA tensors
    one launch of the hand-written kernel (its batch layout, or for few long
    systems its chunked layout: :func:`tridiag_solve_chunked_plain`) or an
    error."""
    if b.device.type == "cpu":
        return tridiag_solve_plain(dhat, l, b)
    return tridiag_kernels.tridiag_solve(dhat, l, b)
