"""Block-tridiagonal symmetric factorization and solves.

Counterpart of galahad_tpu/linalg/banded.py (the TPU replacement of the
banded paths of GALAHAD's SLS 'pbtr' backend, reference
src/sls/sls.f90:843-921).  A symmetric banded matrix with semibandwidth
<= b is held as block tridiagonal with (b, b) dense blocks:

    [D_0  L_0'          ]
    [L_0  D_1  L_1'     ]
    [     L_1  D_2  ... ]

The Cholesky factorization is one dependent step per block row; the solves
are a forward and a backward sweep over the block rows.  The JAX package
runs these as ``lax.scan``s.  Here each has a plain PyTorch version
(``*_plain``: a Python loop of small torch calls, used on the CPU and as the
reference of the kernels) and, for tensors on the card, a hand-written CUDA
kernel that walks the whole chain in one launch (linalg/banded_kernels.py,
csrc/banded.cu).  :func:`block_tridiag_cholesky` and
:func:`block_tridiag_solve` take the plain version only for tensors on the
CPU; on CUDA tensors they launch the kernel or raise.

A block whose Cholesky factorization fails (a diagonal entry of its factor
not finite or not positive) is replaced by the identity and clears ``ok``,
as in the JAX package (``chol_ok``); the recurrence goes on with it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from . import banded_kernels
from .cholesky import chol_factor, chol_ok


@dataclasses.dataclass
class BlockTridiagFactors:
    Ld: torch.Tensor     # (k, b, b) lower-triangular diagonal blocks of L
    Lo: torch.Tensor     # (k-1, b, b) subdiagonal blocks (Lo[i] couples i -> i+1)
    ok: torch.Tensor     # 0-d bool: every block factorized (all pivots positive)


def band_to_blocks(band_lower, n: int, b: int, dtype=None, device=None):
    """Pack a symmetric banded matrix in LAPACK-style lower band storage
    (``band_lower[d, j] = A[j+d, j]``, d = 0..semibandwidth) into (D, L)
    block-tridiagonal form with block size ``b``, padding n up to a multiple
    of b with the identity.  Host-side helper (numpy), as in the JAX package;
    the blocks are returned as tensors on ``device`` (``None``: the card)."""
    band = np.asarray(band_lower, np.float64)
    semibw = band.shape[0] - 1
    if semibw > b:
        raise ValueError("semibandwidth must be <= block size")
    k = -(-n // b)
    npad = k * b
    A = np.zeros((npad, npad))
    for d in range(semibw + 1):
        j = np.arange(n - d)
        A[j + d, j] = band[d, :n - d]
        A[j, j + d] = band[d, :n - d]
    A[np.arange(n, npad), np.arange(n, npad)] = 1.0
    D = np.stack([A[i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(k)])
    L = (np.stack([A[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] for i in range(k - 1)])
         if k > 1 else np.zeros((0, b, b)))
    device, dt = resolve_device(device), resolve_dtype(dtype)
    return (torch.as_tensor(D, device=device).to(dt),
            torch.as_tensor(L, device=device).to(dt))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def block_tridiag_cholesky_plain(D, L) -> BlockTridiagFactors:
    """Cholesky A = L~ L~' of the block-tridiagonal SPD matrix with diagonal
    blocks ``D`` (k, b, b) and subdiagonal blocks ``L`` (k-1, b, b), one
    step per block row:

        Ld_0 = chol(D_0)
        Lo_i = L_i Ld_i^-T,   Ld_{i+1} = chol(D_{i+1} - Lo_i Lo_i')

    each ``chol`` of the symmetrized block, the identity where it fails."""
    banded_kernels.count_plain("factor")
    k, b, _ = D.shape
    eye = torch.eye(b, dtype=D.dtype, device=D.device)

    def factor(S):
        C, info = chol_factor(S)
        good = chol_ok(C, info)
        return torch.where(good, C, eye), good

    Ld, ok = factor(D[0])
    Lds, Los = [Ld], []
    for i in range(1, k):
        # Lo = L Ld^-T: solve Ld Lo' = L'
        Lo = torch.linalg.solve_triangular(Ld, L[i - 1].mT, upper=False).mT
        Ld, good = factor(D[i] - Lo @ Lo.mT)
        ok = ok & good
        Lds.append(Ld)
        Los.append(Lo)
    Lo_all = torch.stack(Los) if Los else torch.zeros((0, b, b), dtype=D.dtype, device=D.device)
    return BlockTridiagFactors(Ld=torch.stack(Lds), Lo=Lo_all, ok=ok)


def block_tridiag_cholesky_partitioned_plain(D, L, chunk: int) -> BlockTridiagFactors:
    """The schedule of the factor kernel (csrc/banded.cu) in plain PyTorch,
    for the tests: the k block rows in P chunks of ``chunk``, the last row of
    chunk j its separator s_j.  (1) Chunk 0 runs the contract's chain and
    leaves S at s_0 as Sigma_0; each middle chunk factors its interior rows
    (s_{j-1}+1 .. s_j-1, an SPD principal submatrix) from no inflow,
    carrying the spike X (the interior's factor applied to the coupling to
    s_{j-1}), and folds the interior onto its two end rows: E = sum X'X on
    s_{j-1}, F between s_{j-1} and s_j, G = S at s_j.  (2) In chunk order,
    Sigma_j = G - W'W with W = chol(Sigma_{j-1} - E)^-1 F: the contract's
    S at s_j up to rounding.  (3) Each chunk after the first runs the
    contract's chain from Ld_{s_{j-1}} = chol(Sigma_{j-1}), which it alone
    writes.  A pivot that is not finite or not positive in any phase gives
    the sequential factor (:func:`block_tridiag_cholesky_plain`), whose
    ``ok`` says whether its own chain failed; one chunk is that factor."""
    k, b, _ = D.shape
    m = min(int(chunk), k)
    nchunks = -(-k // m)
    if nchunks == 1:
        return block_tridiag_cholesky_plain(D, L)
    ends = [min((j + 1) * m, k) - 1 for j in range(nchunks)]
    Ld, Lo = [None] * k, [None] * (k - 1)
    good = True

    def chol(S):
        nonlocal good
        C, info = chol_factor(S)
        good = good and bool(chol_ok(C, info))
        return C

    def lo(i, Ldp):                 # L_i Ldp^-T
        return torch.linalg.solve_triangular(Ldp, L[i].mT, upper=False).mT

    # phase 1: chunk 0 runs the chain; the middle chunks fold their interiors
    for i in range(ends[0]):
        if i > 0:
            Lo[i - 1] = lo(i - 1, Ld[i - 1])
        Ld[i] = chol(D[i] if i == 0 else D[i] - Lo[i - 1] @ Lo[i - 1].mT)
    if ends[0] > 0:
        Lo[ends[0] - 1] = lo(ends[0] - 1, Ld[ends[0] - 1])
        sigma = D[ends[0]] - Lo[ends[0] - 1] @ Lo[ends[0] - 1].mT
    else:
        sigma = D[0]
    folds = []
    for j in range(1, nchunks - 1):
        a, e = ends[j - 1] + 1, ends[j]
        if a == e:                      # no interior
            folds.append((torch.zeros_like(D[0]), L[a - 1].mT, D[e]))
            continue
        Ldp = chol(D[a])
        X = torch.linalg.solve_triangular(Ldp, L[a - 1], upper=False)
        E = X.mT @ X
        for i in range(a + 1, e):
            Lop = lo(i - 1, Ldp)
            Ldp = chol(D[i] - Lop @ Lop.mT)
            X = torch.linalg.solve_triangular(Ldp, -Lop @ X, upper=False)
            E = E + X.mT @ X
        Lop = lo(e - 1, Ldp)
        folds.append((E, X.mT @ Lop.mT, D[e] - Lop @ Lop.mT))
    # phase 2: one hop a chunk, in chunk order
    sigmas = [sigma]
    for E, F, G in folds:
        W = torch.linalg.solve_triangular(chol(sigmas[-1] - E), F, upper=False)
        sigmas.append(G - W.mT @ W)
    # phase 3: each chunk after the first from its inflow
    for j in range(1, nchunks):
        a, e = ends[j - 1] + 1, ends[j]
        Ld[a - 1] = chol(sigmas[j - 1])
        for i in range(a, e + 1):
            Lo[i - 1] = lo(i - 1, Ld[i - 1])
            if i < e or j == nchunks - 1:
                Ld[i] = chol(D[i] - Lo[i - 1] @ Lo[i - 1].mT)
    if not good:
        return block_tridiag_cholesky_plain(D, L)
    return BlockTridiagFactors(Ld=torch.stack(Ld), Lo=torch.stack(Lo),
                               ok=torch.ones((), dtype=torch.bool, device=D.device))


def block_tridiag_solve_plain(f: BlockTridiagFactors, rhs):
    """Solve A x = rhs with the block Cholesky factors ``f``: the forward
    sweep L~ y = rhs, then the backward sweep L~' x = y.  ``rhs`` is (k, b)
    or (k, b, r)."""
    banded_kernels.count_plain("solve")
    Ld, Lo = f.Ld, f.Lo
    k = Ld.shape[0]
    vec = rhs.ndim == 2
    if vec:
        rhs = rhs[..., None]
    y = [torch.linalg.solve_triangular(Ld[0], rhs[0], upper=False)]
    for i in range(1, k):
        y.append(torch.linalg.solve_triangular(Ld[i], rhs[i] - Lo[i - 1] @ y[-1], upper=False))
    x = [torch.linalg.solve_triangular(Ld[k - 1].mT, y[k - 1], upper=True)]
    for i in range(k - 2, -1, -1):
        x.append(torch.linalg.solve_triangular(Ld[i].mT, y[i] - Lo[i].mT @ x[-1], upper=True))
    out = torch.stack(x[::-1])
    return out[..., 0] if vec else out


def block_tridiag_solve_partitioned_plain(f: BlockTridiagFactors, rhs, chunk: int):
    """The schedule of the solve kernel (csrc/banded.cu) in plain PyTorch, for
    the tests: the k block rows in chunks of ``chunk``, per direction in three
    phases.  (1) Each chunk with an inflow (every chunk but the first in the
    direction) runs its substitution from zero inflow, giving the solution
    yh at its last row, and pushes the b unit inflows through the same
    substitution, giving its transfer T with y_last = yh + T y_inflow;
    (2) in chunk order, y_last = yh + T y_inflow from the value the chunk
    before published, and published in turn; (3) each chunk runs its
    substitution again from that inflow.  The first chunk of a direction
    runs once, from no inflow, and publishes its last row.  Same contract as
    :func:`block_tridiag_solve_plain`; the two differ only by the rounding
    the published inflows carry."""
    Ld, Lo = f.Ld, f.Lo
    k, b, _ = Ld.shape
    vec = rhs.ndim == 2
    if vec:
        rhs = rhs[..., None]
    nr = rhs.shape[-1]
    chunk = min(int(chunk), k)
    starts = list(range(0, k, chunk))

    def fwd_row(i, v, z):           # Ld_i^-1 (v - Lo_{i-1} z); z None: no coupling
        t = v if z is None else v - Lo[i - 1] @ z
        return torch.linalg.solve_triangular(Ld[i], t, upper=False)

    def bwd_row(i, v, z):           # Ld_i^-T (v - Lo_i' z)
        t = v if z is None else v - Lo[i].mT @ z
        return torch.linalg.solve_triangular(Ld[i].mT, t, upper=True)

    def sweep(rows, step, src, unit):
        """One direction over the chunks (``rows``: each chunk's rows in the
        order of the direction); ``unit(i)``: the coupling block whose
        columns phase 1 pushes through from the chunk's first row ``i``."""
        sol = [None] * k
        published = None
        for j, idx in enumerate(rows):
            if j == 0:
                z = None
                for i in idx:
                    z = sol[i] = step(i, src[i], z)
                published = z
                continue
            # phase 1: zero inflow (nr columns) and the b unit inflows at once
            i0 = idx[0]
            Z = step(i0, torch.cat([src[i0], -unit(i0)], dim=1), None)
            for i in idx[1:]:
                Z = step(i, torch.cat([src[i], torch.zeros_like(Z[:, nr:])], dim=1), Z)
            yh, T = Z[:, :nr], Z[:, nr:]
            # phase 2, then phase 3 from the inflow the chunk before published
            inflow, published = published, yh + T @ published
            z = inflow
            for i in idx:
                z = sol[i] = step(i, src[i], z)
        return torch.stack(sol)

    fwd_rows = [list(range(s, min(s + chunk, k))) for s in starts]
    y = sweep(fwd_rows, fwd_row, rhs, lambda i: Lo[i - 1])
    bwd_rows = [list(range(min(s + chunk, k) - 1, s - 1, -1)) for s in reversed(starts)]
    x = sweep(bwd_rows, bwd_row, y, lambda i: Lo[i].mT)
    return x[..., 0] if vec else x


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def block_tridiag_cholesky(D, L) -> BlockTridiagFactors:
    """Block Cholesky factors of (D, L) (see :func:`block_tridiag_cholesky_plain`).
    On CUDA tensors: one launch of the factor kernel, or an error."""
    if D.device.type == "cpu":
        return block_tridiag_cholesky_plain(D, L)
    Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L)
    return BlockTridiagFactors(Ld=Ld, Lo=Lo, ok=ok)


def block_tridiag_solve(f: BlockTridiagFactors, rhs):
    """Solve A x = rhs given the block Cholesky factors; ``rhs`` is (k, b)
    blocks or (k, b, r) for r right-hand sides.  On CUDA tensors: one launch
    of the solve kernel (both sweeps), or an error."""
    if rhs.device.type == "cpu":
        return block_tridiag_solve_plain(f, rhs)
    return banded_kernels.block_tridiag_solve(f.Ld, f.Lo, rhs)


def block_tridiag_matvec(D, L, x):
    """A x for the block-tridiagonal A of (D, L); ``x`` is (k, b) or (k, b, r)."""
    k = D.shape[0]
    vec = x.ndim == 2
    xb = x[..., None] if vec else x
    out = D @ xb
    if k > 1:
        out[1:] += L @ xb[:-1]
        out[:-1] += L.mT @ xb[1:]
    return out[..., 0] if vec else out
