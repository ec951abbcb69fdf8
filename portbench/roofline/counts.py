"""Operations and bytes that one call of a kernel needs, from the shapes of
its inputs: each input byte read once, each output byte written once, and
the arithmetic of the algorithm, not of one design of it.  Kept with the
benchmark so that a change to a kernel cannot move its yardstick."""
from __future__ import annotations

import numpy as np


def partial_ldlt(nc, nf, itemsize: int):
    """(operations, bytes) of the partial LDL' of fronts with ``nc``
    eliminated columns out of ``nf`` rows each (arrays, one entry a front).
    Per eliminated column j, with r = nf - 1 - j rows below it: r divisions
    and the symmetric rank-1 update of the r x r trailing lower triangle,
    r (r + 1) multiply-adds counted as two operations each over half.  Bytes:
    the front's lower triangle read; the eliminated columns' lower part and
    the Schur complement's lower triangle written."""
    nc = np.asarray(nc, np.float64)
    nf = np.asarray(nf, np.float64)
    live = nc > 0
    nc, nf = nc[live], nf[live]
    a = nf - 1.0
    # sum_{j<c} r_j and sum_{j<c} r_j^2 for r_j = a - j, in closed form
    s1 = nc * a - nc * (nc - 1) / 2
    s2 = nc * a * a - a * nc * (nc - 1) + (nc - 1) * nc * (2 * nc - 1) / 6
    ops = float((s1 + s2 + s1).sum())
    u = nf - nc
    entries = nf * (nf + 1) / 2 + (nc * (nc + 1) / 2 + u * nc) + u * (u + 1) / 2
    return ops, float(entries.sum()) * itemsize


def triangular_sweeps(nc, nf, rhs_rows: int, itemsize: int, direction: str):
    """(operations, bytes) of one sweep of L (forward: L and D; backward:
    L') over fronts with ``nc`` eliminated columns of ``nf`` rows, on a
    right-hand side of ``rhs_rows`` rows.  Bytes: the L entries below the
    diagonal of the eliminated columns (and forward the diagonal D), each
    front's row map (int32), and the right-hand side read and written once.
    Operations: a multiply-add per L entry, and forward a division per
    eliminated column."""
    nc = np.asarray(nc, np.float64)
    nf = np.asarray(nf, np.float64)
    live = nc > 0
    nc, nf = nc[live], nf[live]
    entries = float((nc * nf - nc * (nc + 1) / 2).sum())
    ops = 2.0 * entries
    nbytes = entries * itemsize + 4.0 * float(nf.sum()) + 2.0 * rhs_rows * itemsize
    if direction == "fwd":
        ops += float(nc.sum())
        nbytes += float(nc.sum()) * itemsize
    return ops, nbytes


def block_tridiagonal_cholesky(k: int, b: int, itemsize: int):
    """(operations, bytes) of the Cholesky of a block-tridiagonal matrix of
    k diagonal blocks of b x b: per block row the Cholesky of its diagonal
    block (b^3 / 3), the triangular solve for the off-diagonal factor block
    (b^3) and its product into the next diagonal block's lower triangle
    (b^2 (b + 1)).  Bytes: the diagonal blocks' lower triangles and the
    off-diagonal blocks read, the factors' lower triangles and off-diagonal
    blocks written."""
    tri = b * (b + 1) / 2
    ops = k * b ** 3 / 3 + max(k - 1, 0) * (b ** 3 + b * b * (b + 1))
    nbytes = 2.0 * (k * tri + max(k - 1, 0) * b * b) * itemsize
    return float(ops), float(nbytes)
