"""Operations and bytes of one solve with the block Cholesky factors of a
block-tridiagonal matrix (k diagonal blocks of b x b), one right-hand side:
the forward sweep L y = r and the backward sweep L' x = y.  Counted as
``counts.py`` counts: the arithmetic of the algorithm, each input byte read
once and each output byte written once."""
from __future__ import annotations


def block_tridiagonal_solve(k: int, b: int, itemsize: int):
    """(operations, bytes).  Per direction and block row a triangular solve
    with the diagonal factor block (b (b - 1) / 2 multiply-adds, two
    operations each, and b divisions: b^2) and, between block rows, a
    product of an off-diagonal factor block with a vector (2 b^2).  Bytes:
    the diagonal factor blocks' lower triangles and the off-diagonal blocks
    read, the right-hand side read and the solution written."""
    links = max(k - 1, 0)
    ops = 2 * (k * b * b + links * 2 * b * b)
    entries = k * b * (b + 1) / 2 + links * b * b + 2 * k * b
    return float(ops), float(entries * itemsize)
