"""Sparse storage-format conversions (coordinate / CSR / CSC / dense).

Counterpart of galahad_tpu/linalg/convert.py (GALAHAD's CONVERT package,
reference src/convert/convert.f90:282,483, and the SMT/ZD11 storage kinds,
src/zd11/zd11.f90:12-17), the port's own copy.  The conversions run on the
host (numpy): they make the static sparsity metadata that the device code
is built against, once, in the set-up phase; the device code receives
the index arrays as tensors where it needs them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class COO(NamedTuple):
    """Coordinate storage (SMT 'COORDINATE', zd11.f90:12-17)."""
    m: int
    n: int
    row: np.ndarray      # (ne,) int32
    col: np.ndarray      # (ne,) int32
    val: np.ndarray      # (ne,)


class CSR(NamedTuple):
    """Sparse-by-rows (SMT 'SPARSE_BY_ROWS')."""
    m: int
    n: int
    ptr: np.ndarray      # (m+1,) int32
    col: np.ndarray      # (ne,) int32
    val: np.ndarray      # (ne,)


def coo_to_csr(a: COO) -> CSR:
    order = np.lexsort((a.col, a.row))
    row = a.row[order]
    col = a.col[order]
    val = a.val[order]
    ptr = np.zeros(a.m + 1, np.int32)
    np.add.at(ptr, row + 1, 1)
    ptr = np.cumsum(ptr).astype(np.int32)
    return CSR(a.m, a.n, ptr, col.astype(np.int32), val)


def csr_to_coo(a: CSR) -> COO:
    row = np.repeat(np.arange(a.m, dtype=np.int32), np.diff(a.ptr))
    return COO(a.m, a.n, row, a.col.copy(), a.val.copy())


def csr_to_csc(a: CSR) -> CSR:
    """Transpose-representation: returns CSC of A as CSR of A^T."""
    c = csr_to_coo(a)
    return coo_to_csr(COO(a.n, a.m, c.col, c.row, c.val))


def coo_to_dense(a: COO, sum_duplicates: bool = True) -> np.ndarray:
    out = np.zeros((a.m, a.n), a.val.dtype)
    if sum_duplicates:
        np.add.at(out, (a.row, a.col), a.val)
    else:
        out[a.row, a.col] = a.val
    return out


def csr_to_dense(a: CSR) -> np.ndarray:
    return coo_to_dense(csr_to_coo(a))


def dense_to_coo(M, tol: float = 0.0) -> COO:
    M = np.asarray(M)
    row, col = np.nonzero(np.abs(M) > tol)
    return COO(M.shape[0], M.shape[1], row.astype(np.int32),
               col.astype(np.int32), M[row, col])


def dense_to_csr(M, tol: float = 0.0) -> CSR:
    return coo_to_csr(dense_to_coo(M, tol))


def symmetric_expand(a: COO) -> COO:
    """Lower-triangle symmetric COO -> full COO (the reference stores
    symmetric matrices as lower triangles; solvers that need the full
    pattern expand, convert.f90 usage in sls/sbls)."""
    off = a.row != a.col
    return COO(
        a.m, a.n,
        np.concatenate([a.row, a.col[off]]).astype(np.int32),
        np.concatenate([a.col, a.row[off]]).astype(np.int32),
        np.concatenate([a.val, a.val[off]]),
    )


def band_from_coo(a: COO, semibandwidth: int | None = None):
    """Symmetric lower-triangle COO -> LAPACK-style lower band storage
    (kd+1, n) — the input form of the block-tridiagonal path
    (linalg/banded.py)."""
    if semibandwidth is None:
        semibandwidth = int(np.max(a.row - a.col, initial=0))
    n = a.n
    band = np.zeros((semibandwidth + 1, n), a.val.dtype)
    lower = a.row >= a.col
    r, c, v = a.row[lower], a.col[lower], a.val[lower]
    np.add.at(band, (r - c, c), v)
    # entries given as upper triangle
    upper = a.row < a.col
    r, c, v = a.col[upper], a.row[upper], a.val[upper]
    np.add.at(band, (r - c, c), v)
    return band
