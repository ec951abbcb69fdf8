"""Sparse matrix-vector operations over static COO metadata.

Counterpart of galahad_tpu/linalg/mop.py (GALAHAD's MOP package, reference
src/mop/mop.f90: mop_Ax :40, the row-norm and scaling helpers).  The index
arrays ``row`` / ``col`` are host numpy (static metadata); the values and
vectors are tensors, and every result lies on their device.  Each product
is one gather and one sum per destination in a fixed order
(core/segsum.py): the JAX package's ``segment_sum`` would be a scatter with
atomics on a CUDA device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.segsum import SegmentSum


def _idx(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)


def coo_Ax(row, col, val, x, m: int, symmetric: bool = False):
    """y = A x from coordinate data.  With ``symmetric``, the triples
    describe the lower triangle of a symmetric A."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    dev = x.device
    if symmetric:
        off = np.flatnonzero(row != col)
        dest = np.concatenate([row, col[off]])
        src = np.concatenate([col, row[off]])
        v = torch.cat([val, val.index_select(0, _idx(off, dev))])
    else:
        dest, src, v = row, col, val
    return SegmentSum(dest, m)(v * x.index_select(0, _idx(src, dev)))


def coo_Aty(row, col, val, y, n: int):
    """x = A' y."""
    return coo_Ax(col, row, val, y, n)


def coo_row_norms(row, col, val, m: int, ord: float = math.inf):
    """Row norms of A (empty rows: 0 for ord 1 and 2, -inf for ord inf, as
    the JAX package's segment reductions give)."""
    row = np.asarray(row, np.int64)
    if ord == math.inf:
        seg = SegmentSum(row, m)
        order, lengths, _ = seg.on(val.device)
        if seg.nnz == 0:
            return torch.full((m,), -math.inf, dtype=val.dtype, device=val.device)
        out = torch.segment_reduce(val.abs().index_select(0, order), "max",
                                   lengths=lengths, unsafe=True)
        return torch.where(lengths > 0, out, -math.inf)
    if ord == 1:
        return SegmentSum(row, m)(val.abs())
    if ord == 2:
        return torch.sqrt(SegmentSum(row, m)(val * val))
    raise ValueError("ord must be 1, 2 or inf")


def coo_col_norms(row, col, val, n: int, ord: float = math.inf):
    return coo_row_norms(col, row, val, n, ord)


def coo_scale(row, col, val, r_scale, c_scale):
    """Values of diag(r) A diag(c)."""
    dev = val.device
    return (val * r_scale.index_select(0, _idx(row, dev))
            * c_scale.index_select(0, _idx(col, dev)))


def coo_extract_diagonal(row, col, val, n: int):
    row = np.asarray(row, np.int64)
    d = np.flatnonzero(row == np.asarray(col, np.int64))
    return SegmentSum(row[d], n)(val.index_select(0, _idx(d, val.device)))
