"""Schur-complement / normal-matrix assembly (BSC equivalent).

Counterpart of galahad_tpu/linalg/bsc.py (GALAHAD's BSC, reference
src/bsc/bsc.f90: BSC_form :372): S = A D A', for Schur-complement KKT
reductions and the Gauss-Newton J'J.  Three modes:

* dense (:func:`bsc_form`): one scaled matmul;
* block-tridiagonal extraction for banded A (:func:`bsc_form_blocks`);
* sparse (:func:`bsc_analyse` + :func:`bsc_form_sparse`): the host's
  symbolic pattern of S on COO input, then a numeric phase on the device of
  one gather, one product and a sum of each S entry's products in a fixed
  order (``core/segsum.py``), no scatter-add.  The lower-COO output feeds
  the flat supernodal LDL^T directly (the sparse Gauss-Newton of
  nlp/nls.py).

``bsc_analyse`` refuses a pattern with duplicate (row, column) entries: the
JAX package's analysis sums the index payload of duplicates into one
out-of-range entry id (galahad_tpu/linalg/bsc.py:92).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.segsum import SegmentSum
from ..core.sparse import COOPattern


def bsc_form(A, d=None):
    """S = A diag(d) A' (d=None -> identity).  A (..., m, n)."""
    At = A.mT
    if d is None:
        return A @ At
    return (A * d[..., None, :]) @ At


def bsc_form_blocks(A, d, block: int):
    """S = A diag(d) A' as block-tridiagonal (D, L) when A has row bandwidth
    <= block (rows i and j share no column when |i - j| >= block); the
    padding of the last block is the identity.  Feeds linalg/banded.py."""
    S = bsc_form(A, d)
    m = S.shape[-1]
    k = -(-m // block)
    pad = k * block - m
    if pad:
        S = F.pad(S, (0, pad, 0, pad))
        idx = torch.arange(m, k * block, device=S.device)
        S[..., idx, idx] = 1.0
    D = torch.stack([S[..., i * block:(i + 1) * block, i * block:(i + 1) * block]
                     for i in range(k)], dim=-3)
    if k > 1:
        L = torch.stack([S[..., (i + 1) * block:(i + 2) * block, i * block:(i + 1) * block]
                         for i in range(k - 1)], dim=-3)
    else:
        L = S.new_zeros(S.shape[:-2] + (0, block, block))
    return D, L


class BSCPlan:
    """Host-analysed sparse S = A D A' assembly (identity-hashed; the
    analyse-once / form-many contract of BSC_form, bsc.f90:372).  The
    products are sorted by their S entry, and each entry's products keep the
    order of the analysis (column of A, then row pair)."""

    __slots__ = ("m", "n", "s_pat", "p1", "p2", "dcol", "sout", "_dev")

    def __init__(self, m, n, s_pat, p1, p2, dcol, sout):
        self.m, self.n = m, n
        self.s_pat = s_pat          # COOPattern, lower triangle of S
        self.p1, self.p2 = p1, p2   # product operand entry ids into a_vals
        self.dcol = dcol            # column (diagonal D index) per product
        self.sout = sout            # S-entry id per product (sorted)
        self._dev = {}

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def device(self, device):
        """(p1, p2, dcol, SegmentSum over sout) with the indices on ``device``."""
        key = str(device)
        hit = self._dev.get(key)
        if hit is None:
            t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
            hit = (t(self.p1), t(self.p2), t(self.dcol),
                   SegmentSum(self.sout, self.s_pat.nnz, dense=True))
            self._dev[key] = hit
        return hit


def bsc_analyse(a_pat) -> BSCPlan:
    """Symbolic pattern of S = A D A' from a COOPattern of A (m x n): for
    every column c, all row pairs (i >= j) with entries in c contribute
    A[i,c] D[c] A[j,c] to S[i,j].  Host numpy, O(sum_c nnz_c^2), the pairs of
    all columns with the same count made at once.  Raises ``ValueError`` on
    duplicate (row, column) entries."""
    rows = np.asarray(a_pat.rows, np.int64)
    cols = np.asarray(a_pat.cols, np.int64)
    m, n = a_pat.m, a_pat.n
    nnz = len(rows)
    key_a = cols * max(m, 1) + rows
    if len(np.unique(key_a)) != nnz:
        raise ValueError("bsc_analyse: the COO pattern of A holds duplicate (row, column) "
                         "entries; coalesce them first")
    # entries by column, then row (the CSC order of the JAX package's analysis)
    e_sorted = np.lexsort((rows, cols))
    counts = np.bincount(cols, minlength=n) if nnz else np.zeros(n, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]) if n else np.zeros(0, np.int64)
    P1, P2, DC, II, JJ = [], [], [], [], []
    for k in np.unique(counts[counts > 0]):
        cs = np.nonzero(counts == k)[0]                     # the columns with k entries
        ii, jj = np.tril_indices(k)                         # row pairs i >= j in the column
        order = np.lexsort((jj, ii))                        # meshgrid order: ii, then jj
        ii, jj = ii[order], jj[order]
        base = starts[cs][:, None]
        P1.append(e_sorted[base + ii[None, :]].reshape(-1))
        P2.append(e_sorted[base + jj[None, :]].reshape(-1))
        DC.append(np.repeat(cs, len(ii)))
        II.append(np.tile(ii, len(cs)))
        JJ.append(np.tile(jj, len(cs)))
    if P1:
        p1, p2, dc = (np.concatenate(a) for a in (P1, P2, DC))
        ii, jj = np.concatenate(II), np.concatenate(JJ)
        first = np.lexsort((jj, ii, dc))                    # column, then row pair
        p1, p2, dc = p1[first], p2[first], dc[first]
    else:
        p1 = p2 = dc = np.zeros(0, np.int64)
    key = rows[p1] * m + rows[p2]
    uniq, inv = np.unique(key, return_inverse=True)
    order = np.argsort(inv, kind="stable")                  # sorted segments
    s_pat = COOPattern(uniq // max(m, 1), uniq % max(m, 1), m, m)
    return BSCPlan(m, n, s_pat, p1[order], p2[order], dc[order], inv[order])


def bsc_form_sparse(plan: BSCPlan, a_vals, d=None):
    """Numeric S = A diag(d) A' on the analysed pattern: the (nnz_S,) values
    aligned with ``plan.s_pat`` (lower COO).  One gather, one product and a
    fixed-order segment sum on the values' device."""
    p1, p2, dc, seg = plan.device(a_vals.device)
    prod = a_vals.index_select(0, p1) * a_vals.index_select(0, p2)
    if d is not None:
        prod = prod * d.index_select(0, dc)
    return seg(prod)
