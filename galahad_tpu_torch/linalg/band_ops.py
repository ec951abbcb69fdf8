"""Banded-matrix operations in diagonal (DIA) storage.

Counterpart of galahad_tpu/linalg/band_ops.py, the support layer of the
banded IPM path (qp/ipm_banded.py).  A banded m x n matrix is a static tuple
of diagonal offsets and an (ndiag, m) value tensor:

    val[p, i] = A[i, i + offsets[p]]      (zero where out of range)

Every operation is O(ndiag * m) or O(ndiag^2 * m) elementwise work on
slices; no dense matrix is formed (except by ``to_dense``):
  * banded matvec and transpose matvec;
  * S = A diag(d) A' assembled directly in symmetric DIA storage;
  * symmetric DIA -> block-tridiagonal (D, L), the input of
    linalg/banded.py's block Cholesky.

The JAX version reads every diagonal at clipped indices and adds 0 where the
index is out of range (``jnp.where(ok, ..., 0)``), with ``.at[].add`` for the
scatters.  Here each diagonal adds over its valid range only, a slice of the
same length on both sides: the same terms in the same order of diagonals, no
``index_add_`` or ``scatter_add`` (whose order of adds can vary on the card),
and nothing that reads the host, so that the IPM step that calls these can be
captured in a CUDA graph.
"""
from __future__ import annotations

import dataclasses

import torch


def _span(off: int, rows: int, cols: int):
    """The rows i of a diagonal ``off`` of a rows x cols matrix with
    0 <= i + off < cols: ``range(lo, hi)`` (empty when hi <= lo)."""
    return max(0, -off), min(rows, cols - off)


@dataclasses.dataclass
class BandMatrix:
    """Banded m x n matrix in DIA storage (row-indexed diagonals)."""

    val: torch.Tensor        # (ndiag, m)
    offsets: tuple = ()      # A[i, i + off]
    m: int = 0
    n: int = 0

    def matvec(self, x):
        """A x: over the diagonals in order, val[p] * x[i + off_p]."""
        out = torch.zeros(self.m, dtype=x.dtype, device=x.device)
        for p, off in enumerate(self.offsets):
            lo, hi = _span(off, self.m, self.n)
            if hi > lo:
                out[lo:hi] += self.val[p, lo:hi] * x[lo + off:hi + off]
        return out

    def rmatvec(self, y):
        """A' y: val[p, i] * y[i] added into row i + off_p of the result,
        the diagonals in order (one diagonal's rows are distinct)."""
        out = torch.zeros(self.n, dtype=y.dtype, device=y.device)
        for p, off in enumerate(self.offsets):
            lo, hi = _span(off, self.m, self.n)
            if hi > lo:
                out[lo + off:hi + off] += self.val[p, lo:hi] * y[lo:hi]
        return out

    def to_dense(self):
        A = torch.zeros((self.m, self.n), dtype=self.val.dtype, device=self.val.device)
        for p, off in enumerate(self.offsets):
            lo, hi = _span(off, self.m, self.n)
            if hi > lo:
                A.diagonal(off).add_(self.val[p, lo:hi])
        return A


def band_from_dense(A, offsets) -> BandMatrix:
    """The diagonals ``offsets`` of the dense tensor ``A`` in DIA storage."""
    m, n = A.shape
    val = torch.zeros((len(offsets), m), dtype=A.dtype, device=A.device)
    for p, off in enumerate(offsets):
        lo, hi = _span(off, m, n)
        if hi > lo:
            val[p, lo:hi] = A.diagonal(off)
    return BandMatrix(val=val, offsets=tuple(int(o) for o in offsets), m=m, n=n)


def sym_band_matvec(diags, x):
    """Symmetric banded matvec: ``diags`` (w+1, n) holds subdiagonal s in
    row s, diags[s, i] = A[i + s, i]."""
    w1, n = diags.shape
    out = diags[0] * x
    for s in range(1, w1):
        if s >= n:
            break
        # sub-diagonal: out[i+s] += d[s,i] x[i];  super: out[i] += d[s,i] x[i+s]
        out[s:] += diags[s, :n - s] * x[:n - s]
        out[:n - s] += diags[s, :n - s] * x[s:]
    return out


def band_ADAt(A: BandMatrix, d):
    """S = A diag(d) A' in symmetric DIA storage (w+1, m), w the spread of
    the offsets: S[i + s, i] = sum over p, q with off_p - off_q = s of
    val[p, i] d[i + off_p] val[q, i + s]."""
    offs = A.offsets
    w = max(offs) - min(offs)
    m = A.m
    Sd = torch.zeros((w + 1, m), dtype=A.val.dtype, device=A.val.device)
    for p, op in enumerate(offs):
        for q, oq in enumerate(offs):
            s = op - oq
            if s < 0:
                continue
            # S[i + s, i] += A[i, i+op] d[i+op] A[i+s, i+s+oq]: needs
            # 0 <= i + op < n and i + s < m
            lo, hi = _span(op, m - s, A.n)
            if hi > lo:
                Sd[s, lo:hi] += (A.val[p, lo:hi] * d[lo + op:hi + op]) * A.val[q, lo + s:hi + s]
    return Sd


def sym_band_add_diag(Sd, c):
    """``Sd`` with ``c`` added to its main diagonal (a new tensor)."""
    out = Sd.clone()
    out[0] += c
    return out


def sym_band_to_blocks(Sd, block: int):
    """Symmetric DIA (w+1, n) -> block-tridiagonal (D (k, b, b), L (k-1, b, b))
    with block size b = ``block`` >= w; n is padded to k * b with an identity
    diagonal.  Diagonal s of the band fills diagonals -s and s of every D_i
    and diagonal b - s of every L_i, each one strided copy."""
    w1, n = Sd.shape
    w = w1 - 1
    if block < w:
        raise ValueError(f"block size {block} must cover the semibandwidth {w}")
    b = block
    k = -(-n // b)
    npad = k * b
    Sp = torch.zeros((w1, npad), dtype=Sd.dtype, device=Sd.device)
    Sp[:, :n] = Sd
    if npad > n:
        Sp[0, n:] = 1.0
    D = torch.zeros((k, b, b), dtype=Sd.dtype, device=Sd.device)
    L = torch.zeros((max(k - 1, 0), b, b), dtype=Sd.dtype, device=Sd.device)
    for s in range(min(w, b - 1) + 1):
        # D_i[c + s, c] = D_i[c, c + s] = A[i b + c + s, i b + c] = Sd[s, i b + c]
        V = Sp[s].view(k, b)[:, :b - s]
        D.diagonal(-s, 1, 2).copy_(V)
        if s:
            D.diagonal(s, 1, 2).copy_(V)
    if k > 1:
        for s in range(1, w + 1):
            # L_i[r, r + b - s] = A[(i+1) b + r, i b + r + b - s] = Sd[s, i b + r + b - s]
            L.diagonal(b - s, 1, 2).copy_(Sp[s].view(k, b)[:k - 1, b - s:])
    return D, L
