"""Sparse Hessian recovery from secant pairs (gradient differences).

Counterpart of galahad_tpu/qn/sha.py (GALAHAD's SHA, reference
src/sha/sha.f90: SHA_analyse :420, SHA_estimate :1005): given a symmetric
sparsity pattern and pairs (s_k, y_k) with H s_k ~= y_k, recover each row's
entries from a small least-squares system.  :func:`sha_analyse` is host
numpy; :func:`sha_estimate` pads every row's system to the largest row
degree and solves the normal equations of all rows in one batched
``torch.linalg.solve`` (a library call, as the JAX package's is).  H is
assembled by ``index_put_`` on the unique (row, column) pairs of the
pattern, the padded slots left out: no accumulation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SHAPattern:
    """Symbolic analysis product (SHA_analyse equivalent): per-row column
    indices padded to the largest degree with column 0."""

    row_cols: np.ndarray     # (n, max_deg) int64
    row_deg: np.ndarray      # (n,) degrees
    n: int = 0
    max_deg: int = 0


def sha_analyse(n: int, rows, cols) -> SHAPattern:
    """Per-row padded index sets of a symmetric pattern given in coordinate
    form (both triangles or either)."""
    adj = [set() for _ in range(n)]
    for r, c in zip(np.asarray(rows), np.asarray(cols)):
        adj[int(r)].add(int(c))
        adj[int(c)].add(int(r))
    deg = np.array([len(a) for a in adj], np.int64)
    max_deg = int(deg.max()) if n else 0
    padded = np.zeros((n, max_deg), np.int64)
    for i, a in enumerate(adj):
        idx = sorted(a)
        padded[i, :len(idx)] = idx
    return SHAPattern(row_cols=padded, row_deg=deg, n=n, max_deg=max_deg)


def sha_estimate(pattern: SHAPattern, S, Y):
    """Estimate H (symmetric, on the pattern) from pairs H s_k ~= y_k.

    S, Y: (npairs, n) tensors.  Row i solves
        min || S[:, cols_i] h_i - Y[:, i] ||
    over its entries h_i by the normal equations, every row in one batched
    solve (needs npairs >= the largest row degree for full rank).  Each
    off-diagonal entry is estimated from both of its rows and averaged.
    Returns the dense (n, n) H (zeros off the pattern)."""
    n, D = pattern.n, pattern.max_deg
    dev, dt = S.device, S.dtype
    cols_np = np.asarray(pattern.row_cols, np.int64).reshape(n, D)
    deg_np = np.asarray(pattern.row_deg, np.int64)
    cols = torch.as_tensor(cols_np, device=dev)
    mask = torch.as_tensor(np.arange(D)[None, :] < deg_np[:, None], device=dev)   # (n, D)
    A = S[:, cols].permute(1, 0, 2)                       # (n, npairs, D)
    A = torch.where(mask[:, None, :], A, 0.0)
    At = A.mT
    # padded columns get a unit diagonal so that G stays regular
    G = At @ A + torch.diag_embed(torch.where(mask, 0.0, 1.0).to(dt))
    h = torch.linalg.solve(G, (At @ Y.T[:, :, None]))[..., 0]
    h = torch.where(mask, h, 0.0)
    active = (np.arange(D)[None, :] < deg_np[:, None]).reshape(-1)
    sel = torch.as_tensor(np.nonzero(active)[0], device=dev)
    r_idx = torch.as_tensor(np.repeat(np.arange(n), D)[active], device=dev)
    c_idx = torch.as_tensor(cols_np.reshape(-1)[active], device=dev)
    H = torch.zeros((n, n), dtype=dt, device=dev).index_put_(
        (r_idx, c_idx), h.reshape(-1).index_select(0, sel))
    mult = torch.zeros((n, n), dtype=dt, device=dev).index_put_(
        (r_idx, c_idx), torch.ones(len(sel), dtype=dt, device=dev))
    total = mult + mult.T
    return torch.where(total > 0, (H + H.T) / torch.clamp(total, min=1.0), 0.0)
