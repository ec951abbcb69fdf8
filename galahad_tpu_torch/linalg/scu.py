"""Schur-complement updating for bordered systems (SCU).

Counterpart of galahad_tpu/linalg/scu.py (GALAHAD's SCU, reference
src/scu/scu.f90: SCU_factorize :200, SCU_solve :643, SCU_append :811,
SCU_delete :1176): solve

    [ A  B ] [x1]   [b1]
    [ C  D ] [x2] = [b2]

where the caller owns a factorization of A (a solve closure) and the
border grows and shrinks as an active set changes.  The border lives in
fixed-capacity buffers on the device with the active count a 0-d tensor,
so no operation reads the host; ``W = A^-1 B`` is kept, so an append costs
one A-solve, a delete none, and ``scu_refresh`` rebuilds W and S.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import resolve_device, resolve_dtype


@dataclasses.dataclass
class SCUState:
    B: Any        # (n, cap) border columns
    C: Any        # (cap, n) border rows
    D: Any        # (cap, cap) corner block
    S: Any        # (cap, cap) Schur complement (identity on unused slots)
    W: Any        # (n, cap) kept A^-1 B
    count: Any    # 0-d int64 tensor: active border size
    cap: int = 0
    n: int = 0


def scu_setup(n: int, cap: int, dtype=None, device=None) -> SCUState:
    """An empty border of capacity ``cap`` on ``device`` (``None``: the card)."""
    like = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    z = torch.zeros
    return SCUState(B=z((n, cap), **like), C=z((cap, n), **like), D=z((cap, cap), **like),
                    S=torch.eye(cap, **like), W=z((n, cap), **like),
                    count=torch.zeros((), dtype=torch.int64, device=like["device"]),
                    cap=cap, n=n)


def _mask(state: SCUState):
    return torch.arange(state.cap, device=state.S.device) < state.count


def _onehot(state: SCUState, j):
    return torch.arange(state.cap, device=state.S.device) == j


def scu_append(state: SCUState, a_solve: Callable, b_col, c_row, d_val) -> SCUState:
    """Grow the border by one (row, column): SCU_append.  b_col (n,),
    c_row (n,), d_val a number or 0-d tensor.  One A-solve."""
    j = state.count
    old = _mask(state)
    e = _onehot(state, j)
    w = a_solve(b_col)
    B = torch.where(e[None, :], b_col[:, None], state.B)
    C = torch.where(e[:, None], c_row[None, :], state.C)
    D = torch.where(e[:, None] & e[None, :], d_val, state.D)
    W = torch.where(e[None, :], w[:, None], state.W)
    s_col = torch.where(old, -(state.C @ w), 0.0)
    s_row = torch.where(old, -(c_row @ state.W), 0.0)
    s_jj = d_val - torch.dot(c_row, w)
    S = torch.where(e[None, :], s_col[:, None], state.S)
    S = torch.where(e[:, None], s_row[None, :], S)
    S = torch.where(e[:, None] & e[None, :], s_jj, S)
    return dataclasses.replace(state, B=B, C=C, D=D, S=S, W=W, count=j + 1)


def _swap(M, i, j, dim: int):
    """M with its i-th and j-th slices along ``dim`` exchanged (i, j 0-d)."""
    k = torch.arange(M.shape[dim], device=M.device)
    src = torch.where(k == i, j, torch.where(k == j, i, k))
    return M.index_select(dim, src)


def scu_delete(state: SCUState, a_solve: Callable, idx) -> SCUState:
    """Remove border entry ``idx`` (SCU_delete): swap the last active slot
    into ``idx`` and shrink.  No A-solves."""
    del a_solve
    last = state.count - 1
    B = _swap(state.B, idx, last, 1)
    W = _swap(state.W, idx, last, 1)
    C = _swap(state.C, idx, last, 0)
    D = _swap(_swap(state.D, idx, last, 0), idx, last, 1)
    S = _swap(_swap(state.S, idx, last, 0), idx, last, 1)
    e = _onehot(state, last)
    B = torch.where(e[None, :], 0.0, B)
    W = torch.where(e[None, :], 0.0, W)
    C = torch.where(e[:, None], 0.0, C)
    D = torch.where(e[:, None] | e[None, :], 0.0, D)
    S = torch.where(e[:, None] | e[None, :], 0.0, S)
    S = torch.where(e[:, None] & e[None, :], 1.0, S)
    return dataclasses.replace(state, B=B, C=C, D=D, S=S, W=W, count=last)


def scu_refresh(state: SCUState, a_solve: Callable) -> SCUState:
    """Recompute W = A^-1 B and S = D - C W on the active slots (one
    batched solve)."""
    m = _mask(state)
    W = a_solve(state.B)
    S = state.D - state.C @ W
    S = torch.where(m[:, None] & m[None, :], S, 0.0)
    S = S + torch.diag(torch.where(m, 0.0, 1.0).to(S.dtype))
    W = torch.where(m[None, :], W, 0.0)
    return dataclasses.replace(state, S=S, W=W)


def scu_solve(state: SCUState, a_solve: Callable, b1, b2):
    """Solve the bordered system (SCU_solve) by block elimination:
    S x2 = b2 - C A^-1 b1;  x1 = A^-1 b1 - W x2.  b2 is (cap,), its
    inactive entries ignored."""
    m = _mask(state)
    w = a_solve(b1)
    rhs2 = torch.where(m, b2 - state.C @ w, 0.0)
    x2 = torch.linalg.solve(state.S, rhs2)
    x2 = torch.where(m, x2, 0.0)
    x1 = w - state.W @ x2
    return x1, x2
