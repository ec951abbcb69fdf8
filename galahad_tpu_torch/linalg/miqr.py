"""Multilevel incomplete QR factorization for least-squares
preconditioning (MIQR).

Counterpart of galahad_tpu/linalg/miqr.py (GALAHAD's MIQR, reference
src/miqr/miqr.f90:17-26; Li & Saad, SIMAX 28(2):524-550): recursively pick
sets of nearly orthogonal columns, orthogonalize the rest against them and
recurse on the remainder, dropping small fill.  The level construction is
host-side analysis (numpy), as in the JAX package; the factors the applies
read (each level's column norms and coupling block, the final dense R) are
tensors on the device, and ``miqr_apply`` / ``miqr_apply_transpose`` run
there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from .._device import resolve_device
from ..core.config import control as control_dc


@control_dc
class MIQRControl:
    max_levels: int = 4
    angle_tol: float = 0.1       # |cos| threshold for "orthogonal enough"
    drop_tol: float = 1.0e-3     # drop fill below this relative size
    min_reduction: float = 0.1   # stop recursing if a level selects < 10%


@dataclasses.dataclass
class MIQRFactors:
    """Per level: the selected columns, their norms ``d`` (the selected
    columns are treated as orthogonal: the 'incomplete' part) and the
    coupling block ``R12``; the final level a dense R of the remainder."""
    levels: List[Any]
    R_final: Any
    perm: Any            # column permutation (the selections, concatenated)
    n: int


def miqr_form(A, ctl: MIQRControl = MIQRControl(), device=None) -> MIQRFactors:
    """Build the multilevel incomplete R of the dense (m, n) A.  The factors
    go to A's device if A is a tensor, else to ``device`` (``None``: the
    card)."""
    if torch.is_tensor(A):
        device = A.device
        A = A.detach().cpu().numpy()
    else:
        device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device)

    A = np.asarray(A, np.float64)
    m, n = A.shape
    levels = []
    remaining = np.arange(n)
    work = A.copy()
    for _ in range(ctl.max_levels):
        k = work.shape[1]
        if k == 0:
            break
        norms = np.linalg.norm(work, axis=0)
        norms = np.where(norms > 0, norms, 1.0)
        W = work / norms
        order = np.argsort(-norms)
        sel: list = []
        G = W.T @ W
        chosen = np.zeros(k, bool)
        for j in order:
            if all(abs(G[j, s]) <= ctl.angle_tol for s in sel):
                sel.append(int(j))
                chosen[j] = True
        if len(sel) < max(1, int(ctl.min_reduction * k)):
            break
        sel_idx = np.array(sel, np.int64)
        rest_idx = np.nonzero(~chosen)[0]
        Q = W[:, sel_idx]
        C = Q.T @ work[:, rest_idx]
        C[np.abs(C) < ctl.drop_tol * norms[rest_idx][None, :]] = 0.0
        work = work[:, rest_idx] - Q @ C
        levels.append(dict(cols=remaining[sel_idx], rest=remaining[rest_idx],
                           d=norms[sel_idx], R12=C))
        remaining = remaining[rest_idx]
        if remaining.size == 0:
            break

    if remaining.size:
        R_final = np.linalg.qr(work, mode="r")
        dset = np.abs(np.diag(R_final))
        bad = dset < 1e-12 * max(dset.max(), 1.0)
        R_final[bad, bad] = 1.0
    else:
        R_final = np.zeros((0, 0))
    perm = (np.concatenate([lv["cols"] for lv in levels] + [remaining])
            if levels or remaining.size else np.zeros(0, np.int64)).astype(np.int64)
    # the coupling blocks, reordered once from each level's "rest" order
    # to the final permutation's
    offset = 0
    for lv in levels:
        offset += len(lv["cols"])
        lut = {int(c): i for i, c in enumerate(lv["rest"])}
        mapping = np.array([lut[int(c)] for c in perm[offset:]], np.int64)
        lv["R12"] = dev(lv["R12"][:, mapping])
        lv["d"] = dev(lv["d"])
    return MIQRFactors(levels=levels, R_final=dev(R_final),
                       perm=torch.as_tensor(perm, device=device), n=n)


def miqr_apply(f: MIQRFactors, y):
    """x = R^-1 y (the right-preconditioner apply)."""
    pos = 0
    slots = []
    for lv in f.levels:
        kk = len(lv["cols"])
        slots.append((pos, pos + kk))
        pos += kk
    nfin = f.n - pos
    if nfin:
        x_rest = torch.linalg.solve(f.R_final, y[pos:pos + nfin])
    else:
        x_rest = y[:0]
    for lv, (a, b) in zip(reversed(f.levels), reversed(slots)):
        x_lvl = (y[a:b] - lv["R12"] @ x_rest) / lv["d"]
        x_rest = torch.cat([x_lvl, x_rest])
    x = torch.zeros(f.n, dtype=y.dtype, device=y.device)
    return x.index_copy(0, f.perm, x_rest)


def miqr_apply_transpose(f: MIQRFactors, x):
    """y = R^-T x."""
    carry = x.index_select(0, f.perm)
    out = []
    for lv in f.levels:
        kk = len(lv["cols"])
        head, carry = carry[:kk], carry[kk:]
        y_lvl = head / lv["d"]
        carry = carry - lv["R12"].T @ y_lvl
        out.append(y_lvl)
    if carry.shape[0]:
        out.append(torch.linalg.solve(f.R_final.T, carry))
    return torch.cat(out) if out else x[:0]
