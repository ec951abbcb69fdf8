"""Iterative refinement (IR).

Counterpart of galahad_tpu/linalg/ir.py (GALAHAD's IR, reference
src/ir/ir.f90: IR_solve :334): residual-correction sweeps against the true
operator around any approximate solve.  Runs on the device of ``b``.
"""
from __future__ import annotations

import torch

from ..core.config import control as control_dc


@control_dc
class IRControl:
    itref_max: int = 2           # reference default sweeps
    acceptable_residual_relative: float = 1.0e-12


def ir_solve(matvec, approx_solve, b, ctl: IRControl = IRControl()):
    """x ~ A^-1 b by refinement: x += M(b - A x) for itref_max sweeps,
    where M = approx_solve.  Returns (x, final residual norm as a 0-d
    tensor)."""
    x = approx_solve(b)
    r = b - matvec(x)
    for _ in range(ctl.itref_max):
        x = x + approx_solve(r)
        r = b - matvec(x)
    return x, torch.linalg.norm(r)
