"""Active-set (working-set) QP solver, and the QPC composite.

Counterpart of galahad_tpu/qp/qpa.py (GALAHAD's QPA, reference
src/qpa/qpa.f90: QPA_solve :897, and QPC, src/qpc/qpc.f90: interior point
then active set).  The working set is a boolean mask and the KKT matrix
keeps its full (n + m + n) layout, inactive rows replaced by identity rows
that fix their multiplier to zero; each iteration assembles it and solves
it by ``torch.linalg.solve`` (the library's LU, as the JAX package calls
XLA's).  The working set lives on the host, as in the JAX package: each
iteration's decision quantities (the step's size, the worst multiplier,
the blocking constraint) come back in ONE read, counted in
``QPAInfo.host_reads`` with the one read of the set-up.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY, QP, check_qp, classify_bounds
from ..core.status import Status


@control_dc
class QPAControl:
    """QPA_control_type equivalent (reference src/qpa/qpa.f90)."""

    maxit: int = 500
    feas_tol: float = 1.0e-8
    multiplier_tol: float = 1.0e-8   # wrong-sign threshold for drops
    reg: float = 1.0e-10             # KKT regularization
    infinity: float = INFINITY


@dataclasses.dataclass
class QPAInfo:
    x: Any
    y: Any
    z: Any
    obj: Any
    status: int
    iter: int
    c_stat: Any      # per constraint: -1 lower active, 0 inactive, 1 upper
    b_stat: Any      # per bound: the same convention
    major_iter: int = 0
    host_reads: int = 0


def _kkt_solve(H, A, ac, ab, rhs_x, reg):
    """Solve the working-set KKT system with masked rows

    [ H + reg I   A_W'          I_B'        ] [ dx ]   [ rhs_x ]
    [ A_W         -reg I + Z_c  0           ] [ -y ] = [ 0     ]
    [ I_B         0             -reg I + Z_b] [ -z ]   [ 0     ]

    (``ac``, ``ab``: the working set as 0/1 of H's type; Z: identity on the
    inactive rows, so their multipliers are 0)."""
    n = H.shape[0]
    m = A.shape[0]
    like = dict(dtype=H.dtype, device=H.device)
    Am = A * ac[:, None]
    Ib = torch.diag(ab)
    top = torch.cat([H + reg * torch.eye(n, **like), Am.T, Ib], dim=1)
    mid = torch.cat([Am, -reg * torch.eye(m, **like) + torch.diag(1.0 - ac),
                     torch.zeros((m, n), **like)], dim=1)
    bot = torch.cat([Ib, torch.zeros((n, m), **like),
                     -reg * torch.eye(n, **like) + torch.diag(1.0 - ab)], dim=1)
    K = torch.cat([top, mid, bot], dim=0)
    rhs = torch.cat([rhs_x, torch.zeros(m + n, **like)])
    sol = torch.linalg.solve(K, rhs)
    return sol[:n], -sol[n:n + m] * ac, -sol[n + m:] * ab


def qpa_solve(qp: QP, x0=None, c_stat0=None, b_stat0=None,
              ctl: QPAControl = QPAControl()) -> QPAInfo:
    """Primal active-set solve on the device of ``qp``.  ``x0`` should be
    feasible (without it an LP phase 1 by ``lsqp_solve`` gives one);
    ``c_stat0`` / ``b_stat0`` warm-start the working set."""
    like = dict(dtype=qp.g.dtype, device=qp.g.device)
    n, m = qp.n, qp.m
    bad = check_qp(qp, ctl.infinity)
    if bad != 0:
        zn = torch.zeros(n, **like)
        return QPAInfo(x=zn, y=torch.zeros(m, **like), z=zn,
                       obj=torch.full((), float("nan"), **like), status=bad, iter=0,
                       c_stat=torch.zeros(m, dtype=torch.int32, device=like["device"]),
                       b_stat=torch.zeros(n, dtype=torch.int32, device=like["device"]))
    masks = classify_bounds(qp, ctl.infinity)
    H = qp.H_dense()
    A = qp.A

    if x0 is None:
        from .frontend import lsqp_solve
        from .ipm import IPMControl

        lp = dataclasses.replace(qp, H=None, h_kind="zero", name="")
        x0, _, _, _ = lsqp_solve(lp, IPMControl(dtype=str(qp.g.dtype).split(".")[-1]))
    x = torch.clamp(torch.as_tensor(x0).to(**like), qp.x_l, qp.x_u)

    # the set-up's one read: the masks and the warm start
    on_lo = ((x - qp.x_l).abs() < ctl.feas_tol) & masks.has_xl
    on_hi = ((qp.x_u - x).abs() < ctl.feas_tol) & masks.has_xu
    stat = lambda s, k: (torch.as_tensor(s).to(device=like["device"], dtype=torch.float64)
                         if s is not None else torch.zeros(k, dtype=torch.float64,
                                                           device=like["device"]))
    host = torch.cat([masks.c_equality.double(), masks.x_fixed.double(), on_lo.double(),
                      on_hi.double(), stat(c_stat0, m), stat(b_stat0, n)]).cpu().numpy()
    reads = 1
    eq = host[:m] != 0
    fx = host[m:m + n] != 0
    lo0 = host[m + n:m + 2 * n] != 0
    hi0 = host[m + 2 * n:m + 3 * n] != 0
    act_b = np.zeros(n, bool)
    sig_b = np.zeros(n, np.int8)
    act_c = np.zeros(m, bool)
    sig_c = np.zeros(m, np.int8)
    if c_stat0 is not None:
        sig_c[:] = np.sign(host[m + 3 * n:2 * m + 3 * n]).astype(np.int8)
        act_c[:] = sig_c != 0
    if b_stat0 is not None:
        sig_b[:] = np.sign(host[2 * m + 3 * n:]).astype(np.int8)
        act_b[:] = sig_b != 0
    act_c |= eq
    sig_c[eq] = -1
    act_b |= fx
    sig_b[fx] = -1
    act_b |= lo0 | hi0
    sig_b[lo0] = -1
    sig_b[hi0 & ~lo0] = 1

    dev = like["device"]
    reg = ctl.reg
    inf = torch.full((), float("inf"), **like)
    tiny = 1e-14
    status = int(Status.MAX_ITERATIONS)
    it = 0
    y = torch.zeros(m, **like)
    z = torch.zeros(n, **like)
    for it in range(1, ctl.maxit + 1):
        ac = torch.as_tensor(act_c, device=dev)
        ab = torch.as_tensor(act_b, device=dev)
        sc = torch.as_tensor(sig_c, device=dev)
        sb = torch.as_tensor(sig_b, device=dev)
        g_x = H @ x + qp.g
        dx, y, z = _kkt_solve(H, A, ac.to(like["dtype"]), ab.to(like["dtype"]), -g_x, reg)
        # the multipliers' signs (lower-active wants >= 0)
        vc = y * torch.where(sc < 0, 1.0, -1.0).to(like["dtype"])
        vc = torch.where(ac & ~masks.c_equality, vc, inf)
        vb = z * torch.where(sb < 0, 1.0, -1.0).to(like["dtype"])
        vb = torch.where(ab & ~masks.x_fixed, vb, inf)
        allv = torch.cat([vc, vb])
        k_mult = torch.argmin(allv)
        # the ratio test: the largest step <= 1 keeping feasibility
        Ax = qp.Ax(x)
        Adx = qp.Ax(dx)
        a_cl = torch.where(~ac & (Adx < -tiny) & masks.has_cl, (qp.c_l - Ax) / Adx, inf)
        a_cu = torch.where(~ac & (Adx > tiny) & masks.has_cu, (qp.c_u - Ax) / Adx, inf)
        a_xl = torch.where(~ab & (dx < -tiny) & masks.has_xl, (qp.x_l - x) / dx, inf)
        a_xu = torch.where(~ab & (dx > tiny) & masks.has_xu, (qp.x_u - x) / dx, inf)
        ratios = torch.cat([a_cl, a_cu, a_xl, a_xu])
        k_ratio = torch.argmin(ratios)
        norm_dx, xmax, worst, alpha, km, kr = torch.stack([
            dx.abs().max(), x.abs().max(), allv[k_mult], ratios[k_ratio],
            k_mult.to(like["dtype"]), k_ratio.to(like["dtype"])]).tolist()
        reads += 1
        norm_dx, xmax = max(norm_dx, 0.0), max(xmax, 0.0)
        km, kr = int(km), int(kr)

        if norm_dx <= 1e-8 * (1.0 + xmax):
            # stationary on the working set: drop the worst wrong-signed multiplier
            if worst >= -ctl.multiplier_tol:
                status = int(Status.OK)
                break
            if km < m:
                act_c[km] = False
                sig_c[km] = 0
            else:
                act_b[km - m] = False
                sig_b[km - m] = 0
            continue

        x = x + min(max(alpha, 0.0), 1.0) * dx
        if alpha < 1.0:
            if kr < m:
                act_c[kr], sig_c[kr] = True, -1
            elif kr < 2 * m:
                act_c[kr - m], sig_c[kr - m] = True, 1
            elif kr < 2 * m + n:
                act_b[kr - 2 * m], sig_b[kr - 2 * m] = True, -1
            else:
                act_b[kr - 2 * m - n], sig_b[kr - 2 * m - n] = True, 1

    obj = 0.5 * x @ (H @ x) + qp.g @ x + qp.f
    c_stat = torch.as_tensor(np.where(act_c, sig_c, 0).astype(np.int32), device=dev)
    b_stat = torch.as_tensor(np.where(act_b, sig_b, 0).astype(np.int32), device=dev)
    return QPAInfo(x=x, y=y, z=z, obj=obj, status=status, iter=it,
                   c_stat=c_stat, b_stat=b_stat, host_reads=reads)


def qpc_solve(qp: QP, ipm_ctl=None, qpa_ctl: QPAControl = QPAControl()) -> QPAInfo:
    """QPC composite (reference src/qpc/qpc.f90): the interior-point solve,
    then the active-set solve warm-started from the IPM's active set."""
    from .ipm import IPMControl, ipm_solve

    x, y, z, st = ipm_solve(qp, ipm_ctl or IPMControl())
    masks = classify_bounds(qp, qpa_ctl.infinity)
    tol = 1e-6
    on_lo = ((x - qp.x_l).abs() < tol) & masks.has_xl
    on_hi = ((qp.x_u - x).abs() < tol) & masks.has_xu
    b_stat0 = torch.where(on_lo, -1, torch.where(on_hi, 1, 0))
    if qp.m:
        c = qp.Ax(x)
        on_cl = ((c - qp.c_l).abs() < tol) & masks.has_cl
        on_cu = ((qp.c_u - c).abs() < tol) & masks.has_cu
        c_stat0 = torch.where(on_cl, -1, torch.where(on_cu, 1, 0))
    else:
        c_stat0 = torch.zeros(0, dtype=torch.int64, device=x.device)
    return qpa_solve(qp, x0=x, c_stat0=c_stat0, b_stat0=b_stat0, ctl=qpa_ctl)
