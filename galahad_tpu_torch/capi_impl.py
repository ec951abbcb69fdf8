"""Python side of the port's C interface (interfaces/c/capi.c).

Counterpart of galahad_tpu/capi_impl.py: receives raw pointers (as
integers) from the embedding shim, views them zero-copy with ctypes and
numpy, moves the data to the device, runs the port's solver, writes the
results back into the caller's buffers and returns the inform scalars (the
role of the reference's per-package *_ciface.f90 modules,
src/cqp/C/cqp_ciface.f90:14-80).

The device is the card.  ``GALAHAD_TPU_TORCH_DEVICE=cpu`` in the calling
process's environment asks for the CPU (the JAX package's C tests set
``JAX_PLATFORMS=cpu`` for the same purpose).  Without a card and without
that request an entry raises, which the shim prints and turns into a
nonzero status: nothing carries on on the CPU.

``GALAHAD_TPU_TORCH_COUNTS=1`` prints, after every entry, one line
``galahad_tpu_torch counts {...}`` with the hand kernels' launch counters
(qp/fused.py ``launch_counts``) of the process, for a caller that checks
which kernels its calls went through.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os

import numpy as np
import torch

DEVICE_VARIABLE = "GALAHAD_TPU_TORCH_DEVICE"
COUNTS_VARIABLE = "GALAHAD_TPU_TORCH_COUNTS"


def device() -> torch.device:
    """The entries' device: the CPU where ``GALAHAD_TPU_TORCH_DEVICE`` asks
    for it (any value torch.device takes), else the card, or an error."""
    from ._device import resolve_device

    asked = os.environ.get(DEVICE_VARIABLE)
    if asked:
        return resolve_device(asked)
    if not torch.cuda.is_available():
        raise RuntimeError(f"galahad_tpu_torch's C interface runs on a CUDA device and none "
                           f"is available; set {DEVICE_VARIABLE}=cpu to run on the host")
    return resolve_device(None)


def _reporting(fn):
    """Print the launch counters after the entry where the caller asked."""
    @functools.wraps(fn)
    def entry(*args):
        try:
            return fn(*args)
        finally:
            if os.environ.get(COUNTS_VARIABLE) == "1":
                from .qp.fused import launch_counts

                print("galahad_tpu_torch counts " + json.dumps(launch_counts()), flush=True)
    return entry


def _view(addr: int, shape, writeable: bool = False):
    if addr == 0:
        return None
    n = int(np.prod(shape))
    buf = (ctypes.c_double * n).from_address(addr)
    a = np.ctypeslib.as_array(buf).reshape(shape)
    return a if writeable else a.copy()


def _iview(addr: int, shape):
    if addr == 0:
        return None
    n = int(np.prod(shape))
    buf = (ctypes.c_int32 * n).from_address(addr)
    return np.ctypeslib.as_array(buf).reshape(shape).copy()


def _write(addr: int, t) -> None:
    if addr:
        out = _view(addr, tuple(t.shape), writeable=True)
        out[...] = t.detach().cpu().numpy()


def _dense_qp(n, m, H, g, f, A, c_l, c_u, x_l, x_u):
    """The caller's dense QP on :func:`device` (H NULL: an LP)."""
    from .core.problem import make_qp

    H_v = _view(H, (n, n))
    return make_qp(
        H=H_v, h_kind="zero" if H_v is None else "dense",
        g=_view(g, (n,)), A=_view(A, (m, n)) if m else np.zeros((0, n)),
        c_l=_view(c_l, (m,)) if m else np.zeros(0),
        c_u=_view(c_u, (m,)) if m else np.zeros(0),
        x_l=_view(x_l, (n,)), x_u=_view(x_u, (n,)), f=float(f), device=device())


def _write_solution(qp, x, y, z, x_out, y_out, z_out) -> None:
    _write(x_out, x)
    if qp.m:
        _write(y_out, y)
    _write(z_out, z)


def _residuals(qp, x, y, z):
    from .core.residuals import kkt_residuals

    return tuple(float(r) for r in kkt_residuals(qp, x, y, z))


@_reporting
def qp_solve_raw(solver, n, m, H, g, f, A, c_l, c_u, x_l, x_u, x_out, y_out, z_out):
    """``galahad_tpu_qp_solve``: ``qp_solve`` with the named solver.  Returns
    (status, iter, obj, primal, dual, complementarity)."""
    from .qp.frontend import QPControl, qp_solve

    qp = _dense_qp(n, m, H, g, f, A, c_l, c_u, x_l, x_u)
    x, y, z, info = qp_solve(qp, QPControl(quadratic_programming_solver=solver))
    _write_solution(qp, x, y, z, x_out, y_out, z_out)
    it = getattr(info, "iter", -1)
    return (int(info.status), int(it) if it is not None else -1, float(qp.objective(x)),
            *_residuals(qp, x, y, z))


# ---------------------------------------------------------------------------
# per-package entries (the reference's per-package C interface role:
# src/<pkg>/C/<pkg>_ciface.f90 mirrors each control/inform type; here each
# raw entry takes that package's control fields explicitly)
# ---------------------------------------------------------------------------

ARCS = ("mehrotra", "taylor", "puiseux", "zhao_sun")


def cqp_control(maxit, print_level, series_order, arc, stop_abs_p, stop_abs_d, stop_abs_c):
    """The ``IPMControl`` of a ``galahad_tpu_cqp_control`` struct's fields."""
    from .qp.ipm import IPMControl

    return IPMControl(maxit=int(maxit), series_order=int(series_order),
                      arc=ARCS[int(arc) % len(ARCS)], stop_abs_p=float(stop_abs_p),
                      stop_abs_d=float(stop_abs_d), stop_abs_c=float(stop_abs_c),
                      print_level=int(print_level))


@_reporting
def cqp_solve_raw(n, m, maxit, print_level, series_order, arc,
                  stop_abs_p, stop_abs_d, stop_abs_c,
                  H, g, f, A, c_l, c_u, x_l, x_u, x_out, y_out, z_out):
    """CQP with the full IPM control set (cqp_ciface role)."""
    from .qp.ipm import ipm_solve

    qp = _dense_qp(n, m, H, g, f, A, c_l, c_u, x_l, x_u)
    ctl = cqp_control(maxit, print_level, series_order, arc, stop_abs_p, stop_abs_d, stop_abs_c)
    x, y, z, st = ipm_solve(qp, ctl)
    _write_solution(qp, x, y, z, x_out, y_out, z_out)
    return (int(st.status), int(st.iter), float(qp.objective(x)), *_residuals(qp, x, y, z))


@_reporting
def qpa_solve_raw(n, m, maxit, feas_tol, multiplier_tol,
                  H, g, f, A, c_l, c_u, x_l, x_u, x_out, y_out, z_out):
    """QPA active-set with its control set (qpa_ciface role)."""
    from .qp.qpa import QPAControl, qpa_solve

    qp = _dense_qp(n, m, H, g, f, A, c_l, c_u, x_l, x_u)
    info = qpa_solve(qp, ctl=QPAControl(maxit=int(maxit), feas_tol=float(feas_tol),
                                        multiplier_tol=float(multiplier_tol)))
    _write_solution(qp, info.x, info.y, info.z, x_out, y_out, z_out)
    return (int(info.status), int(info.iter), float(info.obj),
            *_residuals(qp, info.x, info.y, info.z))


def _tr_inform(info, x_out, n):
    _write(x_out, info.x.reshape(n))
    return (0, float(info.multiplier), float(info.obj), float(info.norm_x),
            int(bool(info.hard_case)))


@_reporting
def trs_solve_raw(n, H, g, radius, x_out):
    """TRS exact trust-region subproblem (trs_ciface role).  Returns
    (status, multiplier, obj, norm_x, hard_case)."""
    from .tr.trs import trs_solve

    dev = device()
    info = trs_solve(torch.as_tensor(_view(H, (n, n)), device=dev),
                     torch.as_tensor(_view(g, (n,)), device=dev), float(radius))
    return _tr_inform(info, x_out, n)


@_reporting
def rqs_solve_raw(n, H, g, sigma, power, x_out):
    """RQS regularized quadratic subproblem (rqs_ciface role)."""
    from .tr.trs import rqs_solve

    dev = device()
    info = rqs_solve(torch.as_tensor(_view(H, (n, n)), device=dev),
                     torch.as_tensor(_view(g, (n,)), device=dev), float(sigma), p=float(power))
    return _tr_inform(info, x_out, n)


# SLS handle registry (the reference's C interface keeps per-package
# opaque data pointers; sls_ciface import/analyse/factorize/solve).  The
# handles sit on the inline supernodal LDL^T (linalg/supernodal.py: rows 1a
# and 1b on the card), as the JAX package's on its linalg/supernodal.py.
_SLS_HANDLES = {}
_SLS_NEXT = [1]
SLS_ORDERS = {0: "amd", 1: "rcm", 2: "nd", 3: "best", 4: "natural"}


@_reporting
def sls_analyse_raw(n, nnz, rows, cols, order):
    """Symbolic analysis of a symmetric COO pattern; returns a handle."""
    from .linalg.supernodal import supernodal_analyse

    dev = device()
    r, c = _iview(rows, (nnz,)), _iview(cols, (nnz,))
    sym = supernodal_analyse(r, c, int(n), order=SLS_ORDERS.get(int(order), "amd"))
    h = _SLS_NEXT[0]
    _SLS_NEXT[0] += 1
    _SLS_HANDLES[h] = dict(sym=sym, fac=None, n=int(n), nnz=int(nnz), device=dev)
    return h


@_reporting
def sls_factorize_raw(handle, vals, shift):
    from .linalg.supernodal import supernodal_factorize

    ent = _SLS_HANDLES.get(int(handle))
    if ent is None:
        return -26
    v = torch.as_tensor(_view(vals, (ent["nnz"],)), device=ent["device"])
    ent["fac"] = supernodal_factorize(ent["sym"], v, shift=float(shift))
    return 0


@_reporting
def sls_solve_raw(handle, b, x_out):
    from .linalg.supernodal import supernodal_solve

    ent = _SLS_HANDLES.get(int(handle))
    if ent is None or ent["fac"] is None:
        return -26
    x = supernodal_solve(ent["sym"], ent["fac"],
                         torch.as_tensor(_view(b, (ent["n"],)), device=ent["device"]))
    _write(x_out, x)
    return 0


def sls_inertia_raw(handle, out3):
    ent = _SLS_HANDLES.get(int(handle))
    if ent is None or ent["fac"] is None:
        return -26
    buf = (ctypes.c_int32 * 3).from_address(out3)
    buf[0], buf[1], buf[2] = (int(v) for v in ent["fac"].inertia.tolist())
    return 0


def sls_free_raw(handle):
    _SLS_HANDLES.pop(int(handle), None)
    return 0
