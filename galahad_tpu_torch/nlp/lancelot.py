"""Augmented-Lagrangian solver for generally-constrained NLP (LANCELOT-class).

Counterpart of galahad_tpu/nlp/lancelot.py (GALAHAD's LANCELOT B, reference
src/lancelot/lancelot.f90: LANCELOT_solve :499):

    min f(x)   s.t.  c_l <= c(x) <= c_u,  x_l <= x <= x_u

Outer iteration k minimizes the Rockafellar shifted augmented Lagrangian

    Phi(x; y, mu) = f(x) + 1/(2 mu) ( ||w(x) - s(x)||^2 - mu^2 ||y||^2 ),
    w(x) = c(x) + mu y,   s(x) = clip(w(x), c_l, c_u)

over the box with TRB (nlp/tru.py); then, if the infeasibility is at most
eta_k, the first-order multiplier update y <- (w - s) / mu and tighter
(omega_k, eta_k), else a smaller mu (the dual / penalty fork of
lancelot.f90's main loop).  The outer loop stays on the host, as in the JAX
package: its counts are small and data-dependent, and it reads the
infeasibility (and, where that passes, the inner solve's projected
gradient) once per outer iteration.  ``mu`` is a Python float; ``y`` a
tensor on the problem's device.  The objective and the constraints are the
user's torch functions of one point (``torch.func`` transforms them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.config import control as control_dc
from ..core.problem import INFINITY
from ..core.status import Status
from ..tr.trs import as_tensors
from .tru import TRBControl, trb_solve


@control_dc
class LancelotControl:
    maxit: int = 30                   # outer iterations
    initial_mu: float = 0.1
    mu_decrease: float = 0.1          # tau in the penalty fork
    stop_c: float = 1.0e-6            # final infeasibility tolerance
    stop_g: float = 1.0e-6            # final projected-gradient tolerance
    inner_maxit: int = 200
    inner_model: str = "auto"         # "auto" | "newton" | "hvp": "newton" forms the
    # dense AL Hessian (small n); "hvp" is the matrix-free path (Hessian-vector
    # products and a masked GLTR); "auto" takes "hvp" when n > hvp_threshold
    hvp_threshold: int = 256
    infinity: float = INFINITY


@dataclasses.dataclass
class LancelotInfo:
    """The JAX package's fields (tensors on the problem's device), and the
    work of the solve: ``inner_iter`` the TRB iterations over all outer
    iterations, ``host_reads`` the outer loop's reads plus TRB's and the one
    read of ``inner_iter`` at the end, ``krylov_reads`` GLTR's (one per
    Lanczos step, model "hvp")."""

    x: Any
    y: Any
    f: Any
    infeas: Any
    norm_pg: Any
    mu: Any
    iter: Any
    converged: Any
    status: Any
    inner_iter: int = 0
    host_reads: int = 0
    krylov_reads: int = 0


def clip(v, lo, hi):
    """``jnp.clip``: min(max(v, lo), hi), whose derivative splits at a tie as
    the JAX package's does."""
    return torch.minimum(torch.maximum(v, lo), hi)


def lancelot_solve(objective: Callable, constraints: Callable, x0, c_l, c_u, x_l=None,
                   x_u=None, ctl: LancelotControl = LancelotControl(),
                   device=None) -> LancelotInfo:
    """Minimize ``objective`` subject to c_l <= constraints(x) <= c_u and
    optional bounds, from x0 (n,) (numpy goes to ``resolve_device(device)``,
    a tensor keeps its device)."""
    x, c_l, c_u, x_l, x_u = as_tensors(x0, c_l, c_u, x_l, x_u, device=device)
    dt, dev = x.dtype, x.device
    n = x.shape[-1]
    if x_l is None:
        x_l = torch.full((n,), -2 * ctl.infinity, dtype=dt, device=dev)
    if x_u is None:
        x_u = torch.full((n,), 2 * ctl.infinity, dtype=dt, device=dev)

    m = constraints(x).shape[-1]
    y = torch.zeros(m, dtype=dt, device=dev)
    mu = float(ctl.initial_mu)
    reads = krylov = 0
    inner = torch.zeros((), dtype=torch.int32, device=dev)

    def infeasibility(xv):
        c = constraints(xv)
        return torch.linalg.vector_norm(c - clip(c, c_l, c_u))

    # LANCELOT's classic tolerance schedules (the JAX package's, as written)
    omega = 1.0 / mu ** 0.1 if mu < 1 else 0.1   # inner grad tol
    eta = mu ** 0.1

    status = int(Status.MAX_ITERATIONS)
    it = 0
    st = None
    omega_k = max(omega, ctl.stop_g)
    eta_k = max(eta, ctl.stop_c)
    inner_model = ctl.inner_model
    if inner_model == "auto":
        inner_model = "hvp" if n > ctl.hvp_threshold else "newton"
    for it in range(1, ctl.maxit + 1):
        def phi(xv, y=y, mu=mu):
            w = constraints(xv) + mu * y
            s = clip(w, c_l, c_u)
            return objective(xv) + (torch.sum((w - s) ** 2)
                                    - mu ** 2 * torch.sum(y ** 2)) / (2.0 * mu)

        st = trb_solve(phi, x, x_l, x_u,
                       TRBControl(maxit=ctl.inner_maxit, model=inner_model,
                                  stop_g_absolute=float(omega_k), stop_g_relative=0.0))
        inner = inner + st.iter
        reads += st.host_reads + 1
        krylov += st.krylov_reads
        x = st.x
        w = constraints(x) + mu * y
        s = clip(w, c_l, c_u)
        viol = float(infeasibility(x))

        if viol <= eta_k:
            y = (w - s) / mu                      # first-order update
            if viol <= ctl.stop_c:
                reads += 1
                if float(st.norm_g) <= ctl.stop_g:
                    status = int(Status.OK)
                    break
            eta_k = max(eta_k * mu ** 0.9, ctl.stop_c)
            omega_k = max(omega_k * mu, ctl.stop_g)
        else:
            mu = mu * ctl.mu_decrease
            eta_k = max(mu ** 0.1, ctl.stop_c)
            omega_k = max(mu, ctl.stop_g)

    norm_pg = st.norm_g if st is not None else torch.zeros((), dtype=dt, device=dev)
    return LancelotInfo(
        x=x, y=y, f=objective(x), infeas=infeasibility(x), norm_pg=norm_pg,
        mu=torch.full((), mu, dtype=dt, device=dev),
        iter=torch.full((), it, dtype=torch.int32, device=dev),
        converged=torch.full((), status == int(Status.OK), dtype=torch.bool, device=dev),
        status=torch.full((), status, dtype=torch.int32, device=dev),
        inner_iter=int(inner), host_reads=reads + 1, krylov_reads=krylov)
