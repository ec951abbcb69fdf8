"""The pieces the NLP solvers share: the state they return, the objective's
derivatives through ``torch.func``, and the outer loop.

The JAX package runs each solve as one ``lax.while_loop`` (vmapped over a
batch of starts).  Here the loop is a Python loop whose decisions stay 0-d
(or batch-shaped) tensors: every update is masked with ``torch.where`` by
the problem's ``active`` flag (not converged and under ``maxit``), so an
iteration after a problem's convergence changes none of its fields and
``iter`` counts what the ``while_loop`` counts.  The host reads the flags
before every pass, so a batch runs as many passes as its slowest problem's
iterations and none after it (max iter + 1 reads per solve, ``maxit`` where
the cap is reached): every pass synchronises anyway (``eigh`` in the exact
subproblems, GLTR's / GLRT's read of ``done`` once per Lanczos step, counted
apart in ``krylov_reads``), so a rarer read would save no sync and only add
masked passes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.func import grad, grad_and_value, hessian, vjp, vmap

from ..core.status import Status
from ..tr.trs import as_tensors


@dataclasses.dataclass
class TRUState:
    """The inform contract of TRU / TRB / ARC / NLS: tensors shaped as the
    batch (``x``, ``g`` with n last), ``radius`` the trust radius or the
    regularization weight; ``host_reads`` the outer loop's reads of its
    flags and ``krylov_reads`` GLTR's / GLRT's reads of ``done`` (one per
    Lanczos step) over the solve."""

    x: Any
    f: Any
    g: Any
    radius: Any
    iter: Any
    converged: Any
    status: Any
    norm_g: Any
    host_reads: int = 0
    krylov_reads: int = 0


FIELDS = ("x", "f", "g", "radius", "iter", "converged", "status", "norm_g")


def status_of(conv):
    """OK where converged, MAX_ITERATIONS elsewhere (int32)."""
    return torch.where(conv, int(Status.OK), int(Status.MAX_ITERATIONS)).to(torch.int32)


def initial_state(x, f, g, radius, ng, stop_g):
    conv = ng <= stop_g
    return TRUState(x=x, f=f, g=g, radius=radius,
                    iter=torch.zeros(f.shape, dtype=torch.int32, device=f.device),
                    converged=conv, status=status_of(conv), norm_g=ng)


def masked(active, new: TRUState, old: TRUState) -> TRUState:
    """``new`` where ``active`` (batch-shaped bool), else ``old``; iter counts
    the active problems only."""
    out = {}
    for f in FIELDS:
        a, b = getattr(new, f), getattr(old, f)
        act = active.reshape(active.shape + (1,) * (a.dim() - active.dim()))
        out[f] = torch.where(act, a, b)
    out["iter"] = old.iter + active.to(torch.int32)
    return TRUState(**out, host_reads=old.host_reads, krylov_reads=new.krylov_reads)


def outer_loop(carry, step: Callable, active_of: Callable, maxit: int):
    """Run ``step(carry, active) -> carry`` (masked by ``active``, the
    batch-shaped flag ``active_of(carry)``) while any problem is active and
    fewer than ``maxit`` passes ran, reading the flags on the host before
    each pass.  Returns (carry, host reads)."""
    reads = 0
    for _ in range(maxit):
        active = active_of(carry)
        reads += 1
        if not bool(active.any()):
            break
        carry = step(carry, active)
    return carry, reads


def run(st: TRUState, step: Callable, maxit: int) -> TRUState:
    """The outer loop of a solver whose carry is its TRUState: ``step``
    (state -> state) runs unmasked, its result is kept where active."""
    st, reads = outer_loop(st, lambda s, active: masked(active, step(s), s),
                           lambda s: ~s.converged & (s.iter < maxit), maxit)
    st.host_reads = reads
    return st


class Objective:
    """A user's objective f: (n,) -> 0-d on a batch of points (B, n) through
    ``torch.func.vmap``: value, value and gradient, gradient, Hessian, and
    the Hessian-vector product at one point (the reference's eval_HPROD)."""

    def __init__(self, f: Callable):
        self._value = vmap(f)
        self._vg = vmap(grad_and_value(f))
        self._grad = vmap(grad(f))
        self._hess = vmap(hessian(f))
        self._g1 = grad(f)

    def value(self, X):
        return self._value(X)

    def value_and_grad(self, X):
        g, v = self._vg(X)
        return v, g

    def grad(self, X):
        return self._grad(X)

    def hessian(self, X):
        return self._hess(X)

    def hvp(self, x):
        """v -> H(x) v at one point x (n,): the vjp of the gradient (H is
        symmetric), its graph built once here and run backward per product.
        The JAX package takes the jvp of the gradient; in ``torch.func``
        forward over reverse re-runs the objective in Python per product (~4 ms
        a product at n = 99,856 on an NVIDIA H100 host, PERF.md §6), the
        backward pass alone well under a millisecond."""
        _, vjp_fn = vjp(self._g1, x)

        def hv(v):
            return vjp_fn(v)[0]

        return hv


def batch_start(x0, device, *others):
    """x0 as a (B, n) tensor (numpy goes to ``resolve_device(device)``, f64 by
    default; a tensor keeps its device), with the batch shape to restore;
    ``others`` (bounds) broadcast to (B, n) on the same device."""
    x0, *rest = as_tensors(x0, *others, device=device)
    if x0.dim() == 0:
        raise ValueError("x0 must have at least one dimension (n,)")
    bshape, n = x0.shape[:-1], x0.shape[-1]
    X = x0.reshape(-1, n)
    rest = [r.expand(bshape + (n,)).reshape(-1, n) for r in rest]
    return X, bshape, rest


def single_problem(bshape, what: str) -> None:
    if len(bshape):
        raise ValueError(f"{what} takes one problem: x0 of shape (n,), not a batch of "
                         f"shape {tuple(bshape)}")


def unbatch(st: TRUState, bshape) -> TRUState:
    """The state's (B, ...) tensors back to the caller's batch shape."""
    out = {}
    for f in FIELDS:
        v = getattr(st, f)
        out[f] = v.reshape(bshape + v.shape[1:])
    return TRUState(**out, host_reads=st.host_reads, krylov_reads=st.krylov_reads)


def stop_threshold(ctl, ng0):
    return torch.clamp(ctl.stop_g_relative * ng0, min=ctl.stop_g_absolute)


def full(like, v):
    """A batch-shaped tensor of ``v`` on ``like``'s device and type."""
    return torch.full(like.shape, float(v), dtype=like.dtype, device=like.device)
