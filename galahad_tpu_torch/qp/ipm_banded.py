"""The banded IPM path (LPB / CQP on banded structure).

Counterpart of galahad_tpu/qp/ipm_banded.py.  A ``BandedQP`` carries a banded
Hessian (symmetric DIA storage) and a banded constraint matrix (a
``BandMatrix``, linalg/band_ops.py); every KKT solve is O(n b^2)
block-tridiagonal work (linalg/banded.py: on the card, the hand-written
factor and solve kernels of csrc/banded.cu), with no O(n^2) memory anywhere.
The one ``ipm_step`` of qp/ipm.py drives it: it calls ``qp.build_kkt``, as it
does for a ``SparseQP``, so the banded step is captured in a CUDA graph and
replayed on the card as the others are (qp/fused.py).

KKT modes per structure (SBLS's decision tree):
  * m = 0, banded H     -> block-tridiagonal Cholesky of G = H + D_x;
  * diagonal or zero H  -> the banded Schur complement S = C + A G^-1 A'
                           (``band_ADAt``), factorized block-tridiagonally;
  * banded H and m > 0  -> preconditioned CG on S, ``cg_maxit`` iterations
                           (a fixed count: no host read, so it captures),
                           with the diagonal-G Schur complement as the
                           preconditioner and banded G solves inside the
                           operator (the reference's SBLS_solve_iterative,
                           sbls.f90:8762).

The PCG count defaults to 128, where the JAX package's is 64.  The
diagonal-G preconditioner misses G^-1's coupling along runs of free
variables, and the runs grow with n: on QPBAND with g of both signs, 64
iterations (times the 1 + refine sweeps) leave directions too inexact for
the IPM from n ~ 3,000 on (200 iterations, no convergence, at n = 20,000),
while 128 converge in the iterations of an exact solve
(tests/test_torch_qpband_pcg.py).  ``convert.banded_qp_from_numpy`` keeps
the JAX package's 64 for the problems it converts.  The CG's guards against a
zero denominator are the dtype's smallest normal number: the JAX package's
1e-300 is 0 in float32.

What differs from the JAX module: its refinement of each KKT solve carries
the iterate as double-word pairs (linalg/dw.py) so that float32 factors reach
~1e-6; the port has no double-word arithmetic (float64 is native on the card)
and refines in the working precision, ``ctl.refine`` times.  The factors'
``ok`` flag is carried, and never read, as in the JAX package.
``ipm_solve_banded`` returns an ``IPMInform`` as the port's ``ipm_solve``
does; the JAX package's returns none.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device, resolve_dtype
from ..core import trace
from ..core.problem import INFINITY
from ..linalg.band_ops import (BandMatrix, band_ADAt, sym_band_add_diag, sym_band_matvec,
                               sym_band_to_blocks)
from ..linalg.banded import block_tridiag_cholesky, block_tridiag_solve
from .ipm import IPMControl, ipm_solve, ipm_solve_compiled

BANDED_H_KINDS = ("banded", "diagonal", "zero")


@dataclasses.dataclass
class BandedQP:
    """QP with banded H (symmetric DIA: h_diags[s, i] = H[i+s, i]) and banded
    A (a ``BandMatrix``, or None when m = 0), tensors on one device."""

    g: torch.Tensor
    A_band: Any                  # BandMatrix or None
    c_l: torch.Tensor
    c_u: torch.Tensor
    x_l: torch.Tensor
    x_u: torch.Tensor
    h_diags: Any = None          # (wh+1, n) or None
    f: Any = 0.0
    x: Any = None
    y: Any = None
    z: Any = None
    name: str = ""
    h_kind: str = "banded"       # "banded" | "diagonal" | "zero"
    block: int = 8               # block-tridiagonal block size
    cg_maxit: int = 128

    @property
    def n(self) -> int:
        return self.g.shape[-1]

    @property
    def m(self) -> int:
        return self.A_band.m if self.A_band is not None else 0

    def dtype(self):
        return self.g.dtype

    def Ax(self, v):
        if self.m == 0:
            return torch.zeros(0, dtype=self.g.dtype, device=self.g.device)
        return self.A_band.matvec(v)

    def Aty(self, y):
        if self.m == 0:
            return torch.zeros_like(self.g)
        return self.A_band.rmatvec(y)

    def Hx(self, v):
        if self.h_kind == "zero":
            return torch.zeros_like(v)
        if self.h_kind == "diagonal":
            return self.h_diags[0] * v
        return sym_band_matvec(self.h_diags, v)

    def H_diag(self):
        if self.h_kind == "zero":
            return torch.zeros_like(self.g)
        return self.h_diags[0]

    def objective(self, x):
        return 0.5 * torch.dot(x, self.Hx(x)) + torch.dot(self.g, x) + self.f

    def scaffold(self) -> "BandedQP":
        """A well-formed banded problem of this one's n and m, on its device
        (what ``ipm_solve`` returns the state of when this one fails its
        input checks)."""
        n, m = max(self.n, 0), max(self.m, 0)
        return make_banded_qp(g=np.zeros(n), a_val=np.zeros((1, m)) if m else None,
                              a_offsets=(0,), dtype=self.g.dtype, device=self.g.device)

    # --- the KKT hook ipm_step dispatches on ----------------------------
    def build_kkt(self, D_x, C_diag, ctl: IPMControl):
        """The KKT solve of one iteration: ``kkt_solve(b1, b2)`` returns
        (x, -v) with [[G, A'], [A, -C]] [x; v] = [b1; b2], G = H + D_x."""
        m = self.m
        if self.h_kind in ("zero", "diagonal"):
            with trace.span("kkt.assemble"):
                Gd = self.H_diag() + D_x
            g_solve = lambda v: v / Gd                            # noqa: E731
            apply_G = lambda v: Gd * v                            # noqa: E731
        else:
            with trace.span("kkt.assemble"):
                G_diags = sym_band_add_diag(self.h_diags, D_x)
                blocks = sym_band_to_blocks(G_diags, max(self.block, self.h_diags.shape[0] - 1))
            with trace.span("kkt.factor"):
                fH = block_tridiag_cholesky(*blocks)
            g_solve = lambda v: _padded_solve(fH, v)              # noqa: E731
            apply_G = lambda v: sym_band_matvec(G_diags, v)       # noqa: E731

        if m == 0:
            def g_only(b1, b2):
                with trace.span("kkt.solve"):
                    return g_solve(b1), b2

            return g_only

        offs = self.A_band.offsets
        bs = max(self.block, max(offs) - min(offs))
        # the Schur complement's blocks: exact, or PCG's preconditioner
        # with the diagonal of G
        with trace.span("kkt.assemble"):
            if self.h_kind in ("zero", "diagonal"):
                Sd = sym_band_add_diag(band_ADAt(self.A_band, 1.0 / Gd), C_diag + ctl.delta)
            else:
                Gd_hat = self.H_diag() + D_x
                Sd = sym_band_add_diag(
                    band_ADAt(self.A_band, 1.0 / torch.clamp(Gd_hat, min=1e-12)),
                    C_diag + ctl.delta)
            blocks = sym_band_to_blocks(Sd, bs)
        with trace.span("kkt.factor"):
            fS = block_tridiag_cholesky(*blocks)
        if self.h_kind in ("zero", "diagonal"):
            # the banded Schur complement, factorized exactly
            s_solve = lambda r: _padded_solve(fS, r)              # noqa: E731
        else:
            # PCG on S = C + A G^-1 A' with the diagonal-G preconditioner
            def prec(r):
                return _padded_solve(fS, r)

            def s_op(v):
                return C_diag * v + self.Ax(g_solve(self.Aty(v))) + ctl.delta * v

            tiny = torch.finfo(D_x.dtype).tiny

            def s_solve(r):
                with trace.span("kkt.pcg"):
                    x = prec(r)
                    rr = r - s_op(x)
                    z = prec(rr)
                    p = z
                    rz = torch.dot(rr, z)
                    for _ in range(self.cg_maxit):
                        Ap = s_op(p)
                        alpha = rz / torch.clamp(torch.dot(p, Ap), min=tiny)
                        x = x + alpha * p
                        rr = rr - alpha * Ap
                        z = prec(rr)
                        rz_new = torch.dot(rr, z)
                        p = z + (rz_new / torch.clamp(rz, min=tiny)) * p
                        rz = rz_new
                    return x

        def block_solve(r1, r2):
            w = g_solve(r1)
            dv = s_solve(self.Ax(w) - r2)
            return g_solve(r1 - self.Aty(dv)), dv

        def kkt_solve(b1, b2):
            # refinement in the working precision (the JAX package carries
            # double-word pairs here, linalg/dw.py)
            with trace.span("kkt.solve"):
                x, v = block_solve(b1, b2)
                for _ in range(ctl.refine):
                    r1 = b1 - (apply_G(x) + self.Aty(v))
                    r2 = b2 - (self.Ax(x) - C_diag * v)
                    dx, dv = block_solve(r1, r2)
                    x = x + dx
                    v = v + dv
                return x, -v

        return kkt_solve


def _padded_solve(f, r):
    """Solve with the block factors ``f`` for the vector ``r``, padded with
    zeros to the blocks' k * b rows."""
    k, b, _ = f.Ld.shape
    out = block_tridiag_solve(f, F.pad(r, (0, k * b - r.shape[-1])).view(k, b))
    return out.reshape(-1)[:r.shape[-1]]


def make_banded_qp(*, g, a_val=None, a_offsets=(), c_l=None, c_u=None, x_l=None, x_u=None,
                   h_diags=None, h_kind=None, block: int = 8, cg_maxit: int = 128, f=0.0,
                   x=None, y=None, z=None, name: str = "", dtype=None,
                   device=None) -> BandedQP:
    """A ``BandedQP`` from arrays (numpy, lists or tensors) on ``device``
    (``None``: the CUDA device, an error if there is none; the tests pass
    ``"cpu"``).  ``a_val`` (ndiag, m) holds the diagonals ``a_offsets`` of A
    (None: no constraints); ``h_diags`` (w+1, n) the subdiagonals of H, whose
    ``h_kind`` defaults to "banded" when it is given and "zero" when not;
    missing bounds are infinite."""
    device = resolve_device(device)
    dt = resolve_dtype(dtype)

    def dev(a):
        if a is None:
            return None
        if torch.is_tensor(a):
            return a.to(device=device, dtype=dt).contiguous()
        return torch.as_tensor(np.array(a, dtype=np.float64, order="C"), device=device).to(dt)

    g = dev(g)
    n = g.shape[-1]
    if h_kind is None:
        h_kind = "zero" if h_diags is None else "banded"
    if h_kind not in BANDED_H_KINDS:
        raise ValueError(f"unknown h_kind {h_kind!r} (a BandedQP's are {BANDED_H_KINDS})")
    if h_kind != "zero" and h_diags is None:
        raise ValueError(f"h_kind {h_kind!r} needs h_diags")
    A_band = None
    if a_val is not None:
        val = dev(a_val)
        A_band = BandMatrix(val=val, offsets=tuple(int(o) for o in a_offsets),
                            m=val.shape[-1], n=n)
    m = A_band.m if A_band is not None else 0

    def vec(v, default, size):
        return torch.full((size,), default, dtype=dt, device=device) if v is None else dev(v)

    return BandedQP(g=g, A_band=A_band, c_l=vec(c_l, -INFINITY, m), c_u=vec(c_u, INFINITY, m),
                    x_l=vec(x_l, -INFINITY, n), x_u=vec(x_u, INFINITY, n),
                    h_diags=None if h_kind == "zero" else dev(h_diags), f=float(f),
                    x=dev(x), y=dev(y), z=dev(z), name=name, h_kind=h_kind,
                    block=int(block), cg_maxit=int(cg_maxit))


def _check_banded(qp, where: str) -> None:
    if not isinstance(qp, BandedQP):
        raise TypeError(f"{where}: takes a BandedQP (got {type(qp).__name__}); "
                        f"ipm_solve takes the other kinds")


def ipm_solve_banded(qp: BandedQP, ctl: IPMControl = IPMControl()):
    """The host loop of ``ipm_solve`` on a ``BandedQP``: on the card
    the iteration is captured once as a CUDA graph and replayed, on the CPU it
    runs directly.  Returns (x, y, z, state) with ``state.inform`` an
    ``IPMInform``."""
    _check_banded(qp, "ipm_solve_banded")
    return ipm_solve(qp, ctl)


def ipm_solve_banded_compiled(qp: BandedQP, ctl: IPMControl = IPMControl()):
    """``ipm_solve_compiled`` on a ``BandedQP``: iterations until the state
    halts or reaches ``ctl.maxit``, with no decision on the host (the JAX
    package's ``lax.while_loop`` solve).  Returns (x, y, z, state)."""
    _check_banded(qp, "ipm_solve_banded_compiled")
    return ipm_solve_compiled(qp, ctl)
