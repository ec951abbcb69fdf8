"""Sparse problem containers (COO patterns on the host, values on the device).

Counterpart of galahad_tpu/core/sparse.py.  The sparsity PATTERN is
static host metadata (numpy, hashed by identity so that plans analysed
for it are reused); only the VALUES are tensors.  Matrix actions are
row-wise sums in a fixed order (core/segsum.py): the JAX package's
scatter-adds would become atomics on a CUDA device and lose bitwise
repeatability.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from . import trace
from .problem import INFINITY
from .segsum import SegmentSum


class COOPattern:
    """Static coordinate sparsity pattern (host-side numpy).

    Hash/eq are by identity: reuse ONE pattern object across solves so
    that the analysed KKT plan and the matvec plans are built once
    (the new_problem_structure contract, reference src/qpt/qpt.f90:161).
    """

    __slots__ = ("rows", "cols", "m", "n", "_plans")

    def __init__(self, rows, cols, m: int, n: int):
        self.rows = np.asarray(rows, np.int32)
        self.cols = np.asarray(cols, np.int32)
        self.m = int(m)
        self.n = int(n)
        self._plans = {}

    @property
    def nnz(self) -> int:
        return len(self.rows)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"COOPattern({self.m}x{self.n}, nnz={self.nnz})"

    # --- fixed-order matvec plans (built once per pattern) -------------
    def _plan(self, kind: str):
        p = self._plans.get(kind)
        if p is not None:
            return p
        r = self.rows.astype(np.int64)
        c = self.cols.astype(np.int64)
        if kind == "row":        # out[r] += v * x[c]
            p = (SegmentSum(r, self.m), c, None)
        elif kind == "col":      # out[c] += v * y[r]
            p = (SegmentSum(c, self.n), r, None)
        elif kind == "sym":      # lower triangle acting as the full matrix
            off = np.flatnonzero(r != c)
            dest = np.concatenate([r, c[off]])
            src = np.concatenate([c, r[off]])
            vsel = np.concatenate([np.arange(len(r)), off])
            p = (SegmentSum(dest, self.n), src, vsel)
        elif kind == "diag":
            d = np.flatnonzero(r == c)
            p = (SegmentSum(r[d], self.n), None, d)
        else:
            raise ValueError(kind)
        self._plans[kind] = p
        return p

    def _dev(self, kind: str, device):
        """(SegmentSum, gather index, value selector) with the index
        arrays as tensors on ``device`` (cached per device)."""
        key = (kind, str(device))
        hit = self._plans.get(key)
        if hit is None:
            seg, src, vsel = self._plan(kind)
            t = lambda a: None if a is None else torch.as_tensor(
                np.ascontiguousarray(a, np.int64), device=device)
            hit = (seg, t(src), t(vsel))
            self._plans[key] = hit
        return hit


def lower_triangle(rows, cols, vals):
    """Normalize a symmetric COO triple to the lower triangle
    (row >= col), summing duplicates.  Host-side."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    r = np.maximum(rows, cols)
    c = np.minimum(rows, cols)
    key = r * (c.max() + 1 if len(c) else 1) + c
    order = np.argsort(key, kind="stable")
    r, c, v = r[order], c[order], vals[order]
    if len(r):
        first = np.ones(len(r), bool)
        first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        idx = np.cumsum(first) - 1
        rr, cc = r[first], c[first]
        vv = np.zeros(first.sum(), vals.dtype)
        np.add.at(vv, idx, v)
        return rr, cc, vv
    return r, c, v


@dataclasses.dataclass
class SparseQP:
    """Quadratic program  min 1/2 x'Hx + g'x + f
    s.t. c_l <= A x <= c_u,  x_l <= x <= x_u,
    with sparse H (lower triangle) and A in COO.  All tensors live on one
    device; the IPM reaches the supernodal augmented-system KKT
    factorization through ``build_kkt``."""

    g: torch.Tensor
    c_l: torch.Tensor
    c_u: torch.Tensor
    x_l: torch.Tensor
    x_u: torch.Tensor
    h_vals: Any = None          # (nnz_h,) values of the H lower triangle
    a_vals: Any = None          # (nnz_a,) values of A
    f: Any = 0.0
    x: Any = None
    y: Any = None
    z: Any = None
    h_pat: COOPattern = None    # lower triangle (row >= col), deduplicated
    a_pat: COOPattern = None
    name: str = ""

    h_kind = "sparse"           # static tag (parallels the JAX containers)

    @property
    def n(self) -> int:
        return self.g.shape[-1]

    @property
    def m(self) -> int:
        return self.a_pat.m if self.a_pat is not None else 0

    def dtype(self):
        return self.g.dtype

    # --- matrix actions (mop_Ax role, reference src/mop/mop.f90:40) ---
    def Ax(self, v: torch.Tensor) -> torch.Tensor:
        with trace.span("coo.matvec"):
            seg, src, _ = self.a_pat._dev("row", v.device)
            return seg(self.a_vals * v.index_select(0, src))

    def Aty(self, y: torch.Tensor) -> torch.Tensor:
        with trace.span("coo.matvec"):
            seg, src, _ = self.a_pat._dev("col", y.device)
            return seg(self.a_vals * y.index_select(0, src))

    def Hx(self, v: torch.Tensor) -> torch.Tensor:
        if self.h_pat is None or self.h_pat.nnz == 0:
            return torch.zeros_like(v)
        with trace.span("coo.matvec"):
            seg, src, vsel = self.h_pat._dev("sym", v.device)
            return seg(self.h_vals.index_select(0, vsel)
                       * v.index_select(0, src))

    def H_diag(self) -> torch.Tensor:
        if self.h_pat is None or self.h_pat.nnz == 0:
            return torch.zeros(self.n, dtype=self.g.dtype,
                               device=self.g.device)
        seg, _, vsel = self.h_pat._dev("diag", self.g.device)
        return seg(self.h_vals.index_select(0, vsel))

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.dot(x, self.Hx(x)) + torch.dot(self.g, x) + self.f

    # --- IPM hook: sparse augmented-system KKT --------------------------
    def build_kkt(self, D_x, C_diag, ctl):
        """Factorize K = [[H + D_x + rho I, A'], [A, -C - delta I]] with
        the supernodal LDL^T (analysed once per pattern) and return a
        solver closure with ``ctl.refine`` sweeps of iterative refinement
        against the UNregularized K (the IR role, reference
        src/ir/ir.f90:334), in the working precision."""
        from ..linalg.sbls import sparse_kkt_factorize, sparse_kkt_plan

        plan = sparse_kkt_plan(self.h_pat, self.a_pat, self.n)
        rho = ctl.rho if ctl.rho else 1e-8
        fac = sparse_kkt_factorize(
            plan, self.h_vals, self.a_vals, D_x, C_diag,
            rho=rho, delta=ctl.delta)
        n = self.n

        def Kmul(u):
            u1, u2 = u[:n], u[n:]
            return torch.cat([
                self.Hx(u1) + D_x * u1 + self.Aty(u2),
                self.Ax(u1) - C_diag * u2,
            ])

        def kkt_solve(b1, b2):
            with trace.span("kkt.solve"):
                b = torch.cat([b1, b2])
                u = plan.solve(fac, b)
                for _ in range(ctl.refine):
                    u = u + plan.solve(fac, b - Kmul(u))
                return u[:n], -u[n:]

        return kkt_solve


def make_sparse_qp(n, m, *, h_coo=None, a_coo=None, g, c_l=None, c_u=None,
                   x_l=None, x_u=None, f=0.0, x=None, y=None, z=None,
                   name: str = "", dtype=None, device=None) -> SparseQP:
    """Assemble a SparseQP from raw COO triples (H may be given in
    either/both triangles; it is normalized to lower).  The patterns stay
    on the host; the values go to ``device`` (``None``: the CUDA device,
    an error if there is none; the tests pass ``"cpu"``)."""
    device = resolve_device(device)
    dt = resolve_dtype(dtype)
    npdt = np.float64 if dt == torch.float64 else np.float32

    def dev(a):
        return torch.as_tensor(np.array(a, dtype=npdt, order="C"),
                               device=device)

    g = dev(g)
    if h_coo is not None:
        hr, hc, hv = lower_triangle(*h_coo)
        h_pat = COOPattern(hr, hc, n, n)
        h_vals = dev(hv)
    else:
        h_pat = COOPattern([], [], n, n)
        h_vals = torch.zeros(0, dtype=dt, device=device)
    if a_coo is not None:
        ar, ac, av = a_coo
        a_pat = COOPattern(ar, ac, m, n)
        a_vals = dev(av)
    else:
        a_pat = COOPattern([], [], m, n)
        a_vals = torch.zeros(0, dtype=dt, device=device)

    def vec(v, default, size):
        if v is None:
            return torch.full((size,), default, dtype=dt, device=device)
        return dev(v)

    return SparseQP(
        g=g, f=f,
        c_l=vec(c_l, -INFINITY, m), c_u=vec(c_u, INFINITY, m),
        x_l=vec(x_l, -INFINITY, n), x_u=vec(x_u, INFINITY, n),
        h_vals=h_vals, a_vals=a_vals, h_pat=h_pat, a_pat=a_pat,
        x=None if x is None else dev(x),
        y=None if y is None else dev(y),
        z=None if z is None else dev(z),
        name=name,
    )
