"""The dense QP container, bound classification and input checks.

Counterpart of galahad_tpu/core/problem.py: ``INFINITY``,
``canonical_dtype``, ``QP`` (with its constructor ``make_qp`` and the guard
``require_dense``), ``BoundMasks``, ``classify_bounds``, ``check_qp``, and the
nonlinear program ``NLP`` with its constructor ``unconstrained_nlp``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from .status import Status

# GALAHAD convention: magnitudes >= infinity are "no bound"
# (reference src/cqp/cqp.f90:219, control%infinity default 1e19).
INFINITY = 1.0e19

H_KINDS = ("dense", "diagonal", "zero", "identity", "scaled_identity")


def canonical_dtype(dtype) -> torch.dtype:
    """The tensor type of a requested float type (``None``: float64).  The
    JAX package demotes float64 to float32 when x64 is off; a card with
    native float64 keeps what was asked for."""
    return resolve_dtype(dtype)


@dataclasses.dataclass
class QP:
    """Quadratic program  min 1/2 x'Hx + g'x + f
                          s.t. c_l <= A x <= c_u,  x_l <= x <= x_u,
    with dense tensors on one device (QPT_problem_type, reference
    src/qpt/qpt.f90:128-240).  ``h_kind`` tags the Hessian's structure:
      "dense"           H is (n, n)
      "diagonal"        H is (n,) holding the diagonal
      "zero"            H is None (LP)
      "identity"        H is None, the Hessian is I
      "scaled_identity" H is a 0-d multiple of I
    The IPM factorizes its KKT system by SBLS's Schur complement
    (linalg/sbls.py) or, without constraints, by Cholesky."""

    g: torch.Tensor                     # (n,) objective gradient
    A: torch.Tensor                     # (m, n) constraint Jacobian
    c_l: torch.Tensor                   # (m,) constraint lower bounds
    c_u: torch.Tensor                   # (m,) constraint upper bounds
    x_l: torch.Tensor                   # (n,) variable lower bounds
    x_u: torch.Tensor                   # (n,) variable upper bounds
    H: Any = None                       # see h_kind
    f: Any = 0.0                        # objective constant
    x: Any = None                       # (n,) primal starting point
    y: Any = None                       # (m,) constraint multipliers
    z: Any = None                       # (n,) bound duals
    name: str = ""
    h_kind: str = "dense"

    @property
    def n(self) -> int:
        return self.g.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2] if self.A is not None else 0

    def dtype(self):
        return self.g.dtype

    # --- constraint-matrix actions (QPD_AX, reference src/qpd/qpd.f90) ---
    def Ax(self, v: torch.Tensor) -> torch.Tensor:
        return self.A @ v

    def Aty(self, y: torch.Tensor) -> torch.Tensor:
        return self.A.T @ y

    # --- Hessian action (QPD_HX, reference src/qpd/qpd.f90) ---
    def Hx(self, v: torch.Tensor) -> torch.Tensor:
        k = self.h_kind
        if k == "dense":
            return self.H @ v
        if k in ("diagonal", "scaled_identity"):
            return self.H * v
        if k == "zero":
            return torch.zeros_like(v)
        if k == "identity":
            return v
        raise ValueError(f"unknown h_kind {k!r}")

    def H_dense(self) -> torch.Tensor:
        """H as a dense (n, n) tensor."""
        n, k = self.n, self.h_kind
        like = dict(dtype=self.g.dtype, device=self.g.device)
        if k == "dense":
            return self.H
        if k == "diagonal":
            return torch.diag(self.H)
        if k == "zero":
            return torch.zeros((n, n), **like)
        if k == "identity":
            return torch.eye(n, **like)
        if k == "scaled_identity":
            return self.H * torch.eye(n, **like)
        raise ValueError(f"unknown h_kind {k!r}")

    def H_diag(self) -> torch.Tensor:
        n, k = self.n, self.h_kind
        like = dict(dtype=self.g.dtype, device=self.g.device)
        if k == "dense":
            return torch.diagonal(self.H, dim1=-2, dim2=-1)
        if k == "diagonal":
            return self.H
        if k == "zero":
            return torch.zeros((n,), **like)
        if k == "identity":
            return torch.ones((n,), **like)
        if k == "scaled_identity":
            return self.H * torch.ones((n,), **like)
        raise ValueError(f"unknown h_kind {k!r}")

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.dot(x, self.Hx(x)) + torch.dot(self.g, x) + self.f


def make_qp(*, g, A=None, c_l=None, c_u=None, x_l=None, x_u=None, H=None,
            h_kind: str = "dense", f=0.0, x=None, y=None, z=None, name: str = "",
            dtype=None, device=None) -> QP:
    """A dense ``QP`` from arrays (numpy, lists or tensors) on ``device``
    (``None``: the CUDA device, an error if there is none; the tests pass
    ``"cpu"``).  ``A=None`` means no constraints; missing bounds are
    infinite."""
    if h_kind not in H_KINDS:
        raise ValueError(f"unknown h_kind {h_kind!r}")
    device = resolve_device(device)
    dt = resolve_dtype(dtype)

    def dev(a):
        if a is None:
            return None
        if torch.is_tensor(a):
            return a.to(device=device, dtype=dt).contiguous()
        return torch.as_tensor(np.array(a, dtype=np.float64, order="C"),
                               device=device).to(dt)

    g = dev(g)
    n = g.shape[-1]
    A = dev(A) if A is not None else torch.zeros((0, n), dtype=dt, device=device)
    m = A.shape[-2]

    def vec(v, default, size):
        return torch.full((size,), default, dtype=dt, device=device) if v is None else dev(v)

    return QP(g=g, A=A, c_l=vec(c_l, -INFINITY, m), c_u=vec(c_u, INFINITY, m),
              x_l=vec(x_l, -INFINITY, n), x_u=vec(x_u, INFINITY, n),
              H=None if h_kind in ("zero", "identity") else dev(H),
              f=float(f), x=dev(x), y=dev(y), z=dev(z), name=name, h_kind=h_kind)


def require_dense(qp, where: str) -> None:
    """Refuse anything but a dense ``QP`` (a ``SparseQP`` or ``BandedQP`` has
    no dense H and A) with a ``TypeError`` that says so."""
    if not isinstance(qp, QP):
        raise TypeError(f"{where} takes a dense QP (make_qp / read_qp), "
                        f"not a {type(qp).__name__}")


@dataclasses.dataclass
class BoundMasks:
    """Static-shape bound classification.  All fields are boolean tensors
    on the problem's device; variable masks have shape (n,), constraint
    masks shape (m,).  A *fixed* variable has x_l == x_u; an *equality*
    constraint has c_l == c_u."""

    has_xl: torch.Tensor
    has_xu: torch.Tensor
    x_free: torch.Tensor
    x_fixed: torch.Tensor
    x_range: torch.Tensor
    has_cl: torch.Tensor
    has_cu: torch.Tensor
    c_free: torch.Tensor
    c_equality: torch.Tensor
    c_range: torch.Tensor


def classify_bounds(qp, infinity: float = INFINITY) -> BoundMasks:
    has_xl = qp.x_l > -infinity
    has_xu = qp.x_u < infinity
    x_fixed = has_xl & has_xu & (qp.x_u - qp.x_l <= 0.0)
    has_cl = qp.c_l > -infinity
    has_cu = qp.c_u < infinity
    c_equality = has_cl & has_cu & (qp.c_u - qp.c_l <= 0.0)
    return BoundMasks(
        has_xl=has_xl,
        has_xu=has_xu,
        x_free=~(has_xl | has_xu),
        x_fixed=x_fixed,
        x_range=has_xl & has_xu & ~x_fixed,
        has_cl=has_cl,
        has_cu=has_cu,
        c_free=~(has_cl | has_cu),
        c_equality=c_equality,
        c_range=has_cl & has_cu & ~c_equality,
    )


def check_qp(qp, infinity: float = INFINITY) -> int:
    """Validate a QP, SparseQP or BandedQP (host-side); returns a Status code
    (restrictions -3, inconsistent bounds -4)."""
    if qp.n < 1:
        return int(Status.RESTRICTIONS)
    A = getattr(qp, "A", None)                  # QP
    if A is not None and A.shape[-1] != qp.n:
        return int(Status.RESTRICTIONS)
    a_pat = getattr(qp, "a_pat", None)
    if a_pat is not None and a_pat.n != qp.n:
        return int(Status.RESTRICTIONS)
    h_pat = getattr(qp, "h_pat", None)
    if h_pat is not None and h_pat.n != qp.n:
        return int(Status.RESTRICTIONS)
    A_band = getattr(qp, "A_band", None)        # BandedQP
    if A_band is not None and (A_band.n != qp.n or A_band.val.shape[-1] != A_band.m):
        return int(Status.RESTRICTIONS)
    h_diags = getattr(qp, "h_diags", None)
    if h_diags is not None and h_diags.shape[-1] != qp.n:
        return int(Status.RESTRICTIONS)
    if qp.x_l.shape[-1] != qp.n or qp.x_u.shape[-1] != qp.n:
        return int(Status.RESTRICTIONS)
    if qp.c_l.shape[-1] != qp.m or qp.c_u.shape[-1] != qp.m:
        return int(Status.RESTRICTIONS)
    inf = float("inf")
    xl = torch.where(qp.x_l > -infinity, qp.x_l, -inf)
    xu = torch.where(qp.x_u < infinity, qp.x_u, inf)
    if bool(torch.any(xl > xu)):
        return int(Status.BAD_BOUNDS)
    if qp.m > 0:
        cl = torch.where(qp.c_l > -infinity, qp.c_l, -inf)
        cu = torch.where(qp.c_u < infinity, qp.c_u, inf)
        if bool(torch.any(cl > cu)):
            return int(Status.BAD_BOUNDS)
    return int(Status.OK)


# ---------------------------------------------------------------------------
# Nonlinear programming problem
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NLP:
    """Nonlinear program  min f(x)  s.t.  c_l <= c(x) <= c_u, x_l <= x <= x_u.

    Mirrors NLPT_problem_type (reference src/nlpt/nlpt.f90:84) with tensors
    on one device and the user's callables ``objective(x) -> 0-d tensor`` and
    ``constraints(x) -> (m,)``, written with torch operations so that
    ``torch.func`` (grad, jvp, hessian, vmap) can transform them: they take
    the place of the reference's eval_G / eval_H / eval_HPROD callbacks
    (src/tru/tru.f90:1102-1440)."""

    x: torch.Tensor                      # starting point / solution
    x_l: torch.Tensor
    x_u: torch.Tensor
    c_l: Any = None
    c_u: Any = None
    y: Any = None
    z: Any = None
    name: str = ""
    objective: Any = None                # callable f(x) -> 0-d tensor
    constraints: Any = None              # callable c(x) -> (m,) or None

    @property
    def n(self) -> int:
        return self.x.shape[-1]


def unconstrained_nlp(objective, x0, name: str = "", dtype=None, device=None) -> NLP:
    """An NLP with no constraints and infinite bounds (2 x INFINITY, as in the
    JAX package).  ``x0`` keeps its device if it is a tensor; numpy input
    goes to ``resolve_device(device)``."""
    if torch.is_tensor(x0):
        x0 = x0.to(resolve_dtype(dtype) if dtype is not None else x0.dtype)
    else:
        x0 = torch.as_tensor(np.asarray(x0, np.float64), device=resolve_device(device)).to(
            resolve_dtype(dtype))
    inf = torch.full((x0.shape[-1],), 2 * INFINITY, dtype=x0.dtype, device=x0.device)
    return NLP(x=x0, x_l=-inf, x_u=inf, name=name, objective=objective)
