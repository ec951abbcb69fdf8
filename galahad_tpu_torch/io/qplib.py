"""QPLIB file reader / writer.

Counterpart of galahad_tpu/io/qplib.py (GALAHAD's RPD package, reference
src/rpd/rpd.f90: RPD_read_problem_data :352, RPD_write_qp_problem_data
:1254): the parser (``loads`` / ``load``), the raw ``QPLIBProblem``
record, its conversion to the port's dense ``QP`` (``to_qp`` /
``read_qp``) and ``SparseQP`` (``to_sparse_qp`` / ``read_sparse_qp``), to
the ``QCQP`` of qp/qcqp.py (``to_qcqp`` / ``read_qcqp``) where the file has
quadratic constraints, and the writer (``dumps`` / ``dump`` / ``from_qp`` /
``write_qp``).

Grammar: comments start with '!'; each record is one line (extra trailing
commentary words ignored); sparse sections are "count; count lines of
indices+value"; vectors are "default value; #exceptions; exception lines".
Problem-type code is 3 letters: objective (L linear, Q quadratic,
D diagonal-quadratic, C convex-quadratic), variables (C continuous,
B binary, I integer, M/G mixed), constraints (N none, B box only,
L linear, Q quadratic).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.problem import INFINITY


@dataclasses.dataclass
class QPLIBProblem:
    """Raw parsed QPLIB data (host-side numpy).

    H and A are stored in COORDINATE form exactly as the file gives them
    (H: lower triangle); nothing is densified at parse time, so files
    with n >> 1e4 stay O(nnz).
    """

    name: str
    ptype: str
    minimize: bool
    n: int
    m: int
    H_coo: tuple             # (rows, cols, vals) lower triangle of H
    g: np.ndarray
    f: float
    A_coo: tuple             # (rows, cols, vals)
    c_l: np.ndarray
    c_u: np.ndarray
    x_l: np.ndarray
    x_u: np.ndarray
    x0: np.ndarray
    y0: np.ndarray
    z0: np.ndarray
    infinity: float
    var_types: np.ndarray    # 0 continuous, 1 integer, 2 binary
    H_c: list                # [(con, row, col, val)] quadratic constraint terms
    x_names: dict
    c_names: dict

    @property
    def H(self) -> np.ndarray:
        """Dense symmetric (n, n) view of the objective Hessian."""
        H = np.zeros((self.n, self.n))
        r, c, v = self.H_coo
        np.add.at(H, (r, c), v)
        off = r != c
        np.add.at(H, (c[off], r[off]), v[off])
        return H

    @property
    def A(self) -> np.ndarray:
        A = np.zeros((self.m, self.n))
        r, c, v = self.A_coo
        np.add.at(A, (r, c), v)
        return A

    def _clip_inf(self, v):
        v = np.asarray(v, dtype=np.float64).copy()
        v[v >= self.infinity] = INFINITY
        v[v <= -self.infinity] = -INFINITY
        return v

    def to_qp(self, dtype=None, device=None):
        """Convert to a dense ``QP`` on ``device`` (``None``: the CUDA
        device); values beyond the file's infinity become ``INFINITY``, and
        a Maximize problem is negated into a minimization."""
        from ..core.problem import make_qp

        if self.H_c:
            raise ValueError(
                "problem has quadratic constraints; use to_qcqp()")
        sgn = 1.0 if self.minimize else -1.0
        quad = self.ptype[0].upper() in ("Q", "D", "C")
        return make_qp(
            H=sgn * self.H if quad else None, h_kind="dense" if quad else "zero",
            g=sgn * self.g, f=sgn * float(self.f), A=self.A,
            c_l=self._clip_inf(self.c_l), c_u=self._clip_inf(self.c_u),
            x_l=self._clip_inf(self.x_l), x_u=self._clip_inf(self.x_u),
            x=self.x0, y=self.y0, z=self.z0, name=self.name,
            dtype=dtype, device=device)

    def to_qcqp(self, dtype=None, device=None):
        """Convert to a solver-ready ``QCQP`` on ``device`` (``None``: the
        CUDA device), the quadratic constraints kept (the RPD QCQP classes,
        reference src/rpd/rpd.f90:20-45): the constraint Hessians' H_c
        triples (con, i, j, val; lower triangle) assemble into the stacked
        symmetric (m, n, n) ``Qc``, an off-diagonal term mirrored."""
        from .._device import resolve_device
        from ..core.problem import canonical_dtype
        from ..qp.qcqp import QCQP

        dt = canonical_dtype(dtype)
        device = resolve_device(device)
        sgn = 1.0 if self.minimize else -1.0
        quad = self.ptype[0].upper() in ("Q", "D", "C")
        Qc = np.zeros((self.m, self.n, self.n))
        if self.H_c:
            con, i, j, v = (np.array(a) for a in zip(*self.H_c))
            lo, hi = np.maximum(i, j), np.minimum(i, j)
            np.add.at(Qc, (con, lo, hi), v)
            off = i != j
            np.add.at(Qc, (con[off], hi[off], lo[off]), v[off])

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dt)

        return QCQP(
            H=dev(sgn * self.H) if quad else None, g=dev(sgn * self.g), f=sgn * float(self.f),
            A=dev(self.A), Qc=dev(Qc), c_l=dev(self._clip_inf(self.c_l)),
            c_u=dev(self._clip_inf(self.c_u)), x_l=dev(self._clip_inf(self.x_l)),
            x_u=dev(self._clip_inf(self.x_u)), x=dev(self.x0), y=dev(self.y0), z=dev(self.z0),
            name=self.name, h_kind="dense" if quad else "zero")

    def to_sparse_qp(self, dtype=None, device=None):
        """Convert to a SparseQP (COO end-to-end, no densification) on
        ``device`` (``None``: the CUDA device)."""
        from ..core.sparse import make_sparse_qp

        if self.H_c:
            raise ValueError(
                "problem has quadratic constraints; use to_qcqp()")

        sgn = 1.0 if self.minimize else -1.0
        quad = self.ptype[0].upper() in ("Q", "D", "C")
        hr, hc, hv = self.H_coo
        return make_sparse_qp(
            self.n, self.m,
            h_coo=(hr, hc, sgn * hv) if quad and len(hr) else None,
            a_coo=self.A_coo,
            g=sgn * self.g, f=sgn * float(self.f),
            c_l=self._clip_inf(self.c_l), c_u=self._clip_inf(self.c_u),
            x_l=self._clip_inf(self.x_l), x_u=self._clip_inf(self.x_u),
            x=self.x0, y=self.y0, z=self.z0,
            name=self.name, dtype=dtype, device=device,
        )


class _Records:
    """Token stream over significant lines of a QPLIB file."""

    def __init__(self, text: str):
        self.lines = [
            ln.strip()
            for ln in text.splitlines()
            if ln.strip() and not ln.strip().startswith(("!", "%", "#"))
        ]
        self.pos = 0

    def next(self) -> list[str]:
        if self.pos >= len(self.lines):
            raise ValueError("unexpected end of QPLIB file")
        toks = self.lines[self.pos].split()
        self.pos += 1
        return toks

    def next_int(self) -> int:
        return int(float(self.next()[0].replace("D", "E").replace("d", "e")))

    def next_float(self) -> float:
        return float(self.next()[0].replace("D", "E").replace("d", "e"))

    def next_str(self) -> str:
        return self.next()[0]


def _read_vector(rec: _Records, size: int, integer: bool = False) -> np.ndarray:
    default = rec.next_float()
    v = np.full(size, default)
    k = rec.next_int()
    for _ in range(k):
        toks = rec.next()
        i = int(toks[0]) - 1
        v[i] = float(toks[1].replace("D", "E").replace("d", "e"))
    return v.astype(np.int64) if integer else v


def _read_names(rec: _Records) -> dict:
    k = rec.next_int()
    out = {}
    for _ in range(k):
        toks = rec.next()
        out[int(toks[0]) - 1] = toks[1]
    return out


def loads(text: str) -> QPLIBProblem:
    rec = _Records(text)
    name = rec.next_str()
    ptype = rec.next_str().upper()
    if len(ptype) != 3:
        raise ValueError(f"bad QPLIB problem-type code {ptype!r}")
    obj_t, var_t, con_t = ptype
    minimize = rec.next_str().lower().startswith("min")
    n = rec.next_int()
    has_constraints = con_t in ("L", "Q")
    m = rec.next_int() if has_constraints else 0

    # objective Hessian (lower triangle coordinate)
    h_r, h_c, h_v = [], [], []
    if obj_t in ("Q", "D", "C"):
        nnz = rec.next_int()
        for _ in range(nnz):
            toks = rec.next()
            i, j = int(toks[0]) - 1, int(toks[1]) - 1
            h_r.append(max(i, j))
            h_c.append(min(i, j))
            h_v.append(float(toks[2].replace("D", "E").replace("d", "e")))

    g = _read_vector(rec, n)
    f = rec.next_float()

    # quadratic constraint Hessians
    H_c = []
    if con_t == "Q":
        nnz = rec.next_int()
        for _ in range(nnz):
            toks = rec.next()
            H_c.append(
                (int(toks[0]) - 1, int(toks[1]) - 1, int(toks[2]) - 1,
                 float(toks[3].replace("D", "E").replace("d", "e")))
            )

    # constraint Jacobian
    a_r, a_c, a_v = [], [], []
    if has_constraints:
        nnz = rec.next_int()
        for _ in range(nnz):
            toks = rec.next()
            a_r.append(int(toks[0]) - 1)
            a_c.append(int(toks[1]) - 1)
            a_v.append(float(toks[2].replace("D", "E").replace("d", "e")))

    infinity = rec.next_float()

    if has_constraints:
        c_l = _read_vector(rec, m)
        c_u = _read_vector(rec, m)
    else:
        c_l = np.zeros(0)
        c_u = np.zeros(0)

    if con_t == "N":            # no bounds section for unconstrained type
        x_l = np.full(n, -infinity)
        x_u = np.full(n, infinity)
    else:
        x_l = _read_vector(rec, n)
        x_u = _read_vector(rec, n)

    var_types = np.zeros(n, dtype=np.int64)
    if var_t not in ("C",):
        if var_t in ("B", "I"):
            var_types[:] = 2 if var_t == "B" else 1
        else:  # mixed: explicit section
            var_types = _read_vector(rec, n, integer=True)

    x0 = _read_vector(rec, n)
    y0 = _read_vector(rec, m) if has_constraints else np.zeros(0)
    z0 = _read_vector(rec, n)

    x_names = _read_names(rec) if rec.pos < len(rec.lines) else {}
    c_names = _read_names(rec) if has_constraints and rec.pos < len(rec.lines) else {}

    def coo(r, c, v):
        return (np.asarray(r, np.int64), np.asarray(c, np.int64),
                np.asarray(v, np.float64))

    return QPLIBProblem(
        name=name, ptype=ptype, minimize=minimize, n=n, m=m,
        H_coo=coo(h_r, h_c, h_v), g=g, f=f, A_coo=coo(a_r, a_c, a_v),
        c_l=c_l, c_u=c_u, x_l=x_l, x_u=x_u, x0=x0, y0=y0, z0=z0,
        infinity=infinity, var_types=var_types, H_c=H_c,
        x_names=x_names, c_names=c_names,
    )


def load(path: str) -> QPLIBProblem:
    with open(path) as fh:
        return loads(fh.read())


def read_qp(path: str, dtype=None, device=None):
    """Read a QPLIB file straight into a dense ``QP`` on ``device``
    (``None``: the CUDA device; ``"cpu"`` for the host)."""
    return load(path).to_qp(dtype, device)


def read_sparse_qp(path: str, dtype=None, device=None):
    """Read a QPLIB file straight into a SparseQP (never densifies)."""
    return load(path).to_sparse_qp(dtype, device)


def read_qcqp(path: str, dtype=None, device=None):
    """Read a QPLIB file with quadratic constraints into a ``QCQP``."""
    return load(path).to_qcqp(dtype, device)


# ---------------------------------------------------------------------------
# Writer (RPD_write_qp_problem_data equivalent) for fixture round-tripping
# ---------------------------------------------------------------------------


def dumps(p: QPLIBProblem) -> str:
    out: list[str] = [p.name, p.ptype, "Minimize" if p.minimize else "Maximize", str(p.n)]
    obj_t, var_t, con_t = p.ptype
    has_constraints = con_t in ("L", "Q")
    if has_constraints:
        out.append(str(p.m))

    if obj_t in ("Q", "D", "C"):
        hr, hc, hv = p.H_coo
        nz = [k for k in range(len(hr)) if hv[k] != 0.0]
        out.append(str(len(nz)))
        out += [f"{hr[k] + 1} {hc[k] + 1} {float(hv[k])!r}" for k in nz]

    def vec(v):
        vals, counts = np.unique(np.asarray(v), return_counts=True)
        default = float(vals[np.argmax(counts)]) if len(vals) else 0.0
        exc = [i for i in range(len(v)) if v[i] != default]
        out.append(repr(default))
        out.append(str(len(exc)))
        out.extend(f"{i + 1} {float(v[i])!r}" for i in exc)

    vec(p.g)
    out.append(repr(float(p.f)))
    if con_t == "Q":
        out.append(str(len(p.H_c)))
        out += [f"{c + 1} {i + 1} {j + 1} {float(v)!r}" for c, i, j, v in p.H_c]
    if has_constraints:
        ar, ac, av = p.A_coo
        nz = [k for k in range(len(ar)) if av[k] != 0.0]
        out.append(str(len(nz)))
        out += [f"{ar[k] + 1} {ac[k] + 1} {float(av[k])!r}" for k in nz]
    out.append(repr(p.infinity))
    if has_constraints:
        vec(p.c_l)
        vec(p.c_u)
    if con_t != "N":
        vec(p.x_l)
        vec(p.x_u)
    if var_t not in ("C", "B", "I"):
        vec(p.var_types)
    vec(p.x0)
    if has_constraints:
        vec(p.y0)
    vec(p.z0)
    for names in ([p.x_names, p.c_names] if has_constraints else [p.x_names]):
        out.append(str(len(names)))
        out += [f"{i + 1} {nm}" for i, nm in sorted(names.items())]
    return "\n".join(out) + "\n"


def dump(p: QPLIBProblem, path: str) -> None:
    with open(path, "w") as fh:
        fh.write(dumps(p))


def _host(v) -> np.ndarray:
    """A tensor or array as float64 numpy on the host."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def from_qp(qp, name: str = "", infinity: float = 1e20) -> QPLIBProblem:
    """A QPLIBProblem from a ``QP`` or ``SparseQP`` (the
    RPD_write_qp_problem_data direction, reference src/rpd/rpd.f90:1254):
    dump a problem for replay, fixtures or bug reports.  A SparseQP stays
    O(nnz) end to end."""
    n, m = qp.n, qp.m
    if hasattr(qp, "h_pat"):          # SparseQP
        hp = qp.h_pat
        H_coo = (np.asarray(hp.rows, np.int64), np.asarray(hp.cols, np.int64),
                 _host(qp.h_vals))
        ap = qp.a_pat
        A_coo = (np.asarray(ap.rows, np.int64), np.asarray(ap.cols, np.int64),
                 _host(qp.a_vals))
        has_h = len(H_coo[0]) > 0
    else:
        H = np.zeros((n, n)) if getattr(qp, "H", None) is None else _host(qp.H)
        if getattr(qp, "h_kind", "dense") in ("diagonal", "identity", "scaled_identity"):
            H = np.diag(_host(qp.H_diag()))
        hr, hc = np.nonzero(np.tril(H))
        H_coo = (hr, hc, H[hr, hc])
        A = np.zeros((m, n)) if getattr(qp, "A", None) is None else _host(qp.A)
        ar, ac = np.nonzero(A)
        A_coo = (ar, ac, A[ar, ac])
        has_h = len(H_coo[0]) > 0 and np.any(H_coo[2] != 0.0)
    ptype = ("QCL" if has_h else "LCL") if m > 0 else ("QCB" if has_h else "LCB")

    def clip(v, size, default):
        if v is None:
            return np.full(size, default)
        v = _host(v).copy()
        v[v >= INFINITY] = infinity
        v[v <= -INFINITY] = -infinity
        return v

    return QPLIBProblem(
        name=name or getattr(qp, "name", "") or "GALAHAD_TPU",
        ptype=ptype, minimize=True, n=n, m=m,
        H_coo=H_coo, g=_host(qp.g), f=float(qp.f), A_coo=A_coo,
        c_l=clip(qp.c_l, m, -infinity), c_u=clip(qp.c_u, m, infinity),
        x_l=clip(qp.x_l, n, -infinity), x_u=clip(qp.x_u, n, infinity),
        x0=np.zeros(n) if qp.x is None else _host(qp.x),
        y0=np.zeros(m) if qp.y is None else _host(qp.y),
        z0=np.zeros(n) if qp.z is None else _host(qp.z),
        infinity=infinity, var_types=np.zeros(n, np.int64), H_c=[],
        x_names={}, c_names={},
    )


def write_qp(path: str, qp, name: str = "") -> None:
    """Write a ``QP`` / ``SparseQP`` to a QPLIB file (the
    generate_qplib_file role of the reference QP solvers,
    src/cqp/cqp.f90:376-395)."""
    dump(from_qp(qp, name=name), path)
