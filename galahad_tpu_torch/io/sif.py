"""SIF (Standard Input Format) decoder -> an NLP of torch functions.

Counterpart of galahad_tpu/io/sif.py (the reference's SIF/CUTEst bridge,
src/cqp/usecqp.f90:284-416; the decoder itself is SifDec/CUTEst).  Only the
element / group FUNCTION expressions (F lines) are read: ``torch.func``
derivatives replace the hand-coded G / H lines and the cutest_functions
evaluation adapter (src/cutest_functions/cutest_functions.f90:23-31).

The parser is host Python and follows the JAX package line by line; the
supported subset is the same:
  * IE/RE/IA/RA/RM/R= parameter assignments, nested DO/OD/ND loops with
    (I,J) index substitution,
  * VARIABLES, GROUPS (N/L/G/E rows with linear coefficients and
    'SCALE'), CONSTANTS, RANGES, BOUNDS (FR/LO/UP/FX/XL/XU/'DEFAULT'),
    START POINT,
  * ELEMENT TYPE (EV elemental / IV internal vars / EP parameters),
    ELEMENT USES (T/V/P and X/Z variants), GROUP TYPE (GV/GP),
    GROUP USES (T/E with weights, X/Z variants),
  * the ELEMENTS / GROUPS function blocks: TEMPORARIES (A assignments,
    M intrinsic declarations), R internal-variable ranges, and F value
    expressions in the Fortran subset (+ - * / **, D-exponents,
    SIN/COS/TAN/EXP/LOG/SQRT/ABS/ATAN/SINH/COSH/TANH/ASIN/ACOS/MAX/MIN).

Group semantics (LANCELOT): objective = sum_g  gtype_g(alpha_g) / s_g
with alpha_g = sum_i c_i x_i + sum_e w_e ElemF_e(x) - b_g; constraint
groups compare the same alpha against the CONSTANTS/RANGES data.

Evaluation goes group by group and op by op, as in the JAX package.  The
intrinsics take Python floats as well as tensors: a temporary computed from
parameters alone reaches SIN, EXP and the rest as a float, which
``torch.sin`` refuses, so a float argument becomes a 0-d tensor of the
point's type and device first.  MAX / MIN take two arguments.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..core.problem import INFINITY, NLP

_TORCH_INTRINSICS = {
    "SIN": torch.sin, "COS": torch.cos, "TAN": torch.tan, "EXP": torch.exp,
    "LOG": torch.log, "LOG10": torch.log10, "SQRT": torch.sqrt,
    "ABS": torch.abs, "ATAN": torch.atan, "ASIN": torch.asin,
    "ACOS": torch.acos, "SINH": torch.sinh, "COSH": torch.cosh,
    "TANH": torch.tanh, "MAX": torch.maximum, "MIN": torch.minimum,
    "SIGN": lambda a, b: torch.abs(a) * torch.sign(b),
}


def _intrinsics(like: torch.Tensor) -> dict:
    """The intrinsics for points like ``like``: each wraps its Python-float
    arguments as 0-d tensors of ``like``'s type and device."""
    def wrap(fn):
        def call(*args):
            return fn(*(a if torch.is_tensor(a) else
                        torch.full((), float(a), dtype=like.dtype, device=like.device)
                        for a in args))
        return call

    return {name: wrap(fn) for name, fn in _TORCH_INTRINSICS.items()}


def _expr(s: str):
    """Translate a Fortran arithmetic expression to a Python one."""
    s = s.strip()
    # D/E exponents: 1.0D+10 -> 1.0e+10 (keep names like D1 intact)
    s = re.sub(r"(\d(?:\.\d*)?)[Dd]([+-]?\d+)", r"\1e\2", s)
    return s


def _feval(expr: str, ns: dict, intrinsics: dict):
    env = dict(intrinsics)
    env.update(ns)
    return eval(_expr(expr), {"__builtins__": {}}, env)  # noqa: S307


def _num(tok: str) -> float:
    return float(tok.replace("D", "e").replace("d", "e"))


@dataclasses.dataclass
class _Group:
    kind: str = "N"              # N objective, L <=, G >=, E ==
    linear: dict = dataclasses.field(default_factory=dict)
    const: float = 0.0
    scale: float = 1.0
    gtype: str = None
    gparams: dict = dataclasses.field(default_factory=dict)
    elements: list = dataclasses.field(default_factory=list)  # (name, w)
    rng: float = None


@dataclasses.dataclass
class SIFProblem:
    name: str
    var_names: list
    x0: np.ndarray
    x_l: np.ndarray
    x_u: np.ndarray
    objective: Any               # callable(x) -> 0-d tensor (torch)
    constraints: Any             # callable(x) -> (m,) or None
    c_l: np.ndarray = None
    c_u: np.ndarray = None
    y0: np.ndarray = None

    @property
    def n(self):
        return len(self.var_names)

    @property
    def m(self):
        return 0 if self.c_l is None else len(self.c_l)

    def to_nlp(self, dtype=None, device=None) -> NLP:
        """The port's ``NLP`` on ``device`` (``None``: the CUDA device)."""
        device = resolve_device(device)
        dt = resolve_dtype(dtype)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dt)

        return NLP(
            x=dev(self.x0), x_l=dev(self.x_l), x_u=dev(self.x_u),
            c_l=None if self.m == 0 else dev(self.c_l),
            c_u=None if self.m == 0 else dev(self.c_u),
            name=self.name, objective=self.objective,
            constraints=self.constraints if self.m else None,
        )


def _sub_indices(tok: str, env: dict) -> str:
    """Expand indexed names: X(I) -> X3, P(I,J) -> P1,2 (SIF decode
    convention: indices joined by commas after the stem)."""
    m = re.match(r"^([A-Za-z0-9]+)\(([^)]*)\)$", tok)
    if not m:
        return tok
    stem, args = m.groups()
    vals = []
    for a in args.split(","):
        a = a.strip()
        vals.append(str(int(env[a])) if a in env else a)
    return stem + ",".join(vals)


def _expand_loops(lines: list, params: dict) -> list:
    """Expand DO ... ND/OD loops (recursively), substituting indices and
    evaluating X*/Z* line variants is left to the section parser."""
    out = []
    i = 0
    while i < len(lines):
        ln = lines[i]
        toks = ln.split()
        if toks and toks[0] == "DO":
            var = toks[1]
            lo = int(params.get(toks[2], toks[2]))
            hi = int(params.get(toks[3], toks[3]))
            depth = 1
            j = i + 1
            body = []
            while j < len(lines):
                t2 = lines[j].split()
                if t2 and t2[0] == "DO":
                    depth += 1
                    body.append(lines[j])
                elif t2 and t2[0] == "OD":
                    depth -= 1
                    if depth == 0:
                        break
                    body.append(lines[j])
                elif t2 and t2[0] == "ND":
                    # SIF: ND terminates ALL open loops; synthesize the
                    # inner closers so the recursion sees balanced loops
                    body.extend([" OD"] * (depth - 1))
                    depth = 0
                    break
                else:
                    body.append(lines[j])
                j += 1
            for v in range(lo, hi + 1):
                pat = re.compile(
                    rf"(?<![A-Za-z0-9]){re.escape(var)}(?![A-Za-z0-9])")
                sub = [pat.sub(str(v), b)
                       if "(" in b and re.search(
                           rf"[(,]\s*{re.escape(var)}\s*[,)]", b)
                       else b for b in body]
                out.extend(_expand_loops(sub, params))
            i = j + 1
        else:
            out.append(ln)
            i += 1
    return out


def loads(text: str) -> SIFProblem:  # noqa: C901 — a decoder is a decoder
    raw = text.splitlines()
    # split off the nonlinear function blocks at their ENDATA markers
    sections = re.split(r"^ENDATA\s*$", "\n".join(raw), flags=re.M)
    data_lines = [ln for ln in sections[0].splitlines()
                  if ln.strip() and not ln.lstrip().startswith("*")]
    fn_blocks = "\n".join(sections[1:])

    params: dict = {}
    name = "SIF"

    # ---- first pass: gather scalar parameters (IE/RE/...) -----------
    body = []
    for ln in data_lines:
        toks = ln.split()
        code = toks[0]
        if code == "NAME":
            name = toks[1] if len(toks) > 1 else name
            continue
        if code in ("IE", "RE") and len(toks) >= 3:
            params[toks[1]] = _num(toks[2])
            continue
        if code in ("IA", "RA") and len(toks) >= 4:
            params[toks[1]] = params[toks[2]] + _num(toks[3])
            continue
        if code in ("IM", "RM") and len(toks) >= 4:
            params[toks[1]] = params[toks[2]] * _num(toks[3])
            continue
        if code in ("I=", "R=") and len(toks) >= 3:
            params[toks[1]] = params[toks[2]]
            continue
        body.append(ln)

    body = _expand_loops(body, params)

    # ---- section walk ------------------------------------------------
    var_names: list = []
    var_idx: dict = {}
    groups: dict = {}
    gorder: list = []
    bounds_default = [0.0, INFINITY]
    blo: dict = {}
    bup: dict = {}
    start: dict = {}
    start_default = 0.0
    etypes: dict = {}    # type -> dict(ev=[], iv=[], ep=[], ranges={})
    euses: dict = {}     # elem -> dict(t=..., v={}, p={})
    gtypes: dict = {}    # type -> dict(gv=..., gp=[])
    default_etype = None
    default_gtype = None

    def group(gname):
        if gname not in groups:
            groups[gname] = _Group()
            gorder.append(gname)
        return groups[gname]

    section = None
    for ln in body:
        toks = ln.split()
        if not toks:
            continue
        if ln[0] not in " \t" and len(toks) <= 2 and toks[0].isupper():
            section = " ".join(toks)
            continue
        code = toks[0]
        t = [_sub_indices(tk, {}) for tk in toks[1:]]

        if section == "VARIABLES":
            vn = toks[0] if ln[0] not in " \t" else t[-1] if code == "X" \
                else toks[0]
            if code == "X":
                vn = t[0]
            else:
                vn = toks[0]
            if vn not in var_idx:
                var_idx[vn] = len(var_names)
                var_names.append(vn)
        elif section == "GROUPS":
            # [X]N/L/G/E  name  [var coef [var coef]] | 'SCALE' value
            kind = code[-1] if code in ("N", "L", "G", "E", "XN", "XL",
                                        "XG", "XE", "ZN", "ZL", "ZG",
                                        "ZE") else None
            if kind is None:
                continue
            g = group(t[0])
            g.kind = kind
            rest = t[1:]
            if rest and rest[0] == "'SCALE'":
                g.scale = _num(rest[1])
            else:
                k = 0
                while k + 1 < len(rest):
                    if code.startswith("Z"):
                        g.linear[rest[k]] = g.linear.get(rest[k], 0.0) \
                            + params[rest[k + 1]]
                    else:
                        g.linear[rest[k]] = g.linear.get(rest[k], 0.0) \
                            + _num(rest[k + 1])
                    k += 2
        elif section == "CONSTANTS":
            # [X/Z] setname  group value [group value]
            rest = t[1:] if code in ("X", "Z") else t
            k = 0
            while k + 1 < len(rest):
                group(rest[k]).const = _num(rest[k + 1])
                k += 2
        elif section == "RANGES":
            rest = t
            k = 0
            while k + 1 < len(rest):
                group(rest[k]).rng = _num(rest[k + 1])
                k += 2
        elif section == "BOUNDS":
            bcode = code.lstrip("XZ") if code not in ("FR", "MI", "PL",
                                                      "LO", "UP", "FX") \
                else code
            if code in ("XL",):
                bcode = "LO"
            if code in ("XU",):
                bcode = "UP"
            tgt = t[1] if len(t) > 1 else None
            val = _num(t[2]) if len(t) > 2 else None
            if tgt == "'DEFAULT'":
                if bcode == "LO":
                    bounds_default[0] = val
                elif bcode == "UP":
                    bounds_default[1] = val
                elif bcode == "FR":
                    bounds_default[0] = -INFINITY
                    bounds_default[1] = INFINITY
                continue
            if bcode == "FR":
                blo[tgt] = -INFINITY
                bup[tgt] = INFINITY
            elif bcode == "MI":
                blo[tgt] = -INFINITY
            elif bcode == "PL":
                bup[tgt] = INFINITY
            elif bcode == "LO":
                blo[tgt] = val
            elif bcode == "UP":
                bup[tgt] = val
            elif bcode == "FX":
                blo[tgt] = val
                bup[tgt] = val
        elif section == "START POINT":
            # [X]V setname var value  (or  setname var value)
            if code in ("V", "XV", "ZV"):
                tgt, val = t[1], t[2]
            else:
                tgt, val = t[0], t[1]
            if tgt == "'DEFAULT'":
                start_default = _num(val)
            else:
                start[tgt] = _num(val)
        elif section == "ELEMENT TYPE":
            et = etypes.setdefault(t[0], dict(ev=[], iv=[], ep=[]))
            if code == "EV":
                et["ev"].extend(t[1:])
            elif code == "IV":
                et["iv"].extend(t[1:])
            elif code == "EP":
                et["ep"].extend(t[1:])
        elif section == "ELEMENT USES":
            if code in ("T", "XT"):
                if t[0] == "'DEFAULT'":
                    default_etype = t[1]
                else:
                    euses.setdefault(t[0], dict(t=None, v={}, p={}))["t"] \
                        = t[1]
            elif code in ("V", "ZV", "XV"):
                e = euses.setdefault(t[0], dict(t=None, v={}, p={}))
                e["v"][t[1]] = t[2]
            elif code in ("P", "XP"):
                e = euses.setdefault(t[0], dict(t=None, v={}, p={}))
                e["p"][t[1]] = _num(t[2])
            elif code == "ZP":
                e = euses.setdefault(t[0], dict(t=None, v={}, p={}))
                e["p"][t[1]] = params[t[2]]
        elif section == "GROUP TYPE":
            gt = gtypes.setdefault(t[0], dict(gv="GVAR", gp=[]))
            if code == "GV":
                gt["gv"] = t[1]
            elif code == "GP":
                gt["gp"].extend(t[1:])
        elif section == "GROUP USES":
            if code in ("T", "XT"):
                if t[0] == "'DEFAULT'":
                    default_gtype = t[1]
                else:
                    group(t[0]).gtype = t[1]
            elif code in ("E", "XE"):
                g = group(t[0])
                rest = t[1:]
                k = 0
                while k < len(rest):
                    w = _num(rest[k + 1]) if k + 1 < len(rest) and re.match(
                        r"^[-+0-9.]", rest[k + 1]) else 1.0
                    used = 2 if (k + 1 < len(rest)
                                 and re.match(r"^[-+0-9.]", rest[k + 1])) \
                        else 1
                    g.elements.append((rest[k], w))
                    k += used
            elif code == "ZE":
                group(t[0]).elements.append((t[1], params[t[2]]))
            elif code in ("P", "XP"):
                group(t[0]).gparams[t[1]] = _num(t[2])
            elif code == "ZP":
                group(t[0]).gparams[t[1]] = params[t[2]]

    # ---- function blocks (ELEMENTS / GROUPS Fortran sections) --------
    elem_fns = _parse_fn_block(fn_blocks, "ELEMENTS")
    group_fns = _parse_fn_block(fn_blocks, "GROUPS")

    # ---- assemble the torch objective/constraints --------------------
    n = len(var_names)
    x_l = np.full(n, bounds_default[0])
    x_u = np.full(n, bounds_default[1])
    x0 = np.full(n, start_default)
    for v, b in blo.items():
        x_l[var_idx[v]] = b
    for v, b in bup.items():
        x_u[var_idx[v]] = b
    for v, s in start.items():
        if v in var_idx:
            x0[var_idx[v]] = s

    def elem_value(ename, x, fns_env):
        use = euses[ename]
        ety = use["t"] or default_etype
        et = etypes[ety]
        fns = elem_fns[ety]
        ns = {}
        for formal in et["ev"]:
            ns[formal] = x[var_idx[use["v"][formal]]]
        for pname in et["ep"]:
            ns[pname] = use["p"][pname]
        if et["iv"]:
            # internal variables: linear maps of the elementals (R lines)
            ev_vals = ns.copy()
            for iv in et["iv"]:
                ns[iv] = sum(c * ev_vals[evn]
                             for evn, c in fns["ranges"][iv].items())
        for tname, texpr in fns["temps"]:
            ns[tname] = _feval(texpr, ns, fns_env)
        return _feval(fns["f"], ns, fns_env)

    def group_alpha(gname, x, fns_env):
        g = groups[gname]
        a = -g.const
        for v, c in g.linear.items():
            a = a + c * x[var_idx[v]]
        for ename, w in g.elements:
            a = a + w * elem_value(ename, x, fns_env)
        return a

    def group_contrib(gname, x, fns_env):
        g = groups[gname]
        a = group_alpha(gname, x, fns_env)
        gt = g.gtype or default_gtype
        if gt is None or gt == "TRIVIAL":
            val = a
        else:
            fns = group_fns[gt]
            ns = {gtypes[gt]["gv"]: a}
            for pn in gtypes[gt]["gp"]:
                ns[pn] = g.gparams[pn]
            for tname, texpr in fns["temps"]:
                ns[tname] = _feval(texpr, ns, fns_env)
            val = _feval(fns["f"], ns, fns_env)
        return val / g.scale

    obj_groups = [gn for gn in gorder if groups[gn].kind == "N"]
    con_groups = [gn for gn in gorder if groups[gn].kind in "LGE"]

    def objective(x):
        env = _intrinsics(x)
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        for gn in obj_groups:
            total = total + group_contrib(gn, x, env)
        return total

    constraints = None
    c_l = c_u = None
    if con_groups:
        c_l = np.zeros(len(con_groups))
        c_u = np.zeros(len(con_groups))
        for k, gn in enumerate(con_groups):
            g = groups[gn]
            b = g.const
            if g.kind == "E":
                c_l[k] = c_u[k] = b
            elif g.kind == "L":
                c_l[k] = -INFINITY
                c_u[k] = b
                if g.rng is not None:
                    c_l[k] = b - abs(g.rng)
            else:  # G
                c_l[k] = b
                c_u[k] = INFINITY
                if g.rng is not None:
                    c_u[k] = b + abs(g.rng)

        def constraints(x):  # noqa: F811
            # alpha includes -const; constraint compares alpha+const to b.
            # A group with no variables leaves alpha a Python float.
            env = _intrinsics(x)
            vals = [group_alpha(gn, x, env) + groups[gn].const
                    for gn in con_groups]
            return torch.stack([v if torch.is_tensor(v) else
                                torch.full((), v, dtype=x.dtype, device=x.device)
                                for v in vals])

    return SIFProblem(
        name=name, var_names=var_names, x0=x0, x_l=x_l, x_u=x_u,
        objective=objective, constraints=constraints, c_l=c_l, c_u=c_u,
    )


def _parse_fn_block(text: str, kind: str) -> dict:
    """Parse an 'ELEMENTS name' or 'GROUPS name' Fortran block into
    {type: dict(f=expr, temps=[(name, expr)], ranges={iv: {ev: coef}})}."""
    out: dict = {}
    lines = text.splitlines()
    i = 0
    inside = False
    cur = None
    temps_global: list = []
    while i < len(lines):
        ln = lines[i]
        i += 1
        s = ln.strip()
        if not s or s.startswith("*"):
            continue
        toks = ln.split()
        if toks[0] == kind:
            inside = True
            cur = None
            temps_global = []
            continue
        if toks[0] in ("ELEMENTS", "GROUPS", "ENDATA") and toks[0] != kind:
            inside = False
            continue
        if not inside:
            continue
        code = toks[0]
        if code == "T":
            cur = toks[1]
            out[cur] = dict(f=None, temps=list(temps_global), ranges={})
        elif code == "A" and len(toks) >= 2:
            # temporary assignment: global (before first T) or per-type
            expr = ln.split(None, 2)[2] if len(toks) > 2 else "0.0"
            if cur is None:
                temps_global.append((toks[1], expr))
            else:
                out[cur]["temps"].append((toks[1], expr))
        elif code == "R" and cur is not None:
            # internal var = sum coef * elemental:  R  X  Y 1.0  Z 1.0
            iv = toks[1]
            rest = toks[2:]
            d = out[cur]["ranges"].setdefault(iv, {})
            for k in range(0, len(rest) - 1, 2):
                d[rest[k]] = _num(rest[k + 1])
        elif code == "F":
            # value expression: the remainder of the line
            expr = ln.split(None, 1)[1]
            if cur is not None:
                out[cur]["f"] = expr
        # G/H derivative lines are intentionally ignored: torch.func
    return out


def load(path: str) -> SIFProblem:
    with open(path) as fh:
        return loads(fh.read())


def read_nlp(path: str, dtype=None, device=None) -> NLP:
    """Decode a SIF file straight into a solver-ready NLP on ``device``
    (``None``: the CUDA device)."""
    return load(path).to_nlp(dtype, device)
