"""The plain reference that decides ``correct``: the KKT conditions of the
QP  min 1/2 x'Hx + g'x  s.t.  c_l <= A x <= c_u,  x_l <= x <= x_u,
evaluated in float64 with numpy and scipy from the problem data the benchmark
made itself.  It imports nothing of the port and takes nothing the port
derived: the port's (x, y, z) are read only to be judged.

Sign convention (the port's, and GALAHAD's CQP): H x + g - A'y - z = 0, with
y >= 0 on a row at its lower bound and <= 0 at its upper one, and z likewise
on the variables."""
from __future__ import annotations

import numpy as np


def _fin(v):
    v = np.asarray(v, np.float64)
    return np.abs(v) < 1e19


def _max(*arrays) -> float:
    return float(max((np.max(a) for a in arrays if a.size), default=0.0))


def kkt_errors(p: dict, x, y, z) -> dict:
    """Primal infeasibility, dual infeasibility (the Lagrangian's gradient and
    multipliers of the wrong sign) and complementarity, each the largest
    absolute violation, for the problem ``p`` (``H`` a scipy matrix or None,
    ``A``, and the vectors ``g``, ``c_l``, ``c_u``, ``x_l``, ``x_u``) and the
    answer (x, y, z); ``kkt`` is the largest of the three."""
    x, y, z = (np.asarray(v, np.float64) for v in (x, y, z))
    g = np.asarray(p["g"], np.float64)
    A = p["A"]
    ax = A @ x
    grad = g - A.T @ y - z
    if p["H"] is not None:
        grad = grad + p["H"] @ x
    cl, cu, xl, xu = (np.asarray(p[k], np.float64) for k in ("c_l", "c_u", "x_l", "x_u"))
    fcl, fcu, fxl, fxu = _fin(cl), _fin(cu), _fin(xl), _fin(xu)
    r_p = _max(np.maximum(cl[fcl] - ax[fcl], 0), np.maximum(ax[fcu] - cu[fcu], 0),
               np.maximum(xl[fxl] - x[fxl], 0), np.maximum(x[fxu] - xu[fxu], 0))
    r_d = _max(np.abs(grad),
               np.maximum(z[~fxl], 0), np.maximum(-z[~fxu], 0),
               np.maximum(y[~fcl], 0), np.maximum(-y[~fcu], 0))
    comp = _max(np.abs((x[fxl] - xl[fxl]) * np.maximum(z[fxl], 0)),
                np.abs((xu[fxu] - x[fxu]) * np.maximum(-z[fxu], 0)),
                np.abs((ax[fcl] - cl[fcl]) * np.maximum(y[fcl], 0)),
                np.abs((cu[fcu] - ax[fcu]) * np.maximum(-y[fcu], 0)))
    return dict(kkt=max(r_p, r_d, comp), primal=r_p, dual=r_d, complementarity=comp)


def judge(p: dict, answer: dict, limits: dict) -> dict:
    """One request's verdict: its status, the shapes and finiteness of (x, y,
    z) and their KKT errors, each held to its limit in ``limits`` (keys of
    :func:`kkt_errors`' result); a status other than 0 fails."""
    n, m = p["A"].shape[1], p["A"].shape[0]
    x, y, z = answer["x"], answer["y"], answer["z"]
    shaped = (np.shape(x) == (n,) and np.shape(y) == (m,) and np.shape(z) == (n,)
              and all(np.isfinite(v).all() for v in (x, y, z)))
    inf = float("inf")
    err = kkt_errors(p, x, y, z) if shaped else dict(kkt=inf, primal=inf, dual=inf,
                                                      complementarity=inf)
    ok = shaped and answer["status"] == 0 and all(err[k] <= v for k, v in limits.items())
    return dict(ok=ok, status=answer["status"], shaped=shaped, **err)
