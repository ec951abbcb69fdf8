"""The elastic-plastic torsion problem (EPT) of the MINPACK-2 test problem
collection: on the unit square with nx x ny interior points of a uniform grid
(spacings hx = 1 / (nx + 1), hy = 1 / (ny + 1)),

    min 1/2 v'Kv - c 1'v   s.t.   -d_i <= v_i <= d_i,

K the 5-point difference Laplacian (2 / hx^2 + 2 / hy^2 on the diagonal,
-1 / hx^2 and -1 / hy^2 to the neighbours: the piecewise-linear elements'
stiffness over hx hy), c the twist, d_i the distance of point i to the
square's boundary.  A request is the problem at a twist c drawn from its seed:
the same pattern and bounds, a new g.

Plain numpy and torch: imports nothing of the port."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from portbench.roofline import grid_elimination

KIND = "sparse"


def _sides(cfg: dict) -> tuple:
    return int(cfg["nx"]), int(cfg["ny"])


def structure(cfg: dict) -> dict:
    """The fixed part of every request: K's lower triangle (rows, cols,
    values) and the bounds, as numpy arrays; no general constraints."""
    nx, ny = _sides(cfg)
    n = nx * ny
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    idx = np.arange(n).reshape(nx, ny)          # point (i, j) is i * ny + j
    rows, cols = [np.arange(n)], [np.arange(n)]
    vals = [np.full(n, 2.0 / hx ** 2 + 2.0 / hy ** 2)]
    for hi, lo, w in ((idx[1:, :], idx[:-1, :], -1.0 / hx ** 2),
                      (idx[:, 1:], idx[:, :-1], -1.0 / hy ** 2)):
        rows.append(hi.ravel())
        cols.append(lo.ravel())
        vals.append(np.full(hi.size, w))
    px = np.arange(1, nx + 1) * hx
    py = np.arange(1, ny + 1) * hy
    d = np.minimum.outer(np.minimum(px, 1.0 - px), np.minimum(py, 1.0 - py)).ravel()
    empty = np.zeros(0, np.int64)
    return dict(
        n=n, m=0, nx=nx, ny=ny,
        h_rows=np.concatenate(rows), h_cols=np.concatenate(cols), h_vals=np.concatenate(vals),
        a_rows=empty, a_cols=empty, c_l=np.zeros(0), c_u=np.zeros(0), x_l=-d, x_u=d)


def values(cfg: dict, st: dict, gen: torch.Generator, device) -> dict:
    """One request's values, float64 on ``device``: g = -c 1 with the twist
    c ~ U(c_lo, c_hi)."""
    c_lo, c_hi = cfg["twist_range"]
    c = torch.rand(1, generator=gen, device=device, dtype=torch.float64) * (c_hi - c_lo) + c_lo
    return dict(g=-c.expand(st["n"]).contiguous())


def host_problem(st: dict, vals: dict) -> dict:
    """The request as float64 scipy matrices for the plain reference."""
    n = st["n"]
    low = sp.csr_matrix((st["h_vals"], (st["h_rows"], st["h_cols"])), shape=(n, n))
    return dict(H=(low + sp.tril(low, -1).T).tocsr(), A=sp.csr_matrix((0, n)),
                g=np.asarray(vals["g"], np.float64), c_l=st["c_l"], c_u=st["c_u"],
                x_l=st["x_l"], x_u=st["x_u"])


def kernel_shapes(cfg: dict, st: dict) -> dict:
    """The work the KKT matrix's factor and solves need: the fronts of the
    grid's nested dissection (the KKT matrix is K plus a diagonal)."""
    nc, nf = grid_elimination.nested_dissection(*_sides(cfg))
    return dict(fronts=dict(nc=nc, nf=nf), rhs_rows=st["n"])
