"""GALAHAD's QPBAND example (the CQP package's CUTEst example, QPBAND.SIF):

    min 1/2 x'Hx + g'x   s.t.   x_i + x_{i+2} >= 1 (i = 1 .. n - 2),  0 <= x <= 2,

with H tridiagonal (2 on the diagonal, -1 beside it) and A with rows
i -> variables {i, i + 2}.  A request keeps H, the pattern and the bounds and
draws A's two diagonals and g anew; a banded H with rows takes the port's
PCG KKT mode (banded G solves inside each operator product).

Plain numpy and torch: imports nothing of the port.  The values of each
request are drawn on the device from the request's seed."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from portbench.families import banded_lp

KIND = "banded_h"


def structure(cfg: dict) -> dict:
    """The banded LP's structure plus H in symmetric DIA storage (2, n):
    ``h_diags[s, i] = H[i + s, i]``, the last subdiagonal entry 0."""
    st = banded_lp.structure(cfg)
    n = st["n"]
    diag, sub = (float(v) for v in cfg["h_diags"])
    st["h_diags"] = np.stack([np.full(n, diag), np.concatenate([np.full(n - 1, sub), [0.0]])])
    return st


values = banded_lp.values


def host_problem(st: dict, vals: dict) -> dict:
    """The request's problem for the reference, H as a scipy matrix."""
    p = banded_lp.host_problem(st, vals)
    d, s = st["h_diags"]
    p["H"] = sp.diags([s[:-1], d, s[:-1]], [-1, 0, 1], format="csr")
    return p


def kernel_shapes(cfg: dict, st: dict) -> dict:
    """The block-tridiagonal matrices of the PCG mode: G = H + D_x (n rows)
    and the preconditioner's Schur complement (m rows), both in blocks of
    ``block``; both come to ceil(n / block) block rows here."""
    return dict(banded_k=-(-st["n"] // st["block"]), banded_b=st["block"])
