"""The banded LP family of GALAHAD's LPBAND / QPBAND examples and of the JAX
package's ``bench_banded_lp``: A with rows i -> variables {i, i + 2}, H = 0,
c_l <= A x, x_l <= x <= x_u, solved on the block-tridiagonal KKT path.

Plain numpy and torch: imports nothing of the port.  The values of each
request (A's two diagonals and g) are drawn on the device from the request's
seed."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

KIND = "banded"


def structure(cfg: dict) -> dict:
    n = int(cfg["n"])
    offsets = tuple(int(o) for o in cfg["a_offsets"])
    m = n - max(offsets)
    lo, hi = cfg["x_bounds"]
    return dict(
        n=n, m=m, a_offsets=offsets, block=int(cfg["block"]),
        c_l=np.full(m, float(cfg["c_lower"])), c_u=np.full(m, np.inf),
        x_l=np.full(n, float(lo)), x_u=np.full(n, float(hi)))


def values(cfg: dict, st: dict, gen: torch.Generator, device) -> dict:
    """One request's values, float64 on ``device``: A's diagonals
    (len(a_offsets), m) ~ U(a_lo, a_hi), g ~ U(g_lo, g_hi)."""
    a_lo, a_hi = cfg["a_range"]
    g_lo, g_hi = cfg["g_range"]
    a = torch.rand(len(st["a_offsets"]), st["m"], generator=gen, device=device,
                   dtype=torch.float64)
    g = torch.rand(st["n"], generator=gen, device=device, dtype=torch.float64)
    return dict(a_val=a * (a_hi - a_lo) + a_lo, g=g * (g_hi - g_lo) + g_lo)


def host_problem(st: dict, vals: dict) -> dict:
    n, m = st["n"], st["m"]
    rows = np.concatenate([np.arange(m)] * len(st["a_offsets"]))
    cols = np.concatenate([np.arange(m) + o for o in st["a_offsets"]])
    A = sp.csr_matrix((np.asarray(vals["a_val"]).reshape(-1), (rows, cols)), shape=(m, n))
    return dict(H=None, A=A, g=vals["g"], c_l=st["c_l"], c_u=st["c_u"],
                x_l=st["x_l"], x_u=st["x_u"])


def kernel_shapes(cfg: dict, st: dict) -> dict:
    """The block-tridiagonal matrix that the KKT system of an LP (H = 0) with
    rows comes to: the Schur complement A D^-1 A' plus a diagonal, m rows in
    blocks of ``block``."""
    return dict(banded_k=-(-st["m"] // st["block"]), banded_b=st["block"])
