"""The port's BQP, BLLS and EQP (galahad_tpu_torch/qp/bqp.py, eqp.py) against
the JAX package's on tests/test_qp_family.py's cases (TestEQP, TestBQP,
TestBLLS), float64, the port on the CPU.

What is held: BQP / BLLS the same status and iteration count, x, z and the
objective within 1e-10 relative; EQP x, y, the objective and the multiplier
within 1e-10, and GLTR's Lanczos count, which on these problems runs to its
cap (128) in both packages: the Krylov space is exhausted and the stop test
reads roundoff, where the counts may part (ROADMAP queue 3, PR 14's Krylov
departure).  Found: x within 3e-15."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.qp import bqp as j_bqp
from galahad_tpu.qp import eqp as j_eqp

from galahad_tpu_torch.qp import (BLLSControl, BQPControl, EQPControl, blls_solve, bqp_solve,
                                  eqp_solve)

from _torch_port_helpers import one_torch_thread, rel  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10


def eqp_cases():
    r = np.random.default_rng(0)
    n, m = 8, 3
    B = r.normal(size=(n, n))
    out = {"kkt": (B @ B.T + np.eye(n), r.normal(size=n), r.normal(size=(m, n)),
                   r.normal(size=m), {})}
    r = np.random.default_rng(1)
    n, m = 10, 4
    H = np.diag(r.uniform(0.5, 2.0, n))
    A, c = r.normal(size=(m, n)), r.normal(size=m)
    out["satisfied"] = (H, r.normal(size=n), A, c, {})
    r = np.random.default_rng(2)
    n, m = 6, 2
    B = r.normal(size=(n, n))
    H, A = B @ B.T, r.normal(size=(m, n))
    out["radius_active"] = (H, 5.0 * r.normal(size=n), A, np.zeros(2), dict(radius=0.1))
    r = np.random.default_rng(3)
    B = r.normal(size=(n, n))
    H, A = (B + B.T) / 2, r.normal(size=(m, n))
    out["indefinite"] = (H, r.normal(size=n), A, np.zeros(2), dict(radius=1.0))
    return out


def test_eqp_cases():
    """TestEQP's four cases (the KKT solution, the constraint satisfied, an
    active radius, an indefinite H within a radius)."""
    for name, (H, g, A, c, kw) in eqp_cases().items():
        ij = j_eqp.eqp_solve(jnp.asarray(H), jnp.asarray(g), jnp.asarray(A), jnp.asarray(c),
                             ctl=j_eqp.EQPControl(**kw))
        it = eqp_solve(H, g, A, c, ctl=EQPControl(**kw), device="cpu")
        assert int(ij.iter) == int(it.iter) == 128, name
        for k in ("x", "y", "obj", "norm_x", "multiplier"):
            assert rel(getattr(ij, k), getattr(it, k)) <= TOL, (name, k)
        np.testing.assert_allclose(A @ it.x.numpy(), c, atol=1e-8, err_msg=name)


def test_bqp_and_blls_cases():
    """TestBQP (against the IPM's case, the duals' signs) and TestBLLS
    (interior, bounds active, the ridge weight)."""
    r = np.random.default_rng(4)
    n = 8
    B = r.normal(size=(n, n))
    cases = [("bqp", (B @ B.T + np.eye(n), r.normal(size=n) * 3.0, np.zeros(n), np.ones(n)), {})]
    r = np.random.default_rng(5)
    cases.append(("bqp_signs", (np.diag(r.uniform(1.0, 2.0, 6)),
                                np.array([3.0, -3.0, 0.1, -0.1, 2.0, -2.0]), -np.ones(6),
                                np.ones(6)), {}))
    r = np.random.default_rng(6)
    A = r.normal(size=(12, 5))
    cases.append(("blls_interior", (A, A @ r.uniform(0.3, 0.7, 5), np.zeros(5), np.ones(5)), {}))
    r = np.random.default_rng(7)
    A = r.normal(size=(10, 4))
    cases.append(("blls_active", (A, A @ np.array([2.0, -1.0, 0.5, 3.0]), np.zeros(4),
                                  np.ones(4)), {}))
    r = np.random.default_rng(8)
    cases.append(("blls_ridge", (r.normal(size=(8, 4)), r.normal(size=8), np.full(4, -10.0),
                                 np.full(4, 10.0)), dict(weight=0.5)))
    for name, args, kw in cases:
        if name.startswith("bqp"):
            ij = j_bqp.bqp_solve(*map(jnp.asarray, args), ctl=j_bqp.BQPControl(**kw))
            it = bqp_solve(*args, ctl=BQPControl(**kw), device="cpu")
        else:
            ij = j_bqp.blls_solve(*map(jnp.asarray, args), ctl=j_bqp.BLLSControl(**kw))
            it = blls_solve(*args, ctl=BLLSControl(**kw), device="cpu")
        assert (int(ij.status), int(ij.iter)) == (int(it.status), int(it.iter)), name
        assert int(it.status) == 0 and it.host_reads == int(it.iter) + 1, name
        for k in ("x", "z", "obj", "norm_pg"):
            assert rel(getattr(ij, k), getattr(it, k)) <= TOL, (name, k)
