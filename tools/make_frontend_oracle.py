#!/usr/bin/env python
"""Record what the JAX package's QP front end gives on the QPLIB sweep, and
what its DQP and CCQP give on the dense QP of chip_smoke.py.

    JAX_PLATFORMS=cpu python tools/make_frontend_oracle.py sweep
        -> tests/frontend_sweep_oracle.json: for each of examples/sweep/*.qplib,
           ``qplib.read_qp`` -> ``qp.frontend.qp_solve(QPControl())`` in
           float64 on the CPU: status, iterations, objective
           (1/2 x'Hx + g'x + f of the problem read), x, and the solver that
           produced x ("cqp", or "dqp" where the default rescue answered).
    JAX_PLATFORMS=cpu python tools/make_frontend_oracle.py dense [n]
        -> prints, for ``random_convex_qp`` of tests/test_ipm.py at size n
           (default 4096; m = n / 2, n / 8 equality rows, seed 0: the dense
           QP of chip_smoke.py), the status, iterations and objective of
           ``dqp_solve`` and ``ccqp_solve`` with their default controls (the
           constants ``JAX_DQP`` of chip_smoke.py), and the seconds each took.

This is the front end's own oracle: ``qp_solve`` rescues two fixtures that
``ipm_solve`` leaves stalled, so tests/dense_sweep_oracle.json (the IPM's
results) does not describe it.  The port's tests hold its ``qp_solve`` and its
command line to the file; one fixture is also solved live by both packages
there, so that a stale file shows.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from make_dense_oracle import dumps_oracle  # noqa: E402

SWEEP = os.path.join(ROOT, "examples", "sweep")
OUT = os.path.join(ROOT, "tests", "frontend_sweep_oracle.json")


def solve_fixture(path):
    """The JAX front end on one fixture: a dict of the oracle's fields."""
    from galahad_tpu.io import qplib
    from galahad_tpu.qp.dqp import DQPInfo
    from galahad_tpu.qp.frontend import QPControl, qp_solve

    qp = qplib.read_qp(path)
    x, _, _, info = qp_solve(qp, QPControl())
    return dict(status=int(info.status), iter=int(info.iter),
                obj=float(qp.objective(x)),
                solver="dqp" if isinstance(info, DQPInfo) else "cqp",
                x=[float(v) for v in np.asarray(x, np.float64)])


def sweep() -> None:
    names = sorted(f[:-6] for f in os.listdir(SWEEP) if f.endswith(".qplib"))
    out = {}
    for name in names:
        t0 = time.perf_counter()
        out[name] = solve_fixture(os.path.join(SWEEP, name + ".qplib"))
        r = out[name]
        print(name, r["solver"], r["status"], r["iter"], r["obj"],
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    doc = dict(
        made_by="tools/make_frontend_oracle.py sweep: the JAX package (galahad_tpu), "
                "qplib.read_qp -> qp.frontend.qp_solve(QPControl()), float64, on the CPU",
        jax_version=jax.__version__, fixtures=out)
    with open(OUT, "w") as fh:
        fh.write(dumps_oracle(doc))


def convex_qp(n, m, seed, equalities):
    """tests/test_ipm.py::random_convex_qp's stream (chip_smoke.py's
    ``convex_qp_arrays``) as a JAX QP."""
    import jax.numpy as jnp
    from galahad_tpu.core.problem import QP

    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    H = B @ B.T + 0.5 * np.eye(n)
    A = r.normal(size=(m, n))
    x_feas = r.uniform(0.2, 0.8, size=n)
    c_at = A @ x_feas
    c_l = np.where(np.arange(m) < equalities, c_at, c_at - r.uniform(0.5, 1.0, m))
    c_u = np.where(np.arange(m) < equalities, c_at, c_at + r.uniform(0.5, 1.0, m))
    g = r.normal(size=n)
    return QP(H=jnp.asarray(H), g=jnp.asarray(g), A=jnp.asarray(A), c_l=jnp.asarray(c_l),
              c_u=jnp.asarray(c_u), x_l=jnp.zeros(n), x_u=jnp.ones(n))


def dense(n: int) -> None:
    from galahad_tpu.qp.dqp import ccqp_solve, dqp_solve

    qp = convex_qp(n, n // 2, 0, n // 8)
    for name, fn in (("dqp", lambda: dqp_solve(qp)), ("ccqp", lambda: ccqp_solve(qp))):
        t0 = time.perf_counter()
        d = fn()
        print(json.dumps(dict(n=n, m=n // 2, equalities=n // 8, solver=name,
                              status=int(d.status), iter=int(d.iter), obj=float(d.obj),
                              seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "sweep"
    if what == "sweep":
        sweep()
    elif what == "dense":
        dense(int(sys.argv[2]) if len(sys.argv) > 2 else 4096)
    else:
        raise SystemExit(f"unknown mode {what!r}: sweep | dense [n]")
