#!/usr/bin/env python
"""Record what the JAX package's dense IPM gives on the QPLIB sweep, and the
series arcs' iteration counts on the flagship grid QP.

    JAX_PLATFORMS=cpu python tools/make_dense_oracle.py sweep
        -> tests/dense_sweep_oracle.json: for each of examples/sweep/*.qplib,
           ``qplib.read_qp`` -> ``ipm_solve`` with the default control, in
           float64 on the CPU: status, iterations, objective and x.
    JAX_PLATFORMS=cpu python tools/make_dense_oracle.py arcs [k]
        -> prints, for the grid QP of size k (default 100; the family of
           chip_smoke.py's ``flagship_qp``), the status and iterations of
           ``ipm_solve`` with taylor order 4, puiseux order 3 and zhao_sun
           order 3 (the constants ``JAX_ARC_ITERS`` of chip_smoke.py).

The tests of the PyTorch port hold its solves to the file; one fixture is
also solved live by both packages there, so that a stale file shows.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

SWEEP = os.path.join(ROOT, "examples", "sweep")
OUT = os.path.join(ROOT, "tests", "dense_sweep_oracle.json")
ARCS = (("taylor", 4), ("puiseux", 3), ("zhao_sun", 3))


def sweep() -> None:
    from galahad_tpu.io import qplib
    from galahad_tpu.qp.ipm import IPMControl, ipm_solve

    names = sorted(f[:-6] for f in os.listdir(SWEEP) if f.endswith(".qplib"))
    out = {}
    for name in names:
        t0 = time.perf_counter()
        qp = qplib.read_qp(os.path.join(SWEEP, name + ".qplib"))
        x, _, _, st = ipm_solve(qp, IPMControl())
        out[name] = dict(status=int(st.status), iter=int(st.iter),
                         obj=float(st.inform.obj),
                         x=[float(v) for v in np.asarray(x, np.float64)])
        print(name, out[name]["status"], out[name]["iter"], out[name]["obj"],
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    doc = dict(
        made_by="tools/make_dense_oracle.py sweep: the JAX package (galahad_tpu), "
                "qplib.read_qp -> qp.ipm.ipm_solve(IPMControl()), float64, on the CPU",
        jax_version=jax.__version__, fixtures=out)
    with open(OUT, "w") as fh:
        fh.write(dumps_oracle(doc))


def dumps_oracle(doc) -> str:
    """The oracle's text: one line per fixture."""
    head = {k: v for k, v in doc.items() if k != "fixtures"}
    lines = [json.dumps(head)[:-1] + ', "fixtures": {']
    items = sorted(doc["fixtures"].items())
    lines += [f" {json.dumps(k)}: {json.dumps(v)}" + ("," if i < len(items) - 1 else "")
              for i, (k, v) in enumerate(items)]
    return "\n".join(lines) + "\n}}\n"


def flagship_arrays(k: int):
    """The arrays of chip_smoke.py's ``flagship_qp(k)``: grid-Laplacian H
    (lower COO), a two-diagonal A, g and the bounds."""
    n = k * k
    idx = np.arange(n).reshape(k, k)
    ii, jj, vv = [np.arange(n)], [np.arange(n)], [np.full(n, 4.0)]
    for a, b in ((idx[:, 1:], idx[:, :-1]), (idx[1:, :], idx[:-1, :])):
        ii.append(np.maximum(a.ravel(), b.ravel()))
        jj.append(np.minimum(a.ravel(), b.ravel()))
        vv.append(np.full(a.size, -1.0))
    m = n // 2
    ar = np.repeat(np.arange(m), 2)
    ac = np.stack([np.arange(m), np.arange(m) + n - m]).T.reshape(-1)
    av = np.random.default_rng(0).uniform(0.5, 1.5, 2 * m)
    g = np.random.default_rng(0).normal(size=n)
    return n, m, dict(h_coo=tuple(map(np.concatenate, (ii, jj, vv))), a_coo=(ar, ac, av),
                      g=g, c_l=np.full(m, 1.0), c_u=np.full(m, 1e20),
                      x_l=np.zeros(n), x_u=np.full(n, 2.0))


def arcs(k: int) -> None:
    from galahad_tpu.core.sparse import make_sparse_qp
    from galahad_tpu.qp.ipm import IPMControl, ipm_solve

    n, m, kw = flagship_arrays(k)
    qp = make_sparse_qp(n, m, **kw)
    for arc, order in ARCS:
        t0 = time.perf_counter()
        _, _, _, st = ipm_solve(qp, IPMControl(arc=arc, series_order=order))
        print(json.dumps(dict(k=k, arc=arc, series_order=order, status=int(st.status),
                              iter=int(st.iter), seconds=time.perf_counter() - t0)),
              flush=True)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "sweep"
    if what == "sweep":
        sweep()
    elif what == "arcs":
        arcs(int(sys.argv[2]) if len(sys.argv) > 2 else 100)
    else:
        raise SystemExit(f"unknown mode {what!r}: sweep | arcs [k]")
