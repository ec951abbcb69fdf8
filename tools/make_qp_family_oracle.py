#!/usr/bin/env python
"""Record what the JAX package's QP family gives on the QPLIB sweep.

    JAX_PLATFORMS=cpu python tools/make_qp_family_oracle.py [NAME ...]
        -> tests/qp_family_oracle.json: for each of examples/sweep/*.qplib
           (or the fixtures named), ``qplib.read_qp`` then, in float64 on the
           CPU, ``qp.frontend.qp_solve`` with quadratic_programming_solver
           "qpa", "qpb" and "qpc" on a QP (a Hessian given) or "lpa" on an LP,
           and with ``crossover=True`` (the default "cqp" solver, then CRO) on
           every fixture: status, iterations, objective (1/2 x'Hx + g'x + f of
           the problem read), x, the seconds it took, and for the crossover
           CRO's own status.  Named fixtures are merged into the existing file.

The port's tests (tests/test_torch_qp_active.py) and chip_smoke.py hold the
port's ``qp_solve`` to this file.
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
OUT = os.path.join(ROOT, "tests", "qp_family_oracle.json")


def runs_of(qp):
    """The solver runs of one fixture: (key, QPControl keywords)."""
    if qp.h_kind == "zero":
        runs = [("lpa", dict(quadratic_programming_solver="lpa"))]
    else:
        runs = [(s, dict(quadratic_programming_solver=s)) for s in ("qpa", "qpb", "qpc")]
    return runs + [("crossover", dict(crossover=True))]


def solve_fixture(path):
    from galahad_tpu.io import qplib
    from galahad_tpu.qp import cro
    from galahad_tpu.qp.frontend import QPControl, qp_solve

    qp = qplib.read_qp(path)
    out = {}
    for key, kw in runs_of(qp):
        t0 = time.perf_counter()
        cro_status = None
        if key == "crossover":
            # the front end drops CRO's status: take it from the same call
            seen = []
            real = cro.cro_crossover

            def spy(*a, **k):
                r = real(*a, **k)
                seen.append(int(r.status))
                return r

            cro.cro_crossover = spy
            try:
                x, _, _, info = qp_solve(qp, QPControl(**kw))
            finally:
                cro.cro_crossover = real
            cro_status = seen[0]
        else:
            x, _, _, info = qp_solve(qp, QPControl(**kw))
        rec = dict(status=int(info.status), iter=int(info.iter),
                   obj=float(qp.objective(x)),
                   x=[float(v) for v in np.asarray(x, np.float64)],
                   seconds=time.perf_counter() - t0)
        if cro_status is not None:
            rec["cro_status"] = cro_status
        out[key] = rec
        print(os.path.basename(path), key, rec["status"], rec["iter"], rec["obj"],
              cro_status, f"{rec['seconds']:.1f}s", flush=True)
    return out


def main(names) -> None:
    every = sorted(f[:-6] for f in os.listdir(SWEEP) if f.endswith(".qplib"))
    fixtures = {}
    if names and os.path.exists(OUT):
        with open(OUT) as fh:
            fixtures = json.load(fh)["fixtures"]
    for name in names or every:
        fixtures[name] = solve_fixture(os.path.join(SWEEP, name + ".qplib"))
    doc = dict(
        made_by="tools/make_qp_family_oracle.py: the JAX package (galahad_tpu), "
                "qplib.read_qp -> qp.frontend.qp_solve(QPControl(quadratic_programming_solver"
                "=qpa|qpb|qpc|lpa)) and qp_solve(QPControl(crossover=True)), float64, on the CPU",
        jax_version=jax.__version__, fixtures=dict(sorted(fixtures.items())))
    with open(OUT, "w") as fh:
        fh.write(dumps_oracle(doc))


if __name__ == "__main__":
    main(sys.argv[1:])
