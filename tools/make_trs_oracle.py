#!/usr/bin/env python
"""Record what the JAX package's trust-region subproblem solvers give on the
reference's headline batch, the batched TRS of bench.py:81
(``bench_batched_trs``).

    JAX_PLATFORMS=cpu python tools/make_trs_oracle.py
        -> tests/trs_oracle.json

The batch (``headline_batch``): ``default_rng(0)`` draws B (1024, 64, 64)
and then the radii U(0.1, 2.0); H = (B + B')/2; c = ``default_rng(1)``
normal (1024, 64).  In float64 on the CPU, per problem:
``trs_solve(H, c, radius)`` obj, multiplier, hard_case, interior;
``rqs_solve(H, c, 1/radius, p=3)`` obj, multiplier, hard_case;
``trs_solve_chol(H, c, radius)`` obj, hard_case, interior; ``dps_solve(H, c,
radius)`` in both norms (the modified absolute value, and ``goldfarb=True``)
obj, interior.  ``tests/test_torch_trs.py`` checks the file against a fresh
JAX run on its first 16 problems; ``chip_smoke.py`` holds the port's results
on the card to it.
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

OUT = os.path.join(ROOT, "tests", "trs_oracle.json")
BATCH, N, SEED_H, SEED_C, P = 1024, 64, 0, 1, 3.0


def headline_batch(batch=BATCH, n=N):
    """(H, c, radius) of the headline batch as numpy float64 arrays."""
    rng = np.random.default_rng(SEED_H)
    B = rng.normal(size=(batch, n, n))
    H = (B + np.swapaxes(B, -1, -2)) / 2
    radius = rng.uniform(0.1, 2.0, size=batch)
    c = np.random.default_rng(SEED_C).normal(size=(batch, n))
    return H, c, radius


def jax_results(H, c, radius):
    """The oracle's fields for the problems given, from the JAX package."""
    import jax.numpy as jnp

    from galahad_tpu.tr.trs import dps_solve, rqs_solve, trs_solve, trs_solve_chol

    H, c, radius = (jnp.asarray(a) for a in (H, c, radius))
    f = lambda a: [float(v) for v in np.asarray(a, np.float64)]    # noqa: E731
    b = lambda a: [int(v) for v in np.asarray(a, bool)]            # noqa: E731
    t = trs_solve(H, c, radius)
    r = rqs_solve(H, c, 1.0 / radius, p=P)
    ch = trs_solve_chol(H, c, radius)
    dm = dps_solve(H, c, radius=radius)
    dg = dps_solve(H, c, radius=radius, goldfarb=True)
    return dict(
        trs_obj=f(t.obj), trs_multiplier=f(t.multiplier), trs_hard_case=b(t.hard_case),
        trs_interior=b(t.interior),
        rqs_obj=f(r.obj), rqs_multiplier=f(r.multiplier), rqs_hard_case=b(r.hard_case),
        chol_obj=f(ch.obj), chol_hard_case=b(ch.hard_case), chol_interior=b(ch.interior),
        dps_obj=f(dm.obj), dps_interior=b(dm.interior),
        dps_goldfarb_obj=f(dg.obj), dps_goldfarb_interior=b(dg.interior))


def main() -> None:
    t0 = time.perf_counter()
    out = dict(made_by="tools/make_trs_oracle.py", jax_version=jax.__version__,
               batch=BATCH, n=N, seed_h=SEED_H, seed_c=SEED_C, p=P, dtype="float64",
               **jax_results(*headline_batch()))
    with open(OUT, "w") as fh:
        json.dump(out, fh, separators=(",", ":"))
        fh.write("\n")
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
