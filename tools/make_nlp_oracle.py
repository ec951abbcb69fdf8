#!/usr/bin/env python
"""Record what the JAX package's sparse Gauss-Newton NLS gives on
tests/test_nlp.py::test_nls_sparse_gauss_newton_large's problem (k = 100:
n = 10,000, m = 19,800; ``tools/nlp_problems.py::grid_residual_arrays``),
from x = 1 with NLSControl(maxit=40), float64 on the CPU:

    JAX_PLATFORMS=cpu python tools/make_nlp_oracle.py
        -> tests/nlp_oracle.json   (~40 s, most of it compiles)

It holds ``iter``, ``status``, ``f``, ``norm_g``, ``x_norm`` and x at the
32 indices ``x_at`` (spread over 0 .. n - 1, both ends included).
``chip_smoke.py``'s ``nlp`` phase holds the port's run on the card at k = 100
to it (the same iterations, f within 1e-8 relative, x within 1e-8), and
tests/test_torch_nls.py the port's CPU run (x within 1e-10).
"""
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

OUT = os.path.join(ROOT, "tests", "nlp_oracle.json")
K, MAXIT = 100, 40
X_ENTRIES = 32


def main() -> int:
    import jax.numpy as jnp
    import numpy as np

    from galahad_tpu.core.sparse import COOPattern
    from galahad_tpu.nlp.nls import NLSControl, nls_solve_sparse
    from nlp_problems import grid_residual_arrays

    n, m, u, v, a, rows, cols = grid_residual_arrays(K)
    ju, jv, ja = jnp.asarray(u), jnp.asarray(v), jnp.asarray(a)
    t0 = time.perf_counter()
    st = nls_solve_sparse(lambda x: x[ju] + x[jv] ** 2 - ja,
                          lambda x: jnp.stack([jnp.ones(m, x.dtype), 2.0 * x[jv]]).T.reshape(-1),
                          COOPattern(rows, cols, m, n), jnp.full(n, 1.0), NLSControl(maxit=MAXIT))
    x = np.asarray(st.x)
    at = np.linspace(0, n - 1, X_ENTRIES).round().astype(int)
    out = {"nls_sparse_k100": dict(k=K, n=n, m=m, maxit=MAXIT, iter=int(st.iter),
                                   status=int(st.status), f=float(st.f),
                                   norm_g=float(st.norm_g), x_norm=float(np.linalg.norm(x)),
                                   x_at=at.tolist(), x=x[at].tolist())}
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
