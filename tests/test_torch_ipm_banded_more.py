"""More of the port's banded IPM and the IPM's named wrappers against the JAX
package.

What is held:
  * the float32 rule of tests/test_ipm_banded.py:131-167 on the port: on the
    banded LP at n = 2,000 (block 8, float32, stop tolerances 1e-6), status 0
    implies every residual of the state within its tolerance, and a status
    other than 0 is never reported as converged;
  * examples/QPBAND50.qplib read by each package's ``read_qp`` and turned into
    a ``BandedQP`` by each package's ``band_from_dense`` (H's diagonals 0, 1,
    A's 0, 2): the same status and iterations, x, y, z and the objective
    within 1e-7 absolute;
  * ``lpb_solve`` and ``bqpb_solve`` (qp/wrappers.py) against the JAX
    package's on the family of tests/test_ipm.py:61 (``random_convex_qp``),
    bqpb with a dense and with a diagonal H: the same status and iterations,
    the objective within 1e-8 relative and x within 1e-6."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.io import qplib as j_qplib
from galahad_tpu.linalg import band_ops as j_band
from galahad_tpu.qp import ipm_banded as j_banded
from galahad_tpu.qp import wrappers as j_wrappers

from galahad_tpu_torch.io import qplib as t_qplib
from galahad_tpu_torch.linalg import band_ops as t_band
from galahad_tpu_torch.qp import ipm as t_ipm
from galahad_tpu_torch.qp import ipm_banded as t_banded
from galahad_tpu_torch.qp import wrappers as t_wrappers

from _torch_port_helpers import (REPO, banded_pair, banded_problem_fields,  # noqa: F401
                                 check_same_banded_solve, check_same_solve, dense_pair,
                                 one_torch_thread, random_convex_qp_arrays)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_f32_conv_never_above_tolerance():
    f = banded_problem_fields(2000, lp=True, seed=3, block=8)
    _, tq = banded_pair(f, dtype="float32")
    assert tq.g.dtype == torch.float32
    tol = 1e-6
    ctl = t_ipm.IPMControl(maxit=60, stop_abs_p=tol, stop_abs_d=tol, stop_abs_c=tol,
                           dtype="float32")
    x, y, z, st = t_banded.ipm_solve_banded(tq, ctl)
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    if st.status == 0:
        assert st.res_p <= tol and st.res_d <= tol and st.res_c <= tol
    else:
        assert not st.converged


def test_qpband50_matches_reference():
    path = os.path.join(REPO, "examples", "QPBAND50.qplib")
    jd = j_qplib.read_qp(path)
    td = t_qplib.read_qp(path, device="cpu")
    assert (td.n, td.m) == (50, 48)
    jH, jA = j_band.band_from_dense(jd.H, (0, 1)), j_band.band_from_dense(jd.A, (0, 2))
    tH, tA = t_band.band_from_dense(td.H, (0, 1)), t_band.band_from_dense(td.A, (0, 2))
    jq = j_banded.BandedQP(g=jd.g, A_band=jA, c_l=jd.c_l, c_u=jd.c_u, x_l=jd.x_l, x_u=jd.x_u,
                           h_diags=jH.val, f=jd.f, h_kind="banded")
    tq = t_banded.BandedQP(g=td.g, A_band=tA, c_l=td.c_l, c_u=td.c_u, x_l=td.x_l,
                           x_u=td.x_u, h_diags=tH.val, f=td.f, h_kind="banded")
    st = check_same_banded_solve(j_banded.ipm_solve_banded(jq), jq,
                                 t_banded.ipm_solve_banded(tq))
    assert st.status == 0
    # the banded solve agrees with the dense one of the same file
    xd, _, _, sd = t_ipm.ipm_solve(td)
    assert sd.status == 0 and abs(sd.inform.obj - st.inform.obj) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_lpb_solve_matches_reference(seed):
    jq, tq = dense_pair(random_convex_qp_arrays(10, 6, seed))
    st = check_same_solve(j_wrappers.lpb_solve(jq), t_wrappers.lpb_solve(tq))
    assert st.status == 0


@pytest.mark.parametrize("kind", ["dense", "diagonal"])
def test_bqpb_solve_matches_reference(kind):
    a = random_convex_qp_arrays(10, 0, 2)
    H = a["H"] if kind == "dense" else np.random.default_rng(5).uniform(0.5, 2.0, 10)
    js = j_wrappers.bqpb_solve(jnp.asarray(H), jnp.asarray(a["g"]), jnp.asarray(a["x_l"]),
                               jnp.asarray(a["x_u"]))
    ts = t_wrappers.bqpb_solve(H, a["g"], a["x_l"], a["x_u"], device="cpu")
    st = check_same_solve(js, ts)
    assert st.status == 0


def test_wrappers_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_wrappers.bqpb_solve(np.ones(2), np.zeros(2), np.zeros(2), np.ones(2))
