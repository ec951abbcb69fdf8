"""The 20 QPLIB sweep fixtures (examples/sweep) through the port's dense
reader and IPM, ``read_qp`` -> ``ipm_solve`` with the default control,
held to the JAX package's results committed in
tests/dense_sweep_oracle.json (made by tools/make_dense_oracle.py).

What is held: each fixture's status and iteration count equal the
oracle's; where the status is 0, the objective within 1e-8 relative and x
within 1e-6.  One fixture is also solved live by both packages, and the
live JAX result must equal the file's, so that a stale oracle shows."""
import json
import os

import numpy as np
import pytest

from galahad_tpu_torch.io import qplib as t_qplib
from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve

from _torch_port_helpers import REPO, SWEEP, one_torch_thread, sweep_path  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

with open(os.path.join(REPO, "tests", "dense_sweep_oracle.json")) as _fh:
    ORACLE = json.load(_fh)["fixtures"]


def test_oracle_covers_the_sweep():
    assert sorted(ORACLE) == SWEEP and len(SWEEP) == 20


def check_against(ref, x, st):
    assert (st.status, st.iter) == (ref["status"], ref["iter"])
    if st.status == 0:
        assert abs(ref["obj"] - st.inform.obj) <= 1e-8 * max(1.0, abs(ref["obj"]))
        assert np.abs(np.asarray(ref["x"]) - x.numpy()).max() <= 1e-6


@pytest.mark.parametrize("name", SWEEP)
def test_fixture_matches_oracle(name):
    x, _, _, st = ipm_solve(t_qplib.read_qp(sweep_path(name), device="cpu"), IPMControl())
    check_against(ORACLE[name], x, st)


def test_oracle_is_current():
    """The JAX package, run now on one fixture, still gives the file's
    status, iterations, objective and x."""
    from galahad_tpu.io import qplib as j_qplib
    from galahad_tpu.qp.ipm import IPMControl as JControl
    from galahad_tpu.qp.ipm import ipm_solve as j_solve

    xj, _, _, sj = j_solve(j_qplib.read_qp(sweep_path("QPEQ")), JControl())
    ref = ORACLE["QPEQ"]
    assert (int(sj.status), int(sj.iter)) == (ref["status"], ref["iter"])
    assert abs(float(sj.inform.obj) - ref["obj"]) <= 1e-12 * max(1.0, abs(ref["obj"]))
    assert np.abs(np.asarray(xj) - np.asarray(ref["x"])).max() <= 1e-12
    x, _, _, st = ipm_solve(t_qplib.read_qp(sweep_path("QPEQ"), device="cpu"), IPMControl())
    check_against(ref, x, st)
