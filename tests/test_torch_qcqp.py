"""The port's QCQP (galahad_tpu_torch/qp/qcqp.py) and the QPLIB reader's QCQP
path (galahad_tpu_torch/io/qplib.py: ``QPLIBProblem.to_qcqp``, ``read_qcqp``)
against the JAX package's, on tests/test_qcqp.py's cases: the ball problem by
both methods and its QPLIB file, and a convex QCQP generated as QPLIB text
(tools/constrained_problems.py::convex_qcqp_text at n = 24, m = 4), float64,
the port on the CPU.

What is held: the same status and outer iteration count, x, y, z and the
objective within 1e-10 relative.  Found: exact agreement for ``method="al"``.
``method="filter"`` starts with FILTRANE, whose Gauss-Newton model on one
constraint in two variables is singular at every step (ROADMAP queue 3, the
TRS on a singular J'J): its point differs from the JAX package's, and the AL
polish then ends within its stop (1e-7) of the same solution (x within
1.1e-6 relative), in 7 outer iterations in the JAX package and 8 in the port
on the ball from (30, 30) (7 and 7 on QCQP_FILE's problem); status and the
solution within 1e-5 are held there."""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.io import qplib as j_qplib
from galahad_tpu.qp.qcqp import QCQPControl as JControl
from galahad_tpu.qp.qcqp import qcqp_solve as j_solve

from galahad_tpu_torch.convert import qcqp_from_numpy
from galahad_tpu_torch.io import qplib as t_qplib
from galahad_tpu_torch.qp import QCQPControl, qcqp_solve

from _torch_port_helpers import REPO, one_torch_thread, rel  # noqa: F401
from test_qcqp import QCQP_FILE, _ball_qcqp

sys.path.insert(0, os.path.join(REPO, "tools"))
import constrained_problems as CP  # noqa: E402  (tools/constrained_problems.py)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10


def hold(oj, ot, what, tol=TOL):
    assert (int(oj.status), int(oj.iter)) == (int(ot.status), int(ot.iter)), (
        what, int(oj.status), int(oj.iter), int(ot.status), int(ot.iter))
    for k in ("x", "y", "z", "obj", "infeas"):
        assert rel(getattr(oj, k), getattr(ot, k)) <= tol, (what, k)


def fields(p):
    return {f.name: (np.asarray(getattr(p, f.name)) if hasattr(getattr(p, f.name), "shape")
                     else getattr(p, f.name)) for f in dataclasses.fields(p)}


def test_ball_both_methods():
    """The ball problem from 0 by "al" (in full) and from (30, 30) by
    "filter" (status, and x, y and the objective within 1e-5: FILTRANE's
    steps part, the module docstring); the JAX QCQP carried by
    ``qcqp_from_numpy``."""
    pj = _ball_qcqp()
    pt = qcqp_from_numpy(fields(pj), device="cpu")
    assert pt.m == 1 and pt.n == 2 and pt.H is None
    hold(j_solve(pj), qcqp_solve(pt), "al")
    far_j = dataclasses.replace(pj, x=jnp.array([30.0, 30.0]))
    far_t = dataclasses.replace(pt, x=torch.tensor([30.0, 30.0], dtype=torch.float64))
    oj = j_solve(far_j, JControl(method="filter"))
    ot = qcqp_solve(far_t, QCQPControl(method="filter"))
    assert int(oj.status) == int(ot.status) == 0       # outer iterations found: 7 and 8
    for k in ("x", "y", "obj"):
        assert rel(getattr(oj, k), getattr(ot, k)) <= 1e-5, k
    np.testing.assert_allclose(float(ot.obj), -np.sqrt(2), atol=1e-3)
    assert ot.host_reads > 0


def test_qplib_qcqp_round_trip(tmp_path):
    """QCQP_FILE through both readers: to_qp refuses with the JAX package's
    message, to_qcqp gives the JAX package's dense Qc (the H_c triples, an
    off-diagonal term mirrored), and the solve its result; the writer keeps
    the H_c triples; ``read_qcqp`` reads the file."""
    assert CP.BALL_QCQP_FILE == QCQP_FILE           # chip_smoke.py's copy of the text
    p = t_qplib.loads(QCQP_FILE)
    assert p.ptype == "QCQ" and len(p.H_c) == 2
    with pytest.raises(ValueError, match="use to_qcqp"):
        p.to_qp(device="cpu")
    with pytest.raises(ValueError, match="use to_qcqp"):
        p.to_sparse_qp(device="cpu")
    qj, qt = j_qplib.loads(QCQP_FILE).to_qcqp(), p.to_qcqp(device="cpu")
    for k in ("Qc", "g", "A", "c_l", "c_u", "x_l", "x_u", "H"):
        assert np.array_equal(np.asarray(getattr(qj, k)), getattr(qt, k).numpy()), k
    hold(j_solve(qj), qcqp_solve(qt), "QCQP_FILE")
    p2 = t_qplib.loads(t_qplib.dumps(p))
    assert p2.H_c == p.H_c
    path = tmp_path / "ball.qplib"
    path.write_text(QCQP_FILE)
    q3 = t_qplib.read_qcqp(str(path), device="cpu")
    assert torch.equal(q3.Qc, qt.Qc) and q3.name == "BALL2"


def test_generated_convex_qcqp():
    """A convex QCQP written as QPLIB text by the generator that
    ``chip_smoke.py`` uses at n = 1,024 (here n = 24, m = 4, Q_i on 6
    variables; off-diagonal Hessian terms, a dense A): both readers give the
    same problem, both solvers the same result."""
    txt = CP.convex_qcqp_text(24, 4, seed=3, q_nnz=6)
    qj = j_qplib.loads(txt).to_qcqp()
    qt = t_qplib.loads(txt).to_qcqp(device="cpu")
    for k in ("Qc", "H", "A", "c_u"):
        assert np.array_equal(np.asarray(getattr(qj, k)), getattr(qt, k).numpy()), k
    oj, ot = j_solve(qj), qcqp_solve(qt)
    hold(oj, ot, "generated")
    assert int(ot.status) == 0 and float(ot.infeas) <= 1e-7
