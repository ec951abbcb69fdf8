"""The port's QPA / QPC, QPB, LPA, CRO and LPQP (galahad_tpu_torch/qp/qpa.py,
qpb.py, lpa.py, cro.py, lpqp.py) through ``qp_solve`` against the JAX
package's, on the QPLIB sweep (examples/sweep), float64, the port on the CPU.
Mirrors tests/test_qp_family.py and tests/test_qp_family2.py.

The JAX package's results are in tests/qp_family_oracle.json (remake:
``JAX_PLATFORMS=cpu python tools/make_qp_family_oracle.py``, ~10 min); one
fixture is solved live by both packages here, so that a stale file shows.
What is held: the oracle's status and iteration count, the objective and x
within 1e-8 relative (max |difference| / max(1, max |oracle|)).  The
fixtures run here are those whose every solve takes under ~2 s on one CPU
thread (QPs of n <= 250, the LPs but LPB300 / LPB800 / LPTALL); all 20 run on
the card in chip_smoke.py against the same file.

Where the two packages part, they part through rounding at a decision that
the arithmetic leaves on its edge (ROADMAP queue 3).  ``PARTS`` lists each
such run with the pass at which it parts; there the test holds the pass
before it in full (x within 1e-12, the same barrier parameter or working
set), shows the pass where they part, and holds the end by the solver's own
stopping tolerance instead of the JAX package's iterate:

- QPB on BQP150, QPB100, QPDENSE, QPEQ and QPDIAG: at the parting pass the
  Armijo test of the barrier merit, or the test ``res_d <= 10 mu`` that
  lowers mu, is decided below the merit's rounding.  On QPEQ at pass 10
  (sigma = 1e-8) every trial merit lies within 9e-12 of the Armijo bound
  (the merit is 25.25, its terms' rounding ~1e-12): the JAX package accepts
  a trial, the port none.  Deep in the barrier endgame (mu ~ 1e-8) the KKT
  matrix's condition number magnifies the last bits of the inputs into a
  1e-11 .. 1e-10 difference of the step, and the next mu test falls the
  other way.  Both end at the same point within stop_d = 1e-6 (objective
  within 3e-8, x within 3e-6); the counts and, on BQP150, the status (0 in
  the JAX package, -13 in the port, at the same objective to 3e-16) part.
- QPC on QPMIXB: QPA starts from the IPM's iterate, and the IPM stops at its
  cap (-18 after 200 iterations in both packages) at points 6.0e-3 apart (the
  IPM's parity holds x only where it converges, _torch_port_helpers.
  check_ipm_fixture); QPA's working set differs from its first pass, and both
  run into QPA's cap (-18 at 500) at iterates whose objectives are 5.5e-4
  apart.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.io import qplib as j_qplib
from galahad_tpu.qp import frontend as j_fe
from galahad_tpu.qp import lpqp as j_lpqp
from galahad_tpu.qp import qpa as j_qpa
from galahad_tpu.qp import qpb as j_qpb

from galahad_tpu_torch.io import qplib as t_qplib
from galahad_tpu_torch.qp import frontend as t_fe
from galahad_tpu_torch.qp import lpqp as t_lpqp
from galahad_tpu_torch.qp import qpa as t_qpa
from galahad_tpu_torch.qp import qpb as t_qpb

from _torch_port_helpers import REPO, one_torch_thread, rel, sweep_path  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

with open(os.path.join(REPO, "tests", "qp_family_oracle.json")) as _fh:
    ORACLE = json.load(_fh)["fixtures"]

QP_CPU = ("BQP150", "QPB100", "QPDEGEN", "QPDENSE", "QPDIAG", "QPEQ", "QPILL", "QPMAX",
          "QPMIXB")
LP_CPU = ("LPB100", "LPDEGEN", "LPRANGE", "LPTIGHT", "LPWIDE")
TOL = 1e-8
PARTS = {("BQP150", "qpb"): 125, ("QPB100", "qpb"): 117, ("QPDENSE", "qpb"): 124,
         ("QPEQ", "qpb"): 10, ("QPDIAG", "qpb"): 103, ("QPMIXB", "qpc"): 1}
_PROBLEMS = {}


def problem(name):
    if name not in _PROBLEMS:
        _PROBLEMS[name] = t_qplib.read_qp(sweep_path(name), device="cpu")
    return _PROBLEMS[name]


def control(key):
    return (t_fe.QPControl(crossover=True) if key == "crossover"
            else t_fe.QPControl(quadratic_programming_solver=key))


def solve(name, key):
    qp = problem(name)
    x, y, z, info = t_fe.qp_solve(qp, control(key))
    return qp, x, info


def held(name, key):
    """One run against the oracle: status, iterations, objective and x."""
    qp, x, info = solve(name, key)
    ref = ORACLE[name][key]
    assert (info.status, info.iter) == (ref["status"], ref["iter"]), (name, key)
    obj = float(qp.objective(x))
    assert abs(obj - ref["obj"]) <= TOL * max(1.0, abs(ref["obj"])), (name, key, obj)
    assert rel(ref["x"], x) <= TOL, (name, key)
    return info


@pytest.mark.parametrize("solver", ["qpa", "qpb", "qpc"])
def test_qp_solvers_match_the_oracle(solver):
    """Each QP fixture through ``qp_solve``; the parting runs by the solver's
    stopping tolerance (the module docstring; their passes in
    test_partings_are_shown)."""
    for name in QP_CPU:
        if (name, solver) not in PARTS:
            info = held(name, solver)
            assert info.solver == solver and info.result is not None
            if solver == "qpa":
                # the set-up's read and one per pass
                assert info.result.host_reads == info.iter + 1, name
            continue
        qp, x, info = solve(name, solver)
        ref = ORACLE[name][solver]
        if solver == "qpb":
            assert info.status in (0, -13) and ref["status"] in (0, -13), name
            assert abs(float(qp.objective(x)) - ref["obj"]) <= 1e-6 * max(1.0, abs(ref["obj"]))
            assert rel(ref["x"], x) <= 1e-5, name
        else:
            assert (info.status, info.iter) == (ref["status"], ref["iter"]) == (-18, 500)


def test_lpa_matches_the_oracle():
    for name in LP_CPU:
        info = held(name, "lpa")
        assert info.solver == "lpa" and len(info.result.basis) <= problem(name).n \
            + problem(name).m


def test_crossover_matches_the_oracle():
    """``crossover=True`` (cqp, then CRO) on every fixture run here: where the
    JAX package's CRO succeeds, its status, iterations, objective and x; where
    it does not (QPILL, LPWIDE: -13, an active set that the box cannot keep),
    CRO's status and the solver's."""
    for name in QP_CPU + LP_CPU:
        ref = ORACLE[name]["crossover"]
        if ref["cro_status"] == 0:
            info = held(name, "crossover")
        else:
            _, _, info = solve(name, "crossover")
            assert (info.status, info.iter) == (ref["status"], ref["iter"]), name
        assert info.cro.status == ref["cro_status"], name


def test_the_oracle_is_live():
    """One fixture solved by both packages now: the oracle is not stale."""
    jq = j_qplib.read_qp(sweep_path("QPEQ"))
    for key in ("qpa", "qpb", "qpc"):
        x, _, _, info = j_fe.qp_solve(jq, j_fe.QPControl(quadratic_programming_solver=key))
        ref = ORACLE["QPEQ"][key]
        assert (int(info.status), int(info.iter)) == (ref["status"], ref["iter"]), key
        assert rel(ref["x"], np.asarray(x)) <= 1e-14, key


def jax_port_pair(name, solver, k):
    """Both packages cut at ``k`` passes: (JAX info, port info)."""
    jq = j_qplib.read_qp(sweep_path(name))
    if solver == "qpb":
        return (j_qpb.qpb_solve(jq, j_qpb.QPBControl(maxit=k)),
                t_qpb.qpb_solve(problem(name), t_qpb.QPBControl(maxit=k)))
    return (j_qpa.qpc_solve(jq, qpa_ctl=j_qpa.QPAControl(maxit=k)),
            t_qpa.qpc_solve(problem(name), qpa_ctl=t_qpa.QPAControl(maxit=k)))


def same_pass(j, t, solver):
    if rel(np.asarray(j.x), t.x) > 1e-12:
        return False
    if solver == "qpb":
        return float(j.res_c) == float(t.res_c)
    return (np.array_equal(np.asarray(j.c_stat), t.c_stat.numpy())
            and np.array_equal(np.asarray(j.b_stat), t.b_stat.numpy()))


@pytest.mark.parametrize("name,solver", sorted(k for k in PARTS if k[1] == "qpb"))
def test_partings_are_shown(name, solver):
    """A parting run: the pass before ``PARTS`` equal in both packages (x
    within 1e-12 and the same mu or working set), the pass itself not."""
    p = PARTS[(name, solver)]
    j, t = jax_port_pair(name, solver, p - 1)
    assert same_pass(j, t, solver), (name, solver, p - 1)
    j, t = jax_port_pair(name, solver, p)
    assert not same_pass(j, t, solver), (name, solver, p)


def test_qpc_on_qpmixb_starts_from_the_ipms_cap():
    """QPC's parting on QPMIXB: both IPMs stop at their cap with points 6e-3
    apart (beyond the roundoff of a converged solve), and QPA's working sets
    differ at its first pass."""
    from galahad_tpu.qp.ipm import ipm_solve as j_ipm

    from galahad_tpu_torch.qp.ipm import ipm_solve as t_ipm

    jq = j_qplib.read_qp(sweep_path("QPMIXB"))
    xj, _, _, sj = j_ipm(jq)
    xt, _, _, st = t_ipm(problem("QPMIXB"))
    assert (int(sj.status), int(sj.iter)) == (st.status, st.iter) == (-18, 200)
    assert np.abs(np.asarray(xj) - xt.numpy()).max() > 1e-3     # found 6.0e-3
    j, t = jax_port_pair("QPMIXB", "qpc", PARTS[("QPMIXB", "qpc")])
    assert not same_pass(j, t, "qpc")


def test_qpa_direct_with_a_warm_start():
    """``qpa_solve`` with a start and a working set (tests/test_qp_family.py's
    warm start): the JAX package's x, status, iterations and statuses."""
    name = "QPMAX"
    jq = j_qplib.read_qp(sweep_path(name))
    tq = problem(name)
    x0 = np.clip(np.zeros(tq.n), tq.x_l.numpy(), tq.x_u.numpy())
    b0 = np.where(x0 <= tq.x_l.numpy(), -1, 0)
    j = j_qpa.qpa_solve(jq, x0=jnp.asarray(x0), b_stat0=jnp.asarray(b0),
                        c_stat0=jnp.zeros(tq.m, jnp.int32))
    t = t_qpa.qpa_solve(tq, x0=torch.as_tensor(x0), b_stat0=torch.as_tensor(b0),
                        c_stat0=torch.zeros(tq.m, dtype=torch.int32))
    assert (j.status, j.iter) == (t.status, t.iter)
    assert rel(np.asarray(j.x), t.x) <= TOL
    assert np.array_equal(np.asarray(j.b_stat), t.b_stat.numpy())
    assert np.array_equal(np.asarray(j.c_stat), t.c_stat.numpy())
    assert t.host_reads == t.iter + 1


def test_lpqp():
    """The elastic reformulation of a fixture, solved by QPB in both packages
    (the JAX package's x, and the restored pieces)."""
    jq = j_qplib.read_qp(sweep_path("QPMAX"))
    tq = problem("QPMAX")
    jw = j_lpqp.lpqp_formulate(jq, 10.0)
    tw = t_lpqp.lpqp_formulate(tq, 10.0)
    for k in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u", "x"):
        assert rel(np.asarray(getattr(jw, k)), getattr(tw, k)) == 0.0, k
    assert (jw.name, jw.h_kind) == (tw.name, tw.h_kind)
    w = torch.linspace(0.0, 1.0, tw.n, dtype=torch.float64)
    x, u, v, _, z = t_lpqp.lpqp_restore(tq, w, zw=w)
    jx, ju, jv, _, jz = j_lpqp.lpqp_restore(jq, jnp.asarray(w.numpy()), zw=jnp.asarray(w.numpy()))
    assert all(rel(np.asarray(a), b) == 0.0 for a, b in ((jx, x), (ju, u), (jv, v), (jz, z)))
    assert float(t_lpqp.lpqp_violation(tq, w)) == pytest.approx(
        float(j_lpqp.lpqp_violation(jq, jnp.asarray(w.numpy()))), rel=1e-15)
    assert t_lpqp.lpqp_formulate(t_qplib.read_qp(sweep_path("BQP150"), device="cpu"),
                                 1.0).n == 150
