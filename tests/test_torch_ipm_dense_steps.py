"""The dense step of the port's IPM (qp/ipm.py ``ipm_step`` on a ``QP``)
and the shift escalation that the driver runs for it (qp/fused.py), against
the JAX package.

What is held: step by step from the same JAX state, the same iteration,
status and flags and iterates within 1e-10 relative (Mehrotra and an arc);
the dense step makes no host read, and a step on a halted state, or one
whose Cholesky factorization fails at its first try, changes no bit (the
latter only sets ``needs_shift``); a problem that forces the shift (a
dense H with a zero row on a free variable that no constraint touches) gives the JAX package's status
and iterations, x within 1e-6, one counted escalation per iteration, and
the same bits with a fetch every 1 and every 4 iterations;
``steps_per_fetch=4`` and ``ipm_solve_compiled`` give the JAX package's
status and iterations, and the host loop's bits."""
import dataclasses

import numpy as np
import pytest
import torch

from galahad_tpu.qp import ipm as j_ipm

from galahad_tpu_torch.core.problem import classify_bounds
from galahad_tpu_torch.qp import ipm as t_ipm

from _torch_port_helpers import (check_same_solve, check_steps_from_reference_states, dense_pair,
                                 one_torch_thread, random_convex_qp_arrays)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def shifted_case(m):
    """random_convex_qp(8, m, seed=0) with the first variable free, in no
    constraint (the first column of A zeroed), with gradient 0 and the
    first row and column of H zeroed: G = H + D_x is singular at every
    iteration, so every first Cholesky try fails, while the problem stays
    well posed (a variable that a constraint touched would make the shifted
    Schur complement ill-conditioned to ~1/eps, where the two packages'
    iterates part)."""
    a = random_convex_qp_arrays(8, m, 0)
    a["H"][0, :] = 0.0
    a["H"][:, 0] = 0.0
    a["A"][:, 0] = 0.0
    a["x_l"][0], a["x_u"][0], a["g"][0] = -1e20, 1e20, 0.0
    return a


def bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.parametrize("arc", ["mehrotra", "taylor"])
def test_each_dense_step_matches_reference_from_the_same_state(arc):
    jq, tq = dense_pair(random_convex_qp_arrays(10, 6, 1, equalities=2))
    order = 3 if arc == "taylor" else 2
    js = check_steps_from_reference_states(
        jq, tq, j_ipm.IPMControl(arc=arc, series_order=order),
        t_ipm.IPMControl(arc=arc, series_order=order))
    assert bool(js.halt) and int(js.status) == 0


HOST_READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__float__", "__int__")


@pytest.mark.parametrize("case", ["m6", "m0", "shifted"])
def test_the_dense_step_makes_no_host_read(monkeypatch, case):
    """Every way a tensor reaches the host raises while the dense step runs
    (a CUDA graph could not capture it), the failed first try included."""
    arrays = (shifted_case(4) if case == "shifted"
              else random_convex_qp_arrays(10, 6 if case == "m6" else 0, 2))
    _, tq = dense_pair(arrays)
    masks = classify_bounds(tq)
    ctl = t_ipm.IPMControl()
    st = t_ipm.ipm_init(tq, masks, ctl)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read (or a copy from the host) inside the step")

    with monkeypatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse)
        # a tensor made from host data is a copy from the host on the card,
        # which a capture refuses (the dense step has no CPU-only plain code)
        for name in ("tensor", "as_tensor"):
            mp.setattr(torch, name, refuse)
        for _ in range(3):
            st = t_ipm.ipm_step(tq, masks, st, ctl)
    assert int(st.iter) == (0 if case == "shifted" else 3)
    assert bool(st.needs_shift) == (case == "shifted")


@pytest.mark.parametrize("why", ["halted", "at_maxit", "needs_shift"])
def test_a_dense_step_that_does_not_advance_is_a_no_op(why):
    arrays = shifted_case(4) if why == "needs_shift" else random_convex_qp_arrays(10, 6, 0)
    _, tq = dense_pair(arrays)
    masks = classify_bounds(tq)
    ctl = t_ipm.IPMControl(maxit=2 if why == "at_maxit" else 200)
    st = t_ipm.ipm_init(tq, masks, ctl)
    if why == "needs_shift":
        st = t_ipm.ipm_step(tq, masks, st, ctl, escalate=True)
    else:
        for _ in range(2):
            st = t_ipm.ipm_step(tq, masks, st, ctl)
    if why == "halted":
        st = dataclasses.replace(st, halt=torch.tensor(True))
    again = t_ipm.ipm_step(tq, masks, st, ctl)
    for name in t_ipm.TENSOR_FIELDS:
        if name == "needs_shift":
            assert bool(again.needs_shift) == (why == "needs_shift")
            continue
        assert torch.equal(bits(getattr(again, name)), bits(getattr(st, name))), name


@pytest.mark.parametrize("m", [0, 4])
def test_forced_escalation_matches_reference(m):
    jq, tq = dense_pair(shifted_case(m))
    st = check_same_solve(j_ipm.ipm_solve(jq, j_ipm.IPMControl()),
                          t_ipm.ipm_solve(tq, t_ipm.IPMControl()))
    assert st.status == 0
    assert st.run.escalations == st.iter >= 1
    # the failed first tries are the steps that changed nothing
    assert st.run.halted_replays == st.run.direct_steps + st.run.escalations - st.iter
    x1, y1, z1, _ = t_ipm.ipm_solve(tq, t_ipm.IPMControl())
    x4, y4, z4, s4 = t_ipm.ipm_solve(tq, t_ipm.IPMControl(steps_per_fetch=4))
    assert s4.iter == st.iter and s4.run.escalations == st.iter
    assert s4.run.direct_steps <= 4 * s4.run.fetches
    for a, b in ((x1, x4), (y1, y4), (z1, z4)):
        assert torch.equal(bits(a), bits(b))
    xc, yc, zc, sc = t_ipm.ipm_solve_compiled(tq, t_ipm.IPMControl())
    assert sc.iter == st.iter and sc.run.escalations == st.iter
    for a, b in ((x1, xc), (y1, yc), (z1, zc)):
        assert torch.equal(bits(a), bits(b))


def test_steps_per_fetch_4_and_compiled_match_reference():
    jq, tq = dense_pair(random_convex_qp_arrays(10, 6, 0, equalities=3))
    jctl = j_ipm.IPMControl(steps_per_fetch=4)
    st4 = check_same_solve(j_ipm.ipm_solve(jq, jctl),
                           t_ipm.ipm_solve(tq, t_ipm.IPMControl(steps_per_fetch=4)))
    assert st4.status == 0 and st4.run.fetches == -(-st4.iter // 4)
    xj, _, _, sj = j_ipm.ipm_solve_compiled(jq, j_ipm.IPMControl())
    xc, yc, zc, sc = t_ipm.ipm_solve_compiled(tq, t_ipm.IPMControl())
    assert (sc.status, sc.iter) == (int(sj.status), int(sj.iter)) == (0, st4.iter)
    assert np.abs(np.asarray(xj) - xc.numpy()).max() <= 1e-6
    assert sc.inform is None and sc.run.fetches == sc.iter
    x1, y1, z1, s1 = t_ipm.ipm_solve(tq, t_ipm.IPMControl())
    assert s1.iter == sc.iter
    for a, b in ((x1, xc), (y1, yc), (z1, zc)):
        assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("kind", ["x", "c", "shape"])
def test_bad_dense_input_returns_a_dense_scaffold(kind):
    a = random_convex_qp_arrays(6, 3, 0)
    if kind == "x":
        a["x_l"][2] = 5.0                      # above x_u = 1
    elif kind == "c":
        a["c_u"] = a["c_l"] - 1.0
    _, tq = dense_pair(a)
    if kind == "shape":
        tq = dataclasses.replace(tq, A=tq.A[:, :4])
    x, y, z, st = t_ipm.ipm_solve(tq)
    assert st.status == st.inform.status == (-3 if kind == "shape" else -4)
    assert st.iter == 0 and x.shape == (6,) and y.shape == (3,)
