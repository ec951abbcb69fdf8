"""The series arcs of the port's IPM (qp/ipm.py ``_series_arc``: "taylor",
"puiseux", "zhao_sun") on the sparse 6x6 grid QP, against the JAX package on
the same numpy-seeded inputs.

What is held: every (arc, order) of tests/test_ipm.py::TestTaylorArc gives
the same status and the SAME iteration count as the JAX package, the
objective within 1e-8 relative and x within 1e-6; the step of an arc makes
no host read (it runs inside the captured graph on the card) and a step on
a halted state changes no bit; the one ROOTS call over every family and
order equals the JAX package's per-family calls exactly.  Step-by-step
parity and the 20x20 grid are in tests/test_torch_ipm_arcs_steps.py, the
dense problems in tests/test_torch_ipm_arcs_dense*.py."""
import dataclasses

import numpy as np
import pytest
import torch

from galahad_tpu.qp import ipm as j_ipm

from galahad_tpu_torch.core.problem import classify_bounds
from galahad_tpu_torch.qp import ipm as t_ipm

from _torch_port_helpers import (ARC_CASES, arc_controls, check_same_solve,
                                 one_torch_thread, sparse_grid_pair)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_GRID6 = []


def grid6():
    if not _GRID6:
        _GRID6.append(sparse_grid_pair(6))
    return _GRID6[0]


@pytest.mark.parametrize("arc,order", ARC_CASES)
def test_grid6_matches_reference(arc, order):
    jq, tq = grid6()
    jctl, ctl = arc_controls(arc, order)
    st = check_same_solve(j_ipm.ipm_solve(jq, jctl), t_ipm.ipm_solve(tq, ctl))
    assert st.status == 0


HOST_READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__float__", "__int__")


@pytest.mark.parametrize("arc", ["taylor", "puiseux", "zhao_sun"])
def test_the_arc_step_makes_no_host_read(monkeypatch, arc):
    """Every way a tensor reaches the host raises while an arc's step runs;
    three steps and a step on a halted state still finish, and the halted
    step changes no bit."""
    _, tq = sparse_grid_pair(4)
    masks = classify_bounds(tq)
    ctl = t_ipm.IPMControl(arc=arc, series_order=4)
    st = t_ipm.ipm_step(tq, masks, t_ipm.ipm_init(tq, masks, ctl), ctl)
    true = torch.tensor(True)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside the step")

    with monkeypatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse)
        for _ in range(3):
            st = t_ipm.ipm_step(tq, masks, st, ctl)
        halted_in = dataclasses.replace(st, halt=true)
        halted = t_ipm.ipm_step(tq, masks, halted_in, ctl)
    assert int(st.iter) == 4 and int(halted.iter) == 4
    for name in t_ipm.TENSOR_FIELDS:
        a, b = getattr(halted, name), getattr(halted_in, name)
        assert torch.equal(a, b) and a.dtype == b.dtype, name


def test_roots_batched_over_families_equal_per_family():
    """The one ROOTS call over every family and order gives, order by order,
    exactly the minimum of one call per family and order (the JAX
    package's way)."""
    from galahad_tpu_torch.core.roots import roots_quartic, smallest_positive_root

    rng = np.random.default_rng(3)
    K, tau = 4, 0.995
    fams = []
    for size in (50, 50, 30, 7):
        v0 = torch.as_tensor(rng.uniform(0.01, 2.0, size))
        mask = torch.as_tensor(rng.uniform(size=size) < 0.8)
        fams.append((v0, [torch.as_tensor(rng.normal(size=size)) for _ in range(K)], mask))
    batched = t_ipm._arc_max_steps(fams, K, tau)
    for j in range(1, K + 1):
        best = torch.tensor(1.0, dtype=torch.float64)
        for v0, ds, mask in fams:
            a = [torch.where(mask, tau * v0, 1.0)] + [torch.where(mask, dk, 0.0)
                                                      for dk in ds[:j]]
            a += [torch.zeros_like(v0)] * (5 - len(a))
            best = torch.minimum(best, smallest_positive_root(*roots_quartic(*a)).min())
        assert torch.equal(batched[j - 1], best)
