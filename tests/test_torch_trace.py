"""The port's span recorder (galahad_tpu_torch/core/trace.py): totals and
counters, no annotation without a profiler, and the spans of a small sparse
``ipm_solve`` nested under its ``ipm.solve`` in a CPU profiler's trace."""
import numpy as np
import pytest
import torch

from galahad_tpu_torch import make_sparse_qp
from galahad_tpu_torch.core import trace
from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve

from _torch_port_helpers import grid_qp_arrays, inside, profiled_spans


@pytest.fixture
def fresh():
    trace.reset()
    yield
    trace.reset()


def test_nesting_and_totals(fresh):
    with trace.span("outer") as outer:
        for _ in range(3):
            with trace.span("inner") as inner:
                sum(range(1000))
    tot = trace.totals()
    assert tot["outer"][0] == 1 and tot["inner"][0] == 3
    assert tot["outer"][1] == pytest.approx(outer.seconds)
    assert outer.t0 <= inner.t0 < inner.t1 <= outer.t1
    assert 0 < tot["inner"][1] <= tot["outer"][1]
    with pytest.raises(ValueError):
        with trace.span("raises"):
            raise ValueError("the span is closed and counted all the same")
    assert trace.totals()["raises"][0] == 1


def test_count_adds(fresh):
    trace.count("a")
    trace.count("a", 3)
    trace.count("b", 0)
    assert trace.counters() == {"a": 4, "b": 0}
    trace.reset()
    assert trace.counters() == {} and trace.totals() == {}


def test_no_annotation_without_a_profiler(fresh, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with trace.span("quiet"):
        pass
    assert opened == [] and trace.totals()["quiet"][0] == 1

    def loud():
        with trace.span("loud"):
            pass

    _, spans = profiled_spans(loud)
    assert opened == [trace.PREFIX + "loud"]
    assert [s[0] for s in spans] == ["loud"]


def test_a_sparse_solve_nests_its_spans_under_ipm_solve(fresh):
    n, m, kw = grid_qp_arrays(5)
    qp = make_sparse_qp(n, m, device="cpu", **kw)
    (x, y, z, st), spans = profiled_spans(lambda: ipm_solve(qp, IPMControl()))
    assert st.status == 0 and st.run.path == "direct"
    roots = [s for s in spans if s[0] == "ipm.solve"]
    assert len(roots) == 1
    assert all(inside(s, roots[0]) for s in spans)
    names = [s[0] for s in spans]
    direct = [s for s in spans if s[0] == "stepper.direct"]
    assert len(direct) == st.run.direct_steps == st.iter > 0
    assert names.count("stepper.fetch") == st.run.fetches
    for name in ("ipm.prepare", "ipm.finish", "stepper.release"):
        assert names.count(name) == 1
    # the step's phases: as many in every direct step; the products outside
    # the steps belong to the start point and the solution
    ends = [s for s in spans if s[0] in ("ipm.prepare", "ipm.finish")]
    for name in ("kkt.assemble", "kkt.factor", "kkt.solve", "coo.matvec"):
        mine = [s for s in spans if s[0] == name]
        per_step = {sum(inside(s, d) for s in mine) for d in direct}
        assert len(per_step) == 1 and per_step.pop() > 0, name
        assert all(any(inside(s, o) for o in direct + ends) for s in mine), name
    # the refinement's products sit inside the solves
    solves = [s for s in spans if s[0] == "kkt.solve"]
    assert any(inside(c, k) for c in spans if c[0] == "coo.matvec" for k in solves)
    # the recorder's own totals agree with the trace
    tot = trace.totals()
    for name in set(names):
        assert tot[name][0] == names.count(name), name
    # PhaseTimes.analyse is the plan lookup's span; the analysis itself runs
    # once per pattern, inside it
    assert names.count("ipm.analyse") == 1
    assert st.inform.time.analyse == tot["ipm.analyse"][1]
    assert all(inside(s, a) for s in spans if s[0] == "sbls.analyse"
               for a in spans if a[0] == "ipm.analyse")
