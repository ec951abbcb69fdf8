"""The reduction of a trace to the program's spans (program_trace.py) on a
fixed synthetic event list worked by hand, beside ``tracing.Trace`` on the
same list (its fields pinned to their values)."""
import pytest

from portbench import program_trace, tracing

US = 1e-6


def span(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name="galahad::" + name, ts=ts, dur=dur,
                pid=1, tid=1)


def launch(name, ts, corr):
    return dict(ph="X", cat="cuda_runtime", name=name, ts=ts, dur=2, pid=1, tid=1,
                args=dict(correlation=corr))


def device(cat, name, ts, dur, corr):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=0, tid=7,
                args=dict(correlation=corr))


# a window of 1,000 us: a solve with one direct step (assembly, a product),
# one replay of the graph and its fetch; a copy before the solve
EVENTS = [
    dict(ph="X", cat="user_annotation", name=tracing.WINDOW, ts=0, dur=1000, pid=1, tid=1),
    span("ipm.solve", 100, 800),
    span("stepper.direct", 150, 250),
    span("kkt.assemble", 160, 40),
    span("coo.matvec", 250, 50),
    span("stepper.replays", 450, 10),
    span("stepper.fetch", 460, 240),
    dict(ph="X", cat="cpu_op", name="aten::empty", ts=700, dur=150, pid=1, tid=1),
    launch("cudaMemcpyAsync", 50, 4),
    launch("cudaLaunchKernel", 170, 1),
    launch("cudaLaunchKernel", 260, 2),
    launch("cudaGraphLaunch", 455, 3),
    device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60, 20, 4),
    device("kernel", "void assemble_kernel<double>(double*)", 210, 50, 1),
    device("kernel", "void segment_reduce<double>(double*)", 300, 20, 2),
    device("kernel", "void ldlt_wide_kernel<double>(double*)", 470, 130, 3),
    device("kernel", "void sweep_wave<double>(double*)", 600, 50, 3),
    # a kernel that ends after the window: clipped at its edge
    device("kernel", "void sweep_wave<double>(double*)", 990, 30, 3),
]

# the window's idle gaps, as Trace finds them (the device busy 60-80, 210-260,
# 300-320, 470-650 and 990-1000)
GAPS = [(0, 60), (80, 210), (260, 300), (320, 470), (650, 990)]


def table(events, gaps=GAPS):
    return program_trace.table(events, 0.0, 1000.0, gaps)


def test_trace_fields_as_pinned():
    tr = tracing.Trace(EVENTS)
    assert tr.window_s == pytest.approx(1000 * US)
    assert tr.busy_s == pytest.approx(280 * US)
    assert {k: (pytest.approx(s), c) for k, (s, c) in tr.kernels.items()} == {
        "Memcpy HtoD (Pageable -> Device)": (20 * US, 1),
        "void assemble_kernel<double>(double*)": (50 * US, 1),
        "void segment_reduce<double>(double*)": (20 * US, 1),
        "void ldlt_wide_kernel<double>(double*)": (130 * US, 1),
        "void sweep_wave<double>(double*)": (60 * US, 2)}
    ops = dict(tr.breakdown["device_ops"])
    assert ops["ldlt_wide_kernel<double>"] == pytest.approx(130 * US)
    assert ops["sweep_wave<double>"] == pytest.approx(60 * US)
    # each gap under the latest host event open at its midpoint
    gaps = {k: pytest.approx(v) for k, v in tr.breakdown["idle_gaps"]}
    assert gaps == {"host: no operation recorded": 60 * US,       # 0-60
                    "galahad::ipm.solve": 130 * US,                  # 80-210
                    "galahad::coo.matvec": 40 * US,                  # 260-300
                    "galahad::stepper.direct": 150 * US,             # 320-470
                    "aten::empty": 340 * US}                         # 650-990


def test_gaps_by_exact_overlap_with_the_innermost_span():
    rows = table(EVENTS)
    idle = {p: pytest.approx(r["idle_s"]) for p, r in rows.items() if r["idle_s"]}
    assert idle == {
        "outside": (60 + 20 + 90) * US,                          # 0-60, 80-100, 900-990
        "ipm.solve": (50 + 50 + 200) * US,                       # 100-150, 400-450, 700-900
        "ipm.solve/stepper.direct": (10 + 10 + 80) * US,         # 150-160, 200-210, 320-400
        "ipm.solve/stepper.direct/kkt.assemble": 40 * US,        # 160-200
        "ipm.solve/stepper.direct/coo.matvec": 40 * US,          # 260-300
        "ipm.solve/stepper.replays": 10 * US,                    # 450-460
        "ipm.solve/stepper.fetch": (10 + 50) * US}               # 460-470, 650-700
    tr = tracing.Trace(EVENTS)
    assert sum(r["idle_s"] for r in rows.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert rows["ipm.solve/stepper.direct"]["calls"] == 1
    assert rows["outside"]["calls"] == 0


def test_device_time_by_the_launch_correlation():
    rows = table(EVENTS)
    dev = {p: pytest.approx(r["device_s"]) for p, r in rows.items() if r["device_s"]}
    assert dev == {"outside": 20 * US,
                   "ipm.solve/stepper.direct/kkt.assemble": 50 * US,
                   "ipm.solve/stepper.direct/coo.matvec": 20 * US,
                   # every kernel of the graph's launch, the clipped one too
                   "ipm.solve/stepper.replays": (130 + 50 + 10) * US}
    tr = tracing.Trace(EVENTS)
    assert sum(r["device_s"] for r in rows.values()) == pytest.approx(
        sum(s for s, _ in tr.kernels.values()))


def test_phase_metrics():
    m = program_trace.phase_metrics(table(EVENTS), 1000 * US)
    assert m["stepper_idle_share"] == pytest.approx(0.18)
    assert m["loop_idle_share"] == pytest.approx(0.37)
    assert m["kkt_assembly_ms"] == pytest.approx(0.05)
    assert m["coo_matvec_ms"] == pytest.approx(0.02)


def test_a_child_that_starts_with_its_parent_is_inside_it():
    events = [EVENTS[0], span("ipm.solve", 100, 100), span("ipm.prepare", 100, 50)]
    rows = table(events, [(0, 1000)])
    assert rows["ipm.solve/ipm.prepare"]["idle_s"] == pytest.approx(50 * US)
    assert rows["ipm.solve"]["idle_s"] == pytest.approx(50 * US)


def test_a_program_without_spans():
    events = [e for e in EVENTS if not e["name"].startswith("galahad::")]
    rows = table(events)
    tr = tracing.Trace(events)
    assert list(rows) == ["outside"]
    assert rows["outside"]["idle_s"] == pytest.approx(tr.window_s - tr.busy_s)
    assert set(program_trace.phase_metrics(rows, tr.window_s).values()) == {None}
