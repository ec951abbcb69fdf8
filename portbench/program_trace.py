"""The program's spans in a device trace: the port's span recorder
(``galahad_tpu_torch/core/trace.py``) opens ``record_function("galahad::" +
name)`` while a profiler runs, so its spans lie on the clock of the device's
events.  ``table(events, w0, w1, gaps)`` reduces a trace's events to a row per
span path (the names of the open spans from the outermost to the innermost,
joined by ``/``; ``outside`` where none is open).  It takes the traced
window's bounds and its idle gaps from ``tracing.Trace``, which computes them
already, and does not recompute them; nothing calls it yet: it waits for the
one line in ``Trace.__init__`` that stores ``table(events, w0, w1, gaps)`` as
``self.program``.  Its rows:

- ``calls``: spans whose own path this is;
- ``idle_s``: the seconds of the traced window in which the device ran no
  kernel, copy or memset, charged by exact overlap to the innermost span open
  on the host at each moment;
- ``device_s``: the device seconds (clipped to the window) of every kernel,
  copy and memset whose launching runtime call, matched by the events'
  ``correlation``, started inside the span, charged to the innermost one.
  The kernels of a replayed CUDA graph belong to its ``cudaGraphLaunch``, so
  to ``stepper.replays``; only a direct step's launches reach the step's
  phase spans.

The rows' ``idle_s`` add up to the window's idle time and their ``device_s``
to the device seconds of ``tracing.Trace.kernels``.  A trace with no program
span (a program without the recorder) has the one row ``outside``.
``phase_metrics`` turns a table into the per-layer numbers PERF.md names."""
from __future__ import annotations

import bisect
from collections import defaultdict

from .tracing import DEVICE_CATS

PREFIX = "galahad::"
LAUNCH_CATS = ("cuda_runtime",)
OUTSIDE = "outside"
STEPPER = ("stepper.direct", "stepper.capture", "stepper.release")


def _spans(events: list) -> list:
    """(start, end, path) of every program span, ordered by start (a parent
    before a child that starts with it)."""
    raw = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e["name"][len(PREFIX):]) for e in events
                  if e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(PREFIX)),
                 key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for a, b, name in raw:
        while stack and stack[-1][1] <= a:
            stack.pop()
        path = (stack[-1][2] + "/" if stack else "") + name
        stack.append((a, b, path))
        out.append((a, b, path))
    return out


def _segments(spans: list) -> list:
    """Disjoint (start, end, path) pieces of time, each with the path of the
    innermost span open in it (the open span that started last)."""
    points = sorted({t for a, b, _ in spans for t in (a, b)})
    starts = sorted(range(len(spans)), key=lambda i: spans[i][0])
    ends = sorted(range(len(spans)), key=lambda i: spans[i][1])
    open_, si, ei, segs = {}, 0, 0, []
    for t0, t1 in zip(points, points[1:]):
        while si < len(starts) and spans[starts[si]][0] <= t0:
            open_[starts[si]] = spans[starts[si]]
            si += 1
        while ei < len(ends) and spans[ends[ei]][1] <= t0:
            open_.pop(ends[ei], None)
            ei += 1
        if open_:
            path = max(open_.values(), key=lambda s: (s[0], -s[1]))[2]
            if segs and segs[-1][2] == path and segs[-1][1] == t0:
                segs[-1][1] = t1
            else:
                segs.append([t0, t1, path])
    return segs


def _row() -> dict:
    return dict(calls=0, idle_s=0.0, device_s=0.0)


def table(events: list, w0: float, w1: float, gaps: list) -> dict:
    """path -> dict(calls, idle_s, device_s) of a trace's events (module doc),
    given the window's bounds ``w0``, ``w1`` and its idle ``gaps`` ((start,
    end) pairs) in the trace's microseconds, as ``tracing.Trace`` finds them."""
    spans = _spans(events)
    segs = _segments(spans)
    seg_starts = [s[0] for s in segs]
    rows = defaultdict(_row)
    rows[OUTSIDE] = _row()
    for _, _, path in spans:
        rows[path]["calls"] += 1

    def path_at(t: float) -> str:
        i = bisect.bisect_right(seg_starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else OUTSIDE

    # idle: every gap split at the segments' edges
    for a, b in gaps:
        covered = 0.0
        i = max(bisect.bisect_right(seg_starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                rows[segs[i][2]]["idle_s"] += (hi - lo) * 1e-6
                covered += hi - lo
            i += 1
        rows[OUTSIDE]["idle_s"] += (b - a - covered) * 1e-6

    # device time, by the span open at its launch
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[corr] = float(e["ts"])
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        t = launched.get((e.get("args") or {}).get("correlation"))
        rows[OUTSIDE if t is None else path_at(t)]["device_s"] += (b - a) * 1e-6
    return dict(rows)


def _names(path: str) -> list:
    return path.split("/")


def phase_metrics(program: dict, window_s: float) -> dict:
    """The per-layer numbers of a table (``None`` where the trace holds no
    span they read): the device's idle share under the fused stepper's own
    spans (direct step, capture, release), and under ``ipm.solve`` outside
    them (the host loop: fetch turnarounds, preparation, finish), each over
    the window; the device ms per direct step launched inside
    ``kkt.assemble`` and inside ``coo.matvec`` within a direct step."""
    rows = {p: r for p, r in program.items() if p != OUTSIDE}
    direct = sum(r["calls"] for p, r in rows.items() if _names(p)[-1] == "stepper.direct")

    def idle(keep) -> float:
        return sum(r["idle_s"] for p, r in rows.items() if keep(_names(p)))

    def per_step_ms(name: str):
        mine = [r for p, r in rows.items()
                if _names(p)[-1] == name and "stepper.direct" in _names(p)]
        return 1e3 * sum(r["device_s"] for r in mine) / direct if mine and direct else None

    solved = any("ipm.solve" in _names(p) for p in rows)
    stepper = any(set(_names(p)) & set(STEPPER) for p in rows)
    return dict(
        stepper_idle_share=(idle(lambda ns: bool(set(ns) & set(STEPPER))) / window_s
                            if stepper and window_s > 0 else None),
        loop_idle_share=(idle(lambda ns: "ipm.solve" in ns and not set(ns) & set(STEPPER))
                         / window_s if solved and window_s > 0 else None),
        kkt_assembly_ms=per_step_ms("kkt.assemble"),
        coo_matvec_ms=per_step_ms("coo.matvec"))
