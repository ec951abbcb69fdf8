"""The port's span recorder: named host-side spans and counters.

``span(name)`` is a context manager.  It adds its call count and host
seconds (``time.perf_counter_ns``) to a per-name total, and, while a
``torch.profiler`` profile runs and only then, opens
``torch.profiler.record_function("galahad::" + name)``, so that the span
shows in the profiler's trace as a user annotation on the clock of the
device's events (the benchmark's ``portbench/program_trace.py`` charges
the device's idle time and each launch's device time to the innermost
span open on the host).  A span never synchronises the device and is
legal while a CUDA graph is captured: it touches only the host.  Which
span is the parent of which, and which solve a span belongs to, follows
from nesting on the host thread: every span of a solve lies inside that
solve's one ``ipm.solve``.

``count(name, n)`` adds ``n`` to a per-name counter.  ``totals()``,
``counters()`` and ``reset()`` read and clear both tables (per process).

The names in use, from the entry down (PERF.md section 3 names what reads
each: ``RunStats`` / ``PhaseTimes``, ``chip_smoke.py``'s ``SOLVE_SPANS`` or a
metric of the benchmark):

  ipm.solve          one ``ipm_solve``
  ipm.prepare        ``check_qp``, ``classify_bounds``, ``ipm_init``
  ipm.analyse        the plan lookup of a sparse QP (``PhaseTimes.analyse``)
  ipm.finish         best-iterate recovery, the solution, indicators, inform
  sbls.analyse       a miss of ``sparse_kkt_plan``: the symbolic analysis
  stepper.direct     a step the host runs op by op
  stepper.capture    the capture of the step (child stepper.instantiate);
                     counter stepper.pool_bytes (the reserve's growth)
  stepper.replays    the host's enqueue of replays
  stepper.fetch      the monitor read, where the host waits
  stepper.release    the graph and its pool dropped
  kkt.assemble       the KKT values, their scaling, the factor's input
  kkt.factor         the numeric factorization
  kkt.solve          the solves with the factors, refinement included
  kkt.pcg            one PCG solve of a banded QP's Schur complement (inside
                     kkt.solve)
  coo.matvec         a product with a ``SparseQP``'s H, A or A'
"""
from __future__ import annotations

import threading
import time

import torch

PREFIX = "galahad::"

_lock = threading.Lock()
_totals: dict = {}       # name -> [calls, nanoseconds]
_counters: dict = {}     # name -> total


class span:
    """``with span(name) as s:`` times the block on the host; afterwards
    ``s.t0`` / ``s.t1`` (``perf_counter_ns``) bound it and ``s.seconds``
    is its length."""

    __slots__ = ("name", "t0", "t1", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.t0 = self.t1 = 0
        self._rf = None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        with _lock:
            rec = _totals.setdefault(self.name, [0, 0])
            rec[0] += 1
            rec[1] += self.t1 - self.t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def totals() -> dict:
    """name -> (calls, host seconds) of every span closed so far."""
    with _lock:
        return {k: (c, ns * 1e-9) for k, (c, ns) in _totals.items()}


def counters() -> dict:
    """name -> total of every counter."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Clear the spans' totals and the counters."""
    with _lock:
        _totals.clear()
        _counters.clear()
