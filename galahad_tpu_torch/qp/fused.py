"""The fused IPM iteration: one CUDA graph per solve, replayed once per
iteration.

Counterpart of how the JAX package runs its sparse IPM
(galahad_tpu/qp/ipm.py): ``ipm_solve`` dispatches ONE fused jitted
``ipm_step`` per iteration, ``_jitted_multi_step`` up to
``steps_per_fetch`` of them per dispatch, and ``ipm_solve_compiled`` the
whole solve as one ``while_loop``; the step decides convergence, the
failure guards and the rollback on the device.

Here the iteration is a function from state to state made of tensor code
with no host read (``ipm.ipm_step``).  On the card a
:class:`Stepper` runs the first iteration directly: that builds the
kernels, uploads the plan's tables and sets the kernels' attributes.  It
then captures the step ONCE as a ``torch.cuda.CUDAGraph`` on static state
buffers and replays the graph once per iteration; the step's allocations
(the factor store among them) come from the graph's pool.  The host reads
one small monitor tensor per fetch.  On the CPU, and on the card with
``GALAHAD_TPU_FUSED=0``, every step runs directly.  A failed capture
raises: nothing falls back to the direct step.

A dense QP's step takes each Cholesky factorization at its first try
only; where that fails the step changes nothing and sets a flag in the
state (``needs_shift``).  At the fetch that reads the flag the stepper
takes that iteration again directly, with the escalating shift (one host
read per try), writes the result into the state (the graph's static
buffers on the card) and goes on; every such step is counted in
``RunStats.escalations``.  With a fetch every k iterations, the replays
between the failed step and the fetch (at most k - 1) change nothing.

The kernels' wrappers count launches where they run: in a direct step and
once while the step is captured.  :class:`RunStats` keeps the counts of the
captured step (``launches_per_replay``) beside the number of replays, so
the launches a solve made on the card are the direct ones plus
``replays x launches_per_replay``.
"""
from __future__ import annotations

import dataclasses
import gc
import os

import torch

from ..core import trace
from ..linalg import banded_kernels, ea_kernels, ldlt_kernels, sweep_kernels


def fused_enabled() -> bool:
    """False when the environment sets ``GALAHAD_TPU_FUSED=0``: then the
    card, too, runs the step directly, one iteration per fetch (the JAX
    package's switch of the same name brings back its split step)."""
    return os.environ.get("GALAHAD_TPU_FUSED", "1") != "0"


def launch_counts() -> dict:
    """The kernel wrappers' counters: calls that launched their kernel,
    the kernel launches of calls that make several, and plain calls."""
    sw = sweep_kernels.sweep_counts()
    ea = ea_kernels.ea_counts()
    bd = banded_kernels.banded_counts()
    return dict(
        partial_ldlt=ldlt_kernels.launch_count(),
        ldlt_wide=ldlt_kernels.wide_launch_count(),
        ldlt_wide_plain=ldlt_kernels.wide_plain_count(),
        extend_add=ea["calls"], extend_add_kernels=ea["kernels"],
        extend_add_plain=ea["plain"],
        sweep_fwd=sw["fwd"], sweep_bwd=sw["bwd"],
        sweep_fwd_kernels=sw["fwd_kernels"], sweep_bwd_kernels=sw["bwd_kernels"],
        sweep_plain=sw["plain"],
        banded_factor=bd["factor"], banded_solve=bd["solve"],
        banded_factor_plain=bd["factor_plain"], banded_solve_plain=bd["solve_plain"])


@dataclasses.dataclass
class RunStats:
    """How a solve's iterations ran."""

    path: str                    # "graph" (captured once, replayed) or "direct"
    fetches: int = 0             # host reads of the monitor
    direct_steps: int = 0        # steps the host ran op by op
    replays: int = 0             # replays of the captured step
    halted_replays: int = 0      # steps that changed nothing: on a halted state, or
                                 # whose factorization needed a shift
    escalations: int = 0         # steps taken again with the escalating shift
    capture_s: float = 0.0       # capture and instantiation of the graph
    instantiate_s: float = 0.0   # of which the instantiation (capture_end)
    replay_s: float = 0.0        # wall from the first replay's launch to the last fetch
    launches_per_replay: dict = None   # counter moves while the step was captured
    sweep_checks: int = 0        # fetches after which every sweep level was checked


class Stepper:
    """Runs the iterations of ``step`` from the state ``st``.

    ``fields`` names the state's tensor fields (the step's inputs and
    outputs), ``monitor`` maps a state to its monitor tensor.  With
    ``graph=True`` (a state on the card) the first step runs directly and
    every later one is a replay of one capture.  ``sweep_levels``: the sweep
    tables of the solve, whose wait status is checked at every fetch.
    ``escalate``: None, or (a test of the monitor's values that is true
    where a step set the needs-shift flag, the step that takes a flagged
    iteration again with the escalating shift).  The state may be a batch
    (its monitor a row per problem): the step then maps over it."""

    def __init__(self, step, st, fields, monitor, graph: bool, sweep_levels=(),
                 escalate=None):
        self.step = step
        self.state = st
        self.fields = tuple(fields)
        self.monitor_of = monitor
        self.stats = RunStats(path="graph" if graph else "direct")
        self.sweep_levels = list(sweep_levels)
        self.escalate = escalate
        self._graph = None
        self._monitor = None
        self._t_replays = None

    def _copy(self, st):
        return dataclasses.replace(st, **{f: getattr(st, f).clone() for f in self.fields})

    def _capture(self) -> None:
        """Capture one step on static copies of the state's tensors.  The
        capture runs on a side stream that waits for the current one (the
        stream order that ``torch.cuda.graph`` keeps, without its device
        synchronisation, garbage collection and release of every cached
        block, which a solve does not need).  Python's collector is held
        off while the step is enqueued, so that no collection of the heap
        falls into the capture."""
        with trace.span("stepper.capture") as sp:
            device = getattr(self.state, self.fields[0]).device
            if device.index != torch.cuda.current_device():
                # the wrappers launch on the current stream of the state's device,
                # which would not be the capturing stream: refuse, do not capture less
                raise RuntimeError(f"the step is captured on the current CUDA device, and "
                                   f"the state lies on {device}: make it current first "
                                   f"(torch.cuda.set_device)")
            static = self._copy(self.state)
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            reserved = torch.cuda.memory_reserved(device)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin()
                    try:
                        new = self.step(static)
                        mon = self.monitor_of(new)
                        for f in self.fields:
                            getattr(static, f).copy_(getattr(new, f))
                    finally:
                        with trace.span("stepper.instantiate") as inst:
                            graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            trace.count("stepper.pool_bytes", torch.cuda.memory_reserved(device) - reserved)
            torch.cuda.current_stream().wait_stream(side)
            after = launch_counts()
            self.stats.launches_per_replay = {k: after[k] - before[k] for k in after}
        self.stats.instantiate_s = inst.seconds
        self.stats.capture_s = sp.seconds
        self.state, self._monitor, self._graph = static, mon, graph

    def advance(self, k: int) -> None:
        """Enqueue ``k`` iterations; no host read."""
        while k and self._graph is None:
            if self.stats.path == "graph" and self.stats.direct_steps:
                self._capture()
                break
            with trace.span("stepper.direct"):
                self.state = self.step(self.state)
            self.stats.direct_steps += 1
            k -= 1
        if k:
            with trace.span("stepper.replays") as sp:
                for _ in range(k):
                    self._graph.replay()
            if self._t_replays is None:
                self._t_replays = sp.t0
            self.stats.replays += k

    def release(self) -> None:
        """Drop the captured graph and, with it, its claim on its memory
        pool (the allocator keeps the pool's blocks in reserve until its
        cache is emptied), here rather than wherever Python frees the
        stepper.  The state stays readable."""
        with trace.span("stepper.release"):
            if self._graph is not None:
                self._graph.reset()
                self._graph = self._monitor = None

    def monitor(self):
        """The current state's monitor tensor (on the state's device)."""
        return self._monitor if self._graph is not None else self.monitor_of(self.state)

    def _fetched(self, t_ns: int) -> None:
        """Book a fetch whose read ended at ``t_ns`` (``perf_counter_ns``)."""
        self.stats.fetches += 1
        if self._t_replays is not None:
            self.stats.replay_s = (t_ns - self._t_replays) * 1e-9
        if self.sweep_levels:
            sweep_kernels.sweep_check(self.sweep_levels, synchronize=False)
            self.stats.sweep_checks += 1

    def _settle(self, values: list) -> list:
        """``values`` of the current state's monitor, or, where they show
        the needs-shift flag, those after the escalated step that takes the
        flagged iteration again (run directly; on the graph path its result
        is copied into the static buffers)."""
        if self.escalate is None or not self.escalate[0](values):
            return values
        new = self.escalate[1](self.state)
        self.stats.escalations += 1
        if self._graph is None:
            self.state = new
        else:
            for f in self.fields:
                getattr(self.state, f).copy_(getattr(new, f))
            self._monitor.copy_(self.monitor_of(new))
        return self.monitor().tolist()

    def fetch(self) -> list:
        """The one host read of a fetch: the current state's monitor, as
        Python numbers (a second read after an escalated step); then every
        sweep level's wait status is checked."""
        with trace.span("stepper.fetch") as sp:
            values = self._settle(self.monitor().tolist())
        self._fetched(sp.t1)
        return values

    def snapshot(self):
        """The current state, still valid after later iterations (a copy on
        the graph path, whose replays overwrite the static buffers)."""
        return self.state if self._graph is None else self._copy(self.state)

    def run_to_halt(self, stop) -> list:
        """Iterate until ``stop(values)`` holds for the monitor's values, and
        return them.  On the graph path replay i + 1 is enqueued before the
        host waits for replay i's monitor in pinned memory, so the card does
        not idle while the host reads; the replay after the last is a step
        on a halted state, which changes nothing.  Where a replay's monitor
        shows the needs-shift flag, the host waits for the replay after it
        (a step on the same flagged state, which changes nothing), takes the
        iteration again with the escalated step and starts the pipeline
        anew."""
        self.advance(1)
        values = self.fetch()
        if stop(values) or self.stats.path == "direct":
            while not stop(values):
                self.advance(1)
                values = self.fetch()
            return values
        like = self.monitor()
        host = torch.empty((2,) + tuple(like.shape), dtype=like.dtype, pin_memory=True)
        done = [torch.cuda.Event(), torch.cuda.Event()]

        def enqueue(slot):
            self.advance(1)
            host[slot].copy_(self.monitor(), non_blocking=True)
            done[slot].record()

        slot = 0
        enqueue(slot)
        while True:
            enqueue(1 - slot)
            with trace.span("stepper.fetch") as sp:
                done[slot].synchronize()
                values = host[slot].tolist()
                flagged = self.escalate is not None and self.escalate[0](values)
                if flagged:
                    done[1 - slot].synchronize()
                    values = self._settle(values)
            self._fetched(sp.t1)
            if stop(values):
                return values
            if flagged:
                enqueue(slot)          # the replay after the escalated step
            else:
                slot = 1 - slot
