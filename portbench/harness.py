"""One run of one cell: set-up, a closed loop of ``ipm_solve`` requests over
the window, the traced requests, the judgement of every answer by the plain
reference, and the metrics that ``BENCHMARK.json`` names for the cell.

Everything that belongs to one configuration, traffic mix or metric is a file
found by its name: ``configs/<config>.json`` (which names its family),
``families/<family>.py`` (the generator and the host matrices the reference
reads), ``port/<kind>_qp.py`` (the port's problem type), ``traffic/<traffic>.json``
and ``metrics/<metric>.py`` (a ``read(run)`` that returns a number or None)."""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "galahad_tpu")
WARM_INDEX = 2 ** 40          # the warm-up request's stream, apart from the window's
LOWER = {"float64": "float32"}   # the control's precision: the nearest below
RELEASE_AT = 0.5              # share of the card's memory in reserve that makes the client release it


def load_module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def request_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of request ``index`` of a run with ``seed``."""
    state = np.random.SeedSequence([seed % 2 ** 64, index]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & (2 ** 63 - 1))
    return gen


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files loaded."""

    root: str
    spec: dict
    workload: dict
    config: dict
    traffic: dict

    @classmethod
    def load(cls, root: str, name: str) -> "Cell":
        spec = load_json(os.path.join(root, "BENCHMARK.json"))
        work = next((w for w in spec["workloads"] if w["name"] == name), None)
        if work is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in spec["configs"] if c["name"] == work["config"])
        return cls(root, spec, work, load_json(os.path.join(root, conf["file"])),
                   load_json(os.path.join(root, "portbench", "traffic",
                                          work["traffic"] + ".json")))

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.workload["name"] in metric["workloads"]

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"] if self._applies(m)]

    def per_layer(self) -> list:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self._applies(m) if "workloads" in m else m["moves"] in moved)]

    def module(self, *parts: str):
        path = os.path.join(self.root, "portbench", *parts)
        return load_module(path, "portbench_" + "_".join(parts).replace(".", "_"))


@dataclasses.dataclass
class Run:
    """What one run leaves for the metric readers: the window's requests and
    the traced ones (dicts of latency, iterations, ``RunStats`` fields and
    device launches by counter), the window's and set-up's seconds, the work
    the kernels need (the family's ``kernel_shapes``), how many kernel calls
    make one factorization or solve (the port's ``calls_per``) and the trace
    (``--trace 1``)."""

    cell: Cell
    dtype: str
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: list = dataclasses.field(default_factory=list)
    traced: list = dataclasses.field(default_factory=list)
    shapes: dict = None
    calls: dict = None
    trace: object = None


def _counters() -> dict:
    from galahad_tpu_torch.qp.fused import launch_counts

    return launch_counts()


def _solve(ipm_solve, qp, ctl) -> tuple:
    """One request: the solve and its answer copied to the host."""
    t0 = time.perf_counter()
    x, y, z, st = ipm_solve(qp, ctl)
    answer = dict(x=x.cpu().numpy(), y=y.cpu().numpy(), z=z.cpu().numpy(),
                  status=int(st.status))
    return time.perf_counter() - t0, answer, st


def _record(latency: float, st, before: dict, after: dict) -> dict:
    """A request's numbers.  The kernels' wrappers count a captured step once
    while it is captured; the card runs it in every replay."""
    run = st.run
    counted = {k: after[k] - before[k] for k in after}
    per = (run.launches_per_replay or {}) if run is not None else {}
    replays = run.replays if run is not None else 0
    launches = {k: counted[k] + (replays - 1) * per.get(k, 0) if replays else counted[k]
                for k in counted}
    return dict(latency_s=latency, iterations=int(st.iter), status=int(st.status),
                path=run.path if run is not None else None,
                capture_s=run.capture_s if run is not None else 0.0,
                replay_s=run.replay_s if run is not None else 0.0, replays=replays,
                halted_replays=run.halted_replays if run is not None else 0,
                launches=launches)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool, device,
             control: str = None, t_start: float = None, log=None) -> dict:
    """One run of the cell ``name``; returns the result object of the
    benchmark's last line.  ``control``: ``"lower_precision"`` runs the program
    in the precision below the configuration's (the control of ``correct``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = Cell.load(root, name)
    cfg, traffic = cell.config, cell.traffic
    if (traffic["loop"], traffic["clients"]) != ("closed", 1):
        raise ValueError(f"traffic {cell.workload['traffic']!r}: only a closed loop of one "
                         f"client is implemented")
    fam = cell.module("families", cfg["family"] + ".py")
    port = cell.module("port", fam.KIND + "_qp.py")
    from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve

    dtype = cfg["dtype"] if control is None else LOWER[cfg["dtype"]]
    tdt = getattr(torch, dtype)
    ctl = IPMControl(**traffic["control"], dtype=dtype)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run = Run(cell, dtype)

    total = torch.cuda.get_device_properties(device).total_memory if cuda else 0

    def release_cache() -> float:
        """The client's release of the allocator's cached blocks once they
        pass ``RELEASE_AT`` of the card, timed: the program leaves every
        solve's CUDA graph pool in reserve, and a process that re-solves
        without the release runs out of device memory after a few solves
        (PERF.md, Open questions)."""
        t = time.perf_counter()
        if cuda and torch.cuda.memory_reserved() > RELEASE_AT * total:
            torch.cuda.empty_cache()
        return time.perf_counter() - t

    # set-up: the structure, the first problem, the analysis, one warm-up solve
    marks = [("start", t_start)]
    st = fam.structure(cfg)
    base = port.base_problem(st, fam.values(cfg, st, request_generator(seed, WARM_INDEX, device),
                                            device), tdt, device)
    marks.append(("problem", time.perf_counter()))
    port.analyse(base)
    marks.append(("analysis", time.perf_counter()))
    _solve(ipm_solve, base, ctl)
    release_cache()
    sync()
    marks.append(("warm-up solve", time.perf_counter()))
    run.setup_s = time.perf_counter() - t_start
    log("set-up: " + ", ".join(f"{name} {t - marks[i][1]:.3f} s"
                               for i, (name, t) in enumerate(marks[1:])))

    def request(i: int) -> dict:
        vals = fam.values(cfg, st, request_generator(seed, i, device), device)
        qp = port.request_problem(base, vals)
        before = _counters()
        reserved = torch.cuda.memory_reserved() if cuda else 0
        latency, answer, state = _solve(ipm_solve, qp, ctl)
        rec = _record(latency, state, before, _counters())
        rec["reserved_growth"] = (torch.cuda.memory_reserved() if cuda else 0) - reserved
        rec["release_s"] = release_cache()
        rec["answer"] = answer
        return rec

    # the window: a closed loop of one client
    t0 = time.perf_counter()
    while True:
        run.requests.append(request(len(run.requests)))
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    if trace:
        from . import tracing

        n_traced = int(traffic["trace_requests"])
        first = len(run.requests)
        run.traced, run.trace = tracing.traced(
            lambda: [request(first + j) for j in range(n_traced)])
        for kname, (sec, cnt) in sorted(run.trace.kernels.items(), key=lambda kv: -kv[1][0])[:16]:
            log(f"trace kernel {cnt} x, {sec:.6f} s: {kname[:160]}")
        log("traced requests' device launches: " + json.dumps(
            [r["launches"] for r in run.traced]))
        log(f"trace: {n_traced} requests, window {run.trace.window_s:.6f} s, "
            f"busy {run.trace.busy_s:.6f} s, reduced in {run.trace.reduce_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        run.shapes = fam.kernel_shapes(cfg, st)
        run.calls = port.calls_per(base)
        log("the port's calls per factorization and solve: " + json.dumps(run.calls))
    del base
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the judgement, once the window has closed
    from . import reference

    limits = {k: float(v) for k, v in cfg["limits"].items()}
    t_judge = time.perf_counter()
    verdicts = []
    for i, rec in enumerate(run.requests + run.traced):
        vals = fam.values(cfg, st, request_generator(seed, i, device), device)
        p = fam.host_problem(st, {k: v.cpu().numpy() for k, v in vals.items()})
        verdicts.append(reference.judge(p, rec.pop("answer"), limits))
    failed = sum(not v["ok"] for v in verdicts)
    checks = {f"{k}_max": dict(value=max(v[k] for v in verdicts), limit=lim)
              for k, lim in limits.items()}
    checks["status_not_0"] = dict(value=sum(v["status"] != 0 for v in verdicts), limit=0)
    checks["bad_shape"] = dict(value=sum(not v["shaped"] for v in verdicts), limit=0)
    log(f"reference: {len(verdicts)} answers judged in {time.perf_counter() - t_judge:.3f} s")
    log("errors of each request (kkt, primal, dual, complementarity): " + json.dumps(
        [[v[k] for k in ("kkt", "primal", "dual", "complementarity")] for v in verdicts]))

    lat = [r["latency_s"] for r in run.requests]
    log("requests (latency_s, iterations, capture_s, replay_s, replays, reserved_growth, "
        "release_s): " + json.dumps(
            [[r[k] for k in ("latency_s", "iterations", "capture_s", "replay_s", "replays",
                             "reserved_growth", "release_s")] for r in run.requests]))
    p90 = float(np.percentile(lat, 90))
    log(f"window: {len(lat)} requests in {run.window_s:.6f} s, {sum(x > p90 for x in lat)} "
        f"beyond the 90th percentile; iterations {sorted({r['iterations'] for r in run.requests})}")
    wanted = cell.per_layer() if trace else cell.end_to_end()
    metrics = {}
    for m in wanted:
        value = cell.module("metrics", m["name"] + ".py").read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=1, memory_peak_bytes=int(peak))
    out = dict(correct=failed == 0 and len(verdicts) > 0, attempted=len(verdicts),
               failed=failed, metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = run.trace.breakdown
    if control:
        out["control"] = control
    for k, v in checks.items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    out["checks"] = checks
    return out
