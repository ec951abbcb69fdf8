"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over a few
requests, reduced to the device's busy time, each kernel's device time and
the longest idle gaps by what the host was doing in them."""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
WINDOW = "portbench.traced_window"
LABEL_SCAN = 4000            # host events looked at, backwards, to name a gap


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    base = name.split("(")[0]
    return re.sub(r"^void ", "", base)


class Trace:
    """What the reduction keeps: ``window_s`` (the traced window on the
    profiler's clock), ``busy_s`` (the union of device activity in it),
    ``kernels`` (name -> [seconds, count], full names) and the breakdown."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace has no window annotation")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = []
        self.kernels = defaultdict(lambda: [0.0, 0])
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            rec = self.kernels[e["name"]]
            rec[0] += (b - a) * 1e-6
            rec[1] += 1
        dev.sort()
        merged = []
        for a, b in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                      for e in events
                      if e.get("cat") in HOST_CATS and e.get("name") != WINDOW and "ts" in e)
        starts = [h[0] for h in host]
        by_label = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label = "host: no operation recorded"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - LABEL_SCAN, -1), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            by_label[label] += (b - a) * 1e-6
        per_kernel = defaultdict(float)
        for name, (sec, _) in self.kernels.items():
            per_kernel[short_name(name)] += sec
        self.breakdown = dict(
            device_ops=[[k, v] for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]],
            idle_gaps=[[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]])

    def device_seconds(self, pattern: str, exclude: str = None):
        """(seconds, count) of the device activity whose full name matches the
        regular expression ``pattern`` (and not ``exclude``)."""
        sec = cnt = 0
        for name, (s, c) in self.kernels.items():
            if re.search(pattern, name) and not (exclude and re.search(exclude, name)):
                sec += s
                cnt += c
        return sec, cnt


def traced(fn):
    """Run ``fn()`` under the profiler (host and, on the card, device
    activity) and return (its result, the :class:`Trace`)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as d:
        with torch.profiler.profile(activities=acts) as prof:
            if cuda:
                torch.cuda.synchronize()
            with torch.profiler.record_function(WINDOW):
                out = fn()
                if cuda:
                    torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    tr = Trace(events)
    tr.reduce_s = time.perf_counter() - t0
    return out, tr
