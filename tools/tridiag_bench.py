#!/usr/bin/env python3
"""The scalar tridiagonal LDL' kernels (csrc/tridiag.cu) at the shapes that
matter to them: their inputs and residual, used by chip_smoke.py, and this
command line, which times both kernels of a checkout of the port on one
CUDA device.

    python3 tools/tridiag_bench.py [--root DIR] [--layouts] [--chunks 2000,5657]

``--root`` is the checkout whose ``galahad_tpu_torch`` is imported (default:
the one holding this file), so that a parent commit unpacked beside it is
timed on the same data in the same call, each in its own process.  Shapes
(SHAPES): (a) the headline 1,024 systems of k = 64 (GLTR's itmax at the
reference's headline batch) in f64 and f32, (b) one system of k = 64 (the
Krylov shape), (c) 64 systems of k = 5,000, (d) one chain of 10^6 rows, f64.
One JSON line per kernel and shape: the device time of one call (calls
queued behind a spin kernel, so the host's launch rate does not enter), the
schedule (``tridiag_schedule``, where the checkout has it), its critical
path and the device time per step of it, and the solve's relative residual.
``--layouts`` times every layout of each kernel on each shape instead (the
solve's chunked layout at its default chunk and at those of ``--chunks``).
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from secular_bench import _events_ms  # noqa: E402

# name: (B, k, dtype); B = 0 is one unbatched system of shape (k,)
SHAPES = {"a_1024x64_float64": (1024, 64, torch.float64),
          "a_1024x64_float32": (1024, 64, torch.float32),
          "b_1x64_float64": (1, 64, torch.float64),
          "c_64x5000_float64": (64, 5000, torch.float64),
          "d_chain_1000000_float64": (0, 1_000_000, torch.float64)}
TARGET_MS = 60.0                     # reps of a timing: about this much device time
SPIN_CYCLES_PER_MS = 2_000_000       # torch.cuda._sleep at ~2 GHz


def tridiag_systems(B, k, dtype, seed=0, device="cuda"):
    """(d, e, b) of B symmetric tridiagonal systems of order k (B = 0: one
    system of shape (k,)), diagonally dominant (|d| in [2, 4], a fifth of
    them negative; |e| < 1), drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (B, k) if B else (k,)
    d = torch.rand(shape, generator=g, device=device, dtype=dtype) * 2.0 + 2.0
    d = torch.where(torch.rand(shape, generator=g, device=device) < 0.2, -d, d)
    e = torch.rand(shape[:-1] + (k - 1,), generator=g, device=device, dtype=dtype) * 2.0 - 1.0
    b = torch.randn(shape, generator=g, device=device, dtype=dtype)
    return d, e, b


def _residual(d, e, b, x):
    r = d * x - b
    r[..., 1:] += e * x[..., :-1]
    r[..., :-1] += e * x[..., 1:]
    return r


def tridiag_residual(d, e, b, x) -> float:
    """max |T x - b| / max |b|."""
    return float(_residual(d, e, b, x).abs().max() / b.abs().max())


def tridiag_rel_residual(d, e, b, x) -> float:
    """max |T x - b| / (||T||_inf max |x|): the chunked solve's criterion,
    within 10 x the sequential solve's + 1e-15."""
    norm = float(d.abs().max()) + 2.0 * float(e.abs().max())
    return float(_residual(d, e, b, x).abs().max()) / (norm * float(x.abs().max()))


def device_ms(fn, reps: int, spin_ms: float = 30.0) -> float:
    """Device ms of one ``fn()``: ``reps`` calls queued behind a spin kernel,
    so that they run back to back and the host's launch rate does not enter;
    taken again behind a spin four times as long where the host's enqueue
    outlasted it (a wrapper's host time can exceed its kernel's)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        t0 = time.perf_counter()
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms < 0.8 * spin_ms:
            break
        spin_ms *= 4
    return e0.elapsed_time(e1) / reps


def timed_ms(fn) -> float:
    """Device ms of one ``fn()``: reps (about TARGET_MS of device time in
    all, 2..20) by :func:`device_ms`."""
    fn()
    torch.cuda.synchronize()
    one = _events_ms(fn)
    reps = int(min(20, max(2, TARGET_MS // max(one, 1e-3))))
    return device_ms(fn, reps)


def bench(name, B, k, dtype, factor_kw=None, solve_kw=None) -> list:
    """Both kernels on shape ``name``: rows of device ms, schedule, critical
    path, us per step and the solve's residual; ``factor_kw`` / ``solve_kw``
    (layout, chunk) force a layout where the checkout's wrappers take it."""
    from galahad_tpu_torch.linalg import tridiag_kernels as tk

    d, e, b = tridiag_systems(B, k, dtype)
    Bn = max(B, 1)
    sched = tk.tridiag_schedule(Bn, k, dtype) if hasattr(tk, "tridiag_schedule") else None
    rows = []
    fkw, skw = factor_kw or {}, solve_kw or {}
    dh, l = tk.tridiag_factor(d, e, **fkw)
    x = tk.tridiag_solve(dh, l, b, **skw)
    for kernel, fn in (("tridiag_factor", lambda: tk.tridiag_factor(d, e, **fkw)),
                       ("tridiag_solve", lambda: tk.tridiag_solve(dh, l, b, **skw))):
        which = kernel.split("_")[1]
        if (fkw and which == "solve") or (skw and which == "factor"):
            continue                     # a forced layout times its own kernel only
        row = dict(kernel=kernel, shape=name, B=Bn, k=k, dtype=str(dtype)[6:],
                   device_ms=timed_ms(fn))
        if sched is not None:
            lay = sched[which]
            if which == "factor" and fkw:
                lay = tk.factor_layout(Bn, k, dtype, fkw["layout"])
            if which == "solve" and skw:
                lay = tk.solve_layout(Bn, k, dtype, skw.get("layout") or "chunked",
                                      skw.get("chunk"))
            row["schedule"] = lay
            row["critical_path_steps"] = lay["critical_path_steps"]
        else:
            row["critical_path_steps"] = k - 1 if which == "factor" else 2 * k - 1
        row["device_us_per_step"] = row["device_ms"] * 1e3 / max(row["critical_path_steps"], 1)
        if which == "factor":
            row["device_us_per_row"] = row["device_ms"] * 1e3 / k
        else:
            row["residual"] = tridiag_residual(d, e, b, x)
        rows.append(row)
    return rows


def layout_options(B, k, dtype, chunks) -> list:
    """(factor_kw, solve_kw) of every layout on (B, k): factor batch and
    chain, solve batch and chunked (its default chunk and ``chunks``)."""
    out = [(dict(layout=f), None) for f in ("batch", "chain")]
    out += [(None, dict(layout="batch")), (None, dict(layout="chunked"))]
    out += [(None, dict(layout="chunked", chunk=c)) for c in chunks if c < k]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   ".."))
    ap.add_argument("--layouts", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--chunks", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        print("tridiag_bench: no CUDA device", file=sys.stderr)
        return 2
    from galahad_tpu_torch.linalg import tridiag_kernels as tk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    tk._library()
    base = dict(card=card, root=os.path.abspath(args.root))
    chunks = [int(c) for c in args.chunks.split(",") if c]
    forced = "layout" in inspect.signature(tk.tridiag_factor).parameters
    for name in args.shapes.split(","):
        B, k, dtype = SHAPES[name]
        options = layout_options(max(B, 1), k, dtype, chunks) if args.layouts and forced \
            else [(None, None)]
        for fkw, skw in options:
            for row in bench(name, B, k, dtype, fkw, skw):
                if fkw or skw:
                    row["forced"] = fkw or skw
                print(json.dumps(dict(base, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
