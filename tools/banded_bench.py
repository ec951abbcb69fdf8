#!/usr/bin/env python3
"""Time the block-tridiagonal factor and solve kernels of a checkout of the
port on one CUDA device, on synthetic block-diagonally dominant matrices.

    python3 tools/banded_bench.py [--root DIR] [--shapes 2500x8,2500x1] [--dtype float64]

``--root`` is the checkout whose ``galahad_tpu_torch`` is imported (default:
this one), so that two commits can be timed in one call, each in its own
process.  For each k x b: the device time of one factorization and of one
solve with one right-hand side (CUDA events around ``--reps`` calls queued
back to back behind a spin kernel, divided by ``--reps``), per block row and
per critical-path step where the solve reports its schedule (``--chunks``:
the solve also at those chunk sizes), and both
results against the plain versions (max abs error) at k <= 2,500.  Prints
one JSON line per shape.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys


def factor_fit(k, chunks, time_ms):
    """The factor's device ms at chunk sizes ``chunks`` (a comma list or
    "auto") and at one chunk of k rows, and the least-squares costs (us) of
    ``launch + (fold + step) m + hop (P - 2)`` over the chunked sizes."""
    import numpy as np

    if chunks == "auto":
        m0 = math.sqrt(k)
        sizes = sorted({max(1, round(m0 * f)) for f in (0.25, 0.5, 0.75, 1, 1.5, 2, 4)})
    else:
        sizes = [int(c) for c in chunks.split(",")]
    sizes = [m for m in sizes if m < k]
    ms = {m: time_ms(m) for m in sizes}
    step = time_ms(k) / k * 1e3
    out = dict(factor_device_ms_by_chunk=ms, factor_us_per_chain_step=step)
    if len(sizes) >= 3:
        A = np.array([[1.0, m, max(-(-k // m) - 2, 0)] for m in sizes])
        us = np.array([ms[m] * 1e3 for m in sizes])
        launch, both, hop = np.linalg.lstsq(A, us, rcond=None)[0]
        out.update(factor_costs_us=[step, float(both) - step, float(hop), float(launch)])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   ".."))
    ap.add_argument("--shapes", default="2500x8,2500x1,125000x8")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--chunks", default="",
                    help="solve chunk sizes to time besides the default, e.g. 36,50,100")
    ap.add_argument("--factor-chunks", default="",
                    help="factor chunk sizes to time and fit, e.g. 100,200,400, or auto")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from galahad_tpu_torch.linalg import banded_kernels as bk
    from galahad_tpu_torch.linalg.banded import (BlockTridiagFactors,
                                                 block_tridiag_cholesky_plain,
                                                 block_tridiag_solve_plain)

    if not torch.cuda.is_available():
        print("banded_bench: no CUDA device", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    bk._library()

    def device_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)                # keep the card busy while the host enqueues
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    for shape in args.shapes.split(","):
        k, b = map(int, shape.split("x"))
        rng = np.random.default_rng(k + b)
        L = rng.uniform(-1.0, 1.0, (k - 1, b, b))
        G = rng.uniform(-1.0, 1.0, (k, b, b))
        D = G @ G.transpose(0, 2, 1) + 3.0 * b * np.eye(b)
        D = torch.as_tensor(D, device="cuda").to(dtype).contiguous()
        L = torch.as_tensor(L, device="cuda").to(dtype).contiguous()
        rhs = torch.as_tensor(rng.normal(size=(k, b)), device="cuda").to(dtype)
        chunked = hasattr(bk, "default_factor_chunk")

        def factor(chunk=None):
            return bk.block_tridiag_factor(D, L, chunk=chunk) if chunked else \
                bk.block_tridiag_factor(D, L)

        Ld, Lo, ok = factor()
        f_ms = device_ms(factor, args.reps)
        Ls, Los, _ = factor(k)
        torch.cuda.synchronize()
        bits = hashlib.sha256(Ls.cpu().numpy().tobytes() + Los.cpu().numpy().tobytes())
        s_ms = device_ms(lambda: bk.block_tridiag_solve(Ld, Lo, rhs), args.reps)
        row = dict(card=card, root=os.path.abspath(args.root), k=k, b=b, dtype=args.dtype,
                   factor_device_ms=f_ms, factor_us_per_row=f_ms / k * 1e3,
                   solve_device_ms=s_ms, solve_us_per_row_and_direction=s_ms / (2 * k) * 1e3,
                   factor_bits=bits.hexdigest()[:16])
        if chunked:
            row.update(factor_chunk=bk.default_factor_chunk(k, b))
        if args.factor_chunks and chunked:
            row.update(factor_fit(k, args.factor_chunks, lambda c: device_ms(
                lambda: factor(c), max(2, args.reps // 4))))
        if hasattr(bk, "solve_schedule"):
            sched = bk.solve_schedule(k, bk.default_chunk(k))
            row.update(sched, solve_us_per_step=s_ms / sched["critical_path_steps"] * 1e3)
        if args.chunks and hasattr(bk, "solve_schedule"):
            row["solve_device_ms_by_chunk"] = {
                c: device_ms(lambda: bk.block_tridiag_solve(Ld, Lo, rhs, chunk=c), args.reps)
                for c in map(int, args.chunks.split(","))}
        if k <= 2500:
            fp = block_tridiag_cholesky_plain(D, L)
            x = bk.block_tridiag_solve(Ld, Lo, rhs)
            xp = block_tridiag_solve_plain(BlockTridiagFactors(Ld, Lo, ok), rhs)
            row.update(factor_err=max(float((Ld - fp.Ld).abs().max()),
                                      float((Lo - fp.Lo).abs().max()) if k > 1 else 0.0),
                       solve_err=float((x - xp).abs().max()), ok=bool(ok))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
