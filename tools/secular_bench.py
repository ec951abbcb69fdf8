#!/usr/bin/env python3
"""The secular Newton kernels (csrc/secular.cu) at the shapes the ``tr``
phase gives them: their inputs and their timing, used by chip_smoke.py's
``kernels`` entries and by this command line, which times the kernels of a
checkout of the port on one CUDA device.

    python3 tools/secular_bench.py [--root DIR] [--layouts]

``--root`` is the checkout whose ``galahad_tpu_torch`` is imported (default:
the one holding this file), so that a parent commit unpacked beside it is
timed on the same data in the same call, each in its own process.  Shapes:
the reference's headline batch (1,024 TRS of n = 64, bench.py:94-97) as
trs_solve and rqs_solve (sigma = 1/radius, p = 3) hand it to the kernels, in
f64 and f32; and the Krylov shape, one problem of n = 64 whose tridiagonal T
holds KRYLOV_ROWS Lanczos rows and the 1e12 pad of gltr.py::padded_tridiagonal
after them.  ``--layouts`` instead times each layout the launcher accepts
against the one ``secular_schedule`` picks, on eigen-data drawn at
n in {32, 200, 1000, 20000} (a checkout with no ``secular_schedule`` times its
own layout only).  One JSON line per kernel, shape and layout: the device
time of one launch, the difference from the plain version, and where the
wrappers report them, the iteration counts (the critical path is the largest,
RQS's growth evaluations added) and the device time per critical-path step.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

TR_BATCH, TR_N = 1024, 64            # the reference's headline batch (bench.py:81)
KRYLOV_ROWS = 40                     # Lanczos rows of the padded Krylov-shape problem
REPS = 20
SPIN_CYCLES = 60_000_000             # ~30 ms of torch.cuda._sleep: longer than the enqueue
LAYOUT_SHAPES = ((32, 1), (32, TR_BATCH), (200, 1), (200, TR_BATCH), (1000, 1), (1000, 64),
                 (20_000, 1), (20_000, 8))


def headline_batch(dtype, device=None):
    """(H, c, radius) of the reference's headline batch (bench.py:94-97; the
    data of tools/make_trs_oracle.py): default_rng(0) draws B (1024, 64, 64)
    and then the radii U(0.1, 2.0), H = (B + B')/2, c = default_rng(1)."""
    rng = np.random.default_rng(0)
    B = rng.normal(size=(TR_BATCH, TR_N, TR_N))
    H = (B + np.swapaxes(B, -1, -2)) / 2
    radius = rng.uniform(0.1, 2.0, size=TR_BATCH)
    c = np.random.default_rng(1).normal(size=(TR_BATCH, TR_N))
    return tuple(torch.as_tensor(a, device=device or "cuda").to(dtype) for a in (H, c, radius))


def capture_secular_inputs(run):
    """The inputs ``run()`` gives the two secular kernels (their dispatch in
    tr/trs.py is wrapped while it runs): lists of argument tuples."""
    from galahad_tpu_torch.tr import trs as T

    got = dict(trs=[], rqs=[])
    orig = T._secular_newton, T._rqs_newton

    def trs(*a):
        got["trs"].append(a)
        return orig[0](*a)

    def rqs(*a):
        got["rqs"].append(a)
        return orig[1](*a)

    T._secular_newton, T._rqs_newton = trs, rqs
    try:
        run()
    finally:
        T._secular_newton, T._rqs_newton = orig
    return got


def solver_inputs(H, c, radius):
    """The kernels' inputs from trs_solve(H, c, radius) and rqs_solve(H, c,
    1/radius, p = 3)."""
    from galahad_tpu_torch.tr import rqs_solve, trs_solve

    return capture_secular_inputs(lambda: (trs_solve(H, c, radius),
                                           rqs_solve(H, c, 1.0 / radius, p=3.0)))


def krylov_secular_inputs():
    """The kernels' inputs at the Krylov solvers' shape: one problem of n =
    itmax = 64 whose T holds KRYLOV_ROWS Lanczos rows (default_rng(2)) and
    the 1e12 pad of gltr.py::padded_tridiagonal after them, as GLTR
    (trs_solve's dispatch) and GLRT (rqs_solve's, sigma = 1, p = 3) hand it
    over when the Krylov space ends early."""
    from galahad_tpu_torch.tr.gltr import padded_tridiagonal

    rng = np.random.default_rng(2)
    diag = torch.as_tensor(rng.normal(size=TR_N) * 2.0, device="cuda")
    off = torch.as_tensor(np.abs(rng.normal(size=TR_N - 1)) + 0.1, device="cuda")
    Tk = padded_tridiagonal(diag, off, KRYLOV_ROWS, TR_N)
    g = torch.zeros(TR_N, dtype=torch.float64, device="cuda")
    g[0] = 3.0
    return solver_inputs(Tk, g, 1.0)


def eigen_inputs(B, n, dtype, seed=0):
    """Both kernels' inputs on eigen-data drawn directly (no eigh, so that n
    may be large): lam sorted N(0, 9), ct = N(0, 1), radius U(0.1, 2.0);
    TRS at the cap 64, RQS at sigma = 1/radius, p = 3, the cap 96 and
    rqs_solve's first bracket."""
    from galahad_tpu_torch.tr import trs as T

    rng = np.random.default_rng(seed)
    lam = np.sort(rng.normal(size=(B, n)) * 3.0, axis=-1)
    ct = rng.normal(size=(B, n))
    radius = rng.uniform(0.1, 2.0, B)
    lam, ct, radius = (torch.as_tensor(a, device="cuda").to(dtype) for a in (lam, ct, radius))
    ct2 = ct * ct
    _, at_min, c_in_min = T._min_eigen(lam, ct, ct2, torch.finfo(dtype).eps)
    lam_lo = torch.clamp(-lam[:, 0], min=0.0)
    sigma = 1.0 / radius
    hi = lam_lo + sigma ** 0.5 * ct2.sum(-1) ** 0.25 + torch.clamp(lam_lo, min=1.0)
    return dict(trs=[(lam, ct2, radius, lam_lo, 64)],
                rqs=[(lam, ct2, at_min & ~c_in_min[..., None], sigma, 3.0, lam_lo, hi, 96)])


def kernel_call(name, args):
    """(lam, cap, kernel(**kw), plain()) of one captured call of kernel
    ``name`` ("trs" or "rqs")."""
    from galahad_tpu_torch.tr import secular_kernels as sk
    from galahad_tpu_torch.tr import trs as T

    if name == "trs":
        lam, ct2, radius, lam_lo, its = args
        radius = radius.expand(lam.shape[:-1])
        return (lam, its,
                lambda **kw: sk.trs_secular_newton(lam, ct2, radius, lam_lo, its, **kw),
                lambda: T.secular_newton_plain(lam, ct2, radius, lam_lo, its))
    lam, ct2, excl, sigma, p, lam_lo, hi0, its = args
    sigma = sigma.expand(lam.shape[:-1])
    return (lam, its,
            lambda **kw: sk.rqs_secular_newton(lam, ct2, excl, sigma, p, lam_lo, hi0, its, **kw),
            lambda: T.rqs_newton_plain(lam, ct2, excl, sigma, p, lam_lo, hi0, its))


def _events_ms(fn) -> float:
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def device_ms(fn, reps: int = REPS) -> float:
    """Device ms of one ``fn()``: ``reps`` calls queued behind a spin kernel,
    so that they run back to back and the host's launch rate does not enter."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    return _events_ms(lambda: [fn() for _ in range(reps)]) / reps


def rel_err(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) if ref.numel() else 0.0


@contextlib.contextmanager
def layout(schedule):
    """The wrappers lay their launches out by ``schedule`` (a layout the
    launcher accepts for their B and n) in place of ``secular_schedule``'s
    while this is open; None leaves them as they are."""
    from galahad_tpu_torch.tr import secular_kernels as sk

    if schedule is None:
        yield
        return
    own = sk.secular_schedule
    sk.secular_schedule = lambda B, n, dtype=None: schedule
    try:
        yield
    finally:
        sk.secular_schedule = own


def timing(name, args, schedule=None, plain=True) -> dict:
    """One kernel on one captured call: ``ms`` (events around REPS calls
    from the host), ``device_ms`` (:func:`device_ms`), the plain version's
    ``plain_ms`` (with ``plain``), the kernel's ``max_rel_err`` from it and,
    where the wrapper reports them, the iteration counts (percentiles,
    total), RQS's growth evaluations (the kernel's own count), the
    ``critical_path_steps`` and ``device_us_per_step``; laid out by
    ``schedule`` (default: ``secular_schedule``'s, see :func:`layout`)."""
    from galahad_tpu_torch.tr import secular_kernels as sk

    lam, cap, call, plain_fn = kernel_call(name, args)
    B, n = lam.numel() // lam.shape[-1], lam.shape[-1]
    row = dict(B=B, n=n, dtype=str(lam.dtype)[6:], max_its=cap)
    counted = "iterations" in inspect.signature(sk.trs_secular_newton).parameters
    if counted:
        row["schedule"] = schedule or sk.secular_schedule(B, n, lam.dtype)
    with layout(schedule):
        s = call()
        row["device_ms"] = device_ms(call)
        if plain:
            call()
            torch.cuda.synchronize()
            row["ms"] = _events_ms(lambda: [call() for _ in range(REPS)]) / REPS
            ref = plain_fn()
            row.update(plain_ms=_events_ms(plain_fn), max_rel_err=rel_err(s, ref))
        if counted:
            got = call(iterations=True)
    if counted:
        its, growth = got[1], (got[2] if name == "rqs" else None)
        steps = sk.critical_path_steps(its, growth)
        row.update(iterations=sk.iteration_percentiles(its), iterations_total=int(its.sum()),
                   critical_path_steps=steps, device_us_per_step=row["device_ms"] / steps * 1e3)
        if growth is not None:
            row.update(growth_evaluations_max=int(growth.max()),
                       theta_evaluations=int(growth.sum()) + row["iterations_total"])
    return row


def layout_candidates(B, n, dtype) -> dict:
    """The layouts the launcher accepts for (B, n), by name: ``schedule``
    (secular_schedule's pick); for n <= 64 every group of lanes that holds n;
    where a warp holds n in registers, blocks of 64 and 128 threads with the
    entries in shared memory; above that, the block with no entry in shared
    memory (``block_global``) and a single warp reading every entry from
    global memory (``warp_global``)."""
    from galahad_tpu_torch.tr import secular_kernels as sk

    sch = sk.secular_schedule(B, n, dtype)
    out = dict(schedule=sch)
    if n <= 64:
        for lanes, per_lane in sk.REG_LAYOUTS:
            if n <= lanes * per_lane:
                out[f"lanes_{lanes}"] = dict(lanes=lanes, threads=min(
                    sk.REG_THREADS, -(-B * lanes // 32) * 32), smem_entries=0)
    elif sch["lanes"]:
        for threads in (64, 128):
            out[f"block_{threads}"] = dict(lanes=0, threads=threads, smem_entries=n)
    else:
        out["block_global"] = dict(lanes=0, threads=sch["threads"], smem_entries=0)
        out["warp_global"] = dict(lanes=0, threads=32, smem_entries=0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   ".."))
    ap.add_argument("--layouts", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from galahad_tpu_torch.tr import secular_kernels as sk

    if not torch.cuda.is_available():
        print("secular_bench: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    sk._library()
    base = dict(card=card, root=os.path.abspath(args.root))
    if args.layouts:
        forced = hasattr(sk, "secular_schedule")
        for n, B in LAYOUT_SHAPES:
            inputs = eigen_inputs(B, n, torch.float64)
            layouts = layout_candidates(B, n, torch.float64) if forced else dict(own=None)
            for name in ("trs", "rqs"):
                for lname, sch in layouts.items():
                    row = timing(name, inputs[name][0], None if lname == "schedule" else sch,
                                 plain=lname in ("schedule", "own"))
                    print(json.dumps(dict(base, kernel=f"{name}_secular_newton", layout=lname,
                                          **row)), flush=True)
        return 0
    shapes = [(f"headline_{str(dt)[6:]}", lambda dt=dt: solver_inputs(*headline_batch(dt)))
              for dt in (torch.float64, torch.float32)]
    shapes.append(("krylov_padded_float64", krylov_secular_inputs))
    for shape, make in shapes:
        inputs = make()
        for name in ("trs", "rqs"):
            print(json.dumps(dict(base, kernel=f"{name}_secular_newton", shape=shape,
                                  **timing(name, inputs[name][0]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
