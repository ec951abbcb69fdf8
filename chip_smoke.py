#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and ``g++``; it builds the native
symbolic library and the seven CUDA sources from this checkout (into
``galahad_tpu_torch/_build/``, all eight at once), then runs, printing one
JSON line per phase:

  1. device     card name and power limit, torch and CUDA versions
  2. build      build seconds of the eight libraries
  3. kernel     every kernel against its plain PyTorch version on the
                card, with time and bound per shape: the small-front
                partial LDL^T at Fpad in {8..128} x nb in {1, 37, 4096} x
                {float32, float64}, and through its work-item table; the
                wide-front kernel on synthetic tree levels of fronts of
                Fpad in {192, 384, 1024, 4096} (1 and 8 fronts, ncols of 0,
                1, 31, 33, partial and nf, nf < Fpad) and one level that
                mixes them, x {float32, float64}, with NaN in every entry it
                may not touch, two runs bitwise equal; the
                sweep kernels on synthetic tree levels of every front size
                in {8..4096} x {float32, float64}, ncols of 0, 1, partial
                and full, fronts sharing struct rows, two runs bitwise equal;
                the extend-add kernel on synthetic levels of parent fronts
                in {8, 32, 128, 512, 4096} x {float32, float64} with 1, 2, 4
                and 16 children, a level of fronts of 64 with 33 and 40
                children each, and one of odd counts of fronts of 8, 16 and
                64, bitwise equal to its plain version; the block-tridiagonal
                factor and solve kernels at b in {1, 2, 4, 8, 16, 32} x k in
                {1, 2, 37, 2500} x {float32, float64}, one and three
                right-hand sides, the solve at its chunk boundaries (one
                chunk and a row over and under, a ragged last chunk, chunks
                of one row; b in {1, 3, 8}, b = 3 padded), a third block that
                is not positive definite (ok False, the identity in both
                versions), two runs bitwise equal, and b = 33 refused
  4. kkt        factorize + solve of the flagship KKT system
                (grid QP, k=316: n=99,856, m=49,928) with D_x = C = 1; a
                solve makes at most 3 forward and 2 backward sweep kernel
                launches per tree level and at most 60 in all
  5. repeat     two factorize+solve runs give the same bits
  6. flagship   ``ipm_solve`` on the flagship QP in float64, default
                control (the iteration captured once as a CUDA graph and
                replayed), checked on the host in float64 with scipy; the
                span recorder's calls and host seconds per span of it
  7. fused      the flagship through the direct path (GALAHAD_TPU_FUSED=0)
                and the graph path in turns (direct, graph, graph, direct),
                then ``steps_per_fetch=4`` and ``ipm_solve_compiled`` on the
                graph path: x, y, z and the host KKT bitwise equal on every
                run, every hand kernel launched in each replay, no plain code
  8. spare_slot the bucketed extend-add that the kernel replaced, timed on
                one factorization's levels with and without its padded
                entries (routed to one spare slot), and held bitwise to
                the kernel
  9. kernels    (printed after phase 12) one entry per hand-written kernel; the
                ``ldlt_wide`` entry also times the parent's 519 ``baddbmm_``
                trailing products on the same shapes (``update_library_ms``),
                as the yardstick of the in-kernel update; the ``extend_add``
                entry has per tree level its device time, bound, tiles, warps,
                pairs and longest chain of pairs, and the kernel's registers,
                spill bytes (0 checked) and resident warps per SM, f32 and f64
 10. arcs       the flagship through ``ipm_solve`` on the graph path with the
                series arcs taylor (order 4), puiseux (3) and zhao_sun (3):
                status 0 and host KKT <= 1e-6 each, x, y, z bitwise equal to
                the direct path's, every hand kernel launched in each replay
                and no plain code; the replay's device time and the aten ops
                of one direct step; at grid_qp_coo(100) the three arcs give
                the JAX package's status and iterations (``JAX_ARC_ITERS``)
 11. dense      dense QPs through ``read_qp`` / ``make_qp`` -> ``ipm_solve``:
                the 20 sweep fixtures against tests/dense_sweep_oracle.json
                (status, iterations, objective within 1e-8 relative); a
                random convex QP at n = 4096, m = 2048 (512 equality rows),
                status 0, host KKT <= 1e-6, graph bitwise equal to direct;
                a QP whose every first Cholesky try fails (a free variable
                with a zero row of H and a zero column of A: escalations
                counted, graph bitwise equal to direct)
 12. banded     ``ipm_solve_banded`` in float64 on the four banded problems of
                ``BANDED_CASES`` (the banded LP of bench.py:269 at n = 20,000
                and 1,000,000, the banded Schur complement; a tridiagonal H
                with the same A, PCG on S; the same H with m = 0, the block
                Cholesky of G), each on the graph path and directly: the JAX
                package's status and iterations, the objective within 1e-8
                relative of its value, host KKT <= 1e-6 (scipy, from the DIA
                data), x, y, z of graph and direct bitwise equal, both banded
                kernels in each replay as many times as the KKT mode calls
                them, and no plain banded code

then ``frontend``: ``qp.frontend.qp_solve`` and the command line on the card.
The flagship as a ``SparseQP`` through ``qp_solve(QPControl())`` (x, y, z and
host KKT bitwise equal to the ``flagship`` phase's ``ipm_solve``, every
flagship kernel in each replay, no plain code); the dense QP of the
``dense`` phase with ``scale=1``, ``presolve_problem`` and ``presolve_reduce``
(status 0, host KKT <= 1e-6 in the original variables, for the scaled run in
the scaled ones where its IPM stopped, objective within 1e-8 relative of the
plain ``ipm_solve``'s; the seconds of ``scale_get``,
``presolve_apply`` and ``presolve_reduce``); ``dqp`` and ``ccqp`` at n = 1024
(the JAX package's status and iterations, two runs bitwise equal, seconds,
host reads and H^-1 solves per DQP iteration); ``batch`` over
examples/sweep/sweep.list against tests/frontend_sweep_oracle.json (status,
iterations, objective within 1e-8 relative, no ERROR line) and ``solve
--json`` on QPMIXB (the DQP rescue's result);
then ``tr``: the trust-region subproblems on the card, their main path run
with the secular and tridiagonal kernels' counters set to 0 before and read
after: the reference's headline batch (1,024 TRS of n = 64, bench.py:81)
through ``trs_solve``, ``trs_solve_chol``, ``rqs_solve`` (sigma = 1/radius,
p = 3) and ``dps_solve`` in both norms, f64 and f32, each twice (bitwise
equal), against tests/trs_oracle.json (f64: obj and multiplier within 1e-10
relative, flags equal) and the port's CPU run of the same call on its first
256 problems (``TR_TOL``), timed by the bench's chained two-point slope with
``eigh``'s share; both secular kernels against their plain versions on the
inputs those calls give them and on a batch of hard cases and equality problems (s within 1e-12 /
1e-5 relative, each problem's iteration count within 1..max_its, the batch position changing no
bit), and timed there, in f32 and at the Krylov solvers' shape (B = 1, n = 64, padded); the
tridiagonal LDL'
entry points on 1,024 systems of k = 64 and one chain of k = 1,000,000
against the plain versions (``TRIDIAG_TOL`` on the card; the factor and the
batch solve bitwise equal to the plain versions on the host, the chain's
factor on its first ``TRIDIAG_PREFIX`` rows; the chain's chunked solve by its
residual against the sequential one's, and two runs bitwise), timed by
tools/tridiag_bench.py at the shapes (a)-(d) there; the sparse TRS
at n = 99,856 (the grid Laplacian of grid_qp_coo(316) minus 3 I, radius 1.5,
with M = 2 I, a contract to 0.75, and a hard case) held by its optimality
conditions in float64 with scipy, with the flagship kernels launched and no
plain code; and the Krylov solvers (GLTR, GLRT, LQR, LQT on that H, LSTR,
LSRT, L2RT on the flagship's A, LLST and LLS on dense A) against their CPU
runs (iter equal, x within 1e-8 relative);
then ``nlp``: the NLP solvers on the card, their main path run with the secular and
flagship kernels' counters set to 0 before and read after (plain code 0): (a) TRU (exact
TRS) and ARC (RQS) on 256 extended-Rosenbrock problems of n = 64 (tools/nlp_problems.py),
each problem's status and iterations those of the port's CPU run on 64 of them spread over the
batch (x within 1e-8 relative; every CPU run of the phase goes to four spawned processes,
which run beside the build), s per outer iteration and ``eigh``'s share; (b) at n = 99,856 from the
standard start TRU with GLTR and with L-BFGS (memory 10), ARC with GLRT, TRB with
Hessian-vector products on [-2, 0.9]^n, each against its CPU run, with Lanczos steps and
host reads per iteration and peak memory; (c) ``nls_solve_sparse`` at k = 316 (n = 99,856,
m = 199,080) twice (bitwise equal, f <= 1e-10, rows 1a-3 launched) and at k = 100 against
tests/nlp_oracle.json (the JAX package's iterations, f within 1e-8 relative, x's norm and 32
entries within 1e-8); (d) the NLS menu, CHECK / FDH
and DQP by TRB (``exact_arc=False``) against their CPU runs; the outer loops read the host
before each pass (reads = the slowest problem's iterations + 1, passes = its iterations);
whether ``torch.linalg.eigh`` synchronises;
then ``constrained``: the constrained and global solvers on the card (tools/
constrained_problems.py, tools/sif_problems.py), their main path run with the kernels'
counters set to 0 before and read after (row 6a launched, plain code 0), each case held to the
port's CPU run of the same call (status, iterations, x within 1e-8 relative; the CPU runs join
the ``nlp`` phase's pool): (e) LANCELOT at n = 400 (test_large_n_matrix_free) and at
n = 99,856 twice (bitwise, held by its optimality conditions in float64 on the host), and
``lancelot_simple`` on test_tr2.py's two cases; (f) QCQP through ``read_qcqp``: the ball
problem by "al" and by "filter" from (30, 30), and a convex QCQP at n = 1,024, m = 32 written as
QPLIB text (host KKT); (g) FILTRANE on TestFiltrane's three systems and the Broyden
tridiagonal system at n = 1,024; (h) BGO on Rastrigin (n = 2, 256 starts; n = 8, 1,024 starts
as one batched TRB: every start stationary on the host, the best f the CPU run's on the same
starts, the first pass held start by start on 64 of them, passes = the slowest start's
iterations), DGO on Hartmann-6 (1,000 splits; two runs bitwise, the splits under CUDA's
sync debug mode set to error) and the 1-D case, UGO on test_go.py's three functions (one
under the sync check); (i) CAMEL6, HART6 and ALLINIT decoded by ``read_nlp`` and solved by
TRB, EXTROSNB decoded (seconds, aten ops per objective evaluation) and solved; (j) BQP,
BLLS (2,048 x 1,024) and EQP (m = 256) at n = 1,024;
then ``linalg``: the inline supernodal LDL^T, SLS, PSLS and the services on the card,
their main path run with the factor and banded kernels' counters set to 0 before and read
after (rows 1a, 1b, 4a, 4b launched, plain code 0): (k) the flagship's KKT system (k = 316,
n + m = 149,784) through ``sparse_kkt_plan(backend="inline")`` / ``sparse_kkt_factorize`` and
an sbls-style solve with two refinement sweeps: relative residual <= 1e-10, inertia (n, m, 0),
x within 1e-10 of the flat path's, two runs bitwise, one launch of row 1a per group of fronts
<= 128 and of row 1b per wider group, three groups of each route held to the plain version on
the same fronts; (l) SLS potr / sytr / eigh at n = 4,096, pbtr at k = 125,000, b = 8,
supernodal on the flagship's H, CG on H + I: residual <= 1e-10 and x within 1e-10 of the
port's CPU run; (m) PSLS, every preconditioner, on the 64 x 64 grid Laplacian (n = 4,096:
finite, v'Pv > 0, symmetric) and on the 32 x 32 one against the CPU run; (o) SCU at n = 4,096
with 64 appended rows, FDC / ULS / MIQR on a 1,024 x 2,048 matrix with 24 planted dependent
rows, SBLS's null-space mode, projected PCG and Fredholm alternative at n = 1,024, m = 512,
each against the CPU run (the CPU runs join the ``nlp`` phase's pool);
then ``qp_family``: ``qp_solve`` with qpa, qpb and qpc on the 12 QP sweep fixtures and with
``crossover=True`` on all 20, on the card, and lpa on the 8 LP fixtures (in a process of its
own that uses the card, started before the build: the simplex is minutes of host work),
each against tests/qp_family_oracle.json (the JAX package's status, iterations, objective
within 1e-8 relative; a QPB run whose endgame parts by rounding by its stopping tolerance);
then ``parallel``: the mesh layer (galahad_tpu_torch/parallel/) on ``make_mesh(devices=
[cuda:0] * 4)``, one card (``cards_in_mesh`` 1: each shard's work and the fixed-order sums are
checked, traffic between cards is not): (p1) ``batch_ipm_solve`` on 256 seeded convex dense QPs
of n = 128, m = 64 over the batch axis (one vmapped step per shard, captured once; steps per
shard = its slowest problem's iterations), 16 of them held to the single
``ipm_solve_compiled`` of each (status, iterations, x within 1e-8 relative); (p2)
``model_sharded_step`` at n = 4,096, m = 2,048 over the model axis within 1e-12 relative of
``ipm_step`` on the whole QP; (p3) ``block_angular_solve`` with 64 scenarios of n = 256 and 64
linking rows (residual and x, y against a dense solve of the 16,448-row system within 1e-10);
(p4) ``sharded_kkt_solve`` on the strip grid at the flagship's width (D = 4 strips of w = 78
columns, R = 316 rows: N = 198,765) twice (bitwise), residual against scipy's monolithic K <=
1e-10 and x within 1e-8 of ``spsolve`` (run by the CPU pool beside the build), rows 1a, 1b, 2a,
2b and 3 launched (the column solves' replays counted), plain code 0;
then ``capi``: the port's C library built (tools: ``gcc``) and one C program, started as a
process on the card before the ``parallel`` phase and joined after it, running
tests/test_capi.py's two programs, ``galahad_tpu_cqp_solve`` on a dense QP of n = 1,024, m =
512 (x printed with ``%.17g``: bitwise the same solver's called from Python here) and
``galahad_tpu_sls_*`` on the flagship's H (n = 99,856: residual <= 1e-10, inertia (n, 0, 0),
rows 1a / 1b launched in that process, by its own counters);
then ``banded_path_kernels`` (both banded kernels on every block set the
banded problems factor at their starting point, against the plain versions,
at k = 125,000 those the CPU pool ran beside the build on the same blocks;
and at their last iteration, by relative residual against the sequential
solve's), then the ``kernels`` line (seven entries: the five of the
flagship's path, measured after the ``fused`` phase, and the two banded
kernels, on the Schur-complement blocks of the banded LP at n = 20,000, with
the library's dense Cholesky and triangular solves of the same matrix as
their yardstick, and their critical-path steps, and the four kernels of the
``tr`` phase; rows 6a, 6b and 1a-3 carry ``launches_nlp``, their launches on the ``nlp``
phase's path, and every entry ``launches_constrained``, ``launches_linalg``,
``launches_parallel`` and ``launches_capi``, its launches on the ``constrained``, ``linalg``,
``parallel`` (p4) and ``capi`` (the C process's) paths)
and, as its last line, ``{"ok": true, "device": {...}}``.  Any failed
phase ends the run with a non-zero exit code and no such line.  Without
a CUDA device it exits non-zero at once; nothing here runs the port on
the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from galahad_tpu_torch import make_qp, make_sparse_qp
from galahad_tpu_torch.core import trace
from galahad_tpu_torch.core.status import Status
from galahad_tpu_torch.linalg import (banded_kernels, ea_kernels, ldlt_kernels, supernodal_flat,
                                     sweep_kernels)
from galahad_tpu_torch.linalg.sbls import sparse_kkt_factorize, sparse_kkt_plan
from galahad_tpu_torch.qp.fused import launch_counts
from galahad_tpu_torch.qp.ipm import IPMControl, ipm_solve, ipm_solve_compiled

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
import secular_bench  # noqa: E402  (tools/secular_bench.py: the secular kernels' inputs, timing)
import tridiag_bench  # noqa: E402  (tools/tridiag_bench.py: the tridiagonal kernels' inputs, timing)
from secular_bench import (TR_BATCH, TR_N, capture_secular_inputs,  # noqa: E402
                           headline_batch)
from tridiag_bench import tridiag_rel_residual, tridiag_residual, tridiag_systems  # noqa: E402
import nlp_problems  # noqa: E402  (tools/nlp_problems.py: the nlp phase's problems)

K_FLAGSHIP = 316
ARC_RUNS = (("taylor", 4), ("puiseux", 3), ("zhao_sun", 3))
K_ARC_PARITY = 100
# (status, iterations) of the JAX package's ipm_solve on flagship_qp(100) with
# each arc, float64 on the CPU, as printed by
# `JAX_PLATFORMS=cpu python tools/make_dense_oracle.py arcs 100`
JAX_ARC_ITERS = {("taylor", 4): (0, 14), ("puiseux", 3): (0, 16), ("zhao_sun", 3): (0, 15)}
DENSE_N, DENSE_M, DENSE_EQ = 4096, 2048, 512
# DQP and CCQP through qp_solve on convex_qp_arrays(DQP_N, DQP_N / 2, 0,
# equalities=DQP_N / 8): n = 1024 is the largest size at which the JAX
# package's two solves stay well under ten minutes on the CPU (97 s and 110
# s; at n = 4096 they ran past 20 minutes).  Its dqp_solve / ccqp_solve there,
# float64 on the CPU (tools/make_frontend_oracle.py dense 1024), gave
# (status, iterations, objective): both stop at maxit, unconverged
DQP_N = 1024
JAX_DQP = {"dqp": (-18, 200, 34872.34931029197), "ccqp": (-18, 200, 45456.67897984131)}
FLAGSHIP_KERNELS = ("partial_ldlt", "ldlt_wide", "extend_add", "sweep_fwd", "sweep_bwd")
TOL = {torch.float32: 1e-4, torch.float64: 1e-11}   # x max|plain result|
TPU_KERNEL = "galahad_tpu/linalg/pallas_kernels.py:129"
SOURCE = "galahad_tpu_torch/csrc/partial_ldlt.cu"
WIDE_SOURCE = "galahad_tpu_torch/csrc/ldlt_wide.cu"
TPU_WIDE = (TPU_KERNEL + " (fronts > 128: its XLA twin galahad_tpu/linalg/"
            "supernodal_flat.py:684 _partial_ldlt_dyn, through _k_factor_scan :852)")
SWEEP_SOURCE = "galahad_tpu_torch/csrc/sweep.cu"
TPU_FWD_SWEEP = "galahad_tpu/linalg/supernodal_flat.py:915"
TPU_BWD_SWEEP = "galahad_tpu/linalg/supernodal_flat.py:955"
EA_SOURCE = "galahad_tpu_torch/csrc/extend_add.cu"
TPU_EA = ("galahad_tpu/linalg/supernodal_flat.py:779 (_ea_slot_apply) / :795 "
          "(_ea_q_apply)")
MAX_SWEEP_LAUNCHES_PER_SOLVE = 60
MAX_SWEEP_LAUNCHES_PER_LEVEL = dict(fwd=3, bwd=2)
MAX_EA_CALLS_PER_FACTORIZATION = 18
MAX_WIDE_CALLS_PER_FACTORIZATION = 18
PANEL_W = ldlt_kernels.PANEL
# the counters of the kernels of the main path (qp/fused.py::launch_counts)
KERNEL_COUNTS = ("partial_ldlt", "ldlt_wide", "extend_add", "extend_add_kernels", "sweep_fwd",
                 "sweep_bwd", "sweep_fwd_kernels", "sweep_bwd_kernels")
PLAIN_COUNTS = ("ldlt_wide_plain", "extend_add_plain", "sweep_plain", "banded_factor_plain",
                "banded_solve_plain")
BANDED_SOURCE = "galahad_tpu_torch/csrc/banded.cu"
TPU_BANDED_FACTOR = ("galahad_tpu/linalg/banded.py:68 block_tridiag_cholesky (lax.scan :103; "
                     "XLA, no Pallas)")
TPU_BANDED_SOLVE = ("galahad_tpu/linalg/banded.py:112 block_tridiag_solve (lax.scan :133 / "
                    ":151; XLA, no Pallas)")
BANDED_CTL = dict(maxit=60, stop_abs_p=1e-6, stop_abs_d=1e-6, stop_abs_c=1e-6)
# (n, h, m): the banded problems; h "tri" is the tridiagonal H (2, -1); m None
# is n - 2 rows (offsets 0 and 2, U(0.8, 1.2) from default_rng(0)); the JAX
# package's ipm_solve_banded on the same data, float64 on the CPU, with
# IPMControl(**BANDED_CTL), gave (iterations, objective), each at status 0
BANDED_CASES = {
    "lp_n20000": ((20_000, None, None), (6, -23999.998820259632)),
    "pcg_n20000": ((20_000, "tri", None), (10, -23997.14324817419)),
    "m0_n20000": ((20_000, "tri", 0), (6, -23997.141558930114)),
    "lp_n1000000": ((1_000_000, None, None), (6, -1199999.9432418859)),
}


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **kw) -> None:
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def grid_qp_coo(k: int):
    """Grid-Laplacian H (lower COO) + 2-diagonal A: the flagship problem
    family (the JAX package's bench.py builds the same arrays)."""
    n = k * k
    idx = np.arange(n).reshape(k, k)
    ii = [np.arange(n)]
    jj = [np.arange(n)]
    vv = [np.full(n, 4.0)]
    right = np.stack([idx[:, 1:].ravel(), idx[:, :-1].ravel()])
    down = np.stack([idx[1:, :].ravel(), idx[:-1, :].ravel()])
    for pair in (right, down):
        hi, lo = np.maximum(pair[0], pair[1]), np.minimum(pair[0], pair[1])
        ii.append(hi)
        jj.append(lo)
        vv.append(np.full(len(hi), -1.0))
    ii, jj, vv = map(np.concatenate, (ii, jj, vv))
    m = n // 2
    ar = np.repeat(np.arange(m), 2)
    ac = np.stack([np.arange(m), np.arange(m) + n - m]).T.reshape(-1)
    av = np.random.default_rng(0).uniform(0.5, 1.5, 2 * m)
    return n, m, (ii, jj, vv), (ar, ac, av)


def flagship_qp(k: int, device, dtype=torch.float64):
    rng = np.random.default_rng(0)
    n, m, h_coo, a_coo = grid_qp_coo(k)
    return make_sparse_qp(
        n, m, h_coo=h_coo, a_coo=a_coo, g=rng.normal(size=n),
        c_l=np.full(m, 1.0), c_u=np.full(m, 1e20),
        x_l=np.zeros(n), x_u=np.full(n, 2.0), dtype=dtype, device=device)


def event_ms(fn) -> float:
    """Time in ms between two CUDA events recorded around ``fn()``."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` in ms, by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return event_ms(lambda: [fn() for _ in range(reps)]) / reps


SPIN_CYCLES_PER_MS = 2_000_000       # ~1 ms of torch.cuda._sleep at 2 GHz


def queued_ms(thunks, batch: int = 128, spin_ms: float = 30.0) -> float:
    """Device time in ms of the calls ``thunks`` run in order.  The device is
    kept busy by a spin kernel while the host enqueues each batch of calls,
    so that the calls then run back to back and the host's launch rate does
    not enter (a plain event pair around calls that the host enqueues slower
    than the device runs them measures the host).  A batch that the host
    did not enqueue well inside the spin is taken again behind a longer one."""
    total = 0.0
    for i in range(0, len(thunks), batch):
        enqueue_ms = 0.0

        def run():
            nonlocal enqueue_ms
            t0 = time.perf_counter()
            for fn in thunks[i:i + batch]:
                fn()
            enqueue_ms = (time.perf_counter() - t0) * 1e3

        for attempt in range(3):
            spin = spin_ms * 2 ** attempt
            torch.cuda.synchronize()
            torch.cuda._sleep(int(spin * SPIN_CYCLES_PER_MS))
            ms = event_ms(run)
            if enqueue_ms < 0.8 * spin:
                break
        total += ms
    return total


def time_each_ms(setup, fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs, each after an
    untimed ``setup()`` (for a function that works in place)."""
    times = []
    for _ in range(reps + 1):
        setup()
        times.append(event_ms(fn))
    return sum(times[1:]) / reps                 # the first run warms up


def contract_mask(ncols, Fpad: int):
    """Entries the storage contract specifies: the lower triangle
    (diagonal included) of eliminated columns and the whole trailing
    square."""
    ar = torch.arange(Fpad, device=ncols.device)
    nc = ncols.to(torch.int64)[:, None, None]
    r, c = ar[None, :, None], ar[None, None, :]
    return ((c < nc) & (r >= c)) | ((r >= nc) & (c >= nc))


def compare(F, ncols):
    """(max abs err on the contract's entries, scale) kernel vs plain."""
    out_k = ldlt_kernels.partial_ldlt(F, ncols)
    out_p = ldlt_kernels.partial_ldlt_plain(F, ncols)
    torch.cuda.synchronize()
    mask = contract_mask(ncols, F.shape[1])
    check(bool(torch.isfinite(out_k[mask]).all()), "kernel produced non-finite values")
    err = float(((out_k - out_p).abs() * mask).max()) if F.numel() else 0.0
    scale = float(out_p.abs().max()) if F.numel() else 1.0
    return err, max(scale, 1.0)


# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return card


def phase_build():
    """Build the eight libraries at once (one compiler process each)."""
    import threading

    from galahad_tpu_torch.linalg import _cuda_build, tridiag_kernels
    from galahad_tpu_torch.native import build as native_build
    from galahad_tpu_torch.tr import secular_kernels

    seconds: dict = {}
    errors: list = []

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as exc:                 # reported below, fails the run
            errors.append(f"{name}: {exc}")
        seconds[name] = time.perf_counter() - t0

    jobs = [("native_symbolic_s", native_build.load_symbolic),
            ("partial_ldlt_s", ldlt_kernels._library),
            ("ldlt_wide_s", ldlt_kernels._wide_library),
            ("sweep_s", sweep_kernels._library),
            ("extend_add_s", ea_kernels._library),
            ("banded_s", banded_kernels._library),
            ("secular_s", secular_kernels._library),
            ("tridiag_s", tridiag_kernels._library)]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=timed, args=j) for j in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, "build failed: " + " | ".join(errors))
    ptxas = {}
    for src in ("partial_ldlt.cu", "ldlt_wide.cu", "sweep.cu", "extend_add.cu", "banded.cu",
                "secular.cu", "tridiag.cu"):
        log = _cuda_build.build_info.get(src, {}).get("log", "")
        ptxas[src] = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                      if "registers" in ln or "error" in ln.lower()
                      or ("spill" in ln and "0 bytes spill" not in ln)][:20]
    emit("build", all_s=time.perf_counter() - t0, **seconds,
         nvcc_flags=" ".join(_cuda_build.NVCC_FLAGS), ptxas=ptxas)


def random_fronts(nb, Fpad, dtype, gen):
    """Symmetric definite fronts of either sign (so the elimination is
    stable without pivoting and both signs of d occur)."""
    G = torch.randn(nb, Fpad, Fpad, dtype=dtype, device="cuda", generator=gen)
    F = G @ G.transpose(-1, -2) / Fpad + torch.eye(Fpad, dtype=dtype, device="cuda")
    sign = torch.where(torch.arange(nb, device="cuda") % 2 == 0, 1.0, -1.0).to(dtype)
    F = F * sign[:, None, None]
    ncols = torch.randint(0, Fpad + 1, (nb,), device="cuda", generator=gen,
                          dtype=torch.int32)
    ncols[-1] = Fpad
    if nb > 1:
        ncols[0] = 0
    return F.contiguous(), ncols


def phase_kernel():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.float64):
        for Fpad in (8, 16, 32, 64, 96, 128):
            for nb in (1, 37, 4096):
                F, ncols = random_fronts(nb, Fpad, dtype, gen)
                err, scale = compare(F, ncols)
                tol = TOL[dtype] * scale
                check(err <= tol, f"kernel disagrees with its plain version: "
                      f"Fpad={Fpad} nb={nb} {dtype}: err {err:.3e} > {tol:.3e}")
                reps = 20 if nb < 4096 else 5
                ms = time_ms(lambda: ldlt_kernels.partial_ldlt(F, ncols), reps=reps)
                dev_ms = queued_ms(
                    [lambda: ldlt_kernels.partial_ldlt(F, ncols)] * reps) / reps
                bound, by = ldlt_kernels.ldlt_bound_ms(ncols, Fpad, dtype)
                rows.append(dict(dtype=str(dtype).split(".")[1], Fpad=Fpad, nb=nb,
                                 max_abs_err=err, tol=tol, ms=ms, device_ms=dev_ms,
                                 bound_ms=bound, bound_by=by))
                del F
    # in-place on a view of a larger buffer, and ncols == 0 everywhere
    F, ncols = random_fronts(64, 32, torch.float64, gen)
    buf = torch.zeros(7 + F.numel(), dtype=F.dtype, device="cuda")
    view = buf[7:].view_as(F)
    view.copy_(F)
    ldlt_kernels.partial_ldlt(view, ncols, inplace=True)
    check(torch.equal(view, ldlt_kernels.partial_ldlt(F, ncols)),
          "in-place result differs from out-of-place")
    zero = torch.zeros_like(ncols)
    check(torch.equal(ldlt_kernels.partial_ldlt(F, zero), F),
          "ncols == 0 must leave the fronts untouched")
    items_rows = kernel_items_cases(gen)
    wide_rows = kernel_wide_cases()
    sweep_rows = kernel_sweep_cases()
    ea_rows = kernel_ea_cases()
    banded_rows = kernel_banded_cases()
    emit("kernel", tolerance="max|kernel-plain| <= 1e-4*scale (float32), "
         "1e-11*scale (float64), scale = max|plain| >= 1; partial_ldlt: on the "
         "lower triangle of eliminated columns and the whole trailing square; "
         "ldlt_wide: on the lower triangle of eliminated columns and the whole "
         "trailing square of each front's real rows, and bitwise on every entry "
         "it may not touch (NaN); sweeps: on "
         "every entry of y after the forward and after the backward sweep; "
         "extend_add: bitwise equal on every entry of the store, NaN included; "
         "banded factor and solve: on every entry of Ld, Lo and x",
         shapes=rows, items=items_rows, wide_shapes=wide_rows,
         sweep_shapes=sweep_rows, ea_shapes=ea_rows, banded_shapes=banded_rows)


def kernel_items_cases(gen):
    """One call over batches of every size at once, through the item table,
    against the same batches one by one."""
    out_rows = []
    for dtype in (torch.float32, torch.float64):
        batches, parts, off = [], [], 64
        for Fpad, nb in ((8, 1000), (128, 5), (16, 333), (64, 41), (32, 77), (96, 9)):
            F, ncols = random_fronts(nb, Fpad, dtype, gen)
            batches.append((off, Fpad, ncols.cpu().numpy()))
            parts.append((off, F, ncols))
            off += F.numel() + 64
        buf = torch.zeros(off, dtype=dtype, device="cuda")
        for o, F, _ in parts:
            buf[o:o + F.numel()] = F.reshape(-1)
        items = ldlt_kernels.build_ldlt_items(batches, "cuda")
        got = ldlt_kernels.partial_ldlt_items(buf, items, out=torch.zeros_like(buf))
        worst = 0.0
        for o, F, ncols in parts:
            ref = ldlt_kernels.partial_ldlt_plain(F, ncols)
            mask = contract_mask(ncols, F.shape[1])
            g = got[o:o + F.numel()].view_as(F)
            check(bool(torch.isfinite(g[mask]).all()), "items kernel: non-finite values")
            err = float(((g - ref).abs() * mask).max())
            tol = TOL[dtype] * max(1.0, float(ref.abs().max()))
            check(err <= tol, f"items kernel disagrees with its plain version: "
                  f"Fpad={F.shape[1]} {dtype}: err {err:.3e} > {tol:.3e}")
            check(torch.equal(g, ldlt_kernels.partial_ldlt(F, ncols)),
                  "items call and uniform call give different bits")
            worst = max(worst, err)
        gaps = torch.ones(off, dtype=torch.bool, device="cuda")
        for o, F, _ in parts:
            gaps[o:o + F.numel()] = False
        check(not bool(got[gaps].any()), "items kernel wrote outside its fronts")
        inplace = buf.clone()
        ldlt_kernels.partial_ldlt_items(inplace, items)
        check(torch.equal(inplace[~gaps], got[~gaps]), "items kernel: in place differs")
        ms = time_ms(lambda: ldlt_kernels.partial_ldlt_items(buf, items, out=got), reps=10)
        dev_ms = queued_ms(
            [lambda: ldlt_kernels.partial_ldlt_items(buf, items, out=got)] * 10) / 10
        out_rows.append(dict(dtype=str(dtype).split(".")[1], fronts=items.fronts,
                             blocks=int(items.table.shape[0]), max_abs_err=worst, ms=ms,
                             device_ms=dev_ms))
    return out_rows


def wide_specs(Fpad: int, count: int):
    """(ncols, nf) of the fronts of one synthetic level: 0, 1, 31, 33, partial
    and full elimination, nf below and at Fpad."""
    nf = Fpad - 29
    if count == 1:
        return [(nf - 45, nf)]
    return [(nf, nf), (nf - 45, nf), (33, nf - 7), (1, nf - 3), (31, nf), (0, nf - 1),
            (Fpad // 2, Fpad), (Fpad - 64, Fpad - 60)][:count]


WIDE_CASES = [(f"{Fpad}x{count}", [(Fpad, nc, nf) for nc, nf in wide_specs(Fpad, count)])
              for Fpad in (192, 384, 1024, 4096) for count in (1, 8)]
WIDE_CASES.append(("mixed", [(192, 150, 190), (1024, 700, 1000), (384, 1, 290),
                             (256, 0, 200), (384, 300, 384), (192, 33, 180),
                             (4096, 200, 3000)]))


def wide_level_store(specs, dtype, seed):
    """A flat store on the card holding the fronts ``specs = [(Fpad, ncols,
    nf), ...]`` (symmetric definite of either sign on the leading nf x nf
    block) with NaN in every entry the kernel may neither read nor write: rows
    and columns at or beyond nf, the upper triangle of rows < ncols, and the
    gaps between fronts.  Returns (store, level table, contract mask)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows, off = [], 40
    for Fpad, nc, nf in specs:
        rows.append((off, Fpad, nc, nf))
        off += Fpad * Fpad + 40
    store = torch.full((off,), float("nan"), dtype=dtype, device="cuda")
    contract = torch.zeros(off, dtype=torch.bool, device="cuda")
    for i, (o, Fpad, nc, nf) in enumerate(rows):
        G = torch.randn(nf, nf, dtype=torch.float64, device="cuda", generator=gen)
        A = (G @ G.T / nf + torch.eye(nf, dtype=torch.float64, device="cuda")) \
            * (1.0 if i % 2 == 0 else -1.0)
        ar = torch.arange(nf, device="cuda")
        r, c = ar[:, None], ar[None, :]
        A[(r < c) & (r < nc)] = float("nan")
        store[o:o + Fpad * Fpad].view(Fpad, Fpad)[:nf, :nf] = A.to(dtype)
        contract[o:o + Fpad * Fpad].view(Fpad, Fpad)[:nf, :nf] = \
            ((c < nc) & (r >= c)) | ((r >= nc) & (c >= nc))
        del G, A
    return store, ldlt_kernels.build_wide_level(rows, "cuda"), contract


def wide_contract(lvl, n: int):
    """Mask over a buffer of ``n`` entries: the entries of the level's fronts
    that the storage contract specifies (within each front's real rows)."""
    mask = torch.zeros(n, dtype=torch.bool, device="cuda")
    for off, Fpad, nc, nf in lvl.fronts.tolist():
        ar = torch.arange(nf, device="cuda")
        r, c = ar[:, None], ar[None, :]
        mask[off:off + Fpad * Fpad].view(Fpad, Fpad)[:nf, :nf] = \
            ((c < nc) & (r >= c)) | ((r >= nc) & (c >= nc))
    return mask


def compare_wide(store, lvl, contract, what: str):
    """Kernel and plain version on copies of ``store``: checks that they agree
    on the contract's entries, that the kernel wrote no other entry (NaN there
    in the synthetic levels), made one launch, never entered the
    plain version, and gives the same bits twice.  Returns (max abs err,
    tolerance, ms of the plain version)."""
    got, ref = store.clone(), store.clone()
    launches, plain = ldlt_kernels.wide_launch_count(), ldlt_kernels.wide_plain_count()
    ldlt_kernels.partial_ldlt_wide(got, lvl)
    made = ldlt_kernels.wide_launch_count() - launches
    check(made == 1, f"ldlt_wide: {made} kernel launches in one call ({what})")
    check(ldlt_kernels.wide_plain_count() == plain,
          f"ldlt_wide: the plain version ran inside the kernel's call ({what})")
    plain_ms = event_ms(lambda: ldlt_kernels.partial_ldlt_wide_plain(ref, lvl))
    check(bool(torch.isfinite(got[contract]).all()),
          f"ldlt_wide kernel produced non-finite values ({what})")
    err = float((got[contract] - ref[contract]).abs().max())
    tol = TOL[store.dtype] * max(1.0, float(ref[contract].abs().max()))
    check(err <= tol, f"ldlt_wide kernel disagrees with its plain version ({what}, "
          f"{store.dtype}): err {err:.3e} > {tol:.3e}")
    untouched = ~contract
    check(same_bits(got[untouched], store[untouched]),
          f"ldlt_wide kernel wrote an entry outside the contract ({what})")
    again = store.clone()
    ldlt_kernels.partial_ldlt_wide(again, lvl)
    check(same_bits(again, got), f"ldlt_wide kernel: two runs differ ({what})")
    del got, ref, again
    return err, tol, plain_ms


def kernel_wide_cases():
    """The wide-front kernel on one synthetic level per case, against its plain
    version, with time and bound."""
    out_rows = []
    for name, specs in WIDE_CASES:
        for dtype in (torch.float32, torch.float64):
            store, lvl, contract = wide_level_store(specs, dtype, seed=len(name))
            check(bool(torch.isnan(store[~contract]).all()),
                  f"ldlt_wide case {name}: NaN must fill every entry off the contract")
            err, tol, plain_ms = compare_wide(store, lvl, contract, f"case {name}")
            work = store.clone()
            ms = time_each_ms(lambda: work.copy_(store),
                              lambda: ldlt_kernels.partial_ldlt_wide(work, lvl), reps=3)
            copies = [store.clone() for _ in range(3)]
            dev_ms = queued_ms([lambda c=c: ldlt_kernels.partial_ldlt_wide(c, lvl)
                                for c in copies]) / len(copies)
            bound, by = ldlt_kernels.wide_bound_ms(lvl, dtype)
            out_rows.append(dict(
                dtype=str(dtype).split(".")[1], case=name, fronts=len(specs),
                steps=lvl.steps, launches=1, max_abs_err=err, tol=tol, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                bitwise_repeat=True, nan_untouched=True))
            del store, contract, work, copies
    return out_rows


def sweep_level(specs, dtype, seed):
    """A synthetic tree level for the sweep kernels, on the card: fronts
    ``specs = [(Fpad, [(ncols, nf), ...]), ...]`` with random unit-lower L and
    d (one pivot of a front is 0: divided by 1) and NaN in every other entry
    (the Schur block, the upper triangle and the padded rows, on which no
    result may depend); eliminated rows distinct over all
    fronts, struct rows drawn from one shared pool, so that fronts add into the
    same rows.  Returns (store, level tables, y)."""
    rng = np.random.default_rng(seed)
    n_elim = sum(nc for _, fronts in specs for nc, _ in fronts)
    pool = max(nf - nc for _, fronts in specs for nc, nf in fronts) + 7
    n = n_elim + pool
    parts, batches = [], []
    off = next_row = 0
    for Fpad, fronts in specs:
        F = np.full((len(fronts), Fpad, Fpad), np.nan)
        frows = np.full((len(fronts), Fpad), n, np.int64)
        for i, (nc, nf) in enumerate(fronts):
            L = rng.normal(size=(nf, nc)) * 0.5 / np.sqrt(max(nc, 1))
            below = np.arange(nf)[:, None] > np.arange(nc)[None, :]
            F[i, :nf, :nc] = np.where(below, L, np.nan)
            d = rng.uniform(0.5, 2.0, nc) * rng.choice([-1.0, 1.0], nc)
            if nc > 2:
                d[1] = 0.0
            F[i, np.arange(nc), np.arange(nc)] = d
            frows[i, :nc] = np.arange(next_row, next_row + nc)
            frows[i, nc:nf] = n_elim + np.sort(rng.choice(pool, nf - nc, replace=False))
            next_row += nc
        batches.append((off, Fpad, np.array([nc for nc, _ in fronts], np.int64), frows))
        parts.append(F.ravel())
        off += F.size
    store = torch.as_tensor(np.concatenate(parts + [np.zeros(1)]), dtype=dtype,
                            device="cuda")
    y = rng.normal(size=n + 1)
    y[n] = 0.0
    return (store, sweep_kernels.build_sweep_level(batches, n, "cuda"),
            torch.as_tensor(y, dtype=dtype, device="cuda"))


def ladder_fronts(Fpad: int, copies: int):
    """(ncols, nf) of 0, 1, partial and full, with and without struct rows."""
    return [(0, Fpad // 2), (1, Fpad), (1, 1), (Fpad // 3, Fpad), (Fpad // 3, Fpad // 2),
            (Fpad, Fpad), (Fpad - 5, Fpad - 2), (2, Fpad - 1),
            (Fpad // 2, Fpad // 2)] * copies


SWEEP_CASES = [
    (8, 400), (16, 200), (32, 100), (64, 40), (96, 20), (128, 16), (192, 4), (256, 3),
    (384, 2), (512, 2), (768, 1), (1024, 1), (1536, 1), (2048, 1), (3072, 1), (4096, 1)]
ROOT = (3575, 3575)              # the flagship's root front: ncols = nf = 3,575 in 4096


def sweep_case_specs():
    """(name, level specs) of the sweep kernel cases: one level per front size
    (a few small fronts ride along: one call serves several sizes), the
    flagship's root alone and the root beside 300 fronts of 64 with 1..22
    columns."""
    out = []
    for Fpad, copies in SWEEP_CASES:
        if Fpad <= 512:
            fronts = ladder_fronts(Fpad, copies)
        else:                      # ncols partial with a large block below, and full
            fronts = [(Fpad // 4, Fpad - 3), (Fpad, Fpad)] * copies
        out.append((f"Fpad={Fpad}", [(Fpad, fronts)]
                    + ([(8, ladder_fronts(8, 2))] if Fpad != 8 else [])))
    out.append(("root", [(4096, [ROOT])]))
    out.append(("root+300x64", [(4096, [ROOT]), (64, [
        (1 + k % 22, 1 + k % 22 + (7 * k) % (42 - k % 22)) for k in range(300)])]))
    return out


def compare_sweeps(store, levels, y0, work, what: str):
    """Forward then backward over ``levels`` (bottom-up, then top-down) with
    the kernels and with the plain versions, the backward sweeps both from
    the plain forward result; checks that they agree and that a second run of
    the kernels gives the same bits.  Returns (err fwd, err bwd, plain ms fwd,
    plain ms bwd, y after the plain forward sweep)."""
    dtype = store.dtype

    def fwd(y):
        for lvl in levels:
            sweep_kernels.sweep_fwd(store, y, lvl, work)

    def bwd(y):
        for lvl in reversed(levels):
            sweep_kernels.sweep_bwd(store, y, lvl, work)

    def fwd_plain(y):
        for lvl in levels:
            sweep_kernels.sweep_fwd_plain(store, y, lvl, work)
            sweep_kernels.sweep_accumulate_plain(y, lvl, work)

    def bwd_plain(y):
        for lvl in reversed(levels):
            sweep_kernels.sweep_bwd_plain(store, y, lvl)

    errs, plain_ms = [], []
    start = y0
    for name, kern, plain in (("forward", fwd, fwd_plain), ("backward", bwd, bwd_plain)):
        yk, yk2, yp = start.clone(), start.clone(), start.clone()
        key = "fwd_kernels" if name == "forward" else "bwd_kernels"
        before = sweep_kernels.sweep_counts()[key]
        kern(yk)
        made = sweep_kernels.sweep_counts()[key] - before
        want = sum(getattr(lvl, key) for lvl in levels)
        check(made == want, f"{name} sweep: the launchers report {made} kernel launches, "
              f"the tables call for {want} ({what})")
        kern(yk2)
        try:
            sweep_kernels.sweep_check(levels)
        except RuntimeError as exc:
            raise SmokeFailure(f"{name} sweep ({what}): {exc}")
        plain_ms.append(event_ms(lambda: plain(yp)))
        check(bool(torch.isfinite(yk).all()),
              f"{name} sweep kernels produced non-finite values ({what})")
        err = float((yk - yp).abs().max())
        tol = TOL[dtype] * max(1.0, float(yp.abs().max()))
        check(err <= tol, f"{name} sweep kernels disagree with their plain version "
              f"({what}, {dtype}): err {err:.3e} > {tol:.3e}")
        check(torch.equal(yk, yk2), f"{name} sweep kernels: two runs differ ({what})")
        check(float(yk[-1]) == 0.0, f"{name} sweep wrote the spare slot of y ({what})")
        errs.append(err)
        if name == "forward":
            start = y_fwd = yp
    return errs[0], errs[1], plain_ms[0], plain_ms[1], y_fwd


def time_sweeps(store, levels, y0, y_fwd, work):
    """(ms fwd, device ms fwd, ms bwd, device ms bwd) of the kernels over
    ``levels``, each run on a fresh copy of its input."""
    out = []
    y = torch.empty_like(y0)
    for src, order, fn in ((y0, levels, sweep_kernels.sweep_fwd),
                           (y_fwd, levels[::-1], sweep_kernels.sweep_bwd)):
        def run():
            for lvl in order:
                fn(store, y, lvl, work)

        out.append(time_each_ms(lambda: y.copy_(src), run, reps=5))
        y.copy_(src)
        out.append(queued_ms([run]))
    return out


def each_device_ms(thunks):
    """Device time in ms of each of the calls ``thunks``, run in order and
    queued behind a spin kernel so that the host's launch cost does not
    enter."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(thunks) + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(20.0 * SPIN_CYCLES_PER_MS))
    events[0].record()
    for fn, ev in zip(thunks, events[1:]):
        fn()
        ev.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def level_device_ms(store, order, src, work, fn):
    """Device time in ms of each call ``fn(store, y, lvl, work)`` for ``lvl`` in
    ``order``, ``y`` a copy of ``src``."""
    y = src.clone()
    return each_device_ms([lambda lvl=lvl: fn(store, y, lvl, work) for lvl in order])


def kernel_sweep_cases():
    """The sweep kernels on one synthetic level per front size, against the
    plain versions, with time and bound."""
    out_rows = []
    for dtype in (torch.float32, torch.float64):
        for name, specs in sweep_case_specs():
            Fpad, fronts = specs[0]
            store, lvl, y0 = sweep_level(specs, dtype, seed=Fpad)
            work = torch.full((lvl.work_size,), float("nan"), dtype=dtype, device="cuda")
            err_f, err_b, plain_f, plain_b, y_fwd = compare_sweeps(
                store, [lvl], y0, work, name)
            ms_f, dev_f, ms_b, dev_b = time_sweeps(store, [lvl], y0, y_fwd, work)
            bound_f, by_f = sweep_kernels.sweep_bound_ms(lvl, dtype, "fwd")
            bound_b, by_b = sweep_kernels.sweep_bound_ms(lvl, dtype, "bwd")
            out_rows.append(dict(
                dtype=str(dtype).split(".")[1], Fpad=Fpad, case=name, fronts=len(fronts),
                wave_items_fwd=int(lvl.fwd_wave.shape[0]),
                wave_items_bwd=int(lvl.bwd_wave.shape[0]), flags=lvl.n_flags,
                launches_fwd=lvl.fwd_kernels,
                launches_bwd=lvl.bwd_kernels, max_abs_err_fwd=err_f, max_abs_err_bwd=err_b,
                ms_fwd=ms_f, device_ms_fwd=dev_f, plain_ms_fwd=plain_f, bound_ms_fwd=bound_f,
                ms_bwd=ms_b, device_ms_bwd=dev_b, plain_ms_bwd=plain_b, bound_ms_bwd=bound_b,
                bound_by=by_f if by_f == by_b else f"{by_f}/{by_b}"))
            del store, lvl, y0, work
    return out_rows


FPAD_LADDER = (8, 16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
               4096)


def ea_level(specs, seed):
    """A synthetic tree level for the extend-add kernel: parents ``specs =
    [(Fd, [children per parent, ...], umax), ...]``, one group per entry; each
    child has u in 1..min(Fd, umax), a random strictly increasing ppos and a
    front of the smallest ladder size that holds ``sncols + u`` (sncols in
    0..3), its Schur block random and NaN in every other entry of its front;
    parent entries that a child reaches are random, the others NaN.  Returns
    (store as float64 numpy, batches for ``build_ea_level``, mask of the reached
    parent entries)."""
    rng = np.random.default_rng(seed)
    groups, kids = [], []
    off = 0
    for Fd, counts, umax in specs:
        groups.append((off, Fd, []))
        for p, nkids in enumerate(counts):
            for _ in range(nkids):
                u = int(rng.integers(1, min(Fd, umax) + 1))
                nc = int(rng.integers(0, 4))
                fps = next(f for f in FPAD_LADDER if f >= nc + u)
                ppos = np.sort(rng.choice(Fd, u, replace=False)).astype(np.int64)
                groups[-1][2].append(dict(sncols=nc, fp_src=fps, u=u, ppos=ppos, ppar=p))
                kids.append(groups[-1][2][-1])
        off += len(counts) * Fd * Fd
    for o in kids:
        o["sbase"] = off
        off += o["fp_src"] ** 2
    store = np.full(off + 1, np.nan)
    reached = np.zeros(off + 1, bool)
    for goff, Fd, recs in groups:
        for o in recs:
            pp = o["ppos"]
            reached[(goff + o["ppar"] * Fd * Fd + pp[:, None] * Fd + pp[None, :]).ravel()] = True
    store[reached] = rng.normal(size=int(reached.sum()))
    for o in kids:
        nc, u, fps = o["sncols"], o["u"], o["fp_src"]
        F = store[o["sbase"]:o["sbase"] + fps * fps].reshape(fps, fps)
        F[nc:nc + u, nc:nc + u] = rng.normal(size=(u, u))
    return store, groups, reached


EA_CASES = [                     # (case, seed, parents: (Fd, children per parent, umax))
    ("8", 8, [(8, [1, 2, 4, 16] * 256, 8)]),
    ("32", 32, [(32, [1, 2, 4, 16] * 64, 32), (8, [3, 1] * 64, 8)]),
    ("128", 128, [(128, [1, 2, 4, 16] * 8, 128)]),
    ("512", 512, [(512, [1, 2, 4, 16], 512)]),
    ("4096", 4096, [(4096, [1, 2], 4096), (4096, [16], 512)]),
    # more pairs in a tile than a warp has lanes
    ("heavy", 64, [(64, [40, 40, 33] * 16, 32)]),
    # odd counts of parents of 8, 16 and 64: packed four and two to a warp
    ("packed", 65, [(8, [3, 1, 5, 2, 9] * 101, 8), (16, [2, 7, 1] * 151, 16),
                    (64, [3, 1, 2, 1, 4] * 21, 40)])]


def same_bits(a, b) -> bool:
    """Bitwise equality of two float tensors, NaN included."""
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


def kernel_ea_cases():
    """The extend-add kernel on one synthetic level per parent size, against
    its plain version (bitwise), with time and bound."""
    out_rows = []
    for case, seed, specs in EA_CASES:
        Fd = specs[0][0]
        store64, batches, reached = ea_level(specs, seed=seed)
        lvl = ea_kernels.build_ea_level(batches, "cuda")
        reached = torch.as_tensor(reached, device="cuda")
        for dtype in (torch.float32, torch.float64):
            store = torch.as_tensor(store64, dtype=dtype, device="cuda")
            got, ref = store.clone(), store.clone()
            before = ea_kernels.ea_counts()
            ea_kernels.extend_add(got, lvl)
            made = ea_kernels.ea_counts()["kernels"] - before["kernels"]
            check(made == lvl.kernels, f"extend_add: the launcher reports {made} kernel "
                  f"launches, the table calls for {lvl.kernels} ({case})")
            plain_ms = event_ms(lambda: ea_kernels.extend_add_plain(ref, lvl))
            check(same_bits(got, ref), f"extend_add kernel and plain version differ "
                  f"({case}, {dtype})")
            check(bool(torch.isfinite(got[reached]).all()),
                  f"extend_add kernel: non-finite destination ({case}, {dtype})")
            again = store.clone()
            ea_kernels.extend_add(again, lvl)
            check(same_bits(again, got), f"extend_add kernel: two runs differ ({case})")
            ms = time_each_ms(lambda: got.copy_(store),
                              lambda: ea_kernels.extend_add(got, lvl), reps=5)
            copies = [store.clone() for _ in range(5)]
            dev_ms = queued_ms([lambda c=c: ea_kernels.extend_add(c, lvl)
                                for c in copies]) / len(copies)
            bound, by = ea_kernels.ea_bound_ms(lvl, dtype)
            out_rows.append(dict(
                dtype=str(dtype).split(".")[1], case=case, Fd=Fd, parents=sum(
                    len(c) for _, c, _ in specs), children=len(lvl.children),
                entries=int((lvl.children[:, 2] ** 2).sum()),
                tiles=int(lvl.tiles.shape[0]), pairs=int(lvl.pairs.shape[0]),
                max_pairs_per_tile=int(lvl.tile_fields()[3].max()), warps=lvl.warps,
                launches=lvl.kernels, bitwise_equal=True, max_abs_err=0.0, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by))
            del store, got, ref, again, copies
        del store64, lvl, reached
    return out_rows


def kkt_matvec(qp, D_x, C_diag, u):
    n = qp.n
    u1, u2 = u[:n], u[n:]
    return torch.cat([qp.Hx(u1) + D_x * u1 + qp.Aty(u2),
                      qp.Ax(u1) - C_diag * u2])


def phase_kkt(qp):
    """Factorize + solve at full size."""
    n, m = qp.n, qp.m
    t0 = time.perf_counter()
    plan = sparse_kkt_plan(qp.h_pat, qp.a_pat, n)
    t_analyse = time.perf_counter() - t0
    sym = plan.sym
    hist: dict = {}
    for g in sym.groups:
        hist[g.Fpad] = hist.get(g.Fpad, 0) + g.nb
    t0 = time.perf_counter()
    dev = supernodal_flat._device_plan(sym, qp.g.device)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    D_x = torch.ones(n, dtype=qp.g.dtype, device=qp.g.device)
    C_diag = torch.ones(m, dtype=qp.g.dtype, device=qp.g.device)
    ctl = IPMControl()
    rho = ctl.rho if ctl.rho else 1e-8

    def factorize():
        return sparse_kkt_factorize(plan, qp.h_vals, qp.a_vals, D_x, C_diag,
                                    rho=rho, delta=ctl.delta)

    factorize()                                   # warm-up
    torch.cuda.synchronize()
    samples = []
    for _ in range(3):
        ldlt_kernels.reset_launch_count()
        ea_kernels.reset_ea_counts()
        t0 = time.perf_counter()
        fac, S = factorize()
        t_enq = time.perf_counter() - t0          # host returns; device may lag
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0, t_enq))
    samples.sort()
    t_factor, t_factor_enqueue = samples[1]       # the median factorization
    launches = ldlt_kernels.launch_count()
    wide_calls = ldlt_kernels.wide_launch_count()       # one launch per call
    ea = ea_kernels.ea_counts()
    inertia = fac.inertia.tolist()
    check(inertia == [n, m, 0], f"inertia {inertia} != {[n, m, 0]}")
    check(launches > 0, "the small-front factor kernel was not launched")
    wide_levels = sum(lvp["wide"] is not None for lvp in dev["levels"])
    check(wide_calls > 0, "the wide-front kernel was not launched")
    check(wide_calls == wide_levels <= MAX_WIDE_CALLS_PER_FACTORIZATION,
          f"{wide_calls} wide-front calls in one factorization (levels with wide fronts "
          f"{wide_levels}, limit {MAX_WIDE_CALLS_PER_FACTORIZATION})")
    check(ldlt_kernels.wide_plain_count() == 0,
          "the plain wide-front code ran in a factorization on the card")
    ea_levels = sum(lvp["ea"] is not None for lvp in dev["levels"])
    check(ea["calls"] > 0 and ea["kernels"] > 0, "the extend-add kernel was not launched")
    check(ea["plain"] == 0, "the plain extend-add ran in a factorization on the card")
    check(ea["calls"] == ea_levels <= MAX_EA_CALLS_PER_FACTORIZATION,
          f"{ea['calls']} extend-add calls in one factorization (levels with children "
          f"{ea_levels}, limit {MAX_EA_CALLS_PER_FACTORIZATION})")

    b = torch.as_tensor(np.random.default_rng(1).normal(size=n + m),
                        device=qp.g.device)
    kkt_solve = qp.build_kkt(D_x, C_diag, ctl)
    kkt_solve(b[:n], b[n:])                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dx, mdy = kkt_solve(b[:n], b[n:])
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0            # 3 solves + 2 matvecs
    u = torch.cat([dx, -mdy])
    rel = float((kkt_matvec(qp, D_x, C_diag, u) - b).norm() / b.norm())
    check(rel <= 1e-10, f"KKT residual {rel:.3e} > 1e-10 after refine=2")
    solve_samples = []
    for _ in range(5):
        sweep_kernels.reset_sweep_counts()
        t0 = time.perf_counter()
        plan.solve((fac, S), b)
        t_enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        solve_samples.append((time.perf_counter() - t0, t_enq))
    solve_samples.sort()
    t_one_solve, t_one_solve_enqueue = solve_samples[2]      # the median solve
    sweeps = sweep_kernels.sweep_counts()
    check(sweeps["fwd"] > 0 and sweeps["bwd"] > 0,
          "a solve on the card did not launch the sweep kernels")
    check(sweeps["plain"] == 0, "the plain sweeps ran in a solve on the card")
    sweep_launches = sweeps["fwd_kernels"] + sweeps["bwd_kernels"]
    check(sweep_launches <= MAX_SWEEP_LAUNCHES_PER_SOLVE,
          f"{sweep_launches} sweep kernel launches in one solve > "
          f"{MAX_SWEEP_LAUNCHES_PER_SOLVE}")
    sweep_levels = [lvp["sweep"] for lvp in dev["levels"]]
    per_level = {d: [getattr(lvl, d + "_kernels") for lvl in sweep_levels]
                 for d in ("fwd", "bwd")}
    for d, most in MAX_SWEEP_LAUNCHES_PER_LEVEL.items():
        check(sweeps[d] == len(sweep_levels) and sweeps[d + "_kernels"] == sum(per_level[d])
              and max(per_level[d]) <= most,
              f"{d} sweeps: {sweeps[d]} calls / {sweeps[d + '_kernels']} launches in one "
              f"solve; the tables call for {per_level[d]} per level, limit {most}")
    try:
        sweep_kernels.sweep_check(sweep_levels)
    except RuntimeError as exc:
        raise SmokeFailure(f"flagship solve: {exc}")
    emit("kkt", n=n, m=m, n_kkt=n + m, S=sym.S, nnz_L=sym.nnz_L, ns=sym.ns,
         flops_model=sym.flops, groups=len(sym.groups),
         levels=len(dev["levels"]),
         ea_ops=ea_levels,
         fpad_histogram={str(k): v for k, v in sorted(hist.items())},
         store_bytes=(sym.S + 1) * 8, inertia=inertia,
         rel_residual=rel, dmin=float(fac.dmin),
         analyse_s=t_analyse, plan_upload_s=t_upload, factorize_s=t_factor,
         factorize_host_enqueue_s=t_factor_enqueue,
         factorize_enqueue_share=t_factor_enqueue / t_factor,
         factorize_samples_s=[round(a, 6) for a, _ in samples],
         refined_solve_s=t_solve, one_solve_s=t_one_solve,
         one_solve_host_enqueue_s=t_one_solve_enqueue,
         one_solve_enqueue_share=t_one_solve_enqueue / t_one_solve,
         one_solve_samples_s=[round(a, 6) for a, _ in solve_samples],
         sweep_calls_per_solve=sweeps["fwd"] + sweeps["bwd"],
         sweep_kernel_launches_per_solve=sweep_launches,
         sweep_fwd_kernel_launches_per_solve=sweeps["fwd_kernels"],
         sweep_bwd_kernel_launches_per_solve=sweeps["bwd_kernels"],
         sweep_fwd_launches_per_level=per_level["fwd"],
         sweep_bwd_launches_per_level=per_level["bwd"],
         sweep_wave_items=[int(lvl.fwd_wave.shape[0]) for lvl in sweep_levels],
         sweep_wave_flags=[lvl.n_flags for lvl in sweep_levels],
         kernel_launches_per_factorization=launches,
         wide_calls_per_factorization=wide_calls,
         wide_plain_calls=ldlt_kernels.wide_plain_count(),
         ea_calls_per_factorization=ea["calls"],
         ea_kernel_launches_per_factorization=ea["kernels"],
         ea_children=sum(len(lvp["ea"].children) for lvp in dev["levels"] if lvp["ea"]),
         ea_entries=sum(int((lvp["ea"].children[:, 2] ** 2).sum())
                        for lvp in dev["levels"] if lvp["ea"]),
         ea_tiles=sum(int(lvp["ea"].tiles.shape[0]) for lvp in dev["levels"] if lvp["ea"]),
         ea_pairs=sum(int(lvp["ea"].pairs.shape[0]) for lvp in dev["levels"] if lvp["ea"]),
         wide_fronts=sum(len(lv["wide"].fronts) for lv in dev["levels"] if lv["wide"]),
         wide_levels=wide_levels,
         wide_panel_steps=[lv["wide"].steps for lv in dev["levels"] if lv["wide"]])
    return plan, D_x, C_diag, b, launches


def phase_repeat(qp, plan, D_x, C_diag, b):
    ctl = IPMControl()
    outs = []
    for _ in range(2):
        fac, S = sparse_kkt_factorize(plan, qp.h_vals, qp.a_vals, D_x, C_diag,
                                      rho=1e-8, delta=ctl.delta)
        dx, mdy = qp.build_kkt(D_x, C_diag, ctl)(b[:qp.n], b[qp.n:])
        torch.cuda.synchronize()
        outs.append((fac.store, dx, mdy))
    same_store = torch.equal(outs[0][0], outs[1][0])
    same_x = torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2])
    check(same_store, "factor store differs between two runs")
    check(same_x, "KKT solution differs between two runs")
    emit("repeat", store_bitwise_equal=same_store, solution_bitwise_equal=same_x)


def host_kkt(qp, x, y, z):
    """KKT error in float64 on the host with scipy (as the JAX package's
    bench.py computes it for the same problem)."""
    import scipy.sparse as sp

    n, m = qp.n, qp.m
    xd, yd, zd = (np.asarray(v.cpu(), np.float64) for v in (x, y, z))
    H = sp.csr_matrix((np.asarray(qp.h_vals.cpu(), np.float64),
                       (qp.h_pat.rows, qp.h_pat.cols)), shape=(n, n))
    H = H + sp.tril(H, -1).T
    A = sp.csr_matrix((np.asarray(qp.a_vals.cpu(), np.float64),
                       (qp.a_pat.rows, qp.a_pat.cols)), shape=(m, n))
    g64 = np.asarray(qp.g.cpu(), np.float64)
    r_d = float(np.max(np.abs(H @ xd + g64 - A.T @ yd - zd)))
    slack = A @ xd
    r_p = float(max(np.max(np.maximum(1.0 - slack, 0.0), initial=0.0),
                    np.max(np.maximum(xd - 2.0, 0.0), initial=0.0),
                    np.max(np.maximum(-xd, 0.0), initial=0.0)))
    comp = float(max(np.max(np.abs(xd * np.maximum(zd, 0.0)), initial=0.0),
                     np.max(np.abs((2.0 - xd) * np.maximum(-zd, 0.0)), initial=0.0),
                     np.max(np.abs((slack - 1.0) * np.maximum(yd, 0.0)), initial=0.0)))
    return max(r_p, r_d, comp), r_p, r_d, comp


@contextlib.contextmanager
def fused_path(on: bool):
    """Run ``ipm_solve`` on the graph path (``on``) or the direct one
    (``GALAHAD_TPU_FUSED=0``)."""
    saved = os.environ.get("GALAHAD_TPU_FUSED")
    os.environ["GALAHAD_TPU_FUSED"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["GALAHAD_TPU_FUSED"]
        else:
            os.environ["GALAHAD_TPU_FUSED"] = saved


def counted_solve(qp, ctl, solver=ipm_solve):
    """One solve with the kernels' counters set to 0 just before and read just
    after.  Returns (x, y, z, state, wall seconds, peak device bytes, device
    launches by counter).  On the graph path the wrappers count once while the
    step is captured, and the card launches that step's kernels in every replay:
    device launches = counted - per replay + replays x per replay."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ldlt_kernels.reset_launch_count()
    sweep_kernels.reset_sweep_counts()
    ea_kernels.reset_ea_counts()
    banded_kernels.reset_banded_counts()
    t0 = time.perf_counter()
    x, y, z, st = solver(qp, ctl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = launch_counts()
    per = st.run.launches_per_replay or {k: 0 for k in counted}
    device = {k: counted[k] + (st.run.replays - 1) * per[k] if st.run.replays else counted[k]
              for k in counted}
    return x, y, z, st, wall, torch.cuda.max_memory_allocated(), device


# the spans a graph-path solve of the flagship opens at least once
SOLVE_SPANS = ("ipm.solve", "ipm.prepare", "ipm.analyse", "stepper.direct",
               "stepper.capture", "stepper.instantiate", "stepper.replays", "stepper.fetch",
               "stepper.release", "ipm.finish", "kkt.assemble", "kkt.factor", "kkt.solve",
               "coo.matvec")


def phase_flagship(qp, launches_per_factorization: int):
    """The main path: ``ipm_solve`` with the default control, on its default
    path on the card (the captured iteration).  The launch counts are set to 0
    just before and read just after."""
    ctl = IPMControl()
    spans_before = trace.totals()
    x, y, z, st, wall, peak_bytes, counts = counted_solve(qp, ctl)
    spans = {name: [calls - spans_before.get(name, (0, 0.0))[0],
                    sec - spans_before.get(name, (0, 0.0))[1]]
             for name, (calls, sec) in trace.totals().items()}
    launches = counts["partial_ldlt"]
    wide_calls = counts["ldlt_wide"]                    # one launch per call
    wide_plain = counts["ldlt_wide_plain"]
    ea = dict(calls=counts["extend_add"], kernels=counts["extend_add_kernels"],
              plain=counts["extend_add_plain"])
    sweeps = dict(fwd=counts["sweep_fwd"], bwd=counts["sweep_bwd"],
                  fwd_kernels=counts["sweep_fwd_kernels"],
                  bwd_kernels=counts["sweep_bwd_kernels"], plain=counts["sweep_plain"])
    # small-front factor calls per factorization, as the kkt phase counted them
    factorizations = launches / launches_per_factorization
    check(st.run.path == "graph", f"the main path ran {st.run.path}, not the captured graph")
    check(st.status == int(Status.OK), f"flagship status {st.status} != 0")
    check(x.shape == (qp.n,) and y.shape == (qp.m,) and z.shape == (qp.n,),
          "flagship solution has the wrong shape")
    check(bool(torch.isfinite(x).all() and torch.isfinite(y).all()
               and torch.isfinite(z).all()), "flagship solution is not finite")
    kkt, r_p, r_d, comp = host_kkt(qp, x, y, z)
    check(kkt <= 1e-6, f"flagship host KKT error {kkt:.3e} > 1e-6")
    check(launches > 0, "the main path did not launch the small-front factor kernel")
    check(wide_calls > 0, "the main path did not launch the wide-front kernel")
    check(wide_plain == 0, "the main path entered the plain wide-front code on the card")
    check(wide_calls <= MAX_WIDE_CALLS_PER_FACTORIZATION * factorizations,
          f"{wide_calls} wide-front calls in {factorizations:g} factorizations")
    check(sweeps["fwd"] > 0, "the main path did not launch the forward sweep kernels")
    check(sweeps["bwd"] > 0, "the main path did not launch the backward sweep kernels")
    check(sweeps["plain"] == 0, "the main path entered the plain sweeps on the card")
    check(ea["calls"] > 0, "the main path did not launch the extend-add kernel")
    check(ea["plain"] == 0, "the main path entered the plain extend-add on the card")
    check(ea["calls"] <= MAX_EA_CALLS_PER_FACTORIZATION * factorizations,
          f"{ea['calls']} extend-add calls in {factorizations:g} factorizations")
    missing = [k for k in SOLVE_SPANS if spans.get(k, [0])[0] == 0]
    check(not missing, f"the solve recorded no span {missing}")
    emit("flagship", status=st.status, iterations=st.iter, maxit_cut=None, path=st.run.path,
         host_kkt=kkt, host_r_p=r_p, host_r_d=r_d, host_comp=comp,
         objective=st.inform.obj, wall_s=wall, s_per_iteration=wall / max(st.iter, 1),
         analyse_s=st.inform.time.analyse, solve_s=st.inform.time.solve,
         capture_s=st.run.capture_s, instantiate_s=st.run.instantiate_s,
         replays=st.run.replays, replay_s=st.run.replay_s,
         kernel_launches=launches, wide_calls=wide_calls, wide_plain_calls=wide_plain,
         wide_calls_per_factorization=wide_calls / factorizations,
         sweep_fwd_calls=sweeps["fwd"], sweep_bwd_calls=sweeps["bwd"],
         sweep_fwd_kernel_launches=sweeps["fwd_kernels"],
         sweep_bwd_kernel_launches=sweeps["bwd_kernels"],
         sweep_plain_calls=sweeps["plain"],
         ea_calls=ea["calls"], ea_kernel_launches=ea["kernels"], ea_plain_calls=ea["plain"],
         factorizations=factorizations,
         ea_calls_per_factorization=ea["calls"] / factorizations,
         ea_kernel_launches_per_factorization=ea["kernels"] / factorizations,
         peak_device_memory_bytes=peak_bytes,
         spans_of_the_solve=spans)
    out = {k: counts[k] for k in KERNEL_COUNTS}
    out["per_replay"] = st.run.launches_per_replay
    return out, (x, y, z, kkt)


def phase_fused(qp, flagship_solution):
    """The direct and the graph path on the flagship in one call (direct,
    graph, graph, direct), then ``steps_per_fetch=4`` and
    ``ipm_solve_compiled`` on the graph path: x, y, z and the host KKT
    bitwise equal on every run and to the main path's, every hand kernel
    launched in each replay, no plain code, every sweep level checked at
    every fetch."""
    t_phase = time.perf_counter()
    rows = []
    ref = flagship_solution
    for label, on, solver, ctl in (
            ("direct", False, ipm_solve, IPMControl()),
            ("graph", True, ipm_solve, IPMControl()),
            ("graph", True, ipm_solve, IPMControl()),
            ("direct", False, ipm_solve, IPMControl()),
            ("graph_steps_per_fetch_4", True, ipm_solve, IPMControl(steps_per_fetch=4)),
            ("graph_ipm_solve_compiled", True, ipm_solve_compiled, IPMControl())):
        with fused_path(on):
            x, y, z, st, wall, peak, counts = counted_solve(qp, ctl, solver)
        run = st.run
        kkt = host_kkt(qp, x, y, z)[0]
        got = (x, y, z, kkt)
        check(st.status == int(Status.OK), f"fused phase, {label}: status {st.status}")
        check(run.path == ("graph" if on else "direct"),
              f"fused phase, {label}: ran the {run.path} path")
        check(all(same_bits(a, b) for a, b in zip(got[:3], ref[:3])) and kkt == ref[3],
              f"fused phase, {label}: x, y, z or the host KKT differ from the main path's")
        check(all(counts[k] == 0 for k in PLAIN_COUNTS),
              f"fused phase, {label}: plain code ran on the card: "
              f"{ {k: counts[k] for k in PLAIN_COUNTS} }")
        check(run.sweep_checks == run.fetches > 0,
              f"fused phase, {label}: {run.sweep_checks} sweep checks in {run.fetches} fetches")
        per = run.launches_per_replay
        if on:
            check(all(per[k] > 0 for k in KERNEL_COUNTS),
                  f"fused phase, {label}: a hand kernel is missing from the captured "
                  f"iteration: {per}")
            check(run.direct_steps == 1 and run.replays - run.halted_replays == st.iter - 1,
                  f"fused phase, {label}: {run.direct_steps} direct steps, {run.replays} "
                  f"replays ({run.halted_replays} halted) for {st.iter} iterations")
        rows.append(dict(
            run=label, path=run.path, wall_s=wall, s_per_iteration=wall / max(st.iter, 1),
            status=st.status, iterations=st.iter, host_kkt=kkt,
            capture_s=run.capture_s, instantiate_s=run.instantiate_s, replays=run.replays,
            replay_s=run.replay_s, s_per_replay=run.replay_s / max(run.replays, 1),
            halted_replays=run.halted_replays, direct_steps=run.direct_steps,
            fetches=run.fetches, sweep_checks=run.sweep_checks,
            launches_per_replay=({k: per[k] for k in KERNEL_COUNTS} if per else None),
            plain_counts={k: counts[k] for k in PLAIN_COUNTS},
            device_launches={k: counts[k] for k in KERNEL_COUNTS},
            peak_device_memory_bytes=peak,
            bitwise_equal_to_main_path=True))
    emit("fused", runs=rows, replay_device_ms=replay_device_ms(qp),
         seconds=time.perf_counter() - t_phase)


def replay_device_ms(qp, ctl=None, reps: int = 10, halted: bool = True) -> float:
    """Device time of one replay of the captured iteration of ``qp`` under
    ``ctl`` (default control): the solve is run to its halt, then ``reps``
    more replays (steps on the halted state: the same kernels on the same
    shapes, whose result is discarded) are timed by an event pair; the host
    enqueues a replay in far less time than the card runs it.  With
    ``halted=False`` the ``reps`` replays follow the capture at once (steps
    3, 4, ... of the solve, which the state has not finished): for a problem
    whose replay takes seconds."""
    from galahad_tpu_torch.core.problem import classify_bounds
    from galahad_tpu_torch.qp import ipm

    ctl = ctl or IPMControl()
    masks = classify_bounds(qp, ctl.infinity)
    with fused_path(True):
        stepper = ipm._stepper(qp, masks, ipm.ipm_init(qp, masks, ctl), ctl)
    halt = ipm.MONITOR.index("halt")
    if halted:
        stepper.run_to_halt(lambda v: v[halt] != 0)
    else:
        stepper.advance(2)                      # the direct step, then the capture
        torch.cuda.synchronize()
    check(stepper.stats.path == "graph" and stepper.stats.replays > 0,
          "replay timing: no graph was captured")
    ms = event_ms(lambda: stepper.advance(reps)) / reps
    del stepper
    return ms


def sweep_kernel_entries(qp, plan, D_x, C_diag, b, main_path_launches):
    """The two sweep entries of the ``kernels`` line: all calls of one
    ``flat_solve`` of the flagship KKT system (one per tree level and
    direction), replayed on that solve's own inputs: the factor store of the
    scaled KKT matrix and the scaled, permuted right-hand side."""
    ctl = IPMControl()
    (fac, S) = sparse_kkt_factorize(plan, qp.h_vals, qp.a_vals, D_x, C_diag,
                                    rho=ctl.rho if ctl.rho else 1e-8, delta=ctl.delta)
    sym = plan.sym
    dev = supernodal_flat._device_plan(sym, b.device)
    levels = [lvp["sweep"] for lvp in dev["levels"]]
    store = fac.store
    y0 = torch.zeros(sym.n + 1, dtype=b.dtype, device=b.device)
    y0[:sym.n] = (S * b).index_select(0, dev["perm"])
    work = torch.empty(dev["sweep_scratch"], dtype=b.dtype, device=b.device)
    err_f, err_b, plain_f, plain_b, y_fwd = compare_sweeps(
        store, levels, y0, work, "the flagship's solve")
    ms_f, dev_f, ms_b, dev_b = time_sweeps(store, levels, y0, y_fwd, work)
    fronts = sum(int((lvl.fronts[:, 1] > 0).sum()) for lvl in levels)
    per_level = dict(
        sweep_fwd=level_device_ms(store, levels, y0, work, sweep_kernels.sweep_fwd),
        sweep_bwd=level_device_ms(store, levels[::-1], y_fwd, work,
                                  sweep_kernels.sweep_bwd)[::-1])
    entries = []
    for name, which, replaces, err, ms, dev_ms, plain in (
            ("sweep_fwd", "fwd", TPU_FWD_SWEEP, err_f, ms_f, dev_f, plain_f),
            ("sweep_bwd", "bwd", TPU_BWD_SWEEP, err_b, ms_b, dev_b, plain_b)):
        tb, to = sweep_kernels.sweep_bound_terms(levels, b.dtype, which)
        n_kernels = sum(getattr(lvl, which + "_kernels") for lvl in levels)
        entries.append(dict(
            name=name, route="cuda", source=SWEEP_SOURCE, replaces=replaces,
            launches=main_path_launches[name],
            launches_per_replay=main_path_launches["per_replay"][name],
            max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain, bound_ms=max(tb, to) * 1e3,
            bound_by="bytes" if tb >= to else "operations", library_ms=None,
            library_ms_reason="no single PyTorch call gathers, solves a batch of "
                              "ragged partial triangles and scatters",
            kernel_launches=main_path_launches[name + "_kernels"],
            per=f"one flat_solve of the flagship KKT ({len(levels)} calls, one per "
                f"tree level, {n_kernels} kernel launches)",
            fronts=fronts,
            device_ms_per_tree_level=[round(t, 4) for t in per_level[name]],
            kernel_launches_per_tree_level=[getattr(lvl, which + "_kernels")
                                            for lvl in levels]))
    return entries


def ea_kernel_entry(sym, store0, main_path_launches):
    """The ``extend_add`` entry of the ``kernels`` line: all calls of one
    factorization of the flagship KKT (one per tree level with children),
    replayed level after level on a copy of that factorization's store (each
    child's Schur block is what the factorization read; the parent fronts
    hold their factors, which the replay adds onto)."""
    dev = supernodal_flat._device_plan(sym, store0.device)
    levels = [lvp["ea"] for lvp in dev["levels"] if lvp["ea"] is not None]
    got, ref = store0.clone(), store0.clone()
    for lvl in levels:
        ea_kernels.extend_add(got, lvl)
    plain_ms = event_ms(lambda: [ea_kernels.extend_add_plain(ref, lvl) for lvl in levels])
    check(same_bits(got, ref), "extend_add kernel and plain version differ on the "
          "flagship's levels")
    check(bool(torch.isfinite(got[:sym.S]).all()), "extend_add: non-finite store")
    del got, ref

    def run():
        for lvl in levels:
            ea_kernels.extend_add(work, lvl)

    work = store0.clone()
    ms = time_each_ms(lambda: work.copy_(store0), run, reps=5)
    work.copy_(store0)
    dev_ms = queued_ms([run])
    work.copy_(store0)
    per_level = each_device_ms([lambda lvl=lvl: ea_kernels.extend_add(work, lvl)
                                for lvl in levels])
    del work
    tb, to = ea_kernels.ea_bound_terms(levels, store0.dtype)
    attributes = {str(dt).split(".")[1]: ea_kernels.ea_attributes(dt)
                  for dt in (torch.float32, torch.float64)}
    check(all(a["spill_bytes"] == 0 for a in attributes.values()),
          f"extend_add kernel spills: {attributes}")
    return dict(
        name="extend_add", route="cuda", source=EA_SOURCE, replaces=TPU_EA,
        launches=main_path_launches["extend_add"],
        launches_per_replay=main_path_launches["per_replay"]["extend_add"],
        max_abs_err=0.0, bitwise_equal=True,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=max(tb, to) * 1e3,
        bound_by="bytes" if tb >= to else "operations", library_ms=None,
        library_ms_reason="no single PyTorch call gathers ragged blocks and adds them "
                          "through a position map",
        kernel_launches=main_path_launches["extend_add_kernels"],
        per=f"one factorization of the flagship KKT ({len(levels)} calls, one per tree "
            f"level with children)",
        children=sum(len(lvl.children) for lvl in levels),
        entries=sum(int((lvl.children[:, 2] ** 2).sum()) for lvl in levels),
        dest_entries=sum(lvl.dest_entries for lvl in levels),
        tiles=sum(int(lvl.tiles.shape[0]) for lvl in levels),
        kernel_attributes=attributes,
        device_ms_per_tree_level=[round(t, 4) for t in per_level],
        bound_ms_per_tree_level=[round(ea_kernels.ea_bound_ms(lvl, store0.dtype)[0], 4)
                                 for lvl in levels],
        tiles_per_tree_level=[int(lvl.tiles.shape[0]) for lvl in levels],
        warps_per_tree_level=[lvl.warps for lvl in levels],
        pairs_per_tree_level=[int(lvl.pairs.shape[0]) for lvl in levels],
        max_pairs_per_tile_per_tree_level=[int(lvl.tile_fields()[3].max()) for lvl in levels])


EA_ELEMS = 1 << 24               # the bucketed composition's cap of nc * Um^2 per op


def parent_ea_ops(sym, device):
    """Per tree level, the ops of the bucketed extend-add that the kernel
    replaced: child records grouped by padded shape (Um = max(8, next power of
    2 of u), fps), split into occurrence layers of same-parent children, ppos
    padded to Um with -1."""
    by_level: dict = {}
    for g in sym.groups:
        by_level.setdefault(g.level, []).append(g)
    out = []
    for lv in sorted(by_level):
        ops = []
        for g in by_level[lv]:
            by_shape: dict = {}
            for o in g.ea:
                Um = max(8, 1 << (o["u"] - 1).bit_length())
                by_shape.setdefault((Um, o["fp_src"]), []).append(o)
            for (Um, fps), olist in sorted(by_shape.items()):
                layers: list = []
                seen: dict = {}
                for o in olist:
                    j = seen.get(o["ppar"], 0)
                    seen[o["ppar"]] = j + 1
                    if len(layers) <= j:
                        layers.append([])
                    layers[j].append(o)
                cap = max(1, EA_ELEMS // (Um * Um))
                for lay in layers:
                    for s0 in range(0, len(lay), cap):
                        sub = lay[s0:s0 + cap]
                        pt = np.full((len(sub), Um), -1, np.int64)
                        for k, o in enumerate(sub):
                            pt[k, :o["u"]] = o["ppos"]
                        ops.append(dict(
                            Um=Um, fps=fps, Fd=g.Fpad,
                            sstart=torch.as_tensor([o["sbase"] + o["sncols"] * fps
                                                    + o["sncols"] for o in sub],
                                                   device=device),
                            pbase=torch.as_tensor([g.goff + o["ppar"] * g.Fpad * g.Fpad
                                                   for o in sub], device=device),
                            ppos=torch.as_tensor(pt, device=device)))
        out.append(ops)
    return out


def parent_ea_indices(o, S: int):
    """(source, destination, real-entry mask) of one bucketed op, padded
    positions routed to the spare slot ``S`` as the replaced code did."""
    Um, fps, Fd = o["Um"], o["fps"], o["Fd"]
    ar = torch.arange(Um, device=o["ppos"].device)
    pp = o["ppos"]
    valid = pp >= 0
    mask = (valid[:, :, None] & valid[:, None, :]).reshape(-1)
    src = (o["sstart"][:, None, None] + (ar * fps)[None, :, None]
           + ar[None, None, :]).reshape(-1)
    dst = ((o["pbase"][:, None] + pp * Fd)[:, :, None] + pp[:, None, :]).reshape(-1)
    return torch.where(mask, src, S), torch.where(mask, dst, S), mask


def parent_ea_apply(store, o, S: int) -> None:
    """One bucketed op as the replaced code ran it."""
    src, dst, _ = parent_ea_indices(o, S)
    store.index_add_(0, dst, store.index_select(0, src))


def phase_spare_slot(sym, store0, kernel_entry):
    """The bucketed extend-add that the kernel replaced, on the levels of one
    flagship factorization, replayed on ``store0`` as the kernel entry does:
    held bitwise to the kernel, then timed as it ran (index lists built in
    every op) and, with the lists built beforehand, once with its padded
    entries (all routed to the spare slot S as atomic adds on one address) and
    once with them dropped."""
    t0 = time.perf_counter()
    S = sym.S
    dev = supernodal_flat._device_plan(sym, store0.device)
    ops_by_level = parent_ea_ops(sym, store0.device)
    old, new = store0.clone(), store0.clone()
    for lvp, ops in zip(dev["levels"], ops_by_level):
        for o in ops:
            parent_ea_apply(old, o, S)
        if lvp["ea"] is not None:
            ea_kernels.extend_add(new, lvp["ea"])
    check(same_bits(old, new), "the extend-add kernel and the bucketed composition it "
          "replaced give different bits")
    del old, new
    ops = [o for level_ops in ops_by_level for o in level_ops]
    work = store0.clone()
    fresh = lambda: work.copy_(store0)
    as_is_ms = time_each_ms(fresh, lambda: [parent_ea_apply(work, o, S) for o in ops], reps=2)
    padded, dropped = [], []
    for o in ops:
        src, dst, mask = parent_ea_indices(o, S)
        padded.append((src, dst))
        dropped.append((src[mask], dst[mask]))

    def run(lists):
        for src, dst in lists:
            work.index_add_(0, dst, work.index_select(0, src))

    padded_ms = time_each_ms(fresh, lambda: run(padded), reps=2)
    dropped_ms = time_each_ms(fresh, lambda: run(dropped), reps=2)
    n_all = sum(int(src.numel()) for src, _ in padded)
    n_real = sum(int(src.numel()) for src, _ in dropped)
    del padded, dropped, work
    emit("spare_slot", ops=len(ops), entries=n_all, real_entries=n_real,
         padded_entries=n_all - n_real, bitwise_equal_to_kernel=True,
         parent_ea_apply_ms=as_is_ms, padded_lists_ms=padded_ms,
         dropped_lists_ms=dropped_ms, kernel_ms=kernel_entry["ms"],
         kernel_device_ms=kernel_entry["device_ms"],
         per="all extend-add ops of one factorization of the flagship KKT",
         seconds=time.perf_counter() - t0)


def parent_update_ops(sym, store):
    """The trailing products of the blocked composition that the wide-front
    kernel replaced: per chunk of wide fronts (the plan's chunking) and per
    32-column panel ``b`` with columns right of it, ``F[:, b:, b+32:] -= W @
    Lm[:, 32:, :]^T`` as one ``baddbmm_`` on a view of ``store``, with ``W`` and
    ``Lm`` of the parent's shapes ``(ch, Fpad-b, 32)``, filled with the chunk's
    first panel of factors."""
    ops = []
    for g in sym.groups:
        Fp = g.Fpad
        if Fp <= ldlt_kernels.MAX_KERNEL_FRONT:
            continue
        for off, ch in supernodal_flat._chunks_of(g.nb, Fp):
            goff = g.goff + off * Fp * Fp
            F = store[goff:goff + ch * Fp * Fp].view(ch, Fp, Fp)
            W = F[:, :, :PANEL_W].clone()
            for b in range(0, int(np.max(g.ncols[off:off + ch])), PANEL_W):
                if b + PANEL_W < Fp:
                    ops.append((F[:, b:, b + PANEL_W:], W[:, b:, :],
                                W[:, b + PANEL_W:, :].transpose(-1, -2)))
    return ops


def wide_kernel_entry(sym, wides, store, main_path_launches):
    """The ``ldlt_wide`` entry of the ``kernels`` line: all calls of one
    factorization of the flagship KKT (one per tree level with wide fronts),
    replayed on the windows of the store that the factorization gave them,
    and the parent's trailing products on a copy of that factorization's
    store as the yardstick of the in-kernel update."""
    err = plain_ms = 0.0
    for win, lvl in wides:
        e, _, p = compare_wide(win, lvl, wide_contract(lvl, win.numel()),
                               f"the flagship's level of {len(lvl.fronts)} wide fronts")
        err = max(err, e)
        plain_ms += p
    works = [win.clone() for win, _ in wides]

    def fresh():
        for w, (win, _) in zip(works, wides):
            w.copy_(win)

    def run():
        for w, (_, lvl) in zip(works, wides):
            ldlt_kernels.partial_ldlt_wide(w, lvl)

    ms = time_each_ms(fresh, run, reps=3)
    fresh()
    dev_ms = queued_ms([run])
    fresh()
    per_level = each_device_ms([lambda w=w, lvl=lvl: ldlt_kernels.partial_ldlt_wide(w, lvl)
                                for w, (_, lvl) in zip(works, wides)])
    del works
    levels = [lvl for _, lvl in wides]
    tb, to = ldlt_kernels.wide_bound_terms(levels, store.dtype)
    # the parent's 519 library products, on a copy of the factored store
    copy = store.clone()
    ops = parent_update_ops(sym, copy)
    thunks = [lambda o=o: o[0].baddbmm_(o[1], o[2], alpha=-1.0) for o in ops]
    torch.backends.cuda.matmul.allow_tf32 = False
    update_host_ms = event_ms(lambda: [fn() for fn in thunks])
    update_ms = queued_ms(thunks)
    n_products = len(ops)
    del ops, thunks, copy
    return dict(
        name="ldlt_wide", route="cuda", source=WIDE_SOURCE, replaces=TPU_WIDE,
        launches=main_path_launches["ldlt_wide"],
        launches_per_replay=main_path_launches["per_replay"]["ldlt_wide"],
        max_abs_err=err, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=max(tb, to) * 1e3,
        bound_by="bytes" if tb >= to else "operations",
        bound_bytes_ms=tb * 1e3, bound_operations_ms=to * 1e3, library_ms=None,
        library_ms_reason="no single PyTorch call computes a non-pivoted partial LDL^T",
        update_library_ms=update_ms, update_library_host_ms=update_host_ms,
        update_library_calls=n_products,
        per=f"one factorization of the flagship KKT ({len(levels)} calls, one per tree "
            f"level with fronts wider than 128)",
        fronts=sum(len(lvl.fronts) for lvl in levels),
        panel_steps_per_tree_level=[lvl.steps for lvl in levels],
        fronts_per_tree_level=[len(lvl.fronts) for lvl in levels],
        device_ms_per_tree_level=[round(t, 4) for t in per_level])


def phase_kernels(qp, plan, D_x, C_diag, b, main_path_launches):
    """The ``kernels`` line.  ``ms`` / ``plain_ms`` / ``bound_ms`` of a factor
    kernel are for ALL its calls in one factorization of the flagship KKT
    system, replayed on the inputs the factorization gave it; those of a sweep
    kernel for all its calls in one solve (:func:`sweep_kernel_entries`).  ``ms`` is taken by an
    event pair around the calls as the host makes them (so it holds the
    host's launch cost where that is the larger); ``device_ms`` is the same
    calls queued behind a spin kernel, i.e. the device's time alone.
    Returns the line; ``main`` adds the banded kernels and prints it."""
    # the kernels' inputs in one factorization of the flagship KKT (captured
    # here, after the flagship solve, so that the solve runs without them)
    ctl = IPMControl()
    captured: list = []
    vals = torch.cat([qp.h_vals, qp.a_vals, D_x + (ctl.rho if ctl.rho else 1e-8),
                      -(C_diag + ctl.delta)])
    fac = supernodal_flat.flat_factorize(plan.sym, vals, capture=captured)
    torch.cuda.synchronize()
    small = [c[1:] for c in captured if c[0] == "small"]     # (buffer, items)
    wides = [c[1:] for c in captured if c[0] == "wide"]      # (window, level table)

    # --- partial_ldlt: one call per tree level, out of place -----------------
    outs = [torch.empty_like(buf) for buf, _ in small]

    def run_small():
        for (buf, items), out in zip(small, outs):
            ldlt_kernels.partial_ldlt_items(buf, items, out=out)

    t0 = time.perf_counter()
    run_small()
    torch.cuda.synchronize()
    refs: list = []
    plain_small_ms = event_ms(lambda: refs.extend(
        ldlt_kernels.partial_ldlt_items_plain(buf, items) for buf, items in small))
    err_small = tb_small = to_small = 0.0
    for (buf, items), out, ref in zip(small, outs, refs):
        for lo, Fpad, nb, nc_off in items.batches:
            hi = lo + nb * Fpad * Fpad
            nc = items.ncols[nc_off:nc_off + nb]
            mask = contract_mask(nc, Fpad)
            g, r = out[lo:hi].view(nb, Fpad, Fpad), ref[lo:hi].view(nb, Fpad, Fpad)
            check(bool(torch.isfinite(g[mask]).all()),
                  "kernel produced non-finite values on the main path's fronts")
            err = float(((g - r).abs() * mask).max())
            tol = TOL[buf.dtype] * max(1.0, float(r.abs().max()))
            check(err <= tol, f"kernel disagrees with its plain version on the main "
                  f"path's fronts ({nb}, {Fpad}, {Fpad}): {err:.3e} > {tol:.3e}")
            err_small = max(err_small, err)
            tb, to = ldlt_kernels.ldlt_bound_terms(nc, Fpad, buf.dtype)
            tb_small += tb
            to_small += to
    del refs
    ms_small = time_ms(run_small, reps=5)
    dev_small = queued_ms([run_small])

    line = dict(kernels=[
        dict(name="partial_ldlt", route="cuda", source=SOURCE, replaces=TPU_KERNEL,
             launches=main_path_launches["partial_ldlt"],
             launches_per_replay=main_path_launches["per_replay"]["partial_ldlt"],
             max_abs_err=err_small,
             ms=ms_small, device_ms=dev_small, plain_ms=plain_small_ms,
             bound_ms=max(tb_small, to_small) * 1e3,
             bound_by="bytes" if tb_small >= to_small else "operations",
             library_ms=None,
             per=f"one factorization of the flagship KKT ({len(small)} calls, "
                 f"one per tree level)",
             fronts=sum(items.fronts for _, items in small))])
    del small, outs
    line["kernels"].append(wide_kernel_entry(plan.sym, wides, fac.store, main_path_launches))
    del wides, captured
    ea_entry = ea_kernel_entry(plan.sym, fac.store, main_path_launches)
    line["kernels"].append(ea_entry)
    phase_spare_slot(plan.sym, fac.store, ea_entry)
    del fac
    line["kernels"] += sweep_kernel_entries(qp, plan, D_x, C_diag, b,
                                            main_path_launches)
    emit("kernels_seconds", seconds=time.perf_counter() - t0)
    return line


def count_ops(fn) -> int:
    """The aten operations that ``fn()`` dispatches (most launch a kernel on
    the card, views launch none; the hand kernels' launches are counted by
    their wrappers instead)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def roots_op_counts(qp, K: int) -> dict:
    """The aten operations and the time of the arc's ROOTS pass over the
    flagship's eight families and K truncation orders: the port's one
    batched call (``ipm._arc_max_steps``) against one ``roots_quartic`` call
    per family and order (the JAX package's ``_arc_max_step`` loop), on the
    same inputs (``batched_device_ms``: queued behind a spin kernel, the
    device's time alone)."""
    from galahad_tpu_torch.core.roots import roots_quartic, smallest_positive_root
    from galahad_tpu_torch.qp import ipm

    gen = torch.Generator(device="cuda").manual_seed(0)
    fams = []
    for size in (qp.n,) * 4 + (qp.m,) * 4:
        v0 = torch.rand(size, dtype=torch.float64, device="cuda", generator=gen) + 0.1
        ds = [torch.randn(size, dtype=torch.float64, device="cuda", generator=gen)
              for _ in range(K)]
        fams.append((v0, ds, v0 > 0.2))

    def per_family():
        out = []
        for j in range(1, K + 1):
            best = torch.ones((), dtype=torch.float64, device="cuda")
            for v0, ds, mask in fams:
                a = [torch.where(mask, 0.995 * v0, 1.0)]
                a += [torch.where(mask, dk, 0.0) for dk in ds[:j]]
                a += [torch.zeros_like(v0)] * (5 - len(a))
                best = torch.minimum(best, smallest_positive_root(*roots_quartic(*a)).min())
            out.append(best)
        return torch.stack(out)

    batched = ipm._arc_max_steps(fams, K, 0.995)
    check(torch.equal(batched, per_family()),
          "the batched ROOTS pass differs from the per-family one")
    return dict(batched=count_ops(lambda: ipm._arc_max_steps(fams, K, 0.995)),
                per_family=count_ops(per_family),
                batched_ms=time_ms(lambda: ipm._arc_max_steps(fams, K, 0.995), reps=5),
                batched_device_ms=queued_ms([lambda: ipm._arc_max_steps(fams, K, 0.995)]),
                per_family_ms=time_ms(per_family, reps=3),
                components=sum(int(v0.numel()) for v0, _, _ in fams), orders=K)


def step_op_count(qp, ctl) -> int:
    """The aten operations of one direct ``ipm_step`` from the starting point."""
    from galahad_tpu_torch.core.problem import classify_bounds
    from galahad_tpu_torch.qp import ipm

    masks = classify_bounds(qp, ctl.infinity)
    st = ipm.ipm_init(qp, masks, ctl)
    ipm.ipm_step(qp, masks, st, ctl)          # plans and tables exist after this
    return count_ops(lambda: ipm.ipm_step(qp, masks, st, ctl))


def phase_arcs(qp):
    """The series arcs on the flagship through ``ipm_solve``, graph path then
    direct path, each with the kernels' counters set to 0 just before and read
    just after; then the three arcs at grid_qp_coo(100) against the JAX
    package's iteration counts."""
    t_phase = time.perf_counter()
    rows = []
    mehrotra_ops = step_op_count(qp, IPMControl())
    for arc, order in ARC_RUNS:
        ctl = IPMControl(arc=arc, series_order=order)
        what = f"arcs phase, {arc} order {order}"
        with fused_path(True):
            x, y, z, st, wall, peak, counts = counted_solve(qp, ctl)
        run = st.run
        kkt = host_kkt(qp, x, y, z)[0]
        per = run.launches_per_replay
        check(run.path == "graph", f"{what}: ran the {run.path} path")
        check(st.status == int(Status.OK), f"{what}: status {st.status}")
        check(kkt <= 1e-6, f"{what}: host KKT error {kkt:.3e} > 1e-6")
        check(all(per[k] > 0 for k in KERNEL_COUNTS),
              f"{what}: a hand kernel is missing from the captured iteration: {per}")
        check(all(counts[k] == 0 for k in PLAIN_COUNTS),
              f"{what}: plain code ran on the card: { {k: counts[k] for k in PLAIN_COUNTS} }")
        check(run.direct_steps == 1 and run.replays - run.halted_replays == st.iter - 1,
              f"{what}: {run.direct_steps} direct steps, {run.replays} replays "
              f"({run.halted_replays} halted) for {st.iter} iterations")
        with fused_path(False):
            xd, yd, zd, sd, wall_d, peak_d, counts_d = counted_solve(qp, ctl)
        check(sd.run.path == "direct" and (sd.status, sd.iter) == (st.status, st.iter)
              and all(same_bits(a, b) for a, b in ((x, xd), (y, yd), (z, zd))),
              f"{what}: the graph path's x, y, z differ from the direct path's")
        rows.append(dict(
            arc=arc, series_order=order, status=st.status, iterations=st.iter, host_kkt=kkt,
            objective=st.inform.obj, wall_s=wall, s_per_iteration=wall / max(st.iter, 1),
            capture_s=run.capture_s, instantiate_s=run.instantiate_s, replays=run.replays,
            replay_s=run.replay_s, s_per_replay=run.replay_s / max(run.replays, 1),
            halted_replays=run.halted_replays, fetches=run.fetches,
            replay_device_ms=replay_device_ms(qp, ctl),
            launches_per_replay={k: per[k] for k in KERNEL_COUNTS},
            device_launches={k: counts[k] for k in KERNEL_COUNTS},
            plain_counts={k: counts[k] for k in PLAIN_COUNTS},
            peak_device_memory_bytes=peak, direct_wall_s=wall_d,
            direct_peak_device_memory_bytes=peak_d,
            aten_ops_per_direct_step=step_op_count(qp, ctl),
            graph_bitwise_equal_direct=True))
    parity = []
    small = flagship_qp(K_ARC_PARITY, "cuda")
    for arc, order in ARC_RUNS:
        _, _, _, st = ipm_solve(small, IPMControl(arc=arc, series_order=order))
        want = JAX_ARC_ITERS[(arc, order)]
        check((st.status, st.iter) == want,
              f"arcs phase, k={K_ARC_PARITY} {arc} order {order}: status {st.status}, "
              f"{st.iter} iterations; the JAX package gives {want}")
        parity.append(dict(arc=arc, series_order=order, status=st.status, iterations=st.iter,
                           jax_status_iterations=list(want), path=st.run.path))
    emit("arcs", runs=rows, mehrotra_aten_ops_per_direct_step=mehrotra_ops,
         roots_aten_ops_per_step=roots_op_counts(qp, 4),
         k100_against_jax=parity, seconds=time.perf_counter() - t_phase)


def convex_qp_arrays(n, m, seed, equalities=0):
    """The family of tests/test_ipm.py::random_convex_qp (the same random
    stream): H = B B' + I/2, m random rows around a feasible point, the
    first ``equalities`` of them equalities, 0 <= x <= 1."""
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    H = B @ B.T + 0.5 * np.eye(n)
    A = r.normal(size=(m, n))
    x_feas = r.uniform(0.2, 0.8, size=n)
    c_at = A @ x_feas
    c_l = np.where(np.arange(m) < equalities, c_at, c_at - r.uniform(0.5, 1.0, m))
    c_u = np.where(np.arange(m) < equalities, c_at, c_at + r.uniform(0.5, 1.0, m))
    return dict(H=H, g=r.normal(size=n), A=A, c_l=c_l, c_u=c_u,
                x_l=np.zeros(n), x_u=np.ones(n))


def dense_host_kkt(qp, x, y, z):
    """KKT error of a dense QP in float64 on the host."""
    return host_kkt_error(np.asarray(qp.H_dense().cpu(), np.float64),
                          np.asarray(qp.A.cpu(), np.float64), qp, x, y, z)


def host_kkt_error(H, A, qp, x, y, z):
    """KKT error in float64 on the host of the QP with Hessian ``H`` and
    constraint matrix ``A`` (numpy or scipy.sparse) and ``qp``'s g and
    bounds: the dual residual, the bound and constraint violations, and the
    complementarity of each finite bound with its multiplier (y, z > 0 at a
    lower bound)."""
    big = 1e19
    g = np.asarray(qp.g.cpu(), np.float64)
    xl, xu, cl, cu = (np.asarray(t.cpu(), np.float64) for t in (qp.x_l, qp.x_u, qp.c_l, qp.c_u))
    xd, yd, zd = (np.asarray(v.cpu(), np.float64) for v in (x, y, z))
    ax = A @ xd
    r_d = float(np.max(np.abs(H @ xd + g - A.T @ yd - zd)))
    viol = [np.where(xl > -big, xl - xd, 0.0), np.where(xu < big, xd - xu, 0.0),
            np.where(cl > -big, cl - ax, 0.0), np.where(cu < big, ax - cu, 0.0)]
    r_p = float(max(np.max(np.maximum(v, 0.0), initial=0.0) for v in viol))
    eq = (cl > -big) & (cu < big) & (cu - cl <= 0)
    comp = [np.where(xl > -big, (xd - xl) * np.maximum(zd, 0.0), 0.0),
            np.where(xu < big, (xu - xd) * np.maximum(-zd, 0.0), 0.0),
            np.where((cl > -big) & ~eq, (ax - cl) * np.maximum(yd, 0.0), 0.0),
            np.where((cu < big) & ~eq, (cu - ax) * np.maximum(-yd, 0.0), 0.0)]
    c = float(max(np.max(np.abs(v), initial=0.0) for v in comp))
    return max(r_p, r_d, c), r_p, r_d, c


def dense_graph_and_direct(qp, what: str):
    """One dense solve on the graph path and one on the direct path: the same
    status, iterations, escalations and bits.  Returns the graph run's row."""
    with fused_path(True):
        x, y, z, st, wall, peak, _ = counted_solve(qp, IPMControl())
    with fused_path(False):
        xd, yd, zd, sd, wall_d, _, _ = counted_solve(qp, IPMControl())
    check(st.run.path == "graph" and sd.run.path == "direct",
          f"{what}: ran the {st.run.path} / {sd.run.path} paths")
    check((st.status, st.iter, st.run.escalations) == (sd.status, sd.iter, sd.run.escalations)
          and all(same_bits(a, b) for a, b in ((x, xd), (y, yd), (z, zd))),
          f"{what}: the graph path's result differs from the direct path's")
    kkt = dense_host_kkt(qp, x, y, z)[0]
    return dict(n=qp.n, m=qp.m, status=st.status, iterations=st.iter, host_kkt=kkt,
                objective=st.inform.obj, wall_s=wall, s_per_iteration=wall / max(st.iter, 1),
                capture_s=st.run.capture_s, replays=st.run.replays,
                halted_replays=st.run.halted_replays, escalations=st.run.escalations,
                fetches=st.run.fetches, peak_device_memory_bytes=peak, direct_wall_s=wall_d,
                graph_bitwise_equal_direct=True), (x, y, z, st)


def phase_dense():
    """Dense QPs on the card through ``read_qp`` and ``make_qp``."""
    from galahad_tpu_torch.io.qplib import read_qp

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "tests", "dense_sweep_oracle.json")) as fh:
        oracle = json.load(fh)["fixtures"]
    sweep_dir = os.path.join(root, "examples", "sweep")
    names = sorted(f[:-6] for f in os.listdir(sweep_dir) if f.endswith(".qplib"))
    check(sorted(oracle) == names and len(names) == 20,
          "dense phase: the oracle does not cover the 20 sweep fixtures")
    sweep = []
    t0 = time.perf_counter()
    for name in names:
        qp = read_qp(os.path.join(sweep_dir, name + ".qplib"))
        t1 = time.perf_counter()
        x, _, _, st = ipm_solve(qp)
        wall = time.perf_counter() - t1
        ref = oracle[name]
        check(st.run.path == "graph", f"dense phase, {name}: ran the {st.run.path} path")
        check((st.status, st.iter) == (ref["status"], ref["iter"]),
              f"dense phase, {name}: status {st.status}, {st.iter} iterations; the oracle "
              f"gives {ref['status']}, {ref['iter']}")
        if st.status == 0:
            rel = abs(st.inform.obj - ref["obj"]) / max(1.0, abs(ref["obj"]))
            check(rel <= 1e-8, f"dense phase, {name}: objective off by {rel:.3e} relative")
        sweep.append(dict(name=name, n=qp.n, m=qp.m, status=st.status, iterations=st.iter,
                          escalations=st.run.escalations, wall_s=wall))
    sweep_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    qp = make_qp(**convex_qp_arrays(DENSE_N, DENSE_M, 0, equalities=DENSE_EQ))
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    big, sol = dense_graph_and_direct(qp, "dense phase, n=4096")
    check(big["status"] == int(Status.OK), f"dense phase, n=4096: status {big['status']}")
    check(big["host_kkt"] <= 1e-6, f"dense phase, n=4096: host KKT {big['host_kkt']:.3e}")
    check(bool(torch.isfinite(sol[0]).all()) and sol[0].shape == (DENSE_N,),
          "dense phase, n=4096: x is not finite or has the wrong shape")
    big.update(make_qp_s=make_s, replay_device_ms=replay_device_ms(qp),
               h_bytes=qp.H.numel() * qp.H.element_size())
    del qp, sol

    a = convex_qp_arrays(512, 128, 0)
    a["H"][0, :] = 0.0
    a["H"][:, 0] = 0.0
    a["A"][:, 0] = 0.0
    a["x_l"][0], a["x_u"][0], a["g"][0] = -1e20, 1e20, 0.0
    shifted, _ = dense_graph_and_direct(make_qp(**a), "dense phase, escalation")
    check(shifted["status"] == int(Status.OK) and shifted["escalations"] >= 1,
          f"dense phase, escalation: status {shifted['status']}, "
          f"{shifted['escalations']} escalations")
    emit("dense", sweep=sweep, sweep_s=sweep_s, n4096=big, escalation=shifted,
         seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# The banded path
# ---------------------------------------------------------------------------


def banded_blocks(k, b, dtype, seed, bad_block=None):
    """(D, L) on the card of a block-tridiagonal SPD matrix (block diagonally
    dominant); ``bad_block``: that diagonal block negated (not positive
    definite)."""
    rng = np.random.default_rng(seed)
    L = rng.uniform(-1.0, 1.0, (k - 1, b, b))
    G = rng.uniform(-1.0, 1.0, (k, b, b))
    D = G @ G.transpose(0, 2, 1) + 3.0 * b * np.eye(b)
    if bad_block is not None:
        D[bad_block] = -D[bad_block]
    return (torch.as_tensor(D, device="cuda").to(dtype).contiguous(),
            torch.as_tensor(L, device="cuda").to(dtype).contiguous())


def banded_errors(D, L, rhs_list, chunk=None, plain=None):
    """Factor and solve kernels against their plain versions on the same
    inputs (the solve on the kernel's factors, its rows in chunks of
    ``chunk``, default the wrapper's; ``plain``: (factors, solutions) of the
    plain versions computed elsewhere, the solves on the plain factors):
    (Ld, Lo, ok, ok of the plain version, max abs error, worst error over
    tolerance, solutions).  Each compared tensor (Ld, Lo, each solution) is
    held to ``TOL`` times its own largest |plain value|.  Each kernel runs
    twice and the two runs must agree bitwise."""
    from galahad_tpu_torch.linalg.banded import (BlockTridiagFactors, block_tridiag_cholesky_plain,
                                                 block_tridiag_solve_plain)

    Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L)
    Ld2, Lo2, ok2 = banded_kernels.block_tridiag_factor(D, L)
    check(same_bits(Ld, Ld2) and same_bits(Lo, Lo2) and bool(ok) == bool(ok2),
          f"banded factor kernel: two runs differ (k={D.shape[0]}, b={D.shape[1]})")
    fp, plain_xs = plain if plain is not None else (block_tridiag_cholesky_plain(D, L), None)
    pairs = [(Ld, fp.Ld), (Lo, fp.Lo)]
    xs = []
    for j, rhs in enumerate(rhs_list):
        x = banded_kernels.block_tridiag_solve(Ld, Lo, rhs, chunk=chunk)
        check(same_bits(x, banded_kernels.block_tridiag_solve(Ld, Lo, rhs, chunk=chunk)),
              f"banded solve kernel: two runs differ (shape {tuple(rhs.shape)}, chunk {chunk})")
        pairs.append((x, block_tridiag_solve_plain(BlockTridiagFactors(Ld, Lo, ok), rhs)
                      if plain_xs is None else plain_xs[j]))
        xs.append(x)
    torch.cuda.synchronize()
    err, ratio = 0.0, 0.0
    for got, want in pairs:
        if want.numel():
            check(bool(torch.isfinite(got).all()), "banded kernel produced non-finite values")
            e = float((got - want).abs().max())
            err = max(err, e)
            ratio = max(ratio, e / (TOL[D.dtype] * (float(want.abs().max()) or 1.0)))
    return Ld, Lo, bool(ok), bool(fp.ok), err, ratio, xs


# (k, chunk) of the solve kernel at its chunk boundaries: one chunk, one
# row over and under, a ragged last chunk, chunks of one row, whole chunks
# and one row over (chunk None: the wrapper's default)
BANDED_CHUNK_CASES = ((64, 64), (65, 64), (63, 64), (100, 7), (37, 1), (247, 62), (249, 62),
                      (2500, None))


def kernel_banded_cases():
    """The block-tridiagonal factor and solve kernels against their plain
    versions, with time and bound per shape; the solve at its chunk
    boundaries (b in {1, 3, 8}: b = 3 runs padded in the kernels of 4); a
    third block that is not positive definite; b = 33 refused."""
    rows = []
    for dtype in (torch.float32, torch.float64):
        for b in (1, 2, 4, 8, 16, 32):
            for k in (1, 2, 37, 2500):
                D, L = banded_blocks(k, b, dtype, seed=1000 * b + k)
                gen = torch.Generator(device="cuda")
                gen.manual_seed(k)
                rhs = [torch.randn(k, b, dtype=dtype, device="cuda", generator=gen),
                       torch.randn(k, b, 3, dtype=dtype, device="cuda", generator=gen)]
                Ld, Lo, ok, ok_plain, err, ratio, _ = banded_errors(D, L, rhs)
                check(ok and ok_plain and ratio <= 1.0,
                      f"banded kernels disagree with their plain versions: b={b} k={k} "
                      f"{dtype}: ok {ok}/{ok_plain}, err {err:.3e} is {ratio:.3g} x the "
                      f"tolerance")
                fac_ms = time_ms(lambda: banded_kernels.block_tridiag_factor(D, L), reps=3)
                sol_ms = time_ms(lambda: banded_kernels.block_tridiag_solve(Ld, Lo, rhs[0]),
                                 reps=3)
                sched = banded_kernels.solve_schedule(k, banded_kernels.default_chunk(k))
                rows.append(dict(dtype=str(dtype).split(".")[1], b=b, k=k, max_abs_err=err,
                                 err_over_tol=ratio, factor_ms=fac_ms, solve_ms=sol_ms,
                                 solve_chunk=sched["chunk"],
                                 solve_critical_path_steps=sched["critical_path_steps"],
                                 factor_bound_ms=banded_kernels.bound_ms(
                                     banded_kernels.factor_bound_terms(k, b, dtype))[0],
                                 solve_bound_ms=banded_kernels.bound_ms(
                                     banded_kernels.solve_bound_terms(k, b, 1, dtype))[0]))
                del D, L, Ld, Lo, rhs
        for b in (1, 3, 8):
            for k, chunk in BANDED_CHUNK_CASES:
                D, L = banded_blocks(k, b, dtype, seed=7 * k + b)
                gen = torch.Generator(device="cuda")
                gen.manual_seed(k + b)
                rhs = [torch.randn(k, b, dtype=dtype, device="cuda", generator=gen),
                       torch.randn(k, b, 3, dtype=dtype, device="cuda", generator=gen)]
                _, _, ok, ok_plain, err, ratio, _ = banded_errors(D, L, rhs, chunk=chunk)
                check(ok and ok_plain and ratio <= 1.0,
                      f"banded solve at chunk boundaries: b={b} k={k} chunk={chunk} {dtype}: "
                      f"ok {ok}/{ok_plain}, err {err:.3e} is {ratio:.3g} x the tolerance")
                m = banded_kernels.default_chunk(k) if chunk is None else chunk
                rows.append(dict(dtype=str(dtype).split(".")[1], b=b, k=k, chunk=m,
                                 chunks=-(-k // m), max_abs_err=err, err_over_tol=ratio))
        for b in (1, 4, 8, 32):
            D, L = banded_blocks(37, b, dtype, seed=b, bad_block=2)
            rhs = [torch.ones(37, b, dtype=dtype, device="cuda")]
            Ld, _, ok, ok_plain, err, ratio, _ = banded_errors(D, L, rhs)
            eye = torch.eye(b, dtype=dtype, device="cuda")
            check(not ok and not ok_plain and torch.equal(Ld[2], eye),
                  f"banded factor, b={b} {dtype}: a failed block must clear ok and give "
                  f"the identity (ok {ok}/{ok_plain})")
            check(ratio <= 1.0,
                  f"banded kernels, failed block, b={b} {dtype}: err {err:.3e} is "
                  f"{ratio:.3g} x the tolerance")
            rows.append(dict(dtype=str(dtype).split(".")[1], b=b, k=37, third_block_not_pd=True,
                             ok=ok, ok_plain=ok_plain, max_abs_err=err, err_over_tol=ratio))
    D, L = banded_blocks(3, 33, torch.float64, seed=0)
    try:
        banded_kernels.block_tridiag_factor(D, L)
        refused = False
    except ValueError:
        refused = True
    check(refused, "the banded factor kernel must refuse b = 33")
    banded_kernels.banded_check()
    return rows


def banded_problem(n, h, m, device="cuda"):
    """The banded QP family of bench.py:269-293 (``bench_banded_lp``) at size
    n: g = -0.2 - 0.2 (i mod 5), x in [0, 2]; A with rows i -> variables
    {i, i+2}, values U(0.8, 1.2) from default_rng(0), c_l = 1 (m = n - 2
    unless given); H the tridiagonal (2, -1) where ``h`` is "tri", else 0;
    block 8."""
    from galahad_tpu_torch.qp.ipm_banded import make_banded_qp

    m = n - 2 if m is None else m
    r = np.random.default_rng(0)
    a = np.stack([r.uniform(0.8, 1.2, m), r.uniform(0.8, 1.2, m)]) if m else None
    hd = (np.stack([np.full(n, 2.0), np.concatenate([-np.ones(n - 1), [0.0]])])
          if h == "tri" else None)
    return make_banded_qp(g=-0.2 - 0.2 * (np.arange(n) % 5), a_val=a, a_offsets=(0, 2),
                          c_l=np.ones(m), c_u=np.full(m, 1e20), x_l=np.zeros(n),
                          x_u=np.full(n, 2.0), h_diags=hd, block=8, device=device)


def banded_host_kkt(qp, x, y, z):
    """KKT error of a BandedQP in float64 on the host, with H and A as scipy
    sparse matrices built from the DIA data."""
    import scipy.sparse as sp

    n, m = qp.n, qp.m
    if qp.h_kind == "zero":
        H = sp.csr_matrix((n, n))
    else:
        d = np.asarray(qp.h_diags.cpu(), np.float64)
        rows, cols, vals = [np.arange(n)], [np.arange(n)], [d[0]]
        for s in range(1, d.shape[0]):
            i = np.arange(n - s)
            rows += [i + s, i]
            cols += [i, i + s]
            vals += [d[s, :n - s]] * 2
        H = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n, n))
    rows, cols, vals = [], [], []
    if m:
        val = np.asarray(qp.A_band.val.cpu(), np.float64)
        for p, off in enumerate(qp.A_band.offsets):
            i = np.arange(max(0, -off), min(m, n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(val[p, i])
    A = (sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                       shape=(m, n)) if m else sp.csr_matrix((0, n)))
    return host_kkt_error(H, A, qp, x, y, z)


def banded_expected_per_replay(qp, ctl):
    """(factor, solve) kernel launches of one banded Mehrotra iteration:
    2 KKT solves (predictor, corrector) of 1 + refine block solves each; a
    block solve is one S solve between two G solves; with m = 0 a KKT solve
    is one G solve, unrefined.  The PCG mode's S solve is 2 preconditioner
    solves and one operator product before the loop and one of each per CG
    iteration, each product holding one G solve."""
    r = 1 + ctl.refine
    if qp.m == 0:
        return (0, 0) if qp.h_kind in ("zero", "diagonal") else (1, 2)
    if qp.h_kind in ("zero", "diagonal"):
        return 1, 2 * r
    s_solve = 3 + 2 * qp.cg_maxit
    return 2, 2 * r * (2 + s_solve)


def phase_banded():
    """The banded IPM on the card: ``ipm_solve_banded`` on each problem of
    ``BANDED_CASES`` on the graph path (the main path of this phase: the
    counts are set to 0 before each solve and read after it) and then
    directly.  Returns the device launches of the banded kernels over the
    graph runs, and per replay."""
    from galahad_tpu_torch.qp.ipm_banded import ipm_solve_banded

    t_phase = time.perf_counter()
    ctl = IPMControl(**BANDED_CTL)
    rows = []
    total = dict(banded_factor=0, banded_solve=0, per_replay={})
    for name, ((n, h, m), (iters, obj)) in BANDED_CASES.items():
        what = f"banded phase, {name}"
        t0 = time.perf_counter()
        qp = banded_problem(n, h, m)
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t0
        base = torch.cuda.memory_allocated()       # the problem and what earlier phases keep
        with fused_path(True):
            x, y, z, st, wall, peak, counts = counted_solve(qp, ctl, ipm_solve_banded)
        with fused_path(False):
            xd, yd, zd, sd, wall_d, peak_d, counts_d = counted_solve(qp, ctl, ipm_solve_banded)
        banded_kernels.banded_check()         # no solve gave up waiting for a chunk
        check(st.run.path == "graph" and sd.run.path == "direct",
              f"{what}: ran the {st.run.path} / {sd.run.path} paths")
        check(st.status == int(Status.OK) and st.iter == iters,
              f"{what}: status {st.status}, {st.iter} iterations; the JAX package gives 0, {iters}")
        rel = abs(st.inform.obj - obj) / max(1.0, abs(obj))
        check(rel <= 1e-8, f"{what}: objective {st.inform.obj!r} off by {rel:.3e} relative")
        kkt = banded_host_kkt(qp, x, y, z)
        check(kkt[0] <= 1e-6, f"{what}: host KKT {kkt[0]:.3e}")
        check(bool(torch.isfinite(x).all()) and x.shape == (n,) and y.shape == (qp.m,),
              f"{what}: x is not finite or has the wrong shape")
        check((sd.status, sd.iter) == (st.status, st.iter)
              and all(same_bits(a, b) for a, b in ((x, xd), (y, yd), (z, zd))),
              f"{what}: the graph path's result differs from the direct path's")
        per = st.run.launches_per_replay
        want = banded_expected_per_replay(qp, ctl)
        check((per["banded_factor"], per["banded_solve"]) == want,
              f"{what}: {per['banded_factor']} factor and {per['banded_solve']} solve launches "
              f"per replay, expected {want}")
        check(all(counts[k] == 0 for k in PLAIN_COUNTS)
              and all(counts_d[k] == 0 for k in PLAIN_COUNTS),
              f"{what}: plain code ran on the card")
        check(st.run.direct_steps == 1 and st.run.replays - st.run.halted_replays == st.iter - 1,
              f"{what}: {st.run.direct_steps} direct steps, {st.run.replays} replays "
              f"({st.run.halted_replays} halted) for {st.iter} iterations")
        for k in ("banded_factor", "banded_solve"):
            total[k] += counts[k]
        total["per_replay"][name] = dict(factor=per["banded_factor"], solve=per["banded_solve"])
        rows.append(dict(
            name=name, n=n, m=qp.m, h_kind=qp.h_kind, status=st.status, iterations=st.iter,
            jax_iterations=iters, objective=st.inform.obj, jax_objective=obj,
            objective_rel_err=rel, host_kkt=kkt[0], host_kkt_p_d_c=kkt[1:],
            wall_s=wall, s_per_iteration=wall / max(st.iter, 1), capture_s=st.run.capture_s,
            instantiate_s=st.run.instantiate_s, replays=st.run.replays,
            halted_replays=st.run.halted_replays, replay_s=st.run.replay_s,
            replay_device_ms=replay_device_ms(qp, ctl, reps=1, halted=False),
            peak_device_memory_bytes=peak, peak_over_start_bytes=peak - base,
            direct_wall_s=wall_d, direct_peak_over_start_bytes=peak_d - base,
            launches_per_replay=dict(factor=per["banded_factor"], solve=per["banded_solve"]),
            device_launches=dict(factor=counts["banded_factor"], solve=counts["banded_solve"]),
            plain_counts={k: counts[k] + counts_d[k] for k in PLAIN_COUNTS},
            make_qp_s=make_s, graph_bitwise_equal_direct=True))
        del qp, x, y, z, xd, yd, zd
    emit("banded", problems=rows, control=BANDED_CTL, seconds=time.perf_counter() - t_phase)
    return total


def dense_blocks(D, L):
    """The dense (k b) x (k b) matrix of the blocks (D, L)."""
    k, b, _ = D.shape
    A = torch.zeros((k * b, k * b), dtype=D.dtype, device=D.device)
    A4 = A.view(k, b, k, b)
    i = torch.arange(k, device=D.device)
    A4[i, :, i, :] = D
    if k > 1:
        A4[i[1:], :, i[:-1], :] = L
        A4[i[:-1], :, i[1:], :] = L.mT
    return A


def banded_path_blocks(name, device="cuda"):
    """The (D, L, factors) of each block set that ``BandedQP.build_kkt`` of
    the problem ``BANDED_CASES[name]`` factors at the starting point, in its
    order (the G blocks, then the Schur complement's), recorded from one
    direct call on ``device`` (on the CPU the factors are the plain
    version's)."""
    from galahad_tpu_torch.core.problem import classify_bounds
    from galahad_tpu_torch.qp import ipm, ipm_banded

    ctl = IPMControl(**BANDED_CTL)
    (n, h, m), _ = BANDED_CASES[name]
    qp = banded_problem(n, h, m, device)
    masks = classify_bounds(qp, ctl.infinity)
    D_x, C_diag = ipm._barrier_diagonals(qp, masks, ipm.ipm_init(qp, masks, ctl), ctl)
    seen = []
    factor = ipm_banded.block_tridiag_cholesky

    def record(D, L):
        seen.append((D, L, factor(D, L)))
        return seen[-1][2]

    ipm_banded.block_tridiag_cholesky = record
    try:
        qp.build_kkt(D_x, C_diag, ctl)
    finally:
        ipm_banded.block_tridiag_cholesky = factor
    return seen


def banded_last_iteration_blocks(name):
    """The (D, L) block sets that ``BandedQP.build_kkt`` factors at the last
    iteration of ``ipm_solve_banded`` on ``BANDED_CASES[name]`` (direct
    path), in their order: as many as one iteration factors (the PCG mode
    two, G and the preconditioner; the other modes one)."""
    from galahad_tpu_torch.qp import ipm_banded
    from galahad_tpu_torch.qp.ipm_banded import ipm_solve_banded

    ctl = IPMControl(**BANDED_CTL)
    (n, h, m), (iters, _) = BANDED_CASES[name]
    qp = banded_problem(n, h, m)
    per_iteration = banded_expected_per_replay(qp, ctl)[0]
    seen = []
    factor = ipm_banded.block_tridiag_cholesky

    def record(D, L):
        seen.append((D, L))
        del seen[:-per_iteration]
        return factor(D, L)

    ipm_banded.block_tridiag_cholesky = record
    try:
        with fused_path(False):
            _, _, _, st = ipm_solve_banded(qp, ctl)
    finally:
        ipm_banded.block_tridiag_cholesky = factor
    check(st.status == 0 and st.iter == iters,
          f"banded last-iteration blocks of {name}: status {st.status}, {st.iter} iterations")
    return seen


def banded_rel_residual(D, L, x, rhs) -> float:
    """||A x - rhs|| / (||A|| ||x||) in max norms, for the block-tridiagonal
    A of (D, L)."""
    from galahad_tpu_torch.linalg.banded import block_tridiag_matvec

    rows = D.abs().sum(-1)
    if D.shape[0] > 1:
        rows[1:] += L.abs().sum(-1)
        rows[:-1] += L.abs().sum(-2)
    r = (block_tridiag_matvec(D, L, x) - rhs).abs().max()
    return float(r) / (float(rows.max()) * float(x.abs().max()))


# the banded problems whose starting-point block sets (k = 125,000) are too long for the plain
# loop on the card (~70 s, PERF.md §4): the CPU pool runs their plain factor and solve beside
# the build (~25 s), and the card's kernels are held to those results
BANDED_HOST_PLAIN = ("lp_n1000000",)


def banded_cpu_reference(name):
    """The plain factor and solve on the CPU of every block set that
    ``BandedQP.build_kkt`` of ``BANDED_CASES[name]`` factors at the starting
    point (the factor is the call's own, the plain version on a CPU tensor;
    the right-hand side from a host generator seeded with the set's index):
    a list of dict(D, L, rhs, fac, x)."""
    from galahad_tpu_torch.linalg.banded import block_tridiag_solve_plain

    out = []
    for i, (D, L, fac) in enumerate(banded_path_blocks(name, "cpu")):
        rhs = torch.randn(D.shape[0], D.shape[1], dtype=D.dtype,
                          generator=torch.Generator().manual_seed(i))
        out.append(dict(D=D, L=L, rhs=rhs, fac=fac, x=block_tridiag_solve_plain(fac, rhs)))
    return out


def phase_banded_path_kernels(host):
    """Both banded kernels against their plain versions (f64, ``TOL``) on
    every block set that the banded phase's problems factor at the starting
    point: the shapes the main path gives the kernels, k = 2,500 and
    k = 125,000 block rows of b = 8 (the latter, BANDED_HOST_PLAIN, on the
    blocks, right-hand side and plain results that the CPU pool made,
    ``host``; the card's own blocks of the same set within ``TOL`` of
    them); the solve with one right-hand side.
    Then the sets of each problem's last iteration, held by relative
    residual: the kernels' solve (its rows in chunks) within 10 x the
    sequential solve's + 1e-15 on the same factors (the plain solve at
    k = 2,500; at k = 125,000 the kernel with one chunk, the sequential
    order, where the plain loop would take ~15 s), two runs bitwise equal.
    Returns the Schur-complement blocks of the LP at n = 20,000 at the
    starting point, which the ``kernels`` line times."""
    from galahad_tpu_torch.linalg.banded import (BlockTridiagFactors,
                                                 block_tridiag_cholesky_plain,
                                                 block_tridiag_solve_plain)

    t0 = time.perf_counter()
    rows, timed = [], None
    for name in BANDED_CASES:
        for i, (D, L, _) in enumerate(banded_path_blocks(name)):
            k, b = D.shape[0], D.shape[1]
            t1 = time.perf_counter()
            plain, extra = None, {}
            if name in BANDED_HOST_PLAIN:
                ref = host["banded_" + name][0][i]
                extra["blocks_off_host"] = max(
                    float((mine - ref[key].to("cuda")).abs().max()) / float(ref[key].abs().max())
                    for mine, key in ((D, "D"), (L, "L")))
                check(extra["blocks_off_host"] <= TOL[D.dtype], f"banded path's blocks {i} of "
                      f"{name}: {extra['blocks_off_host']:.3e} off the CPU's")
                D, L, rhs = (ref[key].to("cuda") for key in ("D", "L", "rhs"))
                fac = ref["fac"]
                plain = (BlockTridiagFactors(fac.Ld.to("cuda"), fac.Lo.to("cuda"), fac.ok),
                         [ref["x"].to("cuda")])
                extra.update(plain="host", plain_cpu_s=host["banded_" + name][1])
            else:
                gen = torch.Generator(device="cuda")
                gen.manual_seed(i)
                rhs = torch.randn(k, b, dtype=D.dtype, device="cuda", generator=gen)
            Ld, Lo, ok, ok_plain, err, ratio, (x,) = banded_errors(D, L, [rhs], plain=plain)
            check(ok and ok_plain and ratio <= 1.0,
                  f"banded kernels on {name}'s blocks {i} (k={k}, b={b}): ok {ok}/{ok_plain}, "
                  f"err {err:.3e} is {ratio:.3g} x the tolerance")
            rows.append(dict(problem=name, iteration="start", blocks=i, k=k, b=b,
                             dtype=str(D.dtype).split(".")[1], max_abs_err=err,
                             err_over_tol=ratio, seconds=time.perf_counter() - t1, **extra))
            if name == "lp_n20000":
                timed = (D, L, rhs, Ld, Lo, ok, err, x)
            del Ld, Lo, x
    for name in BANDED_CASES:
        for i, (D, L) in enumerate(banded_last_iteration_blocks(name)):
            k, b = D.shape[0], D.shape[1]
            gen = torch.Generator(device="cuda")
            gen.manual_seed(100 + i)
            rhs = torch.randn(k, b, dtype=D.dtype, device="cuda", generator=gen)
            t1 = time.perf_counter()
            Ld, Lo, ok = banded_kernels.block_tridiag_factor(D, L)
            x = banded_kernels.block_tridiag_solve(Ld, Lo, rhs)
            check(same_bits(x, banded_kernels.block_tridiag_solve(Ld, Lo, rhs)),
                  f"banded solve on {name}'s last blocks {i}: two runs differ")
            fac = BlockTridiagFactors(Ld, Lo, ok)
            extra = {}
            if k <= 2500:
                x_seq, seq = block_tridiag_solve_plain(fac, rhs), "plain"
                fp = block_tridiag_cholesky_plain(D, L)
                extra = dict(factor_err_over_tol=max(
                    float((got - want).abs().max()) / (TOL[D.dtype] * float(want.abs().max()))
                    for got, want in ((Ld, fp.Ld), (Lo, fp.Lo))))
            else:
                x_seq, seq = banded_kernels.block_tridiag_solve(Ld, Lo, rhs, chunk=k), "one chunk"
            res, res_seq = banded_rel_residual(D, L, x, rhs), banded_rel_residual(D, L, x_seq, rhs)
            bound = 10.0 * res_seq + 1e-15
            check(bool(ok) and bool(torch.isfinite(x).all()) and res <= bound,
                  f"banded kernels on {name}'s last-iteration blocks {i} (k={k}): ok {bool(ok)}, "
                  f"relative residual {res:.3e} against the sequential solve's {res_seq:.3e}")
            diag = torch.diagonal(D, dim1=-2, dim2=-1)
            rows.append(dict(problem=name, iteration="last", blocks=i, k=k, b=b,
                             dtype=str(D.dtype).split(".")[1], rel_residual=res,
                             sequential_rel_residual=res_seq, sequential=seq, bound=bound,
                             diag_range=[float(diag.min()), float(diag.max())],
                             seconds=time.perf_counter() - t1, **extra))
            del Ld, Lo, x, x_seq
    banded_kernels.banded_check()
    emit("banded_path_kernels", cases=rows, seconds=time.perf_counter() - t0)
    return timed


def banded_kernel_entries(launches, timed):
    """The ``kernels`` entries of the two banded kernels, on the blocks that
    the main path gives them: the banded Schur complement of the LP at
    n = 20,000 (k = 2,500, b = 8, f64) at the starting point, as
    ``phase_banded_path_kernels`` checked them; the solve with one
    right-hand side.  ``library_ms``: ``torch.linalg.cholesky`` of the same
    matrix assembled dense, and two ``solve_triangular`` on its factor."""
    from galahad_tpu_torch.linalg.banded import (BlockTridiagFactors, block_tridiag_cholesky_plain,
                                                 block_tridiag_solve_plain)

    D, L, rhs, Ld, Lo, ok, err, x = timed
    k, b = D.shape[0], D.shape[1]
    reps = 10
    factor = lambda: banded_kernels.block_tridiag_factor(D, L)              # noqa: E731
    solve = lambda: banded_kernels.block_tridiag_solve(Ld, Lo, rhs)         # noqa: E731
    f_ms, s_ms = time_ms(factor, reps), time_ms(solve, reps)
    f_dev, s_dev = queued_ms([factor] * reps) / reps, queued_ms([solve] * reps) / reps
    f_plain = event_ms(lambda: block_tridiag_cholesky_plain(D, L))
    s_plain = event_ms(lambda: block_tridiag_solve_plain(BlockTridiagFactors(Ld, Lo, ok), rhs))
    A = dense_blocks(D, L)
    torch.linalg.cholesky(A[:64, :64])                           # the library's warm-up
    lib_f = event_ms(lambda: torch.linalg.cholesky(A))
    C = torch.linalg.cholesky(A)
    v = rhs.reshape(-1, 1)
    lib_s = event_ms(lambda: torch.linalg.solve_triangular(
        C.mT, torch.linalg.solve_triangular(C, v, upper=False), upper=True))
    lib_err = float((torch.linalg.solve_triangular(
        C.mT, torch.linalg.solve_triangular(C, v, upper=False), upper=True).reshape(k, b)
        - x).abs().max())
    del A, C
    f_bound, f_by = banded_kernels.bound_ms(banded_kernels.factor_bound_terms(k, b, D.dtype))
    s_bound, s_by = banded_kernels.bound_ms(banded_kernels.solve_bound_terms(k, b, 1, D.dtype))
    sched = banded_kernels.solve_schedule(k, banded_kernels.default_chunk(k))
    for key in ("banded_factor", "banded_solve"):
        check(launches[key] > 0, f"the banded phase launched no {key} kernel")
    common = dict(route="cuda", source=BANDED_SOURCE, k=k, b=b, dtype="float64",
                  launches_per_replay=launches["per_replay"],
                  per="one call at the main path's shape: the Schur-complement blocks of the "
                      "banded LP at n = 20,000 (launches: the banded phase's graph runs)")
    return [
        dict(name="banded_factor", replaces=TPU_BANDED_FACTOR, launches=launches["banded_factor"],
             max_abs_err=err, ms=f_ms, device_ms=f_dev, plain_ms=f_plain, bound_ms=f_bound,
             bound_by=f_by, library_ms=lib_f,
             library="torch.linalg.cholesky of the dense (k b)^2 matrix",
             critical_path_steps=k, device_us_per_step=f_dev / k * 1e3, **common),
        dict(name="banded_solve", replaces=TPU_BANDED_SOLVE, launches=launches["banded_solve"],
             max_abs_err=err, ms=s_ms, device_ms=s_dev, plain_ms=s_plain, bound_ms=s_bound,
             bound_by=s_by, library_ms=lib_s,
             library="two torch.linalg.solve_triangular on the dense Cholesky factor",
             library_max_abs_diff=lib_err, chunk=sched["chunk"], chunks=sched["chunks"],
             critical_path_steps=sched["critical_path_steps"],
             device_us_per_step=s_dev / sched["critical_path_steps"] * 1e3,
             device_us_per_row_and_direction=s_dev / (2 * k) * 1e3, **common)]

# ---------------------------------------------------------------------------
# The QP front end and the command line
# ---------------------------------------------------------------------------


def frontend_flagship(flagship_solution):
    """The flagship as a SparseQP through ``qp_solve(QPControl())``: the
    IPM's bits, every flagship kernel in each replay, no plain code."""
    from galahad_tpu_torch.qp.frontend import QPControl, qp_solve

    qp = flagship_qp(K_FLAGSHIP, "cuda")
    infos = []

    def front(q, ctl):
        x, y, z, info = qp_solve(q, ctl)
        infos.append(info)
        return x, y, z, info.ipm

    x, y, z, st, wall, peak, counts = counted_solve(qp, QPControl(), front)
    info = infos[0]
    kkt = host_kkt(qp, x, y, z)[0]
    ref = flagship_solution
    per = st.run.launches_per_replay
    check(info.solver == "cqp" and info.status == int(Status.OK) and info.inform is st.inform,
          f"frontend, flagship: {info.solver} answered with status {info.status}")
    check(st.run.path == "graph", f"frontend, flagship: ran the {st.run.path} path")
    check(all(same_bits(a.cpu(), b) for a, b in zip((x, y, z), ref[:3])) and kkt == ref[3],
          "frontend, flagship: x, y, z or the host KKT differ from ipm_solve's")
    check(per is not None and all(per[k] > 0 for k in FLAGSHIP_KERNELS),
          f"frontend, flagship: a flagship kernel is missing from the replay: {per}")
    check(all(counts[k] == 0 for k in PLAIN_COUNTS),
          f"frontend, flagship: plain code ran: { {k: counts[k] for k in PLAIN_COUNTS} }")
    return dict(status=info.status, iterations=info.iter, solver=info.solver, host_kkt=kkt,
                objective=info.obj, wall_s=wall, replays=st.run.replays,
                launches_per_replay={k: per[k] for k in FLAGSHIP_KERNELS},
                device_launches={k: counts[k] for k in FLAGSHIP_KERNELS},
                plain_counts={k: counts[k] for k in PLAIN_COUNTS},
                peak_device_memory_bytes=peak, bitwise_equal_to_ipm_solve=True)


def synced_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def frontend_dense():
    """The dense phase's QP through qp_solve with scaling and each presolve."""
    from galahad_tpu_torch.pre import (PresolveControl, ScaleControl, presolve_apply,
                                       presolve_reduce, scale_apply, scale_get)
    from galahad_tpu_torch.qp.frontend import QPControl, qp_solve

    qp = make_qp(**convex_qp_arrays(DENSE_N, DENSE_M, 0, equalities=DENSE_EQ))
    (x, _, _, st), plain_s = synced_s(lambda: ipm_solve(qp))
    check(st.status == int(Status.OK), f"frontend, n={DENSE_N}: ipm_solve status {st.status}")
    ref = float(qp.objective(x))
    _, scale_s = synced_s(lambda: scale_get(qp, ScaleControl(method="sinkhorn")))
    pinfo, apply_s = synced_s(lambda: presolve_apply(qp, PresolveControl()))
    (red, tr), reduce_s = synced_s(lambda: presolve_reduce(qp, PresolveControl()))
    rows = []
    for fields in (dict(scale=1), dict(presolve_problem=True), dict(presolve_reduce=True)):
        (x, y, z, info), wall = synced_s(lambda: qp_solve(qp, QPControl(**fields)))
        what = f"frontend, n={DENSE_N}, {fields}"
        check(info.status == int(Status.OK) and info.solver == "cqp",
              f"{what}: {info.solver} status {info.status}")
        check(x.shape == (DENSE_N,) and bool(torch.isfinite(x).all()), f"{what}: x not finite")
        kkt = dense_host_kkt(qp, x, y, z)[0]
        row = dict(control=fields, status=info.status, iterations=info.iter, host_kkt=kkt)
        if fields.get("scale"):
            # the IPM's stopping test holds on the scaled problem; back in the
            # original variables the dual residual is divided by the column
            # scale, so the 1e-6 is held where the IPM solved (the same
            # Sinkhorn factors, the solution mapped back into that problem)
            sc = scale_get(qp, ScaleControl(method="sinkhorn"))
            kkt = dense_host_kkt(scale_apply(qp, sc), x / sc.col, y / sc.row, z * sc.col)[0]
            row.update(host_kkt_original_variables=row.pop("host_kkt"), host_kkt_scaled=kkt,
                       col_scale_range=[float(sc.col.min()), float(sc.col.max())],
                       row_scale_range=[float(sc.row.min()), float(sc.row.max())])
        obj = float(qp.objective(x))
        rel = abs(obj - ref) / max(1.0, abs(ref))
        check(kkt <= 1e-6, f"{what}: host KKT {kkt:.3e}")
        check(rel <= 1e-8, f"{what}: objective {obj!r} off the plain solve's {ref!r} by {rel:.3e}")
        rows.append(dict(row, objective=obj, objective_rel_to_plain=rel,
                         path=info.ipm.run.path, wall_s=wall))
    return dict(n=DENSE_N, m=DENSE_M, plain_iterations=st.iter, plain_objective=ref,
                plain_wall_s=plain_s, scale_get_s=scale_s, presolve_apply_s=apply_s,
                presolve_apply_tightened=int(pinfo.n_tightened),
                presolve_apply_forced_rows=int(pinfo.n_forced_rows),
                presolve_reduce_s=reduce_s, presolve_reduce_n_m=[red.n, red.m],
                presolve_reduce_dropped=[tr.n_fixed, tr.n_rows_dropped], runs=rows)


def frontend_dqp():
    """DQP and CCQP through qp_solve at n = DQP_N: the JAX package's status
    and iterations, two runs bitwise equal; per DQP iteration the seconds,
    host reads and H^-1 solves.  The column read of B' against the matvec,
    bitwise, on the card."""
    from galahad_tpu_torch.qp.dqp import DQPControl, _dual_pieces, bt_unit
    from galahad_tpu_torch.qp.frontend import QPControl, qp_solve
    from galahad_tpu_torch import classify_bounds

    from galahad_tpu_torch.linalg.cholesky import chol_factor_shifted, chol_solve

    qp = make_qp(**convex_qp_arrays(DQP_N, DQP_N // 2, 0, equalities=DQP_N // 8))
    # one H^-1 solve as DQP makes it (two triangular solves on the row-major factor)
    L = chol_factor_shifted(qp.H, 0.0)[0].contiguous()
    hinv_ms = time_ms(lambda: chol_solve(L, qp.g), reps=100)
    del L
    *_, Bt, _ = _dual_pieces(qp, classify_bounds(qp), DQPControl())
    size = 2 * qp.m + 2 * qp.n
    idx = np.random.default_rng(0).choice(size, 64, replace=False)
    vals = torch.randn(size, dtype=torch.float64, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    for j in idx:
        jj = torch.full((1,), int(j), dtype=torch.int64, device="cuda")
        e = torch.zeros(size, dtype=torch.float64, device="cuda")
        e[int(j)] = vals[int(j)]
        check(torch.equal(bt_unit(qp, jj, vals[int(j)]), Bt(e)),
              f"frontend, dqp: the column read of B' differs from the matvec at {j}")
    rows = []
    for name in ("dqp", "ccqp"):
        runs = []
        for _ in range(2):
            (x, y, z, info), wall = synced_s(
                lambda: qp_solve(qp, QPControl(quadratic_programming_solver=name)))
            runs.append((x, y, z, info, wall))
        x, y, z, info, wall = runs[0]
        d = info.dqp
        status, iters, obj = JAX_DQP[name]
        check((info.status, info.iter) == (status, iters),
              f"frontend, {name}: status {info.status}, {info.iter} iterations; the JAX "
              f"package gives {status}, {iters}")
        check(info.solver == "dqp" and bool(torch.isfinite(x).all()),
              f"frontend, {name}: answered by {info.solver}, x finite: "
              f"{bool(torch.isfinite(x).all())}")
        check(all(same_bits(a, b) for a, b in zip((x, y, z), runs[1][:3]))
              and runs[1][3].iter == info.iter, f"frontend, {name}: two runs differ")
        kkt, r_p, r_d, comp = dense_host_kkt(qp, x, y, z)
        rows.append(dict(solver=name, status=info.status, iterations=info.iter,
                         objective=info.obj, jax_objective=obj,
                         objective_rel_to_jax=abs(info.obj - obj) / abs(obj),
                         norm_pg=d.norm_pg, host_kkt=kkt, host_r_p=r_p, host_r_d=r_d,
                         host_comp=comp, wall_s=[r[4] for r in runs],
                         s_per_dqp_iteration=wall / max(d.iter, 1),
                         host_reads=d.host_reads,
                         host_reads_per_iteration=d.host_reads / max(d.iter, 1),
                         hinv_solves=d.hinv_solves,
                         hinv_solves_per_iteration=d.hinv_solves / max(d.iter, 1),
                         hinv_share_of_wall=d.hinv_solves * hinv_ms / 1e3 / wall,
                         two_runs_bitwise_equal=True))
    return dict(n=qp.n, m=qp.m, column_read_bitwise_equal_matvec=len(idx), hinv_ms=hinv_ms,
                runs=rows)


def frontend_cli(root):
    """The command line on the card: ``batch`` over the sweep list against the
    front end's oracle, and ``solve --json`` on QPMIXB."""
    import io
    import tempfile

    from galahad_tpu_torch import cli

    with open(os.path.join(root, "tests", "frontend_sweep_oracle.json")) as fh:
        oracle = json.load(fh)["fixtures"]
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(root):
        out = os.path.join(tmp, "RES.d")
        t0 = time.perf_counter()
        rc = cli.main(["batch", "examples/sweep/sweep.list", "--out", out])
        batch_s = time.perf_counter() - t0
        with open(out) as fh:
            lines = fh.read().splitlines()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc_solve = cli.main(["solve", "examples/sweep/QPMIXB.qplib", "--json"])
        solve_s = time.perf_counter() - t0
    check(len(lines) == 20 and not any(" ERROR " in ln for ln in lines),
          f"frontend, batch: {len(lines)} lines, errors: {[ln for ln in lines if ' ERROR ' in ln]}")
    rows = []
    for line in lines:
        f = line.split()
        name, status, obj, iters, wall = f[0], int(f[3]), float(f[4]), int(f[8]), float(f[9])
        ref = oracle[name]
        check((status, iters) == (ref["status"], ref["iter"]),
              f"frontend, batch, {name}: status {status}, {iters} iterations; the oracle "
              f"gives {ref['status']}, {ref['iter']}")
        rel = abs(obj - ref["obj"]) / max(1.0, abs(ref["obj"]))
        check(rel <= 1e-8, f"frontend, batch, {name}: objective off by {rel:.3e} relative")
        rows.append(dict(name=name, status=status, iterations=iters, solver=ref["solver"],
                         objective_rel=rel, wall_s=wall))
    check(sorted(r["name"] for r in rows) == sorted(oracle), "frontend, batch: fixtures missing")
    check(rc == (1 if any(v["status"] != 0 for v in oracle.values()) else 0),
          f"frontend, batch: exit code {rc}")
    r = json.loads(buf.getvalue().splitlines()[-1])
    ref = oracle["QPMIXB"]
    rel = abs(r["objective"] - ref["obj"]) / abs(ref["obj"])
    check(rc_solve == 0 and (r["status"], r["iterations"]) == (ref["status"], ref["iter"])
          and rel <= 1e-8, f"frontend, solve --json QPMIXB: {r}")
    return dict(batch=rows, batch_s=batch_s, batch_exit_code=rc,
                solve_json_qpmixb=dict(r, objective_rel=rel), solve_s=solve_s)


def phase_frontend(flagship_solution):
    """``qp_solve`` and the command line on the card."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    parts, seconds = {}, {}
    for name, fn in (("flagship", lambda: frontend_flagship(flagship_solution)),
                     ("dense", frontend_dense), ("dqp", frontend_dqp),
                     ("cli", lambda: frontend_cli(root))):
        t0 = time.perf_counter()
        parts[name] = fn()
        seconds[name] = time.perf_counter() - t0
    emit("frontend", **parts, seconds=dict(seconds, total=time.perf_counter() - t_phase))


# ---------------------------------------------------------------------------
# The trust-region subproblems (the ``tr`` phase)
# ---------------------------------------------------------------------------

SECULAR_SOURCE = "galahad_tpu_torch/csrc/secular.cu"
RQS_GROWTH = 60                      # theta evaluations of RQS's bracket growth, at most
TRIDIAG_SOURCE = "galahad_tpu_torch/csrc/tridiag.cu"
TPU_TRS_NEWTON = ("galahad_tpu/tr/trs.py:93 _secular_newton (lax.fori_loop :135; XLA, "
                  "no Pallas)")
TPU_RQS_NEWTON = ("galahad_tpu/tr/trs.py:242 rqs_solve's loops (lax.while_loop :301, "
                  "lax.fori_loop :319; XLA, no Pallas)")
TPU_TRIDIAG_FACTOR = ("galahad_tpu/linalg/cholesky.py:87 tridiag_factor (lax.scan :102; XLA, "
                      "no Pallas)")
TPU_TRIDIAG_SOLVE = ("galahad_tpu/linalg/cholesky.py:109 tridiag_solve (lax.scan :118 / :130; "
                     "XLA, no Pallas)")
TR_SOLVERS = ("trs", "chol", "rqs", "dps", "dps_goldfarb")
TR_CPU = 256                         # problems of the headline batch run again on the host
# obj (and multiplier) relative to tests/trs_oracle.json (float64 results of
# the JAX package: held in f64 only; in f32 recorded) and to the port's CPU
# run of the same call; s of the secular kernels relative to their plain
# versions.  f32: the CPU run and the card each lie ~1e-4-3e-3 from the f64
# answer (the eigenvalues in f32; rqs's sigma ||x||^3 term), so 1e-2.
TR_TOL = {torch.float64: dict(oracle=1e-10, cpu=1e-10, s=1e-12),
          torch.float32: dict(oracle=None, cpu=1e-2, s=1e-5)}
TRIDIAG_CHAIN = 1_000_000            # the long chain of the tridiagonal kernels
TRIDIAG_PREFIX = 20_000              # its rows held to the plain factor on the host
# kernel against plain, relative to the largest value: the plain version on the
# card rounds l e before the difference, the kernel does not (one rounding per
# step along a diagonally dominant chain)
TRIDIAG_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
SPARSE_RADIUS, SPARSE_CONTRACT, SPARSE_SHIFT = 1.5, 0.75, 3.0
FLAGSHIP_PLAIN = ("ldlt_wide_plain", "extend_add_plain", "sweep_plain")


def tr_counts() -> dict:
    from galahad_tpu_torch.linalg import tridiag_kernels
    from galahad_tpu_torch.tr import secular_kernels

    out = dict(secular_kernels.secular_counts())
    out.update({"tridiag_" + k: v for k, v in tridiag_kernels.tridiag_counts().items()})
    return out


def reset_tr_counts() -> None:
    from galahad_tpu_torch.linalg import tridiag_kernels
    from galahad_tpu_torch.tr import secular_kernels

    secular_kernels.reset_secular_counts()
    tridiag_kernels.reset_tridiag_counts()


def reset_flagship_counts() -> None:
    ldlt_kernels.reset_launch_count()
    sweep_kernels.reset_sweep_counts()
    ea_kernels.reset_ea_counts()


def tr_solve(name, H, c, radius):
    from galahad_tpu_torch.tr import dps_solve, rqs_solve, trs_solve, trs_solve_chol

    if name == "trs":
        return trs_solve(H, c, radius)
    if name == "chol":
        return trs_solve_chol(H, c, radius)
    if name == "rqs":
        return rqs_solve(H, c, 1.0 / radius, p=3.0)
    return dps_solve(H, c, radius=radius, goldfarb=name == "dps_goldfarb")


def rel_err(got, ref) -> float:
    got = torch.as_tensor(got, dtype=torch.float64).cpu()
    ref = torch.as_tensor(ref, dtype=torch.float64).cpu()
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) if ref.numel() else 0.0


def same_info(a, b) -> bool:
    return all(same_bits(getattr(a, f), getattr(b, f))
               for f in ("x", "obj", "multiplier", "norm_x", "hard_case", "interior"))


def chained_ms(fn, c, reps: int) -> float:
    """Device time of ``reps`` solves chained through the linear term (rep
    i+1's c is c + 1e-4 x of rep i), by CUDA events after a sync."""
    torch.cuda.synchronize()

    def run():
        cc = c
        for _ in range(reps):
            cc = cc + 1e-4 * fn(cc)

    return event_ms(run)


def slope_ms(fn, c, r1: int = 2, r2: int = 10) -> float:
    """ms per batch by the bench's two-point slope (bench.py:112-122); the
    main path has run ``fn`` twice already."""
    return (chained_ms(fn, c, r2) - chained_ms(fn, c, r1)) / (r2 - r1)


def hard_equality_batch(dtype):
    """The headline H with c cut to have no part along the leftmost
    eigenvector in every third problem and scaled by 0.01 (hard cases), for
    the kernels' check beside equality problems."""
    H, c, radius = headline_batch(dtype)
    lam, Q = torch.linalg.eigh(H)
    ct = (Q.mT @ c[..., None])[..., 0]
    ct[::3, 0] = 0.0
    return H, (Q @ (0.01 * ct)[..., None])[..., 0], radius


def sparse_trs_problems(device):
    """The sparse TRS's problems at the flagship's width: H = the grid
    Laplacian of grid_qp_coo(316) minus 3 I (indefinite), g =
    default_rng(5); and the hard case H = diag(linspace(-1, 3, n)) with
    g = 0.01 e_j, j = round(0.2 (n - 1)): the same place in the spectrum as
    e_3 at n = 16 in tests/test_trs_sparse.py (at n = 99,856 e_3 lies 1.2e-4
    above the leftmost eigenvalue, and that problem is not a hard case)."""
    from galahad_tpu_torch import COOPattern

    n, _, (ii, jj, vv), _ = grid_qp_coo(K_FLAGSHIP)
    vv = vv.copy()
    vv[ii == jj] -= SPARSE_SHIFT
    g = np.random.default_rng(5).standard_normal(n)
    gh = np.zeros(n)
    gh[int(round(0.2 * (n - 1)))] = 0.01
    ar = np.arange(n)
    return dict(
        grid=(COOPattern(ii, jj, n, n), torch.as_tensor(vv, device=device), g, vv),
        hard=(COOPattern(ar, ar, n, n), torch.as_tensor(np.linspace(-1.0, 3.0, n),
                                                        device=device), gh, None))


def sparse_optimality(pat, vals, g, info, radius, m_diag, shift):
    """The sparse TRS's result held by its optimality conditions, in float64
    with scipy on the host: ||x||_M = radius within 1e-10 radius on the
    boundary; ||(H + lam M) x + g|| <= 1e-8 ||g|| (plus, in the hard case,
    ``shift`` ||M x||: the reference takes the hard case's x from the
    factorization of H + (lam + shift) M); lam >= 0; and no negative
    eigenvalue of H + lam M (the signs of the pivots of an LDL' of it by
    SuperLU with diagonal pivots, or its diagonal where H is diagonal)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    n = pat.n
    r, c = pat.rows.astype(np.int64), pat.cols.astype(np.int64)
    v = np.asarray(vals, np.float64)
    Hl = sp.coo_matrix((v, (r, c)), shape=(n, n))
    H = (Hl + sp.triu(Hl.T, 1)).tocsc()
    x = info.x.double().cpu().numpy()
    m = np.ones(n) if m_diag is None else np.full(n, float(m_diag))
    lam = float(info.multiplier)
    norm_m = float(np.sqrt((m * x * x).sum()))
    res = float(np.linalg.norm(H @ x + lam * m * x + g))
    bound = 1e-8 * np.linalg.norm(g) + (shift * np.linalg.norm(m * x) if info.hard_case else 0.0)
    if (r == c).all():
        negatives = int((H.diagonal() + lam * m < 0).sum())
    else:
        lu = splu((H + sp.diags(lam * m)).tocsc(), permc_spec="MMD_AT_PLUS_A",
                  diag_pivot_thresh=0.0, options=dict(SymmetricMode=True))
        negatives = int((lu.U.diagonal() < 0).sum())
    boundary = not info.interior
    out = dict(norm_x_m=norm_m, radius=radius, multiplier=lam, residual=res,
               residual_bound=bound, negative_eigenvalues=negatives,
               n_factorizations=info.n_factorizations, hard_case=info.hard_case,
               interior=info.interior, obj=info.obj)
    check(not boundary or abs(norm_m - radius) <= 1e-10 * radius,
          f"tr, sparse: ||x||_M = {norm_m!r}, radius {radius}")
    check(res <= bound, f"tr, sparse: residual {res:.3e} > {bound:.3e}")
    check(lam >= 0 and negatives == 0,
          f"tr, sparse: lambda {lam}, {negatives} negative eigenvalues of H + lambda M")
    return out


def coo_matvecs(pat, vals):
    """(A v, A' u) of a COO matrix, and H v where ``pat`` is the lower
    triangle of a symmetric H: the fixed-order sums of core/sparse.py."""
    seg_r, src_r, _ = pat._dev("row", vals.device)
    seg_c, src_c, _ = pat._dev("col", vals.device)
    seg_s, src_s, vsel = pat._dev("sym", vals.device)
    vs = vals.index_select(0, vsel)
    return (lambda v: seg_r(vals * v.index_select(0, src_r)),
            lambda u: seg_c(vals * u.index_select(0, src_c)),
            lambda v: seg_s(vs * v.index_select(0, src_s)))


def krylov_runs(device):
    """The Krylov solvers at the flagship's width on ``device``: GLTR, GLRT,
    LQR, LQT on the sparse TRS's H (n = 99,856, COO matvec), LSTR, LSRT,
    L2RT on the A of grid_qp_coo(316) (49,928 x 99,856), LLST on a dense
    2,048 x 512 A and LLS on a dense 4,096 x 1,024 A.  Returns
    {name: (info, wall seconds)}."""
    from galahad_tpu_torch import COOPattern
    from galahad_tpu_torch import tr as TR

    n, m, (ii, jj, vv), (ar, ac, av) = grid_qp_coo(K_FLAGSHIP)
    vv = vv.copy()
    vv[ii == jj] -= SPARSE_SHIFT
    hmv = coo_matvecs(COOPattern(ii, jj, n, n), torch.as_tensor(vv, device=device))[2]
    amv, atmv, _ = coo_matvecs(COOPattern(ar, ac, m, n), torch.as_tensor(av, device=device))
    g = torch.as_tensor(np.random.default_rng(5).standard_normal(n), device=device)
    b = torch.as_tensor(np.random.default_rng(6).standard_normal(m), device=device)
    rng = np.random.default_rng(7)
    A1, b1 = (torch.as_tensor(a, device=device) for a in (rng.normal(size=(2048, 512)),
                                                          rng.normal(size=2048)))
    A2, b2 = (torch.as_tensor(a, device=device) for a in (rng.normal(size=(4096, 1024)),
                                                          rng.normal(size=4096)))
    calls = dict(
        gltr=lambda: TR.gltr_solve(hmv, g, SPARSE_RADIUS),
        glrt=lambda: TR.glrt_solve(hmv, g, 1.0),
        lqr=lambda: TR.lqr_solve(hmv, g, SPARSE_RADIUS),
        lqt=lambda: TR.lqt_solve(hmv, g, 1.0),
        lstr=lambda: TR.lstr_solve(amv, atmv, b, 1.0),
        lsrt=lambda: TR.lsrt_solve(amv, atmv, b, 1.0),
        l2rt=lambda: TR.l2rt_solve(amv, atmv, b, 1.0, p=3.0),
        llst=lambda: TR.llst_solve(A1, b1, 1.0),
        lls=lambda: TR.lls_solve(A2, b2, 1.0))
    out = {}
    for name, fn in calls.items():
        info, wall = synced_s(fn) if device != "cpu" else _host_s(fn)
        out[name] = (info, wall)
    return out


def _host_s(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def tr_main_path():
    """The ``tr`` phase's main path on the card, as a user calls it, with the
    counters of the secular and tridiagonal kernels set to 0 before and read
    after (those of the flagship kernels around the sparse TRS): every
    batched solver on the headline batch in f64 and f32, twice; the
    tridiagonal LDL' entry points on 1,024 systems of k = 64 and on one
    chain of k = 1,000,000; the sparse TRS (three solves and a contract);
    and the Krylov solvers."""
    from galahad_tpu_torch.linalg import tridiag_factor, tridiag_solve
    from galahad_tpu_torch.tr import trs_contract, trs_solve_sparse
    from galahad_tpu_torch.tr.trs_sparse import trs_sparse_plan

    torch.cuda.synchronize()
    reset_tr_counts()
    headline, inputs = {}, {}
    for dtype in (torch.float64, torch.float32):
        H, c, radius = headline_batch(dtype)
        # the secular kernels' inputs of the first runs, for their checks
        inputs[dtype] = capture_secular_inputs(lambda: [
            headline.__setitem__((name, dtype), [synced_s(lambda: tr_solve(name, H, c, radius))])
            for name in TR_SOLVERS])
        for name in TR_SOLVERS:
            headline[(name, dtype)].append(synced_s(lambda: tr_solve(name, H, c, radius)))
    tri = {}
    for dtype in (torch.float64, torch.float32):
        d, e, b = tridiag_systems(TR_BATCH, TR_N, dtype)
        dh, l = tridiag_factor(d, e)
        tri[("batch", dtype)] = (d, e, b, dh, l, tridiag_solve(dh, l, b))
    d, e, b = tridiag_systems(0, TRIDIAG_CHAIN, torch.float64, seed=1)
    (dh, l), fac_s = synced_s(lambda: tridiag_factor(d, e))
    x, sol_s = synced_s(lambda: tridiag_solve(dh, l, b))
    tri["chain"] = (d, e, b, dh, l, x, fac_s, sol_s)

    probs = sparse_trs_problems("cuda")
    pat, hv, g, _ = probs["grid"]
    reset_flagship_counts()
    _, analyse_s = synced_s(lambda: trs_sparse_plan(pat))
    sparse = {}
    sparse["radius"] = synced_s(lambda: trs_solve_sparse(pat, hv, g, SPARSE_RADIUS))
    sparse["m_diag"] = synced_s(lambda: trs_solve_sparse(pat, hv, g, SPARSE_RADIUS,
                                                         m_diag=np.full(pat.n, 2.0)))
    sparse["contract"] = synced_s(lambda: trs_contract(pat, hv, g, SPARSE_CONTRACT,
                                                       sparse["radius"][0]))
    grid_launches = launch_counts()
    hpat, hvals, gh, _ = probs["hard"]
    sparse["hard"] = synced_s(lambda: trs_solve_sparse(hpat, hvals, gh, 5.0))
    krylov = krylov_runs("cuda")
    counts = tr_counts()
    return dict(headline=headline, inputs=inputs, tridiag=tri, sparse=sparse,
                analyse_s=analyse_s, grid_launches=grid_launches, krylov=krylov, counts=counts,
                probs=probs)


def tr_headline_rows(main, oracle):
    """The headline batch: each solver's two runs bitwise equal; in f64 obj
    and multiplier within 1e-10 relative of tests/trs_oracle.json and its
    flags equal; obj within ``TR_TOL`` of the port's own CPU run of the same
    call on the first ``TR_CPU`` problems and the flags equal to it; its
    time by the bench's chained slope, and ``eigh``'s time and share of it."""
    from galahad_tpu_torch.tr.trs import _eigh

    rows = []
    for dtype in (torch.float64, torch.float32):
        H, c, radius = headline_batch(dtype)
        # the CPU run on the first TR_CPU problems: each problem's answer does not
        # depend on the rest of the batch (checked on the card below)
        Hc, cc, rc = (a[:TR_CPU].cpu() for a in (H, c, radius))
        tol = TR_TOL[dtype]
        eigh_ms = time_ms(lambda: _eigh(H), reps=1)
        perm = torch.randperm(TR_BATCH, generator=torch.Generator().manual_seed(0)).to("cuda")
        lam_a, _ = _eigh(H)
        lam_b, _ = _eigh(H[perm])
        eigh_position_free = same_bits(lam_a[perm], lam_b)
        for name in TR_SOLVERS:
            (a, wall_a), (b, wall_b) = main["headline"][(name, dtype)]
            what = f"tr, {name}, {str(dtype)[6:]}"
            check(same_info(a, b), f"{what}: two runs differ")
            check(bool(torch.isfinite(a.x).all()) and a.x.shape == (TR_BATCH, TR_N),
                  f"{what}: x not finite or of shape {tuple(a.x.shape)}")
            host = tr_solve(name, Hc, cc, rc)
            cpu_err = rel_err(a.obj[:TR_CPU], host.obj)
            check(cpu_err <= tol["cpu"], f"{what}: obj off the CPU run by {cpu_err:.3e}")
            flags = ("hard_case", "interior")
            # f32's factorization TRS flags the problems its Newton leaves short
            # of 1e-6 as near-hard: recorded, not held
            if not (name == "chol" and dtype == torch.float32):
                check(all(torch.equal(getattr(a, f)[:TR_CPU].cpu(), getattr(host, f))
                          for f in flags), f"{what}: flags differ from the CPU run")
            ora_err = rel_err(a.obj, oracle[f"{name}_obj"])
            row = dict(solver=name, dtype=str(dtype)[6:], obj_rel_oracle=ora_err,
                       obj_rel_cpu=cpu_err, two_runs_bitwise_equal=True,
                       wall_s=[wall_a, wall_b], cpu_problems=TR_CPU,
                       cpu_hard_cases=int(host.hard_case.sum()),
                       card_hard_cases_of_those=int(a.hard_case[:TR_CPU].sum()))
            if tol["oracle"] is not None:
                check(ora_err <= tol["oracle"], f"{what}: obj off the oracle by {ora_err:.3e}")
                if f"{name}_multiplier" in oracle:
                    row["multiplier_rel_oracle"] = rel_err(a.multiplier,
                                                           oracle[f"{name}_multiplier"])
                    check(row["multiplier_rel_oracle"] <= tol["oracle"],
                          f"{what}: multiplier off the oracle")
                for f in flags:
                    key = f"{name}_{f}"
                    if key in oracle:
                        check(torch.equal(getattr(a, f).cpu(),
                                          torch.as_tensor(oracle[key], dtype=torch.bool)),
                              f"{what}: {f} differs from the oracle")
            row["hard_cases"] = int(a.hard_case.sum())
            row["interior"] = int(a.interior.sum())
            # the bench's reps for its own cell (trs, f64) and for the factorization
            # TRS; the other eigh-bound solvers take eigh's time (eigh_ms) and
            # are timed with fewer reps
            reps = (2, 10) if name == "chol" or (name, dtype) == ("trs", torch.float64) \
                else (1, 2)
            ms = slope_ms(lambda cv: tr_solve(name, H, cv, radius).x, c, *reps)
            row.update(ms_per_batch=ms, solves_per_s=TR_BATCH / ms * 1e3, slope_reps=reps)
            if name != "chol":
                row["eigh_ms"] = eigh_ms
                row["eigh_share"] = eigh_ms / ms
            rows.append(row)
        rows.append(dict(dtype=str(dtype)[6:], eigh_ms=eigh_ms,
                         eigh_bitwise_under_batch_permutation=eigh_position_free))
    return rows


def rqs_hard(lam, ct2, excl, sigma, p, lam_lo):
    """The problems rqs_solve flags as hard on these kernel inputs (there it
    takes lam_lo, not the kernel's s: s is the end of a bracket with no
    root, set by roundoff)."""
    from galahad_tpu_torch.tr.trs import _rqs_theta

    norm_lo = _rqs_theta(lam, ct2, excl, sigma, p - 2.0, lam_lo)[1]
    return excl.any(-1) & (lam.min(-1).values < 0) & (norm_lo < (lam_lo / sigma) ** (1 / (p - 2)))


def secular_checks(main):
    """Both secular kernels against their plain versions on the card: on the
    inputs the main path gave them (trs_solve, rqs_solve and dps_solve on
    the headline batch, f64 and f32) and on a batch of hard cases and
    equality problems (f64): max relative error of s (for RQS over the
    problems that use s, not the hard ones), the kernels' answers and
    iteration counts under a permutation of the batch (bitwise), and every
    count between 1 and the cap (percentiles recorded)."""
    from galahad_tpu_torch.tr import TRSControl, secular_kernels
    from galahad_tpu_torch.tr import trs as T

    H, c, radius = hard_equality_batch(torch.float64)
    sets = [(f"headline_{str(dt)[6:]}", main["inputs"][dt]) for dt in main["inputs"]]
    sets.append(("hard_equality_float64", capture_secular_inputs(lambda: (
        T.trs_solve(H, c, radius), T.trs_solve(H, c, radius, ctl=TRSControl(
            equality_problem=True)), T.rqs_solve(H, c, 1.0 / radius)))))
    out = dict(trs=[], rqs=[])
    perm = torch.randperm(TR_BATCH, generator=torch.Generator().manual_seed(1)).to("cuda")

    def counts_ok(name, case, its, its_perm, cap, what="iteration"):
        check(int(its.min()) >= min(1, cap) and int(its.max()) <= cap,
              f"tr, {name}, {case}: {what} counts {int(its.min())}..{int(its.max())} "
              f"outside 1..{cap}")
        check(torch.equal(its[perm], its_perm), f"tr, {name}, {case}: the batch position "
              f"changed a{'n' if what[0] in 'aeiou' else ''} {what} count")
        return secular_kernels.iteration_percentiles(its)

    for case, got in sets:
        for a in got["trs"]:
            lam, ct2, radius_b, lam_lo, n_its = a
            tol = TR_TOL[lam.dtype]["s"]
            radius_b = radius_b.expand(lam.shape[:-1])
            s_k, its = secular_kernels.trs_secular_newton(lam, ct2, radius_b, lam_lo, n_its,
                                                          iterations=True)
            s_p = T.secular_newton_plain(lam, ct2, radius_b, lam_lo, n_its)
            s_perm, its_perm = secular_kernels.trs_secular_newton(
                lam[perm], ct2[perm], radius_b[perm], lam_lo[perm], n_its, iterations=True)
            err = rel_err(s_k, s_p)
            check(err <= tol, f"tr, trs_secular_newton, {case}: {err:.3e} > {tol:.1e}")
            check(same_bits(s_k[perm], s_perm), f"tr, trs_secular_newton, {case}: the batch "
                  f"position changed the answer")
            pct = counts_ok("trs_secular_newton", case, its, its_perm, n_its)
            out["trs"].append(dict(case=case, max_rel_err=err, tol=tol, its=n_its,
                                   iterations=pct))
        for a in got["rqs"]:
            lam, ct2, excl, sigma, p, lam_lo, hi0, n_its = a
            tol = TR_TOL[lam.dtype]["s"]
            sigma = sigma.expand(lam.shape[:-1])
            s_k, its, growth = secular_kernels.rqs_secular_newton(
                lam, ct2, excl, sigma, p, lam_lo, hi0, n_its, iterations=True)
            s_p = T.rqs_newton_plain(lam, ct2, excl, sigma, p, lam_lo, hi0, n_its)
            s_perm, its_perm, growth_perm = secular_kernels.rqs_secular_newton(
                lam[perm], ct2[perm], excl[perm], sigma[perm], p, lam_lo[perm], hi0[perm], n_its,
                iterations=True)
            hard = rqs_hard(lam, ct2, excl, sigma, p, lam_lo)
            err = rel_err(s_k[~hard], s_p[~hard])
            check(err <= tol, f"tr, rqs_secular_newton, {case}: {err:.3e} > {tol:.1e}")
            check(same_bits(s_k[perm], s_perm), f"tr, rqs_secular_newton, {case}: the batch "
                  f"position changed the answer")
            pct = counts_ok("rqs_secular_newton", case, its, its_perm, n_its)
            grown = counts_ok("rqs_secular_newton", case, growth, growth_perm, RQS_GROWTH,
                              "growth evaluation")
            out["rqs"].append(dict(case=case, max_rel_err=err, tol=tol, its=n_its,
                                   iterations=pct, growth_evaluations=grown,
                                   excluded_entries=int(excl.sum()),
                                   hard=int(hard.sum()),
                                   max_rel_err_hard=rel_err(s_k[hard], s_p[hard])))
    return out


def secular_entries(main, checks):
    """The ``kernels`` entries of the two secular kernels, on the inputs the
    main path gives them on the headline batch in f64 (trs_solve's and
    rqs_solve's calls; f32 beside them), and at the Krylov solvers' shape
    (B = 1, n = 64, padded), timed by tools/secular_bench.py::timing: device
    time, critical path (the largest count of iterations the kernel took, RQS's
    growth evaluations added, all the kernel's own counts) and time per step,
    iteration percentiles, schedule; the bound from the iterations this run's
    data needed."""
    from galahad_tpu_torch.tr import secular_kernels

    counts = main["counts"]
    for key in ("trs", "rqs"):
        check(counts[key] > 0, f"tr: the main path launched no {key} secular kernel")
        check(counts[key + "_plain"] == 0, f"tr: the main path ran the plain {key} iteration")
    krylov = secular_bench.krylov_secular_inputs()
    out = {}
    for name in ("trs", "rqs"):
        rows = {}
        for shape, a in (("headline_float64", main["inputs"][torch.float64][name][0]),
                         ("headline_float32", main["inputs"][torch.float32][name][0]),
                         ("krylov_padded_float64", krylov[name][0])):
            row = rows[shape] = secular_bench.timing(name, a)
            tol = TR_TOL[a[0].dtype]["s"]
            check(row["max_rel_err"] <= tol, f"tr, {name}_secular_newton, {shape}: "
                  f"{row['max_rel_err']:.3e} from the plain version")
        out[name] = rows
    B, n = main["inputs"][torch.float64]["trs"][0][0].shape
    h_trs, h_rqs = out["trs"]["headline_float64"], out["rqs"]["headline_float64"]
    tb, to = secular_kernels.trs_bound_terms(B, n, h_trs["iterations_total"], torch.float64)
    rb, ro = secular_kernels.rqs_bound_terms(B, n, h_rqs["theta_evaluations"], torch.float64)
    per = (f"one call at the main path's shape: the headline batch ({B} x {n}, f64) as "
           f"trs_solve / rqs_solve give it; the bound counts the iterations this run's data "
           f"needed; by_shape: f32 and the Krylov solvers' shape (B = 1, n = 64, "
           f"{secular_bench.KRYLOV_ROWS} Lanczos rows and the 1e12 pad)")
    keys = ("critical_path_steps", "device_us_per_step", "iterations", "iterations_total",
            "schedule")
    return [
        dict(name="trs_secular_newton", route="cuda", source=SECULAR_SOURCE,
             replaces=TPU_TRS_NEWTON, launches=counts["trs"],
             max_abs_err=max(r["max_rel_err"] for r in checks["trs"]),
             err="relative, s against the plain version", ms=h_trs["ms"],
             device_ms=h_trs["device_ms"], plain_ms=h_trs["plain_ms"],
             bound_ms=max(tb, to) * 1e3, bound_by="bytes" if tb >= to else "operations",
             library_ms=None, max_its=h_trs["max_its"], **{k: h_trs[k] for k in keys},
             per=per, by_shape=out["trs"], checks=checks["trs"]),
        dict(name="rqs_secular_newton", route="cuda", source=SECULAR_SOURCE,
             replaces=TPU_RQS_NEWTON, launches=counts["rqs"],
             max_abs_err=max(r["max_rel_err"] for r in checks["rqs"]),
             err="relative, s against the plain version", ms=h_rqs["ms"],
             device_ms=h_rqs["device_ms"], plain_ms=h_rqs["plain_ms"],
             bound_ms=max(rb, ro) * 1e3, bound_by="bytes" if rb >= ro else "operations",
             library_ms=None, max_its=h_rqs["max_its"], **{k: h_rqs[k] for k in keys},
             growth_evaluations_max=h_rqs["growth_evaluations_max"],
             theta_evaluations=h_rqs["theta_evaluations"], per=per, by_shape=out["rqs"],
             checks=checks["rqs"])]


def tridiag_err(got, ref) -> float:
    """max |got - ref| over max |ref| (the tridiagonal kernels' error)."""
    return max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-300)
               for g, r in zip(got, ref) if r.numel())


def tridiag_entries(main):
    """The tridiagonal kernels against their plain versions on the main
    path's systems (1,024 x 64, f64 and f32): on the card within
    ``TRIDIAG_TOL`` of the largest value (torch's addcmul on CUDA rounds the
    product before the difference, the kernel's fma does not), and bitwise
    equal to the plain version on the host (whose addcmul is fused, as XLA's
    scan step: the JAX package's bits); on the chain of k = 1,000,000 (f64)
    the factor's first ``TRIDIAG_PREFIX`` rows bitwise equal to the plain
    version on the host, and the solve (its chunked layout) within 10 x the
    sequential solve's relative residual + 1e-15 (the sequential solve: the
    batch layout, bitwise the plain version's) and bitwise repeatable.  Their
    ``kernels`` entries at 1,024 x 64, f64, with ``by_shape`` at the shapes
    (a)-(d) of tools/tridiag_bench.py."""
    from galahad_tpu_torch.linalg import tridiag_kernels
    from galahad_tpu_torch.linalg.cholesky import tridiag_factor_plain, tridiag_solve_plain

    counts = main["counts"]
    checks = []
    for dtype in (torch.float64, torch.float32):
        d, e, b, dh, l, x = main["tridiag"][("batch", dtype)]
        pd, pl = tridiag_factor_plain(d, e)
        px = tridiag_solve_plain(pd, pl, b)
        err = tridiag_err((dh, l, x), (pd, pl, px))
        hd, hl = tridiag_factor_plain(d.cpu(), e.cpu())
        hx = tridiag_solve_plain(hd, hl, b.cpu())
        host_err = tridiag_err((dh.cpu(), l.cpu(), x.cpu()), (hd, hl, hx))
        tol = TRIDIAG_TOL[dtype]
        check(err <= tol and host_err == 0.0, f"tr, tridiag {dtype}: {err:.3e} against the "
              f"plain version on the card (tol {tol:.1e}), {host_err:.3e} on the host (bitwise)")
        checks.append(dict(shape=[TR_BATCH, TR_N], dtype=str(dtype)[6:], rel_err=err, tol=tol,
                           rel_err_host_plain=host_err, bitwise_equal_to_host_plain=True,
                           residual=tridiag_residual(d, e, b, x)))
    d, e, b, dh, l, x, fac_s, sol_s = main["tridiag"]["chain"]
    P = TRIDIAG_PREFIX
    pd, pl = tridiag_factor_plain(d[:P].cpu(), e[:P - 1].cpu())
    prefix_equal = torch.equal(dh[:P].cpu(), pd) and torch.equal(l[:P - 1].cpu(), pl)
    res = tridiag_residual(d, e, b, x)
    x_seq = tridiag_kernels.tridiag_solve(dh, l, b, layout="batch")
    rel = tridiag_rel_residual(d, e, b, x)
    rel_seq = tridiag_rel_residual(d, e, b, x_seq)
    again = same_bits(tridiag_kernels.tridiag_solve(dh, l, b), x)
    check(prefix_equal and res <= 1e-12 and rel <= 10 * rel_seq + 1e-15 and again,
          f"tr, tridiag chain: prefix bitwise {prefix_equal}, relative residual {res:.3e}, "
          f"{rel:.3e} against the sequential solve's {rel_seq:.3e}, repeatable {again}")
    sch = tridiag_kernels.tridiag_schedule(1, TRIDIAG_CHAIN, torch.float64)
    checks.append(dict(shape=[TRIDIAG_CHAIN], dtype="float64", factor_prefix_rows=P,
                       factor_prefix_bitwise_equal_to_host_plain=prefix_equal,
                       solve_relative_residual=res, residual_tol=1e-12,
                       solve_rel_residual_normwise=rel, sequential_rel_residual_normwise=rel_seq,
                       solve_two_runs_bitwise_equal=again, factor_s=fac_s, solve_s=sol_s,
                       factor_us_per_row=fac_s / TRIDIAG_CHAIN * 1e6,
                       solve_us_per_row=sol_s / TRIDIAG_CHAIN * 1e6,
                       factor_layout=sch["factor"]["layout"], solve_layout=sch["solve"]["layout"],
                       chunk=sch["solve"]["chunk"], chunks=sch["solve"]["chunks"]))
    err64 = checks[0]["rel_err"]
    d, e, b, dh, l, x = main["tridiag"][("batch", torch.float64)]
    fac = lambda: tridiag_kernels.tridiag_factor(d, e)           # noqa: E731
    sol = lambda: tridiag_kernels.tridiag_solve(dh, l, b)        # noqa: E731
    f_ms, s_ms = time_ms(fac, reps=20), time_ms(sol, reps=20)
    f_dev, s_dev = queued_ms([fac] * 20) / 20, queued_ms([sol] * 20) / 20
    f_plain = event_ms(lambda: tridiag_factor_plain(d, e))
    s_plain = event_ms(lambda: tridiag_solve_plain(dh, l, b))
    T = torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
    torch.linalg.solve(T[:2], b[:2])                                   # the library's warm-up
    lib_s = event_ms(lambda: torch.linalg.solve(T, b))
    lib_err = float((torch.linalg.solve(T, b) - x).abs().max())
    del T
    fb, fo = tridiag_kernels.factor_bound_terms(TR_BATCH, TR_N, d.dtype)
    sb, so = tridiag_kernels.solve_bound_terms(TR_BATCH, TR_N, d.dtype)
    for key in ("factor", "solve"):
        check(counts["tridiag_" + key] > 0, f"tr: the main path launched no tridiag {key}")
        check(counts[f"tridiag_{key}_plain"] == 0, f"tr: the main path ran the plain {key}")
    by_shape = dict(tridiag_factor={}, tridiag_solve={})
    for name, (B, k, dtype) in tridiag_bench.SHAPES.items():
        for row in tridiag_bench.bench(name, B, k, dtype):
            by_shape[row["kernel"]][name] = {
                key: row[key] for key in ("device_ms", "critical_path_steps",
                                          "device_us_per_step", "device_us_per_row", "residual",
                                          "schedule") if key in row}
    sched = tridiag_kernels.tridiag_schedule(TR_BATCH, TR_N, torch.float64)
    per = (f"one call at the main path's shape: {TR_BATCH} systems of k = {TR_N} (GLTR's "
           f"itmax), f64; launches: the tridiagonal entry points of the tr phase (no solver "
           f"of either package calls them); by_shape: device ms by tools/tridiag_bench.py at "
           f"(a) 1,024 x 64 f64 / f32, (b) 1 x 64, (c) 64 x 5,000, (d) one chain of 10^6 rows")
    out = []
    for name, src, ms, dev, plain, (tb, to), lib in (
            ("tridiag_factor", TPU_TRIDIAG_FACTOR, f_ms, f_dev, f_plain, (fb, fo), None),
            ("tridiag_solve", TPU_TRIDIAG_SOLVE, s_ms, s_dev, s_plain, (sb, so), lib_s)):
        which = name.split("_")[1]
        steps = sched[which]["critical_path_steps"]
        entry = dict(name=name, route="cuda", source=TRIDIAG_SOURCE, replaces=src,
                     launches=counts["tridiag_" + which], max_abs_err=err64,
                     err="relative to the largest value, against the plain version on the card",
                     ms=ms, device_ms=dev, plain_ms=plain, bound_ms=max(tb, to) * 1e3,
                     bound_by="bytes" if tb >= to else "operations", library_ms=lib,
                     schedule=sched[which], critical_path_steps=steps,
                     device_us_per_step=dev / steps * 1e3, per=per, by_shape=by_shape[name])
        if lib is not None:
            entry.update(library="torch.linalg.solve on the assembled dense (1024, 64, 64) "
                                 "tridiagonals", library_max_abs_diff=lib_err)
        else:
            entry["checks"] = checks
        out.append(entry)
    return out


def tr_sparse_rows(main):
    """The sparse TRS's runs held by their optimality conditions; trials,
    analyse seconds, ms per trial, launches of rows 1a-3 (plain 0)."""
    sparse, probs = main["sparse"], main["probs"]
    pat, hv, g, vv = probs["grid"]
    hpat, hvals, gh, _ = probs["hard"]
    from galahad_tpu_torch.tr import TRSSparseControl

    shift = TRSSparseControl().hard_case_shift
    rows = {}
    for name, (info, wall) in sparse.items():
        if name == "hard":
            opt = sparse_optimality(hpat, hvals.cpu().numpy(), gh, info, 5.0, None, shift)
            check(info.hard_case, "tr, sparse: the hard case was not flagged")
        else:
            radius = SPARSE_CONTRACT if name == "contract" else SPARSE_RADIUS
            opt = sparse_optimality(pat, vv, g, info, radius,
                                    2.0 if name == "m_diag" else None, shift)
        rows[name] = dict(opt, wall_s=wall, ms_per_trial=wall / info.n_factorizations * 1e3,
                          history_lambda=[float(v) for v in info.history_lambda])
    gl = main["grid_launches"]
    for key in ("partial_ldlt", "ldlt_wide", "extend_add", "sweep_fwd", "sweep_bwd"):
        check(gl[key] > 0, f"tr, sparse: no {key} launch on the grid's trials")
    check(all(gl[k] == 0 for k in FLAGSHIP_PLAIN), f"tr, sparse: plain code ran: {gl}")
    return dict(n=pat.n, analyse_s=main["analyse_s"], runs=rows,
                launches_grid_runs={k: gl[k] for k in KERNEL_COUNTS},
                plain_counts={k: gl[k] for k in FLAGSHIP_PLAIN})


def tr_krylov_rows(main):
    """Each Krylov solver's card run against the port's CPU run of the same
    inputs: iter equal, x within 1e-8 relative."""
    host = krylov_runs("cpu")
    rows = {}
    for name, (info, wall) in main["krylov"].items():
        ref, host_s = host[name]
        err = rel_err(info.x, ref.x)
        it = getattr(info, "iter", None)
        check(it == getattr(ref, "iter", None), f"tr, {name}: iter {it} on the card, "
              f"{getattr(ref, 'iter', None)} on the CPU")
        check(err <= 1e-8 and bool(torch.isfinite(info.x).all()),
              f"tr, {name}: x off the CPU run by {err:.3e}")
        rows[name] = dict(iter=it, x_rel_cpu=err, wall_s=wall, cpu_wall_s=host_s,
                          obj=float(getattr(info, "obj", getattr(info, "r_norm", 0.0))),
                          multiplier=float(info.multiplier))
    return rows


def phase_tr():
    """The trust-region subproblems on the card: one ``tr`` line; returns
    the four kernels' entries of the ``kernels`` line."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "tests", "trs_oracle.json")) as fh:
        oracle = json.load(fh)
    t0 = time.perf_counter()
    main = tr_main_path()
    main_s = time.perf_counter() - t0
    seconds = dict(main_path=main_s)
    t = time.perf_counter()
    headline = tr_headline_rows(main, oracle)
    seconds["headline"] = time.perf_counter() - t
    t = time.perf_counter()
    entries = secular_entries(main, secular_checks(main)) + tridiag_entries(main)
    seconds["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    sparse = tr_sparse_rows(main)
    seconds["sparse_checks"] = time.perf_counter() - t
    t = time.perf_counter()
    krylov = tr_krylov_rows(main)
    seconds["krylov_cpu_checks"] = time.perf_counter() - t
    seconds["total"] = time.perf_counter() - t0
    emit("tr", headline=headline, sparse=sparse, krylov=krylov, counts=main["counts"],
         kernels={e["name"]: dict(launches=e["launches"], ms=e["ms"], device_ms=e["device_ms"],
                                  plain_ms=e["plain_ms"], bound_ms=e["bound_ms"])
                  for e in entries}, seconds=seconds)
    return entries


# ---------------------------------------------------------------------------
# nlp: TRU / TRB / ARC / NLS, CHECK / FDH and DQP by TRB on the card
# ---------------------------------------------------------------------------

NLP_B, NLP_N = 256, 64            # (a): the headline batch's n; B cut from 1,024 (PERF.md §4)
# (a): the problems run again on the host (each is independent), spread over the batch with
# both ends in it, so its last slots are held too
NLP_CPU_ROWS = np.linspace(0, NLP_B - 1, 64).round().astype(np.int64)
NLP_CPU_WORKERS, NLP_CPU_THREADS = 4, 2       # the CPU runs that hold the card's
NLP_CPU_LONGEST = ("tru_newton_gltr", "arc_glrt", "trb_hvp", "tru_bfgs_m10", "dqp_trb_n256")
NLP_WIDE_N = 99_856               # (b), (c): the flagship's width (k = 316)
NLP_TOL = 1e-8                    # x against the port's CPU run, relative
# (c) at k = 316: the default stop, ||g|| <= max(1e-6, 1e-8 ||g_0||) = 9.9e-6 there, leaves
# f = 4.5e-10 (PERF.md §6); ||g|| <= 1e-8 reaches f <= 1e-10 (13 iterations)
NLP_SPARSE_STOP = dict(stop_g_absolute=1e-8, stop_g_relative=0.0)
NLP_KERNELS = dict(trs_secular_newton="trs", rqs_secular_newton="rqs", partial_ldlt="partial_ldlt",
                   ldlt_wide="ldlt_wide", extend_add="extend_add", sweep_fwd="sweep_fwd",
                   sweep_bwd="sweep_bwd")
NLP_PLAIN = ("trs_plain", "rqs_plain") + FLAGSHIP_PLAIN


def nlp_counts() -> dict:
    out = tr_counts()
    out.update(launch_counts())
    return out


def nlp_x_err(got, ref) -> float:
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def nlp_held(what, st, ref, x_tol=NLP_TOL):
    """The card's state against the CPU's: status and iter (per problem)
    equal, x within ``x_tol`` relative.  A batch on the card is held on the
    problems the CPU ran (NLP_CPU_ROWS)."""
    if st.x.dim() > 1:
        rows = torch.as_tensor(NLP_CPU_ROWS, device=st.x.device)
        st = dataclasses.replace(st, **{f: getattr(st, f)[rows] for f in ("x", "status", "iter")})
    check(torch.equal(st.status.cpu(), ref.status.cpu()), f"nlp, {what}: status differs "
          f"from the CPU run")
    check(torch.equal(st.iter.cpu(), ref.iter.cpu()), f"nlp, {what}: iterations "
          f"{st.iter.cpu().tolist() if st.iter.dim() == 0 else 'per problem'} differ from the "
          f"CPU run's")
    err = nlp_x_err(st.x, ref.x)
    check(err <= x_tol and bool(torch.isfinite(st.x).all()), f"nlp, {what}: x off the CPU run "
          f"by {err:.3e}")
    return err


def nlp_batch_calls(device, rows=None):
    """(a): TRU (exact TRS) and ARC (RQS) on NLP_B extended-Rosenbrock
    problems of n = 64 from the first rows of default_rng(0).normal(size=(1024,
    64)), or on those of them at ``rows``."""
    from galahad_tpu_torch import nlp

    X = nlp_problems.random_starts(NLP_B, NLP_N, 0)
    X = torch.as_tensor(X if rows is None else X[rows], device=device)
    f = nlp_problems.ext_rosenbrock
    return dict(tru_newton_direct=lambda: nlp.tru_solve(f, X),
                arc_direct=lambda: nlp.arc_solve(f, X))


def nlp_wide_calls(device):
    """(b): the matrix-free models at n = 99,856 from the standard start."""
    from galahad_tpu_torch import nlp

    x0 = torch.as_tensor(nlp_problems.standard_start(NLP_WIDE_N), device=device)
    f = nlp_problems.ext_rosenbrock
    return dict(
        tru_newton_gltr=lambda: nlp.tru_solve(f, x0, nlp.TRUControl(subproblem_direct=False)),
        tru_bfgs_m10=lambda: nlp.tru_solve(f, x0, nlp.TRUControl(model="bfgs", lms_memory=10)),
        arc_glrt=lambda: nlp.arc_solve(f, x0, nlp.ARCControl(subproblem_direct=False)),
        trb_hvp=lambda: nlp.trb_solve(f, x0, torch.full_like(x0, -2.0), torch.full_like(x0, 0.9),
                                      nlp.TRBControl(model="hvp")))


def nlp_sparse_call(k, device, stop=None):
    """(c): nls_solve_sparse on tools/nlp_problems.py::grid_residual_arrays(k)
    from x = 1, maxit 40 (test_nls_sparse_gauss_newton_large's problem), with
    NLSControl's stop fields ``stop`` (None: the defaults)."""
    from galahad_tpu_torch import COOPattern
    from galahad_tpu_torch.nlp import NLSControl, nls_solve_sparse

    n, m, u, v, a, rows, cols = nlp_problems.grid_residual_arrays(k)
    tu, tv, ta = (torch.as_tensor(w, device=device) for w in (u, v, a))
    pat = COOPattern(rows, cols, m, n)
    x0 = torch.full((n,), 1.0, dtype=torch.float64, device=device)
    return pat, lambda: nls_solve_sparse(
        lambda x: x[tu] + x[tv] ** 2 - ta,
        lambda x: torch.stack([torch.ones_like(x[tv]), 2.0 * x[tv]]).T.reshape(-1),
        pat, x0, NLSControl(maxit=40, **(stop or {})))


def nlp_dqp_arrays(n, m, seed):
    """A strictly convex QP whose dual TRB solves in few iterations: H = I +
    B B'/n (condition ~5), m random rows around a feasible point, 0 <= x <= 1."""
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    A = r.normal(size=(m, n))
    c_at = A @ r.uniform(0.2, 0.8, size=n)
    return dict(H=np.eye(n) + B @ B.T / n, g=r.normal(size=n), A=A,
                c_l=c_at - r.uniform(0.5, 1.0, m), c_u=c_at + r.uniform(0.5, 1.0, m),
                x_l=np.zeros(n), x_u=np.ones(n))


def nlp_menu_calls(device):
    """(d): the NLS menu (8 models on the Rosenbrock residuals, 4 norms on the
    exponential fit, 4 weight updates), CHECK / FDH and DQP by TRB
    (``exact_arc=False``) on random_convex_qp(12, 6, 77) and at n = 256, at
    the JAX tests' sizes."""
    from galahad_tpu_torch import nlp
    from galahad_tpu_torch.qp.dqp import DQPControl, dqp_solve

    t_fit = torch.linspace(0, 1, 20, dtype=torch.float64, device=device)
    y_fit = 2.0 * torch.exp(-1.5 * t_fit)

    def rosen(x):
        return torch.cat([10.0 * (x[1:] - x[:-1] ** 2), 1.0 - x[:-1]])

    def expfit(x):
        return x[0] * torch.exp(x[1] * t_fit) - y_fit

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    calls = {}
    for model in ("first_order", "diagonal", "gauss_newton", "newton", "gauss_to_newton",
                  "tensor_gauss_newton", "tensor_newton", "tensor_gauss_to_newton"):
        first = model in ("first_order", "diagonal")
        x0 = vec(np.full(3 if first else 4, -0.5 if first else -1.2))
        ctl = nlp.NLSControl(model=model, maxit=50 if first else 200)
        calls["nls_" + model] = lambda x0=x0, ctl=ctl: nlp.nls_solve(rosen, x0, ctl)
    for norm in ("diagonal_jtj", "diagonal_hessian", "band"):
        calls["nls_norm_" + norm] = lambda norm=norm: nlp.nls_solve(
            expfit, vec([1.0, 0.0]), nlp.NLSControl(norm=norm, maxit=200))
    for wu in ("basic", "zero_reset", "imitate_tr", "increase"):
        calls["nls_weight_" + wu] = lambda wu=wu: nlp.nls_solve(
            expfit, vec([1.0, 0.0]), nlp.NLSControl(weight_update=wu, maxit=200))
    fdh_pat = nlp.fdh_analyse(8, np.r_[np.arange(8), np.arange(1, 8)],
                              np.r_[np.arange(8), np.arange(7)])
    fq = lambda x: (x ** 2).sum() + (x[1:] * x[:-1]).sum() + (x ** 3).sum()  # noqa: E731
    calls["check"] = lambda: nlp.check_derivatives(
        lambda x: (x ** 3).sum() + x[0] * x[1], vec([1.0, 2.0, 0.5]))
    calls["fdh"] = lambda: nlp.fdh_estimate(fdh_pat, torch.func.grad(fq),
                                            vec(np.random.default_rng(0).normal(size=8)), h=1e-5)
    for name, arrays in (("dqp_trb_12x6", convex_qp_arrays(12, 6, 77)),
                         ("dqp_trb_n256", nlp_dqp_arrays(256, 16, 0))):
        q = make_qp(h_kind="dense", device=device, **arrays)
        calls[name] = lambda q=q: dqp_solve(q, ctl=DQPControl(exact_arc=False))
    return calls


def eigh_sync_probe(shape) -> dict:
    """Whether ``torch.linalg.eigh`` of a symmetric batch of ``shape`` waits for
    the card: a spin kernel of ~50 ms is queued first; a call that returns to
    the host well before it ends does not synchronise."""
    A = torch.randn(shape, dtype=torch.float64, device="cuda")
    A = A + A.mT
    torch.linalg.eigh(A)
    torch.cuda.synchronize()
    spin_ms = 50.0
    torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
    t0 = time.perf_counter()
    torch.linalg.eigh(A)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return dict(shape=list(shape), host_ms=host_ms, spin_ms=spin_ms,
                synchronises=host_ms >= 0.8 * spin_ms)


@contextlib.contextmanager
def timed_calls(module, name: str, sink: list):
    """Within the block, each call of ``module.name`` appends its seconds to
    ``sink`` (a caller that looks the function up at call time sees it)."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sink.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def nlp_main_path():
    """The ``nlp`` phase's main path on the card, as a user calls it, with the
    secular and flagship kernels' counters set to 0 before and read after:
    (a), (b), (c) at k = 316 twice and at k = 100, and (d)."""
    from galahad_tpu_torch.linalg import bsc

    torch.cuda.synchronize()
    reset_tr_counts()
    reset_flagship_counts()
    runs, per_run = {}, {}
    for name, fn in {**nlp_batch_calls("cuda"), **nlp_wide_calls("cuda")}.items():
        before = nlp_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs[name] = synced_s(fn)
        after = nlp_counts()
        # the solve's own peak: above what earlier phases still hold
        per_run[name] = dict({k: after[k] - before[k] for k in ("trs", "rqs")},
                             peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    _, fn = nlp_sparse_call(K_FLAGSHIP, "cuda", stop=NLP_SPARSE_STOP)
    sparse, setup_s = [], []
    before = nlp_counts()
    for _ in range(2):
        setup = dict(analyse=[], plan_upload=[])
        with timed_calls(bsc, "bsc_analyse", setup["analyse"]), \
                timed_calls(supernodal_flat, "flat_analyse", setup["analyse"]), \
                timed_calls(supernodal_flat, "_device_plan_build", setup["plan_upload"]):
            sparse.append(synced_s(fn))
        setup_s.append({k: sum(v) for k, v in setup.items()})
    after = nlp_counts()
    sparse_launches = {k: after[k] - before[k] for k in KERNEL_COUNTS + FLAGSHIP_PLAIN}
    _, fn100 = nlp_sparse_call(100, "cuda")
    sparse100 = synced_s(fn100)
    menu = {}
    for name, fn in nlp_menu_calls("cuda").items():
        menu[name] = synced_s(fn)
    counts = nlp_counts()
    return dict(runs=runs, per_run=per_run, sparse=sparse, sparse_launches=sparse_launches,
                setup_s=setup_s, sparse100=sparse100, menu=menu, counts=counts)


def nlp_state_row(name, st, wall, launches, ref, ref_s, maxit=100):
    """One solve's row, held to the CPU run ``ref``: status, iterations, f,
    the outer loop's host reads (one before each pass: the slowest problem's
    iterations + 1, or ``maxit`` at the cap) and the Krylov solvers' apart,
    passes of the outer loop (its subproblem solves, one secular launch each;
    checked equal to the slowest problem's iterations), seconds on the card
    and on the host."""
    it = st.iter.cpu()
    it_max = int(it.max())
    row = dict(status=int(st.status.min()), iter_max=it_max, iter_min=int(it.min()),
               f_max=float(st.f.max()), norm_g_max=float(st.norm_g.max()),
               host_reads=st.host_reads, host_reads_expected=min(it_max + 1, maxit),
               krylov_reads=st.krylov_reads, passes=launches, wall_s=wall,
               s_per_outer_iteration=wall / max(launches, 1), cpu_wall_s=ref_s,
               x_rel_cpu=nlp_held(name, st, ref))
    check(st.host_reads == row["host_reads_expected"] and launches == it_max,
          f"nlp, {name}: {st.host_reads} host reads and {launches} passes for {it_max} "
          f"iterations")
    return row


def nlp_cpu_calls():
    return {**nlp_batch_calls("cpu", NLP_CPU_ROWS), **nlp_wide_calls("cpu"),
            **nlp_menu_calls("cpu")}


def nlp_worker_init():
    """A CPU-check worker: two torch threads (the solvers at n = 99,856 are
    bound by their dispatch, not by threads)."""
    torch.set_num_threads(NLP_CPU_THREADS)


def pool_calls() -> dict:
    """Every call that the CPU pool runs, by name: the ``nlp`` and
    ``constrained`` phases' CPU runs, and the plain banded factor and solve of
    BANDED_HOST_PLAIN's starting-point block sets."""
    return {**nlp_cpu_calls(), **con_cpu_calls(), **lin_cpu_calls(),
            **{"banded_" + k: functools.partial(banded_cpu_reference, k)
               for k in BANDED_HOST_PLAIN}, "parallel_spsolve": par_strip_reference}


def nlp_cpu_reference(name):
    """One call of the CPU pool, in a worker: (result, seconds)."""
    calls = pool_calls()
    threads = torch.get_num_threads()
    torch.set_num_threads(CON_CPU_THREADS.get(name, threads))
    try:
        return _host_s(calls[name])
    finally:
        torch.set_num_threads(threads)



class NlpCpuReferences:
    """Every call of the ``nlp`` and ``constrained`` phases run again on the
    CPU, and the plain banded factor and solve at k = 125,000, by
    NLP_CPU_WORKERS spawned processes (the longest first), started before the
    build and joined after it: the build's compilers leave seven of eight cores idle
    after their first ~13 s (banded.cu's alone takes ~45 s), and beside the
    card's host-timed runs the same checks slowed those by up to 1.9x
    (PERF.md §6).  ``join`` returns {name: (result, seconds)}; ``close`` stops
    the pool (pending calls cancelled)."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        self.t0 = time.perf_counter()
        self.pool = concurrent.futures.ProcessPoolExecutor(
            NLP_CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=nlp_worker_init)
        longest = CON_LONGEST + LIN_LONGEST + NLP_CPU_LONGEST
        names = sorted(pool_calls(),
                       key=lambda k: (longest.index(k) if k in longest else len(longest), k))
        self.futures = {name: self.pool.submit(nlp_cpu_reference, name) for name in names}

    def join(self) -> dict:
        t = time.perf_counter()
        out = {name: f.result() for name, f in self.futures.items()}
        self.seconds = dict(all=time.perf_counter() - self.t0,
                            waited_after_build=time.perf_counter() - t)
        return out

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)


def nlp_ab_rows(main, host, rows):
    """(a) and (b): each card run held to the port's CPU run of the same call
    (``nlp_state_row``); for (a) the time of one ``eigh`` of the batch's
    Hessians and its share, for (b) Lanczos steps and host reads per
    iteration.  Fills ``rows`` by name."""
    eigh_ms = None
    for name, (st, wall) in main["runs"].items():
        ref, ref_s = host[name]
        pr = main["per_run"][name]
        launches = pr["trs"] + pr["rqs"]
        row = rows[name] = nlp_state_row(name, st, wall, launches, ref, ref_s)
        row["peak_gib"] = pr["peak_gib"]
        if name in ("tru_newton_direct", "arc_direct"):
            if eigh_ms is None:
                X = torch.as_tensor(nlp_problems.random_starts(NLP_B, NLP_N, 0), device="cuda")
                H0 = torch.func.vmap(torch.func.hessian(nlp_problems.ext_rosenbrock))(X)
                eigh_ms = min(event_ms(lambda: torch.linalg.eigh(H0)) for _ in range(3))
            row.update(eigh_ms=eigh_ms, eigh_share=eigh_ms * launches / (wall * 1e3),
                       converged=int(st.converged.sum()))
        else:
            row.update(lanczos_steps_per_iteration=st.krylov_reads / max(launches, 1),
                       host_reads_per_iteration=(st.host_reads + st.krylov_reads)
                       / max(int(st.iter), 1))


def nlp_sparse_row(main, oracle) -> dict:
    """(c): the k = 316 runs (status, f, bitwise repeat, rows 1a-3 launched,
    plain 0) and the k = 100 run against the JAX package's."""
    (s1, w1), (s2, w2) = main["sparse"]
    s100, w100 = main["sparse100"]
    its, sl = int(s1.iter), main["sparse_launches"]
    setup = main["setup_s"]
    row = dict(n=NLP_WIDE_N, m=2 * 316 * 315, stop=NLP_SPARSE_STOP, status=int(s1.status),
               iter=its, f=float(s1.f), norm_g=float(s1.norm_g),
               analyse_s=[t["analyse"] for t in setup],
               plan_upload_s=[t["plan_upload"] for t in setup], wall_s=[w1, w2],
               ms_per_iteration=[(w - t["analyse"] - t["plan_upload"]) / its * 1e3
                                 for w, t in zip((w1, w2), setup)],
               host_reads=s1.host_reads, launches=sl,
               k100=dict(status=int(s100.status), iter=int(s100.iter), f=float(s100.f),
                         wall_s=w100, jax_iter=oracle["iter"], jax_f=oracle["f"]))
    check(bool(s1.converged) and float(s1.f) <= 1e-10, f"nlp, sparse: status {int(s1.status)}, "
          f"f {float(s1.f)!r}")
    check(same_bits(s1.x, s2.x) and same_bits(s1.f, s2.f), "nlp, sparse: two runs differ")
    for key in ("partial_ldlt", "ldlt_wide", "extend_add", "sweep_fwd", "sweep_bwd"):
        check(sl[key] > 0, f"nlp, sparse: no {key} launch")
    check(all(sl[k] == 0 for k in FLAGSHIP_PLAIN), f"nlp, sparse: plain code ran: {sl}")
    x100 = nlp_x_err(s100.x[oracle["x_at"]], torch.tensor(oracle["x"], dtype=torch.float64))
    x100_norm = abs(float(torch.linalg.norm(s100.x)) - oracle["x_norm"]) / oracle["x_norm"]
    row["k100"].update(x_rel_jax=x100, x_norm_rel_jax=x100_norm)
    check((int(s100.status), int(s100.iter)) == (oracle["status"], oracle["iter"])
          and abs(float(s100.f) - oracle["f"]) <= 1e-8 * oracle["f"]
          and x100 <= NLP_TOL and x100_norm <= NLP_TOL,
          f"nlp, sparse k=100: ({int(s100.status)}, {int(s100.iter)}, {float(s100.f)!r}, x off "
          f"by {x100:.3e}, its norm by {x100_norm:.3e}) against the JAX package's "
          f"({oracle['status']}, {oracle['iter']}, {oracle['f']!r})")
    return row


def nlp_menu_rows(main, host, rows):
    """(d): each card run held to the port's CPU run of the same call."""
    for name, (out, wall) in main["menu"].items():
        ref, ref_s = host[name]
        row = rows[name] = dict(wall_s=wall, cpu_wall_s=ref_s)
        if name == "check":
            row.update(ok=out.ok, max_grad_error=out.max_grad_error,
                       max_hess_error=out.max_hess_error)
            check((out.ok, out.grad_ok, out.hess_ok) == (ref.ok, ref.grad_ok, ref.hess_ok)
                  and out.ok, f"nlp, check: verdicts {out.ok} / {ref.ok}")
        elif name == "fdh":
            row.update(rel_cpu=nlp_x_err(out, ref))
            check(row["rel_cpu"] <= NLP_TOL, f"nlp, fdh: {row['rel_cpu']:.3e} off the CPU run")
        elif name.startswith("dqp"):
            row.update(status=out.status, iter=out.iter, obj=out.obj,
                       x_rel_cpu=nlp_x_err(out.x, ref.x), host_reads=out.host_reads,
                       cpu=(ref.status, ref.iter))
            check((out.status, out.iter) == (ref.status, ref.iter) and out.status == 0,
                  f"nlp, {name}: ({out.status}, {out.iter}) on the card, ({ref.status}, "
                  f"{ref.iter}) on the CPU")
            check(row["x_rel_cpu"] <= NLP_TOL, f"nlp, {name}: x off the CPU run by "
                  f"{row['x_rel_cpu']:.3e}")
        else:
            row.update(status=int(out.status), iter=int(out.iter), f=float(out.f),
                       host_reads=out.host_reads, x_rel_cpu=nlp_held(name, out, ref))


def phase_nlp(host, host_seconds):
    """TRU / TRB / ARC / NLS, CHECK / FDH and DQP by TRB on the card, held to
    their CPU runs ``host`` (``NlpCpuReferences``, which took
    ``host_seconds``): one ``nlp`` line; returns the NLP path's launches of
    the kernels of rows 6a, 6b and 1a-3 by their ``kernels`` entry's name.
    Where a check fails, what was measured so far goes to stderr."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "tests", "nlp_oracle.json")) as fh:
        oracle = json.load(fh)["nls_sparse_k100"]
    t0 = time.perf_counter()
    main = nlp_main_path()
    main_s = time.perf_counter() - t0
    counts = main["counts"]
    out = dict(a_b={}, d={}, seconds=dict(main_path=main_s, cpu_references=host_seconds),
               launches={entry: counts[key] for entry, key in NLP_KERNELS.items()},
               plain={k: counts[k] for k in NLP_PLAIN}, batch=NLP_B, n=NLP_N)
    try:
        for key in ("trs", "rqs", "partial_ldlt", "ldlt_wide", "extend_add", "sweep_fwd",
                    "sweep_bwd"):
            check(counts[key] > 0, f"nlp: the main path launched no {key} kernel")
        check(all(counts[k] == 0 for k in NLP_PLAIN), f"nlp: plain code ran on the card: "
              f"{out['plain']}")
        nlp_ab_rows(main, host, out["a_b"])
        out["sparse"] = nlp_sparse_row(main, oracle)
        nlp_menu_rows(main, host, out["d"])
    except SmokeFailure:
        print(json.dumps({"nlp_partial": out}, default=str), file=sys.stderr, flush=True)
        raise
    out["eigh_sync"] = [eigh_sync_probe((NLP_B, NLP_N, NLP_N)), eigh_sync_probe((64, 64))]
    out["seconds"]["total"] = time.perf_counter() - t0
    emit("nlp", **out)
    return out["launches"]


# ---------------------------------------------------------------------------
# constrained: LANCELOT, FILTRANE, QCQP, BGO / DGO / UGO, SIF, BQP / BLLS / EQP
# ---------------------------------------------------------------------------

CON_CHAIN_N = 400                 # (e): test_large_n_matrix_free's n
CON_WIDE_N = NLP_WIDE_N           # (e), the flagship's width
CON_QCQP_N, CON_QCQP_M = 1024, 32  # (f)
CON_BROYDEN_N = 1024              # (g)
CON_BGO_ATTEMPTS, CON_BGO_N = 1024, 8   # (h): the shape of bench_batched_trs
# (h): the starts of the 1,024 held start by start, spread with both ends
CON_BGO_ROWS = np.linspace(0, CON_BGO_ATTEMPTS - 1, 64).round().astype(np.int64)
CON_DGO_MAXIT = 1000              # (h): capacity 2,001 boxes
CON_SIF_N = 40                    # (i): EXTROSNB's N, cut from 1,000 (PERF.md §4)
CON_QP_N, CON_BLLS_M, CON_EQP_M = 1024, 2048, 256   # (j)
CON_TOL = 1e-8                    # x against the port's CPU run, relative
# calls whose iteration counts part between the card and the CPU by roundoff (ROADMAP queue
# 3): at TRB's Cauchy boundary test (held in status and x within the solver's stop) or at
# FILTRANE's singular Gauss-Newton model (the QCQP's "filter" start: x within the AL stop;
# the inequality system, whose feasible set is not a point: status and theta <= stop_c);
# the counts are reported
CON_EDGE = {"e_simple_rosenbrock": 1e-6, "f_ball_filter": 1e-5, "g_inequality": None}
CON_CPU_THREADS = {"f_qcqp_1024": 4}   # the pool's longest call: 4 threads, not 2
CON_LONGEST = ("f_qcqp_1024", "banded_lp_n1000000", "g_broyden_1024", "h_bgo_all", "j_blls",
               "j_bqp")
CON_KERNELS = dict(NLP_KERNELS, banded_factor="banded_factor", banded_solve="banded_solve",
                   tridiag_factor="tridiag_factor", tridiag_solve="tridiag_solve")
CON_PLAIN = NLP_PLAIN + ("tridiag_factor_plain", "tridiag_solve_plain", "banded_factor_plain",
                         "banded_solve_plain")


def con_problems():
    import constrained_problems  # noqa: E402  (tools/constrained_problems.py)
    import sif_problems  # noqa: E402  (tools/sif_problems.py)
    return constrained_problems, sif_problems


def con_qp_arrays():
    """(j)'s problems at n = 1,024 (tools/constrained_problems.py)."""
    CP, _ = con_problems()
    return dict(bqp=CP.bqp_arrays(CON_QP_N), blls=CP.blls_arrays(CON_BLLS_M, CON_QP_N),
                eqp=CP.eqp_arrays(CON_QP_N, CON_EQP_M))


_CON_DIR: list = []                # the temporary directory of the phase's files


def con_file(name: str, text: str) -> str:
    """``text`` written to a file of a temporary directory (read_qcqp and
    read_nlp take paths), kept for the life of the process."""
    import tempfile

    if not _CON_DIR:
        _CON_DIR.append(tempfile.TemporaryDirectory())
    path = os.path.join(_CON_DIR[0].name, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def con_calls(device):
    """Every call of the ``constrained`` phase that is held against its CPU
    run, by name, on ``device``, through the entry points a user calls."""
    from galahad_tpu_torch import go, nlp, qp
    from galahad_tpu_torch.io import qplib, sif

    CP, S = con_problems()

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    n = CON_CHAIN_N
    calls = dict(
        e_lancelot_400=lambda: nlp.lancelot_solve(
            CP.chain_objective, CP.chain_constraint(n), vec(np.full(n, 0.5)), vec([0.0]),
            vec([0.0]), ctl=nlp.LancelotControl(maxit=20)),
        e_simple_rosenbrock=lambda: nlp.lancelot_simple(
            lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2, vec(np.zeros(2)),
            maxit=200),
        e_simple_equality=lambda: nlp.lancelot_simple(
            lambda x: (x ** 2).sum(), vec(np.zeros(2)),
            constraints=lambda x: torch.stack([x[0] + x[1] - 1.0]), c_eq=1))
    ball = con_file("BALL2.qplib", CP.BALL_QCQP_FILE)
    calls["f_ball_al"] = lambda: qp.qcqp_solve(qplib.read_qcqp(ball, device=device))

    def ball_far():
        p = qplib.read_qcqp(ball, device=device)
        return qp.qcqp_solve(dataclasses.replace(p, x=vec([30.0, 30.0])),
                             qp.QCQPControl(method="filter"))

    calls["f_ball_filter"] = ball_far
    big = con_file("QCQP1024.qplib", CP.convex_qcqp_text(CON_QCQP_N, CON_QCQP_M))
    calls["f_qcqp_1024"] = lambda: qp.qcqp_solve(qplib.read_qcqp(big, device=device))
    INF = 1e19
    for name, c, x0, cl, cu in (
            ("g_system", lambda x: torch.stack([x[0] ** 2 + x[1] ** 2, x[0] - x[1] ** 2]),
             [0.5, 0.5], [1.0, 0.0], [1.0, 0.0]),
            ("g_inequality", lambda x: torch.stack([x[0] + x[1], x[0] ** 2 + x[1] ** 2]),
             [5.0, 5.0], [1.0, -INF], [INF, 4.0]),
            ("g_feasible", lambda x: x, [0.5], [0.0], [1.0]),
            ("g_broyden_1024", CP.broyden_tridiagonal(torch), np.full(CON_BROYDEN_N, -1.0),
             np.zeros(CON_BROYDEN_N), np.zeros(CON_BROYDEN_N))):
        calls[name] = lambda c=c, x0=x0, cl=cl, cu=cu: nlp.filtrane_solve(
            c, vec(x0), vec(cl), vec(cu))
    calls["h_bgo_rastrigin_2"] = lambda: go.bgo_solve(
        CP.rastrigin(torch), vec(np.full(2, -5.12)), vec(np.full(2, 5.12)),
        ctl=go.BGOControl(attempts=256))
    calls["h_dgo_hartmann6"] = lambda: go.dgo_solve(
        S.hartmann6(torch, device), vec(np.zeros(6)), vec(np.ones(6)),
        go.DGOControl(maxit=CON_DGO_MAXIT))
    calls["h_dgo_1d"] = lambda: go.dgo_solve(
        lambda v: torch.sin(v[0]) + torch.sin(10.0 * v[0] / 3.0), vec([2.7]), vec([7.5]),
        go.DGOControl(maxit=150))
    for name, f, a, b, maxit in (
            ("h_ugo_multimodal", lambda x: torch.sin(x) + torch.sin(10.0 * x / 3.0), 2.7, 7.5, 100),
            ("h_ugo_many_minima", lambda x: x ** 2 / 50.0 - torch.cos(x) + 1.0, -20.0, 20.0, 200),
            ("h_ugo_monotone", lambda x: x, -1.0, 3.0, 100)):
        calls[name] = lambda f=f, a=a, b=b, maxit=maxit: go.ugo_solve(
            f, a, b, go.UGOControl(maxit=maxit), device=device)
    for name in ("CAMEL6", "HART6", "ALLINIT"):
        path = con_file(name + ".SIF", S.TEXTS[name])

        def solve(path=path):
            p = sif.read_nlp(path, device=device)
            return nlp.trb_solve(p.objective, p.x, p.x_l, p.x_u)

        calls["i_" + name.lower()] = solve
    arrays = con_qp_arrays()
    calls["j_bqp"] = lambda: qp.bqp_solve(*map(vec, arrays["bqp"]))
    calls["j_blls"] = lambda: qp.blls_solve(*map(vec, arrays["blls"]))
    calls["j_eqp"] = lambda: qp.eqp_solve(*map(vec, arrays["eqp"]))
    return calls


def con_bgo_starts(device, rows=None):
    """(h): the 1,024 Latin-hypercube starts bgo_solve draws (seed 0, host
    generator) on Rastrigin in 8 variables over [-5.12, 5.12]^8, or those at
    ``rows``."""
    from galahad_tpu_torch import go

    lo, hi = np.full(CON_BGO_N, -5.12), np.full(CON_BGO_N, 5.12)
    S = go.lhs_sample_box(torch.Generator().manual_seed(0), CON_BGO_ATTEMPTS, lo, hi,
                          device="cpu")
    return (S if rows is None else S[rows]).to(device), lo, hi


def con_bgo_trb(device, rows=None, maxit=None):
    """(h): the batched TRB of bgo_solve from its starts (those at ``rows``;
    each start is independent), with its control or ``maxit`` passes."""
    from galahad_tpu_torch import go
    from galahad_tpu_torch.nlp import TRBControl, trb_solve

    CP, _ = con_problems()
    S, lo, hi = con_bgo_starts(device, rows)
    ctl = go.BGOControl(attempts=CON_BGO_ATTEMPTS)
    return trb_solve(CP.rastrigin(torch), S, lo, hi,
                     TRBControl(maxit=maxit or ctl.maxit_local,
                                stop_g_absolute=ctl.stop_g_absolute), device=device)


@functools.lru_cache(maxsize=1)
def con_cpu_calls():
    return {**con_calls("cpu"), "h_bgo_all": lambda: con_bgo_trb("cpu"),
            "h_bgo_rows_first": lambda: con_bgo_trb("cpu", CON_BGO_ROWS, maxit=1)}


@contextlib.contextmanager
def no_sync(what: str):
    """CUDA's sync debug mode set to error: a call that synchronises with the
    card (a host read among them) inside the block fails the phase."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as exc:
        raise SmokeFailure(f"constrained, {what}: a synchronising call: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode("default")


def con_main_path():
    """The ``constrained`` phase's main path on the card, as a user calls it,
    with the secular kernels' counters set to 0 before and read after: the
    calls of ``con_calls``, LANCELOT at n = 99,856 twice, BGO at 1,024 starts,
    DGO's box splits and UGO with no synchronising call, and EXTROSNB decoded
    and solved."""
    from galahad_tpu_torch import go, nlp
    from galahad_tpu_torch.go import dgo as dgo_module
    from galahad_tpu_torch.io import sif

    CP, S = con_problems()
    calls = con_calls("cuda")
    torch.cuda.synchronize()
    reset_tr_counts()
    start = nlp_counts()
    runs, per_run = {}, {}

    def run(name, fn):
        before = tr_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs[name] = synced_s(fn)
        after = tr_counts()
        per_run[name] = dict(trs=after["trs"] - before["trs"],
                             peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)

    for name, fn in calls.items():
        if name == "h_dgo_hartmann6":
            continue
        run(name, fn)
    # DGO twice: the second run's box splits with no synchronising call
    run("h_dgo_hartmann6", calls["h_dgo_hartmann6"])
    boxes = dgo_module.dgo_boxes

    def boxes_checked(*args, **kw):
        with no_sync("DGO's box splits"):
            return boxes(*args, **kw)

    dgo_module.dgo_boxes = boxes_checked
    try:
        run("h_dgo_hartmann6_again", calls["h_dgo_hartmann6"])
    finally:
        dgo_module.dgo_boxes = boxes
    with no_sync("UGO"):
        ugo = go.ugo_solve(lambda x: torch.sin(x) + torch.sin(10.0 * x / 3.0), 2.7, 7.5,
                           device="cuda")
    runs["h_ugo_no_sync"] = (ugo, 0.0)
    # (e) at the flagship's width, twice
    n = CON_WIDE_N
    for k in ("e_lancelot_wide", "e_lancelot_wide_again"):
        run(k, lambda: nlp.lancelot_solve(
            CP.chain_objective, CP.chain_constraint(n),
            torch.full((n,), 0.5, dtype=torch.float64, device="cuda"),
            torch.zeros(1, dtype=torch.float64, device="cuda"),
            torch.zeros(1, dtype=torch.float64, device="cuda")))
    # (h) BGO at 1,024 starts
    lo, hi = np.full(CON_BGO_N, -5.12), np.full(CON_BGO_N, 5.12)
    run("h_bgo_rastrigin_8", lambda: go.bgo_solve(
        CP.rastrigin(torch), torch.as_tensor(lo, device="cuda"),
        torch.as_tensor(hi, device="cuda"), ctl=go.BGOControl(attempts=CON_BGO_ATTEMPTS)))
    # (i) EXTROSNB: decoded, its ops per objective evaluation, solved by TRB
    text = S.extended_rosenbrock(CON_SIF_N)
    path = con_file("EXTROSNB.SIF", text)
    t0 = time.perf_counter()
    p = sif.read_nlp(path, device="cuda")
    decode_s = time.perf_counter() - t0
    ops = count_ops(lambda: p.objective(p.x))
    run("i_extrosnb", lambda: nlp.trb_solve(p.objective, p.x, p.x_l, p.x_u))
    end = nlp_counts()
    return dict(runs=runs, per_run=per_run,
                counts={k: end[k] - start[k] for k in end},
                sif=dict(n=CON_SIF_N, decode_s=decode_s, ops_per_objective=ops))


def con_x_err(got, ref) -> float:
    return nlp_x_err(got.reshape(-1), ref.reshape(-1))


def con_held(name, out, ref, fields=("status", "iter")):
    """The card's result against the CPU's: ``fields`` equal, x within
    CON_TOL relative."""
    for k in fields:
        a, b = getattr(out, k), getattr(ref, k)
        a = a.cpu() if torch.is_tensor(a) else torch.as_tensor(a)
        b = b.cpu() if torch.is_tensor(b) else torch.as_tensor(b)
        check(torch.equal(a, b), f"constrained, {name}: {k} {a.tolist()} on the card, "
              f"{b.tolist()} on the CPU")
    err = con_x_err(out.x, ref.x)
    check(err <= CON_TOL and bool(torch.isfinite(out.x).all()), f"constrained, {name}: x off "
          f"the CPU run by {err:.3e}")
    return err


def con_lancelot_wide(main) -> dict:
    """(e) at n = 99,856: two runs bitwise; converged, held by its optimality
    conditions in float64 on the host: |sum x - n/40| <= stop_c and ||grad f +
    y grad c|| <= 10 stop_g (no bounds: the projected gradient is the
    gradient)."""
    from galahad_tpu_torch.nlp import LancelotControl

    (a, wa), (b, wb) = main["runs"]["e_lancelot_wide"], main["runs"]["e_lancelot_wide_again"]
    ctl = LancelotControl()
    x = a.x.double().cpu().numpy()
    y = float(a.y[0])
    n = CON_WIDE_N
    g = 2.0 * (x - 1.0)
    g[1:] += 0.2 * x[1:] * x[:-1] ** 2
    g[:-1] += 0.2 * x[:-1] * x[1:] ** 2
    infeas = abs(float(np.sum(x)) - n / 40.0)
    grad_l = float(np.linalg.norm(g + y))
    outer = int(a.iter)
    row = dict(n=n, status=int(a.status), outer_iterations=outer, trb_iterations=a.inner_iter,
               lanczos_steps=a.krylov_reads, host_reads=a.host_reads, y=y, mu=float(a.mu),
               infeasibility=infeas, lagrangian_gradient=grad_l, wall_s=[wa, wb],
               s_per_outer_iteration=wa / max(outer, 1),
               peak_gib=main["per_run"]["e_lancelot_wide"]["peak_gib"],
               secular_launches=main["per_run"]["e_lancelot_wide"]["trs"])
    check(same_bits(a.x, b.x) and same_bits(a.y, b.y), "constrained, LANCELOT n = 99,856: two "
          "runs differ")
    check(int(a.status) == 0 and infeas <= ctl.stop_c and grad_l <= 10 * ctl.stop_g,
          f"constrained, LANCELOT n = 99,856: status {int(a.status)}, |sum x - n/40| {infeas:.3e}, "
          f"||grad L|| {grad_l:.3e}")
    return row


def con_qcqp_kkt(p, out) -> dict:
    """(f): the QCQP's KKT residuals in float64 on the host with the solver's
    sign (grad f + J'y = 0 on the variables inside their bounds, LANCELOT's
    multiplier y = (w - s) / mu >= 0 on c <= c_u): primal infeasibility, that
    stationarity, y's sign and complementarity."""
    x = out.x.double().cpu().numpy()
    y = out.y.double().cpu().numpy()
    H, g = p.H.double().cpu().numpy(), p.g.double().cpu().numpy()
    A, Q = p.A.double().cpu().numpy(), p.Qc.double().cpu().numpy()
    c = A @ x + 0.5 * np.einsum("mij,i,j->m", Q, x, x)
    J = A + np.einsum("mij,j->mi", Q, x)
    cu, xl, xu = (v.double().cpu().numpy() for v in (p.c_u, p.x_l, p.x_u))
    inside = (x > xl + 1e-8) & (x < xu - 1e-8)
    return dict(primal=float(max(0.0, np.max(c - cu), np.max(xl - x), np.max(x - xu))),
                dual=float(np.max(np.abs((H @ x + g + J.T @ y)[inside]), initial=0.0)),
                y_min=float(y.min()), complementarity=float(np.max(np.abs(y * (cu - c)))),
                active=int(np.sum(cu - c <= 1e-6)), at_bounds=int(np.sum(~inside)))


def con_rows(main, host) -> dict:
    """Every held call's row: the card's result against the CPU's, seconds on
    both; the per-kind extras (LANCELOT's counts, the QCQP's KKT, DGO's boxes
    and host reads, BGO's best point, EQP's Lanczos counts).  Every row is
    checked before the phase fails, and the failures are reported together."""
    rows, fails = {}, []
    for name, (out, wall) in main["runs"].items():
        if name not in host:
            continue
        row = rows[name] = dict(wall_s=wall, cpu_wall_s=host[name][1],
                                secular_launches=main["per_run"][name]["trs"])
        try:
            con_row(name, row, out, host[name][0])
        except SmokeFailure as exc:
            fails.append(str(exc))
    check(not fails, " | ".join(fails))
    return rows


def con_row(name, row, out, ref) -> None:
    """``con_rows``'s checks of one call, its extras into ``row``."""
    from galahad_tpu_torch.io import qplib

    if name in CON_EDGE:
        tol = CON_EDGE[name]
        row.update(status=int(out.status), iter=int(out.iter), cpu_iter=int(ref.iter),
                   x_rel_cpu=con_x_err(out.x, ref.x))
        if tol is None:
            from galahad_tpu_torch.nlp import FiltraneControl

            row.update(theta=float(out.theta), cpu_theta=float(ref.theta))
            ok = max(row["theta"], row["cpu_theta"]) <= FiltraneControl().stop_c
        else:
            ok = row["x_rel_cpu"] <= tol
        check(int(out.status) == int(ref.status) == 0 and ok,
              f"constrained, {name}: status {int(out.status)} / {int(ref.status)}, x off the "
              f"CPU run by {row['x_rel_cpu']:.3e}")
        return
    if name.startswith(("e_", "f_", "g_", "i_")) or name in ("j_bqp", "j_blls"):
        row.update(status=int(out.status), iter=int(out.iter),
                   x_rel_cpu=con_held(name, out, ref))
        check(int(out.status) == 0, f"constrained, {name}: status {int(out.status)}")
    if name.startswith(("e_", "f_")):
        row.update(trb_iterations=out.inner_iter, lanczos_steps=out.krylov_reads,
                   host_reads=out.host_reads, infeas=float(out.infeas),
                   s_per_outer_iteration=row["wall_s"] / max(int(out.iter), 1))
    if name.startswith("g_"):
        row.update(theta=float(out.theta), host_reads=out.host_reads)
    if name == "f_qcqp_1024":
        CP, _ = con_problems()
        p = qplib.read_qcqp(con_file("QCQP1024.qplib", CP.convex_qcqp_text(
            CON_QCQP_N, CON_QCQP_M)), device="cpu")
        row["kkt"] = kkt = con_qcqp_kkt(p, out)
        row["qc_bytes"] = p.Qc.numel() * p.Qc.element_size()
        check(kkt["primal"] <= 1e-6 and kkt["dual"] <= 1e-5 and kkt["y_min"] >= -1e-10
              and kkt["complementarity"] <= 1e-6, f"constrained, f_qcqp_1024: host KKT {kkt}")
    if name.startswith("h_bgo"):
        row.update(f=float(out.f), starts_converged=int(out.starts_converged),
                   cpu_starts_converged=int(ref.starts_converged),
                   x_rel_cpu=con_x_err(out.x, ref.x), host_reads=out.host_reads)
        check(row["x_rel_cpu"] <= CON_TOL and abs(float(out.f) - float(ref.f)) <= 1e-10,
              f"constrained, {name}: the best point off the CPU run's")
    if name.startswith("h_dgo"):
        row.update(boxes=int(out.boxes), f=float(out.f), host_reads=out.host_reads,
                   x_rel_cpu=con_x_err(out.x, ref.x))
        check(int(out.boxes) == int(ref.boxes) and row["x_rel_cpu"] <= 1e-10
              and abs(float(out.f) - float(ref.f)) <= 1e-10 * max(1.0, abs(float(ref.f))),
              f"constrained, {name}: boxes / f / x off the CPU run")
    if name.startswith("h_ugo"):
        row.update(x=float(out.x), f=float(out.f),
                   x_rel_cpu=abs(float(out.x) - float(ref.x)) / max(1.0, abs(float(ref.x))))
        check(row["x_rel_cpu"] <= 1e-10, f"constrained, {name}: x off the CPU run")
    if name == "j_eqp":
        row.update(iter=int(out.iter), cpu_iter=int(ref.iter),
                   x_rel_cpu=con_x_err(out.x, ref.x), y_rel_cpu=con_x_err(out.y, ref.y))
        check(row["x_rel_cpu"] <= CON_TOL and row["y_rel_cpu"] <= CON_TOL,
              "constrained, j_eqp: x / y off the CPU run")


def con_bgo_pg(x, lo, hi):
    """||P(x - g) - x|| of every row of x on Rastrigin (g = 2 x + 20 pi
    sin(2 pi x)), in float64 on the host."""
    x = x.double().cpu().numpy()
    g = 2.0 * x + 20.0 * np.pi * np.sin(2.0 * np.pi * x)
    return np.linalg.norm(np.clip(x - g, lo, hi) - x, axis=-1)


def con_arc_rounding() -> dict:
    """How the card rounds TRB's Cauchy arc point x - t g (``torch.addcmul``)
    on 4,096 triples of an arc's scale: the share of once-rounded values (a
    fused multiply-add, as the CPU's and the JAX package's) and of values with
    the product rounded first."""
    from fractions import Fraction

    r = np.random.default_rng(0)
    x, t, g = r.uniform(-5.0, 5.0, 4096), r.uniform(0.0, 1.0, 4096), 10.0 * r.normal(size=4096)
    once = np.array([float(Fraction(a) - Fraction(b) * Fraction(c)) for a, b, c in zip(x, t, g)])
    card = torch.addcmul(*(torch.as_tensor(v, device="cuda") for v in (x, t, g)),
                         value=-1.0).cpu().numpy()
    return dict(once_rounded=float((card == once).mean()),
                product_rounded_first=float((card == x - t * g).mean()))


def con_bgo_row(main, host) -> dict:
    """(h) at 1,024 starts.  The batched TRB of ``bgo_solve`` run again from
    its starts (``con_bgo_trb``; its best f that of ``bgo_solve``'s run within
    1e-12): every start in the box, and stationary, held on the host in
    float64: converged (status 0) with its projected gradient within the
    solver's stop, max(stop_g_absolute, stop_g_relative ||P(x0 - g0) - x0||),
    or at max iterations with it within 10 stop_g_absolute (the trust region
    collapsed where f's rounding hides its decrease).  The best f within 1e-10
    of the CPU run's on the same 1,024 starts.  On CON_BGO_ROWS, start by
    start against the CPU run: the first pass of every held start (status,
    iterations, x within 1e-8); at the end the starts that reach the CPU
    run's point in its iterations are counted, and the others
    (``parted_starts``: on Rastrigin's many minima a trajectory parts by
    roundoff).  Passes (one secular launch each) against the slowest start's
    iterations and the loop's host reads, s per pass and the share of one
    ``eigh`` of the batch's Hessians; how the card rounds the Cauchy arc
    (``con_arc_rounding``)."""
    from galahad_tpu_torch import go
    from galahad_tpu_torch.core.status import Status
    from galahad_tpu_torch.nlp import TRBControl

    CP, _ = con_problems()
    out, wall = main["runs"]["h_bgo_rastrigin_8"]
    st = con_bgo_trb("cuda")
    ref, ref_s = host["h_bgo_all"]
    ctl = go.BGOControl(attempts=CON_BGO_ATTEMPTS)
    X0, lo, hi = con_bgo_starts("cpu")
    f_scale = max(1.0, abs(float(ref.f.min())))
    check(abs(float(st.f.min()) - float(out.f)) <= 1e-12 * f_scale,
          f"constrained, BGO 1,024: the batched TRB's best f {float(st.f.min())!r} is not "
          f"bgo_solve's {float(out.f)!r}")
    x = st.x.cpu()
    status, iters = st.status.cpu().numpy(), st.iter.cpu().numpy()
    pg = con_bgo_pg(x, lo, hi)
    stop = np.maximum(ctl.stop_g_absolute, TRBControl().stop_g_relative * con_bgo_pg(X0, lo, hi))
    conv = status == int(Status.OK)
    at_cap = (status == int(Status.MAX_ITERATIONS)) & (iters == ctl.maxit_local)
    in_box = bool(((x >= torch.as_tensor(lo)) & (x <= torch.as_tensor(hi))).all())
    stationary = np.where(conv, pg <= stop + 1e-12, at_cap & (pg <= 10 * ctl.stop_g_absolute))
    check(in_box and bool(stationary.all()),
          f"constrained, BGO 1,024: starts {np.nonzero(~stationary)[0].tolist()[:8]} not "
          f"stationary (status {status[~stationary].tolist()[:8]}, projected gradient "
          f"{pg[~stationary].tolist()[:8]}), in the box {in_box}")
    check(abs(float(out.f) - float(ref.f.min())) <= 1e-10 * f_scale,
          f"constrained, BGO 1,024: best f {float(out.f)!r}, the CPU run's "
          f"{float(ref.f.min())!r}")
    rows = torch.as_tensor(CON_BGO_ROWS)
    sub = dataclasses.replace(st, **{f: getattr(st, f).cpu()[rows]
                                     for f in ("x", "status", "iter")})
    ref_rows = dataclasses.replace(ref, **{f: getattr(ref, f)[rows]
                                           for f in ("x", "status", "iter")})
    # a start's trajectory on a multimodal function can part from the CPU's by
    # roundoff (the norms, products and cos, CUDA's and the CPU's): every held
    # start's first pass is held; at the end the starts are counted
    first = con_bgo_trb("cuda", maxit=1)
    first = dataclasses.replace(first, **{f: getattr(first, f)[rows.to("cuda")].cpu()
                                          for f in ("x", "status", "iter")})
    first_err = con_held("h_bgo_rastrigin_8, first pass", first, host["h_bgo_rows_first"][0])
    x_err = ((sub.x - ref_rows.x).abs().max(-1).values
             / ref_rows.x.abs().max().clamp(min=1.0))
    same = (sub.iter == ref_rows.iter) & (sub.status == ref_rows.status) & (x_err <= CON_TOL)
    passes = main["per_run"]["h_bgo_rastrigin_8"]["trs"]
    it_max = int(st.iter.max())
    X = con_bgo_starts("cuda")[0]
    H0 = torch.func.vmap(torch.func.hessian(CP.rastrigin(torch)))(X)
    eigh_ms = min(event_ms(lambda: torch.linalg.eigh(H0)) for _ in range(3))
    row = dict(attempts=CON_BGO_ATTEMPTS, n=CON_BGO_N, f=float(out.f), cpu_f=float(ref.f.min()),
               starts_converged=int(out.starts_converged),
               cpu_starts_converged=int(ref.converged.sum()), at_max_iterations=int(at_cap.sum()),
               cpu_at_max_iterations=int((ref.status != int(Status.OK)).sum()),
               status_differs=int((st.status.cpu() != ref.status).sum()),
               pg_max_converged=float(pg[conv].max()),
               pg_max_at_max_iterations=float(pg[at_cap].max()) if at_cap.any() else None,
               held_starts=len(CON_BGO_ROWS), first_pass_x_rel_cpu=first_err,
               parted_starts=int((~same).sum()),
               parted_status=[int(v) for v in sub.status[~same]],
               cpu_parted_status=[int(v) for v in ref_rows.status[~same]],
               x_rel_cpu_held=float(x_err[same].max()) if bool(same.any()) else None,
               iter_max=it_max, iter_min=int(st.iter.min()), passes=passes,
               host_reads=st.host_reads, wall_s=wall, cpu_wall_s=ref_s,
               s_per_pass=wall / max(passes, 1), eigh_ms=eigh_ms,
               eigh_share=eigh_ms * passes / (wall * 1e3), cauchy_arc=con_arc_rounding())
    check(passes == it_max and st.host_reads == min(it_max + 1, ctl.maxit_local),
          f"constrained, BGO 1,024: {passes} passes and {st.host_reads} host reads for a "
          f"slowest start of {it_max} iterations")
    return row


def phase_constrained(host, host_seconds):
    """LANCELOT, FILTRANE, QCQP, BGO / DGO / UGO, SIF and BQP / BLLS / EQP on
    the card, held to their CPU runs ``host`` (joined with the ``nlp``
    phase's pool, which took ``host_seconds``): one ``constrained`` line;
    returns the path's launches of every kernel by its ``kernels`` entry's
    name.  Where a check fails, what was measured so far goes to stderr."""
    t0 = time.perf_counter()
    main = con_main_path()
    main_s = time.perf_counter() - t0
    counts = main["counts"]
    out = dict(seconds=dict(main_path=main_s, cpu_references=host_seconds),
               launches={entry: counts[key] for entry, key in CON_KERNELS.items()},
               plain={k: counts[k] for k in CON_PLAIN})
    try:
        check(counts["trs"] > 0, "constrained: the main path launched no trs_secular_newton")
        check(all(v == 0 for v in out["plain"].values()), f"constrained: plain code ran on the "
              f"card: {out['plain']}")
        out["rows"] = con_rows(main, host)
        out["lancelot_wide"] = con_lancelot_wide(main)
        out["bgo_1024"] = con_bgo_row(main, host)
        (d1, w1), (d2, w2) = main["runs"]["h_dgo_hartmann6"], main["runs"]["h_dgo_hartmann6_again"]
        check(same_bits(d1.x, d2.x) and same_bits(d1.f, d2.f), "constrained, DGO: two runs "
              "differ")
        out["dgo_hartmann6"] = dict(boxes=int(d1.boxes), f=float(d1.f), wall_s=[w1, w2],
                                    host_reads_per_solve=d1.host_reads,
                                    box_splits_under_sync_check=True,
                                    s_per_split=w1 / CON_DGO_MAXIT)
        ugo = main["runs"]["h_ugo_no_sync"][0]
        ref = host["h_ugo_multimodal"][0]
        check(abs(float(ugo.x) - float(ref.x)) <= 1e-10, "constrained, UGO under the sync check: "
              "x off the CPU run")
        st, wall = main["runs"]["i_extrosnb"]
        out["sif_extrosnb"] = dict(main["sif"], status=int(st.status), iter=int(st.iter),
                                   f=float(st.f), wall_s=wall,
                                   s_per_iteration=wall / max(int(st.iter), 1))
        check(int(st.status) == 0 and float(st.f) <= 1e-8, f"constrained, EXTROSNB: status "
              f"{int(st.status)}, f {float(st.f)!r}")
    except SmokeFailure:
        out["wall_s"] = {k: v[1] for k, v in main["runs"].items()}
        print(json.dumps({"constrained_partial": out}, default=str), file=sys.stderr, flush=True)
        raise
    out["seconds"]["total"] = time.perf_counter() - t0
    emit("constrained", **out)
    return out["launches"]


# ---------------------------------------------------------------------------
# linalg: the inline LDL^T at full size, SLS, PSLS and the services
# ---------------------------------------------------------------------------

LIN_DEVICE = "cuda"
LIN_DENSE_N = 4096                # (l) potr / sytr / eigh
LIN_PSLS_K = 64                   # (m) the 64 x 64 grid Laplacian, n = 4,096
LIN_PBTR = (125_000, 8)           # (l) pbtr: k, b (the banded LP's shape, rows 4a/4b)
LIN_PSLS_CPU_K = 32               # (m) the grid side also held to the CPU run (n = 1,024)
LIN_SCU = (4096, 64)              # (o) SCU: n, appended rows
LIN_SERVICES = (1024, 2048, 24)   # (o) ULS / MIQR / FDC: m, n, planted dependent rows
LIN_SBLS = (1024, 512)            # (o) SBLS null-space / iterative / Fredholm: n, m
LIN_TOL = 1e-10                   # residuals, and x against the port's CPU run (relative)
LIN_REFINE = 2                    # (k) refinement sweeps of the sbls-style solve
LIN_PCG_RES = 1e-5                # (o) SBLS's projected CG (tests/test_linalg2.py: 1e-6 on x)
PSLS_KINDS = ("none", "diagonal", "band", "reordered_band", "full", "full_se", "full_gmps",
              "lin_more", "mi28", "munksgaard")
LIN_KERNELS = ("partial_ldlt", "ldlt_wide", "banded_factor", "banded_solve")
LIN_LONGEST = ("lin_sls_eigh", "lin_sls_pbtr", "lin_sls_supernodal", "lin_services",
               "lin_sbls")


def lin_counts() -> dict:
    b = banded_kernels.banded_counts()
    return dict(partial_ldlt=ldlt_kernels.launch_count(),
                ldlt_wide=ldlt_kernels.wide_launch_count(),
                ldlt_wide_plain=ldlt_kernels.wide_plain_count(),
                banded_factor=b["factor"], banded_solve=b["solve"],
                banded_factor_plain=b["factor_plain"], banded_solve_plain=b["solve_plain"])


def lin_rel(got, ref) -> float:
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@functools.lru_cache(maxsize=None)
def lin_dense(n, kind, device):
    """(A, b): SPD (``spd``: B B'/n + I) or symmetric indefinite with its
    eigenvalues at least 2.5 from 0 (``indef``: a Wigner matrix of radius
    ~1.4 plus 4 diag(+-1)), seeded."""
    r = np.random.default_rng(7 if kind == "spd" else 8)
    B = r.normal(size=(n, n))
    if kind == "spd":
        A = B @ B.T / n + np.eye(n)
    else:
        A = (B + B.T) / (2.0 * np.sqrt(n)) + np.diag(4.0 * np.sign(r.normal(size=n)))
    return (torch.as_tensor(A, device=device), torch.as_tensor(r.normal(size=n), device=device))


def lin_pbtr_blocks(device):
    k, b = LIN_PBTR
    r = np.random.default_rng(9)
    G = r.uniform(-1.0, 1.0, (k, b, b))
    D = G @ G.transpose(0, 2, 1) + 3.0 * b * np.eye(b)
    L = r.uniform(-1.0, 1.0, (k - 1, b, b))
    return (torch.as_tensor(D, device=device), torch.as_tensor(L, device=device),
            torch.as_tensor(r.normal(size=(k, b)), device=device))


@functools.lru_cache(maxsize=None)
def lin_h(device):
    """The flagship's QP (k = 316) for its H (n = 99,856) and a right-hand
    side."""
    qp = flagship_qp(K_FLAGSHIP, device)
    return qp, torch.as_tensor(np.random.default_rng(10).normal(size=qp.n), device=device)


@functools.lru_cache(maxsize=None)
def lin_laplacian(k, device):
    n = k * k
    idx = np.arange(n).reshape(k, k)
    A = 4.0 * np.eye(n)
    for a, b in ((idx[:, 1:], idx[:, :-1]), (idx[1:, :], idx[:-1, :])):
        A[a.ravel(), b.ravel()] = A[b.ravel(), a.ravel()] = -1.0
    r = np.random.default_rng(11)
    return (torch.as_tensor(A, device=device), torch.as_tensor(r.normal(size=n), device=device),
            torch.as_tensor(r.normal(size=n), device=device))


def lin_sls_run(kind, device):
    """One SLS backend of (l): (x, the right-hand side, what the residual
    needs)."""
    from galahad_tpu_torch.linalg.sls import SLSControl, sls_factorize

    if kind in ("potr", "sytr", "eigh"):
        A, b = lin_dense(LIN_DENSE_N, "spd" if kind == "potr" else "indef", device)
        f = sls_factorize(A, SLSControl(solver=kind))
        return dict(x=f.solve(b), b=b, inertia=f.inertia.tolist())
    if kind == "pbtr":
        D, L, rhs = lin_pbtr_blocks(device)
        f = sls_factorize((D, L), SLSControl(solver="pbtr"))
        return dict(x=f.solve(rhs), b=rhs, ok=bool(f.ok))
    qp, b = lin_h(device)
    if kind == "supernodal":
        from galahad_tpu_torch.linalg.supernodal import supernodal_analyse

        sym = supernodal_analyse(qp.h_pat.rows, qp.h_pat.cols, qp.n)
        f = sls_factorize((sym, qp.h_vals), SLSControl(solver="supernodal"))
        return dict(x=f.solve(b), b=b)
    f = sls_factorize(lambda v: qp.Hx(v) + v, SLSControl(solver="cg"), device=device)
    return dict(x=f.solve(b), b=b, host_reads=f.host_reads)


def lin_sls_residual(kind, out) -> float:
    """max |A x - b| / max |b| of an (l) run, on the card."""
    from galahad_tpu_torch.linalg.banded import block_tridiag_matvec

    x, b = out["x"], out["b"]
    if kind in ("potr", "sytr", "eigh"):
        A, _ = lin_dense(LIN_DENSE_N, "spd" if kind == "potr" else "indef", x.device.type)
        r = A @ x - b
    elif kind == "pbtr":
        D, L, _ = lin_pbtr_blocks(x.device.type)
        r = block_tridiag_matvec(D, L, x) - b
    else:
        qp, _ = lin_h(x.device.type)
        r = qp.Hx(x) + (x if kind == "cg" else 0.0) - b
    return float(r.abs().max()) / float(b.abs().max())


def lin_psls_apply(k, kind, device):
    from galahad_tpu_torch.linalg.psls import PSLSControl, psls_build

    H, u, v = lin_laplacian(k, device)
    apply = psls_build(H, PSLSControl(preconditioner=kind))
    return dict(w=apply(v), uPv=float(u @ apply(v)), vPu=float(v @ apply(u)),
                vPv=float(v @ apply(v)))


def lin_scu_run(device):
    """SCU at n = 4,096: 64 borders appended, a solve, 4 deleted, a refresh,
    a solve; (x1, x2) of both solves."""
    from galahad_tpu_torch.linalg.cholesky import chol_factor, chol_solve
    from galahad_tpu_torch.linalg.scu import (scu_append, scu_delete, scu_refresh, scu_setup,
                                              scu_solve)

    n, cap = LIN_SCU
    A, _ = lin_dense(n, "spd", device)
    L, _ = chol_factor(A)
    a_solve = lambda b: chol_solve(L, b)     # noqa: E731
    r = np.random.default_rng(12)
    Bc = torch.as_tensor(r.normal(size=(cap, n)), device=device)
    Cr = torch.as_tensor(r.normal(size=(cap, n)), device=device)
    st = scu_setup(n, cap, device=device)
    for j in range(cap):
        st = scu_append(st, a_solve, Bc[j], Cr[j], float(n))
    b1 = torch.as_tensor(r.normal(size=n), device=device)
    b2 = torch.as_tensor(r.normal(size=cap), device=device)
    first = scu_solve(st, a_solve, b1, b2)
    for idx in (cap // 12, cap // 4, cap * 5 // 8, 0):
        st = scu_delete(st, a_solve, idx)
    st = scu_refresh(st, a_solve)
    second = scu_solve(st, a_solve, b1, b2)
    return dict(first=first, second=second, count=int(st.count))


def lin_services_matrix(device):
    m, n, dep = LIN_SERVICES
    r = np.random.default_rng(13)
    A = r.normal(size=(m, n))
    for i in range(m - dep, m):
        A[i] = A[i - (m - dep)] - 0.5 * A[i - (m - dep) + 1]
    x = r.normal(size=n)
    return torch.as_tensor(A, device=device), torch.as_tensor(A @ x, device=device)


def lin_services_run(device):
    """FDC, ULS (on the independent rows' basis) and MIQR (on A') of a
    1,024 x 2,048 matrix with 24 planted dependent rows."""
    from galahad_tpu_torch.linalg.miqr import miqr_apply, miqr_apply_transpose, miqr_form
    from galahad_tpu_torch.linalg.uls import uls_factorize, uls_solve
    from galahad_tpu_torch.pre.fdc import fdc_find_dependent

    m, _, dep = LIN_SERVICES
    A, b = lin_services_matrix(device)
    fdc = fdc_find_dependent(A, b)
    # ULS: the rank of the leading square (the planted rows make it m - dep),
    # and a refined solve on the independent rows' leading square
    rank = int(uls_factorize(A[:, :m]).rank)
    S = A[:m - dep, :m - dep]
    f = uls_factorize(S)
    rhs = b[:m - dep]
    xs = uls_solve(f, rhs, S)
    mq = miqr_form(A.T)
    y = torch.as_tensor(np.random.default_rng(14).normal(size=m), device=device)
    return dict(independent=fdc.independent.cpu(), n_dependent=int(fdc.n_dependent),
                inconsistent=bool(fdc.inconsistent), uls_rank_square=rank, uls_x=xs,
                uls_res=float((S @ xs - rhs).abs().max() / rhs.abs().max()),
                miqr_x=miqr_apply(mq, y), miqr_y=miqr_apply_transpose(mq, y),
                miqr_levels=len(mq.levels))


def lin_sbls_run(device):
    """SBLS at n = 1,024, m = 512: the null-space mode, the projected PCG
    (diag_h preconditioner) and the Fredholm alternative (A with a zero row:
    a consistent and an inconsistent right-hand side)."""
    from galahad_tpu_torch.linalg.sbls import (sbls_factorize, sbls_factorize_nullspace,
                                               sbls_fredholm_alternative, sbls_preconditioner,
                                               sbls_solve_iterative, sbls_solve_nullspace)

    n, m = LIN_SBLS
    G, _ = lin_dense(n, "spd", device)
    r = np.random.default_rng(15)
    A = torch.as_tensor(r.normal(size=(m, n)) / np.sqrt(n), device=device)
    b = torch.as_tensor(r.normal(size=n + m), device=device)
    fn = sbls_factorize_nullspace(G, A)
    x_ns, y_ns = sbls_solve_nullspace(fn, b[:n], b[n:])
    Gp, is_diag = sbls_preconditioner(G, "diag_h")
    f = sbls_factorize(Gp, A, torch.zeros(m, dtype=G.dtype, device=device), g_is_diag=is_diag,
                       delta=1e-12)
    x_it, y_it, k_it = sbls_solve_iterative(f, lambda v: G @ v, b[:n], b[n:], stop_rel=1e-12)
    A0 = A.clone()
    A0[-1] = 0.0
    K = torch.zeros((n + m, n + m), dtype=G.dtype, device=device)
    K[:n, :n], K[n:, :n], K[:n, n:] = G, A0, A0.T
    b_ok = K @ b
    ok, (x_f, y_f) = sbls_fredholm_alternative(G, A0, torch.zeros(m, dtype=G.dtype,
                                                                  device=device), b_ok[:n], b_ok[n:])
    b_bad = b_ok.clone()
    b_bad[-1] += 1.0
    bad, (v1, v2) = sbls_fredholm_alternative(G, A0, torch.zeros(m, dtype=G.dtype,
                                                                 device=device), b_bad[:n],
                                              b_bad[n:])
    kkt = lambda x, y, AA: torch.cat([G @ x + AA.T @ y, AA @ x])   # noqa: E731
    return dict(x_ns=x_ns, y_ns=y_ns, x_it=x_it, y_it=y_it, k_it=int(k_it),
                res_ns=float((kkt(x_ns, y_ns, A) - b).abs().max() / b.abs().max()),
                res_it=float((kkt(x_it, y_it, A) - b).abs().max() / b.abs().max()),
                fredholm_ok=bool(ok), fredholm_bad=bool(bad), x_f=x_f, y_f=y_f,
                res_f=float((kkt(x_f, y_f, A0) - b_ok).abs().max() / b_ok.abs().max()),
                cert=float((kkt(v1, v2, A0)).abs().max()),
                cert_b=float(v1 @ b_bad[:n] + v2 @ b_bad[n:]))


def lin_cpu_calls():
    """The (l), (m) and (o) runs again on the CPU: the CPU pool's calls."""
    calls = {f"lin_sls_{k}": functools.partial(lin_sls_run, k, "cpu")
             for k in ("potr", "sytr", "eigh", "pbtr", "supernodal", "cg")}
    calls["lin_psls_1024"] = lambda: {k: lin_psls_apply(LIN_PSLS_CPU_K, k, "cpu")
                                      for k in PSLS_KINDS}
    calls["lin_scu"] = lambda: lin_scu_run("cpu")
    calls["lin_services"] = lambda: lin_services_run("cpu")
    calls["lin_sbls"] = lambda: lin_sbls_run("cpu")
    return calls


class KeepGroups(list):
    """The ``capture`` list of ``supernodal_factorize`` keeping only the
    groups named."""

    def __init__(self, wanted):
        super().__init__()
        self.wanted = set(wanted)

    def append(self, item):
        if item[2] in self.wanted:
            super().append(item)


def lin_inline_checks(sym, fac, captured) -> list:
    """(k): the kernels' output on the captured groups against their plain
    versions on the same fronts (the contract's entries, TOL x max |plain|)."""
    from galahad_tpu_torch.linalg.supernodal import kernel_size

    rows = []
    for route, F, l in captured:
        plan = sym.levels[l]
        nb, K = F.shape[0], F.shape[1]
        ncols = torch.as_tensor(plan.ncols.astype(np.int32), device=F.device)
        if route == "small":
            ref = ldlt_kernels.partial_ldlt_plain(F, ncols)
        else:
            store = F.reshape(-1).clone()
            lvl = ldlt_kernels.build_wide_level(
                [(i * K * K, K, int(plan.ncols[i]), int(plan.nrows[i])) for i in range(nb)],
                F.device)
            ldlt_kernels.partial_ldlt_wide_plain(store, lvl)
            ref = store.view(nb, K, K)
        Fp = plan.Fpad
        mask = contract_mask(ncols, Fp)
        got = fac.levels[l][:, :Fp, :Fp]
        err = float(torch.where(mask, got - ref[:, :Fp, :Fp], 0.0).abs().max())
        scale = max(1.0, float(ref[:, :Fp, :Fp].abs().max()))
        rows.append(dict(group=l, route=route, nb=nb, Fpad=Fp, kernel_size=K,
                         err_over_tol=err / (TOL[torch.float64] * scale)))
        check(kernel_size(Fp) == K and err <= TOL[torch.float64] * scale,
              f"linalg (k): the {route} kernel on group {l} (Fpad {Fp}) is {err} off its plain "
              f"version")
    return rows


def lin_inline(flat_x) -> dict:
    """(k): the inline LDL^T on the flagship's KKT (D_x = C = 1, rho = delta =
    1e-8, Jacobi-scaled as sparse_kkt_factorize does), an sbls-style solve
    with LIN_REFINE sweeps against the unregularized K, two runs bitwise, the
    solution against the flat path's ``flat_x``."""
    from galahad_tpu_torch.linalg import supernodal as SN

    qp = flagship_qp(K_FLAGSHIP, LIN_DEVICE)
    n, m = qp.n, qp.m
    D_x = torch.ones(n, dtype=torch.float64, device=LIN_DEVICE)
    C_diag = torch.ones(m, dtype=torch.float64, device=LIN_DEVICE)
    b = lin_kkt_rhs(n + m)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = sparse_kkt_plan(qp.h_pat, qp.a_pat, n, backend="inline")
    analyse_s = time.perf_counter() - t0
    sym = plan.sym
    routes = [SN.kernel_size(p.Fpad) > ldlt_kernels.MAX_KERNEL_FRONT for p in sym.levels]
    small = [l for l, w in enumerate(routes) if not w]
    wide = [l for l, w in enumerate(routes) if w]
    pick = lambda ls: sorted({ls[0], ls[len(ls) // 2], ls[-1]} if ls else set())  # noqa: E731
    _, upload_s = synced_s(lambda: SN._device_plan(sym, qp.g.device))
    c0 = lin_counts()
    captured = KeepGroups(pick(small) + pick(wide))

    def factorize(capture=None):
        return sparse_kkt_factorize(plan, qp.h_vals, qp.a_vals, D_x, C_diag, 1e-8, 1e-8) \
            if capture is None else _inline_factorize_captured(plan, qp, D_x, C_diag, capture)

    fac1, fac1_s = synced_s(lambda: factorize(captured))
    c1 = lin_counts()
    per_factorization = {k: c1[k] - c0[k] for k in c1}

    def solve(fac):
        x = plan.solve(fac, b)
        for _ in range(LIN_REFINE):
            x = x + plan.solve(fac, b - kkt_matvec(qp, D_x, C_diag, x))
        return x

    x1, solve_s = synced_s(lambda: solve(fac1))
    fac2, fac2_s = synced_s(factorize)
    x2 = solve(fac2)
    bitwise = (all(same_bits(a, c) for a, c in zip(fac1[0].levels, fac2[0].levels))
               and same_bits(x1, x2))
    res = float((kkt_matvec(qp, D_x, C_diag, x1) - b).abs().max()) / float(b.abs().max())
    inertia = fac1[0].inertia.tolist()
    out = dict(n=n, m=m, groups=len(sym.levels), small_groups=len(small), wide_groups=len(wide),
               fpad_max=max(p.Fpad for p in sym.levels),
               store_gib=sum(f.numel() for f in fac1[0].levels) * 8 / 2 ** 30,
               analyse_s=analyse_s, plan_upload_s=upload_s, factorize_s=[fac1_s, fac2_s],
               solve_s=solve_s, refine=LIN_REFINE, rel_residual=res, inertia=inertia,
               x_rel_flat=lin_rel(x1, flat_x), bitwise=bitwise,
               launches_per_factorization=per_factorization,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(res <= LIN_TOL, f"linalg (k): relative residual {res}")
    check(inertia == [n, m, 0], f"linalg (k): inertia {inertia}, not ({n}, {m}, 0)")
    check(out["x_rel_flat"] <= LIN_TOL, f"linalg (k): x {out['x_rel_flat']} off the flat path's")
    check(bitwise, "linalg (k): two factorizations or solves differ")
    check(per_factorization["partial_ldlt"] == len(small)
          and per_factorization["ldlt_wide"] == len(wide)
          and per_factorization["ldlt_wide_plain"] == 0,
          f"linalg (k): launches {per_factorization} for {len(small)} small and {len(wide)} "
          "wide groups")
    # the kernels against their plain versions run after the path's counts are read
    out["kernel_checks"] = functools.partial(lin_inline_checks, sym, fac1[0], captured)
    return out


def lin_kkt_rhs(N):
    return torch.as_tensor(np.random.default_rng(16).normal(size=N), device=LIN_DEVICE)


def _inline_factorize_captured(plan, qp, D_x, C_diag, capture):
    """sparse_kkt_factorize's scaling, then supernodal_factorize with a
    capture list (the same call on the same values)."""
    from galahad_tpu_torch.linalg import sbls
    from galahad_tpu_torch.linalg.supernodal import supernodal_factorize

    real = sbls.supernodal_factorize
    sbls.supernodal_factorize = lambda sym, vals: supernodal_factorize(sym, vals,
                                                                       capture=capture)
    try:
        return sparse_kkt_factorize(plan, qp.h_vals, qp.a_vals, D_x, C_diag, 1e-8, 1e-8)
    finally:
        sbls.supernodal_factorize = real


def lin_flat_reference(qp, plan):
    """The flat path's solution of (k)'s system (same D_x, C, rho, delta,
    right-hand side and refinement), on the host: (k) holds the inline
    path to it."""
    n, m = qp.n, qp.m
    D_x = torch.ones(n, dtype=torch.float64, device=LIN_DEVICE)
    C_diag = torch.ones(m, dtype=torch.float64, device=LIN_DEVICE)
    b = lin_kkt_rhs(n + m)
    fac = sparse_kkt_factorize(plan, qp.h_vals, qp.a_vals, D_x, C_diag, 1e-8, 1e-8)
    x = plan.solve(fac, b)
    for _ in range(LIN_REFINE):
        x = x + plan.solve(fac, b - kkt_matvec(qp, D_x, C_diag, x))
    return x.cpu()


def lin_main_path(flat_x) -> dict:
    """The ``linalg`` phase's main path on the card, with the factor and
    banded kernels' counters set to 0 before and read after."""
    ldlt_kernels.reset_launch_count()
    banded_kernels.reset_banded_counts()
    p0 = ldlt_kernels.wide_plain_count()
    out = dict(runs={}, seconds={})
    out["inline"] = lin_inline(flat_x)
    for kind in ("potr", "sytr", "eigh", "pbtr", "supernodal", "cg"):
        out["runs"][kind], out["seconds"][kind] = synced_s(lambda: lin_sls_run(kind, LIN_DEVICE))
    out["psls"] = {}
    for k in (LIN_PSLS_K, LIN_PSLS_CPU_K):
        for kind in PSLS_KINDS:
            out["psls"][(k, kind)], out["seconds"][f"psls_{k}_{kind}"] = synced_s(
                lambda: lin_psls_apply(k, kind, LIN_DEVICE))
    out["scu"], out["seconds"]["scu"] = synced_s(lambda: lin_scu_run(LIN_DEVICE))
    out["services"], out["seconds"]["services"] = synced_s(lambda: lin_services_run(LIN_DEVICE))
    out["sbls"], out["seconds"]["sbls"] = synced_s(lambda: lin_sbls_run(LIN_DEVICE))
    counts = lin_counts()
    counts["ldlt_wide_plain"] -= p0
    out["counts"] = counts
    out["inline"]["kernel_checks"] = out["inline"]["kernel_checks"]()
    return out


def lin_rows(main, host) -> dict:
    """(l), (m), (o): each card run by its residual and against its CPU run."""
    rows = dict(sls={}, psls={})
    for kind, run in main["runs"].items():
        ref, ref_s = host[f"lin_sls_{kind}"]
        res = lin_sls_residual(kind, run)
        row = dict(rel_residual=res, x_rel_cpu=lin_rel(run["x"], ref["x"]),
                   seconds=main["seconds"][kind], cpu_s=ref_s)
        for k in ("inertia", "host_reads", "ok"):
            if k in run:
                row[k] = run[k]
        rows["sls"][kind] = row
        check(res <= LIN_TOL and row["x_rel_cpu"] <= LIN_TOL,
              f"linalg (l), sls {kind}: residual {res}, x {row['x_rel_cpu']} off the CPU run")
        if "inertia" in run:
            check(run["inertia"] == ref["inertia"], f"linalg (l), sls {kind}: inertia "
                  f"{run['inertia']} against the CPU run's {ref['inertia']}")
    check(rows["sls"]["potr"]["inertia"] == [LIN_DENSE_N, 0, 0], "linalg (l): potr's inertia")
    cpu_psls, _ = host["lin_psls_1024"]
    for (k, kind), run in main["psls"].items():
        w = run["w"]
        sym_err = abs(run["uPv"] - run["vPu"]) / max(abs(run["uPv"]), 1e-300)
        row = dict(positive=run["vPv"] > 0, symmetry=sym_err,
                   seconds=main["seconds"][f"psls_{k}_{kind}"])
        check(bool(torch.isfinite(w).all()) and run["vPv"] > 0 and sym_err <= 1e-8,
              f"linalg (m), psls {kind} at n = {k * k}: v'Pv {run['vPv']}, symmetry {sym_err}")
        if k == LIN_PSLS_CPU_K:
            row["x_rel_cpu"] = lin_rel(w, cpu_psls[kind]["w"])
            check(row["x_rel_cpu"] <= LIN_TOL, f"linalg (m), psls {kind}: {row['x_rel_cpu']} "
                  "off the CPU run")
        rows["psls"][f"{kind}_n{k * k}"] = row
    scu, (scu_ref, scu_s) = main["scu"], host["lin_scu"]
    rows["scu"] = dict(count=scu["count"], seconds=main["seconds"]["scu"], cpu_s=scu_s,
                       x_rel_cpu=max(lin_rel(a, c) for a, c in zip(
                           scu["first"] + scu["second"], scu_ref["first"] + scu_ref["second"])))
    check(rows["scu"]["x_rel_cpu"] <= LIN_TOL and scu["count"] == LIN_SCU[1] - 4,
          f"linalg (o), scu: {rows['scu']}")
    sv, (sv_ref, sv_s) = main["services"], host["lin_services"]
    rows["services"] = dict(
        n_dependent=sv["n_dependent"], inconsistent=sv["inconsistent"],
        uls_rank_square=sv["uls_rank_square"], uls_rel_residual=sv["uls_res"],
        uls_x_rel_cpu=lin_rel(sv["uls_x"], sv_ref["uls_x"]), miqr_levels=sv["miqr_levels"],
        miqr_rel_cpu=max(lin_rel(sv["miqr_x"], sv_ref["miqr_x"]),
                         lin_rel(sv["miqr_y"], sv_ref["miqr_y"])),
        seconds=main["seconds"]["services"], cpu_s=sv_s)
    m_dep = LIN_SERVICES[2]
    check(sv["n_dependent"] == m_dep and torch.equal(sv["independent"], sv_ref["independent"])
          and not sv["inconsistent"]
          and sv["uls_rank_square"] == sv_ref["uls_rank_square"] == LIN_SERVICES[0] - m_dep,
          f"linalg (o): FDC's dependent set or ULS's rank off: {rows['services']}")
    check(sv["uls_res"] <= LIN_TOL and rows["services"]["uls_x_rel_cpu"] <= LIN_TOL
          and rows["services"]["miqr_rel_cpu"] <= LIN_TOL,
          f"linalg (o): ULS / MIQR off: {rows['services']}")
    sb, (sb_ref, sb_s) = main["sbls"], host["lin_sbls"]
    rows["sbls"] = dict(
        nullspace_rel_residual=sb["res_ns"], iterative_rel_residual=sb["res_it"],
        iterative_iters=sb["k_it"], iterative_iters_cpu=sb_ref["k_it"],
        fredholm=[sb["fredholm_ok"], sb["fredholm_bad"]], fredholm_rel_residual=sb["res_f"],
        certificate=[sb["cert"], sb["cert_b"]],
        x_rel_cpu=max(lin_rel(sb[k], sb_ref[k]) for k in ("x_ns", "y_ns", "x_it", "y_it")),
        fredholm_rel_cpu=max(lin_rel(sb[k].abs(), sb_ref[k].abs()) for k in ("x_f", "y_f")),
        seconds=main["seconds"]["sbls"], cpu_s=sb_s)
    # the projected CG stops where its energy stagnates (sbls_solve_iterative):
    # its residual is held to LIN_PCG_RES, its count and x to the CPU run's
    check(sb["res_ns"] <= LIN_TOL and sb["res_it"] <= LIN_PCG_RES and sb["res_f"] <= 1e-8
          and sb["fredholm_ok"] and not sb["fredholm_bad"] and sb["cert"] <= 1e-8
          and abs(sb["cert_b"]) > 1e-3 and rows["sbls"]["x_rel_cpu"] <= 1e-8
          and sb["k_it"] == sb_ref["k_it"], f"linalg (o), sbls: {rows['sbls']}")
    return rows


def phase_linalg(host, flat_x):
    """The inline LDL^T, SLS, PSLS and the services on the card: one ``linalg``
    line; returns the path's launches of every kernel by its ``kernels``
    entry's name."""
    t0 = time.perf_counter()
    main = lin_main_path(flat_x)
    main_s = time.perf_counter() - t0
    counts = main["counts"]
    out = dict(inline=main["inline"], launches={k: counts[k] for k in LIN_KERNELS},
               plain={k: counts[k] for k in ("ldlt_wide_plain", "banded_factor_plain",
                                              "banded_solve_plain")},
               seconds=dict(main_path=main_s))
    try:
        check(all(counts[k] > 0 for k in LIN_KERNELS),
              f"linalg: a kernel of the path was not launched: {counts}")
        check(all(v == 0 for v in out["plain"].values()), f"linalg: plain code ran on the "
              f"card: {out['plain']}")
        out.update(lin_rows(main, host))
    except SmokeFailure:
        print(json.dumps({"linalg_partial": out}, default=str), file=sys.stderr, flush=True)
        raise
    out["seconds"]["total"] = time.perf_counter() - t0
    emit("linalg", **out)
    return out["launches"]


# ---------------------------------------------------------------------------
# qp_family: qpa / qpb / qpc / lpa / crossover through qp_solve on the card
# ---------------------------------------------------------------------------

FAMILY_LPA_WORKER_THREADS = "2"
# QPB's barrier endgame decides its Armijo and mu tests below the merit's
# rounding: on the CPU its passes part from the JAX package's on 6 of the 14 QP
# fixtures (tests/test_torch_qp_active.py: PARTS, QPB1000 here), and the card
# rounds differently again.  A QPB run is held to the oracle where its status
# and count agree, else by its stopping tolerance: status 0, -13 or -18 and the
# objective within FAMILY_QPB_OBJ; the runs that parted are listed in the line.
# QPC on QPMIXB starts QPA from the IPM's capped iterate (-18 after 200 iterations in
# both packages, 6e-3 apart): held to the oracle's -18 at QPA's cap of 500.
FAMILY_PARTS = {("QPMIXB", "qpc")}
FAMILY_QPB_OBJ = 1e-6
FAMILY_TOL = 1e-8


def family_oracle():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           "qp_family_oracle.json")) as fh:
        return json.load(fh)["fixtures"]


def family_path(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "sweep",
                        name + ".qplib")


def family_solve(name, key):
    """One fixture read onto the card and solved by ``qp_solve``: a row of
    status, iterations, objective, seconds, host reads, and x on the host."""
    from galahad_tpu_torch.io.qplib import read_qp
    from galahad_tpu_torch.qp.frontend import QPControl, qp_solve

    qp = read_qp(family_path(name))
    ctl = (QPControl(crossover=True) if key == "crossover"
           else QPControl(quadratic_programming_solver=key))
    (x, _, _, info), wall = synced_s(lambda: qp_solve(qp, ctl))
    res = info.result
    return dict(status=info.status, iter=info.iter, obj=float(qp.objective(x)), wall_s=wall,
                s_per_iteration=wall / max(info.iter, 1), solver=info.solver,
                host_reads=getattr(res, "host_reads", None),
                cro_status=info.cro.status if info.cro is not None else None,
                x=x.cpu(), device=str(x.device))


def family_lpa_worker(name):
    """The LPA fixtures, in a process of their own started before the build:
    the simplex is host work of minutes (LPB800: 2,315 pivots of three
    798 x 798 solves), the problem and the answer on the card."""
    return family_solve(name, "lpa")


class FamilyLpa:
    """``family_lpa_worker`` on every LP fixture, in one spawned process that
    uses the card, longest first; ``join`` returns {name: row}."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        oracle = family_oracle()
        names = sorted((n for n in oracle if "lpa" in oracle[n]),
                       key=lambda n: -oracle[n]["lpa"]["seconds"])
        saved = os.environ.get("OPENBLAS_NUM_THREADS")
        os.environ["OPENBLAS_NUM_THREADS"] = FAMILY_LPA_WORKER_THREADS
        try:
            self.pool = concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn"))
            self.futures = {n: self.pool.submit(family_lpa_worker, n) for n in names}
        finally:
            if saved is None:
                os.environ.pop("OPENBLAS_NUM_THREADS", None)
            else:
                os.environ["OPENBLAS_NUM_THREADS"] = saved

    def join(self) -> dict:
        return {n: f.result() for n, f in self.futures.items()}

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)


def family_held(name, key, row, ref) -> None:
    """A run against the oracle: status, iterations and objective (1e-8
    relative); a run of FAMILY_PARTS by its solver's stopping tolerance."""
    obj_rel = abs(row["obj"] - ref["obj"]) / max(1.0, abs(ref["obj"]))
    row["obj_rel_oracle"] = obj_rel
    row["oracle"] = [ref["status"], ref["iter"]]
    same = (row["status"], row["iter"]) == (ref["status"], ref["iter"])
    if key == "qpb" and not same:
        row["parts_by_rounding"] = True
        check(row["status"] in (0, -13, -18) and obj_rel <= FAMILY_QPB_OBJ,
              f"qp_family, {name} qpb: status {row['status']}, objective {obj_rel} off the "
              "oracle")
        return
    if (name, key) in FAMILY_PARTS:
        row["parts_by_rounding"] = True
        check(same, f"qp_family, {name} {key}: {row['status']} / {row['iter']}")
        return
    check((row["status"], row["iter"]) == (ref["status"], ref["iter"]) and obj_rel <= FAMILY_TOL,
          f"qp_family, {name} {key}: status {row['status']}, {row['iter']} iterations, "
          f"objective {obj_rel} off; the oracle {ref['status']}, {ref['iter']}")
    if key == "crossover":
        check(row["cro_status"] == ref["cro_status"], f"qp_family, {name}: CRO status "
              f"{row['cro_status']}, the oracle's {ref['cro_status']}")


def phase_qp_family(lpa_rows):
    """qpa / qpb / qpc on every QP fixture and crossover on every fixture,
    through ``qp_solve`` on the card, and the LPA rows the spawned process
    ran: one ``qp_family`` line."""
    t0 = time.perf_counter()
    oracle = family_oracle()
    check(len(oracle) == 20, "qp_family: the oracle does not cover the 20 sweep fixtures")
    rows = {}
    for name in sorted(oracle):
        for key in oracle[name]:
            if key == "lpa":
                row = lpa_rows[name]
                check(row["device"].startswith("cuda"), f"qp_family, {name}: lpa ran on "
                      f"{row['device']}")
            else:
                row = family_solve(name, key)
            family_held(name, key, row, oracle[name][key])
            row.pop("x")
            rows[f"{name}/{key}"] = row
    per_solver = {}
    for key in ("qpa", "qpb", "qpc", "lpa", "crossover"):
        sel = [r for k, r in rows.items() if k.endswith("/" + key)]
        its = sum(r["iter"] for r in sel)
        per_solver[key] = dict(runs=len(sel), iterations=its,
                               wall_s=sum(r["wall_s"] for r in sel),
                               s_per_iteration=sum(r["wall_s"] for r in sel) / max(its, 1),
                               host_reads=sum(r["host_reads"] or 0 for r in sel))
    emit("qp_family", headline=rows["QPB1000/qpa"] | dict(n=1000, m=500),
         per_solver=per_solver,
         parted_by_rounding=sorted(k for k, r in rows.items() if r.get("parts_by_rounding")),
         rows=rows, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# parallel: the mesh layer with its slots on the one card; capi: the C library
# ---------------------------------------------------------------------------

PAR_SLOTS = 4                      # slots of each mesh, all on cuda:0 (cards_in_mesh 1)
PAR_BATCH = (256, 128, 64)         # (p1) problems, n, m
PAR_HELD = np.linspace(0, PAR_BATCH[0] - 1, 16).round().astype(np.int64)
PAR_MODEL = (DENSE_N, DENSE_M)     # (p2) the dense line's size
PAR_ANGULAR = (64, 256, 64)        # (p3) K scenarios of n, m linking rows
PAR_STRIPS = (4, 78, K_FLAGSHIP)   # (p4) D, w, R: C = 315 grid columns, the flagship's width
PAR_KERNELS = ("partial_ldlt", "ldlt_wide", "sweep_fwd", "sweep_bwd", "extend_add")
PAR_TOL = dict(batch_x=1e-8, model=1e-12, angular=1e-10, strips_res=1e-10, strips_x=1e-8)


def par_counts() -> dict:
    c = launch_counts()
    return {k: c[k] for k in PAR_KERNELS + FLAGSHIP_PLAIN}


def par_rel(got, ref) -> float:
    got, ref = (torch.as_tensor(v).double().cpu() for v in (got, ref))
    return float((got - ref).abs().max() / max(1.0, float(ref.abs().max())))


def par_strip_reference():
    """(p4)'s monolithic solution by scipy's ``spsolve`` (the CPU pool runs it
    beside the build)."""
    from galahad_tpu_torch.parallel.supernodal_mesh import strip_grid_reference

    return strip_grid_reference(*PAR_STRIPS)["x_ref"]


def par_batch(mesh) -> dict:
    """(p1): ``batch_ipm_solve`` on PAR_BATCH's problems over the batch axis,
    16 of them held to the single ``ipm_solve_compiled`` of each."""
    from galahad_tpu_torch.parallel import batch_ipm_solve

    B, n, m = PAR_BATCH
    arrays = [convex_qp_arrays(n, m, 1000 + s) for s in range(B)]
    cols = [torch.as_tensor(np.stack([a[k] for a in arrays]), device="cuda")
            for k in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u")]
    ctl = IPMControl()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, _, _, st = batch_ipm_solve(*cols, ctl=ctl, mesh=mesh)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    status, iters = st.status.tolist(), st.iter.tolist()
    check(all(s == 0 for s in status), f"parallel (p1): statuses {sorted(set(status))}")
    per = B // PAR_SLOTS
    shards = []
    for k, run in enumerate(st.run):
        slowest = max(iters[k * per:(k + 1) * per])
        check(run.path == "graph", f"parallel (p1): shard {k} ran the {run.path} path")
        check(run.direct_steps + run.replays == slowest,
              f"parallel (p1): shard {k} made {run.direct_steps} + {run.replays} steps for a "
              f"slowest problem of {slowest} iterations")
        shards.append(dict(replays=run.replays, direct_steps=run.direct_steps,
                           slowest_iterations=slowest, escalations=run.escalations,
                           capture_s=run.capture_s))
    t0 = time.perf_counter()
    held = []
    for i in PAR_HELD.tolist():
        x, _, _, one = ipm_solve_compiled(make_qp(**arrays[i]), ctl)
        err = par_rel(xs[i], x)
        check((one.status, one.iter) == (status[i], iters[i]) and err <= PAR_TOL["batch_x"],
              f"parallel (p1), problem {i}: batched {status[i]} / {iters[i]}, single "
              f"{one.status} / {one.iter}, x {err:.3e} apart")
        held.append(dict(problem=i, iterations=one.iter, x_rel=err))
    torch.cuda.synchronize()
    return dict(problems=B, n=n, m=m, slots=PAR_SLOTS, batch_s=batch_s,
                single_s=time.perf_counter() - t0, held=len(held),
                x_rel_max=max(h["x_rel"] for h in held),
                iterations=dict(min=min(iters), max=max(iters)), shards=shards)


def par_model(mesh) -> dict:
    """(p2): ``model_sharded_step`` against ``ipm_step`` on the whole QP."""
    from galahad_tpu_torch.core.problem import classify_bounds
    from galahad_tpu_torch.parallel import model_sharded_step
    from galahad_tpu_torch.qp.ipm import TENSOR_FIELDS, ipm_init, ipm_step

    n, m = PAR_MODEL
    a = convex_qp_arrays(n, m, 2, equalities=DENSE_EQ)
    args = tuple(torch.as_tensor(a[k], device="cuda")
                 for k in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u"))
    ctl = IPMControl()
    st, sharded_s = synced_s(lambda: model_sharded_step(args, mesh, ctl))
    qp = make_qp(**dict(zip(("H", "g", "A", "c_l", "c_u", "x_l", "x_u"), args)))
    masks = classify_bounds(qp, ctl.infinity)
    whole, whole_s = synced_s(lambda: ipm_step(qp, masks, ipm_init(qp, masks, ctl), ctl))
    errs = {f: par_rel(getattr(st, f), getattr(whole, f)) for f in TENSOR_FIELDS}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= PAR_TOL["model"], f"parallel (p2): {worst} {errs[worst]:.3e} off the "
          f"unsharded step")
    check(bool(torch.isfinite(st.x).all()), "parallel (p2): x is not finite")
    return dict(n=n, m=m, slots=PAR_SLOTS, rel_max=errs[worst], worst_field=worst,
                sharded_s=sharded_s, whole_s=whole_s)


def par_angular(mesh) -> dict:
    """(p3): ``block_angular_solve`` against a dense solve of the assembled
    system."""
    from galahad_tpu_torch.parallel import block_angular_residual, block_angular_solve

    K, n, m = PAR_ANGULAR
    rng = np.random.default_rng(3)
    Bs = rng.normal(size=(K, n, n))
    G = Bs @ np.swapaxes(Bs, -1, -2) / n + 4 * np.eye(n)
    A = rng.normal(size=(K, m, n))
    b = rng.normal(size=(K, n))
    Cb = rng.normal(size=(m, m))
    G, A, b, C, d = (torch.as_tensor(v, device="cuda")
                     for v in (G, A, b, Cb @ Cb.T / m + np.eye(m), rng.normal(size=m)))
    (x, y), solve_s = synced_s(lambda: block_angular_solve(mesh, G, A, b, C, d))
    res = float(block_angular_residual(G, A, b, C, d, x, y))
    N = K * n + m
    M = torch.zeros((N, N), dtype=torch.float64, device="cuda")
    for k in range(K):
        M[k * n:(k + 1) * n, k * n:(k + 1) * n] = G[k]
        M[k * n:(k + 1) * n, K * n:] = A[k].T
        M[K * n:, k * n:(k + 1) * n] = A[k]
    M[K * n:, K * n:] = -C
    sol, dense_s = synced_s(lambda: torch.linalg.solve(M, torch.cat([b.reshape(-1), d])))
    x_err, y_err = par_rel(x.reshape(-1), sol[:K * n]), par_rel(y, sol[K * n:])
    check(res <= PAR_TOL["angular"] and max(x_err, y_err) <= PAR_TOL["angular"],
          f"parallel (p3): residual {res:.3e}, x {x_err:.3e} and y {y_err:.3e} off the dense "
          f"solve")
    return dict(K=K, n=n, m=m, N=N, residual=res, x_rel=x_err, y_rel=y_err, solve_s=solve_s,
                dense_solve_s=dense_s)


def par_strips(mesh, x_ref) -> dict:
    """(p4): ``sharded_kkt_solve`` on the strip grid at the flagship's width,
    twice (bitwise), against scipy's monolithic K and ``spsolve``; the flat
    kernels' launches as the card made them."""
    from galahad_tpu_torch.parallel.supernodal_mesh import (build_strip_grid_kkt,
                                                            sharded_kkt_residual,
                                                            sharded_kkt_solve,
                                                            strip_grid_reference)

    (plan, parts), build_s = synced_s(lambda: build_strip_grid_kkt(*PAR_STRIPS,
                                                                   reference=False))
    parts.update(strip_grid_reference(*PAR_STRIPS, solve=False))
    args = (parts["vals"], parts["B"], parts["Kss"], parts["b"], parts["bs"])
    runs, stats = [], []
    for _ in range(2):
        before = par_counts()
        stat = {}
        out, s = synced_s(lambda: sharded_kkt_solve(mesh, plan, *args, stats=stat))
        after = par_counts()
        made = {k: after[k] - before[k] - stat["launches_in_captures"].get(k, 0)
                + stat["launches_in_replays"].get(k, 0) for k in after}
        runs.append((out, s, made))
        stats.append(stat)
    (xs, xsep), solve_s, made = runs[0]
    check(torch.equal(xs, runs[1][0][0]) and torch.equal(xsep, runs[1][0][1]),
          "parallel (p4): two runs are not bitwise equal")
    res = sharded_kkt_residual(parts, xs, xsep)
    x = np.concatenate([xs.cpu().numpy().ravel(), xsep.cpu().numpy()])
    ref = np.concatenate([x_ref[I] for I in parts["interior"]] + [x_ref[parts["sep"]]])
    x_err = float(np.max(np.abs(x - ref)) / max(1.0, np.max(np.abs(ref))))
    check(res <= PAR_TOL["strips_res"] and x_err <= PAR_TOL["strips_x"],
          f"parallel (p4): residual {res:.3e}, x {x_err:.3e} off spsolve")
    return dict(D=PAR_STRIPS[0], w=PAR_STRIPS[1], R=PAR_STRIPS[2], N=parts["Kfull"].shape[0],
                nd=parts["nd"], ns=parts["ns"], supernodes=plan.ns, build_s=build_s,
                solve_s=[r[1] for r in runs], residual=res, x_rel_spsolve=x_err, bitwise=True,
                column_replays=stats[0]["replays"], launches=made)


def phase_parallel(host) -> dict:
    """The mesh layer on one card (PAR_SLOTS slots on cuda:0): one
    ``parallel`` line; returns (p4)'s launches of rows 1a-3 by kernel entry
    name."""
    from galahad_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    slots = [torch.device("cuda", 0)] * PAR_SLOTS
    out = dict(cards_in_mesh=len({str(d) for d in slots}), slots=PAR_SLOTS)
    out["p1_batch"], out["seconds_p1"] = synced_s(lambda: par_batch(make_mesh(devices=slots)))
    out["p2_model"], out["seconds_p2"] = synced_s(
        lambda: par_model(make_mesh(devices=slots, batch=1)))
    out["p3_angular"], out["seconds_p3"] = synced_s(lambda: par_angular(make_mesh(devices=slots)))
    x_ref, ref_s = host["parallel_spsolve"]
    out["p4_strips"], out["seconds_p4"] = synced_s(
        lambda: par_strips(make_mesh(devices=slots), x_ref))
    out["p4_strips"]["spsolve_cpu_s"] = ref_s
    made = out["p4_strips"]["launches"]
    out["launches"] = {k: made[k] for k in PAR_KERNELS}
    out["plain"] = {k: made[k] for k in FLAGSHIP_PLAIN}
    check(all(v > 0 for v in out["launches"].values()),
          f"parallel: a kernel of the strips' path was not launched: {out['launches']}")
    check(all(v == 0 for v in out["plain"].values()),
          f"parallel: plain code ran on the card: {out['plain']}")
    out["seconds"] = time.perf_counter() - t0
    emit("parallel", **out)
    return out["launches"]


CAPI_CQP = (1024, 512)             # the C program's cqp: n, m
CAPI_COUNTS = "galahad_tpu_torch counts "


def capi_test_programs(root) -> str:
    """tests/test_capi.py's two C programs (``C_SRC``, ``C_SRC_PKG``, read
    from the file, not imported) as the functions ``c_src`` and ``c_src_pkg``."""
    import ast

    with open(os.path.join(root, "tests", "test_capi.py")) as fh:
        tree = ast.parse(fh.read())
    src = {t.id: node.value.value for node in tree.body if isinstance(node, ast.Assign)
           for t in node.targets if isinstance(t, ast.Name) and t.id in ("C_SRC", "C_SRC_PKG")}
    return (src["C_SRC"].replace("int main(void)", "static int c_src(void)")
            + src["C_SRC_PKG"].replace("int main(void)", "static int c_src_pkg(void)"))


CAPI_MAIN = r"""
static double *load(FILE *f, long n) {
    double *v = malloc(n * sizeof(double));
    if (fread(v, sizeof(double), n, f) != (size_t)n) exit(90);
    return v;
}

static struct timespec t_last;

static void lap(const char *what) {
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    printf("t_%s %.6f\n", what,
           (now.tv_sec - t_last.tv_sec) + 1e-9 * (now.tv_nsec - t_last.tv_nsec));
    t_last = now;
}

int main(int argc, char **argv) {
    setvbuf(stdout, NULL, _IOLBF, 0);
    clock_gettime(CLOCK_MONOTONIC, &t_last);
    int rc = c_src();
    lap("c_src");
    printf("c_src %d\n", rc);
    if (rc) return 10 + rc;
    rc = c_src_pkg();
    printf("c_src_pkg %d\n", rc);
    if (rc) return 40 + rc;
    lap("c_src_pkg");

    FILE *f = fopen(argv[1], "rb");
    int32_t nm[2];
    if (fread(nm, sizeof(int32_t), 2, f) != 2) return 91;
    int n = nm[0], m = nm[1];
    double *H = load(f, (long)n * n), *g = load(f, n), *A = load(f, (long)m * n);
    double *cl = load(f, m), *cu = load(f, m), *xl = load(f, n), *xu = load(f, n);
    fclose(f);
    double *x = malloc(n * sizeof(double)), *y = malloc(m * sizeof(double));
    double *z = malloc(n * sizeof(double));
    galahad_tpu_inform inform;
    int st = galahad_tpu_cqp_solve(NULL, n, m, H, g, 0.0, A, cl, cu, xl, xu, x, y, z, &inform);
    lap("cqp");
    printf("cqp %d %d %.17g\n", st, inform.iter, inform.obj);
    FILE *o = fopen(argv[2], "w");
    for (int i = 0; i < n; ++i) fprintf(o, "%.17g\n", x[i]);
    fclose(o);
    if (st != 0) return 70;

    f = fopen(argv[3], "rb");
    int64_t hdr[2];
    if (fread(hdr, sizeof(int64_t), 2, f) != 2) return 92;
    int32_t *rows = malloc(hdr[1] * sizeof(int32_t)), *cols = malloc(hdr[1] * sizeof(int32_t));
    if (fread(rows, sizeof(int32_t), hdr[1], f) != (size_t)hdr[1]) return 93;
    if (fread(cols, sizeof(int32_t), hdr[1], f) != (size_t)hdr[1]) return 94;
    double *vals = load(f, hdr[1]), *b = load(f, hdr[0]);
    fclose(f);
    double *xs = malloc(hdr[0] * sizeof(double));
    lap("cqp_write");
    int64_t h = galahad_tpu_sls_analyse((int32_t)hdr[0], hdr[1], rows, cols, 0);
    lap("sls_analyse");
    int sf = galahad_tpu_sls_factorize(h, vals, 0.0);
    lap("sls_factorize");
    int ss = galahad_tpu_sls_solve(h, b, xs);
    lap("sls_solve");
    int32_t inertia[3] = {-1, -1, -1};
    int si = galahad_tpu_sls_inertia(h, inertia);
    printf("sls %lld %d %d %d %d %d %d\n", (long long)h, sf, ss, si, inertia[0], inertia[1],
           inertia[2]);
    o = fopen(argv[4], "w");
    for (long i = 0; i < hdr[0]; ++i) fprintf(o, "%.17g\n", xs[i]);
    fclose(o);
    galahad_tpu_sls_free(h);
    galahad_tpu_terminate();
    return (h > 0 && sf == 0 && ss == 0 && si == 0) ? 0 : 80;
}
"""


def capi_files(work):
    """The C program's inputs: the cqp's dense QP and the flagship's H with
    a right-hand side, as raw binary files; returns them and the arrays."""
    n, m = CAPI_CQP
    a = convex_qp_arrays(n, m, 4)
    qp_path = os.path.join(work, "cqp.bin")
    with open(qp_path, "wb") as fh:
        fh.write(np.array([n, m], np.int32).tobytes())
        for k in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u"):
            fh.write(np.ascontiguousarray(a[k], np.float64).tobytes())
    nh, _, (hr, hc, hv), _ = grid_qp_coo(K_FLAGSHIP)
    b = np.random.default_rng(10).normal(size=nh)
    sls_path = os.path.join(work, "sls.bin")
    with open(sls_path, "wb") as fh:
        fh.write(np.array([nh, len(hr)], np.int64).tobytes())
        fh.write(hr.astype(np.int32).tobytes() + hc.astype(np.int32).tobytes())
        fh.write(hv.astype(np.float64).tobytes() + b.tobytes())
    return qp_path, sls_path, a, (nh, hr, hc, hv, b)


class CapiProcess:
    """The ``capi`` phase's C program, run as a process on the card: the port's
    C library built, the program compiled and its inputs written, then the
    process started (before the ``parallel`` phase, beside which it runs: it
    is host work most of its time, the interpreter's start and SLS's symbolic
    analysis); :func:`phase_capi` joins it."""

    def __init__(self):
        import tempfile

        from galahad_tpu_torch import capi_impl
        from galahad_tpu_torch.interfaces.c.build import HERE, build_capi

        self.t0 = time.perf_counter()
        root = os.path.dirname(os.path.abspath(__file__))
        self.so, self.build_s = _host_s(build_capi)
        self.work = tempfile.mkdtemp(prefix="capi_")
        src = os.path.join(self.work, "smoke.c")
        with open(src, "w") as fh:
            fh.write("#include <stdlib.h>\n#include <time.h>\n" + capi_test_programs(root)
                     + CAPI_MAIN)
        exe = os.path.join(self.work, "smoke")
        cc = subprocess.run(["gcc", "-O2", "-o", exe, src, f"-I{HERE}", self.so,
                             f"-Wl,-rpath,{os.path.dirname(self.so)}"],
                            capture_output=True, text=True)
        check(cc.returncode == 0, f"capi: the C program does not compile: {cc.stderr[-2000:]}")
        qp_path, sls_path, self.a, self.sls = capi_files(self.work)
        self.x_path = os.path.join(self.work, "x.txt")
        self.xs_path = os.path.join(self.work, "xs.txt")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in sys.path if p]))
        env[capi_impl.COUNTS_VARIABLE] = "1"
        env.pop(capi_impl.DEVICE_VARIABLE, None)
        self.t_start = time.perf_counter()
        self.proc = subprocess.Popen([exe, qp_path, self.x_path, sls_path, self.xs_path],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     env=env, cwd=self.work)

    def join(self):
        """(stdout, stderr, return code, wall seconds) of the process."""
        out, err = self.proc.communicate(timeout=300)
        return out, err, self.proc.returncode, time.perf_counter() - self.t_start

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def phase_capi(capi: CapiProcess) -> dict:
    """The C program's results held: one ``capi`` line; returns the C
    process's launches of rows 1a and 1b by kernel entry name."""
    import scipy.sparse as sp

    from galahad_tpu_torch import capi_impl

    t_join = time.perf_counter()
    out, err, rc, process_s = capi.join()
    waited_s = time.perf_counter() - t_join
    check(rc == 0, f"capi: the C program exited {rc}: {out[-1500:]} {err[-2500:]}")
    lines = out.splitlines()
    counts = json.loads([ln for ln in lines if ln.startswith(CAPI_COUNTS)][-1][len(CAPI_COUNTS):])
    fields = {ln.split()[0]: ln.split()[1:] for ln in lines if not ln.startswith(CAPI_COUNTS)}
    cqp, sls = fields["cqp"], fields["sls"]
    x_c = np.loadtxt(capi.x_path)
    x_py, _, _, st = ipm_solve(make_qp(**capi.a),
                               capi_impl.cqp_control(200, 0, 2, 0, 1e-6, 1e-6, 1e-6))
    x_py = x_py.cpu().numpy()
    check((int(cqp[0]), int(cqp[1])) == (st.status, st.iter) and np.array_equal(x_c, x_py),
          f"capi: the C program's cqp ({cqp[0]}, {cqp[1]}) is not the Python call's "
          f"({st.status}, {st.iter}) bit for bit: {np.max(np.abs(x_c - x_py)):.3e} apart")
    nh, hr, hc, hv, b = capi.sls
    H = sp.coo_matrix((hv, (hr, hc)), shape=(nh, nh))
    H = (H + sp.tril(H, -1).T).tocsr()
    xs = np.loadtxt(capi.xs_path)
    res = float(np.linalg.norm(H @ xs - b) / np.linalg.norm(b))
    inertia = [int(v) for v in sls[4:7]]
    check(res <= 1e-10 and inertia == [nh, 0, 0],
          f"capi: SLS residual {res:.3e}, inertia {inertia}")
    launches = dict(partial_ldlt=counts["partial_ldlt"], ldlt_wide=counts["ldlt_wide"])
    check(all(v > 0 for v in launches.values()) and counts["ldlt_wide_plain"] == 0,
          f"capi: rows 1a / 1b in the C process: {counts}")
    out = dict(library=os.path.basename(capi.so), build_s=capi.build_s,
               process_wall_s=process_s, waited_after_parallel_s=waited_s,
               c_seconds={k[2:]: float(v[0]) for k, v in fields.items() if k.startswith("t_")},
               c_src=" ".join(["status"] + fields["status"]),
               cqp=dict(n=CAPI_CQP[0], m=CAPI_CQP[1], status=st.status, iterations=st.iter,
                        bitwise_python=True),
               sls=dict(n=nh, residual=res, inertia=inertia), launches=launches,
               plain=dict(ldlt_wide_plain=counts["ldlt_wide_plain"]),
               seconds=time.perf_counter() - capi.t0)
    emit("capi", **out)
    return launches

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    try:
        card = phase_device()
        family_lpa = FamilyLpa()
        try:
            line = main_phases(family_lpa)
        finally:
            family_lpa.close()
        print(json.dumps(line), flush=True)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    emit("done", seconds=time.perf_counter() - t_all)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phases(family_lpa) -> dict:
    """Every phase after ``device``; returns the ``kernels`` line."""
    nlp_cpu = NlpCpuReferences()
    try:
        phase_build()
        nlp_host = nlp_cpu.join()
    finally:
        nlp_cpu.close()
    phase_kernel()
    qp = flagship_qp(K_FLAGSHIP, "cuda")
    plan, D_x, C_diag, b, per_factorization = phase_kkt(qp)
    phase_repeat(qp, plan, D_x, C_diag, b)
    launches, solution = phase_flagship(qp, per_factorization)
    phase_fused(qp, solution)
    flagship_solution = tuple(v.cpu() for v in solution[:3]) + (solution[3],)
    del solution
    line = phase_kernels(qp, plan, D_x, C_diag, b, launches)
    flat_x = lin_flat_reference(qp, plan)
    del plan, D_x, C_diag, b
    phase_arcs(qp)
    del qp
    phase_dense()
    banded_launches = phase_banded()
    phase_frontend(flagship_solution)
    tr_entries = phase_tr()
    nlp_launches = phase_nlp(nlp_host, nlp_cpu.seconds)
    con_launches = phase_constrained(nlp_host, nlp_cpu.seconds)
    lin_launches = phase_linalg(nlp_host, flat_x)
    phase_qp_family(family_lpa.join())
    capi = CapiProcess()
    try:
        par_launches = phase_parallel(nlp_host)
        capi_launches = phase_capi(capi)
    finally:
        capi.close()
    timed = phase_banded_path_kernels(nlp_host)
    line["kernels"] += banded_kernel_entries(banded_launches, timed) + tr_entries
    for entry in line["kernels"]:
        if entry["name"] in nlp_launches:
            entry["launches_nlp"] = nlp_launches[entry["name"]]
        entry["launches_constrained"] = con_launches[entry["name"]]
        entry["launches_linalg"] = lin_launches.get(entry["name"], 0)
        entry["launches_parallel"] = par_launches.get(entry["name"], 0)
        entry["launches_capi"] = capi_launches.get(entry["name"], 0)
    return line


if __name__ == "__main__":
    sys.exit(main())
