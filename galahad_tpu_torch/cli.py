"""Command-line drivers of the port: solve one problem, or batch-run a list.

Counterpart of galahad_tpu/cli.py (the reference's per-package USE_<pkg>
drivers and ``gal`` run script, src/cqp/usecqp.f90:52 and bin/gal:7; the
``galtests`` batch tester, bin/galtests:1-13), with the same options and
the same text, JSON and RES.d line formats.  Input is QPLIB, read into a
dense ``QP`` and solved by ``qp.frontend.qp_solve``.  Usage:

    python -m galahad_tpu_torch solve problem.qplib [--solver cqp]
        [--spec RUNCQP.SPC] [--scale] [--presolve]
        [--solution-file out.txt] [--json] [--device cpu]
    python -m galahad_tpu_torch batch list.txt [--solver cqp] [--out RES.d]

``--device`` picks where the problem lives and the solve runs (default:
the CUDA device); ``--dtype auto`` is float64.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _build_control(args):
    from .core.config import apply_specfile, read_specfile
    from .qp.frontend import QPControl

    ctl = QPControl(quadratic_programming_solver=args.solver,
                    scale=1 if args.scale else 0,
                    presolve_problem=bool(args.presolve))
    if args.spec:
        with open(args.spec) as fh:
            spec = read_specfile(fh.read())
        ctl = apply_specfile(ctl, spec)
        ctl = dataclasses.replace(ctl, ipm=apply_specfile(ctl.ipm, spec))
    return ctl


def _solve_one(path, ctl, dtype, device):
    from .core.residuals import kkt_residuals
    from .core.status import Status
    from .io import qplib
    from .qp.frontend import qp_solve

    qp = qplib.read_qp(path, dtype=dtype, device=device)
    t0 = time.perf_counter()
    x, y, z, info = qp_solve(qp, ctl)
    wall = time.perf_counter() - t0
    rp, rd, rc = kkt_residuals(qp, x, y, z)
    status = info.status
    codes = set(int(s) for s in Status)
    return dict(
        name=qp.name or path, n=qp.n, m=qp.m,
        status=status, status_name=Status(status).name if status in codes else str(status),
        objective=float(qp.objective(x)),
        primal_infeasibility=float(rp),
        dual_infeasibility=float(rd),
        complementary_slackness=float(rc),
        iterations=info.iter,
        time=wall,
        inform=info.inform,
        x=x, y=y, z=z,
    )


def cmd_solve(args) -> int:
    ctl = _build_control(args)
    r = _solve_one(args.problem, ctl, args.torch_dtype, args.device)
    if args.json:
        print(json.dumps({k: v for k, v in r.items() if k not in ("x", "y", "z", "inform")}))
    else:
        print(f" problem        {r['name']}")
        print(f" n, m           {r['n']}, {r['m']}")
        print(f" solver         {args.solver}")
        print(f" status         {r['status']} ({r['status_name']})")
        print(f" objective      {r['objective']:.10e}")
        print(f" primal infeas  {r['primal_infeasibility']:.2e}")
        print(f" dual   infeas  {r['dual_infeasibility']:.2e}")
        print(f" compl. slack   {r['complementary_slackness']:.2e}")
        print(f" iterations     {r['iterations']}")
        print(f" time (s)       {r['time']:.3f}")
        inform = r["inform"]
        if inform is not None:
            # GALAHAD-style footer: phase clocks and factorization counts
            # (reference cqp.f90:2926-2933 and PKG_time_type cqp.f90:429-473)
            t = inform.time
            print(f" factorizations {inform.nfacts}   backsolves {inform.nbacts}")
            print(f" phase times    preprocess {t.preprocess:.3f}  "
                  f"analyse+compile {t.analyse:.3f}  solve {t.solve:.3f}  "
                  f"total {t.total:.3f}")
            if inform.checkpoints_iter is not None:
                marks = [f"1e-{i + 1}:{int(it_)}"
                         for i, it_ in enumerate(inform.checkpoints_iter[:8]) if int(it_) >= 0]
                if marks:
                    print(f" checkpoints    {' '.join(marks)}")
    if args.solution_file:
        with open(args.solution_file, "w") as fh:
            fh.write(f"{r['name']} status {r['status']} objective {r['objective']:.12e}\n")
            for tag in ("x", "y", "z"):
                vec = r[tag].detach().cpu().double().numpy()
                fh.write(f"{tag} {len(vec)}\n")
                for v in vec:
                    fh.write(f"  {v:.12e}\n")
    return 0 if r["status"] == 0 else 1


def batch_line(r) -> str:
    """One RES.d line (galtests convention): name n m status objective primal
    dual compl iters time."""
    return (f"{r['name']:24s} {r['n']:8d} {r['m']:8d} "
            f"{r['status']:4d} {r['objective']: .8e} "
            f"{r['primal_infeasibility']:.1e} "
            f"{r['dual_infeasibility']:.1e} "
            f"{r['complementary_slackness']:.1e} "
            f"{r['iterations']:6d} {r['time']:9.3f}")


def cmd_batch(args) -> int:
    """One result line per problem; a problem that raises gets an ERROR line
    and the batch goes on (the galtests contract: the batch survives bad
    files)."""
    ctl = _build_control(args)
    with open(args.list) as fh:
        problems = [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
    out = open(args.out, "a") if args.out else sys.stdout
    failures = 0
    try:
        for p in problems:
            try:
                r = _solve_one(p, ctl, args.torch_dtype, args.device)
                line = batch_line(r)
                failures += r["status"] != 0
            except Exception as e:  # noqa: BLE001 - the batch survives bad files
                line = f"{p:24s} ERROR {type(e).__name__}: {e}"
                failures += 1
            print(line, file=out)
            out.flush()
    finally:
        if args.out:
            out.close()
    return 1 if failures else 0


def main(argv=None) -> int:
    from .qp.frontend import SOLVERS

    ap = argparse.ArgumentParser(prog="galahad_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--solver", default="cqp", choices=list(SOLVERS))
    common.add_argument("--spec", default=None,
                        help="GALAHAD-style specfile of keyword overrides")
    common.add_argument("--scale", action="store_true")
    common.add_argument("--presolve", action="store_true")
    common.add_argument("--dtype", default="auto", choices=["auto", "float32", "float64"],
                        help="auto = float64, the port's default")
    common.add_argument("--device", default=None,
                        help="where to solve: 'cuda' (the default) or 'cpu'")

    ps = sub.add_parser("solve", parents=[common])
    ps.add_argument("problem")
    ps.add_argument("--solution-file", default=None)
    ps.add_argument("--json", action="store_true")
    ps.set_defaults(fn=cmd_solve)

    pb = sub.add_parser("batch", parents=[common])
    pb.add_argument("list", help="text file with one QPLIB path per line")
    pb.add_argument("--out", default=None, help="append results here")
    pb.set_defaults(fn=cmd_batch)

    args = ap.parse_args(argv)
    args.torch_dtype = None if args.dtype == "auto" else args.dtype
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
