#!/usr/bin/env python3
"""Build one CUDA source of the port as its wrapper builds it, and summarise
what the compiler made of each kernel: ``ptxas -v`` (registers, spills) and
the order of the loads, adds, stores, shuffles and branches in its SASS.

    python3 tools/sass_summary.py galahad_tpu_torch/csrc/extend_add.cu [--out DIR]

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit of a machine with a GPU;
no card is used).  The library is built with ``_cuda_build.NVCC_FLAGS`` into
``DIR`` (default ``galahad_tpu_torch/_build/sass``), where the full ``cuobjdump -sass``
listing is kept beside it.  Printed per kernel: the ptxas lines, counts of
global loads (``LDG``), floating adds (``FADD``/``DADD``), global stores, and
the instruction stream as runs of those classes, e.g. ``LDG*16 DADD*16``: a
batch of loads issued together shows as one run of LDG before its adds.
Last, the most frequent opcodes (``ops``): where a kernel's instruction
stream goes (integer address arithmetic against floating-point work), and
for each loop (a backward branch and the code it spans) that holds a
shuffle, a barrier, a shared-memory load, a global load or store or a call,
its static counts of the floating-point, special-function (``MUFU``),
shuffle, load, store and call instructions:
one iteration's work, the calls being slow paths of IEEE division and sqrt.

    python3 tools/sass_summary.py --listing DIR/secular.sass

summarises a listing kept by an earlier run (no build, no toolkit needed).
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from galahad_tpu_torch._build import build_dir  # noqa: E402
from galahad_tpu_torch.linalg._cuda_build import NVCC_FLAGS, find_nvcc  # noqa: E402

CLASSES = (("LDG", "LDG"), ("LDS", "LDS"), ("STS", "STS"), ("STG", "STG"),
           ("LDGSTS", "LDGSTS"), ("DADD", "ADD"), ("FADD", "ADD"), ("SHFL", "SHFL"),
           ("BRA", "BRA"), ("EXIT", "EXIT"), ("BAR", "BAR"), ("LDL", "LDL"),
           ("STL", "STL"), ("DEPBAR", "WAIT"))


def classify(op: str):
    base = op.split(".")[0]
    for name, cls in CLASSES:
        if base == name:
            return cls
    return None


def runs(seq):
    out, prev, n = [], None, 0
    for c in seq:
        if c == prev:
            n += 1
            continue
        if prev is not None:
            out.append(prev if n == 1 else f"{prev}*{n}")
        prev, n = c, 1
    if prev is not None:
        out.append(prev if n == 1 else f"{prev}*{n}")
    return out


LOOP_OPS = ("DFMA", "DMUL", "DADD", "FFMA", "FMUL", "FADD", "MUFU", "SHFL", "CALL", "BAR",
            "LDS", "STS", "LDG", "STG", "LDGSTS")


def loops(body: str):
    """(start, end, counts) of each loop of a function's SASS that holds a
    SHFL, BAR, LDS, a global load or store or a call: the code from a
    backward branch's target to the branch."""
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T] )?([A-Z][A-Z0-9_.]*)[^;]*;", body)]
    out = []
    for (addr, op), m in zip(ins, re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T] )?[A-Z][A-Z0-9_.]*([^;]*);", body)):
        target = re.search(r"0x([0-9a-f]+)", m.group(2)) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) < addr:
            start = int(target.group(1), 16)
            span = [o.split(".")[0] for a, o in ins if start <= a <= addr]
            c = collections.Counter(span)
            if c["SHFL"] or c["BAR"] or c["LDS"] or c["LDG"] or c["STG"] or c["CALL"]:
                out.append((start, addr, len(span), {k: c[k] for k in LOOP_OPS}))
    return out


def summarise(sass: str) -> None:
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    for body in funcs:
        name = body.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T] )?([A-Z][A-Z0-9_.]*)", body)
        seq = [c for c in map(classify, ops) if c]
        print(f"{name}: {len(ops)} instructions, LDG {seq.count('LDG')}, "
              f"ADD {seq.count('ADD')}, STG {seq.count('STG')}, "
              f"local {seq.count('LDL') + seq.count('STL')}")
        print("  " + " ".join(runs(seq)))
        top = collections.Counter(op.split(".")[0] for op in ops).most_common(12)
        print("  ops " + " ".join(f"{op} {n}" for op, n in top))
        for start, end, n, c in loops(body):
            print(f"  loop {start:#x}-{end:#x}: {n} instructions, "
                  + " ".join(f"{k} {v}" for k, v in c.items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", nargs="?")
    ap.add_argument("--out", default=os.path.join(build_dir(), "sass"))
    ap.add_argument("--listing", help="summarise this cuobjdump -sass listing instead")
    args = ap.parse_args()
    if args.listing:
        with open(args.listing) as fh:
            summarise(fh.read())
        return 0
    if not args.source:
        ap.error("a source, or --listing")
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.source))[0]
    so = os.path.join(args.out, f"lib{stem}.so")
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, args.source],
                         capture_output=True, text=True)
    print("nvcc", " ".join(NVCC_FLAGS), args.source, "->", res.returncode)
    for ln in (res.stdout + res.stderr).splitlines():
        if "ptxas info" in ln and ("Compiling" in ln or "registers" in ln or "spill" in ln):
            print("  " + ln.split("ptxas info    : ")[-1])
    if res.returncode:
        print(res.stderr)
        return 1
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    with open(os.path.join(args.out, f"{stem}.sass"), "w") as fh:
        fh.write(sass)
    summarise(sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
