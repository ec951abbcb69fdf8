"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers:
such a file builds in seconds).  The build happens at first use, inside
the wrapper's CUDA branch, into the port's build directory; importing
this module needs neither ``nvcc`` nor a card.  There is no fallback: a
missing compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

from .._build import build_dir, source_tag

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()     # guards the tables below; a build holds its source's own lock
_source_locks: dict = {}
_libs: dict = {}
build_info: dict = {}    # name -> dict(seconds, log, path) of this process's builds


def csrc_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc", name)


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH): the CUDA kernels are built from source at first use")


def load_cuda_library(source_name: str) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` (once per content) and load it.
    Different sources may be built at the same time from different threads."""
    with _lock:
        source_lock = _source_locks.setdefault(source_name, threading.Lock())
    with source_lock:
        lib = _libs.get(source_name)
        if lib is not None:
            return lib
        src = csrc_path(source_name)
        stem = os.path.splitext(source_name)[0]
        so = os.path.join(
            build_dir(),
            f"lib{stem}-{source_tag(src, ' '.join(NVCC_FLAGS))}.so")
        if not os.path.exists(so):
            tmp = so + f".tmp{os.getpid()}"
            t0 = time.perf_counter()
            res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source_name}:\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, so)
            build_info[source_name] = dict(
                seconds=time.perf_counter() - t0,
                log=(res.stdout + res.stderr).strip(), path=so)
        lib = ctypes.CDLL(so)
        _libs[source_name] = lib
        return lib
