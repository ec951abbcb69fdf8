"""Build-on-first-use of the port's C interface library.

``build_capi()`` compiles capi.c with ``gcc`` into
``galahad_tpu_torch/_build/libgalahad_tpu_torch_c-<hash>.so`` (the package's
build directory, ``GALAHAD_TPU_TORCH_BUILD`` to move it; nothing under the
user's home), embedding this Python: its shared libpython where it has one,
else the static one from ``sysconfig``'s ``LIBPL``.  A failed compile or link
raises with the compiler's message.
"""
from __future__ import annotations

import os
import subprocess
import sysconfig

from ..._build import build_dir, source_tag

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "capi.c")
HEADER = os.path.join(HERE, "galahad_tpu.h")


def _python_link_flags() -> list:
    """The linker flags that embed this Python in a shared library."""
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        return [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}"]
    libpl = sysconfig.get_config_var("LIBPL") or libdir
    static = os.path.join(libpl, sysconfig.get_config_var("LIBRARY") or f"libpython{ver}.a")
    extra = (sysconfig.get_config_var("LIBS") or "").split() + \
        (sysconfig.get_config_var("SYSLIBS") or "").split()
    return [static] + extra


def build_capi() -> str:
    """Compile libgalahad_tpu_torch_c.so (once per source and header);
    returns its path."""
    with open(HEADER) as fh:
        tag = source_tag(SOURCE, fh.read())
    so = os.path.join(build_dir(), f"libgalahad_tpu_torch_c-{tag}.so")
    if os.path.exists(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["gcc", "-O2", "-fPIC", "-shared", "-o", tmp, SOURCE,
           f"-I{sysconfig.get_path('include')}", f"-I{HERE}"] + _python_link_flags()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the C interface failed ({' '.join(cmd)}):\n"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so
