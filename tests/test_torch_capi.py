"""The port's C interface (galahad_tpu_torch/interfaces/c, capi_impl.py):
real C programs compiled against the port's header and linked with
libgalahad_tpu_torch_c, run with GALAHAD_TPU_TORCH_DEVICE=cpu.

tests/test_capi.py's two programs (``C_SRC``, ``C_SRC_PKG``) run unchanged
against the port: their exit codes are held, and the numbers ``C_SRC``
prints are the JAX package's ``capi_impl`` results printed the same way.
``C_FULL`` calls every entry and prints every result with ``%.17g``: each
number is held within 1e-10 (relative to max(1, |value|)) of the JAX
package's ``capi_impl`` function called in this process on ctypes buffers of
the same data.  Without a card and without the variable the entries return
a nonzero status and say why; the process does not crash.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from test_capi import C_SRC, C_SRC_PKG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDR = os.path.join(REPO, "galahad_tpu_torch", "interfaces", "c")

pytestmark = pytest.mark.skipif(
    not os.path.exists("/usr/bin/gcc") and not os.path.exists("/usr/local/bin/gcc"),
    reason="no C compiler")

C_FULL = r"""
#include <stdio.h>
#include <stdint.h>
#include "galahad_tpu.h"

static void vec(const char *name, const double *v, int n) {
    printf("%s", name);
    for (int i = 0; i < n; ++i) printf(" %.17g", v[i]);
    printf("\n");
}

static void inform6(const char *name, int st, const galahad_tpu_inform *f) {
    printf("%s %d %d %.17g %.17g %.17g %.17g\n", name, st, f->iter, f->obj,
           f->primal_infeasibility, f->dual_infeasibility, f->complementary_slackness);
}

int main(void) {
    double H[9] = {4, 1, 0, 1, 3, 1, 0, 1, 2};
    double g[3] = {-1, -2, 0.5};
    double A[6] = {1, 1, 1, 1, -1, 0};
    double cl[2] = {-1e20, -0.5}, cu[2] = {1.0, 0.5};
    double xl[3] = {0, 0, -1}, xu[3] = {1e20, 2, 1};
    double x[3], y[2], z[3];
    galahad_tpu_inform inform;

    int st = galahad_tpu_qp_solve("cqp", 3, 2, H, g, 0.25, A, cl, cu, xl, xu, x, y, z,
                                  &inform);
    inform6("qp", st, &inform); vec("qp_x", x, 3); vec("qp_y", y, 2); vec("qp_z", z, 3);

    galahad_tpu_cqp_control ctl;
    galahad_tpu_cqp_control_init(&ctl);
    ctl.arc = 1;
    ctl.series_order = 3;
    st = galahad_tpu_cqp_solve(&ctl, 3, 2, H, g, 0.25, A, cl, cu, xl, xu, x, y, z, &inform);
    inform6("cqp", st, &inform); vec("cqp_x", x, 3); vec("cqp_y", y, 2); vec("cqp_z", z, 3);

    st = galahad_tpu_qpa_solve(NULL, 3, 2, H, g, 0.25, A, cl, cu, xl, xu, x, y, z, &inform);
    inform6("qpa", st, &inform); vec("qpa_x", x, 3); vec("qpa_y", y, 2); vec("qpa_z", z, 3);

    double Ht[4] = {2, 0, 0, 4};
    double gt[2] = {-4, 0};
    double xt[2];
    galahad_tpu_trs_inform ti;
    st = galahad_tpu_trs_solve(2, Ht, gt, 1.0, xt, &ti);
    printf("trs %d %d %.17g %.17g %.17g\n", st, ti.hard_case, ti.multiplier, ti.obj, ti.norm_x);
    vec("trs_x", xt, 2);
    st = galahad_tpu_rqs_solve(2, Ht, gt, 1.0, 3.0, xt, &ti);
    printf("rqs %d %d %.17g %.17g %.17g\n", st, ti.hard_case, ti.multiplier, ti.obj, ti.norm_x);
    vec("rqs_x", xt, 2);

    int32_t rows[9] = {0, 1, 2, 3, 4, 1, 2, 3, 4};
    int32_t cols[9] = {0, 1, 2, 3, 4, 0, 1, 2, 3};
    double  vals[9] = {4, 4, 4, 4, 4, -1, -1, -1, -1};
    int64_t h = galahad_tpu_sls_analyse(5, 9, rows, cols, 0);
    int sf = galahad_tpu_sls_factorize(h, vals, 0.0);
    double b[5] = {1, 2, 3, 4, 5}, xs[5];
    int ss = galahad_tpu_sls_solve(h, b, xs);
    int32_t inertia[3];
    int si = galahad_tpu_sls_inertia(h, inertia);
    printf("sls %d %d %d %d %d %d\n", sf, ss, si, inertia[0], inertia[1], inertia[2]);
    vec("sls_x", xs, 5);
    galahad_tpu_sls_free(h);
    galahad_tpu_terminate();
    return 0;
}
"""

C_NO_CARD = r"""
#include <stdio.h>
#include <stdint.h>
#include "galahad_tpu.h"

int main(void) {
    double H[1] = {1}, g[1] = {-1}, xl[1] = {0}, xu[1] = {2}, x[1], z[1];
    galahad_tpu_inform inform;
    int st = galahad_tpu_qp_solve("cqp", 1, 0, H, g, 0.0, NULL, NULL, NULL, xl, xu, x, NULL,
                                  z, &inform);
    int32_t r[1] = {0}, c[1] = {0};
    int64_t h = galahad_tpu_sls_analyse(1, 1, r, c, 0);
    galahad_tpu_trs_inform ti;
    int tr = galahad_tpu_trs_solve(1, H, g, 1.0, x, &ti);
    printf("statuses %d %lld %d\n", st, (long long)h, tr);
    return 0;
}
"""


@pytest.fixture(scope="module")
def capi_lib():
    from galahad_tpu_torch.interfaces.c.build import build_capi

    return build_capi()


def _run_c(tmp_path, lib, src, name, device="cpu"):
    (tmp_path / f"{name}.c").write_text(src)
    exe = tmp_path / name
    subprocess.run(["gcc", "-O2", "-o", str(exe), str(tmp_path / f"{name}.c"), f"-I{HDR}", lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True, capture_output=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO] + [p for p in sys.path if p]),
               OMP_NUM_THREADS="1")          # the suite's workers share the host's cores
    env.pop("GALAHAD_TPU_TORCH_DEVICE", None)
    if device is not None:
        env["GALAHAD_TPU_TORCH_DEVICE"] = device
    return subprocess.run([str(exe)], capture_output=True, text=True, timeout=300, env=env,
                          cwd=tmp_path)


def _addr(a):
    return 0 if a is None else a.ctypes.data


class _Buffers:
    """The C program's data as numpy buffers, passed to the JAX package's
    ``capi_impl`` by address as the C shim passes them."""

    def __init__(self, n, m, H, g, A, cl, cu, xl, xu):
        f = lambda v: np.ascontiguousarray(v, np.float64)      # noqa: E731
        self.n, self.m = n, m
        self.H, self.g, self.A = f(H), f(g), f(A)
        self.cl, self.cu, self.xl, self.xu = f(cl), f(cu), f(xl), f(xu)
        self.x, self.y, self.z = np.zeros(n), np.zeros(max(m, 1)), np.zeros(n)

    def args(self):
        return (_addr(self.H), _addr(self.g)), (_addr(self.A), _addr(self.cl), _addr(self.cu),
                                                _addr(self.xl), _addr(self.xu), _addr(self.x),
                                                _addr(self.y), _addr(self.z))


def _parse(stdout):
    out = {}
    for line in stdout.splitlines():
        head, *rest = line.split()
        out[head] = [float(v) for v in rest]
    return out


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.all(err <= 1e-10), (what, got, want)


def test_test_capi_programs_run_against_the_port(tmp_path, capi_lib):
    """tests/test_capi.py's programs, unchanged, on the port's library: exit
    code 0, and C_SRC's printed status, iterations and objective those of the
    JAX package's qp_solve_raw printed the same way."""
    from galahad_tpu import capi_impl as jax_capi

    out = _run_c(tmp_path, capi_lib, C_SRC, "prog")
    assert out.returncode == 0, (out.stdout, out.stderr[-1500:])
    b = _Buffers(2, 1, [[1, 0], [0, 1]], [-1, -2], [[1, 1]], [-1e20], [1.0], [0, 0],
                 [1e20, 1e20])
    (H, g), rest = b.args()
    st, it, obj, *_ = jax_capi.qp_solve_raw("cqp", 2, 1, H, g, 0.0, *rest)
    assert out.stdout.splitlines()[0] == f"status {st} iter {it} obj {obj:.8f}"

    out = _run_c(tmp_path, capi_lib, C_SRC_PKG, "pkg")
    assert out.returncode == 0, (out.stdout, out.stderr[-1500:])
    assert "pkg entries ok" in out.stdout


def test_every_entry_matches_the_jax_package(tmp_path, capi_lib):
    from galahad_tpu import capi_impl as jax_capi

    out = _run_c(tmp_path, capi_lib, C_FULL, "full")
    assert out.returncode == 0, (out.stdout, out.stderr[-1500:])
    got = _parse(out.stdout)
    problem = (3, 2, [[4, 1, 0], [1, 3, 1], [0, 1, 2]], [-1, -2, 0.5], [[1, 1, 1], [1, -1, 0]],
               [-1e20, -0.5], [1.0, 0.5], [0, 0, -1], [1e20, 2, 1])

    def held(name, call):
        b = _Buffers(*problem)
        (H, g), rest = b.args()
        inform = call(H, g, rest)
        _close(got[name], inform, name)
        _close(got[name + "_x"], b.x, name + "_x")
        _close(got[name + "_y"], b.y, name + "_y")
        _close(got[name + "_z"], b.z, name + "_z")

    held("qp", lambda H, g, rest: jax_capi.qp_solve_raw("cqp", 3, 2, H, g, 0.25, *rest))
    held("cqp", lambda H, g, rest: jax_capi.cqp_solve_raw(3, 2, 200, 0, 3, 1, 1e-6, 1e-6, 1e-6,
                                                          H, g, 0.25, *rest))
    held("qpa", lambda H, g, rest: jax_capi.qpa_solve_raw(3, 2, 500, 1e-8, 1e-8, H, g, 0.25,
                                                          *rest))

    Ht = np.array([[2.0, 0], [0, 4]])
    gt = np.array([-4.0, 0])
    for name, call in (("trs", lambda xt: jax_capi.trs_solve_raw(2, Ht.ctypes.data,
                                                                 gt.ctypes.data, 1.0, xt)),
                       ("rqs", lambda xt: jax_capi.rqs_solve_raw(2, Ht.ctypes.data,
                                                                 gt.ctypes.data, 1.0, 3.0, xt))):
        xt = np.zeros(2)
        st, mult, obj, nx, hard = call(xt.ctypes.data)
        _close(got[name], [st, hard, mult, obj, nx], name)
        _close(got[name + "_x"], xt, name + "_x")

    rows = np.array([0, 1, 2, 3, 4, 1, 2, 3, 4], np.int32)
    cols = np.array([0, 1, 2, 3, 4, 0, 1, 2, 3], np.int32)
    vals = np.array([4.0] * 5 + [-1.0] * 4)
    rhs = np.arange(1.0, 6.0)
    xs = np.zeros(5)
    inertia = (ctypes.c_int32 * 3)()
    h = jax_capi.sls_analyse_raw(5, 9, rows.ctypes.data, cols.ctypes.data, 0)
    sf = jax_capi.sls_factorize_raw(h, vals.ctypes.data, 0.0)
    ss = jax_capi.sls_solve_raw(h, rhs.ctypes.data, xs.ctypes.data)
    si = jax_capi.sls_inertia_raw(h, ctypes.addressof(inertia))
    jax_capi.sls_free_raw(h)
    _close(got["sls"], [sf, ss, si, *inertia], "sls")
    _close(got["sls_x"], xs, "sls_x")


def test_no_card_and_no_cpu_request_fails_cleanly(tmp_path, capi_lib):
    """Without a CUDA device and without GALAHAD_TPU_TORCH_DEVICE the entries
    return a nonzero status and print why; nothing runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    out = _run_c(tmp_path, capi_lib, C_NO_CARD, "nocard", device=None)
    assert out.returncode == 0, (out.stdout, out.stderr[-1500:])
    st, h, tr = (int(v) for v in out.stdout.split()[1:])
    assert st != 0 and h <= 0 and tr != 0
    assert "GALAHAD_TPU_TORCH_DEVICE=cpu" in out.stderr
