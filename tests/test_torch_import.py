"""The port imports torch and nothing of JAX or the JAX package, and its
entry points refuse to run on the CPU unless asked to."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import galahad_tpu_torch
import galahad_tpu_torch.convert
import galahad_tpu_torch.core.fit
import galahad_tpu_torch.core.residuals
import galahad_tpu_torch.core.roots
import galahad_tpu_torch.io.qplib
import galahad_tpu_torch.linalg.band_ops
import galahad_tpu_torch.linalg.banded
import galahad_tpu_torch.linalg.banded_kernels
import galahad_tpu_torch.linalg.cholesky
import galahad_tpu_torch.linalg.ldlt_kernels
import galahad_tpu_torch.linalg.sbls
import galahad_tpu_torch.linalg.supernodal_flat
import galahad_tpu_torch.native
import galahad_tpu_torch.qp.ipm
import galahad_tpu_torch.qp.ipm_banded
import galahad_tpu_torch.qp.wrappers
import galahad_tpu_torch.qp.dqp
import galahad_tpu_torch.qp.frontend
import galahad_tpu_torch.pre.scale
import galahad_tpu_torch.pre.presolve
import galahad_tpu_torch.cli
import galahad_tpu_torch.linalg.tridiag_kernels
import galahad_tpu_torch.tr
import galahad_tpu_torch.tr.gltr
import galahad_tpu_torch.tr.llst
import galahad_tpu_torch.tr.lqr
import galahad_tpu_torch.tr.lstr
import galahad_tpu_torch.tr.secular_kernels
import galahad_tpu_torch.tr.trs
import galahad_tpu_torch.tr.trs_sparse
import galahad_tpu_torch.linalg.bsc
import galahad_tpu_torch.nlp
import galahad_tpu_torch.nlp.arc
import galahad_tpu_torch.nlp.check
import galahad_tpu_torch.nlp.nls
import galahad_tpu_torch.nlp.tru
import galahad_tpu_torch.qn
import galahad_tpu_torch.nlp.lancelot
import galahad_tpu_torch.nlp.lancelot_simple
import galahad_tpu_torch.nlp.filtrane
import galahad_tpu_torch.go
import galahad_tpu_torch.go.bgo
import galahad_tpu_torch.go.dgo
import galahad_tpu_torch.go.lhs
import galahad_tpu_torch.go.ugo
import galahad_tpu_torch.io.sif
import galahad_tpu_torch.qp.qcqp
import galahad_tpu_torch.qp.bqp
import galahad_tpu_torch.qp.eqp
import galahad_tpu_torch.linalg.convert
import galahad_tpu_torch.linalg.ir
import galahad_tpu_torch.linalg.miqr
import galahad_tpu_torch.linalg.mop
import galahad_tpu_torch.linalg.psls
import galahad_tpu_torch.linalg.scu
import galahad_tpu_torch.linalg.sls
import galahad_tpu_torch.linalg.supernodal
import galahad_tpu_torch.linalg.uls
import galahad_tpu_torch.pre.fdc
import galahad_tpu_torch.qp.cro
import galahad_tpu_torch.qp.lpa
import galahad_tpu_torch.qp.lpqp
import galahad_tpu_torch.qp.qpa
import galahad_tpu_torch.qp.qpb
import galahad_tpu_torch.parallel
import galahad_tpu_torch.parallel.mesh
import galahad_tpu_torch.parallel.schur
import galahad_tpu_torch.parallel.supernodal_mesh
import galahad_tpu_torch.capi_impl
import galahad_tpu_torch.interfaces.c.build
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "galahad_tpu" or m.startswith("galahad_tpu."))
print("BAD=" + ",".join(bad))
"""


def _run(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_smoke_import_no_jax():
    res = _run(_PROBE)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "BAD="


def test_no_import_statements_of_jax_in_port_sources():
    offenders = []
    roots = [os.path.join(REPO, "galahad_tpu_torch"),
             os.path.join(REPO, "chip_smoke.py")]
    for root in roots:
        files = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(root)
            for f in fs if f.endswith(".py")]
        for path in files:
            for ln in open(path):
                s = ln.strip()
                if s.startswith(("import jax", "from jax", "import galahad_tpu ",
                                 "from galahad_tpu ", "from galahad_tpu.",
                                 "import galahad_tpu.")) or s == "import galahad_tpu":
                    offenders.append((path, s))
    assert offenders == []


@pytest.mark.parametrize("entry", ["make_sparse_qp", "read_sparse_qp",
                                   "sparse_qp_from_numpy", "make_qp", "read_qp",
                                   "qp_from_numpy", "make_banded_qp", "banded_qp_from_numpy"])
def test_default_device_is_the_card(entry):
    """Without device='cpu' an entry point asks for the CUDA device and
    raises where there is none; it does not run on the CPU."""
    import numpy as np
    import torch

    from galahad_tpu_torch import make_qp, make_sparse_qp
    from galahad_tpu_torch.convert import (banded_qp_from_numpy, qp_from_numpy,
                                           sparse_qp_from_numpy)
    from galahad_tpu_torch.io.qplib import read_qp, read_sparse_qp
    from galahad_tpu_torch.qp.ipm_banded import make_banded_qp

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    path = os.path.join(REPO, "examples", "sweep", "QPB100.qplib")
    calls = {
        "make_sparse_qp": lambda: make_sparse_qp(2, 0, g=np.zeros(2)),
        "read_sparse_qp": lambda: read_sparse_qp(path),
        "sparse_qp_from_numpy": lambda: sparse_qp_from_numpy({}),
        "make_qp": lambda: make_qp(g=np.zeros(2)),
        "read_qp": lambda: read_qp(path),
        "qp_from_numpy": lambda: qp_from_numpy(dict(g=np.zeros(2), c_l=np.zeros(0),
                                                    c_u=np.zeros(0), x_l=np.zeros(2),
                                                    x_u=np.ones(2))),
        "make_banded_qp": lambda: make_banded_qp(g=np.zeros(2)),
        "banded_qp_from_numpy": lambda: banded_qp_from_numpy(
            dict(g=np.zeros(2), c_l=np.zeros(0), c_u=np.zeros(0), x_l=np.zeros(2),
                 x_u=np.ones(2), h_kind="zero")),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_smoke_script_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_banded_wrappers_do_not_fall_back(monkeypatch):
    """A block-tridiagonal factorization or solve on a tensor that claims a
    CUDA device reaches the kernel's wrapper, never the plain version."""
    import torch

    from galahad_tpu_torch.linalg import banded

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    called = []
    monkeypatch.setattr(banded, "block_tridiag_cholesky_plain", lambda *a: called.append(1))
    monkeypatch.setattr(banded, "block_tridiag_solve_plain", lambda *a: called.append(1))
    D = torch.zeros(2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        banded.block_tridiag_cholesky(D, torch.zeros(1, 4, 4, device="meta"))
    f = banded.BlockTridiagFactors(Ld=D, Lo=torch.zeros(1, 4, 4, device="meta"), ok=None)
    with pytest.raises(ValueError, match="CUDA"):
        banded.block_tridiag_solve(f, torch.zeros(2, 4, device="meta"))
    assert called == []


def test_cuda_wrapper_does_not_fall_back(monkeypatch):
    """A tensor that claims a CUDA device must reach the kernel path (and
    fail here for want of a card), never the plain version."""
    import torch

    from galahad_tpu_torch.linalg import ldlt_kernels

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    called = []
    monkeypatch.setattr(ldlt_kernels, "partial_ldlt_plain",
                        lambda *a, **k: called.append(1))
    F = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ldlt_kernels.partial_ldlt(F, torch.zeros(1, dtype=torch.int32,
                                                 device="meta"))
    assert called == []


@pytest.mark.parametrize("entry", ["trs_solve", "trs_solve_diagonal", "rqs_solve", "dps_solve",
                                   "trs_solve_chol", "trs_solve_sparse", "llst_solve",
                                   "lls_solve", "gltr_solve"])
def test_tr_entry_points_default_to_the_card(entry):
    """The trust-region entry points put numpy inputs on the CUDA device
    unless asked for the CPU, and raise where there is none."""
    import numpy as np
    import torch

    from galahad_tpu_torch import COOPattern
    from galahad_tpu_torch import tr

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    H, c = np.eye(3), np.ones(3)
    calls = {
        "trs_solve": lambda: tr.trs_solve(H, c, 1.0),
        "trs_solve_diagonal": lambda: tr.trs_solve_diagonal(c, c, 1.0),
        "rqs_solve": lambda: tr.rqs_solve(H, c, 1.0),
        "dps_solve": lambda: tr.dps_solve(H, c, radius=1.0),
        "trs_solve_chol": lambda: tr.trs_solve_chol(H, c, 1.0),
        "trs_solve_sparse": lambda: tr.trs_solve_sparse(
            COOPattern(np.arange(3), np.arange(3), 3, 3), c, c, 1.0),
        "llst_solve": lambda: tr.llst_solve(H, c, 1.0),
        "lls_solve": lambda: tr.lls_solve(H, c, 1.0),
        "gltr_solve": lambda: tr.gltr_solve(lambda v: v, c, 1.0),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["tru_solve", "trb_solve", "arc_solve", "nls_solve",
                                   "nls_solve_sparse", "check_derivatives", "lms_setup",
                                   "unconstrained_nlp"])
def test_nlp_entry_points_default_to_the_card(entry):
    """The NLP and quasi-Newton entry points put numpy inputs on the CUDA
    device unless asked for the CPU, and raise where there is none."""
    import numpy as np
    import torch

    from galahad_tpu_torch import COOPattern, nlp, qn
    from galahad_tpu_torch.core.problem import unconstrained_nlp

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    f = lambda x: (x * x).sum()                                     # noqa: E731
    x0 = np.ones(3)
    calls = {
        "tru_solve": lambda: nlp.tru_solve(f, x0),
        "trb_solve": lambda: nlp.trb_solve(f, x0, -np.ones(3), np.ones(3)),
        "arc_solve": lambda: nlp.arc_solve(f, x0),
        "nls_solve": lambda: nlp.nls_solve(lambda x: x, x0),
        "nls_solve_sparse": lambda: nlp.nls_solve_sparse(
            lambda x: x, lambda x: torch.ones_like(x),
            COOPattern(np.arange(3), np.arange(3), 3, 3), x0),
        "check_derivatives": lambda: nlp.check_derivatives(f, x0),
        "lms_setup": lambda: qn.lms_setup(3),
        "unconstrained_nlp": lambda: unconstrained_nlp(f, x0),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_tr_kernel_wrappers_do_not_fall_back():
    """The tridiagonal factor and solve, and the two secular iterations, on
    tensors that claim a device other than the CPU reach the kernels'
    wrappers (and fail here for want of a card), never the plain versions."""
    import torch

    from galahad_tpu_torch.linalg import tridiag_factor, tridiag_kernels, tridiag_solve
    from galahad_tpu_torch.tr import secular_kernels
    from galahad_tpu_torch.tr import trs as T

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tridiag_kernels.reset_tridiag_counts()
    secular_kernels.reset_secular_counts()
    z = lambda *shape: torch.zeros(*shape, device="meta")      # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        tridiag_factor(z(4, 8), z(4, 7))
    with pytest.raises(ValueError, match="CUDA"):
        tridiag_solve(z(4, 8), z(4, 7), z(4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        T._secular_newton(z(4, 8), z(4, 8), z(4), z(4), 64)
    with pytest.raises(ValueError, match="CUDA"):
        T._rqs_newton(z(4, 8), z(4, 8), torch.zeros(4, 8, dtype=torch.bool, device="meta"),
                      z(4), 3.0, z(4), z(4), 96)
    assert tridiag_kernels.tridiag_counts() == dict(factor=0, solve=0, factor_plain=0,
                                                    solve_plain=0)
    assert secular_kernels.secular_counts() == dict(trs=0, rqs=0, trs_plain=0, rqs_plain=0)


@pytest.mark.parametrize("entry", ["lancelot_solve", "lancelot_simple", "filtrane_solve",
                                   "bgo_solve", "dgo_solve", "ugo_solve", "lhs_sample",
                                   "lhs_sample_box", "filter_init", "read_qcqp", "read_nlp", "bqp_solve", "blls_solve",
                                   "eqp_solve"])
def test_constrained_entry_points_default_to_the_card(entry):
    """LANCELOT, FILTRANE, the global solvers, the QCQP and SIF readers and
    BQP / BLLS / EQP put numpy inputs on the CUDA device unless asked for the
    CPU, and raise where there is none."""
    import numpy as np
    import torch

    from galahad_tpu_torch import go, nlp, qp
    from galahad_tpu_torch.io import qplib, sif

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    f = lambda x: (x * x).sum()                                     # noqa: E731
    c = lambda x: x[:1]                                             # noqa: E731
    x0, lo, hi = np.ones(2), -np.ones(2), np.ones(2)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_qcqp import QCQP_FILE

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import sif_problems

    calls = {
        "lancelot_solve": lambda: nlp.lancelot_solve(f, c, x0, np.zeros(1), np.zeros(1)),
        "lancelot_simple": lambda: nlp.lancelot_simple(f, x0),
        "filtrane_solve": lambda: nlp.filtrane_solve(c, x0, np.zeros(1), np.zeros(1)),
        "bgo_solve": lambda: go.bgo_solve(f, lo, hi),
        "dgo_solve": lambda: go.dgo_solve(f, lo, hi),
        "ugo_solve": lambda: go.ugo_solve(lambda x: x * x, -1.0, 1.0),
        "lhs_sample": lambda: go.lhs_sample(0, 4, 2),
        "lhs_sample_box": lambda: go.lhs_sample_box(0, 4, lo, hi),
        "filter_init": lambda: nlp.filter_init(4),
        "read_qcqp": lambda: qplib.loads(QCQP_FILE).to_qcqp(),
        "read_nlp": lambda: sif.loads(sif_problems.CAMEL6).to_nlp(),
        "bqp_solve": lambda: qp.bqp_solve(np.eye(2), x0, lo, hi),
        "blls_solve": lambda: qp.blls_solve(np.eye(2), x0, lo, hi),
        "eqp_solve": lambda: qp.eqp_solve(np.eye(2), x0, np.ones((1, 2)), np.ones(1)),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["sls_factorize", "sls_factorize_cg", "psls_build",
                                   "psls_remove", "scu_setup", "uls_factorize", "miqr_form",
                                   "fdc_find_dependent", "sbls_preconditioner",
                                   "sbls_factorize_nullspace", "sbls_fredholm_alternative"])
def test_linalg_service_entry_points_default_to_the_card(entry):
    """The linear-algebra services put numpy inputs on the CUDA device unless
    asked for the CPU, and raise where there is none."""
    import numpy as np
    import torch

    from galahad_tpu_torch.linalg import miqr, psls, sbls, scu, sls, uls
    from galahad_tpu_torch.pre import fdc

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    A = np.eye(4) * 2.0
    calls = {
        "sls_factorize": lambda: sls.sls_factorize(A),
        "sls_factorize_cg": lambda: sls.sls_factorize(lambda v: v, sls.SLSControl(solver="cg")),
        "psls_build": lambda: psls.psls_build(A),
        "psls_remove": lambda: psls.psls_remove(lambda v: v, 4, [1]),
        "scu_setup": lambda: scu.scu_setup(4, 2),
        "uls_factorize": lambda: uls.uls_factorize(A),
        "miqr_form": lambda: miqr.miqr_form(A),
        "fdc_find_dependent": lambda: fdc.fdc_find_dependent(A, np.ones(4)),
        "sbls_preconditioner": lambda: sbls.sbls_preconditioner(A),
        "sbls_factorize_nullspace": lambda: sbls.sbls_factorize_nullspace(A, np.ones((1, 4))),
        "sbls_fredholm_alternative": lambda: sbls.sbls_fredholm_alternative(
            A, np.ones((1, 4)), np.zeros(1), np.ones(4), np.ones(1)),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_inline_factor_does_not_fall_back(monkeypatch):
    """A group of the inline LDL^T on a tensor that claims a CUDA device
    reaches the kernels' wrappers, never their plain versions."""
    import numpy as np
    import torch

    from galahad_tpu_torch.linalg import ldlt_kernels, supernodal

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    called = []
    monkeypatch.setattr(ldlt_kernels, "partial_ldlt_plain", lambda *a, **k: called.append(1))
    monkeypatch.setattr(ldlt_kernels, "partial_ldlt_wide_plain",
                        lambda *a, **k: called.append(1))
    for Fpad in (40, 160):
        F = torch.zeros(1, supernodal.kernel_size(Fpad), supernodal.kernel_size(Fpad),
                        device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            if Fpad <= 128:
                ldlt_kernels.partial_ldlt(F, torch.zeros(1, dtype=torch.int32, device="meta"),
                                          inplace=True)
            else:
                K = supernodal.kernel_size(Fpad)
                lvl = ldlt_kernels.build_wide_level([(0, K, 1, Fpad)], "meta")
                ldlt_kernels.partial_ldlt_wide(F.reshape(-1), lvl)
    assert called == []


@pytest.mark.parametrize("entry", ["make_mesh", "batch_ipm_solve", "capi_device",
                                   "capi_qp_solve_raw"])
def test_parallel_and_capi_entry_points_default_to_the_card(entry, monkeypatch):
    """The mesh is laid over the CUDA devices and a batch goes to the card
    unless the CPU is asked for; the C interface's Python side runs on the
    card unless GALAHAD_TPU_TORCH_DEVICE asks for the CPU.  Each raises where
    there is no card: no CPU fallback."""
    import numpy as np
    import torch

    from galahad_tpu_torch import capi_impl
    from galahad_tpu_torch.parallel import batch_ipm_solve, make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    monkeypatch.delenv(capi_impl.DEVICE_VARIABLE, raising=False)
    H, g, x = np.eye(2)[None], np.ones((1, 2)), np.zeros(2)
    calls = {
        "make_mesh": lambda: make_mesh(),
        "batch_ipm_solve": lambda: batch_ipm_solve(H, g, np.zeros((1, 0, 2)), np.zeros((1, 0)),
                                                   np.zeros((1, 0)), np.zeros((1, 2)),
                                                   np.ones((1, 2))),
        "capi_device": capi_impl.device,
        "capi_qp_solve_raw": lambda: capi_impl.qp_solve_raw(
            "cqp", 2, 0, H.ctypes.data, g.ctypes.data, 0.0, 0, 0, 0, x.ctypes.data,
            x.ctypes.data, x.ctypes.data, 0, x.ctypes.data),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
