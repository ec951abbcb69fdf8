"""The port's SIF decoder (galahad_tpu_torch/io/sif.py) against the JAX
package's on the SIF texts of tools/sif_problems.py (CAMEL6, HART6, an
ALLINIT-like problem, CONSTR with constraint groups, EXTROSNB at N = 10):
the decoded structure (names, start, bounds, constraint bounds) equal, the
objective, its gradient, the constraints and their Jacobian within 1e-14
relative at random points (both evaluate group by group, op by op; the
powers and EXP differ in the last bit), and TRB on the three bound-
constrained problems with the JAX package's status, iterations, x and f
(1e-10).  Never read from a CUTEst tree."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.io import sif as j_sif
from galahad_tpu.nlp.tru import trb_solve as j_trb

from galahad_tpu_torch.io import sif as t_sif
from galahad_tpu_torch.nlp import trb_solve

from _torch_port_helpers import REPO, f_off, one_torch_thread, rel  # noqa: F401

sys.path.insert(0, os.path.join(REPO, "tools"))
import sif_problems as S  # noqa: E402  (tools/sif_problems.py)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


TEXTS = dict(S.TEXTS, EXTROSNB=S.extended_rosenbrock(10))


def test_decoded_structure_and_values():
    """Every text: the same problem, and f, grad f, c(x) and its Jacobian
    within 1e-14 at three random points around the start, in the box."""
    r = np.random.default_rng(0)
    for name, txt in TEXTS.items():
        pj, pt = j_sif.loads(txt), t_sif.loads(txt)
        assert (pt.name, pt.var_names, pt.n, pt.m) == (pj.name, pj.var_names, pj.n, pj.m), name
        for k in ("x0", "x_l", "x_u", "c_l", "c_u"):
            a, b = getattr(pj, k), getattr(pt, k)
            assert (a is None and b is None) or np.array_equal(a, b), (name, k)
        for _ in range(3):
            x = np.clip(pj.x0 + r.uniform(-0.5, 0.5, pj.n), pj.x_l, pj.x_u)
            xj, xt = jnp.asarray(x), torch.as_tensor(x)
            assert rel(pj.objective(xj), pt.objective(xt)) <= 1e-14, name
            assert rel(jax.grad(pj.objective)(xj), torch.func.grad(pt.objective)(xt)) <= 1e-14
            if pj.m:
                assert rel(pj.constraints(xj), pt.constraints(xt)) <= 1e-14, name
                assert rel(jax.jacfwd(pj.constraints)(xj),
                           torch.func.jacfwd(pt.constraints)(xt)) <= 1e-14, name
    hart6 = t_sif.loads(S.HART6)
    assert hart6.n == 6 and (hart6.x_l == 0).all() and (hart6.x_u == 1).all()
    allinit = t_sif.loads(S.ALLINIT)
    assert allinit.x_l[0] < -1e18 and allinit.x_u[0] > 1e18 and allinit.x_l[1] == 1.0
    assert allinit.x_l[2] == -1e10 and allinit.x_u[2] == 1.0
    assert allinit.x_l[3] == allinit.x_u[3] == 2.0


def test_intrinsics_take_floats():
    """A temporary made of parameters alone reaches the intrinsics as a Python
    float (CONSTR's COS(S)); each wraps it in the point's type; MAX / MIN take
    two arguments; a constraint group with no variable gives its constant."""
    x = torch.zeros(3, dtype=torch.float64)
    env = t_sif._intrinsics(x)
    assert float(env["SIN"](1.0)) == float(np.sin(1.0)) and env["EXP"](0.0).dtype == x.dtype
    assert float(env["MAX"](1.0, x[0] + 2.0)) == 2.0 and float(env["MIN"](1.0, 3.0)) == 1.0
    assert float(env["SIGN"](-3.0, 1.0)) == 3.0
    p = t_sif.loads(S.CONSTR)
    assert float(p.constraints(x)[3]) == 0.0 and p.c_l[3] == -2.0


def test_trb_on_the_decoded_problems(tmp_path):
    """TRB from each problem's start on CAMEL6, HART6 and ALLINIT: the JAX
    package's status, iterations, x and f; ``read_nlp`` gives the port's NLP
    on the device asked for."""
    for name in ("CAMEL6", "HART6", "ALLINIT"):
        pj, pt = j_sif.loads(S.TEXTS[name]), t_sif.loads(S.TEXTS[name])
        sj = j_trb(pj.objective, pj.x0, pj.x_l, pj.x_u)
        st = trb_solve(pt.objective, pt.x0, pt.x_l, pt.x_u, device="cpu")
        assert (int(sj.status), int(sj.iter)) == (int(st.status), int(st.iter)), name
        assert float(np.abs(np.asarray(sj.x) - st.x.numpy()).max()) <= 1e-10, name
        assert f_off(sj.f, st.f, 1e-10) <= 1.0, name
    assert abs(float(st.f) - float(sj.f)) <= 1e-12 * abs(float(sj.f))
    path = tmp_path / "CAMEL6.SIF"
    path.write_text(S.CAMEL6)
    nlp = t_sif.read_nlp(str(path), device="cpu")
    assert nlp.n == 2 and nlp.x.device.type == "cpu" and nlp.constraints is None
    assert float(nlp.x_l[1]) == -1.5
