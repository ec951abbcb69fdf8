"""The sparse KKT layer of the port (``sparse_kkt_plan`` /
``sparse_kkt_factorize`` / ``SparseQP.build_kkt``) against the JAX
package's for fixed barrier diagonals D_x and C_diag, and the KKT residual
measures of core/residuals.py.

Tolerance: 1e-10 relative on the solution (float64; the JAX side refines
with a double-word iterate, the port in plain float64, so they agree to
the accuracy of the refined solve, not to rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.core.residuals import kkt_residuals as j_kkt_residuals
from galahad_tpu.core.sparse import make_sparse_qp as j_make
from galahad_tpu.io import qplib as j_qplib
from galahad_tpu.linalg.sbls import sparse_kkt_factorize as j_factorize
from galahad_tpu.linalg.sbls import sparse_kkt_plan as j_plan
from galahad_tpu.qp.ipm import IPMControl as JControl

from galahad_tpu_torch.convert import sparse_qp_from_numpy
from galahad_tpu_torch.core.residuals import kkt_residuals
from galahad_tpu_torch.linalg.sbls import sparse_kkt_factorize, sparse_kkt_plan
from galahad_tpu_torch.qp.ipm import IPMControl

from _torch_port_helpers import grid_qp_arrays, sweep_path


def as_fields(jq):
    """The JAX SparseQP's fields as numpy arrays (what convert.py takes)."""
    pat = lambda p: dict(rows=p.rows, cols=p.cols, m=p.m, n=p.n)
    opt = lambda v: None if v is None else np.asarray(v)
    return dict(g=np.asarray(jq.g), f=float(jq.f), c_l=np.asarray(jq.c_l),
                c_u=np.asarray(jq.c_u), x_l=np.asarray(jq.x_l),
                x_u=np.asarray(jq.x_u), h_vals=np.asarray(jq.h_vals),
                a_vals=np.asarray(jq.a_vals), x=opt(jq.x), y=opt(jq.y),
                z=opt(jq.z), h_pat=pat(jq.h_pat), a_pat=pat(jq.a_pat),
                name=jq.name)


def problems(case):
    if case.startswith("grid"):
        n, m, kw = grid_qp_arrays(int(case[4:]))
        jq = j_make(n, m, **kw)
    else:
        jq = j_qplib.read_sparse_qp(sweep_path(case))
    return jq, sparse_qp_from_numpy(as_fields(jq), device="cpu")


@pytest.mark.parametrize("case", ["grid6", "grid10", "QPB100", "LPB100", "QPEQ"])
def test_kkt_solve_matches_reference(case):
    jq, tq = problems(case)
    n, m = tq.n, tq.m
    rng = np.random.default_rng(3)
    D_x = rng.uniform(1e-3, 1e3, n)
    C = rng.uniform(1e-3, 1e3, m)
    C[::3] = 0.0                                 # equality-like rows
    b1, b2 = rng.normal(size=n), rng.normal(size=m)
    dxj, dyj = jq.build_kkt(jnp.asarray(D_x), jnp.asarray(C), JControl())(
        jnp.asarray(b1), jnp.asarray(b2))
    tD, tC = torch.as_tensor(D_x), torch.as_tensor(C)
    dxt, dyt = tq.build_kkt(tD, tC, IPMControl())(
        torch.as_tensor(b1), torch.as_tensor(b2))
    ref = np.concatenate([np.asarray(dxj), np.asarray(dyj)])
    out = np.concatenate([dxt.numpy(), dyt.numpy()])
    assert np.abs(ref - out).max() <= 1e-10 * np.abs(ref).max()
    # and it solves the UNregularized system to refinement accuracy
    u1, u2 = dxt, -dyt
    r1 = tq.Hx(u1) + tD * u1 + tq.Aty(u2) - torch.as_tensor(b1)
    r2 = tq.Ax(u1) - tC * u2 - torch.as_tensor(b2)
    assert float(torch.cat([r1, r2]).norm()) <= 1e-9 * np.linalg.norm(
        np.concatenate([b1, b2]))


@pytest.mark.parametrize("case", ["grid6", "QPMIXB"])
def test_factorize_scaling_inertia_and_dmin(case):
    jq, tq = problems(case)
    n, m = tq.n, tq.m
    rng = np.random.default_rng(5)
    D_x, C = rng.uniform(0.1, 10.0, n), rng.uniform(0.1, 10.0, m)
    pj = j_plan(jq.h_pat, jq.a_pat, n)
    pt = sparse_kkt_plan(tq.h_pat, tq.a_pat, n)
    assert sparse_kkt_plan(tq.h_pat, tq.a_pat, n) is pt        # analysed once
    np.testing.assert_array_equal(pj.rows, pt.rows)
    np.testing.assert_array_equal(pj.dsel, pt.dsel)
    fj, Sj = j_factorize(pj, jq.h_vals, jq.a_vals, jnp.asarray(D_x),
                         jnp.asarray(C), rho=1e-8, delta=1e-8)
    ft, St = sparse_kkt_factorize(pt, tq.h_vals, tq.a_vals, torch.as_tensor(D_x),
                                  torch.as_tensor(C), rho=1e-8, delta=1e-8)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=1e-14)
    assert ft.inertia.tolist() == np.asarray(fj.inertia).tolist() == [n, m, 0]
    assert abs(float(ft.dmin) - float(fj.dmin)) <= 1e-12 * float(fj.dmin)


def test_unported_backend_raises():
    """Both backends of the JAX package are ported ("flat" and, since the
    inline supernodal LDL^T, "inline"); a name that is neither raises."""
    from galahad_tpu_torch.linalg.supernodal import SupernodalSymbolic

    _, tq = problems("grid6")
    with pytest.raises(ValueError, match="unknown sparse KKT backend"):
        sparse_kkt_plan(tq.h_pat, tq.a_pat, tq.n, backend="multifrontal")
    assert isinstance(sparse_kkt_plan(tq.h_pat, tq.a_pat, tq.n, backend="inline").sym,
                      SupernodalSymbolic)


@pytest.mark.parametrize("case", ["grid6", "QPB100", "LPB100"])
def test_kkt_residual_measures_match_reference(case):
    jq, tq = problems(case)
    rng = np.random.default_rng(9)
    x, y, z = rng.normal(size=tq.n), rng.normal(size=tq.m), rng.normal(size=tq.n)
    ref = [float(r) for r in j_kkt_residuals(
        jq, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))]
    out = [float(r) for r in kkt_residuals(
        tq, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(z))]
    np.testing.assert_allclose(out, ref, rtol=1e-12)
