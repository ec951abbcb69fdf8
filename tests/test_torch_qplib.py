"""The port's QPLIB reader and writer against the JAX package's: the 20
sweep fixtures read into identical arrays, patterns and bound masks, as a
SparseQP and as a dense QP, and ``dumps`` (of the parsed file and of each
package's QP through ``from_qp``) gives the JAX package's text."""
import jax.numpy as jnp  # noqa: F401  (both packages live in this process)
import numpy as np
import pytest

from galahad_tpu.core.problem import classify_bounds as j_classify
from galahad_tpu.io import qplib as j_qplib

from galahad_tpu_torch.core.problem import check_qp, classify_bounds
from galahad_tpu_torch.io import qplib as t_qplib

from _torch_port_helpers import SWEEP, sweep_path

MASKS = ["has_xl", "has_xu", "x_free", "x_fixed", "x_range",
         "has_cl", "has_cu", "c_free", "c_equality", "c_range"]


def test_sweep_has_twenty_fixtures():
    assert len(SWEEP) == 20


@pytest.mark.parametrize("name", SWEEP)
def test_fixture_reads_identically(name):
    jq = j_qplib.read_sparse_qp(sweep_path(name))
    tq = t_qplib.read_sparse_qp(sweep_path(name), device="cpu")
    assert (tq.n, tq.m, tq.name) == (jq.n, jq.m, jq.name)
    for f in ("g", "c_l", "c_u", "x_l", "x_u", "h_vals", "a_vals", "x", "y", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(jq, f)),
                                      getattr(tq, f).numpy(), err_msg=f)
    assert float(jq.f) == float(tq.f)
    for pat in ("h_pat", "a_pat"):
        jp, tp = getattr(jq, pat), getattr(tq, pat)
        assert (jp.m, jp.n) == (tp.m, tp.n)
        np.testing.assert_array_equal(jp.rows, tp.rows)
        np.testing.assert_array_equal(jp.cols, tp.cols)
    jm, tm = j_classify(jq), classify_bounds(tq)
    for f in MASKS:
        np.testing.assert_array_equal(np.asarray(getattr(jm, f)),
                                      getattr(tm, f).numpy(), err_msg=f)
    assert check_qp(tq) == 0
    # matrix actions agree with the JAX scatter-adds to rounding (1e-13
    # relative: the same products summed in another order)
    rng = np.random.default_rng(0)
    v, w = rng.normal(size=jq.n), rng.normal(size=jq.m)
    import torch
    tv, tw = torch.as_tensor(v), torch.as_tensor(w)
    for jf, tf in ((jq.Hx(jnp.asarray(v)), tq.Hx(tv)),
                   (jq.Ax(jnp.asarray(v)), tq.Ax(tv)),
                   (jq.Aty(jnp.asarray(w)), tq.Aty(tw)),
                   (jq.H_diag(), tq.H_diag())):
        ref = np.asarray(jf)
        np.testing.assert_allclose(tf.numpy(), ref, rtol=0,
                                   atol=1e-13 * max(1.0, np.abs(ref).max(initial=0.0)))


def test_parser_errors_and_records():
    p = t_qplib.load(sweep_path("QPB100"))
    hr, hc, _ = p.H_coo
    assert (hr >= hc).all() and len(hr) < p.n * p.n // 4
    with pytest.raises(ValueError):
        t_qplib.loads("NAME\nQCL\nminimize\n3\n")
    with pytest.raises(ValueError):
        t_qplib.loads("NAME\nXX\n")


@pytest.mark.parametrize("name", SWEEP)
def test_read_qp_matches_reference(name):
    """The dense reader: every array of the port's QP equal to the JAX
    package's ``read_qp`` (the sign flip of a Maximize file included)."""
    jq = j_qplib.read_qp(sweep_path(name))
    tq = t_qplib.read_qp(sweep_path(name), device="cpu")
    assert (tq.n, tq.m, tq.name, tq.h_kind) == (jq.n, jq.m, jq.name, jq.h_kind)
    for f in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u", "x", "y", "z"):
        a, b = getattr(jq, f), getattr(tq, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    assert float(jq.f) == float(tq.f)
    assert check_qp(tq) == 0


@pytest.mark.parametrize("name", SWEEP)
def test_dumps_matches_reference(name):
    """The writer: ``dumps`` of the parsed fixture, and of the problem
    built back from each package's dense and sparse QP (``from_qp``), give
    the JAX package's text."""
    text = open(sweep_path(name)).read()
    assert t_qplib.dumps(t_qplib.loads(text)) == j_qplib.dumps(j_qplib.loads(text))
    jd, td = j_qplib.read_qp(sweep_path(name)), t_qplib.read_qp(sweep_path(name), device="cpu")
    assert t_qplib.dumps(t_qplib.from_qp(td)) == j_qplib.dumps(j_qplib.from_qp(jd))
    js = j_qplib.read_sparse_qp(sweep_path(name))
    ts = t_qplib.read_sparse_qp(sweep_path(name), device="cpu")
    assert t_qplib.dumps(t_qplib.from_qp(ts)) == j_qplib.dumps(j_qplib.from_qp(js))


def test_write_qp_round_trip(tmp_path):
    """``write_qp`` then ``read_qp`` gives back the same dense QP."""
    tq = t_qplib.read_qp(sweep_path("QPMAX"), device="cpu")
    path = str(tmp_path / "round.qplib")
    t_qplib.write_qp(path, tq, name="ROUND")
    back = t_qplib.read_qp(path, device="cpu")
    assert back.name == "ROUND" and back.h_kind == tq.h_kind
    for f in ("H", "g", "A", "c_l", "c_u", "x_l", "x_u"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), getattr(tq, f).numpy(), err_msg=f)
