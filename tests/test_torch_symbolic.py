"""Symbolic analysis: the port's own native library and ``flat_analyse``
give the JAX package's plan for the same pattern (plan equality, not a
tolerance: the host code is the same)."""
import numpy as np
import pytest
import scipy.sparse as sp

from galahad_tpu.io import qplib as j_qplib
from galahad_tpu.linalg import supernodal_flat as J
from galahad_tpu import native as j_native

from galahad_tpu_torch import native as t_native
from galahad_tpu_torch.convert import flat_plan_from_numpy
from galahad_tpu_torch.core.sparse import lower_triangle
from galahad_tpu_torch.linalg import supernodal_flat as T

from _torch_port_helpers import (grid_laplacian, grid_qp_arrays, kkt_pattern,
                                 sweep_path)


def plans_equal(pj, pt):
    assert (pj.n, pj.S, pj.ns, pj.nnz_L) == (pt.n, pt.S, pt.ns, pt.nnz_L)
    assert pj.flops == pt.flops
    for f in ("perm", "iperm", "a_idx", "a_src", "d_idx", "d_col"):
        np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f), err_msg=f)
    assert len(pj.groups) == len(pt.groups)
    for gj, gt in zip(pj.groups, pt.groups):
        assert (gj.goff, gj.nb, gj.Fpad, gj.level) == (gt.goff, gt.nb, gt.Fpad, gt.level)
        np.testing.assert_array_equal(gj.ncols, gt.ncols)
        np.testing.assert_array_equal(gj.frows, gt.frows)
        assert len(gj.ea) == len(gt.ea)
        for oj, ot in zip(gj.ea, gt.ea):
            assert {k: oj[k] for k in ("sbase", "sncols", "fp_src", "u", "ppar")} \
                == {k: ot[k] for k in ("sbase", "sncols", "fp_src", "u", "ppar")}
            np.testing.assert_array_equal(oj["ppos"], ot["ppos"])


def grid_kkt_pattern(k):
    import types
    n, m, kw = grid_qp_arrays(k)
    hr, hc, _ = lower_triangle(*kw["h_coo"])
    ar, ac, _ = kw["a_coo"]
    h = types.SimpleNamespace(rows=hr, cols=hc, m=n, n=n)
    a = types.SimpleNamespace(rows=ar, cols=ac, m=m, n=n)
    return kkt_pattern(h, a, n)


def fixture_kkt_pattern(name):
    q = j_qplib.read_sparse_qp(sweep_path(name))
    return kkt_pattern(q.h_pat, q.a_pat, q.n)


CASES = {
    "grid_kkt_k20": lambda: grid_kkt_pattern(20),
    "QPB100": lambda: fixture_kkt_pattern("QPB100"),
    "LPB300": lambda: fixture_kkt_pattern("LPB300"),
    "QPMIXB": lambda: fixture_kkt_pattern("QPMIXB"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_reference(case):
    rows, cols, n = CASES[case]()
    pj = J.flat_analyse(rows, cols, n, order="amd", relax_cols=16)
    pt = T.flat_analyse(rows, cols, n, order="amd", relax_cols=16)
    plans_equal(pj, pt)


def duplicated_pattern():
    """The grid KKT pattern at k=12 with a third of its entries given twice
    and some once more as their mirror image (upper for lower), shuffled:
    the analyse must take COO input as it comes."""
    rows, cols, n = grid_kkt_pattern(12)
    rng = np.random.default_rng(7)
    dup = rng.choice(len(rows), len(rows) // 3, replace=False)
    mir = rng.choice(len(rows), len(rows) // 5, replace=False)
    r = np.concatenate([rows, rows[dup], cols[mir]])
    c = np.concatenate([cols, cols[dup], rows[mir]])
    perm = rng.permutation(len(r))
    return r[perm], c[perm], n


@pytest.mark.parametrize("case", ["grid_kkt_k60", "duplicate_entries"])
def test_plan_equals_reference_with_many_supernodes(case):
    """Thousands of supernodes (k=60: KKT order 5,400) and a pattern with
    duplicate entries: a wrong grouping of the entries by supernode would
    move ``a_idx``."""
    rows, cols, n = (grid_kkt_pattern(60) if case == "grid_kkt_k60"
                     else duplicated_pattern())
    pj = J.flat_analyse(rows, cols, n, order="amd", relax_cols=16)
    pt = T.flat_analyse(rows, cols, n, order="amd", relax_cols=16)
    if case == "grid_kkt_k60":
        assert pt.ns > 1000
    plans_equal(pj, pt)


@pytest.mark.parametrize("order", ["amd", "rcm", "nd", "natural"])
def test_orderings_equal_reference(order):
    A = grid_laplacian(7)
    Al = sp.tril(A).tocoo()
    pj = J.flat_analyse(Al.row, Al.col, A.shape[0], order=order)
    pt = T.flat_analyse(Al.row, Al.col, A.shape[0], order=order)
    plans_equal(pj, pt)


def test_plan_carried_across_as_numpy():
    """convert.flat_plan_from_numpy rebuilds the JAX plan field by field."""
    rows, cols, n = grid_kkt_pattern(8)
    pj = J.flat_analyse(rows, cols, n, relax_cols=16)
    fields = dict(
        n=pj.n, S=pj.S, perm=pj.perm, iperm=pj.iperm, a_idx=pj.a_idx,
        a_src=pj.a_src, d_idx=pj.d_idx, d_col=pj.d_col, nnz_L=pj.nnz_L,
        flops=pj.flops, ns=pj.ns,
        groups=[dict(goff=g.goff, nb=g.nb, Fpad=g.Fpad, level=g.level,
                     ncols=g.ncols, frows=g.frows, ea=g.ea) for g in pj.groups])
    plans_equal(pj, flat_plan_from_numpy(fields))


def test_native_wrappers_equal_reference():
    A = grid_laplacian(6)
    for fn in ("amd_order", "rcm_order", "nd_order", "etree"):
        np.testing.assert_array_equal(
            getattr(j_native, fn)(A.indptr, A.indices),
            getattr(t_native, fn)(A.indptr, A.indices), err_msg=fn)
    par = t_native.etree(A.indptr, A.indices)
    np.testing.assert_array_equal(j_native.postorder(par), t_native.postorder(par))


def test_helpers_equal_reference():
    for f in (1, 8, 9, 100, 129, 5000, 20000):
        assert T._fpad_for(f) == J._fpad_for(f)
    assert T._FPAD_LADDER == J._FPAD_LADDER
    for nb, fp in ((1, 8), (4700, 8), (37, 128), (600, 512)):
        assert T._chunks_of(nb, fp) == J._chunks_of(nb, fp)
    par = np.array([2, 2, 4, 4, -1, 6, -1])
    np.testing.assert_array_equal(T._etree_postorder(par), J._etree_postorder(par))


def test_build_directory_is_inside_the_package(tmp_path, monkeypatch):
    from galahad_tpu_torch import _build
    import os

    monkeypatch.delenv("GALAHAD_TPU_TORCH_BUILD", raising=False)
    d = _build.build_dir()
    assert os.path.basename(d) == "_build"
    assert os.path.dirname(d) == os.path.dirname(os.path.abspath(_build.__file__))
    monkeypatch.setenv("GALAHAD_TPU_TORCH_BUILD", str(tmp_path / "b"))
    assert _build.build_dir() == str(tmp_path / "b") and os.path.isdir(tmp_path / "b")
