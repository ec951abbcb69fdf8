"""The port's linear-algebra services against the JAX package's on the same
seeded inputs, float64, the port on the CPU: SLS (every solver, and
``sls_enquire``), PSLS (every preconditioner, and ``psls_remove``), SCU,
ULS with ``uls_find_basis``, MIQR, IR, MOP, CONVERT, FDC and the rest of
SBLS (the G menu, the null-space mode, the projected PCG, the Fredholm
alternative).  Mirrors tests/test_linalg2.py, tests/test_uls_convert.py and
the FDC part of tests/test_pre.py.

Tolerances: 1e-12 relative (max |port - JAX| / max(1, max |JAX|)), 1e-10
where an eigendecomposition is involved (``eigh``, ``full_gmps``, the
Fredholm alternative: the two LAPACK drivers may order the rotations
differently); integer results (inertia, bases, dependent sets, iteration
counts) equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg import convert as j_convert
from galahad_tpu.linalg import ir as j_ir
from galahad_tpu.linalg import miqr as j_miqr
from galahad_tpu.linalg import mop as j_mop
from galahad_tpu.linalg import psls as j_psls
from galahad_tpu.linalg import sbls as j_sbls
from galahad_tpu.linalg import scu as j_scu
from galahad_tpu.linalg import sls as j_sls
from galahad_tpu.linalg import uls as j_uls
from galahad_tpu.pre import fdc as j_fdc

from galahad_tpu_torch.convert import scu_state_from_numpy
from galahad_tpu_torch.linalg import convert as t_convert
from galahad_tpu_torch.linalg import ir as t_ir
from galahad_tpu_torch.linalg import miqr as t_miqr
from galahad_tpu_torch.linalg import mop as t_mop
from galahad_tpu_torch.linalg import psls as t_psls
from galahad_tpu_torch.linalg import sbls as t_sbls
from galahad_tpu_torch.linalg import scu as t_scu
from galahad_tpu_torch.linalg import sls as t_sls
from galahad_tpu_torch.linalg import uls as t_uls
from galahad_tpu_torch.pre import fdc as t_fdc

from _torch_port_helpers import one_torch_thread, rel  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

T = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
J = lambda a: jnp.asarray(np.asarray(a, np.float64))      # noqa: E731


def spd(n, seed, definite=True):
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n))
    H = B @ B.T + (n if definite else -3.0) * np.eye(n)
    return (H + H.T) / 2


def spd_block_tridiag(k, b, seed):
    r = np.random.default_rng(seed)
    n = k * b
    M = np.zeros((n, n))
    for i in range(k):
        Bi = r.normal(size=(b, b))
        M[i * b:(i + 1) * b, i * b:(i + 1) * b] = Bi @ Bi.T + 3 * b * np.eye(b)
        if i < k - 1:
            Li = r.normal(size=(b, b))
            M[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = Li
            M[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = Li.T
    D = np.stack([M[i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(k)])
    L = np.stack([M[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] for i in range(k - 1)])
    return D, L, M


# ---------------------------------------------------------------------------
# SLS


@pytest.mark.parametrize("solver", ["potr", "sytr", "eigh"])
def test_sls_dense(solver):
    """A definite and an indefinite matrix (sytr / eigh); the solve and the
    inertia against the JAX call."""
    r = np.random.default_rng(2)
    B = r.normal(size=(6, 6))
    mats = [spd(7, 0)] + ([] if solver == "potr" else [(B + B.T) / 2])
    tol = 1e-10 if solver == "eigh" else 1e-12
    for k, A in enumerate(mats):
        b = np.random.default_rng(1).normal(size=A.shape[0])
        for shift in (0.0, 0.25):
            fj = j_sls.sls_factorize(J(A), j_sls.SLSControl(solver=solver, shift=shift))
            ft = t_sls.sls_factorize(A, t_sls.SLSControl(solver=solver, shift=shift),
                                     device="cpu")
            assert rel(j_sls.sls_solve(fj, J(b)), ft.solve(T(b))) <= tol, (k, shift)
            assert (t_sls.sls_enquire(ft).tolist()
                    == np.asarray(j_sls.sls_enquire(fj)).tolist())
            assert bool(ft.ok) == bool(fj.ok)


def test_sls_inertia_eigh():
    r = np.random.default_rng(3)
    Q, _ = np.linalg.qr(r.normal(size=(6, 6)))
    A = Q @ np.diag([-2.0, -1.0, 0.5, 1.0, 2.0, 3.0]) @ Q.T
    ft = t_sls.sls_factorize(A, t_sls.SLSControl(solver="eigh"), device="cpu")
    fj = j_sls.sls_factorize(J(A), j_sls.SLSControl(solver="eigh"))
    assert t_sls.sls_enquire(ft).tolist() == np.asarray(j_sls.sls_enquire(fj)).tolist() \
        == [4, 2, 0]


def test_sls_pbtr():
    """``pbtr`` on the block-tridiagonal factor and solve (rows 4a/4b on the
    card, their plain versions here)."""
    D, L, M = spd_block_tridiag(6, 3, 4)
    rhs = np.random.default_rng(5).normal(size=(6, 3))
    fj = j_sls.sls_factorize((J(D), J(L)), j_sls.SLSControl(solver="pbtr"))
    ft = t_sls.sls_factorize((D, L), t_sls.SLSControl(solver="pbtr"), device="cpu")
    xt = ft.solve(T(rhs))
    assert rel(j_sls.sls_solve(fj, J(rhs)), xt) <= 1e-12
    assert np.abs(xt.numpy().reshape(-1) - np.linalg.solve(M, rhs.reshape(-1))).max() < 1e-9
    assert t_sls.sls_enquire(ft).tolist() == [-1, -1, -1]


def test_sls_cg():
    """``cg``: the JAX while loop's answer; its host reads are one every
    CG_CHECK iterations."""
    A = spd(8, 6)
    b = np.random.default_rng(7).normal(size=8)
    fj = j_sls.sls_factorize(lambda v: J(A) @ v, j_sls.SLSControl(solver="cg"))
    At = T(A)
    ft = t_sls.sls_factorize(lambda v: At @ v, t_sls.SLSControl(solver="cg"), device="cpu")
    xt = ft.solve(T(b))
    assert rel(j_sls.sls_solve(fj, J(b)), xt) <= 1e-12
    assert 1 <= ft.host_reads <= 256 // t_sls.CG_CHECK
    assert t_sls.sls_enquire(ft).tolist() == [-1, -1, -1]


# ---------------------------------------------------------------------------
# PSLS

KINDS = ["none", "diagonal", "band", "reordered_band", "full", "full_se", "full_gmps",
         "lin_more", "mi28", "munksgaard"]


@pytest.mark.parametrize("kind", KINDS)
def test_psls_menu(kind):
    """Each preconditioner on a definite and an indefinite H, at the default
    semi-bandwidth (5) and at 2."""
    tol = 1e-10 if kind == "full_gmps" else 1e-12
    r = np.random.default_rng(1)
    v = r.normal(size=12)
    for H in (spd(12, 0), spd(12, 3, definite=False)):
        for sb in (5, 2):
            aj = j_psls.psls_build(J(H), j_psls.PSLSControl(preconditioner=kind,
                                                             semi_bandwidth=sb))
            at = t_psls.psls_build(H, t_psls.PSLSControl(preconditioner=kind,
                                                         semi_bandwidth=sb), device="cpu")
            assert rel(aj(J(v)), at(T(v))) <= tol, sb


def test_psls_remove():
    n = 15
    H = spd(n, 7)
    rem = [2, 9, 13]
    v = np.random.default_rng(8).normal(size=n)
    for kind in ("full", "band"):
        aj = j_psls.psls_build(J(H), j_psls.PSLSControl(preconditioner=kind))
        at = t_psls.psls_build(H, t_psls.PSLSControl(preconditioner=kind), device="cpu")
        xj = j_psls.psls_remove(aj, n, jnp.array(rem))(J(v))
        xt = t_psls.psls_remove(at, n, rem, device="cpu")(T(v))
        assert rel(xj, xt) <= 1e-12
        assert np.abs(xt.numpy()[rem]).max() == 0.0


# ---------------------------------------------------------------------------
# SCU


def test_scu_sequence():
    """Append four borders, delete one, append, refresh; each solve against
    the JAX state's, and the states equal."""
    r = np.random.default_rng(0)
    n, cap = 8, 6
    A = spd(n, 11)
    Aj, At = J(A), T(A)
    sj = j_scu.scu_setup(n, cap)
    st = t_scu.scu_setup(n, cap, device="cpu")
    solve_j = lambda b: jnp.linalg.solve(Aj, b)       # noqa: E731
    solve_t = lambda b: torch.linalg.solve(At, b)      # noqa: E731

    def check():
        b1, b2 = r.normal(size=n), r.normal(size=cap)
        xj = j_scu.scu_solve(sj, solve_j, J(b1), J(b2))
        xt = t_scu.scu_solve(st, solve_t, T(b1), T(b2))
        assert rel(xj[0], xt[0]) <= 1e-12 and rel(xj[1], xt[1]) <= 1e-12
        assert int(sj.count) == int(st.count)
        for k in ("B", "C", "D", "S", "W"):
            assert rel(getattr(sj, k), getattr(st, k)) <= 1e-12, k

    for step in ("a", "a", "a", "a", "d1", "a", "r", "d3", "d0"):
        if step == "a":
            b, c, d = r.normal(size=n), r.normal(size=n), float(r.uniform(3, 5))
            sj = j_scu.scu_append(sj, solve_j, J(b), J(c), d)
            st = t_scu.scu_append(st, solve_t, T(b), T(c), d)
        elif step == "r":
            sj = j_scu.scu_refresh(sj, solve_j)
            st = t_scu.scu_refresh(st, solve_t)
        else:
            sj = j_scu.scu_delete(sj, solve_j, int(step[1]))
            st = t_scu.scu_delete(st, solve_t, int(step[1]))
        check()
    # the JAX state carried across gives the same next solve
    carried = scu_state_from_numpy(dict(
        B=np.asarray(sj.B), C=np.asarray(sj.C), D=np.asarray(sj.D), S=np.asarray(sj.S),
        W=np.asarray(sj.W), count=int(sj.count), cap=cap, n=n), device="cpu")
    b1, b2 = r.normal(size=n), r.normal(size=cap)
    assert rel(j_scu.scu_solve(sj, solve_j, J(b1), J(b2))[0],
               t_scu.scu_solve(carried, solve_t, T(b1), T(b2))[0]) <= 1e-12


# ---------------------------------------------------------------------------
# ULS, MIQR, IR, FDC


def test_uls():
    r = np.random.default_rng(4)
    A = r.normal(size=(9, 9))
    b = r.normal(size=9)
    fj = j_uls.uls_factorize(J(A))
    ft = t_uls.uls_factorize(A, device="cpu")
    for trans in (False, True):
        for with_A in (None, A):
            xj = j_uls.uls_solve(fj, J(b), None if with_A is None else J(A), trans=trans)
            xt = t_uls.uls_solve(ft, T(b), None if with_A is None else T(A), trans=trans)
            assert rel(xj, xt) <= 1e-12
    rj, lo_j, hi_j = j_uls.uls_enquire(fj)
    rt, lo_t, hi_t = t_uls.uls_enquire(ft)
    assert int(rj) == int(rt) == 9
    assert rel(lo_j, lo_t) <= 1e-12 and rel(hi_j, hi_t) <= 1e-12
    S = A.copy()
    S[:, 3] = S[:, 1] + S[:, 2]                # singular: rank 8
    assert int(t_uls.uls_factorize(S, device="cpu").rank) == int(
        j_uls.uls_factorize(J(S)).rank)


def test_uls_find_basis():
    """The same basis as the JAX package, with planted dependent columns."""
    r = np.random.default_rng(5)
    for m, n, dep in ((4, 9, 0), (6, 12, 2), (5, 5, 1)):
        A = r.normal(size=(m, n))
        for k in range(dep):
            A[k] = A[-1] * (k + 2.0)          # dependent rows: rank m - dep
        bj = j_uls.uls_find_basis(A)
        bt = t_uls.uls_find_basis(T(A))
        assert bj[2] == bt[2] == m - dep
        assert np.array_equal(bj[0], bt[0]) and np.array_equal(bj[1], bt[1])


def test_miqr():
    r = np.random.default_rng(6)
    A = r.normal(size=(30, 12))
    A[:, 5] = A[:, 0] + 1e-3 * r.normal(size=30)
    for ctl in ({}, dict(max_levels=1), dict(angle_tol=0.5)):
        fj = j_miqr.miqr_form(A, j_miqr.MIQRControl(**ctl))
        ft = t_miqr.miqr_form(A, t_miqr.MIQRControl(**ctl), device="cpu")
        assert np.array_equal(np.asarray(fj.perm), ft.perm.numpy())
        y = r.normal(size=12)
        assert rel(j_miqr.miqr_apply(fj, J(y)), t_miqr.miqr_apply(ft, T(y))) <= 1e-12
        assert rel(j_miqr.miqr_apply_transpose(fj, J(y)),
                   t_miqr.miqr_apply_transpose(ft, T(y))) <= 1e-12


def test_ir():
    A = spd(10, 2)
    Ap = A + 0.05 * np.eye(10)                 # the approximate operator
    b = np.random.default_rng(3).normal(size=10)
    Aj, Apj, At, Apt = J(A), J(Ap), T(A), T(Ap)
    for sweeps in (0, 2, 4):
        xj, nj = j_ir.ir_solve(lambda v: Aj @ v, lambda v: jnp.linalg.solve(Apj, v), J(b),
                               j_ir.IRControl(itref_max=sweeps))
        xt, nt = t_ir.ir_solve(lambda v: At @ v, lambda v: torch.linalg.solve(Apt, v), T(b),
                               t_ir.IRControl(itref_max=sweeps))
        assert rel(xj, xt) <= 1e-12 and abs(float(nj) - float(nt)) <= 1e-12 * max(1, float(nj))


def test_fdc():
    """The same dependent set (planted dependent rows, one inconsistent)."""
    r = np.random.default_rng(7)
    for m, n, planted, bad in ((6, 10, (4, 5), None), (8, 12, (2, 7), 7), (5, 5, (), None)):
        A = r.normal(size=(m, n))
        x = r.normal(size=n)
        for i in planted:
            A[i] = A[0] - 2.0 * A[1] + (0.5 * A[3] if i > 3 else 0.0)
        b = A @ x
        if bad is not None:
            b[bad] += 1.0
        ij = j_fdc.fdc_find_dependent(J(A), J(b))
        it = t_fdc.fdc_find_dependent(A, b, device="cpu")
        assert np.array_equal(np.asarray(ij.independent), it.independent.numpy())
        assert int(ij.n_dependent) == int(it.n_dependent) == len(planted)
        assert bool(ij.inconsistent) == bool(it.inconsistent) == (bad is not None)


# ---------------------------------------------------------------------------
# MOP, CONVERT


def coo_case(seed=0, m=7, n=9, ne=25):
    r = np.random.default_rng(seed)
    return (r.integers(0, m, ne).astype(np.int32), r.integers(0, n, ne).astype(np.int32),
            r.normal(size=ne), m, n)


def test_mop():
    row, col, val, m, n = coo_case()
    x, y = np.random.default_rng(1).normal(size=n), np.random.default_rng(2).normal(size=m)
    assert rel(j_mop.coo_Ax(row, col, J(val), J(x), m),
               t_mop.coo_Ax(row, col, T(val), T(x), m)) <= 1e-12
    assert rel(j_mop.coo_Aty(row, col, J(val), J(y), n),
               t_mop.coo_Aty(row, col, T(val), T(y), n)) <= 1e-12
    lo = row >= col % m
    sr, sc = np.maximum(row, col % m)[lo], np.minimum(row, col % m)[lo]
    assert rel(j_mop.coo_Ax(sr, sc, J(val[lo]), J(x[:m]), m, symmetric=True),
               t_mop.coo_Ax(sr, sc, T(val[lo]), T(x[:m]), m, symmetric=True)) <= 1e-12
    for ord_ in (np.inf, 1, 2):
        # two empty rows: -inf (ord inf) or 0, as the JAX package's reductions give
        rj = np.asarray(j_mop.coo_row_norms(row, col, J(val), m + 2, ord_))
        rt = t_mop.coo_row_norms(row, col, T(val), m + 2, ord_).numpy()
        assert np.array_equal(rj[m:], rt[m:]) and rel(rj[:m], rt[:m]) <= 1e-12
        cj = np.asarray(j_mop.coo_col_norms(row, col, J(val), n, ord_))
        ct = t_mop.coo_col_norms(row, col, T(val), n, ord_).numpy()
        fin = np.isfinite(cj)                  # column 8 is empty
        assert np.array_equal(cj[~fin], ct[~fin]) and rel(cj[fin], ct[fin]) <= 1e-12
    rs, cs = np.linspace(1, 2, m), np.linspace(2, 3, n)
    assert rel(j_mop.coo_scale(row, col, J(val), J(rs), J(cs)),
               t_mop.coo_scale(row, col, T(val), T(rs), T(cs))) <= 1e-12
    assert rel(j_mop.coo_extract_diagonal(row, col, J(val), 7),
               t_mop.coo_extract_diagonal(row, col, T(val), 7)) <= 1e-12


def test_convert():
    row, col, val, m, n = coo_case(3)
    cj = j_convert.COO(m, n, row, col, val)
    ct = t_convert.COO(m, n, row, col, val)
    for fn in ("coo_to_csr",):
        a, b = getattr(j_convert, fn)(cj), getattr(t_convert, fn)(ct)
        assert all(np.array_equal(u, v) for u, v in zip(a[2:], b[2:]))
    csr_j, csr_t = j_convert.coo_to_csr(cj), t_convert.coo_to_csr(ct)
    for a, b in ((j_convert.csr_to_csc(csr_j), t_convert.csr_to_csc(csr_t)),
                 (j_convert.csr_to_coo(csr_j), t_convert.csr_to_coo(csr_t))):
        assert a[:2] == b[:2] and all(np.array_equal(u, v) for u, v in zip(a[2:], b[2:]))
    assert np.array_equal(j_convert.coo_to_dense(cj), t_convert.coo_to_dense(ct))
    assert np.array_equal(j_convert.csr_to_dense(csr_j), t_convert.csr_to_dense(csr_t))
    M = t_convert.coo_to_dense(ct)
    assert all(np.array_equal(u, v) for u, v in zip(j_convert.dense_to_csr(M, 0.1)[2:],
                                                     t_convert.dense_to_csr(M, 0.1)[2:]))
    lo = row >= col % m
    sj = j_convert.COO(m, m, row[lo], (col % m)[lo], val[lo])
    st = t_convert.COO(m, m, row[lo], (col % m)[lo], val[lo])
    assert all(np.array_equal(u, v) for u, v in zip(j_convert.symmetric_expand(sj)[2:],
                                                     t_convert.symmetric_expand(st)[2:]))
    assert np.array_equal(j_convert.band_from_coo(sj), t_convert.band_from_coo(st))


# ---------------------------------------------------------------------------
# SBLS: the G menu, null-space mode, projected PCG, Fredholm alternative


def test_sbls_preconditioner_menu():
    H = spd(7, 1)
    for kind in ("identity", "full", "diag_h", "band_h"):
        Gj, dj = j_sbls.sbls_preconditioner(J(H), kind, semi_bandwidth=2)
        Gt, dt = t_sbls.sbls_preconditioner(H, kind, semi_bandwidth=2, device="cpu")
        assert dj == dt and rel(Gj, Gt) == 0.0
    D = np.arange(1.0, 8.0)
    Gt, dt = t_sbls.sbls_preconditioner(H, "user_d", D=D, device="cpu")
    assert dt and np.array_equal(Gt.numpy(), D)


def test_sbls_nullspace():
    n, m = 11, 4
    r = np.random.default_rng(0)
    G, A, b = spd(n, 9), r.normal(size=(m, n)), r.normal(size=n + m)
    fj = j_sbls.sbls_factorize_nullspace(J(G), J(A))
    ft = t_sbls.sbls_factorize_nullspace(G, A, device="cpu")
    assert np.array_equal(fj.basic, ft.basic.numpy())
    xj, yj = j_sbls.sbls_solve_nullspace(fj, J(b[:n]), J(b[n:]))
    xt, yt = t_sbls.sbls_solve_nullspace(ft, T(b[:n]), T(b[n:]))
    assert rel(xj, xt) <= 1e-12 and rel(yj, yt) <= 1e-12
    with pytest.raises(ValueError, match="rank deficient"):
        t_sbls.sbls_factorize_nullspace(G, np.vstack([A, A[:1]]), device="cpu")


def test_sbls_projected_pcg():
    """The same iterates and count as the JAX package's two while loops."""
    n, m = 10, 3
    r = np.random.default_rng(2)
    G, A, b = spd(n, 10), r.normal(size=(m, n)), r.normal(size=n + m)
    sol = np.linalg.solve(np.block([[G, A.T], [A, np.zeros((m, m))]]), b)
    for kind, stop in (("diag_h", 1e-12), ("identity", 1e-12), ("band_h", 1e-12)):
        Gpj, dj = j_sbls.sbls_preconditioner(J(G), kind, semi_bandwidth=1)
        fj = j_sbls.sbls_factorize(Gpj, J(A), jnp.zeros(m), g_is_diag=dj, delta=1e-12)
        xj, yj, kj = j_sbls.sbls_solve_iterative(fj, lambda v: J(G) @ v, J(b[:n]),
                                                 J(b[n:]), stop_rel=stop)
        Gpt, dt = t_sbls.sbls_preconditioner(G, kind, semi_bandwidth=1, device="cpu")
        ft = t_sbls.sbls_factorize(Gpt, T(A), torch.zeros(m, dtype=torch.float64),
                                   g_is_diag=dt, delta=1e-12)
        Gt = T(G)
        xt, yt, kt = t_sbls.sbls_solve_iterative(ft, lambda v: Gt @ v, T(b[:n]), T(b[n:]),
                                                 stop_rel=stop)
        assert int(kj) == int(kt), kind
        # the answer is as good as the stop test makes it: where the JAX
        # package's own error is larger than 1e-7 (the identity G: 4e-7),
        # the two stay within a thousandth of it (found: 2.4e-10)
        err = max(1e-7, np.abs(np.asarray(xj) - sol[:n]).max())
        assert rel(xj, xt) <= 1e-3 * err and rel(yj, yt) <= 1e-3 * err, kind


def test_sbls_fredholm():
    n, m = 6, 2
    r = np.random.default_rng(3)
    G = spd(n, 12)
    A = np.vstack([r.normal(size=n), np.zeros(n)])
    K = np.block([[G, A.T], [A, np.zeros((m, m))]])
    b_ok = K @ r.normal(size=n + m)
    b_bad = b_ok + np.concatenate([np.zeros(n), [0.0, 1.0]])
    for b in (b_ok, b_bad):
        sj, (xj, yj) = j_sbls.sbls_fredholm_alternative(J(G), J(A), jnp.zeros(m),
                                                        J(b[:n]), J(b[n:]))
        st, (xt, yt) = t_sbls.sbls_fredholm_alternative(G, A, np.zeros(m), b[:n], b[n:],
                                                        device="cpu")
        assert bool(sj) == bool(st)
        assert rel(np.abs(np.asarray(xj)), xt.abs()) <= 1e-10
        assert rel(np.abs(np.asarray(yj)), yt.abs()) <= 1e-10
    assert not bool(st)
