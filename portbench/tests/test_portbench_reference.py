"""The plain reference on QPs whose solutions are worked out by hand."""
import numpy as np
import scipy.sparse as sp

from portbench import reference


def small_qp():
    """min 1/2 (x0^2 + x1^2) - x0 - 3 x1  s.t.  x0 + x1 <= 2, 0 <= x <= 10.
    The unconstrained minimiser (1, 3) violates the row; on x0 + x1 = 2,
    x = (0, 2) with y = -1 (the row at its upper bound) and z = (-1 + 1 ... )
    worked below."""
    H = sp.csr_matrix(np.eye(2))
    A = sp.csr_matrix(np.array([[1.0, 1.0]]))
    return dict(H=H, A=A, g=np.array([-1.0, -3.0]), c_l=np.array([-np.inf]),
                c_u=np.array([2.0]), x_l=np.zeros(2), x_u=np.full(2, 10.0))


def solution():
    # stationarity H x + g - A'y - z = 0 at x = (0, 2): (0 - 1 - y - z0, 2 - 3 - y) = 0
    # gives y = -1 and z0 = 0: x0 = 0 sits on its bound with a zero multiplier
    return np.array([0.0, 2.0]), np.array([-1.0]), np.array([0.0, 0.0])


def test_the_solution_has_no_error():
    x, y, z = solution()
    err = reference.kkt_errors(small_qp(), x, y, z)
    assert err == dict(kkt=0.0, primal=0.0, dual=0.0, complementarity=0.0)
    v = reference.judge(small_qp(), dict(x=x, y=y, z=z, status=0), dict(kkt=1e-12))
    assert v["ok"]


def test_each_kind_of_error_is_seen():
    p = small_qp()
    x, y, z = solution()
    assert reference.kkt_errors(p, x + [0.0, 0.5], y, z)["primal"] == 0.5
    assert reference.kkt_errors(p, x, y - 0.25, z)["dual"] == 0.25
    # a row multiplier of the wrong sign for a row with no lower bound
    assert reference.kkt_errors(p, x, -y, z)["dual"] >= 1.0
    # x1 = 1.5 leaves the row slack 0.5 with y = -1: complementarity 0.5
    e = reference.kkt_errors(p, np.array([0.0, 1.5]), y, z)
    assert e["complementarity"] == 0.5


def test_judge_fails_status_shape_and_nan():
    p = small_qp()
    x, y, z = solution()
    lim = dict(kkt=1e-6)
    assert not reference.judge(p, dict(x=x, y=y, z=z, status=-18), lim)["ok"]
    assert not reference.judge(p, dict(x=x[:1], y=y, z=z, status=0), lim)["ok"]
    assert not reference.judge(p, dict(x=x * np.nan, y=y, z=z, status=0), lim)["ok"]
    assert not reference.judge(p, dict(x=x + 1e-3, y=y, z=z, status=0), lim)["ok"]


def test_lp_with_h_none():
    # min -x0 - x1 s.t. x0 + x1 >= 1, 0 <= x <= 2: x = (2, 2), y = 0, z = g
    p = dict(H=None, A=sp.csr_matrix(np.ones((1, 2))), g=np.array([-1.0, -1.0]),
             c_l=np.array([1.0]), c_u=np.array([np.inf]), x_l=np.zeros(2), x_u=np.full(2, 2.0))
    assert reference.kkt_errors(p, np.full(2, 2.0), np.zeros(1), np.full(2, -1.0))["kkt"] == 0.0
