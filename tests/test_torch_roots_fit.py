"""The port's ROOTS and FIT modules (galahad_tpu_torch/core/roots.py, fit.py)
against the JAX package's on the same numpy inputs.

What is held: the count of real roots equal, and every real root within
1e-10 relative (to max(1, |root|)), with the +inf padding in the same
slots; ``smallest_positive_root`` likewise; every FIT function within
1e-12 relative.  Cases: seeded random coefficients of each degree, and the
degenerate ones (a4 = 0, a3 = a4 = 0, double roots, no real roots, a
biquadratic whose resolvent gives s -> 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.core import fit as j_fit
from galahad_tpu.core import roots as j_roots

from galahad_tpu_torch.core import fit as t_fit
from galahad_tpu_torch.core import roots as t_roots

ROOT_TOL = 1e-10
FIT_TOL = 1e-12


def same_roots(jout, tout):
    jn, jr = (np.asarray(a) for a in jout)
    tn, tr = (a.numpy() for a in tout)
    np.testing.assert_array_equal(tn, jn)
    fin = np.isfinite(jr)
    np.testing.assert_array_equal(np.isfinite(tr), fin)
    err = np.abs(tr[fin] - jr[fin]) / np.maximum(1.0, np.abs(jr[fin]))
    assert err.max(initial=0.0) <= ROOT_TOL
    jp = np.asarray(j_roots.smallest_positive_root(*(jnp.asarray(a) for a in jout)))
    tp = t_roots.smallest_positive_root(*tout).numpy()
    np.testing.assert_array_equal(np.isfinite(tp), np.isfinite(jp))
    f = np.isfinite(jp)
    assert (np.abs(tp[f] - jp[f]) / np.maximum(1.0, np.abs(jp[f]))).max(initial=0.0) <= ROOT_TOL


def both(name, coeffs):
    jf = getattr(j_roots, name)
    tf = getattr(t_roots, name)
    return (jf(*(jnp.asarray(c) for c in coeffs)),
            tf(*(torch.as_tensor(np.asarray(c, np.float64)) for c in coeffs)))


@pytest.mark.parametrize("name,degree", [("roots_quadratic", 2), ("roots_cubic", 3),
                                         ("roots_quartic", 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_coefficients(name, degree, seed):
    """Coefficients within about two decades of each other.  (With four or
    more decades between them, Ferrari's closed form is ill-conditioned in
    both packages: their quartic roots then differ from each other, and from
    numpy's eigenvalue roots, by far more than 1e-10.)"""
    rng = np.random.default_rng(seed)
    coeffs = [rng.normal(size=2000) * 10.0 ** rng.uniform(-1, 1, 2000)
              for _ in range(degree + 1)]
    same_roots(*both(name, coeffs))


@pytest.mark.parametrize("seed", [0, 1])
def test_quartic_with_known_real_roots(seed):
    """Quartics built from four real roots (of either sign) and a scale."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-5, 5, (300, 4))
    s = rng.uniform(0.1, 10, 300)
    c = np.stack([np.polynomial.polynomial.polyfromroots(row) for row in r]) * s[:, None]
    same_roots(*both("roots_quartic", [c[:, k] for k in range(5)]))


DEGENERATE = {
    # (x-1)(x-2)(x-3), a4 = 0
    "a4_zero": [[-6.0], [11.0], [-6.0], [1.0], [0.0]],
    # (x-1)(x-2), a3 = a4 = 0
    "a3_a4_zero": [[2.0], [-3.0], [1.0], [0.0], [0.0]],
    # (x-1)^2 (x-3)^2
    "double_roots": [[9.0], [-24.0], [22.0], [-8.0], [1.0]],
    # (x^2+1)(x^2+4)
    "no_real_roots": [[4.0], [0.0], [5.0], [0.0], [1.0]],
    # x^4 - 5 x^2 + 4 = (x^2-1)(x^2-4): q = 0, the biquadratic branch
    "biquadratic": [[4.0], [0.0], [-5.0], [0.0], [1.0]],
    # x^4 + 2 x^2 + 1 = (x^2+1)^2: s -> 0 with no real root
    "biquadratic_none": [[1.0], [0.0], [2.0], [0.0], [1.0]],
    # linear and constant step polynomials, as the arc's first orders give
    "linear": [[0.5], [-2.0], [0.0], [0.0], [0.0]],
    "constant": [[0.5], [0.0], [0.0], [0.0], [0.0]],
}


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_degenerate_quartics(case):
    same_roots(*both("roots_quartic", [np.asarray(c, np.float64) for c in DEGENERATE[case]]))


@pytest.mark.parametrize("case", ["double", "triple", "no_real_pair", "a3_zero"])
def test_degenerate_cubics_and_quadratics(case):
    cubic = dict(double=[-4.0, 8.0, -5.0, 1.0],        # (x-1)(x-2)^2
                 triple=[-1.0, 3.0, -3.0, 1.0],         # (x-1)^3
                 no_real_pair=[-1.0, 1.0, -1.0, 1.0],   # (x-1)(x^2+1)
                 a3_zero=[2.0, -3.0, 1.0, 0.0])[case]
    jout, tout = both("roots_cubic", [np.asarray([c]) for c in cubic])
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    # a triple root is only determined to ~eps^(1/3): hold it to that
    tol = 1e-4 if case == "triple" else ROOT_TOL
    jr, tr = np.asarray(jout[1]), tout[1].numpy()
    fin = np.isfinite(jr)
    np.testing.assert_array_equal(np.isfinite(tr), fin)
    assert np.abs(tr[fin] - jr[fin]).max() <= tol
    for quad in ([1.0, -2.0, 1.0], [1.0, 0.0, 1.0], [-4.0, 2.0, 0.0], [3.0, 0.0, 0.0],
                 [1.0, -1.0e8, 1.0]):
        same_roots(*both("roots_quadratic", [np.asarray([c]) for c in quad]))


def test_polynomial_roots_newton():
    c = [24.0, -50.0, 35.0, -10.0, 1.0]
    x0 = np.array([0.8, 2.2, 3.1, 4.4])
    jr = np.asarray(j_roots.polynomial_roots_newton([jnp.asarray(v) for v in c],
                                                    jnp.asarray(x0), iters=8))
    tr = t_roots.polynomial_roots_newton(
        [torch.tensor(v, dtype=torch.float64) for v in c], torch.as_tensor(x0), iters=8).numpy()
    np.testing.assert_allclose(tr, jr, rtol=ROOT_TOL, atol=0)


# ---------------------------------------------------------------------------
# FIT
# ---------------------------------------------------------------------------


def close(t, j):
    j = np.asarray(j)
    assert np.abs(t.numpy() - j).max() <= FIT_TOL * max(1.0, np.abs(j).max())


@pytest.mark.parametrize("shape", [(3,), (5, 4), (2, 3, 5)])
def test_fit_functions(shape):
    rng = np.random.default_rng(len(shape))
    derivs = rng.normal(size=shape)
    t = 0.37
    close(t_fit.hermite_coefficients(torch.as_tensor(derivs)),
          j_fit.hermite_coefficients(jnp.asarray(derivs)))
    close(t_fit.polyval(torch.as_tensor(derivs), t), j_fit.polyval(jnp.asarray(derivs), t))
    close(t_fit.polyval(torch.as_tensor(derivs), torch.tensor(t, dtype=torch.float64)),
          j_fit.polyval(jnp.asarray(derivs), jnp.asarray(t)))
    pc_t = t_fit.puiseux_coefficients(torch.as_tensor(derivs))
    pc_j = j_fit.puiseux_coefficients(jnp.asarray(derivs))
    close(pc_t, pc_j)
    close(t_fit.puiseux_eval(pc_t, t), j_fit.puiseux_eval(pc_j, t))
    alphas = np.sort(rng.uniform(0, 2, shape[-1])) + np.arange(shape[-1])
    values = rng.normal(size=shape)
    nc_t = t_fit.hermite_interpolation(torch.as_tensor(alphas), torch.as_tensor(values))
    nc_j = j_fit.hermite_interpolation(jnp.asarray(alphas), jnp.asarray(values))
    close(nc_t, nc_j)
    close(t_fit.newton_eval(torch.as_tensor(alphas), nc_t, t),
          j_fit.newton_eval(jnp.asarray(alphas), nc_j, t))
