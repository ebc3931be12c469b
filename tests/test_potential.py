"""Misfit/gradient provider tests.

The reference's hand-coded analytic gradients
(reference: inversion/potential.py:688-810) are re-derived here directly
from its formulas and compared against our autodiff gradients — per
SURVEY.md §4(c), autodiff-vs-analytic replaces the reference's untested
gradient code.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from gravinv3dhmc import mesher, utils
from gravinv3dhmc.inversion.potential import (
    GravMagModule,
    logistic_to_mw,
    mw_to_logistic,
    sensitivity_weighting,
)
from gravinv3dhmc.ops import fd, prism


@pytest.fixture(scope="module")
def small_problem():
    """20x10x5 cartesian problem with synthetic data."""
    bounds = (0, 1000, 0, 2000, 0, 500)
    spacing = (100, 100, 100)
    mesh = mesher.PrismMesh(bounds, spacing)
    rng = np.random.RandomState(3)
    rho = np.zeros(mesh.size)
    rho[mesh.size // 2: mesh.size // 2 + 20] = 1.0
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular((0, 1000, 0, 2000), (10, 20), z=-1.0)
    dobs, _ = prism.gz(xo, yo, zo, mesh)
    dobs = dobs + rng.normal(0, 0.02 * dobs.max(), dobs.size)
    module = GravMagModule(dobs, bounds, spacing, (xo, yo, zo),
                           coordinate="cartesian", field="gravity",
                           dtype=jnp.float64, verbose=False)
    return module, rho


def reference_grad(module, mw, mwapr, alpha, regularization, beta):
    """The reference's analytic gradient formulas, re-derived from
    inversion/potential.py:688-810 in f64 numpy."""
    Aw = module.Aw
    dobs = module.dobs
    dpre = Aw @ mw
    r = (dpre - dpre.mean()) - (dobs - dobs.mean())
    data_grad = 2 * Aw.T @ r
    dm = mw - mwapr
    wm_sq = module.wdiag ** 2
    if regularization == "Damping":
        model_grad = 2 * dm
    elif regularization == "MS":
        model_grad = 2 * beta * wm_sq * dm / (dm ** 2 + beta) ** 2
    elif regularization == "Smoothness":
        R = fd.fd3d_matrix(module.mshape)
        model_grad = 2 * R.T @ (R @ dm)
    elif regularization == "TV":
        R = fd.fd3d_matrix(module.mshape)
        t = R @ dm
        model_grad = R.T @ (t / np.sqrt(t ** 2 + beta))
    return data_grad + alpha * model_grad


class TestWeighting:
    def test_column_norm_weighting(self, small_problem):
        module, _ = small_problem
        col_norms = np.linalg.norm(module.A, axis=0)
        np.testing.assert_allclose(module.wdiag, col_norms, rtol=1e-12)
        np.testing.assert_allclose(
            np.linalg.norm(module.Aw, axis=0), 1.0, rtol=1e-10)

    def test_zero_column_safe(self):
        A = np.array([[1.0, 0.0], [2.0, 0.0]])
        Aw, wdiag, wdiag_inv = sensitivity_weighting(A)
        assert wdiag_inv[1] == 0.0
        assert np.isfinite(Aw).all()


@pytest.mark.parametrize("regularization,beta", [
    ("Damping", 0.01), ("MS", 0.001), ("Smoothness", 0.01), ("TV", 0.001),
])
def test_autodiff_matches_reference_analytic(small_problem, regularization,
                                             beta):
    module, _ = small_problem
    M = module.n_active
    rng = np.random.RandomState(7)
    mw = rng.uniform(0.1, 0.9, M)
    mwapr = np.full(M, 0.001)
    low = np.zeros(M)
    high = np.ones(M)
    alpha = 0.7
    fn = module.make_potential(mwapr, low, high, constraint="mandatory",
                               regularization=regularization, beta=beta,
                               dtype=jnp.float64)
    u, g, (dpre, u_data, u_model) = fn(mw, alpha)
    expected = reference_grad(module, mw, mwapr, alpha, regularization, beta)
    np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-8, atol=1e-10)
    # value parity
    Aw = module.Aw
    pre = Aw @ mw
    r = (pre - pre.mean()) - (module.dobs - module.dobs.mean())
    assert float(u_data) == pytest.approx(float(r @ r), rel=1e-10)


def test_misfit_and_grad_reference_api(small_problem):
    module, _ = small_problem
    M = module.n_active
    mw = np.full(M, 0.5)
    mwapr = np.full(M, 0.0)
    low, high = np.zeros(M), np.ones(M)
    u, g, dpre, ud, um = module.misfit_and_grad(
        mw, mwapr, low, high, "mandatory", 1000.0, 1.0, "Damping", 0.01)
    assert np.isfinite(u)
    assert g.shape == (M,)
    assert u == pytest.approx(ud + 1.0 * um, rel=1e-8)


def test_logistic_transform_roundtrip():
    low = np.zeros(5)
    high = np.ones(5)
    mw = np.array([0.1, 0.3, 0.5, 0.7, 0.9])
    x = mw_to_logistic(mw, low, high, 100.0)
    back = logistic_to_mw(jnp.asarray(x), jnp.asarray(low), jnp.asarray(high),
                          100.0)
    np.testing.assert_allclose(np.asarray(back), mw, rtol=1e-6)


def test_logarithmic_constraint_grad_chains_jacobian(small_problem):
    """Unlike the reference (which omits the transform Jacobian,
    inversion/potential.py:812-845), our gradient is d U/d x."""
    module, _ = small_problem
    M = module.n_active
    rng = np.random.RandomState(1)
    x = rng.normal(0, 0.001, M)
    mwapr = np.full(M, 0.001)
    low, high = np.zeros(M), np.ones(M)
    fn = module.make_potential(mwapr, low, high, constraint="logarithmic",
                               log_factor=1000.0, regularization="Damping",
                               dtype=jnp.float64)
    u0, g, _ = fn(x, 1.0)
    # finite-difference check in x-space
    eps = 1e-7
    for i in [0, M // 2]:
        xp = x.copy(); xp[i] += eps
        xm = x.copy(); xm[i] -= eps
        up, _, _ = fn(xp, 1.0)
        um_, _, _ = fn(xm, 1.0)
        fdg = (float(up) - float(um_)) / (2 * eps)
        assert float(g[i]) == pytest.approx(fdg, rel=1e-4, abs=1e-6)


def test_chain_batching(small_problem):
    module, _ = small_problem
    M = module.n_active
    rng = np.random.RandomState(2)
    xb = rng.uniform(0.2, 0.8, (4, M))
    mwapr = np.zeros(M)
    low, high = np.zeros(M), np.ones(M)
    fn = module.make_potential(mwapr, low, high, regularization="Damping",
                               dtype=jnp.float64)
    ub, gb, (dpre_b, ud_b, um_b) = fn(xb, 0.5)
    assert ub.shape == (4,)
    assert gb.shape == (4, M)
    u0, g0, _ = fn(xb[0], 0.5)
    np.testing.assert_allclose(np.asarray(ub[0]), np.asarray(u0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gb[0]), np.asarray(g0), rtol=1e-12)


def test_wavelet_3d_path_matches_dense(small_problem):
    module, _ = small_problem
    bounds = module.mrange
    xo, yo, zo = module.lonobs, module.latobs, module.heightobs
    wmod = GravMagModule(module.dobs, bounds, module.mspacing, (xo, yo, zo),
                         coordinate="cartesian", field="gravity",
                         wavelet="3D", dtype=jnp.float64, verbose=False)
    M = wmod.n_active
    mw = np.random.RandomState(5).uniform(0, 1, M)
    mwapr = np.zeros(M)
    low, high = np.zeros(M), np.ones(M)
    fn_dense = wmod.make_potential(mwapr, low, high, use_wavelet=False,
                                   dtype=jnp.float64)
    fn_wav = wmod.make_potential(mwapr, low, high, use_wavelet="3D",
                                 dtype=jnp.float64)
    u_d, g_d, _ = fn_dense(mw, 1.0)
    u_w, g_w, _ = fn_wav(mw, 1.0)
    # thresholded operator: close but not identical
    assert float(u_w) == pytest.approx(float(u_d), rel=2e-2)
    corr = np.corrcoef(np.asarray(g_d), np.asarray(g_w))[0, 1]
    assert corr > 0.999


def test_fixed_cells_shift_prediction(small_problem):
    module, _ = small_problem
    fix = np.ones(module.dobs.size) * 3.0
    m2 = GravMagModule(module.dobs, module.mrange, module.mspacing,
                       (module.lonobs, module.latobs, module.heightobs),
                       fixed=True, grav_fix=fix, dtype=jnp.float64,
                       verbose=False)
    M = m2.n_active
    mw = np.zeros(M)
    fn = m2.make_potential(np.zeros(M), np.zeros(M), np.ones(M),
                           regularization="Damping", dtype=jnp.float64)
    # constant shift is removed by the mean-centred residual
    u, _, (dpre, ud, um) = fn(mw, 0.0)
    r = -(module.dobs - module.dobs.mean())
    assert float(ud) == pytest.approx(float(r @ r), rel=1e-10)
