"""NUTS + warmup adaptation tests (statistical correctness on analytic
targets, stability on the inversion potential)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import random

from gravinv3dhmc.inversion import nuts


def test_nuts_recovers_anisotropic_gaussian():
    scales = jnp.asarray(np.array([0.2, 1.0, 5.0]), jnp.float32)

    def pot(x):
        return 0.5 * jnp.sum((x / scales) ** 2), x / scales ** 2

    run = jax.jit(lambda x0, key: nuts.run_nuts(
        pot, x0, key, n_warmup=300, n_samples=600, step_size0=0.5,
        max_depth=8))
    xs, stats = run(jnp.zeros(3), random.PRNGKey(0))
    xs = np.asarray(xs)
    rel = np.abs(xs.std(axis=0) / np.asarray(scales) - 1)
    assert (rel < 0.3).all()
    assert int(np.asarray(stats["divergences"]).sum()) == 0
    # mass matrix approximates the marginal variances
    ratio = np.asarray(stats["inv_mass"]) / np.asarray(scales) ** 2
    assert (ratio > 0.3).all() and (ratio < 3.0).all()


def test_nuts_mean_shift():
    mu = jnp.asarray([3.0, -2.0], jnp.float32)

    def pot(x):
        d = x - mu
        return 0.5 * jnp.sum(d * d), d

    xs, stats = jax.jit(lambda: nuts.run_nuts(
        pot, jnp.zeros(2), random.PRNGKey(1), n_warmup=200, n_samples=500,
        step_size0=0.5, max_depth=6))()
    xs = np.asarray(xs)
    np.testing.assert_allclose(xs.mean(axis=0), np.asarray(mu), atol=0.3)


def test_dual_averaging_targets_accept_rate():
    state = nuts.dual_averaging_init(1.0, target=0.8)
    # feed constant accept = 1 -> eps must grow; accept = 0 -> shrink
    s_hi = state
    for _ in range(50):
        s_hi = nuts.dual_averaging_update(s_hi, jnp.asarray(1.0))
    s_lo = state
    for _ in range(50):
        s_lo = nuts.dual_averaging_update(s_lo, jnp.asarray(0.0))
    assert float(s_hi["log_eps"]) > float(state["log_eps"])
    assert float(s_lo["log_eps"]) < float(state["log_eps"])


def test_welford_matches_numpy():
    rng = np.random.RandomState(0)
    xs = rng.normal(2.0, 3.0, (200, 4))
    state = nuts.welford_init(4)
    for x in xs:
        state = nuts.welford_update(state, jnp.asarray(x))
    var = np.asarray(nuts.welford_variance(state, regularize=False))
    np.testing.assert_allclose(var, xs.var(axis=0, ddof=1), rtol=1e-5)


def test_nuts_sample_on_inversion_problem():
    from gravinv3dhmc import mesher, utils
    from gravinv3dhmc.inversion.nuts import NUTSSample
    from gravinv3dhmc.inversion.potential import GravMagModule
    from gravinv3dhmc.ops import prism

    bounds = (0, 500, 0, 500, 0, 300)
    spacing = (100, 100, 100)
    mesh = mesher.PrismMesh(bounds, spacing)
    rho3 = np.zeros(mesh.shape)
    rho3[0:2, 1:4, 1:4] = 1.0
    mesh.addprop("density", rho3.ravel())
    xo, yo, zo = utils.regular((0, 500, 0, 500), (5, 5), z=0.0)
    dobs, _ = prism.gz(xo, yo, zo, mesh)
    mod = GravMagModule(dobs, bounds, spacing, (xo, yo, zo), verbose=False)
    M = mod.n_active
    bnd = np.stack([np.zeros(M), np.ones(M)], axis=1)
    out = NUTSSample(mod, nsamples=100, nwarmup=200,
                     initial_model=np.full(M, 0.5),
                     aprior_model=np.full(M, 0.001), boundaries=bnd,
                     dobs=dobs, regularization="Damping", nchains=2,
                     log_factor=4.0, step_size0=0.05, max_depth=6)
    assert out["divergences"] < 0.2 * 2 * 100
    assert 0.4 < out["mean_accept"] <= 1.0
    samples = out["samples"]
    assert samples.shape == (2, 100, M)
    assert np.isfinite(samples).all()
    # samples respect the box (logistic transform guarantees it)
    assert samples.min() >= -1e-6
    assert samples.max() <= 1.0 + 1e-6
