"""The shared-L XLA leapfrog against the float64 NumPy reference.

The chunk sampler runs in float64 here and the reference replays its own
random stream (the same per-iteration keys, split the same way), so the
two must agree to rounding: trajectory, momentum refresh, Metropolis
decision and the state kept after a rejection.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from jax import random

from gravinv3dhmc import reference
from gravinv3dhmc.inversion import hmc

LMIN, LMAX, SIGMA = 3, 6, 0.001


def _setup(small_module, regularization, beta=0.001, alpha=1.0):
    module, dobs, _ = small_module
    M = module.n_active
    wdiag = module.wdiag
    aprior = wdiag * np.full(M, 0.001)
    low = wdiag * np.zeros(M)
    high = wdiag * np.ones(M)
    pot = module.make_potential(aprior, low, high, constraint="mandatory",
                                regularization=regularization, beta=beta,
                                dtype=jnp.float64)
    P = pot.params

    def ref_pot(x):
        U, g, _, _ = reference.potential(
            P["Aw"], x, P["dobs_centered"], P["aprior_mw"], P["wm_sq"],
            alpha, regularization, beta)
        return U, g

    return module, dobs, pot, ref_pot, low, high, alpha


def _run_both(small_module, regularization, *, dt, inv_mass=None,
              nchains=4, chunk_size=3, x_scale=0.2, alpha=1.0):
    """One chunk on the device path and the same iterations replayed by
    the reference; returns (device carry, device stats, reference x, U,
    accept history)."""
    module, dobs, pot, ref_pot, low, high, alpha = _setup(
        small_module, regularization, alpha=alpha)
    M = module.n_active
    run_chunk = hmc.make_chunk_sampler(
        pot, dt=dt, Lmin=LMIN, Lmax=LMAX, Sigma=SIGMA, low=low, high=high,
        constraint="mandatory", alpha=alpha, chunk_size=chunk_size,
        nsamples=8, ndraws=0, wdiag_inv=module.wdiag_inv,
        data_size=dobs.size, dtype=jnp.float64, shared_L=True)
    rng = np.random.RandomState(5)
    x0 = module.wdiag * rng.uniform(0.0, x_scale, (nchains, M))
    x = jnp.asarray(x0, jnp.float64)
    U, g, (_, ud, um) = pot(x, alpha)
    carry = (x, U, g, ud, um, jnp.zeros(nchains, jnp.int32),
             jnp.zeros((nchains, 8, M), jnp.float64),
             jnp.zeros((nchains, 8, 7), jnp.float64))
    base_key = random.PRNGKey(11)
    im = None if inv_mass is None else jnp.asarray(inv_mass, jnp.float64)
    carry, stats = run_chunk(carry, base_key, 2, pot.params, dt, im)

    # replay: the chunk's keys, split per iteration as the sampler does
    keys = random.split(random.fold_in(base_key, 2), chunk_size)
    xr = np.asarray(x0, np.float64)
    Ur, gr = ref_pot(xr)
    accepts = []
    for i in range(chunk_size):
        kL, kp, ku = random.split(keys[i], 3)
        L = int(random.randint(kL, (), LMIN, LMAX + 1))
        z = np.asarray(random.normal(kp, (nchains, M), jnp.float64))
        p0 = z * SIGMA if inv_mass is None else z / np.sqrt(inv_mass)
        u = np.asarray(random.uniform(ku, (nchains,), jnp.float64))
        xr, Ur, gr, acc = reference.hmc_iteration(
            ref_pot, xr, Ur, gr, p0, L, dt, u, low, high,
            inv_mass=inv_mass)
        accepts.append(acc)
    return carry, np.asarray(stats), xr, Ur, np.stack(accepts)


@pytest.mark.parametrize("metric", ["identity", "diagonal"])
@pytest.mark.parametrize("regularization", ["MS", "Damping"])
def test_shared_L_trajectory_matches_reference(small_module, regularization,
                                               metric):
    """A whole chunk of the shared-L path equals the float64 NumPy
    leapfrog iteration by iteration, under the reference's identity
    kinetic and under an adapted diagonal metric."""
    module = small_module[0]
    inv_mass = None
    dt = 0.01
    if metric == "diagonal":
        inv_mass = np.linspace(0.5, 2.0, module.n_active) * 1e-6
        dt = 0.5
    carry, stats, xr, Ur, acc = _run_both(small_module, regularization,
                                          dt=dt, inv_mass=inv_mass)
    scale = np.abs(xr).max()
    np.testing.assert_allclose(np.asarray(carry[0]), xr, rtol=0,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(np.asarray(carry[1]), Ur, rtol=1e-9)
    np.testing.assert_array_equal(stats[..., 0] > 0.5, acc)
    # the chunk moved the chains: a replay of a no-op would pass trivially
    assert acc.any()


def test_refresh_and_accept_match_reference(small_module):
    """At a step size where the sampler both accepts and rejects, every
    Metropolis decision and the per-chain accept count match the
    reference replaying the same momentum refresh and uniforms."""
    carry, stats, xr, Ur, acc = _run_both(small_module, "MS", dt=0.01,
                                          nchains=8, chunk_size=6,
                                          x_scale=0.5)
    assert acc.any() and (~acc).any(), "need both outcomes to compare"
    np.testing.assert_array_equal(stats[..., 0] > 0.5, acc)
    np.testing.assert_array_equal(np.asarray(carry[5]), acc.sum(axis=0))
    np.testing.assert_allclose(np.asarray(carry[0]), xr, rtol=0,
                               atol=1e-9 * np.abs(xr).max())


def test_rejection_keeps_state(small_module):
    """A step size far too large for the target rejects every proposal:
    state, potential and gradient stay exactly where they started, as in
    the reference (rejected proposals are discarded)."""
    module, dobs, pot, ref_pot, low, high, alpha = _setup(small_module,
                                                          "Damping")
    M = module.n_active
    run_chunk = hmc.make_chunk_sampler(
        pot, dt=50.0, Lmin=LMIN, Lmax=LMAX, Sigma=1.0, low=low, high=high,
        constraint="mandatory", alpha=alpha, chunk_size=4, nsamples=8,
        ndraws=0, wdiag_inv=module.wdiag_inv, data_size=dobs.size,
        dtype=jnp.float64, shared_L=True)
    x = jnp.asarray(np.tile(module.wdiag * 0.3, (3, 1)), jnp.float64)
    U, g, (_, ud, um) = pot(x, alpha)
    x_in, U_in, g_in = (np.asarray(a) for a in (x, U, g))
    carry = (x, U, g, ud, um, jnp.zeros(3, jnp.int32),
             jnp.zeros((3, 8, M), jnp.float64),
             jnp.zeros((3, 8, 7), jnp.float64))
    carry, stats = run_chunk(carry, random.PRNGKey(0), 0, pot.params)
    stats = np.asarray(stats)
    assert not (stats[..., 0] > 0.5).any()
    np.testing.assert_array_equal(np.asarray(carry[0]), x_in)
    np.testing.assert_array_equal(np.asarray(carry[1]), U_in)
    np.testing.assert_array_equal(np.asarray(carry[2]), g_in)
    assert int(jnp.sum(carry[5])) == 0
    # the reference rejects the first proposal from the same draws too
    kL, kp, ku = random.split(
        random.split(random.fold_in(random.PRNGKey(0), 0), 4)[0], 3)
    L = int(random.randint(kL, (), LMIN, LMAX + 1))
    p0 = np.asarray(random.normal(kp, (3, M), jnp.float64))
    u = np.asarray(random.uniform(ku, (3,), jnp.float64))
    Ur, gr = ref_pot(x_in)
    np.testing.assert_allclose(Ur, U_in, rtol=1e-12)
    xr, _, _, acc = reference.hmc_iteration(ref_pot, x_in, Ur, gr, p0, L,
                                            50.0, u, low, high)
    assert not acc.any()
    np.testing.assert_array_equal(xr, x_in)
