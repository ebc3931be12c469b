"""Warmup adaptation of the chunked HMC sampler: windowed dual-averaging +
Welford diagonal metric (an extension the reference lacks — its dt/Sigma
are fixed for the whole run, reference: inversion/hmc.py:85-177)."""
import numpy as np
import pytest

import jax.numpy as jnp

from gravinv3dhmc.inversion import hmc


class _GaussModel:
    """Model shim exposing the GravMagModule surface the sampler needs,
    with an anisotropic Gaussian potential U = sum dm^2 / (2 sigma^2)."""

    def __init__(self, sigmas, mu=0.0):
        self.sigmas = np.asarray(sigmas, np.float64)
        M = self.sigmas.size
        self.mu = np.full(M, mu)
        self.wdiag = np.ones(M)
        self.wdiag_inv = np.ones(M)

    def make_potential(self, aprior, low, high, **kw):
        dtype = kw.get("dtype", jnp.float32)
        s2 = jnp.asarray(self.sigmas ** 2, dtype)
        mu = jnp.asarray(self.mu, dtype)

        def fn(x, alpha):
            dm = x - mu
            U = jnp.sum(dm * dm / (2.0 * s2), axis=-1)
            g = dm / s2
            # distinct buffers: U/u_data/u_model all enter the sampler's
            # donated carry, and XLA rejects donating one buffer twice
            return U, g, (None, 1.0 * U, jnp.zeros_like(U))

        return fn


def _run(sigmas, *, adapt, nsamples=256, nchains=4, seed=3):
    model = _GaussModel(sigmas)
    M = sigmas.size
    chain = hmc.HamiltonianMC(model)
    # a stable fixed dt is set by the NARROWEST direction; without a
    # metric the widest direction then mixes ~ (sigma_max/sigma_min)x
    # slower — the classic ill-conditioned failure the metric fixes
    chain.dt = 0.5 * sigmas.min()
    chain.Lrange = [4, 8]
    chain.Sigma = 1.0
    chain.seed = seed
    chain.RegulFactor = 0.0
    chain.regularization = "Damping"
    chain.nchains = nchains
    chain.chunk_size = 16
    chain.verbose = False
    chain.write_files = False
    chain.shared_L = True
    chain.low = np.full(M, -50.0)
    chain.high = np.full(M, 50.0)
    chain.initial_model = np.zeros(M)
    chain.aprior_model = np.zeros(M)
    chain.dobs = np.zeros(8)  # only its size is used (misfit columns)
    if adapt:
        chain.adapt_step_size = True
        chain.adapt_mass = True
        chain.adapt_chunks = 24
        chain.adapt_target = 0.8
    return chain.sample(nsamples, 0)


def _median_ess(out):
    from gravinv3dhmc.diagnostics import effective_sample_size

    n = int(out["n_stored"].min())
    return float(np.median(effective_sample_size(
        out["samples"][:, :n, :])))


def test_mass_adaptation_improves_ess_on_ill_conditioned_target():
    sigmas = np.logspace(-2, 0, 16)  # condition number 1e4 in variance
    fixed = _run(sigmas, adapt=False)
    adapted = _run(sigmas, adapt=True)
    assert adapted["adapted_mass"]
    # the estimated inverse mass must track the true variances (up to the
    # shrinkage prior) — order-of-magnitude agreement across 2 decades
    ratio = adapted["inv_mass"] / sigmas ** 2
    assert np.all(ratio > 0.1) and np.all(ratio < 10.0), ratio
    # and sampling efficiency on the SLOWEST direction must improve a lot
    ess_fixed = _median_ess(fixed)
    ess_adapted = _median_ess(adapted)
    assert ess_adapted > 3.0 * ess_fixed, (ess_fixed, ess_adapted)


def test_storage_gated_until_kernel_freezes():
    """With adaptation on, every stored sample must come from the frozen
    kernel: accepted counters reset at the freeze, so per-chain accepted
    can never exceed post-freeze attempts."""
    sigmas = np.logspace(-1, 0, 8)
    out = _run(sigmas, adapt=True, nsamples=64)
    per_chain_attempted = out["attempted"] / 4  # nchains
    assert max(out["accepted"]) <= per_chain_attempted
    assert int(out["n_stored"].min()) == 64
    # step size was re-tuned away from the deliberately tiny initial dt
    assert out["step_size"] > 0.5 * sigmas.min()


def test_step_size_adaptation_only_reaches_target_accept():
    sigmas = np.full(8, 1.0)
    model = _GaussModel(sigmas)
    chain = hmc.HamiltonianMC(model)
    chain.dt = 2.0  # far too large: unadapted accept would be ~0
    chain.Lrange = [4, 8]
    chain.Sigma = 1.0
    chain.seed = 0
    chain.RegulFactor = 0.0
    chain.regularization = "Damping"
    chain.nchains = 4
    chain.chunk_size = 16
    chain.verbose = False
    chain.write_files = False
    chain.low = np.full(8, -50.0)
    chain.high = np.full(8, 50.0)
    chain.initial_model = np.zeros(8)
    chain.aprior_model = np.zeros(8)
    chain.dobs = np.zeros(8)
    chain.adapt_step_size = True
    chain.adapt_chunks = 20
    chain.adapt_target = 0.8
    out = chain.sample(128, 0)
    assert 0.5 < out["accept_ratio"] <= 1.0
    assert out["step_size"] < 2.0
