"""ChEES-HMC: adaptation sanity and inversion integration."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import random

from gravinv3dhmc.inversion import chees


def test_halton_low_discrepancy():
    seq = np.asarray(chees._halton(jnp.arange(64, dtype=jnp.int32)))
    assert seq.min() >= 0.0 and seq.max() < 1.0
    # van der Corput base 2: first points 0.5, 0.25, 0.75, ...
    np.testing.assert_allclose(seq[:3], [0.5, 0.25, 0.75])
    # stratification: every length-8 window covers both halves of [0,1)
    for i in range(0, 64, 8):
        w = seq[i:i + 8]
        assert (w < 0.5).any() and (w >= 0.5).any()


def test_static_trajectory_matches_dynamic():
    """The masked lax.scan trajectory (static trip counts) must be
    bit-equivalent to the dynamic fori_loop: masked
    steps pass state through, and the PRNG stream is shared."""
    prec = jnp.asarray(1.0 / np.linspace(1.0, 2.0, 6) ** 2, jnp.float32)

    def pot(x):
        return 0.5 * jnp.sum(prec * x * x, axis=-1), prec * x

    x0 = random.normal(random.PRNGKey(3), (8, 6), jnp.float32) * 0.2
    kw = dict(n_warmup=40, n_samples=50, step_size0=0.2, max_steps=64)
    xs_d, st_d = jax.jit(lambda x, k: chees.run_chees(pot, x, k, **kw))(
        x0, random.PRNGKey(4))
    xs_s, st_s = jax.jit(lambda x, k: chees.run_chees(
        pot, x, k, static_trajectory=True, **kw))(x0, random.PRNGKey(4))
    np.testing.assert_array_equal(np.asarray(st_d["L"]),
                                  np.asarray(st_s["L"]))
    np.testing.assert_allclose(np.asarray(xs_d), np.asarray(xs_s),
                               rtol=0, atol=0)


def test_chunked_runner_matches_one_shot_statistics():
    """run_chees_chunked (short jitted blocks with the adaptation state
    carried across) must sample
    the same target to the same moments as the one-shot runner."""
    scales = np.linspace(1.0, 3.0, 6)
    prec = jnp.asarray(1.0 / scales ** 2, jnp.float32)

    def pot(x, P):
        return 0.5 * jnp.sum(P * x * x, axis=-1), P * x

    C, M = 32, 6
    x0 = random.normal(random.PRNGKey(0), (C, M), jnp.float32) * 0.1
    buf, stats = chees.run_chees_chunked(
        pot, x0, random.PRNGKey(1), n_warmup=200, n_samples=300,
        chunk_iters=50, step_size0=0.2, pot_params=prec)
    xs = np.asarray(buf)  # (N, C, M)
    assert xs.shape == (300, C, M)
    assert np.isfinite(xs).all()
    assert np.abs(xs[-1]).max() > 0  # buffer actually filled to the end
    std = xs.reshape(-1, M).std(axis=0)
    np.testing.assert_allclose(std, scales, rtol=0.35)
    assert 0.3 < float(np.mean(stats["accept"])) <= 1.0
    assert stats["n_samples"] == 300 and stats["n_warmup"] == 200
    # rounding-up contract
    _, st2 = chees.run_chees_chunked(
        pot, x0, random.PRNGKey(1), n_warmup=10, n_samples=15,
        chunk_iters=8, step_size0=0.2, pot_params=prec)
    assert st2["n_warmup"] == 16 and st2["n_samples"] == 16


def test_chees_gaussian_moments_and_adaptation():
    # anisotropic Gaussian: scales 1..4 — ChEES should pick a trajectory
    # time comparable to the largest scale, and moments must be right
    scales = np.linspace(1.0, 4.0, 8)
    prec = jnp.asarray(1.0 / scales**2, jnp.float32)

    def pot(x):  # batched (C, M)
        U = 0.5 * jnp.sum(prec * x * x, axis=-1)
        g = prec * x
        return U, g

    C, M = 64, 8
    x0 = random.normal(random.PRNGKey(0), (C, M), jnp.float32) * 0.1
    xs, stats = jax.jit(lambda x, k: chees.run_chees(
        pot, x, k, n_warmup=300, n_samples=400, step_size0=0.2))(
            x0, random.PRNGKey(1))
    xs = np.asarray(xs)  # (N, C, M)
    assert np.isfinite(xs).all()
    accept = float(np.mean(np.asarray(stats["accept"])))
    assert 0.5 < accept <= 1.0
    T = float(np.asarray(stats["trajectory_time"]))
    # adapted away from the initial 10*eps toward the long length scale
    assert 1.0 < T < 40.0
    flat = xs.reshape(-1, M)
    np.testing.assert_allclose(flat.mean(0), np.zeros(M), atol=0.35)
    np.testing.assert_allclose(flat.std(0), scales, rtol=0.25)


def test_chees_trajectory_lengths_jittered():
    prec = jnp.ones(4, jnp.float32)

    def pot(x):
        return 0.5 * jnp.sum(x * x, axis=-1), x

    x0 = random.normal(random.PRNGKey(2), (16, 4), jnp.float32)
    _, stats = chees.run_chees(pot, x0, random.PRNGKey(3), n_warmup=50,
                               n_samples=50, step_size0=0.3)
    L = np.concatenate([np.asarray(stats["warm_L"]),
                        np.asarray(stats["L"])])
    # jittered lengths: not constant across iterations
    assert len(np.unique(L)) > 1


def test_chees_sample_inversion(small_module):
    module, dobs, truth = small_module
    M = module.n_active
    res = chees.CheesSample(
        module, nsamples=60, nwarmup=80,
        initial_model=np.full(M, 0.001),
        aprior_model=np.full(M, 0.001),
        boundaries=np.column_stack([np.zeros(M), np.ones(M)]),
        dobs=dobs, RegulFactor=1.0, regularization="Damping",
        seed=7, log_factor=100.0, step_size0=0.05, nchains=8,
        verbose=False, temperature=0.1)
    samples = res["samples"]  # (C, N, M)
    assert np.isfinite(samples).all()
    assert 0.2 < res["mean_accept"] <= 1.0
    assert res["trajectory_time"] > 0
    # bounds respected (logistic transform)
    assert samples.min() >= -1e-6 and samples.max() <= 1.0 + 1e-6
    # posterior mean correlates with the truth pattern
    mean = samples.mean(axis=(0, 1))
    corr = np.corrcoef(mean, truth)[0, 1]
    assert corr > 0.2


def test_chees_sample_chunked_mode(small_module):
    """CheesSample(chunk_iters=...) — the block-dispatch mode of short
    programs — must
    deliver the same API surface and a comparable posterior."""
    module, dobs, truth = small_module
    M = module.n_active
    res = chees.CheesSample(
        module, nsamples=60, nwarmup=80,
        initial_model=np.full(M, 0.001),
        aprior_model=np.full(M, 0.001),
        boundaries=np.column_stack([np.zeros(M), np.ones(M)]),
        dobs=dobs, RegulFactor=1.0, regularization="Damping",
        seed=7, log_factor=100.0, step_size0=0.05, nchains=8,
        verbose=False, temperature=0.1, chunk_iters=20)
    samples = res["samples"]
    assert samples.shape[1] == 60  # rounded to chunk multiples (3 x 20)
    assert np.isfinite(samples).all()
    assert 0.2 < res["mean_accept"] <= 1.0
    assert samples.min() >= -1e-6 and samples.max() <= 1.0 + 1e-6
    mean = samples.mean(axis=(0, 1))
    assert np.corrcoef(mean, truth)[0, 1] > 0.2
    assert res["mean_L"] > 0 and res["max_steps_saturated"] <= 1.0
