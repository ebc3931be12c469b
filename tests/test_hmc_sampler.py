"""HamiltonianMC sampler-class behaviors: device-resident modes, target
temperature and sample-storage disciplines."""
import numpy as np
import pytest

import jax.numpy as jnp

from gravinv3dhmc.inversion import hmc


def _chain(module, dobs, nchains=2):
    M = module.n_active
    chain = hmc.HamiltonianMC(module)
    chain.dt = 0.01
    chain.Lrange = [3, 8]
    chain.Sigma = 0.001
    chain.seed = 7
    chain.RegulFactor = 1.0
    chain.regularization = "MS"
    chain.beta = 0.001
    chain.nchains = nchains
    chain.chunk_size = 8
    chain.verbose = False
    chain.write_files = False
    wdiag = module.wdiag
    chain.low = wdiag * np.zeros(M)
    chain.high = wdiag * np.ones(M)
    chain.initial_model = wdiag * np.full(M, 0.001)
    chain.aprior_model = wdiag * np.full(M, 0.001)
    chain.dobs = dobs
    return chain


def test_device_resident_mode_matches_transfer_mode(small_module):
    """transfer_samples=False must produce the same sampling run (same
    counters, same device buffers) while returning no host arrays."""
    module, dobs, _ = small_module
    a = _chain(module, dobs).sample(32, 0)
    c = _chain(module, dobs)
    c.transfer_samples = False
    b = c.sample(32, 0)
    assert b["samples"] is None and b["misfits"] is None
    assert b["accepted"] == a["accepted"]
    assert b["grad_evals"] == a["grad_evals"]
    np.testing.assert_allclose(np.asarray(b["samples_device"], np.float64),
                               a["samples"], rtol=1e-6, atol=1e-8)
    assert b["ess_per_s_median"] is not None
    # the two ESS implementations agree on the same buffers up to f32/f64
    assert b["ess_per_s_median"] == pytest.approx(
        a["ess_per_s_median"]
        * a["elapsed_s"] / b["elapsed_s"], rel=0.05)


def test_honest_posterior_mode_temperature_widens(small_module):
    """temperature/jacobian pass-through (the --honest mode): the
    potential must actually receive them, and a hotter target must
    accept wider moves into a broader posterior than the T=1 run."""
    module, dobs, _ = small_module
    captured = {}
    orig = module.make_potential

    def spy(*a, **k):
        captured.update(k)
        return orig(*a, **k)

    module.make_potential = spy
    try:
        base = _chain(module, dobs)
        base.constraint = "logarithmic"
        out1 = base.sample(48, 0)
        assert captured["temperature"] == 1.0
        assert captured["jacobian"] is False

        hot = _chain(module, dobs)
        hot.constraint = "logarithmic"
        hot.temperature = 400.0
        out2 = hot.sample(48, 0)
        assert captured["temperature"] == 400.0

        jac = _chain(module, dobs)
        jac.constraint = "logarithmic"
        jac.jacobian = True
        # the Jacobian term's gradient is O(log_factor) per coordinate:
        # at the fixture's fixed dt nothing would be accepted (the real
        # honest runs adapt dt); shrink dt so the wiring is observable
        jac.dt = 1e-6
        out3 = jac.sample(48, 0)
        assert captured["jacobian"] is True
    finally:
        module.make_potential = orig
    # the stored misfit rows are [U, u_data, u_model, ...]: under T the
    # potential is (u_data + alpha*u_model)/T, so U*T reconstructs the
    # raw objective; with the Jacobian on, U additionally carries the
    # -log|dmw/dx| term and the identity must NOT hold
    for out, T in ((out1, 1.0), (out2, 400.0)):
        n = int(np.asarray(out["n_stored"]).min())
        assert n >= 1
        k = out["misfits"][:, :n]
        np.testing.assert_allclose(k[..., 0] * T,
                                   k[..., 1] + 1.0 * k[..., 2],
                                   rtol=1e-4)
    n3 = int(np.asarray(out3["n_stored"]).min())
    k3 = out3["misfits"][:, :max(n3, 1)]
    jac_term = k3[..., 0] - (k3[..., 1] + 1.0 * k3[..., 2])
    assert np.abs(jac_term).min() > 1.0  # log-Jacobian present in U


def test_chain_store_mode_records_post_accept_state(small_module):
    """store_mode='chain' stores the post-accept chain state at EVERY
    iteration (the textbook MH estimator): the stored trajectory must end
    at the final chain state, duplicates mark rejections, and the
    buffer's accepted-state set must match accepted-mode storage for the
    same seed/kernel (same chunk keys => same trajectory)."""
    module, dobs, _ = small_module
    a = _chain(module, dobs).sample(24, 0)
    c = _chain(module, dobs)
    c.store_mode = "chain"
    b = c.sample(24, 0)
    # identical PRNG stream => identical chain trajectory: accepted-mode
    # buffer rows must all appear in the chain-mode buffer
    assert int(b["n_stored"].min()) == 24
    bm = b["samples"]
    am = a["samples"]
    for ch in range(2):
        rows_b = {tuple(np.round(r, 6)) for r in bm[ch]}
        n_acc_stored = int(a["n_stored"][ch])
        for i in range(n_acc_stored):
            if tuple(np.round(am[ch, i], 6)) not in rows_b:
                # accepted rows beyond the chain buffer's 24 iterations
                # may be missing only if acceptance outpaced iterations —
                # impossible (<=1 accept per iteration), so fail
                raise AssertionError(
                    f"accepted sample {i} of chain {ch} missing from the "
                    "chain-mode buffer")
    # rejection duplicates: with accept < 1 some consecutive rows repeat
    acc_ratio = b["accept_ratio"]
    dup = sum(np.allclose(bm[0, i], bm[0, i + 1]) for i in range(23))
    if acc_ratio > 0.999:
        assert dup == 0 or dup < 23  # fully-accepting chain may still move
    # misfit rows live at the same slots as their models
    assert np.isfinite(b["misfits"][:, :24]).all()


def test_chain_store_thinning(small_module):
    """store_thin=k stores every k-th post-accept state: the buffer must
    fill completely, spanning k*nsamples iterations, and the thinned
    rows must be a subsequence of the unthinned chain-mode buffer for
    the same seed."""
    module, dobs, _ = small_module
    a = _chain(module, dobs)
    a.store_mode = "chain"
    ra = a.sample(24, 0)
    b = _chain(module, dobs)
    b.store_mode = "chain"
    b.store_thin = 3
    rb = b.sample(8, 0)
    assert int(rb["n_stored"].min()) == 8
    # identical PRNG stream: thinned row j == unthinned row 3*j
    np.testing.assert_allclose(rb["samples"][:, :8],
                               ra["samples"][:, 0:24:3], rtol=1e-6,
                               atol=1e-8)


def test_chain_store_mode_with_warmup_storage_reset(small_module):
    """chain mode + windowed warmup: the storage gate must hold (all
    stored samples post-freeze) and n_stored reach nsamples."""
    module, dobs, _ = small_module
    c = _chain(module, dobs)
    c.store_mode = "chain"
    c.adapt_step_size = True
    c.adapt_chunks = 3
    out = c.sample(16, 0)
    assert int(out["n_stored"].min()) == 16
    assert np.isfinite(out["samples"][:, :16]).all()
    assert out["step_size"] > 0


def test_ess_jax_matches_numpy():
    from gravinv3dhmc.diagnostics import effective_sample_size, ess_jax

    rng = np.random.RandomState(0)
    x = rng.randn(3, 64, 5)
    # add autocorrelation
    for t in range(1, 64):
        x[:, t] = 0.7 * x[:, t - 1] + 0.3 * x[:, t]
    np.testing.assert_allclose(np.asarray(ess_jax(jnp.asarray(x))),
                               effective_sample_size(x), rtol=1e-6)
