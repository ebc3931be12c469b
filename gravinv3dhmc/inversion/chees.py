"""ChEES-HMC: cross-chain adaptive trajectory lengths.

An extension beyond the reference's fixed-L HMC (inversion/hmc.py:297
draws L uniformly per iteration but never adapts it). ChEES (Change in
the Estimator of the Expected Squared jump distance; Hoffman, Radul &
Sountsov, AISTATS 2021) tunes the trajectory *time* T by stochastic
gradient ascent on a criterion estimated from the whole chain ensemble —
which is exactly the quantity a vmapped/sharded chain batch makes cheap:

* every chain runs the SAME number of leapfrog steps per iteration
  (jittered), so the trajectory is one dynamic-length ``fori_loop`` of
  full-batch matmuls with zero masked-step waste (the masked
  per-chain-L scan in hmc.py wastes (Lmax - E[L])/Lmax of its steps);
* the criterion needs cross-chain means — ``jnp.mean`` over the chain
  axis, which GSPMD lowers to a ``psum`` when chains are sharded
  (parallel/sharded.py), the framework's only cross-chain communication.

Like NUTS (inversion/nuts.py), ChEES assumes an unconstrained target:
use the 'logarithmic' box transform. Step size adapts by dual averaging
toward the harmonic-mean acceptance; log T adapts by Adam on the ChEES
gradient estimate, following the paper's scheme.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, random

from .nuts import dual_averaging_init, dual_averaging_update


def _halton(i, base=2):
    """Low-discrepancy jitter sequence (van der Corput, base 2), computed
    with static 16-bit reversal — the paper jitters trajectory lengths
    with a Halton sequence rather than iid uniforms."""
    i = i.astype(jnp.uint32) + 1
    out = jnp.zeros_like(i, dtype=jnp.float32)
    f = jnp.float32(0.5)
    for _ in range(16):
        out = out + f * (i % 2).astype(jnp.float32)
        i = i // 2
        f = f * 0.5
    return out


def adam_init(x0):
    return dict(x=jnp.asarray(x0, jnp.float32),
                m=jnp.zeros(()), v=jnp.zeros(()), t=jnp.zeros(()))


def adam_update(state, grad, lr=0.025, b1=0.9, b2=0.999, eps=1e-8):
    t = state["t"] + 1.0
    m = b1 * state["m"] + (1 - b1) * grad
    v = b2 * state["v"] + (1 - b2) * grad * grad
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    x = state["x"] + lr * mhat / (jnp.sqrt(vhat) + eps)  # ascent
    return dict(x=x, m=m, v=v, t=t)


def run_chees(potential_fn, x0_batch, key, *, n_warmup=200, n_samples=500,
              step_size0=0.05, T0=None, target_accept=0.75,
              max_steps=1024, dtype=jnp.float32, static_trajectory=False):
    """Adaptive ChEES-HMC over a chain batch.

    ``potential_fn(x) -> (U, grad)`` must accept the full (C, M) batch and
    return ((C,), (C, M)) — chains are NOT vmapped here because the
    adaptation couples them through cross-chain means.

    ``static_trajectory=True`` replaces the dynamic-trip-count
    ``fori_loop`` trajectory with a ``lax.scan`` over ``max_steps``
    steps masked by ``i < L`` — fully static shapes and trip counts.
    Same math (masked steps pass state through); it always pays
    ``max_steps`` evaluations per iteration, so use it when L saturates
    the cap anyway (see tools/global_chees.py GC_STATIC).

    Returns ``(samples (n_samples, C, M), stats)`` with the adapted step
    size and trajectory time.
    """
    x0 = jnp.asarray(x0_batch, dtype)
    C, M = x0.shape
    if T0 is None:
        T0 = 10.0 * step_size0

    def kinetic(p):
        return 0.5 * jnp.sum(p * p, axis=-1)

    def one_iteration(carry, inputs):
        it, k = inputs
        x, U, g, da, ad, collecting = carry
        eps = jnp.exp(da["log_eps"]).astype(dtype)
        T = jnp.exp(ad["x"]).astype(dtype)
        u = _halton(it)  # shared jitter, one trajectory length for all
        L = jnp.clip((u * T / eps).astype(jnp.int32) + 1, 1, max_steps)

        kp, ka = random.split(k)
        p0 = random.normal(kp, x.shape, dtype)
        H0 = U + kinetic(p0)

        p = p0 - 0.5 * eps * g

        def body(i, s):
            xx, pp, UU, gg = s
            xx = xx + eps * pp
            UU, gg = potential_fn(xx)
            # full kick except on the final step (half kick after loop)
            kick = jnp.where(i == L - 1, 0.5 * eps, eps)
            pp = pp - kick * gg
            return (xx, pp, UU, gg)

        if static_trajectory:
            # masked static-shape variant: every iteration runs exactly
            # max_steps evaluations; steps with i >= L pass through
            def step(s, i):
                s2 = body(i, s)
                act = i < L
                return (jax.tree.map(
                    lambda a, b: jnp.where(act, b, a), s, s2), None)

            (x_new, p_new, U_new, g_new), _ = lax.scan(
                step, (x, p, U, g), jnp.arange(max_steps))
        else:
            x_new, p_new, U_new, g_new = lax.fori_loop(0, L, body,
                                                       (x, p, U, g))
        H_new = U_new + kinetic(p_new)
        dH = H_new - H0
        accept_prob = jnp.minimum(1.0, jnp.exp(-jnp.where(
            jnp.isfinite(dH), dH, jnp.inf)))
        acc = random.uniform(ka, (C,), dtype) < accept_prob
        accm = acc[:, None]

        # ---- ChEES gradient estimate (paper eq. 14, accept-weighted) ----
        w = accept_prob / jnp.maximum(jnp.sum(accept_prob), 1e-12)
        xbar = jnp.mean(x, axis=0)              # psum over sharded chains
        xbar_new = jnp.sum(w[:, None] * x_new, axis=0)
        c_old = x - xbar
        c_new = x_new - xbar_new
        delta = jnp.sum(c_new * c_new, axis=-1) - jnp.sum(c_old * c_old,
                                                          axis=-1)
        # final velocity; identity metric here so v = p (end momentum
        # before the trailing half kick would differ by O(eps) — use p_new)
        proj = jnp.sum(c_new * p_new, axis=-1)
        grad_t = jnp.sum(w * delta * proj) * u  # d t / d T = u
        # normalized-gradient Adam on log T (paper: sign-like robustness)
        grad_log_T = grad_t * T / (jnp.abs(grad_t * T) + 1e-6)

        x = jnp.where(accm, x_new, x)
        U = jnp.where(acc, U_new, U)
        g = jnp.where(accm, g_new, g)

        mean_accept = jnp.mean(accept_prob)
        da = jax.tree.map(
            lambda a, b: jnp.where(collecting, a, b), da,
            dual_averaging_update(da, mean_accept))
        ad = jax.tree.map(
            lambda a, b: jnp.where(collecting, a, b), ad,
            adam_update(ad, grad_log_T))
        stats = (mean_accept, L.astype(dtype), jnp.exp(ad["x"]))
        return (x, U, g, da, ad, collecting), (x, stats)

    U0, g0 = potential_fn(x0)
    U0 = jnp.asarray(U0, dtype)
    g0 = jnp.asarray(g0, dtype)
    # canonical f32 adaptation state: scan requires carry-type stability
    # through the jnp.where freeze gates
    da = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                      dual_averaging_init(step_size0,
                                          target=target_accept))
    ad = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                      adam_init(jnp.log(T0)))
    keys = random.split(key, n_warmup + n_samples)
    its = jnp.arange(n_warmup + n_samples, dtype=jnp.int32)

    carry = (x0, U0, g0, da, ad, jnp.asarray(False))
    carry, (_, warm_stats) = lax.scan(
        one_iteration, carry, (its[:n_warmup], keys[:n_warmup]))
    x, U, g, da, ad, _ = carry
    # freeze adaptation: switch eps to the dual-averaged value
    da = {**da, "log_eps": da["log_eps_avg"]}
    carry = (x, U, g, da, ad, jnp.asarray(True))
    carry, (xs, samp_stats) = lax.scan(
        one_iteration, carry, (its[n_warmup:], keys[n_warmup:]))

    stats = dict(
        step_size=jnp.exp(da["log_eps_avg"]),
        trajectory_time=jnp.exp(ad["x"]),
        warm_accept=warm_stats[0], warm_L=warm_stats[1],
        warm_T=warm_stats[2],
        accept=samp_stats[0], L=samp_stats[1],
        # the REALIZED trajectory cost: when the adapted T/eps ratio
        # exceeds max_steps the clip at :89 silently caps L, and the
        # reported trajectory_time no longer describes what ran (the
        # round-4 scale-0.5 artifact showed step_size 1.2e-8 with
        # T=0.226 — ~1.9e7 implied steps — without saying L was capped
        # at max_steps). mean_L and the saturation fraction make the
        # cost model honest and the run reproducible.
        mean_L=jnp.mean(samp_stats[1]),
        max_steps=jnp.asarray(max_steps, jnp.int32),
        max_steps_saturated=jnp.mean(
            (samp_stats[1] >= max_steps).astype(jnp.float32)),
    )
    return xs, stats


def run_chees_chunked(potential_fn, x0_batch, key, *, n_warmup=200,
                      n_samples=500, chunk_iters=32, step_size0=0.05,
                      T0=None, target_accept=0.75, max_steps=1024,
                      dtype=jnp.float32, static_trajectory=False,
                      pot_params=None, verbose=False):
    """ChEES-HMC as a sequence of SHORT jitted blocks.

    The one-shot :func:`run_chees` compiles warmup + sampling into a
    single XLA program whose device-side execution runs for minutes at
    whole-Earth scale, with no progress report until it ends. This
    runner dispatches ``chunk_iters`` iterations
    per program — the same discipline the HMC sampler has always used —
    with the adaptation state (dual averaging + Adam on log T) carried
    across blocks and the sample buffer device-resident; only scalar
    block summaries cross the host link.

    ``potential_fn(x, P) -> (U, grad)`` takes the large-array pytree
    ``pot_params`` as an ARGUMENT (a closure-captured kernel matrix
    would be baked into the block executable). ``n_warmup`` and
    ``n_samples`` round up to multiples of ``chunk_iters``.

    Returns ``(samples (n_samples, C, M) device array, stats)`` with the
    same stats vocabulary as :func:`run_chees`.
    """
    from functools import partial

    x0 = jnp.asarray(x0_batch, dtype)
    C, M = x0.shape
    if T0 is None:
        T0 = 10.0 * step_size0
    blocks_w = -(-n_warmup // chunk_iters)
    blocks_s = -(-n_samples // chunk_iters)
    n_warmup = blocks_w * chunk_iters
    n_samples = blocks_s * chunk_iters

    def kinetic(p):
        return 0.5 * jnp.sum(p * p, axis=-1)

    def one_iteration(carry, inputs, P):
        it, k = inputs
        x, U, g, da, ad, collecting = carry
        eps = jnp.exp(da["log_eps"]).astype(dtype)
        T = jnp.exp(ad["x"]).astype(dtype)
        u = _halton(it)
        L = jnp.clip((u * T / eps).astype(jnp.int32) + 1, 1, max_steps)
        kp, ka = random.split(k)
        p0 = random.normal(kp, x.shape, dtype)
        H0 = U + kinetic(p0)
        p = p0 - 0.5 * eps * g

        def body(i, s):
            xx, pp, UU, gg = s
            xx = xx + eps * pp
            UU, gg = potential_fn(xx, P)
            kick = jnp.where(i == L - 1, 0.5 * eps, eps)
            pp = pp - kick * gg
            return (xx, pp, UU, gg)

        if static_trajectory:
            def step(s, i):
                s2 = body(i, s)
                act = i < L
                return (jax.tree.map(
                    lambda a, b: jnp.where(act, b, a), s, s2), None)

            (x_new, p_new, U_new, g_new), _ = lax.scan(
                step, (x, p, U, g), jnp.arange(max_steps))
        else:
            x_new, p_new, U_new, g_new = lax.fori_loop(0, L, body,
                                                       (x, p, U, g))
        H_new = U_new + kinetic(p_new)
        dH = H_new - H0
        accept_prob = jnp.minimum(1.0, jnp.exp(-jnp.where(
            jnp.isfinite(dH), dH, jnp.inf)))
        acc = random.uniform(ka, (C,), dtype) < accept_prob
        accm = acc[:, None]
        w = accept_prob / jnp.maximum(jnp.sum(accept_prob), 1e-12)
        xbar = jnp.mean(x, axis=0)
        xbar_new = jnp.sum(w[:, None] * x_new, axis=0)
        c_old = x - xbar
        c_new = x_new - xbar_new
        delta = jnp.sum(c_new * c_new, axis=-1) - jnp.sum(
            c_old * c_old, axis=-1)
        proj = jnp.sum(c_new * p_new, axis=-1)
        grad_t = jnp.sum(w * delta * proj) * u
        grad_log_T = grad_t * T / (jnp.abs(grad_t * T) + 1e-6)
        x = jnp.where(accm, x_new, x)
        U = jnp.where(acc, U_new, U)
        g = jnp.where(accm, g_new, g)
        mean_accept = jnp.mean(accept_prob)
        da = jax.tree.map(
            lambda a, b: jnp.where(collecting, a, b), da,
            dual_averaging_update(da, mean_accept))
        ad = jax.tree.map(
            lambda a, b: jnp.where(collecting, a, b), ad,
            adam_update(ad, grad_log_T))
        return ((x, U, g, da, ad, collecting),
                (x, (mean_accept, L.astype(dtype), jnp.exp(ad["x"]))))

    # donate ONLY the sample buffer (the large array — in-place across
    # blocks). Donating the carry too would (a) alias-donate the cached
    # zero-constant buffers the adaptation dicts share and (b) consume
    # the caller's x0.
    @partial(jax.jit, donate_argnums=(1,))
    def run_block(carry, buf, base_key, it0, P):
        def step(c, i):
            carry_c, buf_c = c
            it = it0 + i
            k = random.fold_in(base_key, it)
            carry_c, (x_out, st) = one_iteration(carry_c, (it, k), P)
            slot = it - n_warmup

            def store(b):
                return lax.dynamic_update_slice_in_dim(
                    b, x_out[None], jnp.clip(slot, 0, n_samples - 1),
                    axis=0)

            buf_c = lax.cond((slot >= 0) & (slot < n_samples), store,
                             lambda b: b, buf_c)
            return (carry_c, buf_c), st

        (carry, buf), sts = lax.scan(step, (carry, buf),
                                     jnp.arange(chunk_iters))
        # per-block scalar summary (host reads these, nothing else)
        return carry, buf, (jnp.mean(sts[0]), jnp.mean(sts[1]),
                            jnp.mean((sts[1] >= max_steps)
                                     .astype(jnp.float32)), sts[2][-1])

    U0, g0 = potential_fn(x0, pot_params)
    da = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                      dual_averaging_init(step_size0,
                                          target=target_accept))
    ad = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                      adam_init(jnp.log(T0)))
    carry = (x0, jnp.asarray(U0, dtype), jnp.asarray(g0, dtype), da, ad,
             jnp.asarray(False))
    buf = jnp.zeros((n_samples, C, M), dtype)
    accepts, mean_Ls, sat_fracs = [], [], []
    it0 = 0
    for b in range(blocks_w):
        carry, buf, summ = run_block(carry, buf, key, it0, pot_params)
        it0 += chunk_iters
        if verbose:
            print(f"chees warmup block {b + 1}/{blocks_w}: accept "
                  f"{float(summ[0]):.2f} mean_L {float(summ[1]):.0f}",
                  flush=True)
    # freeze adaptation at the block boundary (run_chees semantics)
    x, U, g, da, ad, _ = carry
    da = {**da, "log_eps": da["log_eps_avg"]}
    carry = (x, U, g, da, ad, jnp.asarray(True))
    for b in range(blocks_s):
        carry, buf, summ = run_block(carry, buf, key, it0, pot_params)
        it0 += chunk_iters
        accepts.append(float(summ[0]))
        mean_Ls.append(float(summ[1]))
        sat_fracs.append(float(summ[2]))
        if verbose:
            print(f"chees block {b + 1}/{blocks_s}: accept "
                  f"{accepts[-1]:.2f} mean_L {mean_Ls[-1]:.0f}",
                  flush=True)
    _, _, _, da, ad, _ = carry
    stats = dict(
        step_size=jnp.exp(da["log_eps_avg"]),
        trajectory_time=jnp.exp(ad["x"]),
        accept=jnp.asarray(accepts, jnp.float32),
        L=jnp.asarray(mean_Ls, jnp.float32),
        mean_L=float(np.mean(mean_Ls)),
        max_steps=max_steps,
        max_steps_saturated=float(np.mean(sat_fracs)),
        n_warmup=n_warmup, n_samples=n_samples,
        chunk_iters=chunk_iters,
    )
    return buf, stats


def CheesSample(model, nsamples, nwarmup, initial_model, aprior_model,
                boundaries, dobs, RegulFactor=1.0, regularization="Damping",
                beta=0.01, seed=100, log_factor=100.0, step_size0=0.05,
                target_accept=0.75, myrank=0, save_folder=None, nchains=16,
                dtype=jnp.float32, verbose=True, temperature=1.0,
                max_steps=1024, chunk_iters=None, transfer_samples=True):
    """Multi-chain ChEES-HMC on a :class:`GravMagModule` potential —
    the ensemble counterpart of :func:`nuts.NUTSSample`.

    ``chunk_iters``: dispatch the run as short jitted blocks
    (:func:`run_chees_chunked`) instead of one program, so that a long
    run reports progress between blocks.

    ``transfer_samples=False`` (like
    ``HamiltonianMC.transfer_samples``): the draws stay on device —
    ``out['samples']`` is None and ``out['samples_device']`` holds the
    (C, N, M) density-model array (a 64x256x10427 buffer is ~680 MB);
    file writing is skipped."""
    from .potential import logistic_to_mw, mw_to_logistic

    wdiag = np.asarray(model.wdiag)
    boundaries = np.asarray(boundaries, dtype=np.float64)
    low = wdiag * boundaries[:, 0]
    high = wdiag * boundaries[:, 1]
    aprior_mw = wdiag * np.asarray(aprior_model, dtype=np.float64)
    init_mw = wdiag * np.asarray(initial_model, dtype=np.float64)

    batched = model.make_potential(
        aprior_mw, low, high, constraint="logarithmic",
        log_factor=log_factor, regularization=regularization, beta=beta,
        dtype=dtype, jacobian=True, temperature=temperature)

    x0 = mw_to_logistic(np.clip(init_mw, low + 1e-9 * (high - low + 1e-30),
                                high - 1e-9 * (high - low + 1e-30)),
                        low, high, log_factor)
    x0 = np.where(np.isfinite(x0), x0, 0.0)
    x0_b = jnp.asarray(np.tile(x0[None, :], (nchains, 1)), dtype)
    # spread initial points: tiny seeded perturbation so cross-chain
    # means carry information from the first iteration
    spread = 0.01 * random.normal(random.PRNGKey(seed + 1), x0_b.shape,
                                  dtype)
    x0_b = x0_b + spread

    import time as _time
    chain_key = random.fold_in(random.PRNGKey(seed), myrank)
    if chunk_iters:
        def pot2(xx, P):
            u, g, _ = batched.fn(xx, RegulFactor, P)
            return u, g

        t0 = _time.time()
        buf, cstats = run_chees_chunked(
            pot2, x0_b, chain_key, n_warmup=nwarmup, n_samples=nsamples,
            chunk_iters=chunk_iters, step_size0=step_size0,
            target_accept=target_accept, dtype=dtype,
            max_steps=max_steps, pot_params=batched.params,
            verbose=verbose)
        # map the block summaries onto the one-shot stats vocabulary:
        # L as a per-iteration series so mean/sum below stay correct
        # (warmup grad evals are not counted in the chunked mode)
        stats = dict(cstats,
                     warm_L=np.zeros(0),
                     L=np.full(cstats["n_samples"],
                               cstats["mean_L"], np.float64))
        if not transfer_samples:
            # device-resident finish: transform to the density-model domain
            # ON DEVICE, keep it there; a scalar readback is the
            # completion barrier
            low_d = jnp.asarray(low, dtype)
            high_d = jnp.asarray(high, dtype)
            winv_d = jnp.asarray(np.asarray(model.wdiag_inv), dtype)

            @jax.jit
            def to_m(b):
                mw_d = logistic_to_mw(b, low_d[None, None, :],
                                      high_d[None, None, :], log_factor)
                return jnp.transpose(mw_d * winv_d[None, None, :],
                                     (1, 0, 2))

            m_dev = to_m(buf)  # (C, N, M), device
            float(m_dev[0, 0, 0])
            elapsed = _time.time() - t0
            return {
                "samples": None,
                "samples_device": m_dev,
                "step_size": float(np.asarray(stats["step_size"])),
                "trajectory_time": float(np.asarray(
                    stats["trajectory_time"])),
                "mean_accept": float(np.mean(np.asarray(
                    stats["accept"]))),
                "mean_L": float(np.mean(np.asarray(stats["L"]))),
                "max_steps": int(np.asarray(stats["max_steps"])),
                "max_steps_saturated": float(np.asarray(
                    stats["max_steps_saturated"])),
                "elapsed_s": elapsed,
                "grad_evals": int(np.asarray(stats["L"]).sum()),
            }
        xs = np.asarray(buf, dtype=np.float64)  # (N, C, M)
        elapsed = _time.time() - t0
    else:
        if not transfer_samples:
            raise ValueError("transfer_samples=False requires the "
                             "chunked mode (pass chunk_iters)")
        def _run(xb, key, P):
            def pot_batch(xx):
                u, g, _ = batched.fn(xx, RegulFactor, P)
                return u, g
            return run_chees(pot_batch, xb, key, n_warmup=nwarmup,
                             n_samples=nsamples, step_size0=step_size0,
                             target_accept=target_accept, dtype=dtype,
                             max_steps=max_steps)

        runner = jax.jit(_run)
        t0 = _time.time()
        xs, stats = runner(x0_b, chain_key, batched.params)
        xs = np.asarray(xs, dtype=np.float64)  # (N, C, M)
        elapsed = _time.time() - t0
    mw = logistic_to_mw(xs, low[None, None, :], high[None, None, :],
                        log_factor, xp=np)
    samples = (mw * np.asarray(model.wdiag_inv)[None, None, :]
               ).transpose(1, 0, 2)  # (C, N, M)
    out = {
        "samples": samples,
        "step_size": float(np.asarray(stats["step_size"])),
        "trajectory_time": float(np.asarray(stats["trajectory_time"])),
        "mean_accept": float(np.mean(np.asarray(stats["accept"]))),
        "mean_L": float(np.mean(np.asarray(stats["L"]))),
        "max_steps": int(np.asarray(stats["max_steps"])),
        "max_steps_saturated": float(
            np.asarray(stats["max_steps_saturated"])),
        "elapsed_s": elapsed,
        "grad_evals": int(np.asarray(stats["L"]).sum()
                          + np.asarray(stats["warm_L"]).sum()),
    }
    if save_folder is not None:
        try:
            from ..runtime.sink import SampleSink as Sink
        except Exception:
            from ..runtime.sink_py import PySampleSink as Sink
        folders = []
        for c in range(nchains):
            w = Sink(f"{save_folder}{myrank + c}")
            for i in range(samples.shape[1]):
                w.append(samples[c, i], np.zeros(7))
            w.close()
            folders.append(w.folder)
        out["folders"] = folders
    return out
