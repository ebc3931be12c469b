"""Hamiltonian Monte Carlo sampling on an accelerator.

Re-designs the reference's single-chain numpy sampler
(reference: inversion/hmc.py:29-354) around XLA:

* The leapfrog trajectory is a ``lax.scan`` over ``Lmax`` steps with a
  per-iteration random trajectory length ``L ~ U[Lmin, Lmax]`` applied by
  masking — static shapes, fully jit-compiled
  (reference randomises L per iteration, inversion/hmc.py:297).
* Chains are a vmapped batch axis: C chains' matvecs fuse into one
  (C, M) x (M, D) matmul per leapfrog step, replacing the reference's
  ``mpiexec`` independent ranks that each rebuilt the full kernel
  (reference: run_main.sh:18, SURVEY.md §2 parallelism table).
* The acceptance-driven outer loop ("run until N *accepted* samples",
  reference: inversion/hmc.py:295,334) runs as jitted chunks of fixed
  iteration count. Accepted post-warmup samples are written into a
  device-resident ring buffer inside the jitted chunk; only per-chain
  counters and a small stats block reach the host per chunk, and the
  sample buffers transfer once at the end.

Reference semantics preserved:

* identity mass matrix with momentum drawn as ``p ~ N(0, Sigma^2)``
  (reference: inversion/hmc.py:95,386-389 — note this tempers the target
  unless Sigma == 1; preserved because every shipped config relies on it);
* 'mandatory' boundary handling: clamp to the bound and negate the
  momentum component (reference: inversion/hmc.py:135-141; the true
  reflection variant is kept commented out there too);
* Metropolis accept on the full Hamiltonian; rejected proposals are
  discarded, not re-recorded (reference appends only accepted samples,
  inversion/hmc.py:306-332);
* sample files ``model.dat`` / 7-column ``misfit.dat`` in the same text
  format and units (models un-weighted via WmInv before writing,
  reference: inversion/hmc.py:241-249,318-332).

One deliberate efficiency fix: the reference re-evaluates the potential at
the trajectory start every iteration ("first forward",
inversion/hmc.py:105); here the (U, grad) of the current state is carried
between iterations, saving one gradient evaluation per trajectory.
"""
from __future__ import annotations

import os
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, random

from .potential import logistic_to_mw, mw_to_logistic


def make_chunk_sampler(potential_fn, *, dt, Lmin, Lmax, Sigma, low, high,
                       constraint, alpha, chunk_size, nsamples, ndraws,
                       wdiag_inv, data_size, log_factor=1000.0,
                       dtype=jnp.float32, shared_L=False,
                       welford=False, store_mode="accepted",
                       store_thin=1):
    """Build the jitted chunk kernel with a device-resident sample buffer.

    ``potential_fn(x, alpha) -> (U, grad, (dpre, U_data, U_model))`` must be
    batched over a leading chain axis (see
    :meth:`GravMagModule.make_potential`).

    The returned function has signature::

        carry, stats = run_chunk(carry, base_key, chunk_idx)
        carry = (x, U, g, u_data, u_model, nacc, buf_m, buf_k)

    where ``buf_m`` is the (C, nsamples, M) sample buffer holding
    *unweighted* models and ``buf_k`` the (C, nsamples, 7) misfit rows in
    the reference's column layout; ``nacc`` counts accepted samples
    (including the ``ndraws`` warm-up ones, which are not stored).

    ``store_mode`` selects the sample-storage discipline:

    * ``"accepted"`` — reference parity (inversion/hmc.py:306-332): only
      ACCEPTED post-warmup states are stored, each chain at its own
      ``nacc``-derived row. Device cost: a per-chain-indexed scatter into
      the buffer every iteration, which XLA cannot prove in-place inside
      the scan, so it may copy the buffer.
    * ``"chain"`` — the textbook MH estimator: the post-accept chain
      state is stored EVERY iteration (a rejection re-records the current
      state), all chains at the same slot. The shared scalar row index
      makes the write one ``dynamic_update_slice`` — the KV-cache pattern
      XLA updates in place — and a scalar ``lax.cond`` skips the write
      entirely once the buffer is full. Statistically this is the more
      defensible posterior estimator (the reference's accepted-only
      storage biases toward high-acceptance regions); use it for
      throughput-critical runs. Storage progress is iteration-driven:
      the host passes ``store_base`` (iterations already run since the
      last storage reset) to ``run_chunk``.
    * ``"none"`` — no storage (throughput measurement only).

    NOTE the carry is DONATED to the jitted chunk (the sample buffer
    dominates it — 1.6 GB at bench scale — and donation lets XLA update it
    in place): the input carry, and any array a ``callback`` received from
    it, is invalid after the next ``run_chunk`` call. Hold a copy if you
    need one.

    ``welford=True`` appends per-chain running-moment accumulators
    ``(w_mean (C, M), w_m2 (C, M), w_count ())`` to the carry, updated from
    the post-accept position every iteration — the warmup metric estimator
    (Stan-style; see :meth:`HamiltonianMC.sample`).
    """
    if store_mode not in ("accepted", "chain", "none"):
        raise ValueError(f"unknown store_mode {store_mode!r}")
    dt_default = float(dt)
    Sigma = jnp.asarray(Sigma, dtype)
    low = jnp.asarray(low, dtype)
    high = jnp.asarray(high, dtype)
    alpha_c = jnp.asarray(alpha, dtype)
    wdiag_inv = jnp.asarray(wdiag_inv, dtype)
    mandatory = constraint == "mandatory"
    reflective = constraint == "reflective"
    logarithmic = constraint == "logarithmic"
    total = nsamples + ndraws
    # Potential objects expose (fn, params): large arrays are threaded as
    # jit arguments rather than captured constants
    if hasattr(potential_fn, "fn"):
        pot_raw = potential_fn.fn
    else:
        pot_raw = lambda x, a, _p: potential_fn(x, a)

    def _finish(x, U, g, u_data, u_model, accept, L, it, store_base,
                nacc, buf_m, buf_k, wstate):
        """Post-accept bookkeeping shared by every path: device-side
        sample storage, accept counting, the per-iteration stats row and
        the optional Welford moments."""
        model_size = x.shape[-1]

        def make_rows():
            if logarithmic:
                mw = logistic_to_mw(x, low, high, log_factor)
            else:
                mw = x
            m_rows = mw * wdiag_inv  # unweighted model, reference units
            u_norm_d = u_data / data_size
            u_norm_m = u_model / model_size
            k_rows = jnp.stack([
                U, u_data, u_model,
                u_norm_d + alpha_c * u_norm_m, u_norm_d, u_norm_m,
                jnp.full_like(U, alpha_c)], axis=-1)  # (C, 7)
            return m_rows, k_rows

        if store_mode == "accepted":
            # reference parity: per-chain row index = accepted count. A
            # single masked scatter with uniqueness hints (each chain owns
            # one distinct row; non-storing chains aim out of bounds and
            # are dropped) — no gather, no select pass.
            store = accept & (nacc >= ndraws) & (nacc < total)
            idx = jnp.where(store,
                            jnp.clip(nacc - ndraws, 0, nsamples - 1),
                            nsamples)  # nsamples = out of bounds -> drop
            m_rows, k_rows = make_rows()
            chain_ix = jnp.arange(x.shape[0])
            buf_m = buf_m.at[chain_ix, idx].set(
                m_rows, mode="drop", unique_indices=True)
            buf_k = buf_k.at[chain_ix, idx].set(
                k_rows, mode="drop", unique_indices=True)
        elif store_mode == "chain":
            # every store_thin-th iteration's post-accept state at a
            # SHARED slot: one dynamic_update_slice (in-place in the
            # scan), skipped by a scalar cond otherwise. Thinning makes
            # the stored window span store_thin * nsamples iterations —
            # the ESS lever for slow-mixing targets (thinned MCMC
            # estimates lose almost nothing when autocorrelation >> 1).
            rel = store_base + it

            def do_store(bufs):
                bm, bk = bufs
                m_rows, k_rows = make_rows()
                slot = jnp.clip((rel - ndraws) // store_thin, 0,
                                nsamples - 1)
                bm = lax.dynamic_update_slice_in_dim(
                    bm, m_rows[:, None, :], slot, axis=1)
                bk = lax.dynamic_update_slice_in_dim(
                    bk, k_rows[:, None, :], slot, axis=1)
                return bm, bk

            span = ndraws + nsamples * store_thin
            buf_m, buf_k = lax.cond(
                (rel >= ndraws) & (rel < span)
                & ((rel - ndraws) % store_thin == 0), do_store,
                lambda bufs: bufs, (buf_m, buf_k))
        nacc = nacc + accept.astype(nacc.dtype)

        stats = jnp.stack([accept.astype(dtype), U, u_data, u_model,
                           L.astype(dtype)], axis=-1)  # (C, 5)
        if wstate is not None:
            # per-chain running moments of the post-accept position
            w_mean, w_m2, w_count = wstate
            cnt = w_count + 1.0
            delta = x - w_mean
            w_mean = w_mean + delta / cnt
            w_m2 = w_m2 + delta * (x - w_mean)
            return (x, U, g, u_data, u_model, nacc, buf_m, buf_k,
                    w_mean, w_m2, cnt), stats
        return (x, U, g, u_data, u_model, nacc, buf_m, buf_k), stats

    def one_iteration(carry, key_P):
        key, it, P, dt, inv_mass, store_base = key_P
        if welford:
            (x, U, g, u_data, u_model, nacc, buf_m, buf_k,
             w_mean, w_m2, w_count) = carry
        else:
            x, U, g, u_data, u_model, nacc, buf_m, buf_k = carry
        potential_fn = lambda xx, aa: pot_raw(xx, aa, P)
        C = x.shape[0]
        kL, kp, ku = random.split(key, 3)
        if inv_mass is None:
            # reference kinetic: K = p.p/2 with p ~ N(0, Sigma^2)
            # (inversion/hmc.py:44-50,95 — a tempering quirk, preserved)
            p0 = random.normal(kp, x.shape, dtype) * Sigma
            K0 = 0.5 * jnp.sum(p0 * p0, axis=-1)
        else:
            # proper diagonal metric: p ~ N(0, M), K = p^T M^-1 p / 2
            p0 = random.normal(kp, x.shape, dtype) / jnp.sqrt(inv_mass)
            K0 = 0.5 * jnp.sum(inv_mass * p0 * p0, axis=-1)
        H0 = K0 + U
        # first half kick
        p = p0 - 0.5 * dt * g

        if shared_L:
            # one trajectory length per iteration shared by all chains:
            # exactly L device steps, no masked-step waste (the masked
            # scan below always runs Lmax steps, so on average it spends
            # (Lmax - E[L]) / Lmax of its products on passed-through
            # steps). Statistically equivalent: L is drawn
            # independently of the chain state either way, and sharing
            # one draw across chains leaves each chain's marginal kernel
            # unchanged (the reference also redraws L per iteration,
            # inversion/hmc.py:297).
            L_scalar = random.randint(kL, (), Lmin, Lmax + 1)
            L = jnp.full((C,), L_scalar)

            def leapfrog_step(i, state):
                x, p, U_l, g_l, ud_l, um_l = state
                x = x + dt * (p if inv_mass is None else inv_mass * p)
                if mandatory:
                    over = x > high
                    under = x < low
                    x = jnp.clip(x, low, high)
                    p = jnp.where(over | under, -p, p)
                elif reflective:
                    for _ in range(4):
                        over = x > high
                        under = x < low
                        x = jnp.where(over, 2 * high - x, x)
                        x = jnp.where(under, 2 * low - x, x)
                        p = jnp.where(over | under, -p, p)
                    x = jnp.clip(x, low, high)
                U_l, g_l, (_, ud_l, um_l) = potential_fn(x, alpha_c)
                p = p - dt * g_l
                return (x, p, U_l, g_l, ud_l, um_l)

            state0 = (x, p, U, g, u_data, u_model)
            (x_new, p_new, U_new, g_new, ud_new, um_new) = lax.fori_loop(
                0, L_scalar, leapfrog_step, state0)
            # the loop applies full kicks everywhere; restore the trailing
            # half kick of the standard leapfrog
            p_new = p_new + 0.5 * dt * g_new
        else:
            L = random.randint(kL, (C,), Lmin, Lmax + 1)  # per-chain length

            def leapfrog_step(state, i):
                x, p, U_l, g_l, ud_l, um_l = state
                active = (i < L)[:, None]  # (C, 1)
                x_new = x + dt * (p if inv_mass is None else inv_mass * p)
                p_new = p
                if mandatory:
                    over = x_new > high
                    under = x_new < low
                    x_new = jnp.clip(x_new, low, high)
                    p_new = jnp.where(over | under, -p_new, p_new)
                elif reflective:
                    # true billiard reflection — the variant the reference
                    # keeps commented out (inversion/hmc.py:128-134); a
                    # bounded number of folds handles multi-crossings
                    for _ in range(4):
                        over = x_new > high
                        under = x_new < low
                        x_new = jnp.where(over, 2 * high - x_new, x_new)
                        x_new = jnp.where(under, 2 * low - x_new, x_new)
                        p_new = jnp.where(over | under, -p_new, p_new)
                    x_new = jnp.clip(x_new, low, high)
                U_new, g_new, (_, ud_new, um_new) = potential_fn(x_new,
                                                                 alpha_c)
                # full kick inside the trajectory, half kick on the last
                last = (i == L - 1)[:, None]
                kick = jnp.where(last, 0.5 * dt, dt)
                p_new = p_new - kick * g_new
                # masked update: steps beyond this chain's L pass through
                x = jnp.where(active, x_new, x)
                p = jnp.where(active, p_new, p)
                U_l = jnp.where(active[:, 0], U_new, U_l)
                ud_l = jnp.where(active[:, 0], ud_new, ud_l)
                um_l = jnp.where(active[:, 0], um_new, um_l)
                g_l = jnp.where(active, g_new, g_l)
                return (x, p, U_l, g_l, ud_l, um_l), None

            state0 = (x, p, U, g, u_data, u_model)
            (x_new, p_new, U_new, g_new, ud_new, um_new), _ = lax.scan(
                leapfrog_step, state0, jnp.arange(Lmax))

        if inv_mass is None:
            K_new = 0.5 * jnp.sum(p_new * p_new, axis=-1)
        else:
            K_new = 0.5 * jnp.sum(inv_mass * p_new * p_new, axis=-1)
        H_new = K_new + U_new
        u = random.uniform(ku, (C,), dtype)
        accept = (H_new < H0) | (u < jnp.exp(-(H_new - H0)))
        acc_col = accept[:, None]
        x = jnp.where(acc_col, x_new, x)
        U = jnp.where(accept, U_new, U)
        g = jnp.where(acc_col, g_new, g)
        u_data = jnp.where(accept, ud_new, u_data)
        u_model = jnp.where(accept, um_new, u_model)

        return _finish(x, U, g, u_data, u_model, accept, L, it,
                       store_base, nacc, buf_m, buf_k,
                       (w_mean, w_m2, w_count) if welford else None)

    # carry donation: the (C, nsamples, M) sample buffer dominates the
    # carry (1.6 GB at bench scale); donating it lets XLA update it in
    # place instead of copying it every chunk
    @partial(jax.jit, donate_argnums=(0,))
    def _run_chunk_impl(carry, base_key, chunk_idx, params, dt, inv_mass,
                        store_base):
        # key derivation inside jit: one dispatch per chunk
        dt = jnp.asarray(dt, dtype)
        if inv_mass is not None:
            inv_mass = jnp.asarray(inv_mass, dtype)
        key = random.fold_in(base_key, chunk_idx)
        keys = random.split(key, chunk_size)
        carry, stats = lax.scan(
            lambda c, ki: one_iteration(
                c, (ki[0], ki[1], params, dt, inv_mass, store_base)),
            carry, (keys, jnp.arange(chunk_size, dtype=jnp.int32)))
        return carry, stats

    def run_chunk(carry, base_key, chunk_idx, params, dt=dt_default,
                  inv_mass=None, store_base=0):
        # the first inv_mass!=None call compiles once more. store_base
        # (chain store_mode only) counts iterations already run since the
        # last storage reset; passed as a traced scalar so successive
        # chunks replay one executable.
        return _run_chunk_impl(carry, base_key, chunk_idx, params, dt,
                               inv_mass, jnp.asarray(store_base, jnp.int32))

    # the jitted chunk itself, for ahead-of-time lowering (its compiled
    # memory analysis); arguments as run_chunk passes them
    run_chunk.jitted = _run_chunk_impl
    return run_chunk


class HamiltonianMC:
    """Chain ensemble sampler with the reference's run semantics.

    Construction mirrors the reference's attribute-driven setup
    (reference: inversion/hmc.py:29-42,358-403); :func:`HMCSample` is the
    compatible factory.
    """

    def __init__(self, model):
        self.model = model
        self.dt = None
        self.Lrange = [10, 50]
        self.Sigma = 1.0
        self.seed = 0
        self.myrank = 0
        self.save_folder = "mychain"
        self.constraint = "mandatory"
        self.log_factor = 1000.0
        self.RegulFactor = 1.0
        self.regularization = "Damping"
        self.beta = 0.01
        self.nchains = 1
        self.chunk_size = 64
        self.dtype = jnp.float32
        self.verbose = True
        self.write_files = True
        #: dual-averaging step-size adaptation during the first
        #: ``adapt_chunks`` chunks (an extension the reference lacks; off by
        #: default to preserve its fixed-dt semantics)
        self.adapt_step_size = False
        self.adapt_target = 0.8
        self.adapt_chunks = 10
        #: Stan-style windowed warmup: tune dt for ~0.4*adapt_chunks
        #: chunks, accumulate Welford moments of the position for the next
        #: ~0.4 window, switch the kinetic to K = p^T M^-1 p / 2 with
        #: inverse mass = estimated posterior variance, re-tune dt under
        #: the new metric, then freeze. Implies step-size re-tuning, and
        #: the sample buffer is reset when the kernel freezes so every
        #: stored sample comes from the frozen kernel. The reference's
        #: Sigma-scaled identity quirk is kept when off.
        self.adapt_mass = False
        #: share one trajectory-length draw per iteration across chains —
        #: no masked-step waste (see make_chunk_sampler), same
        #: per-chain marginal kernel. False reproduces the reference's
        #: independent per-chain draws exactly.
        self.shared_L = False
        #: sample-storage discipline (see :func:`make_chunk_sampler`):
        #: 'accepted' = reference parity (only accepted states stored, per
        #: chain); 'chain' = textbook MH estimator (post-accept state
        #: every iteration, shared slot — one in-place
        #: dynamic_update_slice instead of a scatter). 'accepted' stays
        #: the DEFAULT for reference parity only — existing
        #: post-processing compares sample files row-for-row against the
        #: reference's accepted-only model.dat; throughput-critical runs
        #: pass store_mode='chain' (the bench and the global flagship
        #: both do).
        self.store_mode = "accepted"
        #: chain-mode thinning stride: store every k-th iteration so the
        #: buffer spans k*nsamples iterations (the ESS lever when the
        #: target mixes slowly; thinned estimates lose almost nothing at
        #: autocorrelation >> 1)
        self.store_thin = 1
        #: target temperature: the potential becomes U/T. 1.0 preserves
        #: the reference objective; 2*sigma_noise^2 makes exp(-U/T) the
        #: honest Gaussian-likelihood posterior (the calibration mode the
        #: adaptive samplers use — see GravMagModule.make_potential).
        self.temperature = 1.0
        #: add the logistic-transform log-Jacobian to the potential
        #: (constraint='logarithmic' only): the sampled density is then
        #: the true box-constrained posterior in x-space, not the
        #: unweighted pullback. Required for calibrated uncertainty.
        self.jacobian = False
        #: multi-chip SPMD: a (chains, model) ``jax.sharding.Mesh``
        #: (parallel.make_mesh). When set, sample() builds the potential
        #: via parallel.make_sharded_potential — the kernel matrix is
        #: column-sharded over 'model' (the matvec ends in a psum) and
        #: the chain batch shards over 'chains' — and places the whole carry
        #: (state, sample buffers, Welford moments) with matching
        #: NamedShardings, so the COMPLETE feature set (windowed warmup,
        #: chain store, thinning, checkpointing) runs sharded. Requires
        #: the 'mandatory' constraint and a materialised kernel matrix;
        #: nchains must tile the 'chains' axis. The reference's analogue
        #: was mpiexec ranks that each rebuilt the full kernel
        #: (run_main.sh:18).
        self.spmd_mesh = None
        #: transfer the posterior sample buffers to host at the end of
        #: sample(). Set False to keep the posterior on the device:
        #: the run then moves ONLY scalars end to end — ESS is computed on
        #: device (diagnostics.ess_jax), results keep device arrays in
        #: 'samples_device', and file writing is skipped.
        self.transfer_samples = True
        # filled by HMCSample()
        self.low = None
        self.high = None
        self.initial_model = None
        self.aprior_model = None
        self.dobs = None

    # ------------------------------------------------------------------
    def _writers(self):
        """Per-chain append-mode sample sinks in the reference's file
        layout: ``<save_folder><chain>/model.dat`` etc."""
        folders = [f"{self.save_folder}{self.myrank + c}"
                   for c in range(self.nchains)]
        try:
            from ..runtime.sink import SampleSink
            return [SampleSink(f) for f in folders]
        except Exception:
            from ..runtime.sink_py import PySampleSink
            return [PySampleSink(f) for f in folders]

    def sample(self, nsamples, ndraws, max_chunks=None, callback=None,
               checkpoint_path=None, checkpoint_every=20, resume=True):
        """Run until every chain has ``ndraws + nsamples`` accepted samples.

        ``checkpoint_path`` snapshots the full sampler state every
        ``checkpoint_every`` chunks and resumes from it when present
        (exact continuation — chunk keys are derived from the chunk index;
        with adaptation on, snapshots start only after the kernel freezes).
        Returns a dict with posterior sample arrays, file paths and
        throughput stats.

        The chunk carry is DONATED to the jitted chunk: arrays a
        ``callback`` receives are invalidated by the next chunk — copy
        them (``np.asarray``) inside the callback if they must outlive it.
        """
        C = self.nchains
        M = self.initial_model.shape[0]
        total = nsamples + ndraws
        dtype = self.dtype

        if self.spmd_mesh is not None:
            # multi-chip: column-sharded kernel + sharded chain batch
            # (parallel/sharded.py). Same (fn, params) Potential
            # interface, so everything below — adaptation, storage,
            # checkpointing — runs unchanged over the sharded arrays.
            from ..parallel.sharded import make_sharded_potential
            if self.constraint != "mandatory":
                raise ValueError("spmd_mesh supports the 'mandatory' "
                                 "boundary constraint only")
            if self.jacobian or float(self.temperature) != 1.0:
                raise ValueError("spmd_mesh does not support "
                                 "temperature/jacobian potentials yet")
            mod = self.model
            if getattr(mod, "Aw", None) is None:
                raise ValueError("spmd_mesh needs a materialised kernel "
                                 "matrix (module.Aw)")
            active = getattr(getattr(mod, "mesh", None), "active", None)
            potential_fn, _ = make_sharded_potential(
                self.spmd_mesh, mod.Aw, self.dobs, self.aprior_model,
                self.low, self.high,
                grav_fix=(np.asarray(mod.grav_fix)
                          if getattr(mod, "fixed", False) else None),
                regularization=self.regularization, beta=self.beta,
                wm_sq=np.asarray(mod.wdiag) ** 2,
                mshape=getattr(mod, "mshape", None), active=active,
                dtype=dtype)
        else:
            potential_fn = self.model.make_potential(
                self.aprior_model, self.low, self.high,
                constraint=self.constraint, log_factor=self.log_factor,
                regularization=self.regularization, beta=self.beta,
                dtype=dtype, jacobian=self.jacobian,
                temperature=float(self.temperature))

        # convert m-domain init to the optimisation variable x. A
        # device-resident initial model (e.g. the cg_device warm start at
        # global scale) stays on device — broadcasting via numpy would
        # copy it to the host.
        xp = jnp if isinstance(self.initial_model, jax.Array) else np
        mw0 = xp.broadcast_to(self.initial_model, (C, M))
        if xp is np:
            mw0 = mw0.astype(np.float64)
        if self.constraint == "logarithmic":
            # a warm start can sit EXACTLY on a bound (the projected CG
            # clips there); pull it strictly inside so the transform
            # stays finite
            eps_b = 1e-6
            span = self.high - self.low
            mw0 = xp.clip(mw0, self.low + eps_b * span,
                          self.high - eps_b * span)
            x0 = mw_to_logistic(mw0, self.low, self.high, self.log_factor,
                                xp=xp)
        elif self.constraint in ("mandatory", "reflective"):
            x0 = mw0
        else:
            raise ValueError(
                "Please choose right boundary constraint(mandatory, "
                "logarithmic)!")

        run_chunk = make_chunk_sampler(
            potential_fn, dt=self.dt, Lmin=self.Lrange[0],
            Lmax=self.Lrange[1], Sigma=self.Sigma, low=self.low,
            high=self.high, constraint=self.constraint,
            alpha=self.RegulFactor, chunk_size=self.chunk_size,
            nsamples=nsamples, ndraws=ndraws,
            wdiag_inv=self.model.wdiag_inv, data_size=self.dobs.shape[0],
            log_factor=self.log_factor, dtype=dtype,
            shared_L=self.shared_L, welford=self.adapt_mass, store_mode=self.store_mode,
            store_thin=self.store_thin)

        x = jnp.asarray(x0, dtype)
        spmd_shards = None
        if self.spmd_mesh is not None:
            from ..parallel.sharded import carry_shardings
            spmd_shards = carry_shardings(self.spmd_mesh,
                                          welford=self.adapt_mass)
            x = jax.device_put(x, spmd_shards[0])
        U, g, (_, u_data, u_model) = potential_fn(x, self.RegulFactor)
        pot_params = getattr(potential_fn, "params", None)
        base_key = random.fold_in(random.PRNGKey(self.seed), self.myrank)
        carry = (x, U, g, u_data, u_model,
                 jnp.zeros(C, jnp.int32),
                 jnp.zeros((C, nsamples, M), dtype),
                 jnp.zeros((C, nsamples, 7), dtype))
        if self.adapt_mass:
            carry = carry + (jnp.zeros((C, M), dtype),
                             jnp.zeros((C, M), dtype),
                             jnp.zeros((), dtype))
        if spmd_shards is not None:
            # place every carry leaf (state, 7-col stats, sample buffers,
            # Welford moments) on the mesh so the donated chunk jit keeps
            # the layout instead of replicating the big buffers
            carry = tuple(jax.device_put(c, s)
                          for c, s in zip(carry, spmd_shards))
        start_chunk = 0
        chain_mode = self.store_mode == "chain"
        store_iters = 0  # iterations run with storage active (chain mode)
        ckpt_meta = {"nsamples": nsamples, "ndraws": ndraws, "nchains": C,
                     "M": M, "seed": self.seed, "myrank": self.myrank,
                     "store_mode": self.store_mode,
                     "adapt": [bool(self.adapt_step_size),
                               bool(self.adapt_mass),
                               int(self.adapt_chunks)]}
        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            from ..checkpoint import load_state
            carry, start_chunk, base_key, meta = load_state(
                checkpoint_path, like_carry=carry)
            meta = dict(meta)
            store_iters = int(meta.pop("store_iters", 0))
            # checkpoints written before store_mode existed imply the
            # then-only 'accepted' discipline — default it like
            # store_iters instead of failing the equality check
            meta.setdefault("store_mode", "accepted")
            if meta != ckpt_meta:
                raise ValueError(
                    f"checkpoint config mismatch: {meta} != {ckpt_meta}")
            if self.verbose:
                print(f"resumed from {checkpoint_path} at chunk "
                      f"{start_chunk}", flush=True)

        data_size = self.dobs.shape[0]
        model_size = M
        alpha = self.RegulFactor
        attempted = 0
        grad_evals = 0
        # ---- warmup adaptation schedule (Stan-style windows over chunks):
        #   [1, w1]          dual-average dt under the initial kinetic
        #   slow windows     DOUBLING Welford windows; at each window end
        #                    the diagonal metric is re-estimated from that
        #                    window alone and DA re-seeded — early windows
        #                    measure the initial descent, only the last
        #                    (longest) window sees posterior-scale motion
        #                    (Stan 25/50/100... rationale)
        #   final w_f        re-tune dt under the final metric
        #   at W             freeze dt, RESET the accept counters so no
        #                    stored sample was drawn under a still-changing
        #                    kernel (non-diminishing adaptation during
        #                    collection biases the posterior buffer)
        # adapt_mass implies step-size re-tuning; without adapt_mass the
        # schedule degenerates to a single DA window of W chunks.
        adapting = self.adapt_step_size or self.adapt_mass
        W = int(self.adapt_chunks) if adapting else 0
        metric_switches = []  # chunk indices where the metric updates
        if self.adapt_mass:
            W = max(W, 8)
            w1 = max(1, W // 10)
            # the final window must give dual averaging enough updates to
            # settle after its last re-init, or the frozen log_eps_avg is
            # dominated by the early oscillation
            w_f = max(3, W // 5)
            slow_total = W - w1 - w_f
            base = max(1, slow_total // 7)  # 1+2+4 doubling fills ~7x
            lens, acc, cur = [], 0, base
            while acc + cur < slow_total and len(lens) < 6:
                lens.append(cur)
                acc += cur
                cur *= 2
            lens.append(slow_total - acc)
            edge = w1
            for ln in lens:
                edge += ln
                metric_switches.append(edge)
        else:
            w1 = W
        if max_chunks is None:
            max_chunks = max(200, 100 * total // self.chunk_size + 10) + W

        # device-side reduction of the per-chunk stats block: only a few
        # SCALARS reach the host per chunk, instead of the raw (chunk, C,
        # 5) stats (2.6 MB/chunk at 1024x128).
        @jax.jit
        def _reduce_stats(stats, nacc):
            return (jnp.isfinite(stats).all(),
                    jnp.sum(stats[..., 4]),          # grad evals
                    jnp.sum(stats[..., 0]),          # accepts this chunk
                    jnp.mean(stats[..., 0]),         # chunk accept rate
                    stats[-1, 0, 2], stats[-1, 0, 3],  # chain-0 ud/um
                    jnp.min(nacc), jnp.sum(nacc))

        t0 = time.time()
        n_chunks = start_chunk
        acc_min = int(jnp.min(carry[5]))
        acc_sum = int(jnp.sum(carry[5]))
        dt_cur = float(self.dt)
        inv_mass = None
        da = None
        frozen = not adapting
        if adapting:
            from .nuts import dual_averaging_init, dual_averaging_update
            da = dual_averaging_init(dt_cur, target=self.adapt_target)
        # chain store_mode: storage progress is ITERATION-driven (every
        # store_thin-th iteration stores the post-accept state once the
        # kernel is frozen); accepted mode waits for per-chain accept
        # counts
        STORE_OFF = -(2 ** 30)  # rel stays < ndraws -> the cond skips
        chain_span = ndraws + nsamples * self.store_thin

        def storage_done():
            return (store_iters >= chain_span) if chain_mode \
                else (acc_min >= total)

        while not (storage_done() and frozen):
            if n_chunks >= max_chunks:
                print(f"WARNING: stopping after {n_chunks} chunks with "
                      f"min accepted count {acc_min}")
                break
            counted = frozen  # this chunk runs with storage active
            carry, stats_d = run_chunk(
                carry, base_key, n_chunks, pot_params, dt_cur, inv_mass,
                store_base=(store_iters if frozen else STORE_OFF))
            (finite_d, ge_d, acc_chunk_d, acc_rate_d, ud_d, um_d,
             amin_d, asum_d) = _reduce_stats(stats_d, carry[5])
            # scalar transfers only
            if not bool(finite_d):
                # failure detection (the reference had none — its global run
                # died silently to the OOM killer, SURVEY.md §5): stop with
                # a diagnosis instead of writing poisoned samples. The
                # per-chain mask transfer (C bytes) happens only on failure.
                chain_ok = np.asarray(
                    jnp.isfinite(stats_d[..., 1]).all(axis=0))
                bad = np.flatnonzero(~chain_ok)
                raise FloatingPointError(
                    f"non-finite potential in chains {bad.tolist()} at "
                    f"chunk {n_chunks} (dt={self.dt}, Sigma={self.Sigma}); "
                    "reduce the step size or check the kernel matrix. "
                    + (f"Last good state: {checkpoint_path}"
                       if checkpoint_path else
                       "Set checkpoint_path to make such runs resumable."))
            acc_min = int(amin_d)
            acc_sum = int(asum_d)
            n_chunks += 1
            attempted += self.chunk_size * C
            grad_evals += int(ge_d)
            if counted:
                store_iters += self.chunk_size
            if self.verbose:
                frac = (min(store_iters / chain_span, 1.0) if chain_mode
                        else min(acc_min / total, 1.0))
                ratio = acc_sum / attempted
                ud_l = float(ud_d)
                um_l = float(um_d)
                print("chain {}: {:.2%}, misfit(total, data, alpha, model)="
                      "({:.7f},{:.7f},{:.2f},{:.7f}) -- accept ratio {:.2%}"
                      .format(self.myrank, frac,
                              ud_l / data_size + alpha * um_l / model_size,
                              ud_l / data_size, alpha, um_l / model_size,
                              ratio),
                      flush=True)
            if not frozen:
                da = dual_averaging_update(da, float(acc_rate_d))
                dt_cur = float(np.exp(da["log_eps"]))
                if self.adapt_mass and n_chunks == w1:
                    # open the first Welford window: discard the initial
                    # transient's moments
                    carry = carry[:8] + (jnp.zeros_like(carry[8]),
                                         jnp.zeros_like(carry[9]),
                                         jnp.zeros_like(carry[10]))
                if self.adapt_mass and n_chunks in metric_switches:
                    # inverse mass = pooled per-chain variance of THIS
                    # window with Stan's shrinkage toward unity (nuts.py
                    # welford_variance rationale), computed on device
                    cnt = carry[10]
                    var = jnp.mean(carry[9], axis=0) / jnp.maximum(
                        cnt - 1.0, 1.0)
                    n_draws_used = cnt * C
                    var = (n_draws_used / (n_draws_used + 5.0)) * var \
                        + 1e-3 * (5.0 / (n_draws_used + 5.0))
                    new_inv_mass = jnp.clip(var, 1e-12, None)
                    med_std = float(jnp.median(jnp.sqrt(new_inv_mass)))
                    if inv_mass is None:
                        # first switch: the kinetic changes from the
                        # reference's Sigma-scaled identity to the proper
                        # diagonal metric — re-seed dt at a matched
                        # position-step scale (dx ~ dt*Sigma before,
                        # dt*std after)
                        dt_cur = float(np.clip(
                            dt_cur * float(self.Sigma)
                            / max(med_std, 1e-30), 1e-10, 1e6))
                    inv_mass = new_inv_mass
                    da = dual_averaging_init(dt_cur,
                                             target=self.adapt_target)
                    # fresh Welford window for the next (longer) estimate
                    carry = carry[:8] + (jnp.zeros_like(carry[8]),
                                         jnp.zeros_like(carry[9]),
                                         jnp.zeros_like(carry[10]))
                    if self.verbose:
                        print(f"adapted diagonal mass at chunk {n_chunks} "
                              f"(median std {med_std:.4g}); re-tuning dt "
                              f"from {dt_cur:.5g}", flush=True)
                if n_chunks == W:
                    dt_cur = float(np.exp(da["log_eps_avg"]))
                    frozen = True
                    # storage gate: every sample in the buffer must be
                    # drawn by the FROZEN kernel — reset the accept
                    # counters (rows are overwritten as fresh accepts
                    # arrive; n_stored derives from nacc) and the
                    # throughput counters
                    carry = (carry[:5] + (jnp.zeros_like(carry[5]),)
                             + carry[6:])
                    acc_min, acc_sum, attempted = 0, 0, 0
                    store_iters = 0
                    if self.verbose:
                        print(f"warmup done at chunk {n_chunks}: frozen "
                              f"dt={dt_cur:.5g}; sample storage reset",
                              flush=True)
            elif (adapting and acc_min == 0
                    and float(acc_rate_d) < 0.25 * self.adapt_target):
                # emergency brake: the frozen dt rejects (almost)
                # everything and nothing is stored yet — halve dt and
                # reset the (empty) counters so storage stays consistent
                # with one kernel. Cannot trigger once samples exist.
                dt_cur *= 0.5
                carry = (carry[:5] + (jnp.zeros_like(carry[5]),)
                         + carry[6:])
                attempted, acc_sum = 0, 0
                store_iters = 0
                if self.verbose:
                    print(f"post-freeze accept "
                          f"{float(acc_rate_d):.2%} — halving dt to "
                          f"{dt_cur:.5g}", flush=True)
            if callback is not None:
                # per-chain counters transfer only when a callback asks
                callback(np.asarray(carry[5]).astype(np.int64), carry[0])
            if (checkpoint_path and frozen
                    and n_chunks % checkpoint_every == 0):
                # checkpoints only once the kernel is frozen: DA/metric
                # state is host-side and not snapshotted
                from ..checkpoint import save_state
                save_state(checkpoint_path, carry, n_chunks, base_key,
                           meta=dict(ckpt_meta, store_iters=store_iters))
        if checkpoint_path:
            from ..checkpoint import save_state
            save_state(checkpoint_path, carry, n_chunks, base_key,
                       meta=dict(ckpt_meta, store_iters=store_iters))
        elapsed = time.time() - t0

        accepted = np.asarray(carry[5]).astype(np.int64)  # (C,) ints
        if chain_mode:
            # every chain stores at every store_thin-th post-freeze
            # iteration
            done_iters = max(store_iters - ndraws, 0)
            n_stored = np.full(
                C, min((done_iters + self.store_thin - 1)
                       // self.store_thin, nsamples), dtype=np.int64)
        else:
            n_stored = np.minimum(np.maximum(accepted - ndraws, 0),
                                  nsamples)
        n_common = int(n_stored.min())

        if not self.transfer_samples:
            # device-resident finish: scalars only. ESS on device, buffers
            # stay.
            ess_per_s = None
            if n_common >= 8:
                from ..diagnostics import ess_jax
                sub = np.random.RandomState(0).choice(
                    M, size=min(M, 128), replace=False)
                ess = ess_jax(carry[6][:, :n_common, jnp.asarray(sub)])
                ess_per_s = float(jnp.median(ess)) / max(elapsed, 1e-9)
            return {
                "samples": None,
                "samples_device": carry[6],
                "misfits": None,
                "misfits_device": carry[7],
                "n_stored": n_stored,
                "folders": [],
                "accepted": accepted.tolist(),
                "attempted": attempted,
                "accept_ratio": float(accepted.sum()) / max(attempted, 1),
                "elapsed_s": elapsed,
                "grad_evals": grad_evals,
                "grad_evals_per_s": grad_evals / max(elapsed, 1e-9),
                "step_size": dt_cur,
                "adapted_mass": inv_mass is not None,
                "ess_per_s_median": ess_per_s,
            }

        # one bulk transfer of the posterior buffers
        buf_m = np.asarray(carry[6], dtype=np.float64)
        buf_k = np.asarray(carry[7], dtype=np.float64)

        # ESS/s over a parameter subsample (north-star metric,
        # BASELINE.json; full-M autocorrelation would dominate runtime)
        ess_per_s = None
        if n_common >= 8:
            from ..diagnostics import effective_sample_size
            rng = np.random.RandomState(0)
            sub = rng.choice(M, size=min(M, 128), replace=False)
            ess = effective_sample_size(buf_m[:, :n_common, :][:, :, sub])
            ess_per_s = float(np.median(ess)) / max(elapsed, 1e-9)

        folders = []
        if self.write_files:
            writers = self._writers()
            for c, w in enumerate(writers):
                for i in range(int(n_stored[c])):
                    w.append(buf_m[c, i], buf_k[c, i])
                w.close()
            folders = [w.folder for w in writers]

        return {
            "samples": buf_m,
            "misfits": buf_k,
            "n_stored": n_stored,
            "folders": folders,
            "accepted": accepted.tolist(),
            "attempted": attempted,
            "accept_ratio": float(accepted.sum()) / max(attempted, 1),
            "elapsed_s": elapsed,
            "grad_evals": grad_evals,
            "grad_evals_per_s": grad_evals / max(elapsed, 1e-9),
            "step_size": dt_cur,
            "adapted_mass": inv_mass is not None,
            "inv_mass": (np.asarray(inv_mass)
                         if inv_mass is not None else None),
            "ess_per_s_median": ess_per_s,
        }


# reference-compatible misspelled alias (inversion/hmc.py:29)
HamitonianMC = HamiltonianMC


def HMCSample(model, nsamples, ndraws, delta, Lrange, initial_model,
              aprior_model, boundaries, constraint, log_factor, dobs,
              adaptiveRegul=None, RegulRate=None, RegulFactor=1.0,
              regularization="Damping", beta=0.01, seed=100, Sigma=1.0,
              nbest=100, myrank=0, save_folder="mychain", plotsamples=False,
              im=(0, 0), nchains=1, chunk_size=64, dtype=jnp.float32,
              verbose=True, write_files=True, adapt_step_size=False,
              adapt_target=0.8, adapt_mass=False, adapt_chunks=10,
              shared_L=False, transfer_samples=True,
              store_mode="accepted", store_thin=1, spmd_mesh=None,
              jacobian=False, temperature=1.0):
    """Reference-compatible chain factory (inversion/hmc.py:358-403).

    ``nchains`` extends the reference: instead of one chain per MPI rank,
    C chains run vmapped on-device, writing ``save_folder{myrank + c}/``
    so multi-chain post-processing scripts read the same layout.
    ``adaptiveRegul``/``RegulRate``/``nbest``/``plotsamples``/``im`` are
    accepted for parity; the first three were dead code in the reference
    (inversion/hmc.py:53-68 never called from sample) and plotting lives in
    the vis layer here.
    """
    chain = HamiltonianMC(model)
    chain.myrank = myrank
    chain.save_folder = save_folder
    chain.seed = seed + myrank
    chain.constraint = constraint
    chain.log_factor = log_factor
    chain.Lrange = list(Lrange)
    chain.dt = delta
    chain.Sigma = Sigma
    chain.RegulFactor = RegulFactor
    chain.regularization = regularization
    chain.beta = beta
    chain.nchains = nchains
    chain.chunk_size = chunk_size
    chain.dtype = dtype
    chain.verbose = verbose
    chain.write_files = write_files
    chain.adapt_step_size = adapt_step_size
    chain.adapt_target = adapt_target
    chain.adapt_mass = adapt_mass
    chain.adapt_chunks = adapt_chunks
    chain.shared_L = shared_L
    chain.transfer_samples = transfer_samples
    chain.store_mode = store_mode
    chain.store_thin = store_thin
    chain.spmd_mesh = spmd_mesh
    chain.jacobian = jacobian
    chain.temperature = temperature

    boundaries = np.asarray(boundaries, dtype=np.float64)
    # device-resident weighting (kernel_device path) scales on device —
    # np.asarray here would copy it to the host; likewise a
    # device-resident initial model (cg_device warm start)
    wdiag = (model.wdiag if isinstance(model.wdiag, jax.Array)
             else np.asarray(model.wdiag))

    def _as_vec(v):
        return v if isinstance(v, jax.Array) \
            else np.asarray(v, dtype=np.float64)

    # m-domain -> mw-domain (reference: inversion/hmc.py:393-401)
    chain.low = wdiag * boundaries[:, 0]
    chain.high = wdiag * boundaries[:, 1]
    chain.initial_model = wdiag * _as_vec(initial_model)
    chain.aprior_model = wdiag * _as_vec(aprior_model)
    chain.dobs = np.asarray(dobs, dtype=np.float64)

    return chain.sample(nsamples, ndraws)
