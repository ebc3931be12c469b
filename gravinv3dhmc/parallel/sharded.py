"""Multi-chip sharded HMC: chains x model-column partitioning.

The reference's only parallelism is embarrassingly-parallel MPI ranks that
each rebuild the full kernel matrix (reference: run_main.sh:18,
example/uniformgrid/main_uniform.py:19-22, zero collectives anywhere).
Here the two scale axes map onto a 2-D ``jax.sharding.Mesh``:

* ``chains`` — data parallelism: each device group owns a slice of the
  vmapped chain batch (replaces mpiexec ranks);
* ``model`` — tensor parallelism: the dense sensitivity matrix ``Aw`` is
  column-sharded, so each device holds A[:, local] and the predicted data
  ``Aw @ mw`` is a partial sum combined by an XLA-inserted ``psum``
  across devices. The transpose product ``Aw^T r`` needs no collective (rows of the
  result live where the columns live).

Everything is expressed with ``NamedSharding`` annotations on the kernel
matrix and the chain state; GSPMD inserts the collectives. The kernel
matrix is placed once (device-resident, the OOM'd reference global case is
7200 x 72000 f32 = 2.1 GB, SURVEY.md §7 step 6).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..inversion import hmc as hmc_mod
from ..inversion.potential import A_PRECISION


def make_mesh(n_devices=None, chains_axis=None, devices=None):
    """Build a (chains, model) mesh over the available devices.

    ``chains_axis`` defaults to the largest power-of-two divisor of
    ``n_devices`` that is <= sqrt(n_devices), favouring model sharding for
    memory relief.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.array(devices[:n_devices])
    if chains_axis is None:
        chains_axis = 1
        while (n_devices % (chains_axis * 2) == 0
               and chains_axis * 2 <= int(np.sqrt(n_devices))):
            chains_axis *= 2
    model_axis = n_devices // chains_axis
    return Mesh(devices.reshape(chains_axis, model_axis),
                ("chains", "model"))


def make_sharded_potential(mesh, Aw, dobs, aprior_mw, low, high,
                           grav_fix=None, regularization="Damping",
                           beta=0.01, wm_sq=None, mshape=None, active=None,
                           dtype=jnp.float32):
    """Sharded potential-energy closure.

    ``Aw`` is placed with P(None, 'model') — column-sharded across devices;
    model-space vectors with P('model'); the chain batch enters as
    P('chains', 'model'). The data residual is replicated (D is small).
    Elementwise regularizers (Damping/MS) stay fully sharded.

    Smoothness/TV are grid regularizers: the flat model vector reshapes to
    ``mshape`` = (nz, ny, nx) and first-differences run along all three
    axes (ops/fd.py; reference: inversion/potential.py:786-810). The grid
    is annotated P('model', None, None) when nz divides the 'model' axis —
    the z-differences then need exactly one boundary plane per shard and
    GSPMD inserts the halo exchange (a collective-permute); x/y
    differences stay shard-local. Carved meshes (``active`` mask, packed
    length-M vectors) scatter to the dense grid first, like the
    single-chip path (inversion/potential.py:443-450).
    """
    if regularization not in ("Damping", "MS", "Smoothness", "TV"):
        raise ValueError(
            "Please choose regularization from 'MS','Damping', "
            "'Smoothness', 'TV'.")
    needs_grid = regularization in ("Smoothness", "TV")
    if needs_grid and mshape is None:
        raise ValueError(
            "sharded Smoothness/TV need mshape=(nz, ny, nx) "
            "(and the active mask for carved meshes)")
    from ..inversion.potential import Potential
    from ..ops import fd

    col = NamedSharding(mesh, P(None, "model"))
    vec = NamedSharding(mesh, P("model"))
    rep = NamedSharding(mesh, P())
    dobs_d = jax.device_put(jnp.asarray(dobs, dtype), rep)

    grid_sh = None
    active_idx = None
    active3d_np = None
    if needs_grid:
        mshape = tuple(int(s) for s in mshape)
        nz = mshape[0]
        n_model = int(mesh.shape["model"])
        # shard the dense grid along z when it tiles the 'model' axis —
        # the dz halo is then one plane per shard (GSPMD inserts a
        # collective-permute); otherwise leave the (small) grid replicated
        grid_spec = (P("model", None, None) if nz % n_model == 0
                     else P())
        grid_sh = NamedSharding(mesh, grid_spec)
        if active is not None and not np.asarray(active).all():
            active = np.asarray(active, bool).ravel()
            active_idx = jnp.asarray(np.flatnonzero(active))
            active3d_np = active.reshape(mshape)
    params = {
        "Aw": jax.device_put(jnp.asarray(Aw, dtype), col),
        "dobs_c": dobs_d - jnp.mean(dobs_d),
        "aprior_mw": jax.device_put(jnp.asarray(aprior_mw, dtype), vec),
        "low": jax.device_put(jnp.asarray(low, dtype), vec),
        "high": jax.device_put(jnp.asarray(high, dtype), vec),
        "gfix": (jax.device_put(jnp.asarray(grav_fix, dtype), rep)
                 if grav_fix is not None else None),
        # MS sensitivity weighting Wm^2 (single-chip:
        # inversion/potential.py:334,377; reference:
        # inversion/potential.py:719-736) — sharded like every other
        # model-space vector
        "wm_sq": jax.device_put(
            jnp.asarray(wm_sq if wm_sq is not None
                        else np.ones(np.shape(Aw)[1]), dtype), vec),
    }
    if needs_grid and active_idx is not None:
        params["active_idx"] = jax.device_put(active_idx, rep)
        params["active3d"] = jax.device_put(jnp.asarray(active3d_np), rep)
    has_fix = grav_fix is not None
    has_carve = needs_grid and active_idx is not None
    beta = float(beta)

    def grid_term(dm, prm):
        # packed active-cell vector -> dense (nz, ny, nx) grid, sharded
        # along z; first differences along x/y are shard-local, dz rides
        # a GSPMD halo exchange (single-chip analogue:
        # inversion/potential.py:443-464)
        from ..ops import fd as fd_ops
        if has_carve:
            full = jnp.zeros(int(np.prod(mshape)), dtype=dm.dtype)
            full = full.at[prm["active_idx"]].set(dm)
            act = prm["active3d"]
        else:
            full, act = dm, None
        g3 = jax.lax.with_sharding_constraint(
            jnp.reshape(full, mshape), grid_sh)
        if regularization == "Smoothness":
            return fd_ops.smoothness_value(g3, mshape, jnp, act)
        return fd_ops.tv_value(g3, mshape, beta, jnp, act)

    def potential_scalar(mw, alpha, prm):
        # (M,) sharded on 'model'; contraction over M -> psum over 'model'
        dpre = jnp.matmul(prm["Aw"], mw, precision=A_PRECISION)
        dinv = dpre + prm["gfix"] if has_fix else dpre
        r = (dinv - jnp.mean(dinv)) - prm["dobs_c"]
        u_data = jnp.sum(r * r)
        dm = mw - prm["aprior_mw"]
        if regularization == "Damping":
            u_model = jnp.sum(dm * dm)
        elif regularization == "MS":
            # Wm^2-weighted like the single-chip potential
            dm2 = dm * dm
            u_model = jnp.sum(prm["wm_sq"] * dm2 / (dm2 + beta))
        else:  # Smoothness / TV on the (sharded) dense grid
            u_model = grid_term(dm, prm)
        return u_data + alpha * u_model, (dpre, u_data, u_model)

    grad_fn = jax.value_and_grad(potential_scalar, has_aux=True)

    def fn(x, alpha, prm):
        x = jnp.asarray(x, dtype)
        alpha = jnp.asarray(alpha, dtype)
        if x.ndim == 1:
            (u, aux), g = grad_fn(x, alpha, prm)
            return u, g, aux
        (u, aux), g = jax.vmap(lambda xi: grad_fn(xi, alpha, prm))(x)
        return u, g, aux

    pot = Potential(fn, params)
    shardings = {"low": params["low"], "high": params["high"],
                 "Aw": params["Aw"]}
    return pot, shardings


def carry_shardings(mesh, welford=False):
    """NamedShardings of one sampler-carry tuple, positionally matching
    ``make_chunk_sampler``'s carry layout: chain state P('chains',
    'model'), per-chain scalars P('chains'), sample buffers
    P('chains', None, 'model') / P('chains', None), and (welford) the
    running moments like the chain state with a replicated count."""
    xsh = NamedSharding(mesh, P("chains", "model"))
    csh = NamedSharding(mesh, P("chains"))
    bufm_sh = NamedSharding(mesh, P("chains", None, "model"))
    bufk_sh = NamedSharding(mesh, P("chains", None))
    sh = (xsh, csh, xsh, csh, csh, csh, bufm_sh, bufk_sh)
    if welford:
        sh = sh + (xsh, xsh, NamedSharding(mesh, P()))
    return sh


def welford_metric_switch(carry, min_var=1e-12):
    """Pooled Welford variance -> diagonal inverse mass, moments reset.

    The canonical warmup metric switch over a Welford-carrying sampler
    carry ``(..., w_mean, w_m2, w_count)`` (make_chunk_sampler
    welford=True layout): inverse mass = pooled per-chain variance of
    the window, moments zeroed for the next window. Returns
    ``(carry_with_reset_moments, inv_mass)``. One implementation so the
    carry-index surgery lives in exactly one place (the dryrun, the
    2-process worker and the parity tests all perform this switch).
    """
    var = jnp.mean(carry[9], axis=0) / jnp.maximum(carry[10] - 1.0, 1.0)
    inv_mass = jnp.clip(var, min_var, None)
    carry = carry[:8] + (jnp.zeros_like(carry[8]),
                         jnp.zeros_like(carry[9]),
                         jnp.zeros_like(carry[10]))
    return carry, inv_mass


def make_sharded_chunk_sampler(mesh, potential_fn, *, low, high, M, nchains,
                               nsamples, ndraws, wdiag_inv, data_size,
                               dt=0.01, Lmin=5, Lmax=20, Sigma=0.001,
                               constraint="mandatory", alpha=1.0,
                               chunk_size=8, dtype=jnp.float32,
                               shared_L=False, welford=False,
                               store_mode="accepted", store_thin=1):
    """The full sharded training step: one jitted chunk of HMC iterations.

    Chain state is sharded P('chains', 'model'); the device-resident sample
    buffer P('chains', None, 'model'). Returns (run_chunk, init_carry_fn).

    The sampler features are at parity with the single-chip
    :func:`hmc.make_chunk_sampler` (round-4 froze this wrapper at the
    round-2 argument set): ``shared_L`` (one trajectory-length draw per
    iteration — on a sharded mesh also the configuration whose matvecs
    stay in lockstep across devices), ``welford`` (per-chain running
    moments for the windowed warmup metric; the moment buffers shard
    like the chain state), ``store_mode``/``store_thin`` (in-place
    chain-store vs reference-parity accepted-store), and ``run_chunk``'s
    ``dt``/``inv_mass``/``store_base`` runtime arguments, so
    :class:`hmc.HamiltonianMC`'s full adaptation schedule runs on the
    sharded path (see its ``spmd_mesh`` attribute).
    """
    run_chunk = hmc_mod.make_chunk_sampler(
        potential_fn, dt=dt, Lmin=Lmin, Lmax=Lmax, Sigma=Sigma, low=low,
        high=high, constraint=constraint, alpha=alpha,
        chunk_size=chunk_size, nsamples=nsamples, ndraws=ndraws,
        wdiag_inv=wdiag_inv, data_size=data_size, dtype=dtype,
        shared_L=shared_L, welford=welford, store_mode=store_mode,
        store_thin=store_thin)

    shards = carry_shardings(mesh, welford=welford)

    def init_carry(x0):
        x = jax.device_put(jnp.asarray(x0, dtype), shards[0])
        U, g, (_, u_data, u_model) = potential_fn(x, alpha)
        carry = (
            x, U, g, u_data, u_model,
            jnp.zeros(nchains, jnp.int32),
            jnp.zeros((nchains, nsamples, M), dtype),
            jnp.zeros((nchains, nsamples, 7), dtype),
        )
        if welford:
            carry = carry + (jnp.zeros((nchains, M), dtype),
                             jnp.zeros((nchains, M), dtype),
                             jnp.zeros((), dtype))
        return tuple(jax.device_put(c, s)
                     for c, s in zip(carry, shards))

    return run_chunk, init_carry
