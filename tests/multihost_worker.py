"""Worker process for the real multi-process sharding test.

Launched by tests/test_multihost_proc.py: each of two OS processes owns
two virtual CPU devices; ``jax.distributed.initialize`` joins them into
one 4-device runtime, and the sharded potential + chunk sampler run over
the GLOBAL (chains x model) mesh — GSPMD collectives (the matvec psum)
actually cross the process boundary, unlike the single-process dryrun.

Prints one JSON line with process-local identity plus global reductions
that must AGREE across processes.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    coordinator = sys.argv[1]
    num_procs = int(sys.argv[2])
    pid = int(sys.argv[3])

    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_procs, process_id=pid)
    import jax.numpy as jnp

    from gravinv3dhmc.parallel import multihost, sharded

    assert jax.process_count() == num_procs
    mesh = sharded.make_mesh()  # global: all devices of all processes

    D, M, C = 32, 64, 8
    rng = np.random.RandomState(0)  # same data on every process
    Aw = rng.randn(D, M) * 0.1
    dobs = rng.randn(D)
    low = np.zeros(M)
    high = np.ones(M)
    pot, sh = sharded.make_sharded_potential(
        mesh, Aw, dobs, np.zeros(M), low, high,
        regularization="Damping")
    # the ADAPTIVE feature set on the cross-process mesh: shared-L,
    # Welford moments, chain store with thinning, then a mid-run metric
    # switch with runtime dt — the configuration HamiltonianMC.spmd_mesh
    # actually runs (round-4 froze this wrapper at round-2 arguments)
    run_chunk, init_carry = sharded.make_sharded_chunk_sampler(
        mesh, pot, low=low, high=high, M=M, nchains=C, nsamples=4,
        ndraws=0, wdiag_inv=np.ones(M), data_size=D, dt=0.01,
        Lmin=2, Lmax=4, chunk_size=4, shared_L=True, welford=True,
        store_mode="chain", store_thin=2)
    carry = init_carry(np.full((C, M), 0.5))
    carry, stats = run_chunk(carry, jax.random.PRNGKey(0), 0, pot.params,
                             store_base=-(2 ** 30))
    # metric switch: pooled Welford variance -> diagonal inverse mass
    carry, inv_mass = sharded.welford_metric_switch(carry)
    carry, stats = run_chunk(carry, jax.random.PRNGKey(0), 1, pot.params,
                             dt=0.005, inv_mass=inv_mass, store_base=0)
    # global reductions: every process must compute identical values
    total_U = float(jnp.sum(carry[1]))
    total_acc = int(jnp.sum(carry[5]))
    store_norm = float(jnp.sum(carry[6] * carry[6]))
    welford_count = float(carry[10])
    lo, hi = multihost.chains_for_host(C)
    print(json.dumps({
        "pid": pid,
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "mesh_shape": dict(mesh.shape),
        "total_U": total_U,
        "total_accepted": total_acc,
        "store_norm": store_norm,
        "welford_count": welford_count,
        "chain_slice": [lo, hi],
        "host_seed": multihost.host_seed(100),
    }), flush=True)


if __name__ == "__main__":
    main()
