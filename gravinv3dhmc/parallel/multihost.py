"""Multi-host initialisation and chain-distribution helpers.

The reference scales across processes with ``mpiexec`` and uses rank
identity only for seeds and output folders — no collectives
(reference: run_main.sh:18, SURVEY.md §5 "Distributed communication").
Here multi-host runs use single-controller JAX: every host calls
:func:`initialize`, the global device mesh spans all hosts, and the
(chains x model) sharding of :mod:`.sharded` spans the devices of every
host automatically via GSPMD.

Chains never communicate during sampling, so chain-axis scaling across
hosts is bandwidth-free; cross-chain diagnostics (accept rates, R-hat)
reduce with one tiny psum at reporting time.
"""
from __future__ import annotations

import jax


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """``jax.distributed.initialize`` wrapper with env-var defaults.

    Set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID or pass
    them explicitly. Call once per host before any jax computation.
    """
    import os

    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(
            num_processes or os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def chains_for_host(total_chains):
    """Slice of the global chain batch this host owns (per-host batching
    for host-local sample IO)."""
    per = total_chains // jax.process_count()
    start = jax.process_index() * per
    return start, start + per


def host_seed(base_seed):
    """Per-host seed offset, mirroring the reference's ``seed + myrank``
    (reference: inversion/hmc.py:369)."""
    return base_seed + jax.process_index()
