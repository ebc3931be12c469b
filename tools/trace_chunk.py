"""Trace one steady uniformgrid chunk on the GPU and split its device time.

    python tools/trace_chunk.py

Builds the reference's uniformgrid potential (600 x 6000, MS, float32 at
the stated HIGHEST precision) and the bench's chunk sampler (shared L in
[5, 20], chain-mode storage), runs one chunk to compile and warm up, then
traces one more with ``jax.profiler``. From the trace's GPU planes it
reports, as one JSON line (also written to
``chiprun_out/trace_chunk/trace_chunk.json`` beside the trace):

* the leapfrog step time: host wall time of the chunk, and device busy
  time, each over the chunk's leapfrog steps;
* the share of device kernel time spent in the products with A (the GEMM
  kernels) and in everything else;
* the device idle share of the traced window (first to last kernel);
* the kernels with the most device time, so that the GEMM classification
  can be checked by eye.

Exits non-zero without a GPU.
"""
import glob
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "examples")]

NCHAINS = 1024     # the bench's chain count
ITERATIONS = 16    # one short chunk: ~200 leapfrog steps
OUT_DIR = os.path.join(ROOT, "chiprun_out", "trace_chunk")

# cuBLAS / CUTLASS / XLA-emitted matrix-product kernels
GEMM_KERNEL = re.compile(r"gemm|xmma|cutlass|cublas|matmul|dot",
                         re.IGNORECASE)


def kernel_events(trace_dir):
    """(name, start_ns, end_ns) of every event on the GPU stream lines of
    the newest trace under ``trace_dir``."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    events = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            events.extend((e.name, e.start_ns, e.end_ns)
                          for e in line.events)
    return events


def split(events):
    """Busy time (union of intervals), window, GEMM time and per-kernel
    totals of a list of (name, start_ns, end_ns)."""
    if not events:
        raise ValueError("the trace holds no GPU kernel")
    spans = sorted((s, e) for _, s, e in events)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    per_kernel = {}
    for name, s, e in events:
        per_kernel[name] = per_kernel.get(name, 0) + (e - s)
    total = sum(per_kernel.values())
    gemm = sum(t for n, t in per_kernel.items() if GEMM_KERNEL.search(n))
    return {"busy_ns": busy, "window_ns": window, "kernel_ns": total,
            "gemm_ns": gemm, "per_kernel_ns": per_kernel}


def main():
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("trace_chunk: needs a GPU", file=sys.stderr)
        return 2
    from gravinv3dhmc.inversion import hmc
    from gravinv3dhmc.inversion.potential import GravMagModule
    from gravinv3dhmc.runtime.compile_cache import enable_compile_cache
    import workloads as W

    enable_compile_cache()
    wl = W.uniformgrid()
    _, dobs = W.forward_with_noise(wl, seed=1)
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           verbose=False)
    M, C = module.n_active, NCHAINS
    wdiag = np.asarray(module.wdiag)
    low, high = wdiag * 0.0, wdiag * 1.0
    pot = module.make_potential(wdiag * 0.001, low, high,
                                regularization="MS", beta=0.001,
                                dtype=jnp.float32)
    nsamples = 16
    run_chunk = hmc.make_chunk_sampler(
        pot, dt=0.01, Lmin=5, Lmax=20, Sigma=0.001, low=low, high=high,
        constraint="mandatory", alpha=1.0, chunk_size=ITERATIONS,
        nsamples=nsamples, ndraws=0, wdiag_inv=module.wdiag_inv,
        data_size=dobs.size, shared_L=True, store_mode="chain")
    x = jnp.broadcast_to(jnp.asarray(0.001 * wdiag, jnp.float32), (C, M))
    U, g, (_, ud, um) = pot(x, 1.0)
    carry = (x, U, g, ud, um, jnp.zeros(C, jnp.int32),
             jnp.zeros((C, nsamples, M), jnp.float32),
             jnp.zeros((C, nsamples, 7), jnp.float32))
    key = jax.random.PRNGKey(0)
    carry, stats = run_chunk(carry, key, 0, pot.params)
    jax.block_until_ready((carry, stats))

    os.makedirs(OUT_DIR, exist_ok=True)
    with jax.profiler.trace(OUT_DIR):
        t0 = time.perf_counter()
        carry, stats = run_chunk(carry, key, 1, pot.params)
        jax.block_until_ready((carry, stats))
        wall = time.perf_counter() - t0
    steps = int(np.asarray(stats[:, 0, 4]).sum())
    sp = split(kernel_events(OUT_DIR))
    top = sorted(sp["per_kernel_ns"].items(), key=lambda kv: -kv[1])[:15]
    result = {
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "problem": [int(dobs.size), int(M)], "nchains": C,
        "iterations": ITERATIONS, "leapfrog_steps": steps,
        "step_wall_us": wall / steps * 1e6,
        "step_busy_us": sp["busy_ns"] / steps * 1e-3,
        "gemm_share": sp["gemm_ns"] / sp["kernel_ns"],
        "other_share": 1.0 - sp["gemm_ns"] / sp["kernel_ns"],
        "idle_share": 1.0 - sp["busy_ns"] / sp["window_ns"],
        "accept_ratio": float(np.asarray(stats[..., 0]).mean()),
        "top_kernels_us": [[n[:120], t * 1e-3] for n, t in top],
    }
    with open(os.path.join(OUT_DIR, "trace_chunk.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
