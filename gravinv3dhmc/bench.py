"""Benchmark (``python -m gravinv3dhmc.bench``): leapfrog gradient-evaluations per second per chip.

Runs the reference's flagship uniformgrid HMC workload (600 obs x 6000
cells, reference: example/uniformgrid/) with vmapped chains on the GPU and
reports useful leapfrog gradient evaluations per second — the north-star
metric of BASELINE.json. Without a GPU it exits non-zero: a CPU number is
not a device measurement.

Baseline: the reference sustains ~220 grad-evals/s/chain across 2 MPI
chains on a 72-CPU node => 440/s total (BASELINE.md "Derived" table).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

from gravinv3dhmc.runtime.compile_cache import enable_compile_cache

# persistent XLA compile cache: the first run pays the full compile; every
# later run replays it from disk
enable_compile_cache()

from gravinv3dhmc import mesher, utils
from gravinv3dhmc.inversion import hmc
from gravinv3dhmc.inversion.potential import GravMagModule
from gravinv3dhmc.ops import prism

BASELINE_GRAD_EVALS_PER_S = 440.0  # 2 chains x ~220/s (BASELINE.md)
# realdata T1: 1000 samples in ~161 s sampling x 2 MPI chains
# (reference: example/realdata/logout_T1.txt; BASELINE.md derived table)
BASELINE_REALDATA_SAMPLES_PER_S = 2 * 1000 / 161.0
BASELINE_REALDATA_GRAD_EVALS_PER_S = 300.0  # 2 chains x ~150/s

REFERENCE_REALDATA = "/root/reference/example/realdata/data"


def _base_key():
    """Bench PRNG key. BENCH_RBG=1 switches to the 'rbg' implementation
    (threefry's bit generation is elementwise work that shows up at
    ~24.6 MB of normals per iteration at bench scale)."""
    if os.environ.get("BENCH_RBG", "0") == "1":
        return random.key(0, impl="rbg")
    return random.PRNGKey(0)


def build_realdata_problem(verbose=False):
    """The reference's full-feature South China case: spherical tesseroids
    + segmented depth spacing + topography carve + frozen water cells
    (reference: example/realdata/main_real.py:21-75). Loads the published
    observation files when the reference tree is present, otherwise
    synthesises the same geometry."""
    mrange = (106.5, 118.5, 16, 28, 2000, -60000)
    division = [2000, -5000, -15000, -60000]
    spacing = ([-1000, -2000, -5000], 0.5, 0.5)
    if os.path.isdir(REFERENCE_REALDATA):
        lons, lats, heights, dobs = np.loadtxt(
            os.path.join(REFERENCE_REALDATA, "gravinv_12d05d.dat"),
            usecols=[0, 1, 2, 3], unpack=True)
        grav_sea = np.loadtxt(
            os.path.join(REFERENCE_REALDATA, "grasea_12d05d.dat"),
            usecols=[2], unpack=True)
        lons_t, lats_t, topo = np.loadtxt(
            os.path.join(REFERENCE_REALDATA, "topo_12d05d.dat"),
            usecols=[0, 1, 2], unpack=True)
    else:
        lons, lats = np.meshgrid(np.arange(106.75, 118.5, 0.5),
                                 np.arange(16.25, 28.0, 0.5))
        lons, lats = lons.ravel(), lats.ravel()
        heights = np.full(lons.size, 0.0)
        rng = np.random.RandomState(0)
        dobs = rng.normal(0, 20, lons.size)
        grav_sea = np.zeros(lons.size)
        lons_t, lats_t, topo = lons, lats, rng.uniform(-2000, 2000,
                                                       lons.size)
    module = GravMagModule(
        dobs, mrange, spacing, (lons, lats, heights), fixed=True,
        grav_fix=grav_sea, mseg=True, mdivisionsection=division,
        coordinate="spherical", field="gravity", verbose=verbose,
        mtopo=(lons_t, lats_t, topo))
    return module, np.asarray(dobs, np.float64)


def realdata_stage(stage):
    """North-star workload measurement (BASELINE.json: >=10x multi-chain
    samples/s on the realdata model). Returns a result dict; never raises
    (the primary bench line must land regardless).

    Statistically honest since round 4: the sampler runs the full
    production path — windowed warmup (dual-averaging dt + Welford
    diagonal metric) targeting accept 0.8, chain-mode storage, ESS
    computed on device — and the headline comparison is OUR ESS/s vs the
    reference's samples/s. The reference ran at accept 1.0 with unknown
    autocorrelation (example/realdata/logout_T1.txt), so its samples/s is
    an UPPER bound on its ESS/s, making `vs_baseline_ess` a lower bound
    on the true speedup. Round-3's 50.1x claim counted near-duplicate
    accepted states at accept 0.030 — not comparable; this one is.
    """
    nchains = int(os.environ.get("BENCH_REALDATA_NCHAINS", "256"))
    chunk_size = int(os.environ.get("BENCH_REALDATA_CHUNK", "64"))
    nsamples = int(os.environ.get("BENCH_REALDATA_NSAMPLES", "768"))
    adapt_chunks = int(os.environ.get("BENCH_REALDATA_ADAPT_CHUNKS", "12"))
    dt = float(os.environ.get("BENCH_REALDATA_DT", "0.005"))
    # trajectory length: the ESS/s lever. ESS/s is roughly chain-count
    # invariant once the matvecs are compute-bound (ESS and cost both
    # scale with C); what cuts the ~hundreds-of-iterations
    # autocorrelation time is LONGER trajectories (more leapfrog steps
    # per proposal decorrelates faster than it costs, until U-turn).
    # The reference ran L in [5,40] (example/realdata/logout_T1.txt).
    Lrange = [int(v) for v in os.environ.get(
        "BENCH_REALDATA_LRANGE", "5,40").split(",")]
    if len(Lrange) != 2 or Lrange[0] < 1 or Lrange[1] < Lrange[0]:
        raise ValueError(
            f"BENCH_REALDATA_LRANGE must be 'Lmin,Lmax', got {Lrange}")
    store_thin = int(os.environ.get("BENCH_REALDATA_THIN", "1"))
    t_build = time.time()
    module, dobs = build_realdata_problem()
    build_s = time.time() - t_build
    stage(f"realdata problem built ({build_s:.1f}s, "
          f"{dobs.size}x{module.n_active})")
    M = module.n_active
    wdiag = np.asarray(module.wdiag)
    # reference run config: Damping, L in [5, 40], frozen water cells
    # (example/realdata/main_real.py:43; logout_T1.txt header)
    chain = hmc.HamiltonianMC(module)
    chain.dt = dt
    chain.Lrange = Lrange
    chain.Sigma = 0.001
    chain.seed = 100
    chain.RegulFactor = 0.05
    chain.regularization = "Damping"
    chain.nchains = nchains
    chain.chunk_size = chunk_size
    chain.verbose = os.environ.get("BENCH_VERBOSE", "0") == "1"
    chain.write_files = False
    chain.shared_L = True
    chain.adapt_step_size = True
    chain.adapt_mass = True
    # 0.75: between HMC-optimal (~0.65) and Stan's conservative 0.8;
    # the chunk-granular dual averaging lands ~0.1-0.2 below target at
    # freeze (measured: target 0.8 -> 0.58, 0.7 -> 0.45), so this keeps
    # the frozen accept above 0.5
    chain.adapt_target = 0.75
    chain.adapt_chunks = adapt_chunks
    chain.store_mode = "chain"
    chain.store_thin = store_thin
    chain.transfer_samples = False  # ESS on device; scalars only
    chain.low = wdiag * np.full(M, -0.5)
    chain.high = wdiag * np.full(M, 0.5)
    chain.initial_model = wdiag * np.full(M, 0.01)
    chain.aprior_model = wdiag * np.full(M, 0.001)
    chain.dobs = np.asarray(dobs, np.float64)
    stage("realdata sampler configured (adaptive warmup on)")
    out = chain.sample(nsamples, 0)
    stage(f"realdata adaptive run done ({out['elapsed_s']:.1f}s, "
          f"accept {out['accept_ratio']:.2f})")
    ess_per_s = out.get("ess_per_s_median") or float("nan")
    samples_per_s = nchains * nsamples / out["elapsed_s"]
    # free the adaptive run's device sample buffer (8.2 GB at these
    # defaults) before the reference-kernel run allocates its own
    out["samples_device"] = None
    out["misfits_device"] = None

    # ---- reference-kernel ESS/sample: the like-for-like anchor --------
    # The reference logs samples/s but never ESS; its kernel's
    # statistical efficiency is a property of the ALGORITHM + config
    # (fixed dt=0.005, Sigma=0.001, L in [5,40], accept 1.0 —
    # example/realdata/logout_T1.txt), which this framework reproduces
    # EXACTLY at f64. Its measured ESS/sample anchors
    #   reference ESS/s on ITS hardware = its samples/s x ESS/sample.
    # BENCH_REALDATA_REFKERNEL=1 measures it live in f64; by default the
    # stage is skipped.
    ref_est = None
    if os.environ.get("BENCH_REALDATA_REFKERNEL", "0") == "1":
        try:
            ref = hmc.HamiltonianMC(module)
            ref.dt = 0.005
            ref.Lrange = [5, 40]
            ref.Sigma = 0.001
            ref.seed = 100
            ref.RegulFactor = 0.05
            ref.regularization = "Damping"
            ref.nchains = 64
            ref.chunk_size = 32
            ref.verbose = chain.verbose
            ref.write_files = False
            ref.shared_L = True
            ref.store_mode = "chain"
            ref.transfer_samples = False
            ref.dtype = jnp.float64  # the reference is all-f64
            ref.low = chain.low
            ref.high = chain.high
            ref.initial_model = chain.initial_model
            ref.aprior_model = chain.aprior_model
            ref.dobs = chain.dobs
            rS = 128
            rout = ref.sample(rS, 0)
            r_ess_total = ((rout.get("ess_per_s_median") or 0.0)
                           * rout["elapsed_s"])
            e_per_sample = r_ess_total / (64 * rS)
            ref_est = {
                "accept_ratio": round(rout["accept_ratio"], 4),
                "ess_per_sample": e_per_sample,
                "ref_hw_ess_per_s": (BASELINE_REALDATA_SAMPLES_PER_S
                                     * e_per_sample),
                "source": "measured live (f64)",
            }
            stage(f"reference-kernel ESS measured (accept "
                  f"{rout['accept_ratio']:.2f}, ESS/sample "
                  f"{e_per_sample:.2e})")
        except Exception as e:  # noqa: BLE001
            print(f"WARNING: reference-kernel ESS stage failed: "
                  f"{type(e).__name__}: {str(e)[:160]}",
                  file=sys.stderr, flush=True)
    return {
        "problem": [int(dobs.size), int(M)],
        "kernel_build_s": round(build_s, 2),
        "nchains": nchains,
        "nsamples": nsamples,
        "Lrange": Lrange,
        "store_thin": store_thin,
        "grad_evals_per_s": round(out["grad_evals_per_s"], 1),
        "samples_per_s": round(samples_per_s, 1),
        "accept_ratio": round(out["accept_ratio"], 4),
        "step_size": out["step_size"],
        "adapted_mass": out["adapted_mass"],
        "ess_per_s_median": round(ess_per_s, 2),
        "elapsed_s": round(out["elapsed_s"], 1),
        # ESS/s vs the reference's samples/s (>= its ESS/s): lower bound
        "vs_baseline_ess": round(
            ess_per_s / BASELINE_REALDATA_SAMPLES_PER_S, 1),
        "vs_baseline_grad_evals": round(
            out["grad_evals_per_s"] / BASELINE_REALDATA_GRAD_EVALS_PER_S,
            1),
        # measured like-for-like: our ESS/s vs (reference samples/s x its
        # kernel's measured ESS/sample)
        "reference_kernel": ref_est,
        "vs_reference_kernel_ess": (
            round(ess_per_s / max(ref_est["ref_hw_ess_per_s"], 1e-12), 1)
            if ref_est else None),
    }


def build_problem():
    dx = dy = dz = 100
    nx, ny, nz = 20, 30, 10
    bounds = (0, nx * dx, 0, ny * dy, 0, nz * dz)
    mesh = mesher.PrismMesh(bounds, (dz, dy, dx))
    rho = np.zeros((nz, ny, nx))
    rho[2:5, 10:18, 7:11] = 1.0
    mesh.addprop("density", rho.ravel())
    xo, yo, zo = utils.regular((0, nx * dx, 0, ny * dy), (nx, ny), z=0.0)
    gz_pre, _ = prism.gz(xo, yo, zo, mesh)
    dobs = utils.contaminate(gz_pre, 0.02 * gz_pre.max(), seed=1)
    module = GravMagModule(dobs, bounds, (dz, dy, dx), (xo, yo, zo),
                           verbose=False)
    return module, dobs


def device_identity():
    """The device as JAX reports it; raises SystemExit unless it is a GPU
    (the bench measures the card and never falls back to the CPU)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX found {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main():
    device = device_identity()
    nchains = int(os.environ.get("BENCH_NCHAINS", "1024"))
    chunk_size = int(os.environ.get("BENCH_CHUNK", "128"))
    n_timed_chunks = int(os.environ.get("BENCH_CHUNKS", "8"))
    # shared trajectory length per iteration: every device step is a
    # useful grad eval (the masked per-chain-L scan wastes
    # (Lmax-E[L])/Lmax of its steps)
    shared_L = os.environ.get("BENCH_SHARED_L", "1") != "0"

    def stage(msg, _t=[time.time()]):
        now = time.time()
        print(f"[bench +{now - _t[0]:.1f}s] {msg}", file=sys.stderr,
              flush=True)
        _t[0] = now

    module, dobs = build_problem()
    stage("problem built (kernel matrix on host)")
    M = module.n_active
    wdiag = module.wdiag
    aprior = wdiag * np.full(M, 0.001)
    low = wdiag * np.zeros(M)
    high = wdiag * np.ones(M)

    matvec_dtype = os.environ.get("BENCH_MATVEC_DTYPE")
    potential_fn = module.make_potential(
        aprior, low, high, constraint="mandatory", regularization="MS",
        beta=0.001, dtype=jnp.float32,
        matvec_dtype=jnp.dtype(matvec_dtype) if matvec_dtype else None)

    nsamples = int(os.environ.get("BENCH_NSAMPLES", "64"))
    store_mode = os.environ.get("BENCH_STORE_MODE", "chain")
    run_chunk = hmc.make_chunk_sampler(
        potential_fn, dt=0.01, Lmin=5, Lmax=20, Sigma=0.001, low=low,
        high=high, constraint="mandatory", alpha=1.0, chunk_size=chunk_size,
        nsamples=nsamples, ndraws=0, wdiag_inv=module.wdiag_inv,
        data_size=dobs.size, dtype=jnp.float32, shared_L=shared_L,
        store_mode=store_mode)

    wdiag_d = jnp.asarray(wdiag, jnp.float32)  # (M,) — tiny
    x = jnp.broadcast_to(0.001 * wdiag_d, (nchains, M)).astype(jnp.float32)
    U, g, (_, u_data, u_model) = potential_fn(x, 1.0)
    carry = (x, U, g, u_data, u_model,
             jnp.zeros(nchains, jnp.int32),
             jnp.zeros((nchains, nsamples, M), jnp.float32),
             jnp.zeros((nchains, nsamples, 7), jnp.float32))
    base_key = _base_key()

    # warmup (compile)
    carry, stats = run_chunk(carry, base_key, 0, potential_fn.params)
    jax.block_until_ready(carry[0])
    stage("warmup chunk compiled + ran")

    t0 = time.time()
    # counters accumulate on device; the timed window ends when the last
    # chunk's state is ready
    ge_acc = jnp.zeros((), jnp.float32)
    ac_acc = jnp.zeros((), jnp.float32)
    stat_count = 0
    for i in range(1, n_timed_chunks + 1):
        carry, stats = run_chunk(carry, base_key, i, potential_fn.params)
        ge_acc = ge_acc + jnp.sum(stats[..., 4])
        ac_acc = ac_acc + jnp.sum(stats[..., 0])
        stat_count += stats.shape[0] * stats.shape[1]
    jax.block_until_ready((carry, ge_acc, ac_acc))
    elapsed = time.time() - t0
    stage(f"timed chunks done ({elapsed:.1f}s)")
    grad_evals = int(ge_acc)
    accept_sum = float(ac_acc)

    # ESS/s (BASELINE.json names it alongside grad-evals/s): autocorrelation
    # ESS over a 128-parameter subsample of the device-resident sample
    # buffer, computed ON DEVICE (diagnostics.ess_jax)
    from gravinv3dhmc.diagnostics import ess_jax
    sub = np.random.RandomState(0).choice(M, size=min(M, 128), replace=False)
    ess_med = float(jnp.median(ess_jax(carry[6][:, :, jnp.asarray(sub)])))

    value = grad_evals / elapsed
    # NOTE an accept_ratio of 1.0 here is EXPECTED, not a stuck sampler:
    # the shipped uniformgrid config (dt=0.01, Sigma=0.001) matches the
    # reference run's own 100% acceptance (example/uniformgrid/
    # logout_T1.txt — Sigma tempers the target so sharply that every
    # proposal is downhill-or-flat in H).
    accept_ratio = accept_sum / max(stat_count, 1)
    # the nsamples stored samples/chain took ~nsamples/accept_ratio
    # iterations to collect at the measured per-iteration wall time
    ess_per_s = None
    if accept_ratio > 0:
        iter_time = elapsed / (chunk_size * n_timed_chunks)
        collect_time = (nsamples / accept_ratio) * iter_time
        ess_per_s = ess_med / collect_time
    result = {
        "metric": "uniformgrid leapfrog grad-evals/s/chip",
        "value": round(value, 1),
        "unit": "grad-evals/s",
        "vs_baseline": round(value / BASELINE_GRAD_EVALS_PER_S, 2),
        "detail": {
            "device": device,
            "nchains": nchains,
            "chunk_size": chunk_size,
            "shared_L": shared_L,
            "store_mode": store_mode,
            "problem": [int(dobs.size), int(M)],
            "iters_per_s": round(chunk_size * n_timed_chunks * nchains
                                 / elapsed, 1),
            "accept_ratio": accept_ratio,
            "ess_per_s_median": (round(ess_per_s, 1)
                                 if ess_per_s is not None else None),
            "ess_median_total": ess_med,
        },
    }
    # north-star workload (BASELINE.json: realdata multi-chain samples/s)
    # as a nested stage of the same single JSON line
    if os.environ.get("BENCH_REALDATA", "1") != "0":
        # free the main stage's device buffers first: the (C, S, M)
        # sample buffer alone is 1.6 GB and the realdata stage allocates
        # an 8 GB one
        carry = stats = ge_acc = ac_acc = None
        try:
            result["detail"]["realdata"] = realdata_stage(stage)
        except Exception as e:  # noqa: BLE001 — primary line must land
            import traceback
            traceback.print_exc()
            result["detail"]["realdata"] = {
                "error": f"{type(e).__name__}: {str(e)[:200]}"}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
