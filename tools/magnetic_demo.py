"""Spherical MAGNETIC inversion demo — the capability the reference
declares "not implemented" (readme.md:9-18), run end to end on real
hardware, with an exact-ridge control so the recoverability claims are
honest (the GLOBAL_r04 resolution_limit_evidence pattern):

* a TIGHTLY-CONSTRAINED configuration (small box, obs grid matched to
  the cell grid, shallow single body) where the bounded MAP genuinely
  recovers the magnetization;
* a WIDE under-constrained configuration where total-field data are
  classically non-unique — the EXACT ridge solution fits the data to
  the noise floor with a truth-uncorrelated model — and where the
  calibrated honest ChEES posterior correctly reports that ignorance
  as wide intervals (high coverage, uninformative mean) instead of a
  silently-wrong point estimate.

Writes tools/magnetic_demo.json and prints one JSON line.
Usage:  python tools/magnetic_demo.py     (GPU or CPU)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gravinv3dhmc.runtime.compile_cache import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp
from jax import random

from gravinv3dhmc import mesher
from gravinv3dhmc.inversion.chees import run_chees_chunked
from gravinv3dhmc.inversion.potential import (GravMagModule,
                                                  logistic_to_mw,
                                                  mw_to_logistic)
from gravinv3dhmc.inversion.reginv import cg_device
from gravinv3dhmc.ops import tesseroid as tess
from gravinv3dhmc.utils import regular
from gravinv3dhmc.utils.units import dircos

INC, DEC = 50.0, -5.0


def build(mrange, ddeg, dz, nobs, bodies, zobs, seed=7):
    spacing = (dz, ddeg, ddeg)
    mesh = mesher.TesseroidMesh(mrange, spacing)
    mag3 = np.zeros(mesh.shape)
    for (z0, z1, y0, y1, x0, x1, amp) in bodies:
        mag3[z0:z1, y0:y1, x0:x1] = amp
    mesh.addprop("magnetization",
                 np.outer(mag3.ravel(), np.array(dircos(INC, DEC))))
    pad = 0.04 * (mrange[1] - mrange[0])
    lons, lats, hs = regular((mrange[0] + pad, mrange[1] - pad,
                              mrange[2] + pad, mrange[3] - pad),
                             (nobs, nobs), z=zobs)
    dpre, _ = tess.tf(lons, lats, hs, mesh, INC, DEC)
    rng = np.random.RandomState(seed)
    noise = 0.02 * np.abs(dpre).max()
    dobs = dpre + rng.normal(0, noise, dpre.size)
    module = GravMagModule(dobs, mrange, spacing, (lons, lats, hs),
                           coordinate="spherical", field="magnetic",
                           mangle=(INC, DEC), verbose=False)
    return module, mesh, mag3.ravel(), dpre, dobs, noise


def ridge_control(module, dobs, dpre, noise, truth):
    """Exact (unbounded) ridge on the weighted normal equations — the
    best any linear estimator of this family can do. Host-side f64."""
    Aw = np.asarray(module.Aw, np.float64)
    best = None
    for lam in (1e-4, 1e-2, 1.0):
        mw = np.linalg.solve(Aw.T @ Aw + lam * np.eye(Aw.shape[1]),
                             Aw.T @ dobs)
        m = mw * np.asarray(module.wdiag_inv)
        corr = float(np.corrcoef(m, truth)[0, 1])
        fit = float(np.sqrt(np.mean((module.A @ m - dpre) ** 2)) / noise)
        if best is None or corr > best["corr"]:
            best = {"lambda": lam, "corr": round(corr, 4),
                    "rmsd_over_noise": round(fit, 2)}
    return best


def bounded_map(module, dobs, dpre, noise, truth, alpha=0.05, maxk=800):
    cg = cg_device(module, dobs, (0.0, 3.0), regularization="Damping",
                   maxk=maxk, dtype=jnp.float64, alpha=alpha)
    m = np.asarray(cg["m"], np.float64)
    return {"alpha": alpha, "maxk": maxk,
            "truth_corr": round(float(np.corrcoef(m, truth)[0, 1]), 4),
            "rmsd_over_noise": round(float(np.sqrt(np.mean(
                (module.A @ m - dpre) ** 2)) / noise), 2)}


def honest_chees(module, dobs, noise, truth, nsamples=256):
    M = module.n_active
    wdiag = np.asarray(module.wdiag)
    low = wdiag * np.zeros(M)
    high = wdiag * np.full(M, 3.0)
    pot = module.make_potential(wdiag * np.full(M, 0.01), low, high,
                                constraint="logarithmic",
                                log_factor=1000.0,
                                regularization="Damping", beta=0.01,
                                dtype=jnp.float32, jacobian=True,
                                temperature=2.0 * float(noise) ** 2)

    def pot2(xx, P):
        u, g, _ = pot.fn(xx, 0.05, P)
        return u, g

    C = 16
    x0 = mw_to_logistic(np.clip(wdiag * 0.1, low + 1e-6 * (high - low),
                                high - 1e-6 * (high - low)),
                        low, high, 1000.0)
    x0b = jnp.asarray(np.tile(x0[None, :], (C, 1)), jnp.float32)
    t0 = time.time()
    buf, cstats = run_chees_chunked(
        pot2, x0b, random.PRNGKey(11), n_warmup=192, n_samples=nsamples,
        chunk_iters=32, step_size0=0.01, max_steps=256,
        dtype=jnp.float32, pot_params=pot.params)
    mw = logistic_to_mw(buf, jnp.asarray(low, jnp.float32)[None, None],
                        jnp.asarray(high, jnp.float32)[None, None],
                        1000.0)
    m = mw * jnp.asarray(module.wdiag_inv, jnp.float32)[None, None]
    mean_m = jnp.mean(m, axis=(0, 1))
    std_m = jnp.std(m, axis=(0, 1))
    t_d = jnp.asarray(truth, jnp.float32)
    return {
        "nchains": C, "nsamples": int(cstats["n_samples"]),
        "accept": round(float(np.mean(np.asarray(cstats["accept"]))), 3),
        "posterior_truth_corr": round(float(jnp.corrcoef(
            jnp.stack([mean_m, t_d]))[0, 1]), 4),
        "coverage_2std": round(float(jnp.mean(
            jnp.abs(mean_m - t_d) <= 2.0 * std_m)), 4),
        "mean_posterior_std": round(float(jnp.mean(std_m)), 4),
        "sampling_s": round(time.time() - t0, 1),
    }


def main():
    t0 = time.time()
    res = {"case": "spherical MAGNETIC inversion (reference: 'not "
                   "implemented') — tesseroid tf via Poisson over the "
                   "GLQ tensor",
           "device": str(jax.devices()[0])}

    # --- constrained configuration: obs grid matched to the cell grid,
    # one shallow body — the recoverable regime
    mod, mesh, truth, dpre, dobs, noise = build(
        (-0.2, 0.2, -0.2, 0.2, 0.0, -6000.0), 0.05, -2000.0, 8,
        [(0, 2, 3, 6, 3, 6, 2.0)], 400.0)
    res["constrained"] = {
        "problem": [int(dobs.size), int(mod.n_active)],
        "bounded_map": bounded_map(mod, dobs, dpre, noise, truth,
                                   alpha=0.01, maxk=400),
        "ridge_control": ridge_control(mod, dobs, dpre, noise, truth),
    }

    # --- wide configuration: 1-degree box, two bodies — the classic
    # total-field non-unique regime. The exact-ridge control shows the
    # non-uniqueness is PHYSICS (noise-floor fit, truth-uncorrelated
    # model); the calibrated posterior reports it as wide intervals.
    mod2, mesh2, truth2, dpre2, dobs2, noise2 = build(
        (-0.5, 0.5, -0.5, 0.5, 0.0, -10000.0), 0.05, -2000.0, 24,
        [(0, 2, 5, 10, 5, 10, 2.0), (1, 3, 10, 15, 10, 15, 1.0)], 500.0)
    res["wide_nonunique"] = {
        "problem": [int(dobs2.size), int(mod2.n_active)],
        "ridge_control": ridge_control(mod2, dobs2, dpre2, noise2,
                                       truth2),
        "bounded_map": bounded_map(mod2, dobs2, dpre2, noise2, truth2),
        "honest_chees": honest_chees(mod2, dobs2, noise2, truth2),
        "reading": "the exact ridge fits the data at the noise floor "
                   "with a truth-uncorrelated model => the data do not "
                   "constrain the model pointwise here; the calibrated "
                   "posterior's high coverage + large posterior std is "
                   "the CORRECT answer, where a lone point estimate "
                   "would silently mislead",
    }
    res["total_s"] = round(time.time() - t0, 1)
    with open(os.path.join(os.path.dirname(__file__),
                           "magnetic_demo.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
