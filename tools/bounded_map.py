"""Bounded MAP at full whole-Earth scale: fixed-alpha projected-CG ladder.

Closes the round-4 resolution-limit argument (VERDICT r4 Missing #3):
the exact UNBOUNDED ridge MAP caps at corr 0.44 (GLOBAL_r04
resolution_limit_evidence), the HMC posterior mean reaches 0.589, and
the open question was whether the gap comes from the box constraints
alone — i.e. whether a BOUNDED MAP (projected CG, the repo's own
inversion/reginv.py box projection every iteration) can match the
sampler. This tool runs the fixed-alpha ladder the verdict prescribed
(NOT the reference's adaptive schedule, which diverges at this scale —
docs/DESIGN.md divergence 7): one jitted solve with alpha as a
traced argument, evaluated at log-spaced alphas bracketing the
self-scaled anchor alpha_ref = U_data(m0)/U_model(m0).

Everything device-resident (kernel built on device, scalars-only d2h).
Writes tools/bounded_map.json and prints one JSON line.
Usage:  python tools/bounded_map.py        (on the GPU)
Knobs:  BM_SCALE (1.0), BM_MAXK (400), BM_DECADES (3), BM_OUT
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

import workloads as W
from gravinv3dhmc.inversion.potential import GravMagModule
from gravinv3dhmc.inversion.reginv import _make_cg_core


def main():
    scale = float(os.environ.get("BM_SCALE", "1.0"))
    maxk = int(os.environ.get("BM_MAXK", "400"))
    decades = int(os.environ.get("BM_DECADES", "3"))
    # segment length per jitted program: deep solves run as
    # restarted-CG segments, the global best-objective iterate kept
    # across segments, with a progress line after each.
    seg = int(os.environ.get("BM_CHUNK", "800"))
    t_all = time.time()

    wl = W.global_tess(scale=scale)
    dpre, dobs = W.forward_with_noise(
        wl, seed=1, kernel_cache="cache/global_kernel.npy"
        if scale == 1.0 else None)
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           kernel_device=True, verbose=False,
                           **wl["mesh_kwargs"])
    M = module.n_active
    D = dobs.size
    dtype = jnp.float32
    Aw = module.device_arrays(dtype)["Aw"]
    wdiag = jnp.asarray(module.wdiag, dtype)
    wdiag_inv = jnp.asarray(module.wdiag_inv, dtype)
    dobs_d = jnp.asarray(dobs, dtype)
    apr_m = jnp.full(M, 0.001, dtype)       # the flagship's aprior model
    rhomin, rhomax = 0.0, 0.8               # the flagship's box
    print(f"[+{time.time()-t_all:.0f}s] device kernel ready "
          f"({D}x{M})", file=sys.stderr, flush=True)

    n_segments = max(1, -(-maxk // seg))
    solve = _make_cg_core(
        Aw, None, None, None, module.mshape, None, "Damping", 0.01, 0.7,
        min(maxk, seg), rhomin, rhomax, "normalized", dtype, as_args=True,
        fixed_alpha=True, keep_best=True)
    arrs = (Aw, dobs_d, wdiag, wdiag_inv, wdiag * apr_m)
    truth = jnp.asarray(wl["rho"], dtype)
    mw0 = jnp.zeros(M, dtype)
    ones = jnp.ones(D, dtype)

    def evaluate(mw, Aw_a):
        # Aw threaded as an ARGUMENT — closing over it bakes the 2.1 GB
        # kernel into the executable
        m = mw * wdiag_inv
        dp = Aw_a @ mw
        r = (dp - jnp.mean(dp)) - (dobs_d - jnp.mean(dobs_d))
        rmsd = jnp.sqrt(jnp.mean(r ** 2))
        rmsm = jnp.sqrt(jnp.mean((m - truth) ** 2))
        corr = jnp.corrcoef(jnp.stack([m, truth]))[0, 1]
        at_lo = jnp.mean((m <= rhomin + 1e-6).astype(dtype))
        at_hi = jnp.mean((m >= rhomax - 1e-6).astype(dtype))
        return rmsd, rmsm, corr, at_lo, at_hi

    @jax.jit
    def run_segment(mw_in, alpha, arrs):
        mw_fin, d_h, m_h, _, n_it = solve(mw_in, ones, arrs, alpha)
        Aw_, dobs_, _, _, apr_ = arrs
        r = Aw_ @ mw_fin - dobs_
        dm = mw_fin - apr_
        obj = jnp.sum(r * r) + alpha * jnp.sum(dm * dm)
        return mw_fin, obj, n_it

    @jax.jit
    def finish(mw, alpha, arrs):
        Aw_, dobs_, _, _, apr_ = arrs
        r = Aw_ @ mw - dobs_
        d_fin = jnp.sum(r * r) / D
        return evaluate(mw, Aw_) + (d_fin,)

    def run(alpha, arrs):
        """Restarted projected CG: n_segments jitted programs of <= seg
        iterations each, keeping the global best-objective iterate."""
        mw_best, obj_best = mw0, jnp.inf
        n_total = 0
        mw = mw0
        for _ in range(n_segments):
            mw, obj, n_it = run_segment(mw, alpha, arrs)
            n_total += int(n_it)  # scalar sync bounds program length
            if float(obj) < float(obj_best):
                mw_best, obj_best = mw, obj
            mw = mw_best  # restart from the best point
        return finish(mw_best, alpha, arrs) + (n_total,)

    # self-scaled anchor AT THE SOLUTION: run the pure projected
    # least-squares (alpha=0) first and set alpha_ref =
    # U_data(m*)/U_model(m*) there — anchoring at the start point (the
    # reference's k==1 rule) mis-scales by orders of magnitude because
    # U_model(m0) ~ ||apr||^2 is tiny. The ladder brackets alpha_ref by
    # +-decades and includes the flagship HMC's own RegulFactor 5.0.
    @jax.jit
    def anchor(arrs):
        mw_star, _, _, _, _ = solve(mw0, ones, arrs,
                                    jnp.asarray(0.0, dtype))
        Aw_, dobs_, _, _, apr_ = arrs
        r = Aw_ @ mw_star - dobs_
        dm = mw_star - apr_
        return jnp.sum(r * r) / jnp.sum(dm * dm)

    if os.environ.get("BM_ALPHAS"):
        # explicit ladder (e.g. a convergence re-check of the best
        # points at a larger BM_MAXK)
        a_ref = float("nan")
        alphas = [float(a) for a in
                  os.environ["BM_ALPHAS"].split(",")]
    else:
        a_ref = float(anchor(arrs))
        alphas = [0.0] + sorted(
            {a_ref * 10.0 ** e for e in range(-decades, decades + 1)}
            | {5.0})
    print(f"[+{time.time()-t_all:.0f}s] anchor alpha_ref={a_ref:.4g} "
          f"(at the alpha=0 solution); ladder {len(alphas)} points",
          file=sys.stderr, flush=True)

    t0 = time.time()
    ladder = []
    for a in alphas:
        out = run(jnp.asarray(a, dtype), arrs)
        ladder.append({
            "alpha": a,
            "RMSD": float(out[0]),
            "RMSM": float(out[1]),
            "corr": float(out[2]),
            "frac_at_lower_bound": float(out[3]),
            "frac_at_upper_bound": float(out[4]),
            "final_data_misfit_norm": float(out[5]),
            "n_iters": int(out[6]),
        })
        print(f"  alpha={a:.4g}: corr={ladder[-1]['corr']:.4f} "
              f"RMSM={ladder[-1]['RMSM']:.4f} "
              f"RMSD={ladder[-1]['RMSD']:.1f}",
              file=sys.stderr, flush=True)
    best = max(ladder, key=lambda r: r["corr"])
    res = {
        "case": "bounded MAP ladder: fixed-alpha projected CG, "
                "Damping family, box [0, 0.8]",
        "device": str(jax.devices()[0]),
        "problem": [int(D), int(M)],
        "maxk": maxk,
        "alpha_ref": None if a_ref != a_ref else a_ref,
        "ladder": ladder,
        "best_alpha": best["alpha"],
        "best_corr": best["corr"],
        "best_RMSM": best["RMSM"],
        "hmc_posterior_mean_corr": 0.589,   # GLOBAL_r04 flagship
        "unbounded_ridge_map_max_corr": 0.44,  # GLOBAL_r04 ladder
        "solve_s": round(time.time() - t0, 1),
        "total_s": round(time.time() - t_all, 1),
    }
    res["bounded_map_beats_hmc_mean"] = bool(best["corr"] > 0.589)
    out_path = os.environ.get("BM_OUT", os.path.join(
        os.path.dirname(__file__), "bounded_map.json"))
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
