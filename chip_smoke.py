"""Smoke run of the main path on the GPU.

    python chip_smoke.py                  # the one-card phases
    python chip_smoke.py --phases potential,uniformgrid
    python chip_smoke.py --multichip 4    # the sharded sampler, four cards

Everything runs in this one process, so one JAX process holds the card.
The script exits non-zero, without its last line, when JAX's first device
is not a GPU or when any phase fails. Its last line of standard output is
one JSON object: ``{"ok": true, "device": {"platform": "gpu", "kind":
..., "count": ...}}``.

One-card phases:

* ``potential`` — uniformgrid at the reference's 600 x 6000 through
  ``GravMagModule``: U and its gradient for 64 chains in float32 on the
  GPU against the float64 NumPy reference (``gravinv3dhmc.reference``)
  from the same float32-rounded inputs, at the initial point and at a
  uniform-random point in the box;
* ``uniformgrid`` — ``workloads.run_hmc`` at 600 x 6000 with the
  reference config (MS, dt 0.01, Sigma 0.001, L in [5, 20]) on 256 chains;
* ``realdata`` — ``examples/run.py realdata`` with the Welford warmup
  (the South China geometry: spherical tesseroids, segmented depths,
  topography carve, frozen cells; host C++ kernel build);
* ``global`` — ``examples/run.py global --map-only`` at scale 0.25 (the
  device tesseroid builder and ``reginv.cg_device``);
* ``gpu_tests`` — the ``gpu``-marked tests, in this process.

``--multichip N`` runs only the sharded chunk sampler at 600 x 6000 in
float64 on a (chains, model) mesh of N cards against the unsharded
one-card sampler with the same key (``__graft_entry__.dryrun_multichip``).
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("potential", "uniformgrid", "realdata", "global", "gpu_tests")

# acceptance bounds of the potential phase (float32 storage, products at
# lax.Precision.HIGHEST, against float64 from the same rounded inputs)
U_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
# the reference's own logs and the CPU runs accept ~1.0 at this config
MIN_ACCEPT_UNIFORMGRID = 0.9

COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")


class PhaseFailed(AssertionError):
    """A phase's result is outside its bound."""


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--multichip", type=int, default=0, metavar="N",
                    help="run only the sharded sampler on N cards")
    args = ap.parse_args(argv)
    if args.multichip:
        if args.multichip < 2:
            ap.error("--multichip needs at least 2 cards")
        args.phases = ("multichip",)
    else:
        phases = tuple(p for p in args.phases.split(",") if p)
        unknown = sorted(set(phases) - set(PHASES))
        if unknown or not phases:
            ap.error(f"unknown phases {unknown}; choose from {PHASES}")
        args.phases = phases
    return args


def card_lines():
    """The cards' names and power limits, read by nvidia-smi in a child
    process that never imports JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, summed."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.total += duration


def _uniformgrid():
    import workloads as W
    wl = W.uniformgrid()
    _, dobs = W.forward_with_noise(wl, seed=1)
    return W, wl, dobs


def _unstated_precision_potential(P, x, alpha, beta):
    """The MS potential with every product left at the default precision:
    printed for the record beside the stated-precision error."""
    import jax
    import jax.numpy as jnp

    def u(xi):
        dpre = P["Aw"] @ xi
        r = dpre - jnp.mean(dpre) - P["dobs_centered"]
        dm = xi - P["aprior_mw"]
        dm2 = dm * dm
        return jnp.sum(r * r) + alpha * jnp.sum(P["wm_sq"] * dm2
                                                / (dm2 + beta))

    return jax.jit(jax.vmap(jax.value_and_grad(u)))(x)


def phase_potential():
    import jax.numpy as jnp
    import numpy as np

    from gravinv3dhmc import reference
    from gravinv3dhmc.inversion.potential import GravMagModule

    _, wl, dobs = _uniformgrid()
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           verbose=False)
    D, M = dobs.size, module.n_active
    check((D, M) == (600, 6000), f"uniformgrid is {D} x {M}")
    alpha, beta, C = 1.0, 0.001, 64
    wdiag = np.asarray(module.wdiag)
    low, high = wdiag * wl["rhomin"], wdiag * wl["rhomax"]
    pot = module.make_potential(wdiag * 0.001, low, high,
                                regularization="MS", beta=beta,
                                dtype=jnp.float32)
    P64 = {k: np.asarray(v, np.float64) for k, v in pot.params.items()
           if v is not None}
    rng = np.random.RandomState(0)
    points = {"initial": np.tile(0.001 * wdiag, (C, 1)),
              "random": low + rng.uniform(size=(C, M)) * (high - low)}
    info = {}
    for name, x in points.items():
        x32 = jnp.asarray(x, jnp.float32)
        U, g, _ = pot(x32, alpha)
        Ur, gr, _, _ = reference.potential(
            P64["Aw"], np.asarray(x32, np.float64), P64["dobs_centered"],
            P64["aprior_mw"], P64["wm_sq"], alpha, "MS", beta)
        err_u = float(np.max(np.abs(np.asarray(U, np.float64) - Ur)
                             / np.abs(Ur)))
        err_g = float(np.max(np.abs(np.asarray(g, np.float64) - gr))
                      / np.max(np.abs(gr)))
        Ud, gd = _unstated_precision_potential(
            {k: pot.params[k] for k in ("Aw", "dobs_centered", "aprior_mw",
                                        "wm_sq")}, x32, alpha, beta)
        info[name] = {
            "U_rel_err": err_u, "grad_rel_err": err_g,
            "unstated_U_rel_err": float(np.max(
                np.abs(np.asarray(Ud, np.float64) - Ur) / np.abs(Ur))),
            "unstated_grad_rel_err": float(
                np.max(np.abs(np.asarray(gd, np.float64) - gr))
                / np.max(np.abs(gr))),
        }
        check(err_u <= U_REL_TOL, f"{name}: U rel err {err_u:.3e}")
        check(err_g <= GRAD_REL_TOL, f"{name}: grad rel err {err_g:.3e}")
    return info


def phase_uniformgrid():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gravinv3dhmc.inversion import hmc

    W, wl, dobs = _uniformgrid()
    C, S, chunk, alpha = 256, 128, 64, 1.0
    cfg = dict(delta=0.01, Lrange=(5, 20), Sigma=0.001, RegulFactor=alpha,
               regularization="MS", beta=0.001)
    module, stats, _, _, out = W.run_hmc(
        wl, dobs, nsamples=S, ndraws=0, nchains=C, chunk_size=chunk,
        verbose=False, transfer_samples=False, **cfg)
    D, M = dobs.size, module.n_active
    wdiag = np.asarray(module.wdiag)
    low, high = wdiag * wl["rhomin"], wdiag * wl["rhomax"]
    pot = module.make_potential(wdiag * 0.001, low, high,
                                regularization="MS", beta=cfg["beta"],
                                dtype=jnp.float32)
    # run_hmc starts every chain at the flat 0.001 density model
    _, _, (_, ud0, um0) = pot(jnp.asarray(wdiag[None, :] * 0.001,
                                          jnp.float32), alpha)
    misfit_start = float(ud0[0]) / D + alpha * float(um0[0]) / M
    n = int(np.min(stats["n_stored"]))
    check(n > 0, "no sample stored")
    rows = stats["misfits_device"][:, n - 1, 3]
    misfit_end = float(jnp.mean(rows))
    finite = bool(jnp.isfinite(stats["samples_device"]).all()
                  & jnp.isfinite(stats["misfits_device"]).all())

    # the chunk this run compiled, lowered again for its memory analysis
    run_chunk = hmc.make_chunk_sampler(
        pot, dt=cfg["delta"], Lmin=5, Lmax=20, Sigma=cfg["Sigma"], low=low,
        high=high, constraint="mandatory", alpha=alpha, chunk_size=chunk,
        nsamples=S, ndraws=0, wdiag_inv=module.wdiag_inv, data_size=D)
    f32 = jnp.float32
    carry = (jax.ShapeDtypeStruct((C, M), f32),
             jax.ShapeDtypeStruct((C,), f32),
             jax.ShapeDtypeStruct((C, M), f32),
             jax.ShapeDtypeStruct((C,), f32),
             jax.ShapeDtypeStruct((C,), f32),
             jax.ShapeDtypeStruct((C,), jnp.int32),
             jax.ShapeDtypeStruct((C, S, M), f32),
             jax.ShapeDtypeStruct((C, S, 7), f32))
    ma = run_chunk.jitted.lower(
        carry, jax.random.PRNGKey(0), 0, pot.params, cfg["delta"], None,
        jnp.int32(0)).compile().memory_analysis()
    mem = {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes")}
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    info = {"problem": [D, M], "nchains": C, "nsamples": S,
            "grad_evals_per_s": stats["grad_evals_per_s"],
            "accept_ratio": stats["accept_ratio"],
            "sampling_s": stats["elapsed_s"],
            "misfit_start": misfit_start, "misfit_end": misfit_end,
            "ess_per_s_median": out.get("ess_per_s_median"),
            "chunk_memory_analysis": mem, "peak_bytes_in_use": peak}
    check(finite, "non-finite sampler state")
    check(np.isfinite(misfit_end), "non-finite end misfit")
    check(stats["accept_ratio"] >= MIN_ACCEPT_UNIFORMGRID,
          f"accept {stats['accept_ratio']:.3f} < {MIN_ACCEPT_UNIFORMGRID}")
    return info


def _non_finite(out):
    import numpy as np
    return {k: v for k, v in out.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and not np.isfinite(v)}


def phase_realdata():
    import run
    out = run.main(["realdata", "--sampler", "hmc", "--adapt-mass",
                    "--adapt-chunks", "10", "--nchains", "64",
                    "--nsamples", "64", "--chunk-size", "32", "--quiet"])
    info = {k: out.get(k) for k in (
        "problem", "kernel_build_s", "accept_ratio", "ess_per_s_median",
        "grad_evals_per_s", "RMSD", "rhat_max", "total_s")}
    bad = _non_finite(out)
    check(not bad, f"non-finite output {bad}")
    check(out.get("ess_per_s_median") is not None, "no ESS")
    # the kernel builder falls back to NumPy when the C++ engine cannot be
    # built; this raises if g++ could not build it on this host
    from gravinv3dhmc.runtime import tessglq
    info["native_glq_threads"] = int(tessglq.get_lib().tessglq_num_threads())
    return info


def phase_global():
    import run
    out = run.main(["global", "--scale", "0.25", "--map-only",
                    "--cg-maxk", "60", "--quiet"])
    info = {k: out.get(k) for k in (
        "problem", "RMSD_start", "RMSD", "posterior_truth_corr", "n_iters",
        "total_s")}
    bad = _non_finite(out)
    check(not bad, f"non-finite output {bad}")
    check(out["RMSD"] < out["RMSD_start"],
          f"misfit did not fall: {out['RMSD_start']} -> {out['RMSD']}")
    return info


def phase_gpu_tests():
    import pytest

    class Tally:
        passed = 0
        failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1

    tally = Tally()
    # conftest.py keeps an already-chosen platform
    os.environ["JAX_PLATFORMS"] = "cuda"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[tally])
    info = {"passed": tally.passed, "failed": tally.failed, "rc": int(rc)}
    check(int(rc) == 0 and tally.failed == 0, f"gpu tests failed: {info}")
    check(tally.passed > 0, "no gpu test ran")
    return info


def phase_multichip(n):
    import __graft_entry__
    t0 = time.time()
    # raises on a diverged accept pattern or a relative state gap >= 1e-9
    __graft_entry__.dryrun_multichip(n, grid=(20, 30, 10))
    return {"devices": n, "problem": [600, 6000], "wall_s": time.time() - t0}


def main(argv=None):
    args = parse_args(argv)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{devs[0].platform!r}", file=sys.stderr)
        return 2
    n_cards = args.multichip or 1
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 2
    for line in card_lines():
        print(f"card: {line}")
    print(f"jax: device_kind={devs[0].device_kind} count={len(devs)}")

    sys.path[:0] = [ROOT, os.path.join(ROOT, "examples")]
    from gravinv3dhmc.runtime.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    clock = CompileClock()
    phases = {"potential": phase_potential,
              "uniformgrid": phase_uniformgrid,
              "realdata": phase_realdata, "global": phase_global,
              "gpu_tests": phase_gpu_tests,
              "multichip": lambda: phase_multichip(args.multichip)}
    failed = []
    for name in args.phases:
        print(f"== phase {name}", flush=True)
        t0, c0 = time.time(), clock.total
        try:
            info = phases[name]()
        except Exception:  # noqa: BLE001 — recorded as this phase's failure
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAIL", flush=True)
            continue
        info.update(phase_s=round(time.time() - t0, 3),
                    compile_s=round(clock.total - c0, 3))
        print(f"phase {name}: PASS {json.dumps(info)}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
