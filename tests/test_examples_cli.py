"""Driver-surface tests: examples/run.py modes added in round 5.

Each test launches the CLI as a real subprocess on the CPU backend (the
verify-skill recipe) and checks the one JSON line — the same surface a
user drives.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "examples", "run.py")


def _run(args, extra_env=None, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    if extra_env:
        env.update(extra_env)
    r = subprocess.run([sys.executable, RUN] + args, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_global_map_only():
    out = _run(["global", "--scale", "0.25", "--map-only",
                "--cg-maxk", "120", "--quiet"])
    assert out["estimator"].startswith("bounded MAP")
    assert out["problem"] == [496, 4500]
    # the fixed-alpha projected CG recovers real structure even at this
    # tiny budget (full scale: corr 0.849 at maxk 6400)
    assert out["posterior_truth_corr"] > 0.3
    assert out["RMSD"] < 5000


def test_global_honest_mode():
    out = _run(["global", "--scale", "0.25", "--honest", "--no-cg",
                "--nchains", "4", "--nsamples", "24",
                "--chunk-size", "8", "--adapt-chunks", "6", "--quiet"])
    assert out["target"].startswith("honest posterior")
    assert out["accept_ratio"] > 0.2
    assert "ess_frozen_floor" in out


def test_uniformgrid_multichip_virtual_mesh():
    out = _run(["uniformgrid", "--multichip", "--nchains", "4",
                "--nsamples", "16", "--chunk-size", "8", "--quiet"],
               extra_env={"XLA_FLAGS":
                          "--xla_force_host_platform_device_count=8"})
    assert out["workload"] == "uniformgrid"
    assert out["n_samples"] == 16


def test_realdata_chees_auto_temperature():
    """realdata --sampler chees: the calibrated mode on real data —
    temperature auto-derived from the bounded-MAP misfit floor."""
    out = _run(["realdata", "--sampler", "chees", "--nchains", "4",
                "--nsamples", "16", "--nwarmup", "16",
                "--chunk-size", "8", "--quiet"])
    assert out["sampler"] == "chees"
    assert out["temperature"] > 0
    assert 0.2 < out["accept_ratio"] <= 1.0
    assert out["problem"][1] > 10000  # carved spherical mesh built


def test_multichip_rejects_undivisible_chains():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    r = subprocess.run(
        [sys.executable, RUN, "uniformgrid", "--multichip",
         "--nchains", "3", "--nsamples", "8", "--quiet"],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode != 0
    assert "tile the 'chains' mesh axis" in (r.stderr + r.stdout)
