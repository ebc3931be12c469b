"""chip_smoke.py and the bench measure the card and never fall back to
the CPU; the smoke's phase selection."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run_on_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(ROOT, script)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    r = _run_on_cpu(script)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "GPU" in r.stderr


def test_phase_and_argument_parsing():
    assert chip_smoke.parse_args([]).phases == chip_smoke.PHASES
    args = chip_smoke.parse_args(["--phases", "potential,global"])
    assert args.phases == ("potential", "global")
    assert args.multichip == 0
    # the four-card path runs that phase and no other
    args = chip_smoke.parse_args(["--multichip", "4", "--phases",
                                  "potential"])
    assert args.phases == ("multichip",) and args.multichip == 4
    for bad in (["--phases", "potential,warp"], ["--phases", ","],
                ["--multichip", "1"]):
        with pytest.raises(SystemExit):
            chip_smoke.parse_args(bad)
