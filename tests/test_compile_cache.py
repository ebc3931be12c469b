"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR says,
and otherwise at one fixed path in the checkout."""
import json
import os
import subprocess
import sys

from gravinv3dhmc.runtime import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import json, jax; "
          "from gravinv3dhmc.runtime.compile_cache import "
          "enable_compile_cache; "
          "d = enable_compile_cache(); "
          "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))")


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_honours_env_dir(tmp_path):
    target = str(tmp_path / "xla-cache")
    used, configured = _probe(target)
    assert used == configured == target
    assert os.path.isdir(target)


def test_default_dir_is_fixed(monkeypatch):
    """Without the variable the cache sits at <checkout>/cache/jaxcache in
    every process: no process id or time in the path, so a second run
    finds what the first compiled."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = os.path.join(ROOT, "cache", "jaxcache")
    assert compile_cache.cache_dir() == expected
    first = _probe(None)
    second = _probe(None)
    assert first == second == [expected, expected]
