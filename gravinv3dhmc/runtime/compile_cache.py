"""Persistent XLA compilation cache setup.

Compiling the chunk sampler at full size takes tens of seconds, and every
entry point compiles it anew in a fresh process. JAX's persistent
compilation cache replays such programs from disk on every run after the
first.

The reference has no analogue (its numba/Cython kernels cache in
``__pycache__`` / prebuilt ``.so`` files; reference: gravmag/setup.py,
gravmag/_tesseroid_numba.py).
"""
from __future__ import annotations

import os

#: Fixed default inside the checkout: the directory is part of the cache's
#: key, so a path that changed between runs would never hit.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "cache", "jaxcache")


def cache_dir() -> str:
    """Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when set,
    otherwise :data:`DEFAULT_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent) and return
    its directory.

    Must be called before the first compilation to benefit it; safe to
    call any time.
    """
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
