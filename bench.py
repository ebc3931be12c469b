"""Driver entry point — delegates to :mod:`gravinv3dhmc.bench`.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Prefer ``pip install -e . && python -m gravinv3dhmc.bench``; this shim
runs ``python bench.py`` from an uninstalled checkout.
"""
import os
import sys

try:
    import gravinv3dhmc  # noqa: F401 — installed?
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gravinv3dhmc.bench import main

if __name__ == "__main__":
    main()
