"""Whole-Earth (global) inversion demo — the reference's OOM case, on one accelerator.

Thin CLI shim: the whole path now lives in the unified driver
(``examples/run.py global`` -> workloads.run_hmc with
GravMagModule(kernel_device=True), windowed warmup adaptation and
device-resident posterior statistics). The reference attempted this
7381 x 72000 spherical inversion on a 72-CPU / 251 GB node and was
OOM-killed mid-sampling (reference: example/global/logout_T1.txt).

Usage:  python examples/global_demo.py [--nsamples 128] [--nchains 32]
        [--kernel-cache cache/global_kernel.npy] [--out GLOBAL_r03.json]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # siblings

if __name__ == "__main__":
    argv = sys.argv[1:]
    defaults = {"--scale": "1.0", "--nsamples": "128", "--ndraws": "0",
                "--nchains": "32", "--chunk-size": "32"}
    for flag, val in defaults.items():
        if not any(a == flag or a.startswith(flag + "=") for a in argv):
            argv += [flag, val]
    sys.argv = [sys.argv[0], "global"] + argv
    import run
    run.main()
