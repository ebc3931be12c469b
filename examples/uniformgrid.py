"""uniformgrid example: single buried cube, Cartesian uniform mesh.

Mirrors the reference workload end to end
(reference: example/uniformgrid/{model01_singlecube,main_uniform,plot_uniform}.py):
truth model -> forward + noise -> HMC inversion -> posterior mean/std with
RMSD/RMSM. The reference's two MPI ranks become ``nchains`` vmapped chains
on one chip.

Run:  python examples/uniformgrid.py [--nsamples 500] [--nchains 2] ...
"""
import argparse
import json
import os
import sys
import time

try:
    import gravinv3dhmc  # noqa: F401 — installed package?
except ImportError:  # uninstalled checkout: repo root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gravinv3dhmc import mesher, utils
from gravinv3dhmc.inversion import hmc
from gravinv3dhmc.inversion.potential import GravMagModule
from gravinv3dhmc.ops import prism


def build_truth(rhomax=1.0):
    """Single-cube truth model (reference:
    example/uniformgrid/model01_singlecube.py:24-40)."""
    dx = dy = dz = 100
    nx, ny, nz = 20, 30, 10
    bounds = (0, nx * dx, 0, ny * dy, 0, nz * dz)
    mesh = mesher.PrismMesh(bounds, (dz, dy, dx))
    rho = np.zeros((nz, ny, nx))
    rho[2:5, 10:18, 7:11] = rhomax
    rho = rho.ravel()
    mesh.addprop("density", rho)
    return bounds, mesh, rho


def forward_data(bounds, mesh, noise=0.02, seed=1):
    """Observed gz on the surface grid with 2% Gaussian noise
    (reference: example/uniformgrid/model01_singlecube.py:93-98)."""
    nx, ny = 20, 30
    xo, yo, zo = utils.regular((bounds[0], bounds[1], bounds[2], bounds[3]),
                               (nx, ny), z=0.0)
    gz_pre, _ = prism.gz(xo, yo, zo, mesh)
    gz_noise = utils.contaminate(gz_pre, noise * gz_pre.max(), seed=seed)
    return xo, yo, zo, gz_pre, gz_noise


def run(args):
    bounds, mesh, rho_true = build_truth()
    xo, yo, zo, gz_pre, dobs = forward_data(bounds, mesh)

    t0 = time.time()
    module = GravMagModule(dobs, bounds, (100, 100, 100), (xo, yo, zo),
                           coordinate="cartesian", field="gravity",
                           wavelet=args.wavelet)
    M = module.n_active
    initial_model = np.ones(M) * 0.001
    aprior_model = np.ones(M) * 0.001
    boundaries = np.stack([np.full(M, args.rhomin),
                           np.full(M, args.rhomax)], axis=1)

    stats = hmc.HMCSample(
        module, args.nsamples, args.ndraws, args.delta, args.Lrange,
        initial_model, aprior_model, boundaries, "mandatory", 1000.0, dobs,
        RegulFactor=args.RegulFactor, regularization=args.regularization,
        beta=args.beta, seed=100, Sigma=args.Sigma,
        save_folder=args.save_folder, nchains=args.nchains,
        chunk_size=args.chunk_size, verbose=not args.quiet)
    total = time.time() - t0

    # posterior statistics (reference: example/uniformgrid/plot_uniform.py:101-155)
    samples = np.concatenate(
        [stats["samples"][c, : stats["n_stored"][c]]
         for c in range(args.nchains)])
    post_mean = samples.mean(axis=0)
    post_std = samples.std(axis=0)
    d_mean = module.A @ post_mean
    rmsd = float(np.sqrt(np.mean((dobs - d_mean) ** 2)))
    rmsm = float(np.sqrt(np.mean((post_mean - rho_true) ** 2)))

    summary = {
        "workload": "uniformgrid",
        "problem": [int(dobs.size), int(M)],
        "nchains": args.nchains,
        "nsamples_per_chain": args.nsamples,
        "accept_ratio": stats["accept_ratio"],
        "total_s": total,
        "sampling_s": stats["elapsed_s"],
        "grad_evals_per_s": stats["grad_evals_per_s"],
        "RMSD_mGal": rmsd,
        "RMSM": rmsm,
        "post_max": float(post_mean.max()),
    }
    print(json.dumps(summary))
    if args.save_folder:
        np.savetxt(os.path.join(os.path.dirname(args.save_folder) or ".",
                                "posterior_mean.dat"), post_mean)
        np.savetxt(os.path.join(os.path.dirname(args.save_folder) or ".",
                                "posterior_std.dat"), post_std)
    return summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsamples", type=int, default=500)
    ap.add_argument("--ndraws", type=int, default=0)
    ap.add_argument("--nchains", type=int, default=2)
    ap.add_argument("--chunk-size", type=int, dest="chunk_size", default=64)
    ap.add_argument("--delta", type=float, default=0.01)
    ap.add_argument("--Lrange", type=int, nargs=2, default=[5, 20])
    ap.add_argument("--Sigma", type=float, default=0.001)
    ap.add_argument("--RegulFactor", type=float, default=1.0)
    ap.add_argument("--regularization", default="MS")
    ap.add_argument("--beta", type=float, default=0.001)
    ap.add_argument("--rhomin", type=float, default=0.0)
    ap.add_argument("--rhomax", type=float, default=1.0)
    ap.add_argument("--wavelet", default=False,
                    choices=[False, "1D", "3D"], type=lambda s: s if s else False)
    ap.add_argument("--save-folder", dest="save_folder",
                    default="result/uniformgrid_chain")
    ap.add_argument("--quiet", action="store_true")
    run(ap.parse_args())


if __name__ == "__main__":
    main()
