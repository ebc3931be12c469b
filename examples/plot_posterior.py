"""Posterior statistics + figures from chain sample folders.

The equivalent of the reference's per-workload plot scripts
(reference: example/uniformgrid/plot_uniform.py,
example/realdata/plot_real_multichain.py): loads ``<folder><c>/model.dat``
for all chains, merges them, computes posterior mean/std, R-hat/ESS,
re-forwards the mean through the forward operator, reports RMSD (and RMSM
when a truth model file is given), and writes layer-panel + profile
figures.

    python examples/plot_posterior.py result/model01T1_chain --chains 2 \
        --workload uniformgrid [--truth modeldata/rho.dat] [--outdir picture]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # sibling workloads.py
try:
    import gravinv3dhmc  # noqa: F401 — installed package?
except ImportError:  # uninstalled checkout: repo root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import matplotlib

matplotlib.use("Agg")
import numpy as np

from gravinv3dhmc import diagnostics, utils
from gravinv3dhmc.ops import prism
from gravinv3dhmc.ops import tesseroid as tess
from gravinv3dhmc.vis import mpl as vmpl

import workloads as W


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("save_folder", help="chain folder prefix (no index)")
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--ndraws", type=int, default=0)
    ap.add_argument("--workload", default="uniformgrid",
                    choices=["uniformgrid", "segmentgrid", "ratiogrid",
                             "global", "realdata"])
    ap.add_argument("--truth", default=None,
                    help="optional dense truth-model file")
    ap.add_argument("--outdir", default="picture")
    ap.add_argument("--mask", default=None,
                    help="maskindex file for carved meshes (carve2rho)")
    args = ap.parse_args()

    chains = diagnostics.load_chains(args.save_folder, args.chains,
                                     ndraws=args.ndraws)
    mean, std = diagnostics.posterior_stats(chains)

    builders = {"uniformgrid": W.uniformgrid, "segmentgrid": W.segmentgrid,
                "ratiogrid": W.ratiogrid,
                "global": lambda: W.global_tess(1.0)}
    out = {
        "chains": int(chains.shape[0]),
        "samples_per_chain": int(chains.shape[1]),
        "rhat_max": float(np.nanmax(diagnostics.split_rhat(chains))),
        "ess_min": float(np.nanmin(diagnostics.effective_sample_size(chains))),
    }

    mesh = None
    dense_mean = mean
    if args.workload in builders:
        wl = builders[args.workload]()
        mesh = wl["mesh"]
        xo, yo, zo = wl["obs"]
        # re-forward the posterior mean (reference re-forwards via
        # prism.gz / tesseroidforward.gz, plot_uniform.py:118)
        if args.mask:
            maskidx = np.loadtxt(args.mask).astype(int)
            dense_mean = utils.carve2rho(mean, np.zeros(mesh.size), maskidx)
        if wl.get("mesh_kwargs", {}).get("coordinate") == "spherical":
            dpre = (tess.tesseroid_kernel_matrix("gz", xo, yo, zo, mesh)
                    @ dense_mean[mesh.active])
        else:
            k = prism.prism_kernel_matrix("gz", xo, yo, zo, mesh)
            dpre = k @ dense_mean[mesh.active]
        if "rho" in wl:
            out["RMSM"] = diagnostics.rmsm(dense_mean, wl["rho"])
        _, dobs = W.forward_with_noise(wl)
        out["RMSD"] = diagnostics.rmsd(dobs, dpre)

    if args.truth:
        truth = np.loadtxt(args.truth).ravel()
        out["RMSM_vs_file"] = diagnostics.rmsm(dense_mean, truth)

    os.makedirs(args.outdir, exist_ok=True)
    if args.workload == "realdata":
        # map-view posterior data figure with coastlines, the realdata
        # plot-script pattern (reference:
        # example/realdata/plot_real_multichain.py:179-199 — Basemap
        # contourf + meridians/parallels; coastline drawn here from the
        # topography zero contour, exact for the region)
        import matplotlib.pyplot as plt

        rd = W.realdata_southchina()
        lons, lats, heights = rd["obs"]
        dobs = rd["dobs"]
        west, east = lons.min(), lons.max()
        south, north = lats.min(), lats.max()
        bm = vmpl.basemap((west, east, south, north), "merc")
        nlat = np.unique(lats).size
        nlon = lons.size // nlat
        shape = (nlat, nlon)
        grd = os.path.join(W.REFERENCE_DATA, "data", "topo_12d05d.grd")
        coast_src = grd if os.path.exists(grd) else None
        for name, vals in (("dobs", dobs),):
            plt.figure(figsize=(7, 7))
            vmpl.contourf(lons, lats, vals, shape, 15, basemap=bm)
            plt.colorbar(label="mGal")
            vmpl.draw_coastlines(bm, linewidth=1.0, source=coast_src)
            vmpl.draw_countries(bm, linewidth=0.5)
            bm.drawmeridians(np.linspace(west, east, 5), linewidth=0.2)
            bm.drawparallels(np.linspace(south, north, 5), linewidth=0.2)
            plt.gca().set_aspect("equal")
            plt.title(f"realdata {name}")
            plt.savefig(os.path.join(args.outdir, f"realdata_{name}.png"),
                        dpi=200, bbox_inches="tight")
            plt.close()
        out["figures"] = args.outdir
    if mesh is not None:
        fig = vmpl.layers(mesh, dense_mean, suptitle="posterior mean")
        fig.savefig(os.path.join(args.outdir, "posterior_mean_layers.png"),
                    dpi=200)
        dense_std = (utils.carve2rho(std, np.zeros(mesh.size),
                                     np.loadtxt(args.mask).astype(int))
                     if args.mask else std)
        fig = vmpl.layers(mesh, dense_std, suptitle="posterior std")
        fig.savefig(os.path.join(args.outdir, "posterior_std_layers.png"),
                    dpi=200)
        fig = vmpl.profile(mesh, dense_mean, axis="x",
                           index=mesh.shape[1] // 2)
        fig.savefig(os.path.join(args.outdir, "posterior_mean_profile.png"),
                    dpi=200)
        out["figures"] = args.outdir
    print(json.dumps(out))


if __name__ == "__main__":
    main()
