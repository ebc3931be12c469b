"""Workload library: the reference's seven example configurations.

Each builder returns (mrange, mspacing, mesh_kwargs, truth_rho, obs) with
the exact geometry and anomalous bodies of the corresponding reference
example (file citations inline); the shared runners drive HMC or CG
inversion and posterior statistics on top of them.
"""
from __future__ import annotations

import os
import sys
import time

try:
    import gravinv3dhmc  # noqa: F401 — installed package?
except ImportError:  # uninstalled checkout: repo root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gravinv3dhmc import diagnostics, mesher, utils
from gravinv3dhmc.inversion import hmc
from gravinv3dhmc.inversion.potential import GravMagModule
from gravinv3dhmc.inversion.reginv import BootStrap, ConjugateGradient
from gravinv3dhmc.ops import prism
from gravinv3dhmc.ops import tesseroid as tess

REFERENCE_DATA = "/root/reference/example/realdata"


def _box(rho3, iz, iy, ix, value):
    rho3[iz[0]: iz[1] + 1, iy[0]: iy[1] + 1, ix[0]: ix[1] + 1] = value


# ---------------------------------------------------------------------------
# Cartesian synthetic workloads
# ---------------------------------------------------------------------------

def uniformgrid():
    """Single cube, 20x30x10 uniform mesh
    (reference: example/uniformgrid/model01_singlecube.py:24-40)."""
    nx, ny, nz = 20, 30, 10
    d = 100
    mrange = (0, nx * d, 0, ny * d, 0, nz * d)
    mesh = mesher.PrismMesh(mrange, (d, d, d))
    rho3 = np.zeros(mesh.shape)
    _box(rho3, (2, 4), (10, 17), (7, 10), 1.0)
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=(d, d, d), mesh=mesh, rho=rho,
                obs=(xo, yo, zo), mesh_kwargs={}, rhomin=0.0, rhomax=1.0)


def segmentgrid():
    """Single cube on a segmented-depth mesh
    (reference: example/segmentgrid/model_seg.py:25-45)."""
    nx, ny = 20, 30
    d = 100
    mrange = (0, 2000, 0, 3000, 0, 2100)
    division = [0, 300, 900, 2100]
    spacing = ([100, 200, 300], d, d)
    mesh = mesher.PrismMeshSegment(mrange, spacing, division)
    rho3 = np.zeros(mesh.shape)
    _box(rho3, (2, 4), (10, 17), (7, 10), 1.0)
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=spacing, mesh=mesh, rho=rho,
                obs=(xo, yo, zo),
                mesh_kwargs=dict(mseg=True, mdivisionsection=division),
                rhomin=0.0, rhomax=1.0)


def ratiogrid():
    """Dyke complex on a geometric-ratio mesh
    (reference: example/ratiogrid/model_ratio.py:25-56, SetPMTS mratio=1.05)."""
    d = 200
    mrange = (0, 6000, 0, 6000, 0, 6000)
    mesh = mesher.PrismMesh(mrange, (d, d, d), ratio=1.05)
    nz, ny, nx = mesh.shape
    rho3 = np.zeros(mesh.shape)
    rho_density = 0.4
    # left vertical dyke / three horizontal bars
    _box(rho3, (2, min(15, nz - 1)), (10, 11), (5, 25), rho_density)
    _box(rho3, (3, min(16, nz - 1)), (12, 21), (23, 25), rho_density)
    _box(rho3, (5, min(9, nz - 1)), (12, 21), (14, 16), rho_density)
    _box(rho3, (3, min(16, nz - 1)), (12, 21), (5, 7), rho_density)
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=(d, d, d), mesh=mesh, rho=rho,
                obs=(xo, yo, zo), mesh_kwargs=dict(mratio=1.05),
                rhomin=0.0, rhomax=0.4)


# ---------------------------------------------------------------------------
# CG synthetic models (reference: example/CG/model0*.py)
# ---------------------------------------------------------------------------

def cg_model(name="model03_twodykes"):
    if name == "model01_singlecube":
        return uniformgrid()
    d = 100
    if name == "model02_twocubes":
        nx, ny, nz = 20, 30, 10
        mrange = (0, nx * d, 0, ny * d, 0, nz * d)
        mesh = mesher.PrismMesh(mrange, (d, d, d))
        rho3 = np.zeros(mesh.shape)
        # reference model02 uses a rhomin=-1 cube and a rhomax=+1 cube
        # (example/CG/model02_twocubes.py:47-53)
        _box(rho3, (2, 4), (5, 11), (8, 12), -1.0)
        _box(rho3, (3, 5), (18, 24), (8, 12), 1.0)
        rhomin, rhomax = -1.0, 1.0
    elif name == "model03_twodykes":
        nx, ny, nz = 30, 40, 10
        mrange = (0, nx * d, 0, ny * d, 0, nz * d)
        mesh = mesher.PrismMesh(mrange, (d, d, d))
        rho3 = np.zeros(mesh.shape)
        # two dipping dykes (example/CG/model03_twodykes.py:51-57)
        for iz in range(1, 4):
            rho3[iz, iz + 8: iz + 11, 14:17] = 1.0
        for iz in range(2, 8):
            rho3[iz, -iz + 24: -iz + 33, 11:20] = 1.0
        rhomin, rhomax = 0.0, 1.0
    elif name == "model04_complex":
        nx, ny, nz = 30, 40, 10
        mrange = (0, nx * d, 0, ny * d, 0, nz * d)
        mesh = mesher.PrismMesh(mrange, (d, d, d))
        rho3 = np.zeros(mesh.shape)
        # five bodies (example/CG/model04_complex.py:47-64)
        _box(rho3, (2, 6), (24, 27), (7, 10), 1.0)
        _box(rho3, (3, 5), (27, 31), (15, 20), 1.0)
        _box(rho3, (2, 4), (10, 16), (5, 7), 1.0)
        _box(rho3, (2, 4), (14, 16), (7, 15), 1.0)
        _box(rho3, (2, 6), (9, 19), (21, 24), 1.0)
        rhomin, rhomax = 0.0, 1.0
    else:
        raise ValueError(f"unknown CG model {name}")
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=(d, d, d), mesh=mesh, rho=rho,
                obs=(xo, yo, zo), mesh_kwargs={}, rhomin=rhomin,
                rhomax=rhomax)


# ---------------------------------------------------------------------------
# Spherical workloads
# ---------------------------------------------------------------------------

def global_tess(scale=1.0):
    """Whole-Earth tesseroid inversion — the workload that OOM-killed the
    reference (reference: example/global/model_global.py:47-82,
    example/global/logout_T1.txt). ``scale`` < 1 coarsens the mesh for
    quick runs; scale=1 is the full 120x60x10 = 72000-cell problem.
    """
    dlon = dlat = 3 / scale
    nlon, nlat, nr = int(120 * scale), int(60 * scale), 10
    dr = -300000
    mrange = (-180, 180, -90, 90, 0, nr * dr)
    mesh = mesher.TesseroidMesh(mrange, (dr, dlat, dlon))
    assert mesh.shape == (nr, nlat, nlon)
    rho3 = np.zeros(mesh.shape)

    def sbox(iz, iy, ix, value):
        s = scale
        rho3[iz[0]: iz[1] + 1,
             int(iy[0] * s): int(iy[1] * s) + 1,
             int(ix[0] * s): int(ix[1] * s) + 1] = value

    sbox((2, 6), (25, 40), (25, 40), 0.8)
    sbox((2, 6), (10, 20), (60, 70), 0.4)
    sbox((2, 5), (45, 50), (60, 90), 0.6)
    sbox((2, 4), (30, 35), (70, 80), 0.5)
    sbox((2, 4), (25, 30), (90, 100), 0.5)
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    lons, lats, heights = utils.regular((-180, 180, -90, 90),
                                        (nlon + 1, nlat + 1), z=5000.0)
    return dict(mrange=mrange, mspacing=(dr, dlat, dlon), mesh=mesh,
                rho=rho, obs=(lons, lats, heights),
                mesh_kwargs=dict(coordinate="spherical"),
                rhomin=0.0, rhomax=0.8)


def realdata_southchina():
    """South China real-data case: spherical + segmented + topography +
    frozen water cells + prior model
    (reference: example/realdata/main_real.py:21-75). Loads the published
    observation files from the reference tree when present; otherwise
    synthesises a comparable dataset."""
    mrange = (106.5, 118.5, 16, 28, 2000, -60000)
    division = [2000, -5000, -15000, -60000]
    spacing = ([-1000, -2000, -5000], 0.5, 0.5)
    data_dir = os.path.join(REFERENCE_DATA, "data")
    if os.path.isdir(data_dir):
        lons, lats, heights, dobs = np.loadtxt(
            os.path.join(data_dir, "gravinv_12d05d.dat"),
            usecols=[0, 1, 2, 3], unpack=True)
        grav_sea = np.loadtxt(os.path.join(data_dir, "grasea_12d05d.dat"),
                              usecols=[2], unpack=True)
        lons_t, lats_t, topo = np.loadtxt(
            os.path.join(data_dir, "topo_12d05d.dat"),
            usecols=[0, 1, 2], unpack=True)
        aprior_mesh = np.loadtxt(
            os.path.join(data_dir, "SC_ApriorModel.txt"),
            usecols=[3], unpack=True)
    else:
        # synthetic stand-in with the same geometry
        lons, lats = np.meshgrid(np.arange(106.75, 118.5, 0.5),
                                 np.arange(16.25, 28.0, 0.5))
        lons, lats = lons.ravel(), lats.ravel()
        heights = np.full(lons.size, 0.0)
        rng = np.random.RandomState(0)
        dobs = rng.normal(0, 20, lons.size)
        grav_sea = np.zeros(lons.size)
        lons_t, lats_t, topo = lons, lats, rng.uniform(-2000, 2000,
                                                       lons.size)
        aprior_mesh = None
    return dict(mrange=mrange, mspacing=spacing,
                division=division, obs=(lons, lats, heights), dobs=dobs,
                grav_sea=grav_sea, topo=(lons_t, lats_t, topo),
                aprior_mesh=aprior_mesh, rhomin=-0.5, rhomax=0.5)


# ---------------------------------------------------------------------------
# shared runners
# ---------------------------------------------------------------------------

def _cache_meta_path(kernel_cache):
    """Per-cache metadata file (``k.npy`` -> ``k.meta.json``): a fixed
    per-directory name would let two caches in one directory clobber each
    other's metadata."""
    stem = kernel_cache[:-4] if kernel_cache.endswith(".npy") \
        else kernel_cache
    return stem + ".meta.json"


def _geometry_fingerprint(wl):
    """Hash of everything the kernel matrix depends on — mesh bounds,
    spacing, mesh kwargs and observation coordinates — so a
    shape-compatible cache from a DIFFERENT geometry is rejected instead
    of silently replaying wrong observations."""
    import hashlib
    h = hashlib.sha256()
    h.update(repr(tuple(np.asarray(wl["mrange"], np.float64))).encode())
    h.update(repr(wl["mspacing"]).encode())
    h.update(repr(sorted(wl.get("mesh_kwargs", {}).items())).encode())
    for a in wl["obs"]:
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()


def forward_with_noise(wl, noise=0.02, seed=1, kernel_cache=None):
    """Forward the synthetic truth + seeded noise. When ``kernel_cache``
    points at an existing ``.npy`` kernel matrix (the same file
    :class:`GravMagModule` caches), the forward is one matvec against it
    instead of a full rebuild — at global scale that saves a second
    ~90 s kernel construction."""
    import json

    xo, yo, zo = wl["obs"]
    if kernel_cache and os.path.exists(kernel_cache):
        K = np.load(kernel_cache, mmap_mode="r")
        D, M = len(wl["obs"][0]), len(wl["rho"])
        if K.shape != (D, M):
            raise ValueError(
                f"kernel cache {kernel_cache} has shape {K.shape}, but the "
                f"current workload needs ({D}, {M}) — stale cache from a "
                "different --scale or geometry?")
        meta_path = _cache_meta_path(kernel_cache)
        fp = _geometry_fingerprint(wl)
        if os.path.exists(meta_path):
            meta = json.load(open(meta_path))
            if meta.get("geometry") not in (None, fp):
                raise ValueError(
                    f"kernel cache {kernel_cache} was built for a "
                    "different geometry (fingerprint mismatch in "
                    f"{meta_path}) — delete the cache or pass the "
                    "matching workload")
        dpre = K @ np.asarray(wl["rho"], dtype=K.dtype)
    else:
        t0 = time.time()
        if wl.get("mesh_kwargs", {}).get("coordinate") == "spherical":
            dpre, K = tess.gz(xo, yo, zo, wl["mesh"])
        else:
            dpre, K = prism.gz(xo, yo, zo, wl["mesh"])
        wl["kernel_build_host_s"] = time.time() - t0
        if kernel_cache:
            # persist the f64 host kernel: later runs forward with one
            # matvec, and the device-built kernel can be spot-checked
            # against it (examples/run.py cmd_global)
            os.makedirs(os.path.dirname(kernel_cache) or ".",
                        exist_ok=True)
            np.save(kernel_cache, K)
            with open(_cache_meta_path(kernel_cache), "w") as f:
                json.dump({"shape": list(K.shape),
                           "geometry": _geometry_fingerprint(wl),
                           "build_s": wl["kernel_build_host_s"]}, f)
        del K
    dobs = utils.contaminate(dpre, noise * np.abs(dpre).max(), seed=seed)
    return dpre, dobs


def device_posterior_summary(module, stats, dobs, truth=None, sub=128):
    """Posterior statistics computed ON DEVICE from the sampler's
    device-resident buffers (transfer_samples=False runs): mean/std,
    RMSD, RMSM/correlation vs truth and ESS — only scalars reach the
    host."""
    import jax.numpy as jnp

    buf = stats["samples_device"]           # (C, nsamples, M) unweighted m
    n_common = int(min(stats["n_stored"].min(), buf.shape[1]))
    out = {"n_common": n_common}
    if n_common == 0:
        out.update(RMSD=float("nan"), mean_model_max=float("nan"),
                   std_model_max=float("nan"))
        if truth is not None:
            out.update(RMSM=float("nan"),
                       posterior_truth_corr=float("nan"))
        return out, None
    sl = buf[:, :n_common]
    mean_m = jnp.mean(sl, axis=(0, 1))
    std_m = jnp.std(sl, axis=(0, 1))
    wdiag_d = jnp.asarray(module.wdiag, module.dtype)
    dpre = module.predict(mean_m * wdiag_d)
    dobs_d = jnp.asarray(dobs, module.dtype)
    # mean-removed residual — the misfit convention the inversion targets
    # (reference: inversion/potential.py:706-708); the absolute offset is
    # unconstrained by design, so an offset-inclusive RMSD would measure
    # something the posterior never controlled
    r = (dpre - jnp.mean(dpre)) - (dobs_d - jnp.mean(dobs_d))
    out["RMSD"] = float(jnp.sqrt(jnp.mean(r ** 2)))
    out["mean_model_max"] = float(jnp.max(mean_m))
    out["std_model_max"] = float(jnp.max(std_m))
    if truth is not None:
        t_d = jnp.asarray(truth, module.dtype)
        out["RMSM"] = float(jnp.sqrt(jnp.mean((mean_m - t_d) ** 2)))
        out["posterior_truth_corr"] = float(
            jnp.corrcoef(jnp.stack([mean_m, t_d]))[0, 1])
        # statistical realness of the POSTERIOR (not just its mean): the
        # fraction of cells whose truth lies within mean +- 2 std. A
        # well-calibrated Gaussian-ish posterior covers ~95%; a
        # random-walk stuck in a ball around its start covers ~0 for
        # every cell the data actually constrains.
        out["coverage_2std"] = float(jnp.mean(
            (jnp.abs(mean_m - t_d) <= 2.0 * std_m)))
        # amplitude ratio of the recovered field vs truth: >1 means the
        # mean over-amplifies (shrinkage via a larger RegulFactor would
        # lower RMSM at the same correlation)
        out["amplitude_ratio"] = float(
            jnp.sqrt(jnp.mean(mean_m ** 2) / jnp.mean(t_d ** 2)))
    if n_common >= 8:
        from gravinv3dhmc.diagnostics import ess_jax
        idx = np.random.RandomState(0).choice(
            buf.shape[2], size=min(buf.shape[2], sub), replace=False)
        ess = ess_jax(sl[:, :, jnp.asarray(idx)])
        out["ess_median"] = float(jnp.median(ess))
        # the estimator's DEGENERATE floor at this (C, N): chains with
        # zero within-chain variance (bitwise-frozen states — exactly
        # what the full-scale Sigma-tempered target produces once dt
        # freezes) yield this value deterministically, ~= the chain
        # count. An ess_median at the floor measures the ensemble SIZE,
        # not mixing — flag it instead of reporting it as evidence.
        C = buf.shape[0]
        # f32 explicitly, like the sample buffer: under the package-wide
        # x64 mode linspace would be f64
        frozen = jnp.broadcast_to(
            jnp.linspace(0.0, 1.0, C, dtype=jnp.float32)[:, None, None],
            (C, n_common, 4))
        floor = float(jnp.median(ess_jax(frozen)))
        out["ess_frozen_floor"] = floor
        out["ess_degenerate"] = bool(out["ess_median"] < 1.25 * floor)
    return out, mean_m


def run_hmc(wl, dobs, nsamples=500, ndraws=0, nchains=2, delta=0.01,
            Lrange=(5, 20), Sigma=0.001, RegulFactor=1.0,
            regularization="MS", beta=0.001, wavelet=False, chunk_size=64,
            save_folder=None, seed=100, verbose=True, kernel_cache=None,
            sampler="hmc", nwarmup=None, temperature=None,
            adapt_step_size=False, adapt_mass=False, adapt_chunks=10,
            kernel_device=False, transfer_samples=True,
            cg_warm_start=False, cg_maxk=200, cg_alpha=None,
            store_mode="accepted", store_thin=1, spmd_mesh=None,
            constraint="mandatory", jacobian=False, hmc_temperature=1.0):
    """Shared sampling driver (reference: example/*/main_*.py pattern).

    ``sampler`` selects the MCMC kernel: ``'hmc'`` — the reference's
    fixed-L leapfrog HMC; ``'nuts'`` / ``'chees'`` — the adaptive
    extensions (inversion/nuts.py, inversion/chees.py) with dual-averaging
    step size; ``ndraws`` doubles as the warm-up length for those unless
    ``nwarmup`` is given.

    ``kernel_device=True`` builds the sensitivity kernel on the
    accelerator (GravMagModule kernel_device path — the whole-Earth
    link-safe configuration) and ``transfer_samples=False`` keeps the
    posterior buffers device-resident, with statistics computed on device
    (:func:`device_posterior_summary`).

    ``cg_warm_start=True`` runs the device-resident ConjugateGradient
    first (reginv.cg_device) and seeds every chain at its solution — the
    reference's own production workflow ("CG for the map, HMC for the
    uncertainty around it"): with the reference's Sigma-tempered kinetic
    the HMC posterior is a narrow ball around its start, so starting at
    the MAP is what makes the whole-Earth posterior fit the data.

    ``spmd_mesh`` (a parallel.make_mesh (chains, model) mesh) runs the
    fixed-L HMC sampler SPMD over multiple chips: kernel columns sharded
    over 'model', the chain batch over 'chains' (the reference's
    analogue is mpiexec ranks, run_main.sh:16-20). The full warmup
    adaptation and chain-store feature set rides along (hmc.spmd_mesh).
    """
    mesh_kwargs = dict(wl.get("mesh_kwargs", {}))
    t0 = time.time()
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           wavelet=wavelet, verbose=verbose,
                           kernel_cache=kernel_cache,
                           kernel_device=kernel_device, **mesh_kwargs)
    M = module.n_active
    initial = np.full(M, 0.001)
    aprior = np.full(M, 0.001)
    boundaries = np.stack([np.full(M, wl["rhomin"]),
                           np.full(M, wl["rhomax"])], axis=1)
    cg_info = None
    if cg_warm_start:
        import jax.numpy as jnp

        from gravinv3dhmc.inversion.reginv import cg_device

        t_cg = time.time()
        # cg_alpha: a FIXED regularization weight for the warm start —
        # the reference's adaptive schedule diverges at whole-Earth
        # scale (GLOBAL_r04 reference_cg_divergence; its RMSD-17018
        # "warm start" was actively harmful), while the fixed-alpha
        # projected CG converges (tools/bounded_map.py ladder)
        cg = cg_device(module, dobs, (wl["rhomin"], wl["rhomax"]),
                       regularization=regularization, beta=beta, q=0.7,
                       maxk=cg_maxk, dtype=jnp.float32, alpha=cg_alpha)
        # CG-point data fit, mean-removed like the HMC misfit — scalars
        dpre_cg = module.predict(cg["mw"])
        dobs_d = jnp.asarray(dobs, jnp.float32)
        r = ((dpre_cg - jnp.mean(dpre_cg))
             - (dobs_d - jnp.mean(dobs_d)))
        d_h = [round(float(v), 3) for v in cg["data_hist"]]
        cg_info = {
            "n_iters": cg["n_iters"],
            "elapsed_s": time.time() - t_cg,
            "RMSD": float(jnp.sqrt(jnp.mean(r ** 2))),
            "alpha": cg_alpha,
            # head/min/tail of the misfit history — the full 200-entry
            # list bloated every artifact line without adding evidence
            "data_hist_head": d_h[:5],
            "data_hist_min": min(d_h),
            "data_hist_last": d_h[-1],
            "diverged": d_h[-1] > 2.0 * min(d_h),
            "regul_hist_last": float(cg["regul_hist"][-1]),
        }
        if verbose:
            print(f"CG warm start: {cg['n_iters']} iters, "
                  f"RMSD {cg_info['RMSD']:.2f}, "
                  f"{cg_info['elapsed_s']:.1f}s", flush=True)
        initial = cg["m"]  # device (M,) — stays on device end to end
    if spmd_mesh is not None and sampler != "hmc":
        raise ValueError("--multichip currently drives the fixed-L HMC "
                         "sampler only (nuts/chees vmap chains on one "
                         "device)")
    if sampler == "hmc":
        if temperature is not None:
            raise ValueError(
                "--temperature applies to the adaptive samplers only "
                "(nuts/chees); the reference HMC kernel's effective "
                "tempering comes from Sigma (inversion/hmc.py docstring)")
        stats = hmc.HMCSample(
            module, nsamples, ndraws, delta, list(Lrange), initial, aprior,
            boundaries, constraint, 1000.0, dobs, RegulFactor=RegulFactor,
            regularization=regularization, beta=beta, seed=seed, Sigma=Sigma,
            save_folder=save_folder or "result/chain", nchains=nchains,
            chunk_size=chunk_size, verbose=verbose,
            write_files=save_folder is not None and transfer_samples,
            adapt_step_size=adapt_step_size, adapt_mass=adapt_mass,
            adapt_chunks=adapt_chunks, transfer_samples=transfer_samples,
            store_mode=store_mode, store_thin=store_thin,
            spmd_mesh=spmd_mesh, jacobian=jacobian,
            temperature=hmc_temperature)
        if not transfer_samples:
            # device-resident finish: stats on device, scalars only
            out, _ = device_posterior_summary(module, stats, dobs,
                                              truth=wl.get("rho"))
            out.update(sampler=sampler, total_s=time.time() - t0,
                       sampling_s=stats["elapsed_s"],
                       grad_evals_per_s=stats["grad_evals_per_s"],
                       accept_ratio=stats["accept_ratio"],
                       step_size=stats["step_size"],
                       adapted_mass=stats.get("adapted_mass", False))
            if cg_info:
                out["cg"] = cg_info
            if out.get("ess_median") is not None:
                out["ess_per_s_median"] = (out["ess_median"]
                                           / max(stats["elapsed_s"], 1e-9))
            return module, stats, None, None, out
        chains = np.stack([stats["samples"][c, : int(stats["n_stored"][c])]
                           for c in range(nchains)])
    elif sampler in ("nuts", "chees"):
        warm = nwarmup if nwarmup is not None else max(ndraws, 100)
        # temperature: the adaptive samplers target exp(-U/T) with the
        # PROPER Jacobian-corrected box transform. T=1 (default) is the
        # honest Bayesian posterior; T=Sigma^2 approximates the effective
        # target of the reference's p ~ N(0, Sigma^2) unit-mass quirk
        # (see GravMagModule.make_potential temperature).
        if temperature is not None and temperature <= 0:
            raise ValueError(f"temperature must be positive, "
                             f"got {temperature}")
        kwargs = dict(RegulFactor=RegulFactor,
                      regularization=regularization, beta=beta, seed=seed,
                      step_size0=delta, nchains=nchains, verbose=verbose,
                      save_folder=save_folder,
                      temperature=(temperature if temperature is not None
                                   else 1.0))
        if sampler == "nuts":
            from gravinv3dhmc.inversion.nuts import NUTSSample
            stats = NUTSSample(module, nsamples, warm, initial, aprior,
                               boundaries, dobs, **kwargs)
        else:
            from gravinv3dhmc.inversion.chees import CheesSample
            stats = CheesSample(module, nsamples, warm, initial, aprior,
                                boundaries, dobs, **kwargs)
        chains = stats["samples"]
        # derived throughput stats in the HMC result's vocabulary
        if "grad_evals" in stats:
            stats["grad_evals_per_s"] = (stats["grad_evals"]
                                         / max(stats["elapsed_s"], 1e-9))
        else:  # NUTS: 2^depth - 1 leapfrog steps per draw
            stats["grad_evals_per_s"] = float("nan")
        stats["accept_ratio"] = stats.get("mean_accept", float("nan"))
    else:
        raise ValueError(
            "sampler must be one of 'hmc', 'nuts', 'chees'")
    total = time.time() - t0
    mean, std = diagnostics.posterior_stats(chains)
    if module.A is not None:
        dpre_mean = module.A @ mean
    else:  # device-built kernel: forward on device
        import jax.numpy as jnp
        dpre_mean = np.asarray(module.predict(
            jnp.asarray(mean * module.wdiag, module.dtype)), np.float64)
    out = diagnostics.summarize(chains, dobs=dobs, dpre=dpre_mean,
                                truth=wl.get("rho"), post_mean=mean)
    out.update(sampler=sampler, total_s=total,
               sampling_s=stats["elapsed_s"],
               grad_evals_per_s=stats["grad_evals_per_s"],
               accept_ratio=stats["accept_ratio"])
    if cg_info:
        out["cg"] = cg_info
    # ESS/s over a parameter subsample (north-star metric, BASELINE.json)
    n_common = chains.shape[1]
    if n_common >= 8:
        sub = np.random.RandomState(0).choice(
            M, size=min(M, 128), replace=False)
        ess = diagnostics.effective_sample_size(chains[:, :, sub])
        out["ess_per_s_median"] = (float(np.median(ess))
                                   / max(stats["elapsed_s"], 1e-9))
    return module, stats, mean, std, out


def run_cg(wl, dobs, regularization="MS", beta=0.001, q=0.7, maxk=200,
           wavelet=False, verbose=True):
    """Shared CG driver (reference: example/CG/main_prism_CG.py:40-76)."""
    inv3d = ConjugateGradient(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                              wavelet=wavelet, verbose=verbose,
                              **{k: v for k, v in
                                 wl.get("mesh_kwargs", {}).items()})
    M = inv3d.msize
    model_inv, data_inv, d_h, m_h, r_h = inv3d.CG(
        np.zeros(M), np.zeros(M), (wl["rhomin"], wl["rhomax"]),
        regularization=regularization, beta=beta, q=q, maxk=maxk)
    out = {
        "iterations": len(d_h),
        "final_data_misfit": float(d_h[-1]),
        "RMSD": diagnostics.rmsd(dobs, data_inv),
    }
    if "rho" in wl:
        out["RMSM"] = diagnostics.rmsm(model_inv, wl["rho"])
        out["corr"] = float(np.corrcoef(model_inv, wl["rho"])[0, 1])
    return inv3d, model_inv, data_inv, out
