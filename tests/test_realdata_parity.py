"""Parity against the reference's committed real-data artifacts.

The reference repository ships the outputs of its actual South China run
(example/realdata/modeldata/maskindex_SC.txt written by
main_real.py:63-64); reproducing them end-to-end validates the full
spherical + segmented + topography-carving construction chain.
"""
import os

import numpy as np
import pytest

from gravinv3dhmc import mesher

REF = "/root/reference/example/realdata"


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference data absent")
def test_carvetopo_mask_matches_committed_run():
    lons_t, lats_t, topo = np.loadtxt(
        os.path.join(REF, "data", "topo_12d05d.dat"),
        usecols=[0, 1, 2], unpack=True)
    mesh = mesher.TesseroidMeshSegment(
        (106.5, 118.5, 16, 28, 2000, -60000),
        ([-1000, -2000, -5000], 0.5, 0.5),
        [2000, -5000, -15000, -60000])
    mask = mesh.carvetopo(lons_t, lats_t, topo)
    ref_mask = np.loadtxt(
        os.path.join(REF, "modeldata", "maskindex_SC.txt")).astype(int)
    assert sorted(mask) == sorted(ref_mask.tolist())
    # effective cell count from the committed log: 625 x 10427
    assert mesh.size - len(mask) == 10427


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference data absent")
def test_hmc_converges_to_reference_misfit_level():
    """Full-stack end-to-end parity: the T0 configuration on the published
    South China data must converge to the reference's logged misfit
    plateau (normalized total 333.8, data 300.1, model 33.7 —
    example/realdata/logout_T0.txt tail)."""
    import jax.numpy as jnp

    from gravinv3dhmc import utils
    from gravinv3dhmc.inversion import hmc
    from gravinv3dhmc.inversion.potential import GravMagModule

    lons, lats, heights, dobs = np.loadtxt(
        os.path.join(REF, "data", "gravinv_12d05d.dat"),
        usecols=[0, 1, 2, 3], unpack=True)
    grav_sea = np.loadtxt(os.path.join(REF, "data", "grasea_12d05d.dat"),
                          usecols=[2], unpack=True)
    lons_t, lats_t, topo = np.loadtxt(
        os.path.join(REF, "data", "topo_12d05d.dat"),
        usecols=[0, 1, 2], unpack=True)
    aprior_mesh = np.loadtxt(os.path.join(REF, "data", "SC_ApriorModel.txt"),
                             usecols=[3], unpack=True)
    module = GravMagModule(
        dobs, (106.5, 118.5, 16, 28, 2000, -60000),
        ([-1000, -2000, -5000], 0.5, 0.5), (lons, lats, heights),
        fixed=True, grav_fix=grav_sea, mseg=True,
        mdivisionsection=[2000, -5000, -15000, -60000],
        coordinate="spherical", field="gravity", verbose=False,
        mtopo=(lons_t, lats_t, topo))
    M = module.n_active
    aprior = utils.rho2carve(aprior_mesh, module.mask)
    stats = hmc.HMCSample(
        module, 300, 0, 0.01, [5, 20], np.full(M, 0.01), aprior,
        np.stack([np.full(M, -0.5), np.full(M, 0.5)], axis=1),
        "mandatory", 1000.0, dobs, RegulFactor=1.0,
        regularization="Damping", beta=0.01, seed=100, Sigma=0.01,
        nchains=2, chunk_size=64, verbose=False, write_files=False)
    final = stats["misfits"][:, -1, :]  # (C, 7)
    # reference plateau: data 300.08, model 33.74 (normalized)
    for c in range(2):
        assert final[c, 4] == pytest.approx(300.1, abs=3.0)
        assert final[c, 5] == pytest.approx(33.74, abs=0.5)
