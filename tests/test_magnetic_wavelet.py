"""Magnetic-field inversion path + wavelet-compressed sampling path."""
import numpy as np
import pytest

from gravinv3dhmc import mesher, utils
from gravinv3dhmc.inversion import hmc
from gravinv3dhmc.inversion.potential import GravMagModule
from gravinv3dhmc.ops import prism


@pytest.fixture(scope="module")
def setup():
    bounds = (0, 800, 0, 800, 0, 400)
    spacing = (100, 100, 100)
    mesh = mesher.PrismMesh(bounds, spacing)
    xo, yo, zo = utils.regular((0, 800, 0, 800), (8, 8), z=-1.0)
    return bounds, spacing, mesh, (xo, yo, zo)


def test_magnetic_module_forward_parity(setup):
    bounds, spacing, mesh, obs = setup
    mag3 = np.zeros(mesh.shape)
    mag3[1:3, 3:6, 3:6] = 2.0

    class MagMesh:
        def cell_bounds(self, only_active=False):
            return mesh.cell_bounds(only_active)
        props = {"magnetization": mag3.ravel()}
        active = mesh.active

    dobs, _ = prism.tf(*obs, MagMesh(), inc=50.0, dec=20.0)
    mod = GravMagModule(dobs, bounds, spacing, obs, field="magnetic",
                        mangle=(50.0, 20.0), verbose=False)
    # induced-unit kernel columns: A @ scalar magnetizations reproduces tf
    np.testing.assert_allclose(mod.A @ mag3.ravel(), dobs, rtol=1e-10)


def test_magnetic_hmc_runs(setup):
    bounds, spacing, mesh, obs = setup
    mag3 = np.zeros(mesh.shape)
    mag3[1:3, 3:6, 3:6] = 2.0

    class MagMesh:
        def cell_bounds(self, only_active=False):
            return mesh.cell_bounds(only_active)
        props = {"magnetization": mag3.ravel()}
        active = mesh.active

    dobs, _ = prism.tf(*obs, MagMesh(), inc=50.0, dec=20.0)
    mod = GravMagModule(dobs, bounds, spacing, obs, field="magnetic",
                        mangle=(50.0, 20.0), verbose=False)
    M = mod.n_active
    bnd = np.stack([np.zeros(M), np.full(M, 3.0)], axis=1)
    stats = hmc.HMCSample(mod, nsamples=50, ndraws=0, delta=0.01,
                          Lrange=[3, 8], initial_model=np.full(M, 0.01),
                          aprior_model=np.full(M, 0.01), boundaries=bnd,
                          constraint="mandatory", log_factor=1000, dobs=dobs,
                          RegulFactor=1.0, regularization="Damping", seed=3,
                          Sigma=0.005, nchains=2, chunk_size=16,
                          verbose=False, write_files=False)
    assert min(stats["accepted"]) >= 50
    assert np.isfinite(stats["samples"]).all()


def test_wavelet_compressed_sampling(setup):
    bounds, spacing, mesh, obs = setup
    rho3 = np.zeros(mesh.shape)
    rho3[1:3, 3:6, 3:6] = 1.0
    mesh.addprop("density", rho3.ravel())
    dobs, _ = prism.gz(*obs, mesh)
    mod = GravMagModule(dobs, bounds, spacing, obs, wavelet="3D",
                        verbose=False)
    assert mod.Awcp is not None
    M = mod.n_active
    bnd = np.stack([np.zeros(M), np.ones(M)], axis=1)
    stats = hmc.HMCSample(mod, nsamples=50, ndraws=0, delta=0.01,
                          Lrange=[3, 8], initial_model=np.full(M, 0.001),
                          aprior_model=np.full(M, 0.001), boundaries=bnd,
                          constraint="mandatory", log_factor=1000, dobs=dobs,
                          RegulFactor=1.0, regularization="MS", beta=0.001,
                          seed=3, Sigma=0.001, nchains=2, chunk_size=16,
                          verbose=False, write_files=False)
    assert min(stats["accepted"]) >= 50
    post = stats["samples"].reshape(-1, M).mean(axis=0)
    # compressed-operator posterior still reduces the data misfit
    r0 = dobs - mod.A @ np.full(M, 0.001)
    r1 = dobs - mod.A @ post
    assert np.sum(r1 ** 2) < 0.5 * np.sum(r0 ** 2)
