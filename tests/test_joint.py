"""Joint gravity+magnetic module tests."""
import numpy as np
import pytest

import jax.numpy as jnp

from gravinv3dhmc import mesher, utils
from gravinv3dhmc.inversion.joint import JointModule
from gravinv3dhmc.ops import prism
from gravinv3dhmc.utils.units import ang2vec


@pytest.fixture(scope="module")
def joint_problem():
    bounds = (0, 600, 0, 800, 0, 300)
    spacing = (100, 100, 100)
    mesh = mesher.PrismMesh(bounds, spacing)
    rho3 = np.zeros(mesh.shape)
    rho3[0:2, 3:6, 2:4] = 0.5
    rho = rho3.ravel()
    mag = 2.0 * rho  # structurally identical magnetization
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular((0, 600, 0, 800), (6, 8), z=-1.0)
    dgz, _ = prism.gz(xo, yo, zo, mesh)
    mesh.addprop("magnetization", mag)
    # induced magnetization via scalar per-cell values
    class MagMesh:
        def cell_bounds(self, only_active=False):
            return mesh.cell_bounds(only_active)
        props = {"magnetization": mag}
        active = mesh.active
    dtf, _ = prism.tf(xo, yo, zo, MagMesh(), inc=60.0, dec=10.0)
    jm = JointModule(dgz, dtf, bounds, spacing, (xo, yo, zo),
                     mangle=(60.0, 10.0), dtype=jnp.float64, verbose=False)
    return jm, rho, mag


def test_block_forward_matches_block_matrix(joint_problem):
    jm, rho, mag = joint_problem
    m = np.concatenate([rho, mag])
    np.testing.assert_allclose(jm.forward(m), jm.A @ m, rtol=1e-12)


def test_weighting_block_structure(joint_problem):
    jm, rho, mag = joint_problem
    # gravity block of Aw has unit column norms; magnetic block wb_tf
    np.testing.assert_allclose(np.linalg.norm(jm.Awg, axis=0), 1.0,
                               rtol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(jm.Awt, axis=0), jm.wb_tf,
                               rtol=1e-10)


def test_joint_gradient_finite_difference(joint_problem):
    jm, rho, mag = joint_problem
    n = jm.n_active
    rng = np.random.RandomState(0)
    mw = rng.uniform(0.1, 0.5, n)
    apr = np.zeros(n)
    low, high = np.full(n, -10.0), np.full(n, 10.0)
    pot = jm.make_potential(apr, low, high, regularization="Smoothness",
                            dtype=jnp.float64)
    u, g, aux = pot(mw, 0.3)
    eps = 1e-6
    for i in [0, n // 2, n - 1]:
        mp = mw.copy(); mp[i] += eps
        mm = mw.copy(); mm[i] -= eps
        up, _, _ = pot(mp, 0.3)
        um, _, _ = pot(mm, 0.3)
        fdg = (float(up) - float(um)) / (2 * eps)
        assert float(g[i]) == pytest.approx(fdg, rel=1e-5, abs=1e-6)


def test_cross_gradient_zero_for_parallel_structures(joint_problem):
    jm, rho, mag = joint_problem
    n = jm.n_active
    apr = np.zeros(n)
    low, high = np.full(n, -10.0), np.full(n, 10.0)
    pot_cg = jm.make_potential(apr, low, high, regularization="Damping",
                               cross_gradient_weight=1.0, dtype=jnp.float64)
    pot_no = jm.make_potential(apr, low, high, regularization="Damping",
                               cross_gradient_weight=0.0, dtype=jnp.float64)
    # mag exactly proportional to rho -> gradients parallel -> CG term = 0
    mw = np.concatenate([jm.wdiag[: jm.M] * rho,
                         jm.wdiag[jm.M:] * mag])
    u_cg, _, _ = pot_cg(mw, 1.0)
    u_no, _, _ = pot_no(mw, 1.0)
    assert float(u_cg) == pytest.approx(float(u_no), rel=1e-8)
    # non-parallel structures produce a positive coupling term
    rng = np.random.RandomState(1)
    mw2 = mw.copy()
    mw2[jm.M:] = jm.wdiag[jm.M:] * rng.uniform(0, 1, jm.M)
    u2_cg, _, _ = pot_cg(mw2, 1.0)
    u2_no, _, _ = pot_no(mw2, 1.0)
    assert float(u2_cg) > float(u2_no)


def test_joint_hmc_runs(joint_problem):
    from gravinv3dhmc.inversion import hmc
    jm, rho, mag = joint_problem
    n = jm.n_active
    init = np.full(n, 0.001)
    apr = np.full(n, 0.001)
    bnd = np.stack([np.full(n, -0.1), np.full(n, 2.5)], axis=1)
    dobs = np.concatenate([jm.dobs_gz, jm.dobs_tf])
    stats = hmc.HMCSample(jm, nsamples=40, ndraws=0, delta=0.005,
                          Lrange=[3, 8], initial_model=init,
                          aprior_model=apr, boundaries=bnd,
                          constraint="mandatory", log_factor=1000.0,
                          dobs=dobs, RegulFactor=1.0,
                          regularization="Damping", seed=1, Sigma=0.001,
                          nchains=2, chunk_size=16, verbose=False,
                          write_files=False, dtype=jnp.float64)
    assert min(stats["accepted"]) >= 40
    samples = stats["samples"]
    assert np.isfinite(samples).all()
