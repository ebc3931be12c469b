"""Spherical (tesseroid) magnetics — an EXTENSION beyond the reference,
which declares it not implemented (readme.md:9-18; its GravMagModule
stubs the spherical+magnetic branch, inversion/potential.py:106-108).

Built on Poisson's relation over the adaptive-GLQ tensor kernels.
Correctness anchors: the flat-earth limit (a small tesseroid at the
equator is an equivalent right prism, so every magnetic quantity must
match ops.prism's magnetics), the induced-unit-column kernel property,
and the tf == bz identity for a vertical field."""
import numpy as np
import pytest

from gravinv3dhmc import mesher
from gravinv3dhmc.ops import prism as P
from gravinv3dhmc.ops import tesseroid as T

R = T.MEAN_EARTH_RADIUS
D2R = np.pi / 180

# small equatorial tesseroid: ~1.1 km across, 1 km thick, 2 km deep
W, E, S, N, TOP, BOT = -0.005, 0.005, -0.005, 0.005, -2000.0, -3000.0
CELLS = np.array([[W, E, S, N, TOP, BOT]])
PRISM = np.array([[R * S * D2R, R * N * D2R,
                   R * W * D2R, R * E * D2R, -TOP, -BOT]])

LONS = np.array([0.02, -0.015, 0.0])
LATS = np.array([0.01, 0.004, 0.03])
HS = np.array([500.0, 800.0, 300.0])
PX, PY, PZ = R * LATS * D2R, R * LONS * D2R, -HS


class FakeTessMesh:
    """cells + vector magnetization through the mesh interface."""

    def __init__(self, mag):
        self.props = {"magnetization": mag}
        self.active = np.ones(len(CELLS), bool)

    def cell_bounds(self, only_active=False):
        return CELLS


class FakePrismMesh(FakeTessMesh):
    def cell_bounds(self, only_active=False):
        return PRISM


def test_tf_matches_prism_flat_earth():
    # induced magnetization, oblique regional field
    res_t, k_t = T.tf(LONS, LATS, HS, CELLS, inc=45.0, dec=30.0, pmag=2.0)
    res_p, k_p = P.tf(PX, PY, PZ, PRISM, inc=45.0, dec=30.0, pmag=2.0)
    np.testing.assert_allclose(res_t, res_p, rtol=5e-3)
    np.testing.assert_allclose(k_t, k_p, rtol=5e-3)


def test_b_components_match_prism_flat_earth():
    mag = np.array([[1.0, -0.5, 2.0]])  # one oblique remanent vector
    for tb, pb in ((T.bx, P.bx), (T.by, P.by), (T.bz, P.bz)):
        bt = tb(LONS, LATS, HS, FakeTessMesh(mag))
        bp = pb(PX, PY, PZ, FakePrismMesh(mag))
        np.testing.assert_allclose(bt, bp, rtol=5e-3, atol=1e-4)


def test_tf_vertical_field_equals_bz():
    mag = np.array([[0.0, 0.0, 2.0]])
    res_tf, _ = T.tf(LONS, LATS, HS, FakeTessMesh(mag), inc=90.0, dec=0.0)
    res_bz = T.bz(LONS, LATS, HS, FakeTessMesh(mag))
    np.testing.assert_allclose(res_tf, res_bz, rtol=1e-10)


def test_tf_kernel_is_induced_unit_column():
    _, k = T.tf(LONS, LATS, HS, CELLS, inc=45.0, dec=30.0)
    res_unit, _ = T.tf(LONS, LATS, HS, CELLS, inc=45.0, dec=30.0, pmag=1.0)
    np.testing.assert_allclose(k[:, 0], res_unit, rtol=1e-12)


def test_spherical_magnetic_inversion_end_to_end():
    """A full HMC inversion of tesseroid total-field data — the workflow
    the reference cannot run at all — recovers the magnetized body."""
    import jax.numpy as jnp

    from gravinv3dhmc.inversion import hmc
    from gravinv3dhmc.inversion.potential import GravMagModule

    mrange = (-0.2, 0.2, -0.2, 0.2, 0.0, -6000.0)
    spacing = (-2000.0, 0.05, 0.05)
    mesh = mesher.TesseroidMesh(mrange, spacing)
    nz, ny, nx = mesh.shape
    mag3 = np.zeros(mesh.shape)
    mag3[0:2, 3:6, 3:6] = 2.0  # shallow magnetized block (A/m, induced)
    lons, lats = np.meshgrid(np.linspace(-0.18, 0.18, 8),
                             np.linspace(-0.18, 0.18, 8))
    lons, lats = lons.ravel(), lats.ravel()
    hs = np.full(lons.size, 400.0)
    inc, dec = 55.0, 15.0
    mesh.addprop("magnetization",
                 np.asarray(np.outer(mag3.ravel(),
                                     np.array(P.dircos(inc, dec)))))
    dpre, _ = T.tf(lons, lats, hs, mesh, inc, dec)
    rng = np.random.RandomState(3)
    dobs = dpre + rng.normal(0, 0.02 * np.abs(dpre).max(), dpre.size)

    module = GravMagModule(dobs, mrange, spacing, (lons, lats, hs),
                           coordinate="spherical", field="magnetic",
                           mangle=(inc, dec), verbose=False)
    M = module.n_active

    # bounded-MAP recovery (the production point estimator): the
    # magnetized block comes back sharply
    import jax.numpy as jnp

    from gravinv3dhmc.inversion.reginv import cg_device

    cg = cg_device(module, dobs, (0.0, 3.0), regularization="Damping",
                   maxk=400, dtype=jnp.float64, alpha=0.01)
    m_map = np.asarray(cg["m"], np.float64)
    corr = np.corrcoef(m_map, mag3.ravel())[0, 1]
    # 64 obs over 1280 cells: underdetermined by design; 0.55 is
    # a strong recovery for this geometry (best over the alpha ladder
    # ~0.60)
    assert corr > 0.55, f"bounded-MAP magnetization corr {corr:.3f}"
    r = module.A @ m_map - dpre
    assert np.sqrt(np.mean(r ** 2)) < 0.2 * np.sqrt(np.mean(dpre ** 2))

    # and the HMC sampler runs on the magnetic kernel end to end,
    # improving the data fit from the flat start
    bounds = np.column_stack([np.zeros(M), np.full(M, 3.0)])
    stats = hmc.HMCSample(
        module, 120, 0, 0.02, [3, 8], np.full(M, 0.01),
        np.full(M, 0.01), bounds, "mandatory", 1000.0, dobs,
        RegulFactor=0.1, regularization="Damping", seed=5, Sigma=0.001,
        nchains=4, chunk_size=32, verbose=False, write_files=False)
    chains = np.stack([stats["samples"][c, : int(stats["n_stored"][c])]
                       for c in range(4)])
    mean = chains.mean(axis=(0, 1))
    r_hmc = module.A @ mean - dpre
    r_flat = module.A @ np.full(M, 0.01) - dpre
    assert np.isfinite(chains).all()
    assert (np.sqrt(np.mean(r_hmc ** 2))
            < 0.5 * np.sqrt(np.mean(r_flat ** 2)))


def test_joint_module_spherical():
    """The spherical JOINT inversion — impossible in the reference
    (inversion/potential.py:897 raises) — builds both kernels and its
    potential evaluates."""
    import jax.numpy as jnp

    from gravinv3dhmc.inversion.joint import JointModule

    mrange = (-0.1, 0.1, -0.1, 0.1, 0.0, -6000.0)
    spacing = (-2000.0, 0.05, 0.05)
    lons, lats = np.meshgrid(np.linspace(-0.08, 0.08, 4),
                             np.linspace(-0.08, 0.08, 4))
    lons, lats = lons.ravel(), lats.ravel()
    hs = np.full(lons.size, 400.0)
    rng = np.random.RandomState(1)
    jm = JointModule(rng.normal(0, 5, lons.size),
                     rng.normal(0, 10, lons.size), mrange, spacing,
                     (lons, lats, hs), coordinate="spherical",
                     mangle=(50.0, 10.0), verbose=False)
    M = jm.M
    assert jm.kernel_gz.shape == jm.kernel_tf.shape == (lons.size, M)
    assert np.isfinite(jm.kernel_tf).all()
    w = jm.wdiag
    pot = jm.make_potential(w * np.zeros(2 * M), w * np.full(2 * M, -2.0),
                            w * np.full(2 * M, 2.0), dtype=jnp.float64)
    x = jnp.asarray((w * np.full(2 * M, 0.1))[None, :])
    U, g, _ = pot(x, 1.0)
    assert np.isfinite(float(U[0])) and np.isfinite(np.asarray(g)).all()


def test_gravmag_module_spherical_magnetic():
    """The GravMagModule spherical+magnetic branch (the path the
    reference stubs) builds a kernel, weights it, and its autodiff
    potential runs."""
    import jax.numpy as jnp

    from gravinv3dhmc.inversion.potential import GravMagModule

    mrange = (-0.1, 0.1, -0.1, 0.1, 0.0, -6000.0)
    spacing = (-2000.0, 0.05, 0.05)
    lons, lats = np.meshgrid(np.linspace(-0.08, 0.08, 4),
                             np.linspace(-0.08, 0.08, 4))
    lons, lats = lons.ravel(), lats.ravel()
    hs = np.full(lons.size, 400.0)
    rng = np.random.RandomState(0)
    dobs = rng.normal(0, 5, lons.size)
    module = GravMagModule(dobs, mrange, spacing, (lons, lats, hs),
                           coordinate="spherical", field="magnetic",
                           mangle=(50.0, 10.0), verbose=False)
    M = module.n_active
    assert module.A.shape == (lons.size, M)
    assert np.isfinite(module.Aw).all() and np.abs(module.Aw).max() > 0
    w = module.wdiag
    pot = module.make_potential(w * np.zeros(M), w * np.full(M, -2.0),
                                w * np.full(M, 2.0),
                                regularization="Damping",
                                dtype=jnp.float64)
    x = jnp.asarray((w * np.full(M, 0.1))[None, :])
    U, g, _ = pot(x, 1.0)
    assert np.isfinite(float(U[0])) and np.isfinite(np.asarray(g)).all()
