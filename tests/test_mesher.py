"""Mesh parity tests: cell bounds must match the reference mesher exactly
for every example configuration (SURVEY.md build order step 2)."""
import numpy as np
import pytest

from gravinv3dhmc import mesher

from conftest import load_reference_modules

REF = load_reference_modules()


def _ref_bounds(ref_mesh):
    out = []
    for cell in ref_mesh:
        if cell is None:
            out.append([np.nan] * 6)
        else:
            out.append(cell.get_bounds())
    return np.array(out)


def _ours_bounds(mesh):
    b = mesh.cell_bounds().copy()
    b[~mesh.active] = np.nan
    return b


@pytest.mark.skipif(REF is None, reason="reference not importable")
class TestParityWithReference:
    def test_uniform_prism_mesh(self):
        bounds = (0, 2000, 0, 3000, 0, 1000)
        spacing = (100, 100, 100)
        ref = REF["mesher"].PrismMesh(bounds, spacing)
        ours = mesher.PrismMesh(bounds, spacing)
        assert ours.shape == ref.shape
        assert ours.size == ref.size
        np.testing.assert_allclose(_ours_bounds(ours), _ref_bounds(ref), rtol=0, atol=1e-9)
        np.testing.assert_allclose(ours.get_xs(), ref.get_xs())
        np.testing.assert_allclose(ours.get_ys(), ref.get_ys())
        np.testing.assert_allclose(ours.get_zs(), ref.get_zs())

    def test_nondivisible_bounds_are_enlarged(self):
        bounds = (0, 1950, 0, 2980, 0, 990)
        spacing = (100, 100, 100)
        ref = REF["mesher"].PrismMesh(bounds, spacing)
        ours = mesher.PrismMesh(bounds, spacing)
        assert ours.shape == ref.shape
        assert ours.bounds == tuple(ref.bounds)
        np.testing.assert_allclose(_ours_bounds(ours), _ref_bounds(ref), atol=1e-9)

    def test_ratio_prism_mesh(self):
        # ratiogrid example: mratio=1.05 (reference example/ratiogrid)
        bounds = (0, 3000, 0, 5700, 0, 2100)
        spacing = (100, 100, 100)
        ref = REF["mesher"].PrismMesh(bounds, spacing, ratio=1.05)
        ours = mesher.PrismMesh(bounds, spacing, ratio=1.05)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(_ours_bounds(ours), _ref_bounds(ref), atol=1e-9)
        np.testing.assert_allclose(ours.get_zs(), ref.get_zs())

    def test_segment_prism_mesh(self):
        # segmentgrid example: dz=[100,200,300], sections [0,300,900,2100]
        bounds = (0, 2000, 0, 3000, 0, 2100)
        spacing = ([100, 200, 300], 100, 100)
        division = [0, 300, 900, 2100]
        ref = REF["mesher"].PrismMeshSegment(bounds, spacing, division)
        ours = mesher.PrismMeshSegment(bounds, spacing, division)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(_ours_bounds(ours), _ref_bounds(ref), atol=1e-9)

    def test_tesseroid_mesh_global(self):
        # global example: 3 deg x 3 deg x 300 km (reference example/global)
        bounds = (-180, 180, -90, 90, 0, -3000000)
        spacing = (-300000, 3, 3)
        ref = REF["mesher"].TesseroidMesh(bounds, spacing)
        ours = mesher.TesseroidMesh(bounds, spacing)
        assert ours.shape == ref.shape
        ref_b = []
        for cell in ref:
            ref_b.append(cell.get_bounds())
        ref_b = np.array(ref_b)  # [w, e, s, n, top, bottom]
        ours_b = ours.cell_bounds()  # [w, e, s, n, ztop, zbot]
        np.testing.assert_allclose(ours_b[:, :4], ref_b[:, :4], atol=1e-9)
        np.testing.assert_allclose(ours_b[:, 4], ref_b[:, 4], atol=1e-6)
        np.testing.assert_allclose(ours_b[:, 5], ref_b[:, 5], atol=1e-6)

    def test_tesseroid_segment_mesh_realdata(self):
        # realdata example: dr=[-1000,-2000,-5000], sections
        # [2000,-5000,-15000,-60000] (reference example/realdata/main_real.py:29)
        bounds = (106, 122, 18, 33, 2000, -60000)
        spacing = ([-1000, -2000, -5000], 0.5, 0.5)
        division = [2000, -5000, -15000, -60000]
        ref = REF["mesher"].TesseroidMeshSegment(bounds, spacing, division)
        ours = mesher.TesseroidMeshSegment(bounds, spacing, division)
        assert ours.shape == ref.shape
        ref_b = np.array([c.get_bounds() for c in ref])
        ours_b = ours.cell_bounds()
        np.testing.assert_allclose(ours_b[:, :4], ref_b[:, :4], atol=1e-9)
        np.testing.assert_allclose(ours_b[:, 4], ref_b[:, 4], atol=1e-6)
        np.testing.assert_allclose(ours_b[:, 5], ref_b[:, 5], atol=1e-6)

    def test_carvetopo_uniform(self):
        bounds = (0, 1000, 0, 1000, -200, 500)
        spacing = (100, 100, 100)
        rng = np.random.RandomState(0)
        tx, ty = np.meshgrid(np.linspace(0, 1000, 15), np.linspace(0, 1000, 15))
        tx, ty = tx.ravel(), ty.ravel()
        th = 100 + 50 * np.sin(tx / 300.0) + rng.normal(0, 5, tx.size)
        ref = REF["mesher"].PrismMesh(bounds, spacing)
        ref_mask = ref.carvetopo(tx, ty, th)
        ours = mesher.PrismMesh(bounds, spacing)
        ours_mask = ours.carvetopo(tx, ty, th)
        assert sorted(ref_mask) == sorted(ours_mask)

    def test_carvetopo_segment_nearest(self):
        bounds = (0, 1000, 0, 1000, -200, 2100)
        spacing = ([100, 200, 300], 100, 100)
        division = [-200, 300, 900, 2100]
        tx, ty = np.meshgrid(np.linspace(0, 1000, 12), np.linspace(0, 1000, 12))
        tx, ty = tx.ravel(), ty.ravel()
        th = 50 + 80 * np.cos(ty / 400.0)
        ref = REF["mesher"].PrismMeshSegment(bounds, spacing, division)
        ref_mask = ref.carvetopo(tx, ty, th)
        ours = mesher.PrismMeshSegment(bounds, spacing, division)
        ours_mask = ours.carvetopo(tx, ty, th)
        assert sorted(ref_mask) == sorted(ours_mask)


class TestMeshBasics:
    def test_ordering_x_fastest(self):
        m = mesher.PrismMesh((0, 200, 0, 300, 0, 100), (100, 100, 100))
        assert m.shape == (1, 3, 2)
        b = m.cell_bounds()
        # index 1 -> x index 1, y index 0
        np.testing.assert_allclose(b[1], [100, 200, 0, 100, 0, 100])
        # index 2 -> x index 0, y index 1
        np.testing.assert_allclose(b[2], [0, 100, 100, 200, 0, 100])

    def test_getitem_matches_cell_bounds(self):
        m = mesher.PrismMesh((0, 500, 0, 400, 0, 300), (100, 100, 100), ratio=1.3)
        b = m.cell_bounds()
        for idx in [0, 7, m.size - 1]:
            np.testing.assert_allclose(m[idx].get_bounds(), b[idx])

    def test_layer_volume_conservation_ratio(self):
        m = mesher.PrismMesh((0, 100, 0, 100, 0, 1000), (50, 50, 50), ratio=1.2)
        assert m.ztop[0] == 0
        assert m.zbot[-1] == 1000
        np.testing.assert_allclose(m.zbot[:-1], m.ztop[1:])

    def test_rho2carve_roundtrip(self):
        from gravinv3dhmc.utils import carve2rho, rho2carve
        rho = np.arange(10.0)
        mask = [2, 5]
        packed = rho2carve(rho, mask)
        assert packed.size == 8
        dense = carve2rho(packed, np.zeros(10), mask)
        expected = rho.copy()
        expected[[2, 5]] = 0
        np.testing.assert_allclose(dense, expected)

    def test_prism_relief_sign_flip(self):
        nodes = (np.array([0.0, 10.0]), np.array([0.0, 10.0]),
                 np.array([-50.0, 50.0]))
        relief = mesher.PrismRelief(0, (10, 10), nodes)
        relief.addprop("density", [100.0, 100.0])
        assert relief.props["density"][0] == 100.0
        assert relief.props["density"][1] == -100.0
