"""Tesseroid forward-operator tests.

Anchors (SURVEY.md §4): the analytic spherical-shell field, Laplace's
equation, native-vs-numpy backend agreement, and the GravMagModule
spherical path.
"""
import numpy as np
import pytest

from gravinv3dhmc import constants, mesher
from gravinv3dhmc.ops import tesseroid as tess

R = constants.MEAN_EARTH_RADIUS


def shell_cells(top=-10e3, bottom=-20e3, dlat=30, dlon=30):
    cells = []
    for s in range(-90, 90, dlat):
        for w in range(-180, 180, dlon):
            cells.append([w, w + dlon, s, s + dlat, top, bottom])
    return np.array(cells, dtype=float)


class TestShellAnalytic:
    def test_gz_matches_shell(self):
        cells = shell_cells()
        h = 260e3
        lon = np.array([12.0])
        lat = np.array([43.0])
        height = np.array([h])
        res, k = tess.gz(lon, lat, height, cells, dens=1.0)
        vol = 4 / 3 * np.pi * ((R - 10e3) ** 3 - (R - 20e3) ** 3)
        analytic = constants.G * constants.SI2MGAL * vol / (R + h) ** 2
        assert res[0] == pytest.approx(analytic, rel=1e-3)
        assert k.sum(axis=1)[0] == pytest.approx(analytic, rel=1e-3)

    def test_potential_matches_shell(self):
        cells = shell_cells()
        h = 500e3
        res, _ = tess.potential(np.array([0.0]), np.array([0.0]),
                                np.array([h]), cells, dens=1.0)
        vol = 4 / 3 * np.pi * ((R - 10e3) ** 3 - (R - 20e3) ** 3)
        analytic = constants.G * vol / (R + h)
        assert res[0] == pytest.approx(analytic, rel=1e-3)

    def test_horizontal_components_vanish_on_shell(self):
        cells = shell_cells()
        for f in (tess.gx, tess.gy):
            res, _ = f(np.array([20.0]), np.array([-35.0]),
                       np.array([3e5]), cells, dens=1.0)
            gz_res, _ = tess.gz(np.array([20.0]), np.array([-35.0]),
                                np.array([3e5]), cells, dens=1.0)
            assert abs(res[0]) < 2e-3 * abs(gz_res[0])

    def test_laplace_tensor_trace(self):
        cells = shell_cells()
        tr = 0.0
        for f in (tess.gxx, tess.gyy, tess.gzz):
            res, _ = f(np.array([12.0]), np.array([43.0]), np.array([2.6e5]),
                       cells, dens=1.0)
            tr += res[0]
        gzz_res, _ = tess.gzz(np.array([12.0]), np.array([43.0]),
                              np.array([2.6e5]), cells, dens=1.0)
        assert abs(tr) < 1e-8 * abs(gzz_res[0])


class TestBackends:
    def test_native_matches_numpy(self):
        cells = np.array([[0, 2, 0, 2, -1000, -5000],
                          [10, 12, 40, 42, 0, -3000],
                          [-30, -28, -10, -8, 500, -10000]], dtype=float)
        lon = np.array([1.0, 11.0, 45.0, -29.0])
        lat = np.array([1.0, 41.0, -20.0, -9.0])
        h = np.array([5e4, 1e4, 2e5, 8e3])
        for field in ("potential", "gx", "gy", "gz", "gxx", "gxy", "gxz",
                      "gyy", "gyz", "gzz"):
            kn = tess.tesseroid_kernel_matrix(field, lon, lat, h, cells,
                                              backend="numpy")
            try:
                kc = tess.tesseroid_kernel_matrix(field, lon, lat, h, cells,
                                                  backend="native")
            except Exception:
                pytest.skip("native tessglq unavailable")
            denom = np.abs(kn).max()
            # identical leaves, different summation order: f64 round-off
            assert np.abs(kc - kn).max() < 1e-6 * denom

    def test_degenerate_cells_warn_and_skip(self):
        cells = np.array([[0, 2, 0, 2, -1000, -5000],
                          [5, 5 + 1e-8, 0, 2, -1000, -5000]], dtype=float)
        with pytest.warns(RuntimeWarning):
            k = tess.tesseroid_kernel_matrix(
                "gz", np.array([1.0]), np.array([1.0]), np.array([1e4]),
                cells, backend="numpy")
        assert k.shape == (1, 1)


class TestSphericalModule:
    def test_gravmag_module_spherical(self):
        import jax.numpy as jnp
        from gravinv3dhmc.inversion.potential import GravMagModule
        # small global-style mesh
        bounds = (-180, 180, -90, 90, 0, -600000)
        spacing = (-300000, 30, 30)
        mesh = mesher.TesseroidMesh(bounds, spacing)
        rho = np.zeros(mesh.size)
        rho[::7] = 0.3
        mesh.addprop("density", rho)
        lon, lat = np.meshgrid(np.linspace(-150, 150, 6),
                               np.linspace(-60, 60, 6))
        lon, lat = lon.ravel(), lat.ravel()
        height = np.full(lon.size, 260e3)
        dobs, _ = tess.gz(lon, lat, height, mesh)
        module = GravMagModule(dobs, bounds, spacing, (lon, lat, height),
                               coordinate="spherical", field="gravity",
                               dtype=jnp.float64, verbose=False)
        assert module.A.shape == (36, mesh.size)
        # forward through the module kernel reproduces dobs
        np.testing.assert_allclose(module.A @ rho, dobs, rtol=1e-10)


class TestReferenceEngineParity:
    """Engine-vs-engine parity against the reference's numba engine
    (reference: gravmag/_tesseroid_numba.py), run as pure Python via a
    numba stub (VERDICT round-1 item 7). Closes the cross-check loop the
    prism side cannot (its native backend is a py37-only .so)."""

    @staticmethod
    def _load_reference_engine():
        import importlib.util
        import sys
        import types

        path = "/root/reference/gravmag/_tesseroid_numba.py"
        import os
        if not os.path.exists(path):
            return None
        if "numba" not in sys.modules:
            stub = types.ModuleType("numba")

            def _jit(*a, **k):
                def deco(f):
                    return f
                return deco

            stub.jit = _jit
            sys.modules["numba"] = stub
        if "/root/reference" not in sys.path:
            sys.path.insert(0, "/root/reference")
        try:
            spec = importlib.util.spec_from_file_location(
                "_ref_tesseroid_numba", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
        except Exception:
            return None

    @pytest.mark.parametrize("field", ["gz", "potential", "gzz"])
    def test_kernel2d_matches_reference_engine(self, field):
        ref = self._load_reference_engine()
        if ref is None:
            pytest.skip("reference numba engine not importable")
        # a small spherical patch whose geometry forces real subdivision
        cells = np.array([
            [0, 20, -10, 10, -5e3, -40e3],
            [20, 40, -10, 10, -5e3, -40e3],
            [0, 20, 10, 30, -5e3, -40e3],
            [20, 40, 10, 30, -5e3, -40e3],
        ], dtype=float)
        lon = np.array([10.0, 25.0, 40.0])
        lat = np.array([0.0, 15.0, 25.0])
        height = np.array([150e3, 260e3, 500e3])
        ratio = {"gz": tess.RATIO_G, "potential": tess.RATIO_V,
                 "gzz": tess.RATIO_GG}[field]

        # ---- reference engine (per-cell adaptive stack, LIFO order) ----
        lon_r = np.radians(lon)
        sinlat = np.sin(np.radians(lat))
        coslat = np.cos(np.radians(lat))
        radius = tess.MEAN_EARTH_RADIUS + height
        stack = np.empty((100, 6))
        lonc = np.empty(2)
        sinlatc = np.empty(2)
        coslatc = np.empty(2)
        rc = np.empty(2)
        result = np.zeros(lon.size)
        k_ref = np.zeros((lon.size, cells.shape[0]))
        engine = getattr(ref, field)
        for tessnum in range(cells.shape[0]):
            err = engine(lon_r, sinlat, coslat, radius, cells[tessnum],
                         1.0, ratio, stack, lonc, sinlatc, coslatc, rc,
                         result, k_ref, tessnum)
            assert err == 0

        # ---- this repo's engines -------------------------------------
        scale = tess._SCALES[field]
        k_np = tess.tesseroid_kernel_matrix(
            field, lon, lat, height, cells, backend="numpy") / scale
        np.testing.assert_allclose(k_np, k_ref, rtol=1e-12, atol=1e-300)
        try:
            k_cpp = tess.tesseroid_kernel_matrix(
                field, lon, lat, height, cells, backend="native") / scale
        except Exception:
            k_cpp = None  # no toolchain — numpy parity already proven
        if k_cpp is not None:
            np.testing.assert_allclose(k_cpp, k_ref, rtol=1e-12,
                                       atol=1e-300)


def test_device_kernel_matches_host():
    """The device-side far-field + host near-field kernel builder
    (ops/tesseroid.tesseroid_kernel_device) reproduces the host adaptive
    engine to f32 rounding — both with cached-kernel corrections and with
    engine-computed corrections (the link-safe global path)."""
    import jax.numpy as jnp
    from gravinv3dhmc.ops import tesseroid as tess

    cells = np.array([
        [-10.0, 10.0, -10.0, 10.0, 0.0, -5e4],
        [10.0, 30.0, -10.0, 10.0, 0.0, -5e4],
        [150.0, 170.0, 40.0, 60.0, -5e4, -1e5],
    ])
    lons, lats = np.meshgrid(np.linspace(-30, 40, 6),
                             np.linspace(-25, 25, 5))
    lons, lats = lons.ravel(), lats.ravel()
    heights = np.full(lons.size, 5e3)

    k_host = tess.tesseroid_kernel_matrix("gz", lons, lats, heights, cells)
    scale = np.abs(k_host).max()
    for kwargs in (dict(host_kernel=k_host), dict()):
        k_dev, (oi, ci) = tess.tesseroid_kernel_device(
            "gz", lons, lats, heights, cells, obs_block=7, **kwargs)
        assert k_dev.dtype == jnp.float32
        assert oi.size > 0  # the near cells must need subdivision
        err = np.abs(np.asarray(k_dev, np.float64) - k_host).max() / scale
        assert err < 1e-5, err
    # winv folding
    winv = np.linspace(0.5, 2.0, cells.shape[0])
    k_w, _ = tess.tesseroid_kernel_device(
        "gz", lons, lats, heights, cells, host_kernel=k_host, winv=winv)
    err = np.abs(np.asarray(k_w, np.float64) - k_host * winv).max() / scale
    assert err < 1e-5, err


def test_subdivision_mask_backends_and_pair_engines_agree():
    """The device-side f32 pair test must select the same near-field set
    as the host f64 broadcast, and both pair-subset engines (native C++,
    vectorised numpy worklist) must reproduce the full-matrix entries."""
    from gravinv3dhmc.ops import tesseroid as tess

    cells = np.array([[w, w + 3.0, -1.5, 1.5, -3e5, -6e5]
                      for w in range(-180, 180, 3)], np.float64)
    lons = np.linspace(-180, 177.0, 120)
    lats = np.full(lons.size, 0.5)
    h = np.full(lons.size, 5e3)
    kh = tess.tesseroid_kernel_matrix("gz", lons, lats, h, cells)
    oi, ci = tess.subdivision_mask(lons, lats, h, cells, 1.6,
                                   backend="host")
    oi_d, ci_d = tess.subdivision_mask(lons, lats, h, cells, 1.6,
                                       backend="device")
    assert set(zip(oi.tolist(), ci.tolist())) == set(
        zip(oi_d.tolist(), ci_d.tolist()))
    # the native C++ two-pass mask must match the host f64 test EXACTLY
    # (same math, same ordering — obs-major); skip if no toolchain
    try:
        oi_n, ci_n = tess.subdivision_mask(lons, lats, h, cells, 1.6,
                                           backend="native")
    except Exception:
        oi_n = None
    if oi_n is not None:
        assert np.array_equal(oi, oi_n) and np.array_equal(ci, ci_n)
    want = kh[oi, ci]
    scale = np.abs(kh).max()
    # bulk pair values (native engine if the toolchain built, else the
    # numpy worklist — exercise whichever the install resolves to)
    got = tess._nearfield_pair_values("gz", lons, lats, h, oi, ci, cells,
                                      1.6) * tess._SCALES["gz"]
    assert np.abs(got - want).max() / scale < 1e-12
    # and the numpy worklist explicitly (the no-toolchain fallback)
    lon_rr = np.radians(lons)
    sinla, cosla = np.sin(np.radians(lats)), np.cos(np.radians(lats))
    rad = tess.MEAN_EARTH_RADIUS + h
    p_obs, p_slot, leaf_b = tess.adaptive_leaves(
        lon_rr, sinla, cosla, rad, cells[ci], 1.6,
        pairs=(oi, np.arange(oi.size)))
    lc, slc, clc, rcn, sc = tess._glq_nodes(leaf_b, np)
    v = sc * tess._NP_KERNELS["gz"](lon_rr[p_obs], sinla[p_obs],
                                    cosla[p_obs], rad[p_obs],
                                    lc, slc, clc, rcn)
    out = np.zeros(oi.size)
    np.add.at(out, p_slot, v)
    assert np.abs(out * tess._SCALES["gz"] - want).max() / scale < 1e-12


def test_device_kernel_per_entry_accuracy_midrange():
    """PER-ENTRY relative accuracy of the f32 device far-field evaluation
    for mid-range pairs (just outside the near-field mask) — the regime
    where the classic l_sqr form cancels catastrophically in f32. The
    stable haversine form must hold every entry to ~1e-5 relative, not
    just relative to the matrix max."""
    from gravinv3dhmc.ops import tesseroid as tess

    # global-case geometry: 3-degree tesseroid ring at depth — the mask
    # boundary sits at ~530 km where f32 l_sqr loses ~1e-4 classically
    cells = np.array([[w, w + 3.0, -1.5, 1.5, -3e5, -6e5]
                      for w in range(-180, 180, 3)], np.float64)
    lons = np.linspace(-180, 177.0, 120)
    lats = np.full(lons.size, 0.5)
    heights = np.full(lons.size, 5e3)
    k_host = tess.tesseroid_kernel_matrix("gz", lons, lats, heights, cells)
    k_dev, (oi, ci) = tess.tesseroid_kernel_device(
        "gz", lons, lats, heights, cells, host_kernel=k_host, obs_block=16)
    k_dev = np.asarray(k_dev, np.float64)
    # exclude the host-corrected near-field entries: they are exact
    far = np.ones_like(k_host, bool)
    far[oi, ci] = False
    rel = np.abs(k_dev - k_host)[far] / np.abs(k_host)[far]
    assert rel.max() < 1e-5, rel.max()  # classic l_sqr form: 1.1e-5 here
