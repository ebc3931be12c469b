"""Smoke tests for the visualization layer (reference: vis/mpl.py, vis/myv.py).

Rendering is checked for crash-freedom and basic geometric sanity, not
pixels; figures go to the Agg backend.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest

from gravinv3dhmc import mesher, utils
from gravinv3dhmc.vis import mpl as vmpl
from gravinv3dhmc.vis import myv


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def _flat_grid():
    x, y, z = utils.regular((0, 1000, 0, 2000), (5, 8), z=0.0)
    v = np.sin(x / 300.0) + np.cos(y / 500.0)
    return x, y, v, (5, 8)


def test_contour_contourf_pcolor():
    x, y, v, shape = _flat_grid()
    vmpl.contour(x, y, v, shape, levels=5)
    vmpl.contourf(x, y, v, shape, levels=5)
    vmpl.pcolor(x, y, v, shape)
    vmpl.m2km()


def test_basemap_projections_roundtrip_center():
    # the projection center must map to the origin for every projection
    area = (100, 120, 18, 32)
    for proj in ["merc", "ortho", "stere", "robin", "cyl"]:
        m = vmpl.basemap(area, proj)
        x, y = m(110.0, 25.0)
        assert abs(float(x)) < 1e-6 * m.R
        # merc/robin/cyl y is lat-dependent but small near center
        assert np.isfinite(float(y))
    with pytest.raises(ValueError):
        vmpl.basemap(area, "not-a-projection")


def test_basemap_merc_monotone():
    m = vmpl.basemap((100, 120, 18, 32), "merc")
    lons = np.array([102.0, 108.0, 114.0])
    x, _ = m(lons, np.full(3, 25.0))
    assert np.all(np.diff(x) > 0)
    _, y = m(np.full(3, 110.0), np.array([20.0, 25.0, 30.0]))
    assert np.all(np.diff(y) > 0)


def test_draw_geolines_coastlines_countries():
    area = (100, 130, 5, 45)  # East Asia: coast + borders both present
    m = vmpl.basemap(area, "merc")
    plt.figure()
    vmpl.draw_geolines(area, 5, 5, m)
    n0 = len(plt.gca().lines)
    assert n0 > 0
    vmpl.draw_coastlines(m)  # embedded coarse world set
    n1 = len(plt.gca().lines)
    assert n1 > n0, "draw_coastlines drew nothing"
    vmpl.draw_countries(m)
    assert len(plt.gca().lines) > n1, "draw_countries drew nothing"


def test_coastline_from_topo_grd():
    """Exact regional coastline from a Surfer grid's zero contour; also
    covers the binary DSRB reader (the reference's own realdata grids are
    DSRB, which its DSAA-only loader could not open)."""
    import os
    from gravinv3dhmc.vis.geodata import coastline_from_topo_grd
    grd = "/root/reference/example/realdata/data/topo_12d05d.grd"
    if not os.path.exists(grd):
        pytest.skip("reference realdata grid not present")
    segs = coastline_from_topo_grd(grd)
    assert segs, "no zero-contour segments found"
    allpts = np.vstack(segs)
    # contour vertices stay inside the grid's lon/lat window
    assert allpts[:, 0].min() >= 106.0 and allpts[:, 0].max() <= 119.0
    assert allpts[:, 1].min() >= 15.5 and allpts[:, 1].max() <= 28.5


def _small_mesh():
    mesh = mesher.PrismMesh((0, 400, 0, 400, 0, 200), (100, 100, 100))
    rho = np.zeros(mesh.size)
    rho[::3] = 1.0
    mesh.addprop("density", rho)
    return mesh


def test_myv_prisms_walls_axes():
    mesh = _small_mesh()
    ax = myv.prisms(mesh, threshold=0.5)
    myv.axes(ax)
    myv.outline(ax)
    bounds = (0, 400, 0, 400, 0, 200)
    for wall in (myv.wall_north, myv.wall_south, myv.wall_east,
                 myv.wall_west, myv.wall_top, myv.wall_bottom):
        wall(bounds, ax=ax)
    myv.title("scene", ax=ax)


def test_myv_sphere_scene():
    ax = myv.earth()
    myv.core(ax=ax)
    myv.core(inner=True, ax=ax)
    myv.meridians([0, 90, 180, 270], ax=ax)
    myv.parallels([-45, 0, 45], ax=ax)
    with pytest.warns(UserWarning):
        myv.continents(ax=ax)
    myv.points([(0, 0, 0), (45, 45, 1000.0)], spherical=True, ax=ax)
    myv.colorbar(None, ax=ax)
