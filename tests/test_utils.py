"""Foundation-layer tests (grids, units, packing, config)."""
import json

import numpy as np
import pytest

from gravinv3dhmc import constants, utils
from gravinv3dhmc.config import HMCConfig, load_setpmts

from conftest import load_reference_modules

REF = load_reference_modules()


def test_regular_grid_ordering():
    x, y, z = utils.regular((0, 30, 0, 20), (4, 3), z=-5)
    assert x.size == 12
    # x-major: x constant within a row of y values
    np.testing.assert_allclose(x[:3], [0, 0, 0])
    np.testing.assert_allclose(y[:3], [0, 10, 20])
    np.testing.assert_allclose(z, -5 * np.ones(12))


@pytest.mark.skipif(REF is None, reason="reference not importable")
def test_regular_parity():
    ours = utils.regular((0, 100, -50, 50), (7, 9), z=3.0)
    try:
        refs = REF["utils"].regular((0, 100, -50, 50), (7, 9), z=3.0)
    except AttributeError:
        # the reference's regular() mutates a tuple on numpy>=2; compare the
        # z-less variant, which exercises the same ordering logic
        refs = REF["utils"].regular((0, 100, -50, 50), (7, 9))
        ours = ours[:2]
    for a, b in zip(ours, refs):
        np.testing.assert_allclose(a, b)


def test_contaminate_zero_mean_and_seeded():
    data = np.zeros(1000)
    noisy1 = utils.contaminate(data, 0.1, seed=42)
    noisy2 = utils.contaminate(data, 0.1, seed=42)
    np.testing.assert_allclose(noisy1, noisy2)
    assert abs(noisy1.mean()) < 1e-12  # mean removed
    assert 0.05 < noisy1.std() < 0.2


def test_contaminate_percent():
    data = np.ones(100) * 10
    _, std = utils.contaminate(data, 0.05, percent=True, return_stddev=True, seed=0)
    assert std == pytest.approx(0.5)


def test_dircos_ang2vec_roundtrip():
    v = utils.ang2vec(3.0, 45.0, 45.0)
    np.testing.assert_allclose(v, [1.5, 1.5, 3 * np.sin(np.pi / 4)], atol=1e-12)
    intensity, inc, dec = utils.vec2ang(v)
    assert intensity == pytest.approx(3.0)
    assert inc == pytest.approx(45.0)
    assert dec == pytest.approx(45.0)


def test_sph2cart():
    x, y, z = utils.sph2cart(0.0, 0.0, 0.0)
    assert x == pytest.approx(constants.MEAN_EARTH_RADIUS)
    assert y == pytest.approx(0.0)
    assert z == pytest.approx(0.0)


def test_kernel2ubc_ordering():
    # shape (nx, ny, nz) = (2, 1, 3): cells x-fastest z-slowest
    D, nx, ny, nz = 4, 2, 1, 3
    M = nx * ny * nz
    kernel = np.arange(D * M, dtype=float).reshape(D, M)
    ubc = utils.kernel2ubc(kernel, (nx, ny, nz))
    # first UBC column = column of cell (ix=0, iz=0..): order iz-fastest
    np.testing.assert_allclose(ubc[:, 0], kernel[:, 0])
    np.testing.assert_allclose(ubc[:, 1], kernel[:, 2])
    np.testing.assert_allclose(ubc[:, 2], kernel[:, 4])
    np.testing.assert_allclose(ubc[:, 3], kernel[:, 1])


@pytest.mark.skipif(REF is None, reason="reference not importable")
def test_kernel2ubc_parity():
    kernel = np.random.RandomState(1).normal(size=(5, 24))
    shape = (2, 3, 4)  # nx, ny, nz
    np.testing.assert_allclose(
        utils.kernel2ubc(kernel, shape), REF["utils"].kernel2UBC(kernel, shape)
    )


def test_config_reads_reference_setpmts(tmp_path):
    line = json.dumps({
        "set": "model01_singlecube", "test": "T1", "rhomin": 0, "rhomax": 1,
        "mspacing": [100, 100, 100], "Lrange": [5, 20], "delta": 0.01,
        "Sigma": 0.001, "RegulFactor": 1, "regularization": "MS",
        "beta": 0.001, "nsamples": 500,
    })
    p = tmp_path / "SetPMTS.txt"
    p.write_text(line + "\n" + line + "\n")
    configs = load_setpmts(str(p))
    assert len(configs) == 2
    cfg = configs[0]
    assert cfg.set == "model01_singlecube"
    assert cfg.regularization == "MS"
    assert cfg.Lrange == [5, 20]
    assert cfg.delta == 0.01
    assert isinstance(cfg, HMCConfig)


def test_grd_roundtrip(tmp_path):
    data = np.random.RandomState(0).normal(size=(5, 7))
    x = np.linspace(0, 6, 7)
    y = np.linspace(0, 4, 5)
    path = str(tmp_path / "test.grd")
    utils.grdwrite(x, y, data, path)
    grid = utils.grdload(path)
    np.testing.assert_allclose(grid.data, data)
    assert grid.ncol == 7
    assert grid.nrow == 5
    assert grid.xmin == 0
    assert grid.xmax == 6
