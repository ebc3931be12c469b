"""Tests that need the card. Each decides in its body whether JAX's
device is a GPU and skips otherwise; ``python chip_smoke.py`` runs them
on the GPU in its own process."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gravinv3dhmc import reference

pytestmark = pytest.mark.gpu


def _require_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


def test_potential_at_stated_precision_on_gpu(small_module):
    """float32 storage at HIGHEST: U and its gradient agree with the
    float64 reference evaluated from the same float32-rounded inputs."""
    _require_gpu()
    module = small_module[0]
    M = module.n_active
    wdiag = module.wdiag
    pot = module.make_potential(wdiag * np.full(M, 0.001),
                                wdiag * np.zeros(M), wdiag * np.ones(M),
                                regularization="MS", beta=0.001,
                                dtype=jnp.float32)
    P = {k: np.asarray(v, np.float64) for k, v in pot.params.items()
         if v is not None}
    x = jnp.asarray(wdiag * np.random.RandomState(0).uniform(size=(32, M)),
                    jnp.float32)
    U, g, _ = pot(x, 1.0)
    Ur, gr, _, _ = reference.potential(P["Aw"], np.asarray(x, np.float64),
                                       P["dobs_centered"], P["aprior_mw"],
                                       P["wm_sq"], 1.0, "MS", 0.001)
    assert np.max(np.abs(np.asarray(U) - Ur) / np.abs(Ur)) <= 1e-5
    assert (np.max(np.abs(np.asarray(g) - gr))
            <= 1e-4 * np.max(np.abs(gr)))


@pytest.mark.parametrize("regularization", ["MS", "Damping"])
def test_shared_L_chunk_matches_reference_on_gpu(small_module,
                                                 regularization):
    """The float64 shared-L chunk on the card replays the NumPy leapfrog
    to rounding, Metropolis decisions included."""
    _require_gpu()
    from test_hmc_reference import _run_both

    carry, stats, xr, Ur, acc = _run_both(small_module, regularization,
                                          dt=0.01, nchains=8, chunk_size=6,
                                          x_scale=0.5)
    np.testing.assert_array_equal(stats[..., 0] > 0.5, acc)
    np.testing.assert_allclose(np.asarray(carry[0]), xr, rtol=0,
                               atol=1e-9 * np.abs(xr).max())
    np.testing.assert_allclose(np.asarray(carry[1]), Ur, rtol=1e-9)
