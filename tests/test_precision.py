"""The precision of every product with the sensitivity matrix is stated.

Read from the potential's jaxpr (value and gradient, so the transposed
product of the backward pass is covered too): float32 storage multiplies
at HIGHEST, which no backend may lower to TF32 or bf16 passes; bf16
storage multiplies in bf16 and accumulates in float32.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dot_generals(sub)


def _potential_dots(small_module, matvec_dtype):
    module = small_module[0]
    M = module.n_active
    wdiag = module.wdiag
    pot = module.make_potential(wdiag * np.full(M, 0.001),
                                wdiag * np.zeros(M), wdiag * np.ones(M),
                                regularization="MS", beta=0.001,
                                dtype=jnp.float32, matvec_dtype=matvec_dtype)
    x = jnp.asarray(np.tile(wdiag * 0.01, (4, 1)), jnp.float32)
    closed = jax.make_jaxpr(pot.fn)(x, jnp.float32(1.0), pot.params)
    dots = list(_dot_generals(closed.jaxpr))
    # forward product and its transpose in the gradient
    assert len(dots) >= 2
    return dots


def test_float32_products_run_at_highest(small_module):
    for eqn in _potential_dots(small_module, None):
        prec = eqn.params["precision"]
        assert prec is not None, "unstated precision on a product with A"
        assert tuple(prec) == (lax.Precision.HIGHEST,) * 2, prec
        assert all(v.aval.dtype == jnp.float32 for v in eqn.invars)


@pytest.mark.parametrize("matvec_dtype", [jnp.bfloat16])
def test_bf16_storage_accumulates_in_float32(small_module, matvec_dtype):
    dots = _potential_dots(small_module, matvec_dtype)
    for eqn in dots:
        assert eqn.params["preferred_element_type"] == jnp.float32
        assert eqn.outvars[0].aval.dtype == jnp.float32
    # the forward product reads A in bf16
    assert any(v.aval.dtype == jnp.bfloat16 and v.aval.ndim == 2
               for eqn in dots for v in eqn.invars)
