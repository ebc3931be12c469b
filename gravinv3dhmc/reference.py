"""Plain float64 NumPy references for the sampler's hot path.

Independent of the JAX code under test, these are what tests and the GPU
smoke run compare the device path with:

* :func:`potential` — the MS/Damping potential of
  :meth:`GravMagModule.make_potential` ('mandatory' constraint) with its
  analytic gradient (reference: inversion/potential.py:688-810);
* :func:`hmc_iteration` — one shared-L HMC iteration with the
  'mandatory' boundary (reference: inversion/hmc.py:95-155), driven by
  random draws supplied by the caller, so that a test can replay the
  device sampler's own stream.
"""
from __future__ import annotations

import numpy as np


def potential(A, x, dobs_centered, aprior, wm_sq, alpha,
              regularization="MS", beta=0.001):
    """``(U, grad, U_data, U_model)`` for a chain batch ``x`` (C, M).

    ``U = |(A x - mean(A x)) - dobs_centered|^2 + alpha * U_model`` with
    ``U_model = sum(wm_sq * dm^2 / (dm^2 + beta))`` (MS) or
    ``sum(dm^2)`` (Damping), ``dm = x - aprior``.
    """
    A = np.asarray(A, np.float64)
    x = np.atleast_2d(np.asarray(x, np.float64))
    dpre = x @ A.T
    r = dpre - dpre.mean(axis=1, keepdims=True) - np.asarray(
        dobs_centered, np.float64)
    u_data = np.sum(r * r, axis=1)
    dm = x - np.asarray(aprior, np.float64)
    if regularization == "MS":
        wm_sq = np.asarray(wm_sq, np.float64)
        dm2 = dm * dm
        u_model = np.sum(wm_sq * dm2 / (dm2 + beta), axis=1)
        g_model = wm_sq * 2.0 * dm * beta / (dm2 + beta) ** 2
    elif regularization == "Damping":
        u_model = np.sum(dm * dm, axis=1)
        g_model = 2.0 * dm
    else:
        raise ValueError(f"no reference for {regularization!r}")
    # d|P r|^2 / d(A x) = 2 P r, with P the centring projector
    g_data = 2.0 * (r - r.mean(axis=1, keepdims=True)) @ A
    return (u_data + alpha * u_model, g_data + alpha * g_model,
            u_data, u_model)


def hmc_iteration(pot, x, U, g, p0, L, dt, u, low, high, inv_mass=None):
    """One shared-L leapfrog iteration with Metropolis accept.

    ``pot(x) -> (U, grad)``; ``p0`` is the refreshed momentum
    (``Sigma * N(0, 1)`` under the reference's identity kinetic,
    ``N(0, 1) / sqrt(inv_mass)`` under a diagonal metric); ``u`` the (C,)
    uniforms of the accept test. Returns ``(x, U, g, accept)`` after the
    accept/reject select.
    """
    def kinetic(p):
        if inv_mass is None:
            return 0.5 * np.sum(p * p, axis=-1)
        return 0.5 * np.sum(inv_mass * p * p, axis=-1)

    H0 = kinetic(p0) + U
    p = p0 - 0.5 * dt * g
    xn, Un, gn = x, U, g
    for _ in range(int(L)):
        xn = xn + dt * (p if inv_mass is None else inv_mass * p)
        hit = (xn > high) | (xn < low)
        xn = np.clip(xn, low, high)
        p = np.where(hit, -p, p)
        Un, gn = pot(xn)
        p = p - dt * gn
    p = p + 0.5 * dt * gn
    H = kinetic(p) + Un
    accept = (H < H0) | (u < np.exp(-(H - H0)))
    acc = accept[:, None]
    return (np.where(acc, xn, x), np.where(accept, Un, U),
            np.where(acc, gn, g), accept)
