"""Finite-difference regularizer operators.

The reference materialises a sparse 3-D first-difference matrix ``R3d`` from
COO triplets and applies it per misfit evaluation
(reference: inversion/potential.py:266-582). On the accelerator the same operator is
three ``jnp.diff`` calls on the (nz, ny, nx) reshape — fused by XLA into the
surrounding elementwise work, with no sparse storage and autodiff providing
the exact ``2 R^T R`` / TV gradients.

``fd3d_matrix`` keeps the explicit scipy matrix for parity tests and
UBC-style tooling; its row ordering matches the reference exactly
(per-layer x-diffs then y-diffs, then inter-layer z-diffs).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def fd3d_matrix(shape):
    """Sparse first-difference matrix, reference row ordering
    (reference: inversion/potential.py:266-361).

    ``shape = (nz, ny, nx)``; each row is m[i] - m[j] for an adjacent pair.
    """
    nz, ny, nx = shape
    per_layer = (nx - 1) * ny + (ny - 1) * nx
    nderivs = per_layer * nz + nx * ny * (nz - 1)
    rows, cols, vals = [], [], []

    def add(r, c1, c2):
        rows.extend([r, r])
        cols.extend([c1, c2])
        vals.extend([1.0, -1.0])

    for k in range(nz):
        deriv = per_layer * k
        base = nx * ny * k
        # x-direction within each y-row
        p = 0
        for _ in range(ny):
            for _ in range(nx - 1):
                add(deriv, base + p, base + p + 1)
                deriv += 1
                p += 1
            p += 1
        # y-direction
        p = 0
        for _ in range(ny - 1):
            for _ in range(nx):
                add(deriv, base + p, base + p + nx)
                deriv += 1
                p += 1
    front = per_layer * nz
    for k in range(nz - 1):
        base = nx * ny * k
        for p in range(nx * ny):
            add(front + base + p, base + p, base + p + nx * ny)
    return sp.coo_matrix((vals, (rows, cols)),
                         (nderivs, nx * ny * nz)).tocsr()


def grid_diffs(v, shape, xp, active3d=None):
    """First differences of a flat model vector along x, y, z.

    Returns a tuple of three arrays: diffs along x (m[i]-m[i+1] within rows),
    y, and z — together exactly the entries of ``R3d @ v``. When ``active3d``
    (boolean (nz, ny, nx)) is given, differences touching an inactive cell
    are zeroed, extending Smoothness/TV to topography-carved meshes (which
    the reference cannot regularise with fd3d at all).
    """
    nz, ny, nx = shape
    g = xp.reshape(v, (nz, ny, nx))
    dx = g[:, :, :-1] - g[:, :, 1:]
    dy = g[:, :-1, :] - g[:, 1:, :]
    dz = g[:-1, :, :] - g[1:, :, :]
    if active3d is not None:
        ax = active3d[:, :, :-1] & active3d[:, :, 1:]
        ay = active3d[:, :-1, :] & active3d[:, 1:, :]
        az = active3d[:-1, :, :] & active3d[1:, :, :]
        dx = xp.where(ax, dx, 0.0)
        dy = xp.where(ay, dy, 0.0)
        dz = xp.where(az, dz, 0.0)
    return dx, dy, dz


def smoothness_value(v, shape, xp, active3d=None):
    """``||R3d v||^2`` (1st-order Tikhonov, reference:
    inversion/potential.py:786-796) without materialising R3d."""
    dx, dy, dz = grid_diffs(v, shape, xp, active3d)
    return (dx * dx).sum() + (dy * dy).sum() + (dz * dz).sum()


def tv_value(v, shape, beta, xp, active3d=None):
    """Total-variation functional ``sum sqrt((R3d v)^2 + beta)``
    (reference: inversion/potential.py:798-810).

    Note the reference sums sqrt(beta) over *all* rows of R3d, including
    zero differences; preserved here by summing over full diff arrays.
    """
    dx, dy, dz = grid_diffs(v, shape, xp, active3d)
    return (xp.sqrt(dx * dx + beta).sum()
            + xp.sqrt(dy * dy + beta).sum()
            + xp.sqrt(dz * dz + beta).sum())
