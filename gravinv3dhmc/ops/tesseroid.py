"""Tesseroid (spherical prism) forward operators, Uieda et al. (2016).

Accelerator re-design of the reference's per-point numba stack recursion
(reference: gravmag/_tesseroid_numba.py:32-71): the adaptive subdivision
depends only on geometry, so it is resolved on the host as a *vectorised
worklist expansion* — every (observation, cell) pair that fails the
``distance > ratio * size`` test is split into 2/4/8 children in bulk numpy
operations, exactly reproducing the reference's stack algorithm (same
distance measure, same per-axis decisions, same minimum-size guards,
reference: gravmag/_tesseroid_numba.py:94-157) — and the resulting flat
list of quadrature leaves is evaluated on the device as one batched
2x2x2-node Gauss-Legendre pass with static shapes, then segment-summed
into the dense kernel matrix.

This keeps the data-dependent recursion off the accelerator (SURVEY.md §7
"hard parts") while making the numerical result identical to the
reference's engine up to summation order.

Field scalings match the reference exactly, including its Gs-vs-G quirk on
``gy`` (reference: gravmag/tesseroid.py:402-417).
"""
from __future__ import annotations

import os
import warnings

import numpy as np

from .. import constants
from ..constants import MEAN_EARTH_RADIUS

# accuracy ratios (reference: gravmag/tesseroid.py:76-79)
RATIO_V = 1
RATIO_G = 1.6
RATIO_GG = 8
STACK_SIZE = 100
#: maximum host expansion rounds (a stack depth equivalent)
MAX_DEPTH = 40

NODES = np.array([-0.577350269189625731058868041146,
                  0.577350269189625731058868041146])

D2R = np.pi / 180.0


# --------------------------------------------------------------------------
# host-side adaptive subdivision (vectorised reference algorithm)
# --------------------------------------------------------------------------

def _distance_size(lon, coslat, sinlat, radius, b):
    """Distance obs->cell centre and cell dimensions in metres
    (reference: gravmag/_tesseroid_numba.py:94-111).

    ``b`` is an (N, 6) bounds array [w, e, s, n, top, bottom] (degrees/m);
    obs arrays are per-pair (radians / sin / cos / m).
    """
    w, e, s, n, top, bottom = (b[:, i] for i in range(6))
    rt = 0.5 * (top + bottom) + MEAN_EARTH_RADIUS
    lont = D2R * 0.5 * (w + e)
    latt = D2R * 0.5 * (s + n)
    sinlatt = np.sin(latt)
    coslatt = np.cos(latt)
    cospsi = sinlat * sinlatt + coslat * coslatt * np.cos(lon - lont)
    distance = np.sqrt(radius ** 2 + rt ** 2 - 2 * radius * rt * cospsi)
    rtop = top + MEAN_EARTH_RADIUS
    Llon = rtop * np.arccos(
        np.clip(sinlatt ** 2 + coslatt ** 2 * np.cos(D2R * (e - w)), -1, 1))
    Llat = rtop * np.arccos(
        np.clip(np.sin(D2R * n) * np.sin(D2R * s)
                + np.cos(D2R * n) * np.cos(D2R * s), -1, 1))
    Lr = top - bottom
    return distance, Llon, Llat, Lr


def _split_axis_counts(distance, Llon, Llat, Lr, ratio):
    """Per-axis 1-or-2 split decision with minimum-size guards
    (reference: gravmag/_tesseroid_numba.py:135-157)."""
    nlon = np.where((distance <= ratio * Llon) & (Llon > 0.1), 2, 1)
    nlat = np.where((distance <= ratio * Llat) & (Llat > 0.1), 2, 1)
    nr = np.where((distance <= ratio * Lr) & (Lr > 1e3), 2, 1)
    undersized = (((distance <= ratio * Llon) & (Llon <= 0.1))
                  | ((distance <= ratio * Llat) & (Llat <= 0.1))
                  | ((distance <= ratio * Lr) & (Lr <= 1e3)))
    return nlon, nlat, nr, undersized


def _expand(b, nlon, nlat, nr):
    """Split each bounds row into its children (vectorised
    reference split(), gravmag/_tesseroid_numba.py:114-132)."""
    out = []
    w, e, s, n, top, bottom = (b[:, i] for i in range(6))
    dlon = (e - w) / nlon
    dlat = (n - s) / nlat
    dr = (top - bottom) / nr
    # children per row: nlon*nlat*nr in {2,4,8}; group rows by pattern
    for pat_lon in (1, 2):
        for pat_lat in (1, 2):
            for pat_r in (1, 2):
                sel = (nlon == pat_lon) & (nlat == pat_lat) & (nr == pat_r)
                if pat_lon * pat_lat * pat_r == 1 or not sel.any():
                    continue
                idx = np.flatnonzero(sel)
                for i in range(pat_lon):
                    for j in range(pat_lat):
                        for k in range(pat_r):
                            child = np.empty((idx.size, 6))
                            child[:, 0] = w[idx] + i * dlon[idx]
                            child[:, 1] = w[idx] + (i + 1) * dlon[idx]
                            child[:, 2] = s[idx] + j * dlat[idx]
                            child[:, 3] = s[idx] + (j + 1) * dlat[idx]
                            child[:, 4] = bottom[idx] + (k + 1) * dr[idx]
                            child[:, 5] = bottom[idx] + k * dr[idx]
                            out.append((idx, child))
    return out


def adaptive_leaves(lon_r, sinlat, coslat, radius, cells, ratio,
                    max_depth=MAX_DEPTH, pairs=None):
    """Resolve the adaptive subdivision for a block of observation points.

    Returns (pair_obs, pair_cell, leaf_bounds): flat arrays where each leaf
    is a (obs index within block, cell index, 6 bounds) quadrature task.

    ``pairs=(obs_idx, cell_idx)`` restricts the worklist to an explicit
    pair subset instead of the full (obs x cell) cross product — the
    near-field correction path of the device kernel builder.
    """
    n_obs = lon_r.size
    n_cells = cells.shape[0]
    if pairs is not None:
        obs_idx = np.asarray(pairs[0], dtype=np.int64)
        cell_idx = np.asarray(pairs[1], dtype=np.int64)
        bounds = np.asarray(cells, np.float64)[cell_idx]
    else:
        # initial worklist: the full (obs x cell) cross product
        obs_idx = np.repeat(np.arange(n_obs), n_cells)
        cell_idx = np.tile(np.arange(n_cells), n_obs)
        bounds = np.tile(cells, (n_obs, 1))

    leaves_obs, leaves_cell, leaves_b = [], [], []
    warned = False
    for _ in range(max_depth):
        if obs_idx.size == 0:
            break
        d, Llon, Llat, Lr = _distance_size(
            lon_r[obs_idx], coslat[obs_idx], sinlat[obs_idx],
            radius[obs_idx], bounds)
        nlon, nlat, nr, undersized = _split_axis_counts(d, Llon, Llat, Lr,
                                                        ratio)
        if undersized.any() and not warned:
            warnings.warn(
                "Stopped dividing a tesseroid because it's dimensions would "
                "be below the minimum numerical threshold (1e-6 degrees or "
                "1e-3 m). Will compute without division. Cannot guarantee "
                "the accuracy of the solution.", RuntimeWarning)
            warned = True
        total = nlon * nlat * nr
        done = total == 1
        leaves_obs.append(obs_idx[done])
        leaves_cell.append(cell_idx[done])
        leaves_b.append(bounds[done])
        todo = ~done
        if not todo.any():
            obs_idx = obs_idx[:0]
            break
        groups = _expand(bounds[todo], nlon[todo], nlat[todo], nr[todo])
        t_obs = obs_idx[todo]
        t_cell = cell_idx[todo]
        obs_parts, cell_parts, b_parts = [], [], []
        for idx, child in groups:
            obs_parts.append(t_obs[idx])
            cell_parts.append(t_cell[idx])
            b_parts.append(child)
        obs_idx = np.concatenate(obs_parts)
        cell_idx = np.concatenate(cell_parts)
        bounds = np.concatenate(b_parts)
    else:
        if obs_idx.size:
            # treat whatever is left as leaves (stack-overflow analogue;
            # the reference raises OverflowError at STACK_SIZE instead)
            leaves_obs.append(obs_idx)
            leaves_cell.append(cell_idx)
            leaves_b.append(bounds)
    return (np.concatenate(leaves_obs), np.concatenate(leaves_cell),
            np.concatenate(leaves_b))


# --------------------------------------------------------------------------
# GLQ point kernels (reference: gravmag/_tesseroid_numba.py:160-328)
# evaluated over flat leaf arrays; xp is numpy or jax.numpy
# --------------------------------------------------------------------------

def _glq_nodes(b, xp):
    """Scaled 2-node GLQ abscissas per leaf
    (reference: gravmag/_tesseroid_numba.py:75-91).

    Returns (lonc, sinlatc, coslatc, rc) with shape (N, 2) and the (N,)
    volume scale.
    """
    w, e, s, n, top, bottom = (b[:, i] for i in range(6))
    nodes = xp.asarray(NODES, dtype=b.dtype)
    dlon = D2R * (e - w)
    dlat = D2R * (n - s)
    dr = top - bottom
    lonc = 0.5 * dlon[:, None] * nodes[None, :] + D2R * 0.5 * (e + w)[:, None]
    latc = 0.5 * dlat[:, None] * nodes[None, :] + D2R * 0.5 * (n + s)[:, None]
    sinlatc = xp.sin(latc)
    coslatc = xp.cos(latc)
    rc = (0.5 * dr[:, None] * nodes[None, :]
          + 0.5 * (top + bottom)[:, None] + MEAN_EARTH_RADIUS)
    scale = dlon * dlat * dr * 0.125
    return lonc, sinlatc, coslatc, rc, scale


def _pair_terms(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp):
    """Common per-(i,j,k) quantities for all kernels, vectorised over the
    2x2x2 node grid: returns arrays of shape (N, 2, 2, 2)."""
    coslon = xp.cos(lon[:, None] - lonc)            # (N, 2): i
    sinlon = xp.sin(lonc - lon[:, None])            # (N, 2): i
    # cospsi, kphi over (i, j)
    cospsi = (sinlat[:, None, None] * sinlatc[:, None, :]
              + coslat[:, None, None] * coslatc[:, None, :]
              * coslon[:, :, None])                 # (N, i, j)
    kphi = (coslat[:, None, None] * sinlatc[:, None, :]
            - sinlat[:, None, None] * coslatc[:, None, :]
            * coslon[:, :, None])                   # (N, i, j)
    rc_k = rc[:, None, None, :]                     # (N, 1, 1, k)
    l_sqr = (radius[:, None, None, None] ** 2 + rc_k ** 2
             - 2 * radius[:, None, None, None] * rc_k
             * cospsi[:, :, :, None])               # (N, i, j, k)
    kappa = (rc_k ** 2) * coslatc[:, None, :, None]  # (N, 1, j, k)
    return coslon, sinlon, cospsi, kphi, rc_k, l_sqr, kappa


def _pair_terms_stable(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc,
                       rc, xp):
    """Cancellation-free variant of :func:`_pair_terms` for float32 device
    evaluation.

    The classic ``l_sqr = radius^2 + rc^2 - 2 radius rc cospsi`` cancels
    catastrophically at Earth-radius magnitude (~4e13) in f32 for pairs
    just outside the near-field mask (per-entry rel err up to ~1e-4).
    Rearranged as ``(radius - rc)^2 + 4 radius rc hav(psi)`` with the
    haversine ``hav = sin^2(dlat/2) + coslat coslatc sin^2(dlon/2)``:
    both terms are computed from SMALL differences, no large-square
    subtraction anywhere.
    """
    dlon = lon[:, None] - lonc
    coslon = xp.cos(dlon)                           # (N, 2): i
    sinlon = xp.sin(lonc - lon[:, None])            # (N, 2): i
    lat = xp.arctan2(sinlat, coslat)                # (N,)
    latc = xp.arctan2(sinlatc, coslatc)             # (N, 2): j
    sin_hlat = xp.sin(0.5 * (lat[:, None] - latc))  # (N, j)
    sin_hlon = xp.sin(0.5 * dlon)                   # (N, i)
    hav = ((sin_hlat ** 2)[:, None, :]
           + coslat[:, None, None] * coslatc[:, None, :]
           * (sin_hlon ** 2)[:, :, None])           # (N, i, j)
    cospsi = 1.0 - 2.0 * hav
    kphi = (coslat[:, None, None] * sinlatc[:, None, :]
            - sinlat[:, None, None] * coslatc[:, None, :]
            * coslon[:, :, None])                   # (N, i, j)
    rc_k = rc[:, None, None, :]                     # (N, 1, 1, k)
    # radial separation from small height differences: radius = R + h_obs
    # and rc = R + h_node, so (radius - rc) = h_obs - h_node exactly
    dr = (radius - MEAN_EARTH_RADIUS)[:, None, None, None] \
        - (rc_k - MEAN_EARTH_RADIUS)
    l_sqr = dr * dr + 4.0 * radius[:, None, None, None] * rc_k \
        * hav[:, :, :, None]                        # (N, i, j, k)
    kappa = (rc_k ** 2) * coslatc[:, None, :, None]  # (N, 1, j, k)
    return coslon, sinlon, cospsi, kphi, rc_k, l_sqr, kappa


def _sum_ijk(x, xp):
    return xp.sum(x, axis=(1, 2, 3))


def _make_kernels(xp, pair_terms=None):
    pair_terms = _pair_terms if pair_terms is None else pair_terms
    def kernelV(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, _, _, _, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        return _sum_ijk(kappa / xp.sqrt(l_sqr), xp)

    def kernelx(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, _, kphi, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        return _sum_ijk(kappa * rc_k * kphi[:, :, :, None] / l_sqr ** 1.5, xp)

    def kernely(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, sinlon, _, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltay = rc_k * coslatc[:, None, :, None] * sinlon[:, :, None, None]
        return _sum_ijk(kappa * deltay / l_sqr ** 1.5, xp)

    def kernelz(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, cospsi, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltaz = rc_k * cospsi[:, :, :, None] - radius[:, None, None, None]
        # sign flip so gz is z-down positive (reference:
        # gravmag/_tesseroid_numba.py:219-223)
        return -_sum_ijk(kappa * deltaz / l_sqr ** 1.5, xp)

    def kernelxx(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, _, kphi, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        num = 3 * (rc_k * kphi[:, :, :, None]) ** 2 - l_sqr
        return _sum_ijk(kappa * num / l_sqr ** 2.5, xp)

    def kernelxy(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, sinlon, _, kphi, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        num = (3 * rc_k ** 2 * kphi[:, :, :, None]
               * coslatc[:, None, :, None] * sinlon[:, :, None, None])
        return _sum_ijk(kappa * num / l_sqr ** 2.5, xp)

    def kernelxz(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, cospsi, kphi, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltaz = rc_k * cospsi[:, :, :, None] - radius[:, None, None, None]
        num = 3 * rc_k * kphi[:, :, :, None] * deltaz
        return _sum_ijk(kappa * num / l_sqr ** 2.5, xp)

    def kernelyy(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, sinlon, _, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltay = rc_k * coslatc[:, None, :, None] * sinlon[:, :, None, None]
        return _sum_ijk(kappa * (3 * deltay ** 2 - l_sqr) / l_sqr ** 2.5, xp)

    def kernelyz(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, sinlon, cospsi, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltay = rc_k * coslatc[:, None, :, None] * sinlon[:, :, None, None]
        deltaz = rc_k * cospsi[:, :, :, None] - radius[:, None, None, None]
        return _sum_ijk(kappa * 3.0 * deltay * deltaz / l_sqr ** 2.5, xp)

    def kernelzz(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, cospsi, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltaz = rc_k * cospsi[:, :, :, None] - radius[:, None, None, None]
        return _sum_ijk(kappa * (3 * deltaz ** 2 - l_sqr) / l_sqr ** 2.5, xp)

    return {
        "potential": kernelV, "gx": kernelx, "gy": kernely, "gz": kernelz,
        "gxx": kernelxx, "gxy": kernelxy, "gxz": kernelxz,
        "gyy": kernelyy, "gyz": kernelyz, "gzz": kernelzz,
    }


_NP_KERNELS = _make_kernels(np)

_RATIOS = {
    "potential": RATIO_V, "geoid": RATIO_V,
    "gx": RATIO_G, "gy": RATIO_G, "gz": RATIO_G,
    "gxx": RATIO_GG, "gxy": RATIO_GG, "gxz": RATIO_GG,
    "gyy": RATIO_GG, "gyz": RATIO_GG, "gzz": RATIO_GG,
}

_SCALES = {
    "potential": constants.G,
    "geoid": constants.G / constants.g0,
    "gx": constants.SI2MGAL * constants.G,
    # the reference scales gy with the spherical-SI constant
    # (gravmag/tesseroid.py:416-417)
    "gy": constants.SI2MGAL * constants.Gs,
    "gz": constants.SI2MGAL * constants.G,
    "gxx": constants.SI2EOTVOS * constants.G,
    "gxy": constants.SI2EOTVOS * constants.G,
    "gxz": constants.SI2EOTVOS * constants.G,
    "gyy": constants.SI2EOTVOS * constants.G,
    "gyz": constants.SI2EOTVOS * constants.G,
    "gzz": constants.SI2EOTVOS * constants.G,
}


def _tess_cells(mesh_or_cells):
    """(M, 6) [w, e, s, n, top, bottom] bounds of active cells."""
    if hasattr(mesh_or_cells, "cell_bounds"):
        cells = np.asarray(mesh_or_cells.cell_bounds(only_active=True),
                           dtype=np.float64)
    else:
        cells = np.asarray(mesh_or_cells, dtype=np.float64)
    # validity checks (reference: gravmag/tesseroid.py:126-153)
    w, e, s, n, top, bottom = (cells[:, i] for i in range(6))
    assert (w <= e).all() and (s <= n).all() and (top >= bottom).all(), \
        "Invalid tesseroid dimensions"
    degenerate = ((e - w <= 1e-6) | (n - s <= 1e-6) | (top - bottom <= 1e-3))
    if degenerate.any():
        warnings.warn(
            "Encountered tesseroid with dimensions smaller than the "
            "numerical threshold (1e-6 degrees or 1e-3 m). "
            "Ignoring this tesseroid.", RuntimeWarning)
        cells = cells[~degenerate]
    return cells


def tesseroid_kernel_matrix(field, lon, lat, height, mesh_or_cells,
                            ratio=None, obs_block=256, backend="auto"):
    """Dense (D, M) sensitivity matrix of a tesseroid field in output units.

    Each column holds the field of a unit-density (1 g/cm^3) tesseroid,
    equivalent to the reference's ``kernel2d`` accumulation
    (reference: gravmag/_tesseroid_numba.py:63-69).

    Backends: ``'native'`` — the C++/OpenMP adaptive-stack engine
    (runtime/native/tessglq.cpp, the replacement for the reference's numba
    JIT); ``'numpy'`` — vectorised host worklist expansion + batched GLQ;
    ``'auto'`` — native with numpy fallback. Both produce the same leaves;
    they cross-check each other in tests.
    """
    if field not in _SCALES:
        raise ValueError(f"unknown tesseroid field {field!r}")
    ratio = _RATIOS[field] if ratio is None else ratio
    cells = _tess_cells(mesh_or_cells)
    lon = np.asarray(lon, dtype=np.float64).ravel()
    lat = np.asarray(lat, dtype=np.float64).ravel()
    height = np.asarray(height, dtype=np.float64).ravel()
    assert lon.shape == lat.shape == height.shape, \
        "Input coordinate arrays must have same shape"
    assert ratio > 0, f"Invalid ratio {ratio}. Must be > 0."
    D, M = lon.size, cells.shape[0]

    if backend in ("auto", "native"):
        try:
            from ..runtime import tessglq
            kname = "potential" if field == "geoid" else field
            kernel = tessglq.kernel_matrix(kname, lon, lat, height, cells,
                                           ratio)
            return kernel * _SCALES[field]
        except Exception:
            if backend == "native":
                raise
    # coordinate conversion (reference: gravmag/tesseroid.py:108-123)
    lon_r = np.radians(lon)
    lat_r = np.radians(lat)
    sinlat = np.sin(lat_r)
    coslat = np.cos(lat_r)
    radius = MEAN_EARTH_RADIUS + height

    kname = "potential" if field == "geoid" else field
    kfn = _NP_KERNELS[kname]
    kernel = np.zeros((D, M))
    for s0 in range(0, D, obs_block):
        s1 = min(s0 + obs_block, D)
        p_obs, p_cell, leaf_b = adaptive_leaves(
            lon_r[s0:s1], sinlat[s0:s1], coslat[s0:s1], radius[s0:s1],
            cells, ratio)
        lonc, sinlatc, coslatc, rc, scale = _glq_nodes(leaf_b, np)
        vals = scale * kfn(lon_r[s0:s1][p_obs], sinlat[s0:s1][p_obs],
                           coslat[s0:s1][p_obs], radius[s0:s1][p_obs],
                           lonc, sinlatc, coslatc, rc)
        np.add.at(kernel, (s0 + p_obs, p_cell), vals)
    kernel *= _SCALES[field]
    return kernel


def _mask_cell_terms(cells, ratio):
    """Per-cell subdivision-test constants: the obs-independent pieces of
    the reference's divisions() test (gravmag/_tesseroid_numba.py:135-157),
    reduced to ONE squared-distance threshold per cell: the root is
    subdivided iff d^2 <= max over valid axes of (ratio * L_axis)^2."""
    w, e, s, n, top, bottom = (cells[:, i] for i in range(6))
    rt = 0.5 * (top + bottom) + MEAN_EARTH_RADIUS
    lont = D2R * 0.5 * (w + e)
    latt = D2R * 0.5 * (s + n)
    rtop = top + MEAN_EARTH_RADIUS
    sinlatt, coslatt = np.sin(latt), np.cos(latt)
    Llon = rtop * np.arccos(np.clip(
        sinlatt ** 2 + coslatt ** 2 * np.cos(D2R * (e - w)), -1, 1))
    Llat = rtop * np.arccos(np.clip(
        np.sin(D2R * n) * np.sin(D2R * s)
        + np.cos(D2R * n) * np.cos(D2R * s), -1, 1))
    Lr = top - bottom
    thr = np.maximum.reduce([
        np.where(Llon > 0.1, (ratio * Llon) ** 2, -1.0),
        np.where(Llat > 0.1, (ratio * Llat) ** 2, -1.0),
        np.where(Lr > 1e3, (ratio * Lr) ** 2, -1.0)])
    return lont, latt, sinlatt, coslatt, rt, thr


def subdivision_mask(lon, lat, height, cells, ratio, obs_block=None,
                     backend="host"):
    """(obs_idx, cell_idx) pairs whose ROOT tesseroid the adaptive engine
    would subdivide (``distance <= ratio * size`` on any axis,
    reference: gravmag/_tesseroid_numba.py:135-157).

    These are the near-field pairs where depth-0 GLQ is insufficient;
    everything else evaluates exactly like the adaptive engine's leaf
    pass. The cell-dependent thresholds are precomputed once; the (B, M)
    pair test is a broadcast over obs blocks.

    ``backend='device'`` runs the pair test on the accelerator in f32 (the
    stable haversine distance form) and transfers only the matched index
    lists — at whole-Earth scale the host test reads ~0.5e9 f64 pairs
    while the device one is a trivial elementwise map. f32 thresholding
    may flip pairs within ~1e-6 relative of the test boundary, where
    depth-0 GLQ and one subdivision agree to the engine tolerance anyway.
    """
    lon_r = np.radians(np.asarray(lon, np.float64).ravel())
    lat_r = np.radians(np.asarray(lat, np.float64).ravel())
    radius = MEAN_EARTH_RADIUS + np.asarray(height, np.float64).ravel()
    cells = np.asarray(cells, np.float64)
    D, M = lon_r.size, cells.shape[0]
    lont, latt, sinlatt, coslatt, rt, thr = _mask_cell_terms(cells, ratio)

    if backend == "native":
        # C++/OpenMP two-pass pair test (runtime/native/tessglq.cpp
        # subdiv_mask_*): identical f64 math to the host path below, no
        # (B, M) numpy temporaries, no device-to-host copy of the pair
        # indices (the device backend's is large at whole-Earth scale).
        from ..runtime import tessglq
        return tessglq.subdivision_pairs(
            lon_r, np.sin(lat_r), np.cos(lat_r), radius,
            lont, sinlatt, coslatt, rt, thr)

    if backend == "device":
        import jax
        import jax.numpy as jnp

        obs_block = min(obs_block or 1024, D)
        f32 = jnp.float32
        # cell/obs geometry travels as jit ARGUMENTS: closure constants
        # would be baked into the HLO, making every geometry a fresh
        # compile
        cell_geom = tuple(jnp.asarray(a, f32) for a in
                          (lont, latt, coslatt, rt - MEAN_EARTH_RADIUS, rt,
                           thr))
        obs_all = tuple(jnp.asarray(a, f32) for a in
                        (lon_r, lat_r, np.cos(lat_r),
                         radius - MEAN_EARTH_RADIUS, radius))

        @jax.jit
        def block_mask(sl, obs, cgeom):
            c_lont, c_latt, c_coslatt, c_ht, c_rt, c_thr = cgeom
            lo, la, cl, hr, ra = (jax.lax.dynamic_slice_in_dim(a, sl,
                                                               obs_block)
                                  for a in obs)
            # stable d^2 = (dh)^2 + 4 r rt hav(psi)
            hav = (jnp.sin(0.5 * (la[:, None] - c_latt)) ** 2
                   + cl[:, None] * c_coslatt
                   * jnp.sin(0.5 * (lo[:, None] - c_lont)) ** 2)
            d2 = ((hr[:, None] - c_ht) ** 2
                  + 4.0 * ra[:, None] * c_rt * hav)
            m = d2 <= c_thr
            return m.ravel(), jnp.sum(m)

        oi_parts, ci_parts = [], []
        for s0 in range(0, D, obs_block):
            base = min(s0, max(D - obs_block, 0))  # last block backs up
            mask_flat, cnt = block_mask(base, obs_all, cell_geom)
            n = int(cnt)  # scalar d2h
            if n == 0:
                continue
            # round the nonzero size up so shapes (and compiles) repeat
            size = 1 << max(int(np.ceil(np.log2(n))), 10)
            (idx,) = jnp.nonzero(mask_flat, size=size, fill_value=-1)
            idx = np.asarray(idx)  # <= size * 4 bytes over the link
            idx = idx[idx >= 0]
            o = base + idx // M
            c = idx % M
            keep = (o >= s0) & (o < min(s0 + obs_block, D))
            oi_parts.append(o[keep])
            ci_parts.append(c[keep])
        if not oi_parts:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        return (np.concatenate(oi_parts).astype(np.int32),
                np.concatenate(ci_parts).astype(np.int32))

    obs_block = obs_block or 2048
    sinlat = np.sin(lat_r)
    coslat = np.cos(lat_r)
    oi_parts, ci_parts = [], []
    for s0 in range(0, D, obs_block):
        s1 = min(s0 + obs_block, D)
        cospsi = (sinlat[s0:s1, None] * sinlatt[None, :]
                  + coslat[s0:s1, None] * coslatt[None, :]
                  * np.cos(lon_r[s0:s1, None] - lont[None, :]))
        d2 = (radius[s0:s1, None] ** 2 + rt[None, :] ** 2
              - 2.0 * radius[s0:s1, None] * rt[None, :] * cospsi)
        o, c = np.nonzero(d2 <= thr[None, :])
        oi_parts.append(s0 + o)
        ci_parts.append(c)
    return (np.concatenate(oi_parts).astype(np.int32),
            np.concatenate(ci_parts).astype(np.int32))


def _nearfield_pair_values(kname, lon, lat, height, oi, ci, cells, ratio,
                           pair_block=65536):
    """UNSCALED adaptive-engine values of an explicit pair subset.

    Native C++/OpenMP engine (runtime/native/tessglq.cpp kernel_pairs)
    with a vectorised numpy-worklist fallback — either way the whole
    subset is evaluated in bulk, not one observation at a time (the
    round-2 per-observation loop cost ~1100 s at whole-Earth scale).
    """
    try:
        from ..runtime import tessglq
        return tessglq.kernel_pairs(kname, lon, lat, height, oi, ci, cells,
                                    ratio)
    except Exception:
        pass
    lon_rr = np.radians(lon)
    lat_rr = np.radians(lat)
    sinla, cosla = np.sin(lat_rr), np.cos(lat_rr)
    rad = MEAN_EARTH_RADIUS + height
    kfn_np = _NP_KERNELS[kname]
    vals = np.zeros(oi.size, np.float64)
    for s0 in range(0, oi.size, pair_block):
        s1 = min(s0 + pair_block, oi.size)
        # pair-restricted worklist: leaf 'cell' ids are PAIR slots because
        # the cells array passed in is already gathered per pair
        p_obs, p_slot, leaf_b = adaptive_leaves(
            lon_rr, sinla, cosla, rad, cells[ci[s0:s1]], ratio,
            pairs=(oi[s0:s1], np.arange(s1 - s0)))
        lc, slc, clc, rcn, sc = _glq_nodes(leaf_b, np)
        v = sc * kfn_np(lon_rr[p_obs], sinla[p_obs], cosla[p_obs],
                        rad[p_obs], lc, slc, clc, rcn)
        np.add.at(vals, s0 + p_slot, v)
    return vals


def tesseroid_kernel_device(field, lon, lat, height, mesh_or_cells, *,
                            ratio=None, host_kernel=None, obs_block=256,
                            winv=None, dtype=None):
    """Dense (D, M) sensitivity matrix built ON DEVICE — the link-safe
    path for kernels too large to ship over a slow host<->device link.

    The adaptive engine's subdivision decision depends only on geometry:
    far-field pairs (the overwhelming majority at whole-Earth scale)
    evaluate at depth 0, i.e. one 2x2x2 GLQ of the root tesseroid — a
    closed-form jnp computation the device can do from the (M, 6) cell
    bounds plus the observation coordinates (~KBs of h2d). Near-field
    pairs (``subdivision_mask``) are overwritten with exact host-engine
    values, shipped as a sparse (idx, value) correction. Total h2d:
    geometry + corrections instead of the dense D x M matrix (2.1 GB for
    the reference's global case, reference: example/global/logout_T1.txt).

    ``host_kernel``: optional host (D, M) array (e.g. the cached f64
    kernel) to source correction values; otherwise the native/numpy host
    engine computes just the masked pairs. ``winv``: optional (M,) column
    scaling folded in on device (sensitivity weighting). Returns a jax
    array in output units (field scaling applied).
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    dtype = dtype or jnp.float32
    if field not in _SCALES:
        raise ValueError(f"unknown tesseroid field {field!r}")
    ratio = _RATIOS[field] if ratio is None else ratio
    cells = _tess_cells(mesh_or_cells)
    lon = np.asarray(lon, np.float64).ravel()
    lat = np.asarray(lat, np.float64).ravel()
    height = np.asarray(height, np.float64).ravel()
    D, M = lon.size, cells.shape[0]
    kname = "potential" if field == "geoid" else field
    timing = bool(int(os.environ.get("GRAVINV_BUILD_TIMING", "0") or 0))
    t_mark = _time.time()

    def _stage(msg):
        nonlocal t_mark
        if timing:
            now = _time.time()
            print(f"[kernel_device +{now - t_mark:.2f}s] {msg}", flush=True)
            t_mark = now

    # --- far field: depth-0 GLQ on device -----------------------------
    lonc, sinlatc, coslatc, rc, scale = _glq_nodes(cells, np)
    scale_all = scale * _SCALES[field]
    if winv is not None:
        scale_all = scale_all * np.asarray(winv, np.float64)
    # geometry h2d: 5 (M, 2)/(M,) f32 arrays + 4 (D,) obs arrays (~3 MB
    # at global scale)
    cell_geom = (jnp.asarray(lonc, dtype), jnp.asarray(sinlatc, dtype),
                 jnp.asarray(coslatc, dtype), jnp.asarray(rc, dtype),
                 jnp.asarray(scale_all, dtype))
    lon_r = np.radians(lon)
    lat_r = np.radians(lat)
    obs_d = (jnp.asarray(lon_r, dtype), jnp.asarray(np.sin(lat_r), dtype),
             jnp.asarray(np.cos(lat_r), dtype),
             jnp.asarray(MEAN_EARTH_RADIUS + height, dtype))

    # cancellation-free pair terms: the classic l_sqr form loses up to
    # ~1e-4 per-entry relative accuracy in f32 at Earth-radius magnitudes
    kfn = _make_kernels(jnp, pair_terms=_pair_terms_stable)[kname]

    # geometry enters as jit ARGUMENTS (baking it in as closure constants
    # makes every geometry — even every --scale — a fresh compile), and
    # every block reuses ONE compiled shape (the
    # last block backs up and the overlap is sliced off)
    def _block(obs, cgeom):
        lonc_d, sinlatc_d, coslatc_d, rc_d, scale_d = cgeom

        def one_obs(lo, sl, cl, ra):
            full = lambda v: jnp.full((M,), v, dtype)
            return scale_d * kfn(full(lo), full(sl), full(cl), full(ra),
                                 lonc_d, sinlatc_d, coslatc_d, rc_d)

        return jax.vmap(one_obs)(*obs)

    block_fn = jax.jit(_block)
    obs_block = min(obs_block, D)
    rows, s0 = [], 0
    while s0 < D:
        base = min(s0, D - obs_block)
        blk = block_fn(tuple(o[base:base + obs_block] for o in obs_d),
                       cell_geom)
        rows.append(blk[s0 - base:])
        s0 = base + obs_block
    kernel = rows[0] if len(rows) == 1 else jnp.concatenate(rows, axis=0)
    kernel.block_until_ready()
    _stage(f"far-field depth-0 GLQ ({(D + obs_block - 1)//obs_block} "
           f"blocks of {obs_block})")

    # --- near field: exact host-engine values scattered in ------------
    # native C++ pair test first (no temporaries, no device-to-host
    # copy); the device test only as fallback for large problems (its
    # index copy to the host is large), host numpy for small ones
    try:
        oi, ci = subdivision_mask(lon, lat, height, cells, ratio,
                                  backend="native")
        mask_backend = "native"
    except Exception:  # noqa: BLE001 — native toolchain unavailable
        mask_backend = "device" if D * M > 20_000_000 else "host"
        oi, ci = subdivision_mask(lon, lat, height, cells, ratio,
                                  backend=mask_backend)
    _stage(f"subdivision mask [{mask_backend}] ({oi.size} pairs)")
    if oi.size:
        if host_kernel is not None:
            vals = np.asarray(host_kernel)[oi, ci].astype(np.float64)
        else:
            vals = _nearfield_pair_values(kname, lon, lat, height, oi, ci,
                                          cells, ratio) * _SCALES[field]
        if winv is not None:
            corr_scale = np.asarray(winv, np.float64)[ci]
            vals = vals * corr_scale
        _stage("near-field pair values (native engine)")
        # corrections travel as jit ARGUMENTS. Pad the pair list to a
        # power-of-two size (duplicating pair 0 with its own value —
        # duplicate .set of identical values is order-independent) so the
        # scatter compiles for O(log) distinct shapes, not one per
        # geometry.
        n = int(oi.size)
        size = 1 << max(int(np.ceil(np.log2(n))), 10)
        o_p = np.full(size, oi[0], np.int32)
        c_p = np.full(size, ci[0], np.int32)
        v_p = np.full(size, vals[0],
                      np.dtype(jnp.dtype(dtype).name))
        o_p[:n], c_p[:n] = oi, ci
        v_p[:n] = vals.astype(v_p.dtype)
        scatter = jax.jit(
            lambda K, o, c, v: K.at[o, c].set(v), donate_argnums=(0,))
        kernel = scatter(kernel, o_p, c_p, v_p)
        kernel.block_until_ready()
        _stage(f"scatter corrections (padded {n} -> {size})")
    return kernel, (oi, ci)


def _tess_field(field):
    def compute(lon, lat, height, model, dens=None, ratio=None, njobs=1,
                pool=None, **_ignored):
        """Field value and sensitivity matrix, reference-compatible API
        (reference: gravmag/tesseroid.py:324-508): returns
        ``(res, kernel2d)`` with res = kernel2d @ densities. ``njobs`` and
        ``pool`` are accepted for parity and ignored."""
        kernel2d = tesseroid_kernel_matrix(field, lon, lat, height, model,
                                           ratio=ratio)
        if dens is not None:
            densities = np.full(kernel2d.shape[1], float(dens))
        elif hasattr(model, "props") and "density" in model.props:
            densities = np.asarray(model.props["density"],
                                   dtype=np.float64)[model.active]
        else:
            densities = np.zeros(kernel2d.shape[1])
        res = kernel2d @ densities
        return res, kernel2d

    compute.__name__ = field
    return compute


potential = _tess_field("potential")
geoid = _tess_field("geoid")
gx = _tess_field("gx")
gy = _tess_field("gy")
gz = _tess_field("gz")
gxx = _tess_field("gxx")
gxy = _tess_field("gxy")
gxz = _tess_field("gxz")
gyy = _tess_field("gyy")
gyz = _tess_field("gyz")
gzz = _tess_field("gzz")


def forward(field, lon, lat, height, model, dens=None, ratio=None):
    """Forward-only evaluation (no kernel matrix) — the reference ships a
    separate ``tesseroidforward`` module for this
    (reference: gravmag/tesseroidforward.py); here the same engine skips
    the matrix when only the field is needed for plot-time re-forwarding."""
    res, _ = _tess_field(field)(lon, lat, height, model, dens=dens,
                                ratio=ratio)
    return res


# --------------------------------------------------------------------------
# magnetics — an EXTENSION: the reference declares spherical magnetic
# "not implemented" (readme.md:9-18; inversion/potential.py:106-108 stubs
# it). Built on Poisson's relation: the induction of a uniformly
# magnetized body is the gravity-gradient tensor of the same geometry
# contracted with the magnetization vector, so the adaptive-GLQ tensor
# kernels above ARE the magnetic kernels up to constants and frame.
# --------------------------------------------------------------------------

def _tensor_kernels_local_down(lons, lats, heights, mesh_or_cells,
                               ratio=None, backend="auto"):
    """Six RAW tensor kernel matrices in the local x=north, y=east,
    z=DOWN frame (the prism/magnetics convention, ops/prism.py).

    The GLQ tensor kernels use a local z-UP radial axis, so the mixed
    z terms flip sign (measured against the prism tensor in the
    flat-earth limit: gxz/gyz ratio -1, everything else +1 —
    tests/test_tesseroid_magnetic.py pins this). "Raw" = each field's
    output scaling divided back out (this also neutralises the
    reference's Gs-on-gy quirk, which must not leak into magnetics).
    """
    vs = []
    for f in ("gxx", "gxy", "gxz", "gyy", "gyz", "gzz"):
        k = tesseroid_kernel_matrix(f, lons, lats, heights, mesh_or_cells,
                                    ratio=ratio, backend=backend)
        k = k / _SCALES[f]
        if f in ("gxz", "gyz"):
            k = -k
        vs.append(k)
    return vs


def tf(lons, lats, heights, mesh_or_cells, inc, dec, pmag=None,
       ratio=None, backend="auto", **_ignored):
    """Total-field magnetic anomaly of tesseroids and its sensitivity
    matrix — same API and conventions as :func:`ops.prism.tf`
    (inc/dec in degrees, inc positive down; output nT via CM * T2NT;
    ``kernel2d`` columns = unit INDUCED magnetization along the
    regional field). Reference: declared unimplemented
    (gravmag/tesseroid.py:510 stub comment)."""
    from ..utils.units import dircos
    from .prism import _magnetization_vectors, _project

    cells = _tess_cells(mesh_or_cells)
    M = cells.shape[0]
    fdir = dircos(inc, dec)
    fx, fy, fz = fdir
    # magnetization override rules shared with the prism driver (its
    # _as_cells reads props through the same mesh interface — bounds
    # units differ between prisms and tesseroids, props do not)
    mvec = _magnetization_vectors(mesh_or_cells, pmag, fdir, M)
    vs = _tensor_kernels_local_down(lons, lats, heights, mesh_or_cells,
                                    ratio=ratio, backend=backend)
    scale = constants.CM * constants.T2NT
    bxm, bym, bzm = _project(vs, (mvec[0][None, :], mvec[1][None, :],
                                  mvec[2][None, :]))
    res = (fx * bxm + fy * bym + fz * bzm).sum(axis=1) * scale
    bxf, byf, bzf = _project(vs, (fx, fy, fz))
    kernel2d = (fx * bxf + fy * byf + fz * bzf) * scale
    return res, kernel2d


def _b_component_tess(index):
    def compute(lons, lats, heights, mesh_or_cells, pmag=None, ratio=None,
                backend="auto", **_ignored):
        """One component of the magnetic induction (nT), local x=north /
        y=east / z=down — the tesseroid counterpart of
        ops.prism.bx/by/bz (result only, like the reference's prism
        b-components, gravmag/prism.py:735-870)."""
        from .prism import _project

        cells = _tess_cells(mesh_or_cells)
        M = cells.shape[0]
        if pmag is not None:
            vec = np.asarray(pmag, dtype=np.float64).reshape(3, 1)
            mvec = np.broadcast_to(vec, (3, M))
        else:
            values = None
            if hasattr(mesh_or_cells, "props"):
                values = mesh_or_cells.props.get("magnetization")
                if values is not None:
                    values = np.asarray(values,
                                        np.float64)[mesh_or_cells.active]
            if values is None or np.asarray(values).ndim != 2:
                raise ValueError(
                    "b-components need vector magnetization or pmag")
            mvec = np.asarray(values, dtype=np.float64).T
        vs = _tensor_kernels_local_down(lons, lats, heights,
                                        mesh_or_cells, ratio=ratio,
                                        backend=backend)
        comps = _project(vs, (mvec[0][None, :], mvec[1][None, :],
                              mvec[2][None, :]))
        return comps[index].sum(axis=1) * constants.CM * constants.T2NT

    return compute


bx = _b_component_tess(0)
by = _b_component_tess(1)
bz = _b_component_tess(2)
