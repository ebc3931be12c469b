"""Wavelet kernel-matrix compression (db4, periodized, level 2).

Re-implements the reference's pywt-based compressors
(reference: gravmag/compressor1D.py:18-60, compressor3D.py:18-68) from
scratch — pywt is not a dependency. Rows of the weighted kernel are
transformed with an orthonormal Daubechies-4 discrete wavelet transform,
hard-thresholded, and stored sparse; the model vector is transformed with
the same operator so the matvec happens in the wavelet domain:

    A m  =  (A W^T) (W m)  ~=  threshold(A W^T) (W m)

``W`` is built as an explicit linear isometry (W^T W = I): odd-length
levels are zero-padded before the even-periodized orthogonal step, so the
identity holds exactly before thresholding. Filter taps are the published
Daubechies-4 coefficients.

On an accelerator a dense matmul usually beats sparse gathers, so
compression is an opt-in for memory-limited problems — the same role it
plays in the reference (reference: readme.md:109).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# Daubechies-4 (8-tap) scaling filter, orthonormal normalisation
DB4_LO = np.array([
    0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
    -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
    0.032883011666982945, -0.010597401784997278,
])
#: quadrature-mirror high-pass: h[m] = (-1)^m g[L-1-m]
DB4_HI = ((-1.0) ** np.arange(8)) * DB4_LO[::-1]


def _dwt_level(x, axis):
    """One periodized DWT level along ``axis``; zero-pads odd lengths first.

    Jointly (approx, detail) is an isometry of the input axis.
    """
    x = np.moveaxis(np.asarray(x, dtype=np.float64), axis, -1)
    n = x.shape[-1]
    if n % 2:
        x = np.concatenate([x, np.zeros(x.shape[:-1] + (1,))], axis=-1)
        n += 1
    idx = (2 * np.arange(n // 2)[:, None] + np.arange(8)[None, :]) % n
    windows = x[..., idx]  # (..., n//2, 8)
    a = windows @ DB4_LO
    d = windows @ DB4_HI
    return np.moveaxis(a, -1, axis), np.moveaxis(d, -1, axis)


def dwt1d(x, levels=2, axis=-1):
    """Multi-level 1-D DWT along ``axis``: [a_L, d_L, ..., d_1] concatenated.

    Operates on any batch shape; the transform is a linear isometry of the
    chosen axis.
    """
    details = []
    a = np.asarray(x, dtype=np.float64)
    for _ in range(levels):
        a, d = _dwt_level(a, axis)
        details.append(d)
    return np.concatenate([a] + details[::-1], axis=axis)


def _level3d(v, axes):
    """Split one level into the LLL block plus 7 detail octants."""
    blocks = [v]
    for ax in axes:
        nxt = []
        for b in blocks:
            a, d = _dwt_level(b, ax)
            nxt.extend([a, d])
        blocks = nxt
    return blocks[0], blocks[1:]


def dwt3d(vol, levels=2):
    """Multi-level separable 3-D DWT flattened to a vector.

    ``vol`` is (nz, ny, nx) or batched (B, nz, ny, nx). Output stacks the
    deepest approximation block then the detail octants per level (deepest
    first). The block ordering is internal — only the isometry property
    matters for compression. Output length K >= nz*ny*nx when padding
    occurred.
    """
    vol = np.asarray(vol, dtype=np.float64)
    batched = vol.ndim == 4
    if not batched:
        vol = vol[None]
    axes = (1, 2, 3)
    a = vol
    details = []
    for _ in range(levels):
        a, ds = _level3d(a, axes)
        details.append(np.concatenate(
            [d.reshape(d.shape[0], -1) for d in ds], axis=1))
    flat = np.concatenate([a.reshape(a.shape[0], -1)] + details[::-1], axis=1)
    return flat if batched else flat[0]


# --------------------------------------------------------------------------
# compressors (reference-compatible API)
# --------------------------------------------------------------------------

def kernelcompressor_1d(Aw, threshold=1e-3, levels=2):
    """Row-wise 1-D DWT + hard threshold -> CSR
    (reference: gravmag/compressor1D.py:18-47)."""
    Aw = np.asarray(Aw, dtype=np.float64)
    coeffs = dwt1d(Aw, levels=levels, axis=1)
    coeffs[np.abs(coeffs) < threshold] = 0.0
    return sp.csr_matrix(coeffs)


def modelcompressor_1d(m, Awcp, levels=2):
    """Wavelet-domain matvec: Awcp @ W m
    (reference: gravmag/compressor1D.py:50-60)."""
    mcp = dwt1d(np.asarray(m, dtype=np.float64), levels=levels, axis=-1)
    return np.asarray(Awcp @ mcp).ravel()


def kernelcompressor_3d(Aw, mshape, threshold=1e-3, levels=2):
    """Row-wise 3-D DWT + hard threshold -> CSR
    (reference: gravmag/compressor3D.py:18-40)."""
    Aw = np.asarray(Aw, dtype=np.float64)
    nz, ny, nx = mshape
    vol = Aw.reshape(Aw.shape[0], nz, ny, nx)
    coeffs = dwt3d(vol, levels=levels)
    coeffs[np.abs(coeffs) < threshold] = 0.0
    return sp.csr_matrix(coeffs)


def modelcompressor_3d(m, Awcp, mshape, levels=2):
    """Wavelet-domain matvec for the 3-D transform
    (reference: gravmag/compressor3D.py:46-68)."""
    nz, ny, nx = mshape
    mcp = dwt3d(np.asarray(m, dtype=np.float64).reshape(nz, ny, nx),
                levels=levels)
    return np.asarray(Awcp @ mcp).ravel()


def compression_ratio(Awcp, dense_shape):
    """Fraction of nonzeros retained after thresholding."""
    return Awcp.nnz / float(dense_shape[0] * dense_shape[1])


# --------------------------------------------------------------------------
# device-side (jax) model transform for the sampler hot loop
# --------------------------------------------------------------------------

def _dwt_level_jax(x, axis):
    """jnp mirror of :func:`_dwt_level` (linear, autodiff-friendly)."""
    import jax.numpy as jnp

    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if n % 2:
        x = jnp.concatenate([x, jnp.zeros(x.shape[:-1] + (1,), x.dtype)], axis=-1)
        n += 1
    idx = (2 * np.arange(n // 2)[:, None] + np.arange(8)[None, :]) % n
    windows = x[..., idx]
    lo = jnp.asarray(DB4_LO, dtype=x.dtype)
    hi = jnp.asarray(DB4_HI, dtype=x.dtype)
    a = windows @ lo
    d = windows @ hi
    return jnp.moveaxis(a, -1, axis), jnp.moveaxis(d, -1, axis)


def make_model_transform(mshape=None, mode="1D", levels=2):
    """Jittable ``W m`` for the sampler's wavelet-domain matvec.

    ``mode='1D'`` transforms the trailing axis of a (..., M) model batch;
    ``mode='3D'`` reshapes the trailing axis to ``mshape`` first. The
    returned function matches the host-side :func:`dwt1d` / :func:`dwt3d`
    coefficient layout exactly.
    """
    import jax.numpy as jnp

    def transform1d(m):
        a = m
        details = []
        for _ in range(levels):
            a, d = _dwt_level_jax(a, -1)
            details.append(d)
        return jnp.concatenate([a] + details[::-1], axis=-1)

    if mode == "1D":
        return transform1d

    nz, ny, nx = mshape

    def transform3d(m):
        batch = m.shape[:-1]
        v = m.reshape(batch + (nz, ny, nx))
        off = len(batch)
        axes = (off, off + 1, off + 2)
        a = v
        details = []
        for _ in range(levels):
            blocks = [a]
            for ax in axes:
                nxt = []
                for b in blocks:
                    lo, hi = _dwt_level_jax(b, ax)
                    nxt.extend([lo, hi])
                blocks = nxt
            a = blocks[0]
            details.append(jnp.concatenate(
                [b.reshape(batch + (-1,)) for b in blocks[1:]], axis=-1))
        return jnp.concatenate(
            [a.reshape(batch + (-1,))] + details[::-1], axis=-1)

    return transform3d
