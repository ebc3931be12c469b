"""Joint gravity + magnetic inversion module.

Accelerator re-design of the reference's ``JointModule``
(reference: inversion/potential.py:847-1812): both fields share one mesh;
the reference materialises a block-diagonal (D_g+D_t) x 2M kernel
(inversion/potential.py:935-938) — here the block structure is exploited
instead, so the joint matvec is two independent matmuls and the
combined matrix is never formed. Weighting follows ``weightKDM``
(inversion/potential.py:1003-1065): per-column sqrt-energy model weighting
(block-diagonal, so each field weights its own columns) plus the
data-balancing diagonal ``Wb`` that scales the magnetic rows by
std(kernel_gz)/std(kernel_tf).

The joint data term uses the plain (not mean-removed) weighted residual
``||Aw mw - Wb d||^2`` (reference: inversion/potential.py:1665-1690 —
unlike the single-field module). Regularizers act on the stacked
``[rho; mag]`` vector; Smoothness/TV apply the 3-D difference operator to
each half (the reference's doubled fd3d*joint operators,
inversion/potential.py:1075-1555).

``cross_gradient`` implements the structural-coupling term the reference
stubs out (its ``CrossGradient`` is a bare ``pass``,
inversion/potential.py:1558-1559): the squared cross product of the two
property gradients summed over cells, differentiated by autodiff.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .. import mesher
from ..ops import fd, prism
from ..utils.units import ang2vec
from .potential import A_PRECISION, Potential, sensitivity_weighting


class JointModule:
    """Misfit/gradient provider for joint [density; magnetization]
    inversion, reference-compatible construction
    (inversion/potential.py:848-1001)."""

    def __init__(self, dobs_gz, dobs_tf, mrange, mspacing, obsurface,
                 mratio=1, coordinate="cartesian", njobs=1, mangle=(90, 0),
                 wavelet=False, dtype=jnp.float32, verbose=True, **kwargs):
        self.dobs_gz = np.asarray(dobs_gz, dtype=np.float64)
        self.dobs_tf = np.asarray(dobs_tf, dtype=np.float64)
        self.mrange = mrange
        self.mspacing = mspacing
        self.mratio = mratio
        self.inc, self.dec = mangle
        self.dtype = dtype
        self.topocarve = False
        self.mask = []
        lon, lat, height = (np.asarray(a, dtype=np.float64)
                            for a in obsurface)

        mtopo = None
        for _k, v in kwargs.items():
            self.topocarve = True
            mtopo = v

        if coordinate == "spherical":
            mesh = mesher.TesseroidMesh(mrange, mspacing, mratio)
        elif coordinate == "cartesian":
            mesh = mesher.PrismMesh(mrange, mspacing, mratio)
        else:
            raise ValueError(
                "Please choose coordinate from(cartesian, spherical)!")
        if mtopo is not None:
            self.mask = mesh.carvetopo(mtopo[0], mtopo[1], mtopo[2])
        self.mesh = mesh
        self.mshape = mesh.shape
        self.mxs = mesh.get_xs()
        self.mys = mesh.get_ys()
        self.mzs = mesh.get_zs()

        if coordinate == "spherical":
            # EXTENSION: the reference's joint module cannot do spherical
            # at all (inversion/potential.py:897 raises); the magnetic
            # tesseroid kernel (Poisson relation over the GLQ tensor,
            # ops/tesseroid.py tf) completes the pair here.
            from ..ops import tesseroid as tess
            mesh.addprop("density", np.zeros(mesh.size))
            kernel_gz = tess.tesseroid_kernel_matrix("gz", lon, lat,
                                                     height, mesh)
            mesh.addprop("magnetization",
                         ang2vec(np.zeros(mesh.size), self.inc, self.dec))
            _, kernel_tf = tess.tf(lon, lat, height, mesh, self.inc,
                                   self.dec)
        else:
            mesh.addprop("density", np.zeros(mesh.size))
            kernel_gz = prism.prism_kernel_matrix("gz", lon, lat, height,
                                                  mesh)
            mesh.addprop("magnetization",
                         ang2vec(np.zeros(mesh.size), self.inc, self.dec))
            _, kernel_tf = prism.tf(lon, lat, height, mesh, self.inc,
                                    self.dec)
        self.kernel_gz = kernel_gz
        self.kernel_tf = kernel_tf

        # weightKDM: block-diagonal structure means each field weights its
        # own columns; Wb balances the magnetic rows
        _, wg, wg_inv = sensitivity_weighting(kernel_gz, 0.5)
        _, wt, wt_inv = sensitivity_weighting(kernel_tf, 0.5)
        std_gz = float(np.std(kernel_gz))
        std_tf = float(np.std(kernel_tf))
        self.wb_tf = std_gz / std_tf  # magnetic-row balance factor
        self.wdiag = np.concatenate([wg, wt])
        self.wdiag_inv = np.concatenate([wg_inv, wt_inv])
        self.Awg = kernel_gz * wg_inv[None, :]
        self.Awt = (kernel_tf * wt_inv[None, :]) * self.wb_tf
        self.dobsw = np.concatenate([self.dobs_gz,
                                     self.wb_tf * self.dobs_tf])
        self.M = kernel_gz.shape[1]
        self.n_active = 2 * self.M
        self._active3d = (mesh.active.reshape(mesh.shape)
                          if not mesh.active.all() else None)

    # ------------------------------------------------------------------
    @property
    def A(self):
        """Materialised block-diagonal kernel, reference layout
        (inversion/potential.py:935-938). Prefer the block matvec."""
        Dg, M = self.kernel_gz.shape
        Dt = self.kernel_tf.shape[0]
        A = np.zeros((Dg + Dt, 2 * M))
        A[:Dg, :M] = self.kernel_gz
        A[Dg:, M:] = self.kernel_tf
        return A

    def forward(self, model):
        """Unweighted forward of a stacked [rho; mag] model
        (reference: inversion/potential.py:1067-1073)."""
        model = np.asarray(model)
        return np.concatenate([self.kernel_gz @ model[: self.M],
                               self.kernel_tf @ model[self.M:]])

    def make_potential(self, aprior_mw, low, high, constraint="mandatory",
                       log_factor=1000.0, regularization="Damping",
                       beta=0.01, cross_gradient_weight=0.0, dtype=None,
                       jacobian=False, temperature=1.0):
        """Jittable joint potential over the stacked (2M,) variable."""
        from .potential import logistic_to_mw

        if jacobian or float(temperature) != 1.0:
            raise NotImplementedError(
                "the joint potential does not support the honest-"
                "posterior temperature/jacobian mode yet")

        dtype = dtype or self.dtype
        M = self.M
        mshape = self.mshape
        beta = float(beta)
        lf = float(log_factor)
        cgw = float(cross_gradient_weight)
        params = {
            "Awg": jnp.asarray(self.Awg, dtype),
            "Awt": jnp.asarray(self.Awt, dtype),
            "dobsw": jnp.asarray(self.dobsw, dtype),
            "aprior_mw": jnp.asarray(aprior_mw, dtype),
            "low": jnp.asarray(low, dtype),
            "high": jnp.asarray(high, dtype),
            "wm_sq": jnp.asarray(self.wdiag ** 2, dtype),
            "wdiag_inv": jnp.asarray(self.wdiag_inv, dtype),
        }

        def model_term(mw, P):
            dm = mw - P["aprior_mw"]
            if regularization == "MS":
                dm2 = dm * dm
                return jnp.sum(P["wm_sq"] * dm2 / (dm2 + beta))
            if regularization == "Damping":
                return jnp.sum(dm * dm)
            # doubled-size operators: apply fd3d to each half
            if regularization == "Smoothness":
                return (fd.smoothness_value(dm[:M], mshape, jnp)
                        + fd.smoothness_value(dm[M:], mshape, jnp))
            return (fd.tv_value(dm[:M], mshape, beta, jnp)
                    + fd.tv_value(dm[M:], mshape, beta, jnp))

        def cross_gradient(mw, P):
            """Structural coupling sum ||grad rho x grad mag||^2 over the
            grid (the reference's stubbed CrossGradient,
            inversion/potential.py:1558-1559)."""
            m = mw * P["wdiag_inv"]
            gx_r, gy_r, gz_r = fd.grid_diffs(m[:M], mshape, jnp)
            gx_m, gy_m, gz_m = fd.grid_diffs(m[M:], mshape, jnp)
            # pad the one-short difference axes back to grid shape
            def pad(a, axis):
                widths = [(0, 0)] * 3
                widths[axis] = (0, 1)
                return jnp.pad(a, widths)
            ax, ay, az = pad(gx_r, 2), pad(gy_r, 1), pad(gz_r, 0)
            bx, by, bz = pad(gx_m, 2), pad(gy_m, 1), pad(gz_m, 0)
            cx = ay * bz - az * by
            cy = az * bx - ax * bz
            cz = ax * by - ay * bx
            return jnp.sum(cx * cx + cy * cy + cz * cz)

        def potential_scalar(x, alpha, P):
            if constraint == "logarithmic":
                mw = logistic_to_mw(x, P["low"], P["high"], lf)
            else:
                mw = x
            dpre = jnp.concatenate([
                jnp.matmul(P["Awg"], mw[:M], precision=A_PRECISION),
                jnp.matmul(P["Awt"], mw[M:], precision=A_PRECISION)])
            r = dpre - P["dobsw"]  # plain residual (joint module convention)
            u_data = jnp.sum(r * r)
            u_model = model_term(mw, P)
            u = u_data + alpha * u_model
            if cgw:
                u = u + cgw * cross_gradient(mw, P)
            return u, (dpre, u_data, u_model)

        grad_fn = jax.value_and_grad(potential_scalar, has_aux=True)

        def fn(x, alpha, P):
            x = jnp.asarray(x, dtype)
            alpha = jnp.asarray(alpha, dtype)
            if x.ndim == 1:
                (u, aux), g = grad_fn(x, alpha, P)
                return u, g, aux
            (u, aux), g = jax.vmap(lambda xi: grad_fn(xi, alpha, P))(x)
            return u, g, aux

        return Potential(fn, params)
