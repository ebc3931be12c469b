"""Deterministic regularized inversion: Conjugate Gradient + Bootstrap.

Accelerator re-design of the reference's numpy CG
(reference: inversion/reginv.py:22-491) and bootstrap wrapper
(reference: inversion/reginv.py:494-748):

* The CG iteration (Fletcher-Reeves direction, analytic step size, hard
  box projection, adaptive regularization decay) runs as one jitted
  ``lax.scan`` — the exact reference schedule: alpha = 0 at k=0,
  alpha = data/model at k=1, alpha <- q * alpha whenever the data misfit
  drops by less than 1% (reference: inversion/reginv.py:383-404,427-463).
* Bootstrap row-resampling is reformulated as multiplicity-weighted least
  squares: resampling rows of (Aw, dobs) with replacement is identical to
  weighting each row by its draw count, so every replicate shares the one
  device-resident kernel matrix and all replicates run as a vmapped batch —
  replacing the reference's per-sample python loop that materialises a
  full copy of Aw per replicate (reference: inversion/reginv.py:727-741).

Reference quirks handled:

* CG uses the plain (not mean-removed) residual, unlike the HMC module
  (reference: inversion/reginv.py:248-257 vs potential.py:706-708);
  preserved.
* The reference's ``model_gfun_MS`` divides by (mw^2 + beta)^2 instead of
  ((mw - mwapr)^2 + beta)^2 — a bug that is invisible in the shipped
  examples because their prior model is zero. Here the gradient is the
  exact derivative of the MS value (autodiff); identical whenever
  mwapr == 0.
* The bootstrap's internal CG regularises ``mw`` directly (no prior) with
  beta squared and stops on an absolute data misfit < 0.1
  (reference: inversion/reginv.py:600-614,693-696); preserved.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .potential import A_PRECISION, GravMagModule


def _make_cg_core(Aw, dobs, wdiag, wdiag_inv, mshape, active3d,
                  regularization, beta, q, maxk, rhomin, rhomax,
                  stop_mode, dtype, aprior_mw=None, bootstrap_ms=False,
                  as_args=False, fixed_alpha=False, keep_best=False):
    """Jitted CG solver over (optionally weighted) rows.

    Returns solve(mw0, row_weights[, arrs][, alpha]) -> (mw_final,
    data_hist, model_hist, regul_hist, n_iters). ``row_weights`` are
    data-row multiplicities (ones = plain CG).

    ``as_args=True`` returns a solver taking the large arrays as a
    third ``arrs`` pytree argument ``(Aw, dobs, wdiag, wdiag_inv,
    aprior_mw)`` instead of closure constants — REQUIRED for
    device-resident kernels: a closure-captured jax.Array becomes a jit
    constant embedded in the executable (gigabytes per compile).

    ``fixed_alpha=True`` replaces the reference's adaptive
    regularization schedule (alpha=0 at k=0, data/model at k=1, q-decay
    on stalls — inversion/reginv.py:383-404, which DIVERGES at the
    whole-Earth scale, GLOBAL_r04 reference_cg_divergence) with a
    CONSTANT alpha passed at call time: solve(mw0, c, arrs, alpha).
    Every iteration — including the k=0 steepest-descent step — then
    minimises the one objective ||A mw - d||^2 + alpha*R(mw) under the
    hard box projection: the bounded-MAP estimator of the configured
    family (the fixed-alpha ladder that closes the resolution-limit
    argument).
    """
    from ..ops import fd

    if as_args:
        const_arrs = None
        dsize, msize = Aw.shape
    else:
        Aw_c = jnp.asarray(Aw, dtype)
        const_arrs = (Aw_c, jnp.asarray(dobs, dtype),
                      jnp.asarray(wdiag, dtype),
                      jnp.asarray(wdiag_inv, dtype),
                      (jnp.asarray(aprior_mw, dtype)
                       if aprior_mw is not None
                       else jnp.zeros(Aw_c.shape[1], dtype)))
        dsize, msize = Aw_c.shape
    beta = float(beta)
    q = float(q)
    act = jnp.asarray(active3d) if active3d is not None else None

    def solve(mw0, c, arrs=None, alpha=None):
        Aw, dobs, wdiag, wdiag_inv, apr = \
            const_arrs if arrs is None else arrs
        wm_sq = wdiag * wdiag
        alpha_f = (jnp.asarray(alpha, dtype) if fixed_alpha
                   else None)

        def a_mul(v):
            return jnp.matmul(Aw, v, precision=A_PRECISION)

        def data_value(mw, c):
            r = a_mul(mw) - dobs
            return jnp.sum(c * r * r)

        def data_grad(mw, c):
            r = a_mul(mw) - dobs
            return 2.0 * jnp.matmul(c * r, Aw, precision=A_PRECISION)

        def model_value(mw):
            dm = mw - apr
            if bootstrap_ms:
                # bootstrap variant: no prior, beta squared
                # (reference: inversion/reginv.py:600-606)
                m2 = mw * mw
                return jnp.sum(wm_sq * m2 / (m2 + beta ** 2))
            if regularization == "MS":
                dm2 = dm * dm
                return jnp.sum(wm_sq * dm2 / (dm2 + beta))
            if regularization == "Damping":
                return jnp.sum(dm * dm)
            if regularization == "Smoothness":
                return fd.smoothness_value(dm, mshape, jnp, act)
            return fd.tv_value(dm, mshape, beta, jnp, act)

        model_grad = jax.grad(model_value)

        def project(mw):
            m = jnp.clip(mw * wdiag_inv, rhomin, rhomax)
            return m * wdiag

        def weighted_norm_sq(v, c):
            av = a_mul(v)
            return jnp.sum(c * av * av)

        mw0 = jnp.asarray(mw0, dtype)
        c = jnp.asarray(c, dtype)
        # ---- k = 0: steepest descent (alpha = 0 under the reference's
        # adaptive schedule; the fixed objective's full gradient in
        # fixed-alpha mode) ------------------------------------------------
        if alpha_f is None:
            I0 = data_grad(mw0, c)  # + 0 * model_grad
            Iw0 = I0
            kstep = jnp.dot(Iw0, I0) / weighted_norm_sq(Iw0, c)
        else:
            I0 = data_grad(mw0, c) + alpha_f * model_grad(mw0)
            Iw0 = I0
            kstep = jnp.dot(Iw0, I0) / (weighted_norm_sq(Iw0, c)
                                        + alpha_f * jnp.sum(Iw0 * Iw0))
        mw1 = project(mw0 - kstep * Iw0)
        d0 = data_value(mw0, c)
        m0 = model_value(mw0)

        def body(carry, k):
            (mw_prev, mw_cur, I_prev, Iw_prev, alpha, done) = carry[:6]
            d_prev = data_value(mw_prev, c)
            d_cur = data_value(mw_cur, c)
            if alpha_f is None:
                alpha1 = d_cur / model_value(mw_cur)  # k == 1 rule
                decay = jnp.where(d_prev - d_cur < 0.01 * d_prev,
                                  q * alpha, alpha)
                alpha = jnp.where(k == 1, alpha1, decay)
            else:
                alpha = alpha_f
            I = data_grad(mw_cur, c) + alpha * model_grad(mw_cur)
            mu = jnp.sum(I * I) / jnp.sum(I_prev * I_prev)
            Iw = I + mu * Iw_prev
            kstep = jnp.dot(Iw, I) / (weighted_norm_sq(Iw, c)
                                      + alpha * jnp.sum(Iw * Iw))
            mw_next = project(mw_cur - kstep * Iw)
            d_next = data_value(mw_next, c)
            m_next = model_value(mw_next)
            if stop_mode == "normalized":
                stop_now = d_next / dsize < 0.001
            else:  # absolute (bootstrap, reference: reginv.py:693-696)
                stop_now = d_next < 0.1
            # freeze the state once done
            mw_prev_n = jnp.where(done, mw_prev, mw_cur)
            mw_cur_n = jnp.where(done, mw_cur, mw_next)
            I_n = jnp.where(done, I_prev, I)
            Iw_n = jnp.where(done, Iw_prev, Iw)
            hist = jnp.where(done, jnp.nan,
                             jnp.stack([d_next / dsize, m_next / msize,
                                        alpha]))
            done_pre = done  # before this iteration's stop criterion
            done = done | stop_now
            new_carry = (mw_prev_n, mw_cur_n, I_n, Iw_n, alpha, done)
            if keep_best:
                # projected Fletcher-Reeves is NOT monotone (the hard box
                # projection breaks conjugacy and can late-diverge in
                # f32 — a full-scale warm start was measured passing
                # objective 3.2e5 and ending at 1.3e8): track the best
                # iterate by the FIXED objective and return that. Gate
                # on done BEFORE this iteration's stop flag, or the
                # iterate that TRIGGERS the stop criterion (typically
                # the best of the run) could never be recorded.
                mw_best, obj_best = carry[6], carry[7]
                obj_next = d_next + alpha * m_next
                better = (obj_next < obj_best) & ~done_pre
                mw_best = jnp.where(better, mw_next, mw_best)
                obj_best = jnp.where(better, obj_next, obj_best)
                new_carry = new_carry + (mw_best, obj_best)
            return new_carry, hist

        carry0 = (mw0, mw1, I0, Iw0, jnp.asarray(0.0, dtype),
                  jnp.asarray(False))
        if keep_best:
            # seed the best from BOTH the incoming point and the k=0
            # step — a segmented (restarted) solve must never return
            # worse than what it was handed
            a0 = alpha_f if alpha_f is not None else jnp.asarray(0.0,
                                                                 dtype)
            obj_in = d0 + a0 * m0
            obj_1 = data_value(mw1, c) + a0 * model_value(mw1)
            take1 = obj_1 < obj_in
            carry0 = carry0 + (jnp.where(take1, mw1, mw0),
                               jnp.minimum(obj_in, obj_1))
        fin_carry, hist = lax.scan(body, carry0, jnp.arange(1, maxk))
        mw_fin = fin_carry[6] if keep_best else fin_carry[1]
        data_hist = jnp.concatenate([jnp.array([d0 / dsize], dtype),
                                     hist[:, 0]])
        model_hist = jnp.concatenate([jnp.array([m0 / msize], dtype),
                                      hist[:, 1]])
        regul_hist = jnp.concatenate([jnp.array([0.0], dtype), hist[:, 2]])
        n_iters = jnp.sum(~jnp.isnan(hist[:, 0])) + 1
        return mw_fin, data_hist, model_hist, regul_hist, n_iters

    return solve


def cg_device(module, dobs, boundary, regularization="Damping", beta=0.01,
              q=0.7, maxk=200, initial=None, aprior=None,
              dtype=jnp.float32, alpha=None, keep_best=None):
    """Device-resident CG on an EXISTING :class:`GravMagModule`.

    The whole-Earth warm-start path: the reference's own workflow is "CG
    for the map, HMC for the uncertainty around it" (reference:
    inversion/reginv.py:357-491 is the production inversion; HMC samples
    its neighborhood), and at the 7381x72000 global scale the kernel
    lives on the accelerator (kernel_device=True), so the CG must run
    against the module's device kernel with every large array threaded
    as a jit ARGUMENT — not rebuilt from a host matrix like
    :class:`ConjugateGradient`.

    Returns a dict: ``mw`` (weighted-domain solution, device), ``m``
    (density model, device), small host-side ``data_hist`` /
    ``model_hist`` / ``regul_hist`` / ``n_iters``. Only the histories
    (O(maxk) floats) cross the device link.
    """
    arrs_mod = module.device_arrays(dtype)
    Aw = arrs_mod["Aw"]
    D, M = Aw.shape
    wdiag = jnp.asarray(module.wdiag, dtype)
    wdiag_inv = jnp.asarray(module.wdiag_inv, dtype)
    dobs_d = jnp.asarray(dobs, dtype)
    rhomin, rhomax = boundary[0], boundary[1]
    apr_m = (jnp.asarray(aprior, dtype) if aprior is not None
             else jnp.zeros(M, dtype))
    mw0 = (wdiag * jnp.asarray(initial, dtype) if initial is not None
           else jnp.zeros(M, dtype))
    active3d = getattr(module, "_active3d", None)
    if keep_best is None:
        # fixed-alpha mode minimises ONE objective, so returning the
        # best-objective iterate is well-defined (and guards against the
        # f32 late-divergence of projected Fletcher-Reeves); the
        # adaptive mode keeps the reference's return-final semantics
        keep_best = alpha is not None
    # Deep FIXED-alpha solves run as restarted segments of at most
    # SEGMENT iterations, one short program each — well-defined there
    # because keep_best tracks the one objective; the adaptive schedule
    # carries cross-iteration state and stays single-program.
    SEGMENT = 800
    n_segments = 1
    maxk_core = maxk
    if alpha is not None and maxk > SEGMENT:
        n_segments = -(-maxk // SEGMENT)
        maxk_core = SEGMENT
    solve = _make_cg_core(
        Aw, None, None, None, module.mshape, active3d, regularization,
        beta, q, maxk_core, rhomin, rhomax, "normalized", dtype,
        as_args=True, fixed_alpha=alpha is not None, keep_best=keep_best)
    arrs = (Aw, dobs_d, wdiag, wdiag_inv, wdiag * apr_m)
    jsolve = jax.jit(solve)
    if alpha is None:
        mw_fin, d_h, m_h, r_h, n_it = jsolve(mw0, jnp.ones(D, dtype), arrs)
        n_it = int(n_it)  # scalar d2h — also the completion barrier
        d_hs = [np.asarray(d_h, np.float64)[:n_it]]
        m_hs = [np.asarray(m_h, np.float64)[:n_it]]
        r_hs = [np.asarray(r_h, np.float64)[:n_it]]
        n_total = n_it
    else:
        # bounded MAP at a FIXED alpha (ladder mode): alpha rides as a
        # traced argument so one executable serves a whole ladder
        a = jnp.asarray(alpha, dtype)
        mw_fin = mw0
        d_hs, m_hs, r_hs = [], [], []
        n_total = 0
        for _ in range(n_segments):
            mw_fin, d_h, m_h, r_h, n_it = jsolve(
                mw_fin, jnp.ones(D, dtype), arrs, a)
            n_it = int(n_it)  # per-segment scalar sync: short programs
            d_hs.append(np.asarray(d_h, np.float64)[:n_it])
            m_hs.append(np.asarray(m_h, np.float64)[:n_it])
            r_hs.append(np.asarray(r_h, np.float64)[:n_it])
            n_total += n_it
    return {
        "mw": mw_fin,
        "m": mw_fin * wdiag_inv,
        "data_hist": np.concatenate(d_hs),
        "model_hist": np.concatenate(m_hs),
        "regul_hist": np.concatenate(r_hs),
        "n_iters": n_total,
    }


class ConjugateGradient:
    """Regularized CG inversion, reference-compatible construction
    (reference: inversion/reginv.py:22-149). Builds mesh + kernel +
    sqrt-column weighting via :class:`GravMagModule` (the reference's
    ``newkernel`` is the weightfactor=0.5 case of sensitivity weighting).
    """

    def __init__(self, dobs, mrange, mspacing, obsurface, mratio=1, njobs=1,
                 coordinate="cartesian", field="gravity", mangle=(90, 0),
                 wavelet=False, mseg=False, mdivisionsection=(),
                 dtype=jnp.float64, verbose=True, **kwargs):
        self._mod = GravMagModule(
            dobs, mrange, mspacing, obsurface, mratio=mratio,
            weightfactor=0.5, coordinate=coordinate, njobs=njobs,
            field=field, mangle=mangle, wavelet=wavelet, mseg=mseg,
            mdivisionsection=mdivisionsection, dtype=dtype, verbose=verbose,
            **kwargs)
        self.dtype = dtype
        self.dobs = np.asarray(dobs, dtype=np.float64)
        self.mesh = self._mod.mesh
        self.mshape = self._mod.mshape
        self.mxs = self._mod.mxs
        self.mys = self._mod.mys
        self.mzs = self._mod.mzs
        self.A = self._mod.A
        self.Aw = self._mod.Aw
        self.wdiag = self._mod.wdiag
        self.wdiag_inv = self._mod.wdiag_inv
        self.dsize = self.A.shape[0]
        self.msize = self.A.shape[1]
        self.mask = self._mod.mask

    # ---------------------------------------------------------------- value
    def data(self, mw):
        """Plain-residual data misfit (reference: inversion/reginv.py:248)."""
        r = self.Aw @ np.asarray(mw) - self.dobs
        return float(r @ r)

    def CG(self, initialModel, apriorModel, boundary, regularization="MS",
           beta=0.01, q=0.9, maxk=100):
        """Run the inversion (reference: inversion/reginv.py:357-491).

        Returns (model_inv, data_inv, data_misfit, model_misfit,
        regul_factor) — histories as numpy arrays trimmed to the performed
        iterations.
        """
        if regularization not in ("MS", "Damping", "Smoothness", "TV"):
            raise ValueError(
                "Please choose regularization from 'MS','Damping', "
                "'Smoothness', 'TV'.")
        rhomin, rhomax = boundary[0], boundary[1]
        mw0 = self.wdiag * np.asarray(initialModel, dtype=np.float64)
        apr = self.wdiag * np.asarray(apriorModel, dtype=np.float64)
        active3d = (self.mesh.active.reshape(self.mshape)
                    if not self.mesh.active.all() else None)
        solve = jax.jit(_make_cg_core(
            self.Aw, self.dobs, self.wdiag, self.wdiag_inv, self.mshape,
            active3d, regularization, beta, q, maxk, rhomin, rhomax,
            "normalized", self.dtype, aprior_mw=apr))
        mw_fin, d_h, m_h, r_h, n_it = solve(mw0, np.ones(self.dsize))
        n_it = int(n_it)
        model_inv = self.wdiag_inv * np.asarray(mw_fin, dtype=np.float64)
        data_inv = self.A @ model_inv
        return (model_inv, data_inv,
                np.asarray(d_h, dtype=np.float64)[:n_it],
                np.asarray(m_h, dtype=np.float64)[:n_it],
                np.asarray(r_h, dtype=np.float64)[:n_it])


class BootStrap:
    """Bootstrap uncertainty via vmapped weighted re-inversions
    (reference: inversion/reginv.py:494-748)."""

    def __init__(self, mrange, mspacing, obsurface, dobs, boundary,
                 samples=100, beta=0.01, maxk=100, mratio=1, njobs=1,
                 wavelet=False, dtype=jnp.float64, verbose=True, **kwargs):
        self._mod = GravMagModule(
            dobs, mrange, mspacing, obsurface, mratio=mratio,
            weightfactor=0.5, coordinate="cartesian", field="gravity",
            njobs=njobs, wavelet=wavelet, dtype=dtype, verbose=verbose,
            **kwargs)
        self.dtype = dtype
        self.dobs = np.asarray(dobs, dtype=np.float64)
        self.boundary = boundary
        self.samples = samples
        self.beta = beta
        self.maxk = maxk
        self.mesh = self._mod.mesh
        self.mshape = self._mod.mshape
        self.mxs = self._mod.mxs
        self.mys = self._mod.mys
        self.mzs = self._mod.mzs
        self.A = self._mod.A
        self.Aw = self._mod.Aw
        self.wdiag = self._mod.wdiag
        self.wdiag_inv = self._mod.wdiag_inv
        self.dsize = self.A.shape[0]
        self.msize = self.A.shape[1]
        self.mask = self._mod.mask

    def resample_weights(self):
        """(samples, D) row-multiplicity matrix reproducing the reference's
        seeded with-replacement draws (reference: inversion/reginv.py:727-738
        uses np.random.seed(sample); np.random.choice)."""
        weights = np.zeros((self.samples, self.dsize))
        for s in range(self.samples):
            rng = np.random.RandomState(s)
            idx = rng.choice(np.arange(self.dsize), size=self.dsize,
                             replace=True)
            weights[s] = np.bincount(idx, minlength=self.dsize)
        return weights

    def BSCG(self, initialModel, batch=None):
        """Run ``samples`` bootstrap re-inversions as vmapped batches.

        Returns (model_inv_all, data_misfit_all, model_misfit_all,
        regul_factor_all) like the reference (histories over maxk-1 /
        maxk entries, NaN-padded after early stop).
        """
        rhomin, rhomax = self.boundary[0], self.boundary[1]
        mw0 = self.wdiag * np.asarray(initialModel, dtype=np.float64)
        solve = _make_cg_core(
            self.Aw, self.dobs, self.wdiag, self.wdiag_inv, self.mshape,
            None, "MS", self.beta, 0.9, self.maxk, rhomin, rhomax,
            "absolute", self.dtype, bootstrap_ms=True)
        vsolve = jax.jit(jax.vmap(solve, in_axes=(None, 0)))
        weights = self.resample_weights()
        batch = batch or self.samples
        models, d_hists, m_hists, r_hists = [], [], [], []
        for s0 in range(0, self.samples, batch):
            w = weights[s0: s0 + batch]
            mw_fin, d_h, m_h, r_h, _ = vsolve(mw0, w)
            models.append(np.asarray(mw_fin, dtype=np.float64)
                          * self.wdiag_inv[None, :])
            d_hists.append(np.asarray(d_h, dtype=np.float64))
            m_hists.append(np.asarray(m_h, dtype=np.float64))
            r_hists.append(np.asarray(r_h, dtype=np.float64))
        return (np.concatenate(models),
                np.concatenate(d_hists)[:, 1:],
                np.concatenate(m_hists)[:, 1:],
                np.concatenate(r_hists))
