"""Posterior diagnostics: chain merging, R-hat, ESS, recovery metrics.

The reference computes only posterior mean/std and RMSD/RMSM in its plot
scripts (reference: example/uniformgrid/plot_uniform.py:101-155,
example/realdata/plot_real_multichain.py:111-121); this module adds the
standard MCMC convergence diagnostics (split-R-hat and autocorrelation
ESS, Vehtari et al. 2021 formulation) that the north-star metric tracks
(BASELINE.json: "ESS/s").
"""
from __future__ import annotations

import os

import numpy as np


def load_chains(save_folder, nchains, ndraws=0, myrank=0):
    """Load ``<save_folder><c>/model.dat`` for c in rank..rank+nchains-1,
    skipping ``ndraws`` warm-up lines, like the reference's plot scripts
    (reference: example/uniformgrid/plot_uniform.py:47-54)."""
    try:
        from .runtime.sink import read_matrix as _read
    except Exception:
        _read = np.loadtxt
    chains = []
    for c in range(myrank, myrank + nchains):
        path = os.path.join(f"{save_folder}{c}", "model.dat")
        m = np.atleast_2d(_read(path))
        chains.append(m[ndraws:])
    n = min(len(m) for m in chains)
    return np.stack([m[:n] for m in chains])  # (C, N, M)


def posterior_stats(chains):
    """Mean and std over all chains and draws; chains is (C, N, M)."""
    flat = chains.reshape(-1, chains.shape[-1])
    return flat.mean(axis=0), flat.std(axis=0)


def rmsd(dobs, dpre):
    """Root-mean-square data misfit
    (reference: example/uniformgrid/plot_uniform.py:152-153)."""
    dobs = np.asarray(dobs)
    dpre = np.asarray(dpre)
    return float(np.sqrt(np.mean((dobs - dpre) ** 2)))


def rmsm(model, truth):
    """Root-mean-square model recovery error
    (reference: example/uniformgrid/plot_uniform.py:154-155)."""
    model = np.asarray(model)
    truth = np.asarray(truth)
    return float(np.sqrt(np.mean((model - truth) ** 2)))


def split_rhat(chains):
    """Split potential-scale-reduction R-hat per parameter.

    ``chains`` is (C, N, M); each chain is split in half, giving 2C
    sequences. Values near 1 indicate convergence.
    """
    c, n, m = chains.shape
    half = n // 2
    seqs = np.concatenate([chains[:, :half], chains[:, half: 2 * half]])
    k, n2, _ = seqs.shape
    means = seqs.mean(axis=1)                      # (k, M)
    variances = seqs.var(axis=1, ddof=1)           # (k, M)
    w = variances.mean(axis=0)                     # within
    b = n2 * means.var(axis=0, ddof=1)             # between
    var_plus = (n2 - 1) / n2 * w + b / n2
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / w)
    return np.where(w == 0, 1.0, rhat)


def effective_sample_size(chains):
    """Autocorrelation-based ESS per parameter (Geyer initial-monotone
    estimator over the chain-averaged correlogram)."""
    c, n, m = chains.shape
    if n < 4:
        return np.full(m, float(c * n))
    centered = chains - chains.mean(axis=1, keepdims=True)
    # FFT autocovariance per chain/parameter
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(centered, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real
    acov /= n
    var_plus = acov[:, 0].mean(axis=0) * n / (n - 1)
    rho = 1.0 - (acov[:, 0].mean(axis=0) - acov.mean(axis=0)) / \
        np.where(var_plus == 0, 1.0, var_plus)
    ess = np.empty(m)
    for j in range(m):
        if var_plus[j] == 0:
            ess[j] = c * n
            continue
        # pair sums until the first negative pair (initial positive seq.)
        t = 1
        s = 0.0
        while t + 1 < n:
            pair = rho[t, j] + rho[t + 1, j]
            if pair < 0:
                break
            s += pair
            t += 2
        tau = 1.0 + 2.0 * s
        ess[j] = c * n / max(tau, 1.0)
    return ess


def ess_jax(chains):
    """``effective_sample_size`` computed entirely on device.

    ``chains`` is a (C, N, K) jax array; returns a (K,) device array of
    total-ESS values (same Geyer initial-positive-sequence estimator as the
    numpy version, with the stopping rule vectorized as a cumulative
    positivity mask). Intended for runs that keep the sample buffer on
    the device; callers pull back only a reduced scalar.
    """
    import jax.numpy as jnp

    c, n, k = chains.shape
    if n < 4:
        return jnp.full((k,), float(c * n))
    centered = chains - jnp.mean(chains, axis=1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = jnp.fft.rfft(centered, nfft, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), nfft, axis=1)[:, :n].real / n
    var0 = jnp.mean(acov[:, 0], axis=0)                     # (K,)
    var_plus = var0 * n / (n - 1)
    safe = jnp.where(var_plus == 0, 1.0, var_plus)
    rho = 1.0 - (var0[None, :] - jnp.mean(acov, axis=0)) / safe  # (n, K)
    # Geyer pairs rho_{2j+1} + rho_{2j+2}; include while all previous
    # pairs were non-negative (cumulative mask replaces the while-loop)
    npairs = (n - 1) // 2
    pairs = (rho[1:1 + 2 * npairs].reshape(npairs, 2, k).sum(axis=1))
    keep = jnp.cumprod((pairs >= 0).astype(rho.dtype), axis=0)
    tau = jnp.maximum(1.0 + 2.0 * jnp.sum(pairs * keep, axis=0), 1.0)
    return jnp.where(var_plus == 0, float(c * n), c * n / tau)


def summarize(chains, dobs=None, dpre=None, truth=None, post_mean=None):
    """One-stop posterior summary dict."""
    mean, std = posterior_stats(chains)
    out = {
        "n_chains": chains.shape[0],
        "n_samples": chains.shape[1],
        "rhat_max": float(np.nanmax(split_rhat(chains))),
        "ess_min": float(np.nanmin(effective_sample_size(chains))),
        "ess_mean": float(np.nanmean(effective_sample_size(chains))),
    }
    if dobs is not None and dpre is not None:
        out["RMSD"] = rmsd(dobs, dpre)
    if truth is not None:
        out["RMSM"] = rmsm(post_mean if post_mean is not None else mean,
                           truth)
    return out
