"""Convergence diagnostics: effective sample size and split-Rhat.

Implements the rank-normalized split-chain diagnostics of Vehtari et al.
(2021), matching ArviZ's ``ess(method="bulk")`` / ``rhat`` definitions so the
acceptance gates from the reference docs (min ESS > 500, Rhat <= 1.02 on the
radon model, ``docs/stan-usage.qmd:207-211``) carry over.  Used by the test
suite and ``bench.py``; ArviZ itself is an optional dependency.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtri
from scipy.stats import rankdata


def _split_chains(x: np.ndarray) -> np.ndarray:
    """[chains, draws] -> [2*chains, draws//2]"""
    c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    # Average ranks for ties (Vehtari et al. 2021 / ArviZ definition) —
    # ordinal ranks deviate on integer-valued series like tree depth.
    shape = x.shape
    flat = x.reshape(-1)
    ranks = rankdata(flat, method="average")
    z = ndtri((ranks - 0.375) / (flat.size + 0.25))
    return z.reshape(shape)


def _autocovariance(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance via FFT; x is [chains, draws]."""
    c, n = x.shape
    x = x - x.mean(axis=1, keepdims=True)
    m = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n].real
    return acov / n


def ess_from_samples(x: np.ndarray) -> float:
    """Bulk ESS for one scalar quantity, x shaped [chains, draws]."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    x = _split_chains(x)
    if not np.all(np.isfinite(x)):
        return float("nan")
    if np.allclose(x, x.ravel()[0]):
        return float("nan")
    x = _rank_normalize(x)
    c, n = x.shape
    acov = _autocovariance(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = np.mean(chain_var)
    var_plus = mean_var * (n - 1.0) / n + np.var(x.mean(axis=1), ddof=1 if c > 1 else 0)
    rho = 1.0 - (mean_var - np.mean(acov, axis=0)) / var_plus

    # Geyer initial monotone positive sequence
    rho_even = rho[0::2]
    rho_odd = rho[1::2]
    k = min(len(rho_even), len(rho_odd))
    p = rho_even[:k] + rho_odd[:k]
    # find first negative pair
    mask = p > 0
    if not mask[0]:
        t = 1
    else:
        idx = np.where(~mask)[0]
        t = idx[0] if len(idx) else k
    p = p[:t]
    # enforce monotone decreasing
    p = np.minimum.accumulate(p)
    tau = -1.0 + 2.0 * np.sum(p)
    tau = max(tau, 1.0 / np.log10(c * n + 10))
    return float(c * n / tau)


def rhat_from_samples(x: np.ndarray) -> float:
    """Rank-normalized split-Rhat for one scalar quantity [chains, draws]."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    x = _split_chains(x)
    if not np.all(np.isfinite(x)) or np.allclose(x, x.ravel()[0]):
        return float("nan")
    x = _rank_normalize(x)
    c, n = x.shape
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    between = n * np.var(chain_means, ddof=1)
    within = np.mean(chain_vars)
    var_plus = (n - 1.0) / n * within + between / n
    return float(np.sqrt(var_plus / within))


def _iter_scalars(samples: np.ndarray):
    """samples [chains, draws, *shape] -> iterate scalar series."""
    if samples.ndim == 2:
        yield samples
        return
    flat = samples.reshape(samples.shape[0], samples.shape[1], -1)
    for i in range(flat.shape[-1]):
        yield flat[..., i]


def ess(samples: np.ndarray) -> np.ndarray:
    """Bulk ESS per scalar element; samples [chains, draws, *shape]."""
    out = np.array([ess_from_samples(s) for s in _iter_scalars(samples)])
    if samples.ndim <= 2:
        return out[0]
    return out.reshape(samples.shape[2:])


def rhat(samples: np.ndarray) -> np.ndarray:
    out = np.array([rhat_from_samples(s) for s in _iter_scalars(samples)])
    if samples.ndim <= 2:
        return out[0]
    return out.reshape(samples.shape[2:])
