"""Convergence diagnostics on the tensor's device (torch implementations).

Same algorithms as :mod:`nutpie_tpu_torch.diagnostics` (rank-normalized
split-chain bulk ESS and R-hat, Vehtari et al. 2021), written in torch so
they run where the draws are, over the full draw buffers, without copying
them to the host first.  Ported from ``nutpie_tpu/diagnostics_device.py``:
the ranks come from one ``torch.sort`` and the runs of equal values in it
(average ranks for ties, as ``scipy.stats.rankdata(method="average")``),
the autocovariance from ``torch.fft``.  As there, a non-finite value ranks
as the largest and each NaN as its own run, so a series with NaN or
infinite values still gets a number.
"""

from __future__ import annotations

import math

import torch


def _split_chains(x: torch.Tensor) -> torch.Tensor:
    """[chains, draws] -> [2*chains, draws//2]"""
    c, n = x.shape
    half = n // 2
    return torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)


def _rank_normalize(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    n = flat.numel()
    sv, order = torch.sort(flat, stable=True)
    idx = torch.arange(n, device=x.device)
    # first and last index of each run of equal values, over the run
    run_start = torch.ones(n, dtype=torch.bool, device=x.device)
    run_start[1:] = sv[1:] != sv[:-1]
    first = torch.cummax(torch.where(run_start, idx, 0), dim=0).values
    run_end = torch.ones_like(run_start)
    run_end[:-1] = run_start[1:]
    last = torch.flip(torch.cummin(torch.flip(torch.where(run_end, idx, n - 1), (0,)),
                                   dim=0).values, (0,))
    ranks = torch.empty_like(flat)
    ranks[order] = 0.5 * (first + last).to(flat.dtype) + 1.0
    return torch.special.ndtri((ranks - 0.375) / (n + 0.25)).reshape(x.shape)


def _autocovariance(x: torch.Tensor) -> torch.Tensor:
    c, n = x.shape
    x = x - x.mean(dim=1, keepdim=True)
    m = 1 << max(1, 2 * n - 1).bit_length()
    f = torch.fft.rfft(x, m, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), m, dim=1)[:, :n]
    return acov / n


def _as_float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def ess_bulk(x) -> torch.Tensor:
    """Bulk ESS of one scalar series ``[chains, draws]`` (0-d tensor)."""
    x = _rank_normalize(_split_chains(_as_float(x)))
    c, n = x.shape
    acov = _autocovariance(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = torch.mean(chain_var)
    var_plus = mean_var * (n - 1.0) / n + torch.var(x.mean(dim=1), correction=1)
    rho = 1.0 - (mean_var - torch.mean(acov, dim=0)) / var_plus
    rho_even, rho_odd = rho[0::2], rho[1::2]
    k = min(rho_even.shape[0], rho_odd.shape[0])
    p = rho_even[:k] + rho_odd[:k]
    # Geyer's initial positive and monotone sequence
    arange = torch.arange(k, device=x.device)
    nonpos = ~(p > 0)
    t = torch.where(nonpos.any(), torch.clamp(torch.argmax(nonpos.to(torch.int8)), min=1),
                    torch.tensor(k, device=x.device))
    masked = torch.where(arange < t, p, torch.full_like(p, math.inf))
    dec = torch.where(arange < t, torch.cummin(masked, dim=0).values, torch.zeros_like(p))
    tau = -1.0 + 2.0 * torch.sum(dec)
    tau = torch.clamp(tau, min=1.0 / math.log10(c * n + 10.0))
    ess = c * n / tau
    return torch.where(torch.isfinite(x).all(), ess, torch.full_like(ess, math.nan))


def rhat(x) -> torch.Tensor:
    """Rank-normalized split R-hat of one scalar series ``[chains, draws]``."""
    x = _rank_normalize(_split_chains(_as_float(x)))
    c, n = x.shape
    within = torch.mean(x.var(dim=1, correction=1))
    between = n * torch.var(x.mean(dim=1), correction=1)
    var_plus = (n - 1.0) / n * within + between / n
    r = torch.sqrt(var_plus / within)
    return torch.where(torch.isfinite(x).all(), r, torch.full_like(r, math.nan))


def min_ess_over_columns(draws: torch.Tensor, cols, max_cols: int = 32) -> torch.Tensor:
    """Min bulk ESS over the first ``max_cols`` of the columns ``cols`` of
    ``draws [chains, n, dim]`` (NaN-ignoring)."""
    cols = torch.as_tensor(cols, device=draws.device)[:max_cols]
    esses = torch.stack([ess_bulk(draws[:, :, int(j)]) for j in cols.tolist()])
    finite = esses[~torch.isnan(esses)]
    return finite.min() if finite.numel() else esses.new_tensor(math.nan)
