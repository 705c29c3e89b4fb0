"""Warmup adaptation: step size + diagonal mass matrix, batched over chains.

Same semantics as ``nutpie_tpu/sampler/adapt.py``: dual averaging toward
``target_accept`` (with the Adam and fixed-step alternatives), nutpie's
gradient-based diagonal estimate ``sqrt(var(draw) / var(grad))`` from a
current/background pair of Welford accumulators that swap on the window
schedule, the per-draw rate limit on the metric with the matched step-size
shift, and cross-chain pooling at chunk boundaries.

State lives in the packed ``adapt_vecs [C, 9, dim]`` / ``adapt_flts
[C, 12]`` tensors (``state.py``); the functions here take and return them
whole, computing new values for every chain (callers mask).  The CUDA
chunk kernel carries the per-draw update as a device function
(``csrc/adapt.cuh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from .state import ADAPT_FLT_SLOTS, ADAPT_VEC_SLOTS, N_ADAPT_FLT, N_ADAPT_VEC, WELFORD

_DA = ("log_step", "log_step_bar", "hbar", "mu", "da_count")
_ADAM = ("adam_m", "adam_v", "adam_count")


class Schedule(NamedTuple):
    """Warmup-schedule scalars.

    ``depth_cap`` is the fleet-relative tree-depth cap (see
    ``run.fleet_depth_cap``); it may be a 0-d int32 tensor on the device,
    so updating it between chunks needs no host round trip.  ``2**30``
    (above any maxdepth) is inert.
    """

    num_tune: int
    early_end: int
    freeze_start: int
    depth_cap: object


def make_schedule(cfg: "AdaptConfig", num_tune: int, depth_cap=None) -> Schedule:
    return Schedule(
        num_tune=int(num_tune),
        early_end=int(cfg.early_phase_share * num_tune),
        freeze_start=int(num_tune - int(cfg.freeze_share * num_tune)),
        depth_cap=2 ** 30 if depth_cap is None else depth_cap,
    )


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Static adaptation configuration, derived from settings."""

    num_tune: int
    target_accept: float = 0.8
    initial_step: float = 0.1
    # dual averaging
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75
    max_step_size: float = 100.0
    # step size method: "dual_average" | "adam" | float (fixed)
    method: object = "dual_average"
    adam_lr: float = 0.05
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    step_size_jitter: Optional[float] = None
    # mass matrix windows
    switch_freq: int = 80
    early_switch_freq: int = 10
    early_phase_share: float = 0.3
    freeze_share: float = 0.1
    use_grad_based_estimate: bool = True
    update_mass_matrix: bool = True
    # clipping for the variance estimate
    min_variance: float = 1e-12
    max_variance: float = 1e12


# ------------------------------------------------------------- packing


def flts_get(adapt_flts: torch.Tensor, names) -> dict:
    return {n: adapt_flts[:, ADAPT_FLT_SLOTS[n]] for n in names}


def flts_set(adapt_flts: torch.Tensor, values: dict) -> torch.Tensor:
    out = adapt_flts.clone()
    for n, v in values.items():
        out[:, ADAPT_FLT_SLOTS[n]] = v
    return out


# ------------------------------------------------------------- Welford


def welford_add(mean, m2, count, x):
    """One draw into a batched accumulator (``mean/m2 [C, dim]``, ``count [C]``)."""
    count = count + 1
    delta = x - mean
    mean = mean + delta / count[:, None]
    m2 = m2 + delta * (x - mean)
    return mean, m2, count


def welford_variance(m2, count):
    return m2 / torch.clamp(count - 1, min=1)[:, None]


# ------------------------------------------------------------- step size


def dual_avg_init(cfg: AdaptConfig, n_chains: int, dtype, device) -> dict:
    log_step = torch.full((n_chains,), math.log(cfg.initial_step), dtype=dtype,
                          device=device)
    zero = torch.zeros_like(log_step)
    return {
        "log_step": log_step,
        "log_step_bar": log_step,
        "hbar": zero,
        "mu": math.log(10.0) + log_step,
        "da_count": zero,
    }


def dual_avg_update(cfg: AdaptConfig, da: dict, accept: torch.Tensor) -> dict:
    count = da["da_count"] + 1
    w = 1.0 / (count + cfg.t0)
    hbar = (1.0 - w) * da["hbar"] + w * (cfg.target_accept - accept)
    log_step = da["mu"] - torch.sqrt(count) / cfg.gamma * hbar
    # trust region with an escape hatch (see nutpie_tpu/sampler/adapt.py):
    # the per-draw increase is capped at x2 unless the step crashed far
    # below its running average
    crashed = da["log_step"] < da["log_step_bar"] - math.log(8.0)
    cap = torch.where(
        crashed, torch.full_like(log_step, math.inf),
        da["log_step"] + math.log(2.0),
    )
    log_step = torch.minimum(log_step, cap)
    log_step = torch.clamp(log_step, max=math.log(cfg.max_step_size))
    eta = count ** (-cfg.kappa)
    log_step_bar = eta * log_step + (1.0 - eta) * da["log_step_bar"]
    return {
        "log_step": log_step,
        "log_step_bar": log_step_bar,
        "hbar": hbar,
        "mu": da["mu"],
        "da_count": count,
    }


def dual_avg_restart(da: dict) -> dict:
    """Soft restart after a mass-matrix switch (mu re-centers a factor 2 up)."""
    return {
        "log_step": da["log_step"],
        "log_step_bar": da["log_step_bar"],
        "hbar": torch.zeros_like(da["hbar"]),
        "mu": math.log(2.0) + da["log_step"],
        "da_count": torch.zeros_like(da["da_count"]),
    }


def adam_update(cfg: AdaptConfig, adam: dict, da: dict, accept: torch.Tensor):
    """Adam on log step size with gradient (target - accept)."""
    g = cfg.target_accept - accept
    count = adam["adam_count"] + 1
    m = cfg.adam_beta1 * adam["adam_m"] + (1 - cfg.adam_beta1) * g
    v = cfg.adam_beta2 * adam["adam_v"] + (1 - cfg.adam_beta2) * g * g
    mhat = m / (1 - cfg.adam_beta1 ** count)
    vhat = v / (1 - cfg.adam_beta2 ** count)
    log_step = da["log_step"] - cfg.adam_lr * mhat / (torch.sqrt(vhat) + 1e-8)
    log_step = torch.minimum(log_step, da["log_step"] + math.log(2.0))
    log_step = torch.clamp(log_step, max=math.log(cfg.max_step_size))
    eta = count ** (-cfg.kappa)
    log_step_bar = eta * log_step + (1.0 - eta) * da["log_step_bar"]
    new_da = dict(da, log_step=log_step, log_step_bar=log_step_bar,
                  da_count=da["da_count"] + 1)
    return {"adam_m": m, "adam_v": v, "adam_count": count}, new_da


# ------------------------------------------------------------- mass matrix


def init_inv_mass_from_gradient(gradient: torch.Tensor) -> torch.Tensor:
    """Gradient-informed initial diagonal: sigma_i^2 ~ 1 / g_i^2, clipped."""
    g2 = gradient * gradient
    var = torch.where(g2 > 0, 1.0 / torch.clamp(g2, min=1e-12),
                      torch.ones_like(g2))
    return torch.clamp(var, 1e-6, 1e6)


def diag_adapt_init(cfg: AdaptConfig, gradient: torch.Tensor, dtype):
    """Initial ``(adapt_vecs, adapt_flts)`` for a batch of chains."""
    n, dim = gradient.shape
    device = gradient.device
    vecs = torch.zeros((n, N_ADAPT_VEC, dim), dtype=dtype, device=device)
    vecs[:, ADAPT_VEC_SLOTS["inv_mass"]] = init_inv_mass_from_gradient(gradient).to(dtype)
    flts = torch.zeros((n, N_ADAPT_FLT), dtype=dtype, device=device)
    flts = flts_set(flts, dual_avg_init(cfg, n, dtype, device))
    return vecs, flts


def _estimate_inv_mass(cfg: AdaptConfig, draws, grads, fallback):
    d_mean, d_m2, d_count = draws
    g_mean, g_m2, g_count = grads
    draw_var = welford_variance(d_m2, d_count)
    if cfg.use_grad_based_estimate:
        grad_var = welford_variance(g_m2, g_count)
        est = torch.sqrt(
            torch.clamp(draw_var, min=cfg.min_variance)
            / torch.clamp(grad_var, min=cfg.min_variance)
        )
    else:
        # Stan-style shrinkage toward unit scale
        n = d_count[:, None]
        est = (n / (n + 5.0)) * draw_var + 1e-3 * (5.0 / (n + 5.0))
    est = torch.clamp(est, cfg.min_variance, cfg.max_variance)
    ok = (d_count > 2) & torch.all(torch.isfinite(est), dim=1)
    return torch.where(ok[:, None], est, fallback)


def diag_adapt_update(cfg: AdaptConfig, sched: Schedule, adapt_vecs, adapt_flts,
                      draw_idx, position, gradient, accept, diverging):
    """Per-draw adaptation update for every chain (callers mask to tuning draws).

    ``draw_idx`` int32 ``[C]``, ``position``/``gradient`` ``[C, dim]``,
    ``accept`` ``[C]``, ``diverging`` bool ``[C]``.  Returns new
    ``(adapt_vecs, adapt_flts)``.
    """
    da = flts_get(adapt_flts, _DA)
    adam = flts_get(adapt_flts, _ADAM)
    # -- step size
    if isinstance(cfg.method, (int, float)):
        log_fixed = torch.full_like(da["log_step"], math.log(float(cfg.method)))
        da = dict(da, log_step=log_fixed, log_step_bar=log_fixed)
    elif cfg.method == "adam":
        adam, da = adam_update(cfg, adam, da, accept)
    else:
        da = dual_avg_update(cfg, da, accept)

    # -- mass matrix accumulators (skip divergent and nonfinite draws)
    ok = (
        ~diverging
        & torch.all(torch.isfinite(position), dim=1)
        & torch.all(torch.isfinite(gradient), dim=1)
    )
    old_inv_mass = adapt_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]]
    acc = {}
    for name, (mi, vi, ci) in WELFORD.items():
        x = position if name.startswith("draws") else gradient
        mean, m2, count = adapt_vecs[:, mi], adapt_vecs[:, vi], adapt_flts[:, ci]
        n_mean, n_m2, n_count = welford_add(mean, m2, count, x)
        acc[name] = (
            torch.where(ok[:, None], n_mean, mean),
            torch.where(ok[:, None], n_m2, m2),
            torch.where(ok, n_count, count),
        )

    # -- window schedule
    frozen = draw_idx >= sched.freeze_start
    freq = torch.where(
        draw_idx < sched.early_end,
        torch.full_like(draw_idx, cfg.early_switch_freq),
        torch.full_like(draw_idx, cfg.switch_freq),
    )
    switch = (~frozen) & (draw_idx > 0) & (torch.remainder(draw_idx + 1, freq) == 0)

    # switch first (current <- background, background <- fresh), so the new
    # window's estimate, the step-size correction and the dual-averaging
    # restart land on the same draw
    for kind in ("draws", "grads"):
        cur, bg = acc[f"{kind}_cur"], acc[f"{kind}_bg"]
        acc[f"{kind}_cur"] = tuple(
            torch.where(switch.reshape((-1,) + (1,) * (c.dim() - 1)), b, c)
            for c, b in zip(cur, bg)
        )
        acc[f"{kind}_bg"] = tuple(
            torch.where(switch.reshape((-1,) + (1,) * (b.dim() - 1)),
                        torch.zeros_like(b), b)
            for b in bg
        )

    # rate-limited estimate from the current window
    if cfg.update_mass_matrix:
        inv_mass = _estimate_inv_mass(
            cfg, acc["draws_cur"], acc["grads_cur"], old_inv_mass
        )
        inv_mass = torch.clamp(inv_mass, old_inv_mass * 0.5, old_inv_mass * 2.0)
        inv_mass = torch.where(frozen[:, None], old_inv_mass, inv_mass)
    else:
        inv_mass = old_inv_mass

    # matched step-size correction for the stability margin lost
    ratio = torch.amax(
        inv_mass / torch.clamp(old_inv_mass, min=cfg.min_variance), dim=1
    )
    shift = -0.5 * torch.log(torch.clamp(ratio, 1.0, 2.0))
    da = dict(da, log_step=da["log_step"] + shift, mu=da["mu"] + shift)

    # soft-restart dual averaging when the window switched
    restarted = dual_avg_restart(da)
    da = {k: torch.where(switch, restarted[k], v) for k, v in da.items()}

    new_vecs = adapt_vecs.clone()
    new_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]] = inv_mass
    flt_values = dict(da, **adam)
    for name, (mi, vi, ci) in WELFORD.items():
        mean, m2, count = acc[name]
        new_vecs[:, mi] = mean
        new_vecs[:, vi] = m2
        flt_values[f"{name}_count"] = count
    return new_vecs, flts_set(adapt_flts, flt_values)


def pool_adapt_state(adapt_vecs, adapt_flts, pool_mass: bool = True,
                     pool_step: bool = False):
    """Pool adaptation state across chains (chunk-boundary collective).

    ``pool_mass`` combines the Welford accumulators over the chains axis
    (pooled mean, within + between m2, mean count); ``pool_step`` averages
    the dual-averaging log step sizes (a geometric mean of the steps).
    """
    n_chains = adapt_vecs.shape[0]
    vecs, flts = adapt_vecs.clone(), adapt_flts.clone()
    if pool_mass:
        for mi, vi, ci in WELFORD.values():
            count = adapt_flts[:, ci]
            mean_c = adapt_vecs[:, mi]
            total = torch.sum(count)
            mean = torch.sum(mean_c * count[:, None], dim=0) / torch.clamp(total, min=1)
            m2 = torch.sum(
                adapt_vecs[:, vi] + count[:, None] * torch.square(mean_c - mean),
                dim=0,
            )
            vecs[:, mi] = mean
            vecs[:, vi] = m2 / n_chains
            flts[:, ci] = total / n_chains
    if pool_step:
        for name in ("log_step", "log_step_bar", "hbar", "mu"):
            slot = ADAPT_FLT_SLOTS[name]
            flts[:, slot] = torch.mean(adapt_flts[:, slot])
    return vecs, flts
