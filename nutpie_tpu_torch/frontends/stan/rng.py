"""Random draws for Stan's ``_rng`` functions, on Threefry key data.

A key is raw Threefry key data (int64 ``[2]``, ``ops/threefry.py``), so
keys, splits and fold-ins are bit-equal to ``jax.random``'s.  Draws that
``jax.random`` computes in closed form from uniforms or normals
(``uniform``, ``normal``, ``exponential``, ``logistic``, ``bernoulli``,
``categorical``) follow its formulas.  ``jax.random``'s rejection samplers
(gamma, beta, Poisson, binomial, Student-t, Dirichlet) and ``randint``
loop until the data say stop; here each runs a fixed number of rounds
with masking, so a draw makes no host sync and can be captured.  These
agree with ``jax.random`` in distribution, not draw by draw.

Every function evaluates in the dtype and on the device of the running
``xp.evaluation``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops import threefry
from . import xp


_NP = {torch.float64: np.float64, torch.float32: np.float32}


def split(kd, n: int = 2):
    return tuple(threefry.split(kd, n).unbind(-2))


def fold_in(kd, data):
    return threefry.fold_in_data(kd, data)


def _unit_uniform(kd, shape, dtype):
    """``jax.random``'s ``[0, 1)`` floats: the mantissa bits scaled, which
    equals its bit-cast of ``1.m`` minus 1 exactly, without the bit-cast
    vmap cannot batch."""
    if dtype == torch.float64:
        return threefry._mantissa64(kd, shape).to(torch.float64) * 2.0 ** -52
    return ((threefry.random_bits32(kd, shape) >> 9).to(torch.float32) * 2.0 ** -23).to(dtype)


def uniform(kd, shape=(), minval=0.0, maxval=1.0):
    dt = xp.fdtype()
    lo, hi = xp.asarray(minval, dt), xp.asarray(maxval, dt)
    floats = _unit_uniform(kd, tuple(shape), dt)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(kd, shape=()):
    """``jax.random.normal``: sqrt(2) erfinv(u), u uniform on (-1, 1)."""
    dt = xp.fdtype()
    lo = float(np.nextafter(np.dtype(_NP[dt]).type(-1.0), np.dtype(_NP[dt]).type(0.0)))
    u = uniform(kd, shape, lo, 1.0)
    return torch.full((), math.sqrt(2), dtype=dt, device=u.device) * threefry.erfinv(u)


def exponential(kd, shape=()):
    return -torch.log1p(-uniform(kd, shape))


def logistic(kd, shape=()):
    x = uniform(kd, shape, torch.finfo(xp.fdtype()).tiny, 1.0)
    return torch.log(x) - torch.log1p(-x)


def bernoulli(kd, p, shape=()):
    return uniform(kd, shape) < xp.asarray(p)


def categorical(kd, logits, axis=-1):
    logits = xp._f(logits)
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(uniform(kd, tuple(logits.shape), tiny, 1.0)))
    return torch.argmax(gumbel + logits, dim=axis)


# rounds of each rejection sampler: every round accepts with probability
# above 0.9 (Marsaglia-Tsang above 0.95, PTRS/BTRS above 0.9), so 24 rounds
# leave a draw unaccepted with probability below 1e-24
_ROUNDS = 24
# terms of the inversion samplers for small means (Poisson below 10, a
# binomial with n * min(p, 1 - p) below 10): the tail past 64 is below 1e-25
_INVERSION_TERMS = 64


def _gamma_one_plus(kd, a, shape):
    """Marsaglia-Tsang for shape ``a >= 1``: ``_ROUNDS`` candidates, the
    first accepted one kept."""
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.ones(shape, dtype=a.dtype, device=a.device) * d
    done = torch.zeros(shape, dtype=torch.bool, device=a.device)
    for r in range(_ROUNDS):
        kr = fold_in(kd, r)
        kx, ku = split(kr)
        x = normal(kx, shape)
        v = (1.0 + c * x) ** 3
        u = uniform(ku, shape)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        take = ok & ~done
        out = torch.where(take, d * v, out)
        done = done | ok
    return out


def gamma(kd, a, shape=()):
    """Gamma(a, 1); shapes below 1 boosted: G(a) = G(a + 1) U^(1/a)."""
    shape = tuple(shape)
    a = torch.broadcast_to(xp._f(a), shape)
    k_main, k_boost = split(kd)
    small = a < 1.0
    g = _gamma_one_plus(k_main, torch.where(small, a + 1.0, a), shape)
    u = uniform(k_boost, shape, torch.finfo(a.dtype).tiny, 1.0)
    return torch.where(small, g * u ** (1.0 / a), g)


def beta(kd, a, b, shape=()):
    ka, kb = split(kd)
    ga = gamma(ka, a, shape)
    gb = gamma(kb, b, shape)
    return ga / (ga + gb)


def dirichlet(kd, alpha):
    alpha = xp._f(alpha)
    g = gamma(kd, alpha, tuple(alpha.shape))
    return g / g.sum(-1, keepdim=True)


def t(kd, df, shape=()):
    kn, kg = split(kd)
    n = normal(kn, shape)
    two = 2.0 * gamma(kg, xp._f(df) / 2.0, shape)
    return n * torch.sqrt(xp._f(df) / two)


def _count_by_inversion(u, log_pmf0, log_ratio):
    """Smallest k with F(k) >= u for a count whose pmf starts at
    ``exp(log_pmf0)`` and whose ratio p(k) / p(k - 1) is
    ``exp(log_ratio(k))``; ``_INVERSION_TERMS`` terms."""
    log_p = log_pmf0
    cdf = torch.exp(log_p)
    k = torch.zeros_like(u)
    for j in range(1, _INVERSION_TERMS):
        k = k + (cdf < u).to(u.dtype)
        log_p = log_p + log_ratio(j)
        cdf = cdf + torch.exp(log_p)
    return k


def poisson(kd, lam, shape=()):
    """Poisson(lam): inversion below a mean of 10, PTRS (Hormann 1993) above."""
    shape = tuple(shape)
    lam = torch.broadcast_to(xp._f(lam), shape)
    k_inv, k_rej = split(kd)
    small = lam < 10.0
    lam_s = torch.where(small, lam, torch.ones_like(lam))
    u = uniform(k_inv, shape)
    log_lam = torch.log(lam_s)
    k_small = _count_by_inversion(u, -lam_s, lambda j: log_lam - math.log(j))

    lam_l = torch.where(small, torch.full_like(lam, 10.0), lam)
    log_l = torch.log(lam_l)
    b = 0.931 + 2.53 * torch.sqrt(lam_l)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2.0)
    out = torch.zeros_like(lam_l)
    done = torch.zeros(shape, dtype=torch.bool, device=lam.device)
    for r in range(_ROUNDS):
        ku, kv = split(fold_in(k_rej, r))
        uu = uniform(ku, shape) - 0.5
        v = uniform(kv, shape)
        us = 0.5 - torch.abs(uu)
        k = torch.floor((2.0 * a / us + b) * uu + lam_l + 0.43)
        fast = (us >= 0.07) & (v <= v_r)
        lhs = torch.log(v * inv_alpha / (a / (us * us) + b))
        rhs = -lam_l + k * log_l - torch.lgamma(k + 1.0)
        ok = (k >= 0) & (fast | ((us >= 0.013) | (v <= us)) & (lhs <= rhs))
        take = ok & ~done
        out = torch.where(take, k, out)
        done = done | ok
    return torch.where(small, k_small, out)


def binomial(kd, n, p, shape=()):
    """Binomial(n, p): inversion where n * min(p, 1 - p) is below 10, BTRS
    (Hormann 1993) above; drawn for q = min(p, 1 - p) and reflected."""
    shape = tuple(shape)
    n = torch.broadcast_to(xp._f(n), shape)
    p = torch.broadcast_to(xp._f(p), shape)
    flip = p > 0.5
    q = torch.where(flip, 1.0 - p, p)
    k_inv, k_rej = split(kd)
    small = n * q < 10.0
    q_s = torch.clamp(torch.where(small, q, torch.full_like(q, 0.25)), 1e-300, 0.5)
    u = uniform(k_inv, shape)
    log_odds = torch.log(q_s) - torch.log1p(-q_s)
    k_small = _count_by_inversion(
        u, n * torch.log1p(-q_s),
        lambda j: torch.log(torch.clamp(n - j + 1.0, min=0.0)) - math.log(j) + log_odds)
    k_small = torch.minimum(k_small, n)

    n_l = torch.where(small, torch.full_like(n, 100.0), n)
    q_l = torch.where(small, torch.full_like(q, 0.25), q)
    spq = torch.sqrt(n_l * q_l * (1.0 - q_l))
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * q_l
    c = n_l * q_l + 0.5
    v_r = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spq
    lpq = torch.log(q_l / (1.0 - q_l))
    m = torch.floor((n_l + 1.0) * q_l)
    h = torch.lgamma(m + 1.0) + torch.lgamma(n_l - m + 1.0)
    out = torch.zeros_like(n_l)
    done = torch.zeros(shape, dtype=torch.bool, device=n.device)
    for r in range(_ROUNDS):
        ku, kv = split(fold_in(k_rej, r))
        uu = uniform(ku, shape) - 0.5
        v = uniform(kv, shape)
        us = 0.5 - torch.abs(uu)
        k = torch.floor((2.0 * a / us + b) * uu + c)
        inside = (k >= 0) & (k <= n_l)
        fast = (us >= 0.07) & (v <= v_r)
        lv = torch.log(v * alpha / (a / (us * us) + b))
        kc = torch.clamp(k, torch.zeros_like(n_l), n_l)
        rhs = h - torch.lgamma(kc + 1.0) - torch.lgamma(n_l - kc + 1.0) + (kc - m) * lpq
        ok = inside & (fast | (lv <= rhs))
        take = ok & ~done
        out = torch.where(take, k, out)
        done = done | ok
    k = torch.where(small, k_small, out)
    return torch.where(flip, n - k, k)


def randint(kd, shape, lo, hi):
    """Uniform integers on ``[lo, hi)`` from one uniform each."""
    lo_t, hi_t = xp.asarray(lo), xp.asarray(hi)
    span = (hi_t - lo_t).to(xp.fdtype())
    u = uniform(kd, shape)
    k = torch.floor(u * span).to(torch.int64)
    return lo_t + torch.minimum(k, (hi_t - lo_t - 1))
