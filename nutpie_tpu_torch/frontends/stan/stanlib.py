"""Stan math library and distribution implementations over torch.

Written against ``xp``, the interpreter's array namespace over torch, so
each function reads as its formula; ``rng`` holds the random draws.

Value conventions: scalars are 0-d, Stan ``vector`` is a 1-D array,
``row_vector`` is a 2-D ``(1, n)`` array, ``matrix`` is 2-D; array types
prepend leading axes.  Distributions return *elementwise* log densities
(including normalization constants); sampling statements sum them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng, xp
from .xp import special as sp

from .errors import StanCompileError

_LOG_SQRT_2PI = 0.9189385332046727  # log(sqrt(2*pi))


def _as_f(x):
    return xp.asarray(x, xp.fdtype())


# ----------------------------------------------------------------- densities

def normal_lpdf(y, mu, sigma):
    y, mu, sigma = _as_f(y), _as_f(mu), _as_f(sigma)
    z = (y - mu) / sigma
    return -0.5 * z * z - xp.log(sigma) - _LOG_SQRT_2PI


def std_normal_lpdf(y):
    y = _as_f(y)
    return -0.5 * y * y - _LOG_SQRT_2PI


def normal_lcdf(y, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    return sp.log_ndtr(z)

def normal_lccdf(y, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    return sp.log_ndtr(-z)


def normal_cdf(y, mu, sigma):
    return sp.ndtr((_as_f(y) - mu) / sigma)


def lognormal_lpdf(y, mu, sigma):
    y = _as_f(y)
    ly = xp.log(y)
    z = (ly - mu) / sigma
    return -0.5 * z * z - xp.log(sigma) - _LOG_SQRT_2PI - ly


def student_t_lpdf(y, nu, mu, sigma):
    y, nu, mu, sigma = _as_f(y), _as_f(nu), _as_f(mu), _as_f(sigma)
    z = (y - mu) / sigma
    return (
        sp.gammaln((nu + 1) / 2)
        - sp.gammaln(nu / 2)
        - 0.5 * xp.log(nu * xp.pi)
        - xp.log(sigma)
        - (nu + 1) / 2 * xp.log1p(z * z / nu)
    )


def cauchy_lpdf(y, mu, sigma):
    y, mu, sigma = _as_f(y), _as_f(mu), _as_f(sigma)
    z = (y - mu) / sigma
    return -xp.log(xp.pi) - xp.log(sigma) - xp.log1p(z * z)


def double_exponential_lpdf(y, mu, sigma):
    z = xp.abs(_as_f(y) - mu) / sigma
    return -xp.log(2.0) - xp.log(sigma) - z


def logistic_lpdf(y, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    return -z - xp.log(sigma) - 2.0 * xp.nn.softplus(-z)


def gumbel_lpdf(y, mu, beta):
    z = (_as_f(y) - mu) / beta
    return -xp.log(beta) - z - xp.exp(-z)


def exponential_lpdf(y, lam):
    return xp.log(lam) - lam * _as_f(y)


def gamma_lpdf(y, alpha, beta):
    y, alpha, beta = _as_f(y), _as_f(alpha), _as_f(beta)
    return (
        alpha * xp.log(beta) - sp.gammaln(alpha)
        + (alpha - 1) * xp.log(y) - beta * y
    )


def inv_gamma_lpdf(y, alpha, beta):
    y, alpha, beta = _as_f(y), _as_f(alpha), _as_f(beta)
    return (
        alpha * xp.log(beta) - sp.gammaln(alpha)
        - (alpha + 1) * xp.log(y) - beta / y
    )


def chi_square_lpdf(y, nu):
    y, nu = _as_f(y), _as_f(nu)
    return (
        (nu / 2 - 1) * xp.log(y) - y / 2
        - (nu / 2) * xp.log(2.0) - sp.gammaln(nu / 2)
    )


def beta_lpdf(y, alpha, beta):
    y, alpha, beta = _as_f(y), _as_f(alpha), _as_f(beta)
    return (
        (alpha - 1) * xp.log(y) + (beta - 1) * xp.log1p(-y)
        - sp.betaln(alpha, beta)
    )


def uniform_lpdf(y, lower, upper):
    y, lower, upper = _as_f(y), _as_f(lower), _as_f(upper)
    inside = (y >= lower) & (y <= upper)
    return xp.where(inside, -xp.log(upper - lower), -xp.inf)


def weibull_lpdf(y, alpha, sigma):
    y, alpha, sigma = _as_f(y), _as_f(alpha), _as_f(sigma)
    z = y / sigma
    return (
        xp.log(alpha) - xp.log(sigma)
        + (alpha - 1) * xp.log(z) - z**alpha
    )


def pareto_lpdf(y, y_min, alpha):
    y, y_min, alpha = _as_f(y), _as_f(y_min), _as_f(alpha)
    return xp.log(alpha) + alpha * xp.log(y_min) - (alpha + 1) * xp.log(y)


def bernoulli_lpmf(y, theta):
    y, theta = _as_f(y), _as_f(theta)
    return y * xp.log(theta) + (1 - y) * xp.log1p(-theta)


def bernoulli_logit_lpmf(y, alpha):
    y, alpha = _as_f(y), _as_f(alpha)
    return y * alpha - xp.nn.softplus(alpha)


def binomial_lpmf(y, n, theta):
    y, n, theta = _as_f(y), _as_f(n), _as_f(theta)
    return (
        sp.gammaln(n + 1) - sp.gammaln(y + 1) - sp.gammaln(n - y + 1)
        + y * xp.log(theta) + (n - y) * xp.log1p(-theta)
    )


def binomial_logit_lpmf(y, n, alpha):
    y, n, alpha = _as_f(y), _as_f(n), _as_f(alpha)
    return (
        sp.gammaln(n + 1) - sp.gammaln(y + 1) - sp.gammaln(n - y + 1)
        + y * alpha - n * xp.nn.softplus(alpha)
    )


def poisson_lpmf(y, lam):
    y, lam = _as_f(y), _as_f(lam)
    return y * xp.log(lam) - lam - sp.gammaln(y + 1)


def poisson_log_lpmf(y, alpha):
    y, alpha = _as_f(y), _as_f(alpha)
    return y * alpha - xp.exp(alpha) - sp.gammaln(y + 1)


def neg_binomial_2_lpmf(y, mu, phi):
    y, mu, phi = _as_f(y), _as_f(mu), _as_f(phi)
    return (
        sp.gammaln(y + phi) - sp.gammaln(phi) - sp.gammaln(y + 1)
        + phi * (xp.log(phi) - xp.log(phi + mu))
        + y * (xp.log(mu) - xp.log(phi + mu))
    )


def neg_binomial_2_log_lpmf(y, eta, phi):
    return neg_binomial_2_lpmf(y, xp.exp(_as_f(eta)), phi)


def categorical_lpmf(y, theta):
    # y: int (or int array), theta: simplex vector
    y = xp.asarray(y)
    logt = xp.log(_as_f(theta))
    return xp.take(logt, y - 1, axis=-1)


def categorical_logit_lpmf(y, beta):
    y = xp.asarray(y)
    logp = xp.nn.log_softmax(_as_f(beta), axis=-1)
    return xp.take(logp, y - 1, axis=-1)


def dirichlet_lpdf(theta, alpha):
    theta, alpha = _as_f(theta), _as_f(alpha)
    return (
        xp.sum((alpha - 1) * xp.log(theta), axis=-1)
        + sp.gammaln(xp.sum(alpha, axis=-1))
        - xp.sum(sp.gammaln(alpha), axis=-1)
    )


def _tri_solve_rows(L, diff):
    """L^{-1} d for each row d of ``diff [..., K]`` (``L [..., K, K]``
    broadcast over the rows): ``array[N] vector[K]`` observations are N
    rows, never one K x N right-hand side."""
    return xp.linalg.solve_triangular(L, diff[..., None], lower=True)[..., 0]


def multi_normal_lpdf(y, mu, Sigma):
    y, mu, Sigma = _as_f(y), _as_f(mu), _as_f(Sigma)
    d = y.shape[-1]
    chol = xp.linalg.cholesky(Sigma)
    diff = y - mu
    z = _tri_solve_rows(chol, diff)
    return (
        -0.5 * xp.sum(z * z, axis=-1)
        - xp.sum(xp.log(xp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
        - 0.5 * d * xp.log(2 * xp.pi)
    )


def multi_normal_cholesky_lpdf(y, mu, L):
    y, mu, L = _as_f(y), _as_f(mu), _as_f(L)
    d = y.shape[-1]
    diff = y - mu
    z = _tri_solve_rows(L, diff)
    return (
        -0.5 * xp.sum(z * z, axis=-1)
        - xp.sum(xp.log(xp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
        - 0.5 * d * xp.log(2 * xp.pi)
    )


def lkj_corr_cholesky_lpdf(L, eta):
    L, eta = _as_f(L), _as_f(eta)
    K = L.shape[-1]
    diag = xp.diagonal(L, axis1=-2, axis2=-1)
    exponents = K - xp.arange(2, K + 1) + 2.0 * eta - 2.0
    # density over the cholesky factor (without the normalizing constant,
    # which does not depend on L)
    return xp.sum(exponents * xp.log(diag[..., 1:]), axis=-1)



def ordered_logistic_lpmf(y, eta, c):
    """Ordered logistic (Stan functions reference; K = len(c)+1 categories).

    log p(y=k) computed category-stably: edge categories via log_sigmoid,
    interior via sigmoid(a)-sigmoid(b) = sigmoid(b)*sigmoid(-a)*expm1(a-b)
    with a = eta - c_{k-1} > b = eta - c_k.
    """
    y = xp.asarray(y)
    eta, c = _as_f(eta), xp.atleast_1d(_as_f(c))
    K = c.shape[-1] + 1
    ls = xp.nn.log_sigmoid
    k = y - 1  # 0-based category
    c_lo = c[xp.clip(k - 1, 0, K - 2)]
    c_hi = c[xp.clip(k, 0, K - 2)]
    a = eta - c_lo
    b = eta - c_hi
    interior = ls(b) + ls(-a) + xp.log(xp.expm1(xp.maximum(a - b, 1e-30)))
    first = ls(c[0] - eta)
    last = ls(eta - c[K - 2])
    return xp.where(k <= 0, first, xp.where(k >= K - 1, last, interior))


def multinomial_lpmf(y, theta):
    y, theta = _as_f(y), _as_f(theta)
    n = xp.sum(y, axis=-1)
    # multiply_log semantics: 0 * log(0) == 0 so boundary simplex values
    # with y_i == 0 don't poison the logp (Stan's multinomial_lpmf does the
    # same via multiply_log).
    ylogt = xp.where(y > 0, y * xp.log(theta), 0.0)
    return (
        sp.gammaln(n + 1) - xp.sum(sp.gammaln(y + 1), axis=-1)
        + xp.sum(ylogt, axis=-1)
    )


def multinomial_logit_lpmf(y, gamma):
    return multinomial_lpmf(y, xp.nn.softmax(_as_f(gamma), axis=-1))


def beta_binomial_lpmf(y, n, alpha, beta):
    y, n, alpha, beta = _as_f(y), _as_f(n), _as_f(alpha), _as_f(beta)
    return (
        sp.gammaln(n + 1) - sp.gammaln(y + 1) - sp.gammaln(n - y + 1)
        + sp.betaln(y + alpha, n - y + beta) - sp.betaln(alpha, beta)
    )


def von_mises_lpdf(y, mu, kappa):
    y, mu, kappa = _as_f(y), _as_f(mu), _as_f(kappa)
    # log I0(kappa) = log i0e(kappa) + kappa (scaled bessel, overflow-safe)
    return (
        kappa * xp.cos(y - mu)
        - xp.log(2 * xp.pi) - (xp.log(sp.i0e(kappa)) + kappa)
    )


def skew_normal_lpdf(y, xi, omega, alpha):
    y, xi, omega, alpha = _as_f(y), _as_f(xi), _as_f(omega), _as_f(alpha)
    z = (y - xi) / omega
    return (
        xp.log(2.0) - xp.log(omega)
        - 0.5 * z * z - 0.5 * xp.log(2 * xp.pi)
        + sp.log_ndtr(alpha * z)
    )


def frechet_lpdf(y, alpha, sigma):
    y, alpha, sigma = _as_f(y), _as_f(alpha), _as_f(sigma)
    z = sigma / y
    return xp.log(alpha) - xp.log(sigma) + (alpha + 1) * xp.log(z) - z**alpha


def rayleigh_lpdf(y, sigma):
    y, sigma = _as_f(y), _as_f(sigma)
    return xp.log(y) - 2 * xp.log(sigma) - 0.5 * (y / sigma) ** 2


def lkj_corr_lpdf(y, eta):
    y, eta = _as_f(y), _as_f(eta)
    sign, logdet = xp.linalg.slogdet(y)
    return (eta - 1.0) * logdet


def _mvgammaln(d, a):
    i = xp.arange(d, dtype=xp.fdtype())
    return d * (d - 1) / 4.0 * xp.log(xp.pi) + xp.sum(
        sp.gammaln(a - i / 2.0)
    )


def wishart_lpdf(W, nu, S):
    W, nu, S = _as_f(W), _as_f(nu), _as_f(S)
    d = W.shape[-1]
    _, logdet_w = xp.linalg.slogdet(W)
    chol_s = xp.linalg.cholesky(S)
    logdet_s = 2.0 * xp.sum(xp.log(xp.diagonal(chol_s)))
    x = xp.linalg.cho_solve((chol_s, True), W)
    tr = xp.trace(x)
    return (
        0.5 * (nu - d - 1) * logdet_w - 0.5 * tr
        - 0.5 * nu * d * xp.log(2.0) - 0.5 * nu * logdet_s
        - _mvgammaln(d, nu / 2.0)
    )


def inv_wishart_lpdf(W, nu, S):
    W, nu, S = _as_f(W), _as_f(nu), _as_f(S)
    d = W.shape[-1]
    _, logdet_w = xp.linalg.slogdet(W)
    chol_s = xp.linalg.cholesky(S)
    logdet_s = 2.0 * xp.sum(xp.log(xp.diagonal(chol_s)))
    chol_w = xp.linalg.cholesky(W)
    x = xp.linalg.cho_solve((chol_w, True), S)
    tr = xp.trace(x)
    return (
        -0.5 * (nu + d + 1) * logdet_w - 0.5 * tr
        + 0.5 * nu * logdet_s - 0.5 * nu * d * xp.log(2.0)
        - _mvgammaln(d, nu / 2.0)
    )


def multi_student_t_lpdf(y, nu, mu, Sigma):
    y, nu, mu, Sigma = _as_f(y), _as_f(nu), _as_f(mu), _as_f(Sigma)
    d = y.shape[-1]
    chol = xp.linalg.cholesky(Sigma)
    diff = y - mu
    z = _tri_solve_rows(chol, diff)
    q = xp.sum(z * z, axis=-1)
    return (
        sp.gammaln((nu + d) / 2.0) - sp.gammaln(nu / 2.0)
        - 0.5 * d * xp.log(nu * xp.pi)
        - xp.sum(xp.log(xp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
        - 0.5 * (nu + d) * xp.log1p(q / nu)
    )


def exp_mod_normal_lpdf(y, mu, sigma, lam):
    """Exponentially modified normal; the erfc tail goes through
    log_ndtr for stability (erfc(u) = 2*ndtr(-u*sqrt(2)))."""
    y, mu, sigma, lam = _as_f(y), _as_f(mu), _as_f(sigma), _as_f(lam)
    u = (mu + lam * sigma * sigma - y) / (xp.sqrt(2.0) * sigma)
    return (
        xp.log(lam) - xp.log(2.0)
        + 0.5 * lam * (2.0 * mu + lam * sigma * sigma - 2.0 * y)
        + xp.log(2.0) + sp.log_ndtr(-u * xp.sqrt(2.0))
    )


def skew_double_exponential_lpdf(y, mu, sigma, tau):
    y, mu, sigma, tau = _as_f(y), _as_f(mu), _as_f(sigma), _as_f(tau)
    z = y - mu
    cost = xp.where(z >= 0, tau * z, (tau - 1.0) * z)
    return (
        xp.log(2.0) + xp.log(tau) + xp.log1p(-tau) - xp.log(sigma)
        - 2.0 * cost / sigma
    )


def beta_proportion_lpdf(theta, mu, kappa):
    mu, kappa = _as_f(mu), _as_f(kappa)
    return beta_lpdf(theta, mu * kappa, (1.0 - mu) * kappa)


def ordered_probit_lpmf(y, eta, c):
    """Latent-normal ordered model: P(y<=k) = Phi(c_k - eta)."""
    y = xp.asarray(y)
    eta, c = _as_f(eta), xp.atleast_1d(_as_f(c))
    z = c - (eta[..., None] if xp.ndim(eta) else eta)
    cum = sp.ndtr(z)
    pad0 = xp.zeros(cum.shape[:-1] + (1,))
    pad1 = xp.ones(cum.shape[:-1] + (1,))
    probs = xp.diff(xp.concatenate([pad0, cum, pad1], axis=-1), axis=-1)
    if probs.ndim == 1:
        return xp.log(xp.take(probs, y - 1))
    return xp.log(
        xp.take_along_axis(probs, (y - 1)[..., None], axis=-1)[..., 0]
    )


# ------------------------------------------------------- fused GLM densities
# Stan math's *_glm families (C++ fused likelihood+linear-predictor):
# eta = alpha + x @ beta is one batched product ahead of the elementwise
# density.

def _glm_eta(x, alpha, beta):
    return xp.asarray(alpha) + xp.asarray(x) @ xp.ravel(_as_f(beta))


def normal_id_glm_lpdf(y, x, alpha, beta, sigma):
    return normal_lpdf(y, _glm_eta(x, alpha, beta), sigma)


def bernoulli_logit_glm_lpmf(y, x, alpha, beta):
    return bernoulli_logit_lpmf(y, _glm_eta(x, alpha, beta))


def poisson_log_glm_lpmf(y, x, alpha, beta):
    return poisson_log_lpmf(y, _glm_eta(x, alpha, beta))


def neg_binomial_2_log_glm_lpmf(y, x, alpha, beta, phi):
    return neg_binomial_2_log_lpmf(y, _glm_eta(x, alpha, beta), phi)


def ordered_logistic_glm_lpmf(y, x, beta, cuts):
    eta = xp.asarray(x) @ xp.ravel(_as_f(beta))
    return ordered_logistic_lpmf(y, eta, cuts)


def categorical_logit_glm_lpmf(y, x, alpha, beta):
    # x: [n, k]; beta: [k, K]; alpha: [K] -> eta: [n, K]
    eta = xp.asarray(alpha)[None, :] + xp.asarray(x) @ _as_f(beta)
    logp = xp.nn.log_softmax(eta, axis=-1)
    idx = (xp.asarray(y) - 1).reshape(-1, 1)
    return xp.take_along_axis(logp, idx, axis=-1)[:, 0]


DISTRIBUTIONS = {
    "normal": normal_lpdf,
    "std_normal": std_normal_lpdf,
    "lognormal": lognormal_lpdf,
    "student_t": student_t_lpdf,
    "cauchy": cauchy_lpdf,
    "double_exponential": double_exponential_lpdf,
    "logistic": logistic_lpdf,
    "gumbel": gumbel_lpdf,
    "exponential": exponential_lpdf,
    "gamma": gamma_lpdf,
    "inv_gamma": inv_gamma_lpdf,
    "chi_square": chi_square_lpdf,
    "beta": beta_lpdf,
    "uniform": uniform_lpdf,
    "weibull": weibull_lpdf,
    "pareto": pareto_lpdf,
    "bernoulli": bernoulli_lpmf,
    "bernoulli_logit": bernoulli_logit_lpmf,
    "binomial": binomial_lpmf,
    "binomial_logit": binomial_logit_lpmf,
    "poisson": poisson_lpmf,
    "poisson_log": poisson_log_lpmf,
    "neg_binomial_2": neg_binomial_2_lpmf,
    "neg_binomial_2_log": neg_binomial_2_log_lpmf,
    "categorical": categorical_lpmf,
    "categorical_logit": categorical_logit_lpmf,
    "dirichlet": dirichlet_lpdf,
    "multi_normal": multi_normal_lpdf,
    "multi_normal_cholesky": multi_normal_cholesky_lpdf,
    "lkj_corr_cholesky": lkj_corr_cholesky_lpdf,
    "ordered_logistic": ordered_logistic_lpmf,
    "multinomial": multinomial_lpmf,
    "multinomial_logit": multinomial_logit_lpmf,
    "beta_binomial": beta_binomial_lpmf,
    "von_mises": von_mises_lpdf,
    "skew_normal": skew_normal_lpdf,
    "frechet": frechet_lpdf,
    "rayleigh": rayleigh_lpdf,
    "lkj_corr": lkj_corr_lpdf,
    "wishart": wishart_lpdf,
    "inv_wishart": inv_wishart_lpdf,
    "multi_student_t": multi_student_t_lpdf,
    "exp_mod_normal": exp_mod_normal_lpdf,
    "skew_double_exponential": skew_double_exponential_lpdf,
    "beta_proportion": beta_proportion_lpdf,
    "ordered_probit": ordered_probit_lpmf,
    "normal_id_glm": normal_id_glm_lpdf,
    "bernoulli_logit_glm": bernoulli_logit_glm_lpmf,
    "poisson_log_glm": poisson_log_glm_lpmf,
    "neg_binomial_2_log_glm": neg_binomial_2_log_glm_lpmf,
    "ordered_logistic_glm": ordered_logistic_glm_lpmf,
    "categorical_logit_glm": categorical_logit_glm_lpmf,
}

def exponential_lcdf(y, lam):
    return xp.log1p(-xp.exp(-lam * _as_f(y)))


def exponential_lccdf(y, lam):
    return -lam * _as_f(y)


def uniform_lcdf(y, lo, hi):
    return xp.log((_as_f(y) - lo) / (hi - lo))


def uniform_lccdf(y, lo, hi):
    return xp.log((hi - _as_f(y)) / (hi - lo))


def logistic_lcdf(y, mu, sigma):
    return xp.nn.log_sigmoid((_as_f(y) - mu) / sigma)


def logistic_lccdf(y, mu, sigma):
    return xp.nn.log_sigmoid(-(_as_f(y) - mu) / sigma)


def cauchy_lcdf(y, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    return xp.log(0.5 + xp.arctan(z) / xp.pi)


def cauchy_lccdf(y, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    return xp.log(0.5 - xp.arctan(z) / xp.pi)


def lognormal_lcdf(y, mu, sigma):
    return sp.log_ndtr((xp.log(_as_f(y)) - mu) / sigma)


def lognormal_lccdf(y, mu, sigma):
    return sp.log_ndtr(-(xp.log(_as_f(y)) - mu) / sigma)


def gumbel_lcdf(y, mu, beta):
    return -xp.exp(-(_as_f(y) - mu) / beta)


def gumbel_lccdf(y, mu, beta):
    return xp.log1p(-xp.exp(-xp.exp(-(_as_f(y) - mu) / beta)))


def weibull_lcdf(y, alpha, sigma):
    return xp.log1p(-xp.exp(-((_as_f(y) / sigma) ** alpha)))


def weibull_lccdf(y, alpha, sigma):
    return -((_as_f(y) / sigma) ** alpha)


def gamma_lcdf(y, alpha, beta):
    return xp.log(sp.gammainc(alpha, beta * _as_f(y)))


def gamma_lccdf(y, alpha, beta):
    return xp.log1p(-sp.gammainc(alpha, beta * _as_f(y)))


def student_t_lcdf(y, nu, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    x = nu / (nu + z * z)
    tail = 0.5 * sp.betainc(nu / 2.0, 0.5, x)
    return xp.log(xp.where(z > 0, 1.0 - tail, tail))


def student_t_lccdf(y, nu, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    x = nu / (nu + z * z)
    tail = 0.5 * sp.betainc(nu / 2.0, 0.5, x)
    return xp.log(xp.where(z > 0, tail, 1.0 - tail))


# lcdf/lccdf lookups for truncation
LCDFS = {
    "normal": normal_lcdf,
    "exponential": exponential_lcdf,
    "uniform": uniform_lcdf,
    "logistic": logistic_lcdf,
    "cauchy": cauchy_lcdf,
    "lognormal": lognormal_lcdf,
    "gumbel": gumbel_lcdf,
    "weibull": weibull_lcdf,
    "gamma": gamma_lcdf,
    "student_t": student_t_lcdf,
}
LCCDFS = {
    "normal": normal_lccdf,
    "exponential": exponential_lccdf,
    "uniform": uniform_lccdf,
    "logistic": logistic_lccdf,
    "cauchy": cauchy_lccdf,
    "lognormal": lognormal_lccdf,
    "gumbel": gumbel_lccdf,
    "weibull": weibull_lccdf,
    "gamma": gamma_lccdf,
    "student_t": student_t_lccdf,
}


# ------------------------------------------------------------ rng functions

def _bshape(*args):
    return xp.broadcast_shapes(*(xp.shape(a) for a in args))


_VON_MISES_ROUNDS = 48


def _von_mises_rng(key, mu, kappa):
    """Best & Fisher (1979) rejection sampler, vectorized + jit-safe."""
    shape = _bshape(mu, kappa)
    mu = xp.broadcast_to(_as_f(mu), shape)
    kappa = xp.broadcast_to(_as_f(kappa), shape)
    tau = 1.0 + xp.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - xp.sqrt(2.0 * tau)) / (2.0 * xp.maximum(kappa, 1e-12))
    r = (1.0 + rho * rho) / (2.0 * rho)

    # the JAX sampler loops until every element accepts (at most 100
    # rounds); here a fixed count of rounds, each accepting with
    # probability above 0.65, leaves an element unaccepted below 1e-20
    def body(carry):
        key, f_acc, sign, done = carry
        key, k1, k2, k3 = rng.split(key, 4)
        u1 = rng.uniform(k1, shape)
        u2 = rng.uniform(k2, shape)
        u3 = rng.uniform(k3, shape)
        z = xp.cos(xp.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        accept = ((c * (2.0 - c) - u2) > 0.0) | (
            (xp.log(xp.maximum(c, 1e-300) / xp.maximum(u2, 1e-300))
             + 1.0 - c) >= 0.0
        )
        take = accept & ~done
        f_acc = xp.where(take, f, f_acc)
        sign = xp.where(take, xp.where(u3 < 0.5, -1.0, 1.0), sign)
        return key, f_acc, sign, done | accept

    carry = (key, xp.ones(shape), xp.ones(shape), xp.zeros(shape, torch.bool))
    for _ in range(_VON_MISES_ROUNDS):
        carry = body(carry)
    _, f, sign, _ = carry
    theta = sign * xp.arccos(xp.clip(f, -1.0, 1.0))
    return xp.mod(mu + theta + xp.pi, 2.0 * xp.pi) - xp.pi


# --------------------------------------------------------- HMM functions
# The reference gets these from Stan math's C++ hmm_marginal.hpp family
# via BridgeStan; here they are forward(/backward) recursions in log space,
# unrolled over the static number of observations.  Convention (Stan docs): log_omega is K x N (states x
# observations), Gamma[i, j] = P(z_{n+1} = j | z_n = i), rho the initial
# state simplex.

def _hmm_forward(log_omega, Gamma, rho):
    lo = xp.asarray(log_omega, xp.fdtype())
    lg = xp.log(xp.asarray(Gamma, xp.fdtype()))
    lrho = xp.log(xp.asarray(rho, xp.fdtype()))
    alpha0 = lrho + lo[:, 0]

    alphas = [alpha0]
    for n in range(1, lo.shape[1]):
        alphas.append(lo[:, n] + sp.logsumexp(alphas[-1][:, None] + lg, axis=0))
    return torch.stack(alphas), alphas[-1], lg, lo


def hmm_marginal(log_omega, Gamma, rho):
    _, alpha_last, _, _ = _hmm_forward(log_omega, Gamma, rho)
    return sp.logsumexp(alpha_last)


def hmm_hidden_state_prob(log_omega, Gamma, rho):
    """K x N matrix of P(z_n = k | y_{1:N}) via forward-backward."""
    alphas, alpha_last, lg, lo = _hmm_forward(log_omega, Gamma, rho)
    n = lo.shape[1]
    beta_last = xp.zeros(lo.shape[0])
    betas_rev = [beta_last]
    for m in range(n - 1, 0, -1):
        betas_rev.append(sp.logsumexp(lg + (lo[:, m] + betas_rev[-1])[None, :], axis=1))
    betas = torch.stack(betas_rev[::-1])
    log_z = sp.logsumexp(alpha_last)
    return xp.exp(alphas + betas - log_z).T


def hmm_latent_rng(key, log_omega, Gamma, rho):
    """Sample a latent path via forward-filter backward-sample; returns
    1-based states (Stan convention)."""
    alphas, alpha_last, lg, lo = _hmm_forward(log_omega, Gamma, rho)
    n = lo.shape[1]
    key, k_last = rng.split(key)
    z_last = rng.categorical(k_last, alpha_last)
    zs_rev = [z_last]
    for m in range(n - 2, -1, -1):
        key, k = rng.split(key)
        logits = alphas[m] + lg[:, zs_rev[-1]]
        zs_rev.append(rng.categorical(k, logits))
    return torch.stack(zs_rev[::-1]) + 1


RNG_FUNCTIONS = {
    "normal_rng": lambda key, mu, sigma: mu + sigma * rng.normal(
        key, _bshape(mu, sigma)
    ),
    "std_normal_rng": lambda key: rng.normal(key, ()),
    "uniform_rng": lambda key, lo, hi: rng.uniform(
        key, _bshape(lo, hi), minval=lo, maxval=hi
    ),
    "lognormal_rng": lambda key, mu, sigma: xp.exp(
        mu + sigma * rng.normal(key, _bshape(mu, sigma))
    ),
    "exponential_rng": lambda key, lam: rng.exponential(
        key, _bshape(lam)
    ) / lam,
    "gamma_rng": lambda key, a, b: rng.gamma(key, a, _bshape(a, b)) / b,
    "inv_gamma_rng": lambda key, a, b: b / rng.gamma(
        key, a, _bshape(a, b)
    ),
    "beta_rng": lambda key, a, b: rng.beta(key, a, b, _bshape(a, b)),
    "chi_square_rng": lambda key, nu: 2.0 * rng.gamma(
        key, xp.asarray(nu) / 2.0, _bshape(nu)
    ),
    "student_t_rng": lambda key, nu, mu, sigma: mu + sigma * rng.t(
        key, nu, _bshape(nu, mu, sigma)
    ),
    "cauchy_rng": lambda key, mu, sigma: mu + sigma * xp.tan(
        xp.pi * (rng.uniform(key, _bshape(mu, sigma)) - 0.5)
    ),
    "double_exponential_rng": lambda key, mu, sigma: (
        lambda v: mu + sigma * xp.sign(v) * -xp.log1p(-2.0 * xp.abs(v))
    )(rng.uniform(key, _bshape(mu, sigma)) - 0.5),
    "weibull_rng": lambda key, a, sigma: sigma * (
        -xp.log1p(-rng.uniform(key, _bshape(a, sigma)))
    ) ** (1.0 / a),
    "bernoulli_rng": lambda key, p: rng.bernoulli(
        key, p, _bshape(p)
    ).to(torch.int64),
    "bernoulli_logit_rng": lambda key, a: rng.bernoulli(
        key, xp.nn.sigmoid(a), _bshape(a)
    ).to(torch.int64),
    "binomial_rng": lambda key, n, p: rng.binomial(
        key, n, p, _bshape(n, p)
    ).to(torch.int64),
    "poisson_rng": lambda key, lam: rng.poisson(
        key, lam, _bshape(lam)
    ).to(torch.int64),
    "poisson_log_rng": lambda key, a: rng.poisson(
        key, xp.exp(a), _bshape(a)
    ).to(torch.int64),
    "categorical_rng": lambda key, theta: (
        rng.categorical(key, xp.log(xp.asarray(theta)), axis=-1) + 1
    ).to(torch.int64),
    "categorical_logit_rng": lambda key, beta: (
        rng.categorical(key, xp.asarray(beta), axis=-1) + 1
    ).to(torch.int64),
    "dirichlet_rng": lambda key, alpha: rng.dirichlet(key, alpha),
    "multi_normal_rng": lambda key, mu, Sigma: xp.asarray(mu)
    + xp.linalg.cholesky(xp.asarray(Sigma))
    @ rng.normal(key, (xp.shape(mu)[-1],)),
    "beta_binomial_rng": lambda key, n, a, b: rng.binomial(
        rng.fold_in(key, 1), n,
        rng.beta(rng.fold_in(key, 0), a, b, _bshape(n, a, b)),
        _bshape(n, a, b),
    ).to(torch.int64),
    "ordered_logistic_rng": lambda key, eta, c: (
        xp.sum(
            (rng.logistic(key, xp.shape(eta)) + xp.asarray(eta))[
                ..., None
            ]
            > xp.atleast_1d(xp.asarray(c)), axis=-1
        ) + 1
    ).to(torch.int64),
    "von_mises_rng": _von_mises_rng,
    "hmm_latent_rng": hmm_latent_rng,
    "skew_normal_rng": lambda key, xi, omega, alpha: (
        lambda k1, k2, d: xi + omega * (
            d * xp.abs(rng.normal(k1, _bshape(xi, omega, alpha)))
            + xp.sqrt(1 - d * d)
            * rng.normal(k2, _bshape(xi, omega, alpha))
        )
    )(
        rng.fold_in(key, 0), rng.fold_in(key, 1),
        xp.asarray(alpha) / xp.sqrt(1.0 + xp.asarray(alpha) ** 2),
    ),
    "rayleigh_rng": lambda key, sigma: sigma * xp.sqrt(
        -2.0 * xp.log1p(-rng.uniform(key, _bshape(sigma)))
    ),
}


# ------------------------------------------------------------ math functions

def _transpose(x):
    x = xp.asarray(x)
    if x.ndim == 0:
        return x
    if x.ndim == 1:
        return x.reshape(1, -1)
    if x.ndim == 2 and x.shape[0] == 1:
        return x.ravel()
    return xp.swapaxes(x, -1, -2)


def _dot(a, b):
    """Stan's ``*``: matrix product respecting vector/row_vector shapes."""
    a, b = xp.promote(xp.asarray(a), xp.asarray(b))
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim == 1 and b.ndim == 1:
        # vector * vector is ill-typed in Stan; the common intent in the
        # models we accept is elementwise only via .*; treat as dot error
        raise StanCompileError(
            "vector * vector is not defined in Stan; use dot_product or .*"
        )
    if a.ndim == 1 and b.ndim == 2:
        # vector(n) * row_vector(1,m) -> outer (n,m); vector * matrix invalid
        if b.shape[0] == 1:
            return xp.outer(a, b.ravel())
        raise StanCompileError("vector * matrix is not defined in Stan")
    if a.ndim == 2 and b.ndim == 1:
        # matrix(m,n) * vector(n) -> vector(m); row_vector(1,n) * vector -> real
        out = a @ b
        if a.shape[0] == 1:
            return out[0]
        return out
    return a @ b


def _divide(a, b):
    a, b = xp.asarray(a), xp.asarray(b)
    if b.ndim == 2 and a.ndim >= 1:
        # matrix division A / B = A B^-1
        return xp.linalg.solve(_transpose(b), _transpose(a)).T
    if not (a.is_floating_point() or b.is_floating_point()):
        a = a.to(xp.fdtype())  # true division of device integers
    return a / b


def _softmax(x):
    return xp.nn.softmax(xp.asarray(x), axis=-1)


def _log_sum_exp(*args):
    if len(args) == 1:
        return sp.logsumexp(xp.asarray(args[0]))
    return sp.logsumexp(xp.stack([xp.asarray(a) for a in args]))


def _rep_vector(x, n):
    return xp.full((int(n),), x, xp.fdtype())


def _rep_row_vector(x, n):
    return xp.full((1, int(n)), x, xp.fdtype())


def _rep_matrix(x, m, n=None):
    x = xp.asarray(x)
    if n is None:
        # rep_matrix(vector, n) -> n copies of the vector as columns
        if x.ndim == 1:
            return xp.tile(x[:, None], (1, int(m)))
        if x.ndim == 2 and x.shape[0] == 1:
            return xp.tile(x, (int(m), 1))
        raise StanCompileError("rep_matrix: unsupported arguments")
    return xp.full((int(m), int(n)), x, xp.fdtype())


def _rep_array(x, *dims):
    dims = tuple(int(d) for d in dims)
    x = xp.asarray(x)
    return xp.broadcast_to(x, dims + x.shape)


def _to_vector(x):
    x = xp.asarray(x)
    if x.ndim == 2:
        # matrix -> column-major ravel (Stan is column-major)
        return x.T.ravel()
    return x.ravel()


def _to_matrix(x, m=None, n=None):
    x = xp.asarray(x)
    if m is None:
        return xp.atleast_2d(x)
    # column-major, as Stan fills matrices
    flat = x.permute(*reversed(range(x.ndim))).reshape(-1)
    return flat.reshape(int(n), int(m)).T


def _segment(x, start, n):
    # the start is clamped into range, as a dynamic slice clamps it
    x, n = xp.asarray(x), int(n)
    hi = max(x.shape[0] - n, 0)
    if isinstance(start, torch.Tensor):
        first = torch.clamp(start - 1, 0, hi)
        return x[first + torch.arange(n, device=x.device)]
    first = min(max(int(start) - 1, 0), hi)
    return x[first:first + n]


def _head(x, n):
    return xp.asarray(x)[: int(n)]


def _tail(x, n):
    x = xp.asarray(x)
    return x[x.shape[0] - int(n):]


def _append_row(a, b):
    a, b = xp.atleast_1d(xp.asarray(a)), xp.atleast_1d(xp.asarray(b))
    if a.ndim == 1 and b.ndim == 1:
        return xp.concatenate([a, b])
    return xp.concatenate([xp.atleast_2d(a), xp.atleast_2d(b)], axis=0)


def _append_col(a, b):
    # Stan treats (column) vectors as n x 1 in append_col: two length-n
    # vectors give an (n, 2) matrix, and matrix+vector adds one column.
    a, b = xp.asarray(a), xp.asarray(b)
    if a.ndim == 1 and b.ndim == 1:
        return xp.stack([a, b], axis=1)
    if a.ndim == 1:
        a = a[:, None]
    if b.ndim == 1:
        b = b[:, None]
    return xp.concatenate([xp.atleast_2d(a), xp.atleast_2d(b)], axis=1)


def _quad_form(A, B):
    B = xp.asarray(B)
    return _transpose(B) @ xp.asarray(A) @ B


def _sd(x):
    x = xp.asarray(x)
    return xp.std(x, ddof=1)


def _variance(x):
    x = xp.asarray(x)
    return xp.var(x, ddof=1)


def _int_div(a, b):
    return a // b




FUNCTIONS = {
    # elementary
    "abs": xp.abs, "fabs": xp.abs, "fmin": xp.minimum, "fmax": xp.maximum,
    "min": lambda *a: xp.minimum(*a) if len(a) == 2 else xp.min(xp.asarray(a[0])),
    "max": lambda *a: xp.maximum(*a) if len(a) == 2 else xp.max(xp.asarray(a[0])),
    "sqrt": xp.sqrt, "cbrt": xp.cbrt, "square": xp.square,
    "exp": xp.exp, "exp2": xp.exp2, "expm1": xp.expm1,
    "log": xp.log, "log2": xp.log2, "log10": xp.log10, "log1p": xp.log1p,
    "log1m": lambda x: xp.log1p(-xp.asarray(x)),
    "log1p_exp": lambda x: xp.nn.softplus(xp.asarray(x)),
    "log1m_exp": lambda x: xp.log(-xp.expm1(xp.asarray(x))),
    "log_diff_exp": lambda a, b: xp.asarray(a) + xp.log1p(
        -xp.exp(xp.asarray(b) - xp.asarray(a))
    ),
    "log_inv_logit": lambda x: -xp.nn.softplus(-xp.asarray(x)),
    "log1m_inv_logit": lambda x: -xp.nn.softplus(xp.asarray(x)),
    "inv": lambda x: 1.0 / xp.asarray(x),
    "inv_sqrt": lambda x: 1.0 / xp.sqrt(xp.asarray(x)),
    "inv_square": lambda x: 1.0 / xp.square(xp.asarray(x)),
    "inv_logit": lambda x: xp.nn.sigmoid(xp.asarray(x)),
    "logit": sp.logit,
    "pow": xp.power, "hypot": xp.hypot,
    "floor": xp.floor, "ceil": xp.ceil, "round": xp.round,
    "trunc": xp.trunc, "fmod": xp.fmod, "fdim": lambda a, b: xp.maximum(
        xp.asarray(a) - xp.asarray(b), 0.0
    ),
    "step": lambda x: xp.where(xp.asarray(x) >= 0, 1.0, 0.0),
    "int_step": lambda x: xp.where(xp.asarray(x) > 0, 1, 0),
    "sin": xp.sin, "cos": xp.cos, "tan": xp.tan,
    "asin": xp.arcsin, "acos": xp.arccos, "atan": xp.arctan,
    "atan2": xp.arctan2,
    "sinh": xp.sinh, "cosh": xp.cosh, "tanh": xp.tanh,
    "asinh": xp.arcsinh, "acosh": xp.arccosh, "atanh": xp.arctanh,
    "lgamma": sp.gammaln, "tgamma": lambda x: xp.exp(sp.gammaln(xp.asarray(x))),
    "digamma": sp.digamma,
    "lmgamma": lambda k, x: sp.multigammaln(xp.asarray(x), int(k)),
    "lbeta": sp.betaln,
    "binomial_coefficient_log": lambda n, k: (
        sp.gammaln(xp.asarray(n) + 1) - sp.gammaln(xp.asarray(k) + 1)
        - sp.gammaln(xp.asarray(n) - xp.asarray(k) + 1)
    ),
    "lchoose": lambda n, k: (
        sp.gammaln(xp.asarray(n) + 1) - sp.gammaln(xp.asarray(k) + 1)
        - sp.gammaln(xp.asarray(n) - xp.asarray(k) + 1)
    ),
    "lmultiply": lambda a, b: xp.asarray(a) * xp.log(xp.asarray(b)),
    "multiply_log": lambda a, b: xp.asarray(a) * xp.log(xp.asarray(b)),
    "erf": sp.erf, "erfc": sp.erfc, "Phi": sp.ndtr,
    "Phi_approx": lambda x: xp.nn.sigmoid(
        0.07056 * xp.asarray(x) ** 3 + 1.5976 * xp.asarray(x)
    ),
    "inv_Phi": sp.ndtri,
    # reductions / vector ops
    "sum": lambda x: xp.sum(xp.asarray(x)),
    "prod": lambda x: xp.prod(xp.asarray(x)),
    "mean": lambda x: xp.mean(xp.asarray(x)),
    "sd": _sd, "variance": _variance,
    "log_sum_exp": _log_sum_exp,
    "softmax": _softmax,
    "log_softmax": lambda x: xp.nn.log_softmax(xp.asarray(x), axis=-1),
    "cumulative_sum": lambda x: xp.cumsum(xp.asarray(x), axis=-1),
    "dot_product": lambda a, b: xp.sum(
        xp.ravel(xp.asarray(a)) * xp.ravel(xp.asarray(b))
    ),
    "dot_self": lambda x: xp.sum(xp.square(xp.ravel(xp.asarray(x)))),
    "columns_dot_product": lambda a, b: xp.sum(
        xp.asarray(a) * xp.asarray(b), axis=0
    ).reshape(1, -1),
    "rows_dot_product": lambda a, b: xp.sum(
        xp.asarray(a) * xp.asarray(b), axis=1
    ),
    "distance": lambda a, b: xp.sqrt(
        xp.sum(xp.square(xp.ravel(xp.asarray(a)) - xp.ravel(xp.asarray(b))))
    ),
    "squared_distance": lambda a, b: xp.sum(
        xp.square(xp.ravel(xp.asarray(a)) - xp.ravel(xp.asarray(b)))
    ),
    "sort_asc": lambda x: xp.sort(xp.asarray(x)),
    "sort_desc": lambda x: -xp.sort(-xp.asarray(x)),
    "reverse": lambda x: xp.flip(xp.asarray(x), axis=0),
    # shapes / construction
    "rep_vector": _rep_vector,
    "rep_row_vector": _rep_row_vector,
    "rep_matrix": _rep_matrix,
    "rep_array": _rep_array,
    "to_vector": _to_vector,
    "to_row_vector": lambda x: _to_vector(x).reshape(1, -1),
    "to_array_1d": _to_vector,
    "to_matrix": _to_matrix,
    "linspaced_vector": lambda n, a, b: xp.linspace(a, b, int(n)),
    # to_int truncates toward zero (Stan requires the value to fit; we
    # match numpy's truncation semantics)
    "to_int": lambda x: (
        np.asarray(x).astype(np.int64)
        if isinstance(x, (int, float, np.generic, np.ndarray))
        else xp.asarray(x).to(torch.int64)
    ),
    "ones_vector": lambda n: xp.ones(int(n)),
    "zeros_vector": lambda n: xp.zeros(int(n)),
    "ones_row_vector": lambda n: xp.ones((1, int(n))),
    "zeros_row_vector": lambda n: xp.zeros((1, int(n))),
    "identity_matrix": lambda n: xp.eye(int(n)),
    "head": _head, "tail": _tail, "segment": _segment,
    "append_row": _append_row, "append_col": _append_col,
    # linear algebra
    "diag_matrix": lambda x: xp.diag(xp.ravel(xp.asarray(x))),
    "diagonal": lambda x: xp.diagonal(xp.asarray(x)),
    "transpose": _transpose,
    "inverse": xp.linalg.inv,
    "cholesky_decompose": xp.linalg.cholesky,
    "determinant": xp.linalg.det,
    "log_determinant": lambda x: xp.linalg.slogdet(xp.asarray(x))[1],
    "trace": xp.trace,
    "quad_form": _quad_form,
    "quad_form_diag": lambda A, v: xp.asarray(A)
    * (xp.ravel(xp.asarray(v))[:, None] * xp.ravel(xp.asarray(v))[None, :]),
    "diag_pre_multiply": lambda v, A: xp.ravel(xp.asarray(v))[:, None]
    * xp.asarray(A),
    "diag_post_multiply": lambda A, v: xp.asarray(A)
    * xp.ravel(xp.asarray(v))[None, :],
    "multiply_lower_tri_self_transpose": lambda L: xp.asarray(L)
    @ _transpose(xp.asarray(L)),
    "mdivide_left_tri_low": lambda L, b: xp.linalg.solve_triangular(
        xp.asarray(L), xp.asarray(b), lower=True
    ),
    "mdivide_right_tri_low": lambda b, L: xp.linalg.solve_triangular(
        xp.asarray(L).T, xp.asarray(b).T, lower=False
    ).T,
    "mdivide_left": lambda A, b: xp.linalg.solve(xp.asarray(A), xp.asarray(b)),
    # hidden Markov models (forward/backward recursions)
    "hmm_marginal": hmm_marginal,
    "hmm_hidden_state_prob": hmm_hidden_state_prob,
    # mixtures
    "log_mix": lambda theta, a, b: xp.logaddexp(
        xp.log(xp.asarray(theta)) + xp.asarray(a),
        xp.log1p(-xp.asarray(theta)) + xp.asarray(b),
    ),
    # special functions
    "inc_beta": lambda a, b, x: sp.betainc(
        _as_f(a), _as_f(b), _as_f(x)
    ),
    "gamma_p": lambda a, z: sp.gammainc(_as_f(a), _as_f(z)),
    "gamma_q": lambda a, z: sp.gammaincc(_as_f(a), _as_f(z)),
    "trigamma": lambda x: sp.polygamma(1, _as_f(x)),
    "choose": lambda n, k: xp.round(xp.exp(
        sp.gammaln(_as_f(n) + 1) - sp.gammaln(_as_f(k) + 1)
        - sp.gammaln(_as_f(n) - _as_f(k) + 1)
    )).to(torch.int64),
    "falling_factorial": lambda x, n: xp.exp(
        sp.gammaln(_as_f(x) + 1) - sp.gammaln(_as_f(x) - _as_f(n) + 1)
    ),
    "rising_factorial": lambda x, n: xp.exp(
        sp.gammaln(_as_f(x) + _as_f(n)) - sp.gammaln(_as_f(x))
    ),
    "log_falling_factorial": lambda x, n: (
        sp.gammaln(_as_f(x) + 1) - sp.gammaln(_as_f(x) - _as_f(n) + 1)
    ),
    "log_rising_factorial": lambda x, n: (
        sp.gammaln(_as_f(x) + _as_f(n)) - sp.gammaln(_as_f(x))
    ),
    "inv_cloglog": lambda x: -xp.expm1(-xp.exp(_as_f(x))),
    "cloglog": lambda x: xp.log(-xp.log1p(-_as_f(x))),
    "fma": lambda x, y, z: _as_f(x) * _as_f(y) + _as_f(z),
    "ldexp": lambda x, n: _as_f(x) * xp.exp2(_as_f(n)),
    "erf_inv": lambda x: sp.erfinv(_as_f(x)),
    "inv_erfc": lambda x: sp.erfinv(1.0 - _as_f(x)),
    # matrix decompositions (torch.linalg)
    "matrix_exp": lambda A: xp.linalg.expm(_as_f(A)),
    "eigenvalues_sym": lambda A: xp.linalg.eigvalsh(_as_f(A)),
    "eigenvectors_sym": lambda A: xp.linalg.eigh(_as_f(A))[1],
    "qr_thin_Q": lambda A: xp.linalg.qr(_as_f(A), mode="reduced")[0],
    "qr_thin_R": lambda A: xp.linalg.qr(_as_f(A), mode="reduced")[1],
    "qr_Q": lambda A: xp.linalg.qr(_as_f(A), mode="complete")[0],
    "qr_R": lambda A: xp.linalg.qr(_as_f(A), mode="complete")[1],
    "singular_values": lambda A: xp.linalg.svd(
        _as_f(A), compute_uv=False
    ),
    "svd_U": lambda A: xp.linalg.svd(_as_f(A), full_matrices=False)[0],
    "svd_V": lambda A: xp.swapaxes(
        xp.linalg.svd(_as_f(A), full_matrices=False)[2], -1, -2
    ),
    "generalized_inverse": lambda A: xp.linalg.pinv(_as_f(A)),
    "crossprod": lambda A: _transpose(_as_f(A)) @ _as_f(A),
    "tcrossprod": lambda A: _as_f(A) @ _transpose(_as_f(A)),
    # constants
    # (log2()/log10() as 0-arg constants are handled by arity dispatch in
    # the interpreter; the dict entries above are the 1-arg functions)
    "pi": lambda: xp.pi,
    "e": lambda: xp.e,
    "sqrt2": lambda: xp.sqrt(2.0),
    "machine_precision": lambda: xp.finfo(xp.fdtype()).eps,
    "positive_infinity": lambda: xp.inf,
    "negative_infinity": lambda: -xp.inf,
    "not_a_number": lambda: xp.nan,
}


# ------------------------------------------------- round-5 breadth additions
# (reference: BridgeStan inherits all of Stan math's C++,
# src/stan.rs:449-463; each entry re-derived on torch
# primitives and scipy cross-checked in tests/test_stanlib_breadth.py)

def inv_chi_square_lpdf(y, nu):
    y, nu = _as_f(y), _as_f(nu)
    h = nu / 2.0
    return -(h + 1.0) * xp.log(y) - 0.5 / y - sp.gammaln(h) - h * xp.log(2.0)


def scaled_inv_chi_square_lpdf(y, nu, s):
    y, nu, s = _as_f(y), _as_f(nu), _as_f(s)
    h = nu / 2.0
    return (
        h * xp.log(h) + nu * xp.log(s) - sp.gammaln(h)
        - (h + 1.0) * xp.log(y) - h * s * s / y
    )


def pareto_type_2_lpdf(y, mu, lam, alpha):
    y, mu, lam, alpha = _as_f(y), _as_f(mu), _as_f(lam), _as_f(alpha)
    return (
        xp.log(alpha) - xp.log(lam)
        - (alpha + 1.0) * xp.log1p((y - mu) / lam)
    )


def multi_normal_prec_lpdf(y, mu, Omega):
    y, mu, Omega = _as_f(y), _as_f(mu), _as_f(Omega)
    d = y.shape[-1]
    chol = xp.linalg.cholesky(Omega)  # Omega = L L^T
    diff = y - mu
    z = xp.einsum("...ij,...j->...i", xp.swapaxes(chol, -1, -2), diff)
    return (
        -0.5 * xp.sum(z * z, axis=-1)
        + xp.sum(xp.log(xp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
        - 0.5 * d * xp.log(2 * xp.pi)
    )


def multi_student_t_cholesky_lpdf(y, nu, mu, L):
    y, nu, mu, L = _as_f(y), _as_f(nu), _as_f(mu), _as_f(L)
    d = y.shape[-1]
    diff = y - mu
    z = _tri_solve_rows(L, diff)
    q = xp.sum(z * z, axis=-1)
    return (
        sp.gammaln((nu + d) / 2.0) - sp.gammaln(nu / 2.0)
        - 0.5 * d * xp.log(nu * xp.pi)
        - xp.sum(xp.log(xp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
        - 0.5 * (nu + d) * xp.log1p(q / nu)
    )


def neg_binomial_lpmf(y, alpha, beta):
    # Stan's v1 parameterization: y ~ NB(alpha, beta), mean alpha/beta
    y, alpha, beta = _as_f(y), _as_f(alpha), _as_f(beta)
    return (
        sp.gammaln(y + alpha) - sp.gammaln(alpha) - sp.gammaln(y + 1)
        + alpha * xp.log(beta / (beta + 1.0)) - y * xp.log1p(beta)
    )


def hypergeometric_lpmf(y, N, a, b):
    y, N, a, b = _as_f(y), _as_f(N), _as_f(a), _as_f(b)

    def lchoose(n, k):
        return (
            sp.gammaln(n + 1) - sp.gammaln(k + 1) - sp.gammaln(n - k + 1)
        )

    return lchoose(a, y) + lchoose(b, N - y) - lchoose(a + b, N)


def discrete_range_lpmf(y, lower, upper):
    y, lower, upper = _as_f(y), _as_f(lower), _as_f(upper)
    inside = (y >= lower) & (y <= upper)
    return xp.where(inside, -xp.log(upper - lower + 1.0), -xp.inf)


def wiener_lpdf(y, alpha, tau, beta, delta):
    """First-passage density of a Wiener diffusion at the LOWER boundary
    (Stan's wiener_lpdf): Navarro & Fuss (2009) with both the small-time
    and large-time series at fixed truncation, selected per element."""
    y, alpha = _as_f(y), _as_f(alpha)
    tau, beta, delta = _as_f(tau), _as_f(beta), _as_f(delta)
    t = (y - tau) / (alpha * alpha)  # normalized time
    t = xp.maximum(t, 1e-9)
    w = beta

    ks = xp.arange(-7, 8, dtype=t.dtype)
    terms_s = (w + 2.0 * ks) * xp.exp(
        -0.5 * xp.square(w + 2.0 * ks) / t[..., None]
    )
    f_small = xp.sum(terms_s, axis=-1) / xp.sqrt(
        2.0 * xp.pi * t ** 3
    )

    kl = xp.arange(1, 11, dtype=t.dtype)
    terms_l = kl * xp.exp(-0.5 * xp.square(kl * xp.pi) * t[..., None]) \
        * xp.sin(kl * xp.pi * w)
    f_large = xp.pi * xp.sum(terms_l, axis=-1)

    f = xp.where(t < 0.75, f_small, f_large)
    log_f = xp.log(xp.maximum(f, 1e-300))
    return (
        log_f - 2.0 * xp.log(alpha)
        - delta * alpha * w - 0.5 * delta * delta * (y - tau)
    )


DISTRIBUTIONS.update({
    "inv_chi_square": inv_chi_square_lpdf,
    "scaled_inv_chi_square": scaled_inv_chi_square_lpdf,
    "pareto_type_2": pareto_type_2_lpdf,
    "multi_normal_prec": multi_normal_prec_lpdf,
    "multi_student_t_cholesky": multi_student_t_cholesky_lpdf,
    "neg_binomial": neg_binomial_lpmf,
    "hypergeometric": hypergeometric_lpmf,
    "discrete_range": discrete_range_lpmf,
    "wiener": wiener_lpdf,
})


# --- cdf breadth: every continuous/count family with a jsp special-function
# representation gets lcdf/lccdf (and therefore _cdf via the interpreter)

def beta_lcdf(y, alpha, beta):
    return xp.log(sp.betainc(alpha, beta, _as_f(y)))


def beta_lccdf(y, alpha, beta):
    return xp.log1p(-sp.betainc(alpha, beta, _as_f(y)))


def chi_square_lcdf(y, nu):
    return xp.log(sp.gammainc(nu / 2.0, 0.5 * _as_f(y)))


def chi_square_lccdf(y, nu):
    return xp.log1p(-sp.gammainc(nu / 2.0, 0.5 * _as_f(y)))


def inv_chi_square_lcdf(y, nu):
    return xp.log1p(-sp.gammainc(nu / 2.0, 0.5 / _as_f(y)))


def inv_chi_square_lccdf(y, nu):
    return xp.log(sp.gammainc(nu / 2.0, 0.5 / _as_f(y)))


def scaled_inv_chi_square_lcdf(y, nu, s):
    h = nu / 2.0
    return xp.log1p(-sp.gammainc(h, h * s * s / _as_f(y)))


def scaled_inv_chi_square_lccdf(y, nu, s):
    h = nu / 2.0
    return xp.log(sp.gammainc(h, h * s * s / _as_f(y)))


def inv_gamma_lcdf(y, alpha, beta):
    return xp.log1p(-sp.gammainc(alpha, beta / _as_f(y)))


def inv_gamma_lccdf(y, alpha, beta):
    return xp.log(sp.gammainc(alpha, beta / _as_f(y)))


def double_exponential_lcdf(y, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    return xp.where(
        z < 0, xp.log(0.5) + z, xp.log1p(-0.5 * xp.exp(-z))
    )


def double_exponential_lccdf(y, mu, sigma):
    z = (_as_f(y) - mu) / sigma
    return xp.where(
        z < 0, xp.log1p(-0.5 * xp.exp(z)), xp.log(0.5) - z
    )


def pareto_lcdf(y, y_min, alpha):
    return xp.log1p(-((y_min / _as_f(y)) ** alpha))


def pareto_lccdf(y, y_min, alpha):
    return alpha * (xp.log(y_min) - xp.log(_as_f(y)))


def pareto_type_2_lcdf(y, mu, lam, alpha):
    return xp.log1p(-((1.0 + (_as_f(y) - mu) / lam) ** (-alpha)))


def pareto_type_2_lccdf(y, mu, lam, alpha):
    return -alpha * xp.log1p((_as_f(y) - mu) / lam)


def frechet_lcdf(y, alpha, sigma):
    return -((sigma / _as_f(y)) ** alpha)


def frechet_lccdf(y, alpha, sigma):
    return xp.log1p(-xp.exp(-((sigma / _as_f(y)) ** alpha)))


def rayleigh_lcdf(y, sigma):
    z = _as_f(y) / sigma
    return xp.log1p(-xp.exp(-0.5 * z * z))


def rayleigh_lccdf(y, sigma):
    z = _as_f(y) / sigma
    return -0.5 * z * z


def std_normal_lcdf(y):
    return sp.log_ndtr(_as_f(y))


def std_normal_lccdf(y):
    return sp.log_ndtr(-_as_f(y))


def exp_mod_normal_lcdf(y, mu, sigma, lam):
    y = _as_f(y)
    u = lam * (y - mu)
    v = lam * sigma
    cdf = sp.ndtr((y - mu) / sigma) - xp.exp(
        -u + 0.5 * v * v + sp.log_ndtr(u / v - v)
    )
    return xp.log(xp.maximum(cdf, 1e-300))


def exp_mod_normal_lccdf(y, mu, sigma, lam):
    y = _as_f(y)
    u = lam * (y - mu)
    v = lam * sigma
    cdf = sp.ndtr((y - mu) / sigma) - xp.exp(
        -u + 0.5 * v * v + sp.log_ndtr(u / v - v)
    )
    return xp.log1p(-xp.minimum(cdf, 1.0 - 1e-16))


def poisson_lcdf(y, lam):
    # P(Y <= y) = Q(floor(y)+1, lam) (regularized upper incomplete gamma)
    return xp.log(sp.gammaincc(xp.floor(_as_f(y)) + 1.0, _as_f(lam)))


def poisson_lccdf(y, lam):
    return xp.log(sp.gammainc(xp.floor(_as_f(y)) + 1.0, _as_f(lam)))


def binomial_lcdf(y, n, theta):
    # P(Y <= y) = I_{1-theta}(n - y, y + 1)
    y, n = xp.floor(_as_f(y)), _as_f(n)
    return xp.log(sp.betainc(n - y, y + 1.0, 1.0 - _as_f(theta)))


def binomial_lccdf(y, n, theta):
    y, n = xp.floor(_as_f(y)), _as_f(n)
    return xp.log1p(-sp.betainc(n - y, y + 1.0, 1.0 - _as_f(theta)))


def neg_binomial_2_lcdf(y, mu, phi):
    # NB2 cdf = I_{phi/(phi+mu)}(phi, y+1)
    y = xp.floor(_as_f(y))
    p = phi / (phi + _as_f(mu))
    return xp.log(sp.betainc(_as_f(phi), y + 1.0, p))


def neg_binomial_2_lccdf(y, mu, phi):
    y = xp.floor(_as_f(y))
    p = phi / (phi + _as_f(mu))
    return xp.log1p(-sp.betainc(_as_f(phi), y + 1.0, p))


def bernoulli_lcdf(y, theta):
    y = xp.floor(_as_f(y))
    cdf = xp.where(y < 0, 0.0, xp.where(y < 1, 1.0 - _as_f(theta), 1.0))
    return xp.log(xp.maximum(cdf, 1e-300))


def bernoulli_lccdf(y, theta):
    y = xp.floor(_as_f(y))
    ccdf = xp.where(y < 0, 1.0, xp.where(y < 1, _as_f(theta), 0.0))
    return xp.log(xp.maximum(ccdf, 1e-300))


LCDFS.update({
    "beta": beta_lcdf,
    "chi_square": chi_square_lcdf,
    "inv_chi_square": inv_chi_square_lcdf,
    "scaled_inv_chi_square": scaled_inv_chi_square_lcdf,
    "inv_gamma": inv_gamma_lcdf,
    "double_exponential": double_exponential_lcdf,
    "pareto": pareto_lcdf,
    "pareto_type_2": pareto_type_2_lcdf,
    "frechet": frechet_lcdf,
    "rayleigh": rayleigh_lcdf,
    "std_normal": std_normal_lcdf,
    "exp_mod_normal": exp_mod_normal_lcdf,
    "poisson": poisson_lcdf,
    "binomial": binomial_lcdf,
    "neg_binomial_2": neg_binomial_2_lcdf,
    "bernoulli": bernoulli_lcdf,
})
LCCDFS.update({
    "beta": beta_lccdf,
    "chi_square": chi_square_lccdf,
    "inv_chi_square": inv_chi_square_lccdf,
    "scaled_inv_chi_square": scaled_inv_chi_square_lccdf,
    "inv_gamma": inv_gamma_lccdf,
    "double_exponential": double_exponential_lccdf,
    "pareto": pareto_lccdf,
    "pareto_type_2": pareto_type_2_lccdf,
    "frechet": frechet_lccdf,
    "rayleigh": rayleigh_lccdf,
    "std_normal": std_normal_lccdf,
    "exp_mod_normal": exp_mod_normal_lccdf,
    "poisson": poisson_lccdf,
    "binomial": binomial_lccdf,
    "neg_binomial_2": neg_binomial_2_lccdf,
    "bernoulli": bernoulli_lccdf,
})


# --- function breadth

_OWENS_T_NODES, _OWENS_T_WEIGHTS = np.polynomial.legendre.leggauss(48)


def _owens_t_quad(h, a):
    """T(h, a) for |a| <= 1 by 48-point Gauss-Legendre on the defining
    integral T(h,a) = (1/2pi) int_0^a exp(-h^2(1+x^2)/2)/(1+x^2) dx."""
    half_a = 0.5 * a
    acc = 0.0
    for xj, wj in zip(_OWENS_T_NODES, _OWENS_T_WEIGHTS):
        x = half_a * (xj + 1.0)
        acc = acc + float(wj) * xp.exp(-0.5 * h * h * (1.0 + x * x)) / (
            1.0 + x * x
        )
    return half_a * acc / (2.0 * xp.pi)


def owens_t(h, a):
    """Owen's T function, differentiable in both arguments.

    T is even in h and odd in a.  For |a| <= 1 the quadrature converges to
    about 1e-14; for |a| > 1 Owen's (1956) identity
    T(h, a) = Phi(h)/2 + Phi(ah)/2 - Phi(h) Phi(ah) - T(ah, 1/a)  (h >= 0)
    reduces the argument, since the integrand's width in x shrinks like
    1/h and the quadrature over [0, a] misses it for large a."""
    h, a = _as_f(h), _as_f(a)
    h = xp.abs(h)
    sa = xp.abs(a)
    big = sa > 1.0
    sa_small = xp.where(big, 1.0, sa)
    sa_big = xp.where(big, sa, 2.0)
    ph, pah = sp.ndtr(h), sp.ndtr(sa_big * h)
    t_big = (0.5 * ph + 0.5 * pah - ph * pah
             - _owens_t_quad(sa_big * h, 1.0 / sa_big))
    t = xp.where(big, t_big, _owens_t_quad(h, sa_small))
    return xp.where(a < 0, -t, t)


# Gauss-Laguerre nodes for the skew normal's lower tail
_LAGUERRE_NODES, _LAGUERRE_WEIGHTS = np.polynomial.laguerre.laggauss(48)


def skew_normal_lcdf(y, xi, omega, alpha):
    """log F(z) = log(Phi(z) - 2 T(z, alpha)).

    Where z < 0 and alpha > 0 both terms are nearly equal and the
    difference cancels (it underflows to 0 from z alpha of about -8).
    There F is written as an integral with a positive integrand,
    F(z) = (1/pi) int_alpha^inf exp(-z^2(1+x^2)/2)/(1+x^2) dx
         = exp(-z^2(1+alpha^2)/2)/(pi z^2) int_0^inf e^-u g(u) du,
    g(u) = 1/((1+x^2) x) with x = sqrt(alpha^2 + 2u/z^2), taken by
    Gauss-Laguerre quadrature in log space; g is smooth on the scale of
    e^-u once z^2 alpha^2 / 2 >= 1, which selects this branch."""
    z = (_as_f(y) - xi) / omega
    alpha = _as_f(alpha)
    tail = (z < 0) & (alpha > 0) & (z * z * alpha * alpha >= 2.0)
    zt = xp.where(tail, z, -2.0)
    at = xp.where(tail, alpha, 2.0)
    z2 = zt * zt
    acc = 0.0
    for uj, wj in zip(_LAGUERRE_NODES, _LAGUERRE_WEIGHTS):
        x2 = at * at + 2.0 * float(uj) / z2
        acc = acc + float(wj) / ((1.0 + x2) * xp.sqrt(x2))
    log_tail = -0.5 * z2 * (1.0 + at * at) - xp.log(xp.pi * z2) + xp.log(acc)
    zd = xp.where(tail, 0.0, z)
    cdf = sp.ndtr(zd) - 2.0 * owens_t(zd, alpha)
    return xp.where(tail, log_tail, xp.log(xp.maximum(cdf, 1e-300)))


def skew_normal_lccdf(y, xi, omega, alpha):
    z = (_as_f(y) - xi) / omega
    cdf = sp.ndtr(z) - 2.0 * owens_t(z, alpha)
    return xp.log1p(-xp.minimum(cdf, 1.0 - 1e-16))


LCDFS["skew_normal"] = skew_normal_lcdf
LCCDFS["skew_normal"] = skew_normal_lccdf


FUNCTIONS.update({
    "owens_t": owens_t,
    "trace_quad_form": lambda A, B: xp.trace(
        _transpose(_as_f(B)) @ _as_f(A) @ _as_f(B)
    ),
    "rank": lambda v, s: xp.sum(
        (_as_f(v) < _as_f(v)[..., xp.asarray(s) - 1]).to(torch.int64),
        axis=-1,
    ),
    "sort_indices_asc": lambda v: xp.argsort(_as_f(v), axis=-1) + 1,
    "sort_indices_desc": lambda v: xp.argsort(-_as_f(v), axis=-1) + 1,
    "uniform_simplex": lambda n: xp.full((int(n),), 1.0 / float(n)),
    "to_array_2d": lambda m: xp.asarray(m),
    "std_normal_log_qf": lambda lp: sp.ndtri(xp.exp(_as_f(lp))),
})


RNG_FUNCTIONS.update({
    "inv_chi_square_rng": lambda key, nu: 1.0 / (
        2.0 * rng.gamma(key, _as_f(nu) / 2.0, _bshape(nu))
    ),
    "scaled_inv_chi_square_rng": lambda key, nu, s: (
        _as_f(nu) * _as_f(s) ** 2
        / (2.0 * rng.gamma(key, _as_f(nu) / 2.0, _bshape(nu, s)))
    ),
    "pareto_type_2_rng": lambda key, mu, lam, alpha: _as_f(mu) + _as_f(lam) * (
        (1.0 - rng.uniform(key, _bshape(mu, lam, alpha)))
        ** (-1.0 / _as_f(alpha)) - 1.0
    ),
    "pareto_rng": lambda key, y_min, alpha: _as_f(y_min) * (
        (1.0 - rng.uniform(key, _bshape(y_min, alpha)))
        ** (-1.0 / _as_f(alpha))
    ),
    "neg_binomial_rng": lambda key, alpha, beta: rng.poisson(
        rng.split(key)[0],
        rng.gamma(rng.split(key)[1], _as_f(alpha),
                         _bshape(alpha, beta)) / _as_f(beta),
    ),
    "neg_binomial_2_rng": lambda key, mu, phi: rng.poisson(
        rng.split(key)[0],
        rng.gamma(rng.split(key)[1], _as_f(phi),
                         _bshape(mu, phi)) * _as_f(mu) / _as_f(phi),
    ),
    "discrete_range_rng": lambda key, lo, hi: rng.randint(
        key, _bshape(lo, hi), xp.asarray(lo), xp.asarray(hi) + 1
    ),
    "frechet_rng": lambda key, alpha, sigma: _as_f(sigma) * (
        -xp.log(rng.uniform(key, _bshape(alpha, sigma)))
    ) ** (-1.0 / _as_f(alpha)),
    "gumbel_rng": lambda key, mu, beta: _as_f(mu) - _as_f(beta) * xp.log(
        -xp.log(rng.uniform(key, _bshape(mu, beta)))
    ),
    "logistic_rng": lambda key, mu, sigma: _as_f(mu) + _as_f(sigma) * (
        rng.logistic(key, _bshape(mu, sigma))
    ),
})


def skew_double_exponential_lcdf(y, mu, sigma, tau):
    # cdf: tau * exp((1-tau) z / sigma ... Stan: for y < mu:
    #   tau * exp((1-tau)(y-mu)/sigma); else 1 - (1-tau) exp(-tau (y-mu)/sigma)
    z = _as_f(y) - _as_f(mu)
    t, s = _as_f(tau), _as_f(sigma)
    lo = xp.log(t) + (1.0 - t) * z * 2.0 / s
    hi = xp.log1p(-(1.0 - t) * xp.exp(-t * z * 2.0 / s))
    return xp.where(z < 0, lo, hi)


def skew_double_exponential_lccdf(y, mu, sigma, tau):
    z = _as_f(y) - _as_f(mu)
    t, s = _as_f(tau), _as_f(sigma)
    lo = xp.log1p(-t * xp.exp((1.0 - t) * z * 2.0 / s))
    hi = xp.log1p(-t) - t * z * 2.0 / s
    return xp.where(z < 0, lo, hi)


def beta_proportion_lcdf(y, mu, kappa):
    m, k = _as_f(mu), _as_f(kappa)
    return xp.log(sp.betainc(m * k, (1.0 - m) * k, _as_f(y)))


def beta_proportion_lccdf(y, mu, kappa):
    m, k = _as_f(mu), _as_f(kappa)
    return xp.log1p(-sp.betainc(m * k, (1.0 - m) * k, _as_f(y)))


def neg_binomial_lcdf(y, alpha, beta):
    yv = xp.floor(_as_f(y))
    p = _as_f(beta) / (_as_f(beta) + 1.0)
    return xp.log(sp.betainc(_as_f(alpha), yv + 1.0, p))


def neg_binomial_lccdf(y, alpha, beta):
    yv = xp.floor(_as_f(y))
    p = _as_f(beta) / (_as_f(beta) + 1.0)
    return xp.log1p(-sp.betainc(_as_f(alpha), yv + 1.0, p))


LCDFS.update({
    "skew_double_exponential": skew_double_exponential_lcdf,
    "beta_proportion": beta_proportion_lcdf,
    "neg_binomial": neg_binomial_lcdf,
})
LCCDFS.update({
    "skew_double_exponential": skew_double_exponential_lccdf,
    "beta_proportion": beta_proportion_lccdf,
    "neg_binomial": neg_binomial_lccdf,
})


def beta_binomial_lcdf(y, n, alpha, beta):
    # y and n are Stan ints (data) -> host values; the cdf is
    # the exact logsumexp over k = 0..floor(y)
    y_c = int(np.floor(float(np.asarray(y))))
    ks = xp.arange(0, max(y_c, 0) + 1)
    lps = beta_binomial_lpmf(ks, n, alpha, beta)
    out = sp.logsumexp(lps)
    return xp.where(xp.asarray(y_c) < 0, -xp.inf, out)


def beta_binomial_lccdf(y, n, alpha, beta):
    y_c = int(np.floor(float(np.asarray(y))))
    n_c = int(np.asarray(n))
    ks = xp.arange(min(y_c + 1, n_c + 1), n_c + 1)
    if ks.shape[0] == 0:
        return xp.asarray(-xp.inf)
    lps = beta_binomial_lpmf(ks, n, alpha, beta)
    return sp.logsumexp(lps)


LCDFS["beta_binomial"] = beta_binomial_lcdf
LCCDFS["beta_binomial"] = beta_binomial_lccdf
