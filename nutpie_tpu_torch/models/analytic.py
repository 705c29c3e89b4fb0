"""Analytic test posteriors with known moments, as batched torch logps.

Ports ``nutpie_tpu/models/analytic.py``: the same seven models, the same
variables, coords and expand outputs, with every log density written
batched, ``x [C, ndim] -> [C]``, so one call (and one autograd pass)
serves every chain.  Model data live in tensors cached per device and
dtype and built on first use, so no call copies data to the device.  A
logp follows ``x.device`` and ``x.dtype``, as a user's logp given to
``from_pyfunc`` must.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import ModelDef, make_model


def _data_cache(**arrays):
    """``data(ref, dtype=None)``: the arrays as tensors on ``ref``'s device,
    in ``dtype`` (default ``ref.dtype``), built once per device and dtype."""
    cache: dict = {}

    def data(ref: torch.Tensor, dtype=None) -> dict:
        key = (ref.device, dtype or ref.dtype)
        if key not in cache:
            cache[key] = {name: torch.as_tensor(a, dtype=key[1], device=ref.device)
                          for name, a in arrays.items()}
        return cache[key]

    return data


def std_normal(dim: int = 1, mu: float = 0.0, sigma: float = 1.0) -> ModelDef:
    """Independent normals: the Stan README model generalized to ``dim``."""

    def logp(x):
        z = (x - mu) / sigma
        return -0.5 * torch.sum(z * z, dim=1)

    return make_model(
        dim,
        logp,
        param_vars=[("x", np.float64, (dim,), ("unconstrained_parameter",))],
    )


def _v_x_expand(q):
    return {"v": q[:, 0], "x": q[:, 1:]}


def _v_x_vars(dim):
    return [("v", np.float64, (), None), ("x", np.float64, (dim,), ("x_dim",))]


def funnel(dim: int = 10, scale: float = 3.0) -> ModelDef:
    """Neal's funnel: v ~ N(0, scale^2); x_i ~ N(0, exp(v/2)^2).

    ``dim`` counts the x block, so ndim is ``dim + 1`` with v first.
    """

    def logp(q):
        v, x = q[:, 0], q[:, 1:]
        logp_v = -0.5 * (v / scale) ** 2
        logp_x = -0.5 * torch.sum(x * x, dim=1) * torch.exp(-v) - 0.5 * dim * v
        return logp_v + logp_x

    return make_model(dim + 1, logp, expand_fn=_v_x_expand,
                      expanded_vars=_v_x_vars(dim), param_vars=_v_x_vars(dim))


def student_t_funnel(dim: int = 50, nu: float = 3.0,
                     scale: float = 3.0) -> ModelDef:
    """Heavy-tailed funnel: v ~ StudentT(nu, 0, scale);
    x_i ~ StudentT(nu, 0, exp(v/2)).  ndim = dim + 1 with v first."""

    half = 0.5 * (nu + 1.0)

    def t_logpdf_unit(z):
        # unnormalized StudentT(nu, 0, 1) log density
        return -half * torch.log1p(z * z / nu)

    def logp(q):
        v, x = q[:, 0], q[:, 1:]
        logp_v = t_logpdf_unit(v / scale)
        # scale family: subtract dim * log(scale) = dim * v/2
        logp_x = (torch.sum(t_logpdf_unit(x * torch.exp(-0.5 * v)[:, None]), dim=1)
                  - 0.5 * dim * v)
        return logp_v + logp_x

    return make_model(dim + 1, logp, expand_fn=_v_x_expand,
                      expanded_vars=_v_x_vars(dim), param_vars=_v_x_vars(dim))


def hierarchical_funnel(groups: int = 8, dim: int = 8,
                        scale: float = 1.5) -> ModelDef:
    """A funnel of funnels: tau ~ N(0, scale^2); v_g ~ N(0, exp(tau/2)^2);
    x_{g,i} ~ N(0, exp(v_g/2)^2).  Layout [tau, v_1..v_G, x_11..x_GK]."""

    G, K = groups, dim
    ndim = 1 + G + G * K

    def logp(q):
        tau = q[:, 0]
        v = q[:, 1 : 1 + G]
        x = q[:, 1 + G :].reshape(-1, G, K)
        logp_tau = -0.5 * (tau / scale) ** 2
        logp_v = -0.5 * torch.sum(v * v, dim=1) * torch.exp(-tau) - 0.5 * G * tau
        logp_x = (
            -0.5 * torch.sum(torch.sum(x * x, dim=2) * torch.exp(-v), dim=1)
            - 0.5 * K * torch.sum(v, dim=1)
        )
        return logp_tau + logp_v + logp_x

    def expand(q):
        return {
            "tau": q[:, 0],
            "v": q[:, 1 : 1 + G],
            "x": q[:, 1 + G :].reshape(-1, G, K),
        }

    return make_model(
        ndim,
        logp,
        expand_fn=expand,
        expanded_vars=[
            ("tau", np.float64, (), None),
            ("v", np.float64, (G,), ("group",)),
            ("x", np.float64, (G, K), ("group", "x_dim")),
        ],
        param_vars=[
            ("tau", np.float64, (), None),
            ("v", np.float64, (G,), ("group",)),
            ("x", np.float64, (G * K,), ("group_x",)),
        ],
    )


def ill_conditioned_gaussian(
    dim: int = 1000, condition: float = 1e4, seed: int = 0, correlate: bool = True
) -> ModelDef:
    """Zero-mean Gaussian with log-spaced eigenvalues and a random rotation
    (``correlate=False``: diagonal covariance)."""

    rng = np.random.default_rng(seed)
    eigs = np.logspace(0, np.log10(condition), dim)
    if correlate:
        q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
        # precision P = prec_half @ prec_half.T; logp = -0.5 x^T P x
        data = _data_cache(prec_half=q * (1.0 / np.sqrt(eigs)))

        def logp(x):
            y = x @ data(x)["prec_half"]
            return -0.5 * torch.sum(y * y, dim=1)

    else:
        data = _data_cache(inv_eigs=1.0 / eigs)

        def logp(x):
            return -0.5 * torch.sum(x * x * data(x)["inv_eigs"], dim=1)

    return make_model(
        dim,
        logp,
        param_vars=[("x", np.float64, (dim,), ("unconstrained_parameter",))],
    )


def eight_schools(centered: bool = False) -> ModelDef:
    """The eight-schools hierarchical model (non-centered by default)."""

    data = _data_cache(
        y=np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]),
        sigma=np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]),
    )

    def logp(q):
        d = data(q)
        mu, log_tau, theta_t = q[:, 0], q[:, 1], q[:, 2:]
        tau = torch.exp(log_tau)
        lp = -0.5 * (mu / 5.0) ** 2
        lp = lp + -0.5 * (log_tau / 1.0) ** 2  # log-normal prior on tau
        if centered:
            theta = theta_t
            lp = lp + (torch.sum(-0.5 * ((theta - mu[:, None]) / tau[:, None]) ** 2, dim=1)
                       - 8 * log_tau)
        else:
            theta = mu[:, None] + tau[:, None] * theta_t
            lp = lp + torch.sum(-0.5 * theta_t**2, dim=1)
        lp = lp + torch.sum(-0.5 * ((d["y"] - theta) / d["sigma"]) ** 2, dim=1)
        return lp

    def expand(q):
        mu, log_tau, theta_t = q[:, 0], q[:, 1], q[:, 2:]
        tau = torch.exp(log_tau)
        theta = theta_t if centered else mu[:, None] + tau[:, None] * theta_t
        return {"mu": mu, "tau": tau, "theta": theta}

    return make_model(
        10,
        logp,
        expand_fn=expand,
        expanded_vars=[
            ("mu", np.float64, (), None),
            ("tau", np.float64, (), None),
            ("theta", np.float64, (8,), ("school",)),
        ],
        param_vars=[
            ("mu", np.float64, (), None),
            ("log_tau", np.float64, (), None),
            ("theta_raw", np.float64, (8,), ("school",)),
        ],
        coords={"school": list(range(8))},
        reparameterized_names=("theta_raw",) if not centered else (),
    )


def glm_data(n_data: int = 1024, dim: int = 64, seed: int = 0):
    """The simulated design matrix ``X [n_data, dim]`` and outcomes ``y``
    of ``logistic_glm`` (float32 numpy arrays, the JAX model's draws)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_data, dim)).astype(np.float32)
    beta_true = rng.standard_normal(dim) / np.sqrt(dim)
    logits = X @ beta_true
    y = (rng.random(n_data) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return X, y


def logistic_glm(
    n_data: int = 1024, dim: int = 64, seed: int = 0
) -> ModelDef:
    """Logistic regression with simulated data (the many-chain benchmark).

    The logp is one ``[C, dim] x [dim, n_data]`` product per call.  Its
    arithmetic is the JAX model's: ``X`` and ``y`` are float32 and the
    coefficients are cast to float32 for the product, in every run dtype;
    the softplus is the select-free form.
    """

    X, y = glm_data(n_data, dim, seed)
    data = _data_cache(Xt=np.ascontiguousarray(X.T), y=y)

    def logp(beta):
        d = data(beta, torch.float32)
        logits = beta.to(torch.float32) @ d["Xt"]
        # sum(y*logits - softplus(logits)), softplus as (x + |x|)/2 +
        # log1p(exp(-|x|)) with |x| = sqrt(x^2 + tiny)
        ax = torch.sqrt(logits * logits + 1e-30)
        softplus = 0.5 * (logits + ax) + torch.log1p(torch.exp(-ax))
        lp = torch.sum(d["y"] * logits - softplus, dim=1)
        return lp.to(beta.dtype) - 0.5 * torch.sum(beta * beta, dim=1)

    return make_model(
        dim,
        logp,
        param_vars=[("beta", np.float64, (dim,), ("coef",))],
        coords={"coef": list(range(dim))},
    )
