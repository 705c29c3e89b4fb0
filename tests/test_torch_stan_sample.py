"""Stan models sampled end to end by the port on the CPU.

- The golden Stan cases of ``tests/test_golden.py:36-80`` (``stan_mu`` and
  ``stan_y_rep``: 2 chains x (150 + 100), seed 2026): the port's chains
  differ from the JAX package's (its normals agree to a few ULP and every
  warmup amplifies rounding), so each variable is held to the committed
  JAX draws ``tests/reference/stan_*.npy`` in distribution: its mean and
  standard deviation within 5 Monte Carlo standard errors (the MCSE from
  each trace's own effective sample size, combined).  The files are only
  read.  ``y_rep`` is recomputed from the trace's positions and the
  expansion's keys.
- A correlated 3-d Gaussian written in Stan under
  ``adaptation="low_rank"``, and an iid 4-d normal under
  ``sampler="mclmc"``: each coordinate's mean and variance (the mean of
  its squared distance from the true mean) within 5 MCSE of the truth
  (MCLMC's variance, which its tuned step biases, within 30%).

float64; vmap's per-example fallback warning is an error here.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import nutpie_tpu_torch as nt
from nutpie_tpu_torch.diagnostics import ess
from nutpie_tpu_torch.sample import expand_keys

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

torch.set_num_threads(1)

REFERENCE = Path(__file__).parent / "reference"

GOLDEN = """
data { int N; vector[N] y; }
parameters { real mu; real<lower=0> sigma; }
model {
  mu ~ normal(0, 5);
  sigma ~ normal(0, 2);
  y ~ normal(mu, sigma);
}
generated quantities {
  real y_rep = normal_rng(mu, sigma);
}
"""

GAUSSIAN = """
data { vector[3] m; matrix[3, 3] S; }
parameters { vector[3] x; }
model { x ~ multi_normal(m, S); }
"""
NORMAL4 = "parameters { vector[4] x; } model { x ~ normal(2, 1.5); }"
M = np.array([1.0, -2.0, 0.5])
S = np.array([[1.0, 0.6, 0.0], [0.6, 2.0, -0.3], [0.0, -0.3, 0.5]])


def _mcse(draws: np.ndarray):
    """MCSEs of the mean and of the standard deviation of ``[chains, draws]``."""
    n_eff = max(float(ess(draws)), 2.0)
    sd = float(draws.std())
    return sd / np.sqrt(n_eff), sd / np.sqrt(2.0 * (n_eff - 1.0))


@pytest.fixture(scope="module")
def golden_trace():
    rng = np.random.default_rng(13)
    y = 1.5 + 0.8 * rng.standard_normal(50)
    model = nt.compile_stan_model(GOLDEN).with_data(N=50, y=y)
    return model, nt.sample(model, chains=2, draws=100, tune=150, seed=2026, device="cpu",
                            progress_bar=False, return_raw_trace=True)


@pytest.mark.parametrize("var", ["mu", "y_rep"])
def test_golden_stan_draws_in_distribution(golden_trace, var):
    _, raw = golden_trace
    got = np.asarray(raw["expanded"][var])[:, 150:]
    ref = np.load(REFERENCE / f"stan_{var}.npy")
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    (m1, s1), (m2, s2) = _mcse(got), _mcse(ref)
    assert abs(got.mean() - ref.mean()) < 5.0 * np.hypot(m1, m2), (got.mean(), ref.mean())
    assert abs(got.std() - ref.std()) < 5.0 * np.hypot(s1, s2), (got.std(), ref.std())


def test_golden_y_rep_from_positions_and_keys(golden_trace):
    model, raw = golden_trace
    pos = np.asarray(raw["position"])
    C, L, _ = pos.shape
    keys = expand_keys(2026, C, L, 0, "cpu").reshape(C * L, 2)
    again = model._make_model(0).expand_fn(torch.as_tensor(pos.reshape(C * L, -1)), keys)
    assert np.array_equal(again["y_rep"].numpy().reshape(C, L), np.asarray(raw["expanded"]["y_rep"]))


def _hold_moments(x, m, s, var_rtol=None):
    """Means within 5 MCSE of ``m``; variances within 5 MCSE of ``s``, or
    within ``var_rtol`` of it where the sampler itself is biased."""
    assert np.isfinite(x).all()
    for i in range(len(m)):
        xi = x[..., i]
        mcse, _ = _mcse(xi)
        assert abs(xi.mean() - m[i]) < 5.0 * mcse, (i, xi.mean(), mcse)
        sq = (xi - m[i]) ** 2
        if var_rtol is not None:
            assert abs(sq.mean() / s[i] - 1.0) < var_rtol, (i, sq.mean())
            continue
        mcse_var, _ = _mcse(sq)
        assert abs(sq.mean() - s[i]) < 5.0 * mcse_var, (i, sq.mean(), mcse_var)


def test_low_rank_gaussian_moments():
    model = nt.compile_stan_model(GAUSSIAN).with_data(m=M, S=S)
    trace = nt.sample(model, chains=2, tune=300, draws=300, seed=5, device="cpu",
                      progress_bar=False, adaptation="low_rank")
    _hold_moments(np.asarray(trace.posterior["x"].values), M, np.diag(S))


def test_mclmc_normal_moments():
    """MCLMC on an iid normal written in Stan.  MCLMC's tuned step leaves a
    discretization bias in the variance (about 13% low here, as on the same
    target in ``tests/test_torch_mclmc_sample.py``, whose bar on the
    standard deviation is 0.2 of 1.5): the variance is held to 30%."""
    model = nt.compile_stan_model(NORMAL4)
    trace = nt.sample(model, chains=4, tune=600, draws=2000, seed=21, device="cpu",
                      progress_bar=False, sampler="mclmc")
    _hold_moments(np.asarray(trace.posterior["x"].values), [2.0] * 4, [2.25] * 4,
                  var_rtol=0.3)
