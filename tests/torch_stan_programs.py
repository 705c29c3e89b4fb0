"""Stan programs and data shared by the port's Stan tests (no JAX here, so
the card's tests can import it).

``RADON_VECTOR`` and ``RADON_LOOP`` are radon written in Stan, in the
unconstrained layout of ``nutpie_tpu_torch/models/radon.py``
(intercept | county_raw_z | log county_sd | floor_effect | cf_raw_z |
log cf_sd | log sigma), so their log density equals radon's up to a
constant: the likelihood vectorised, and as a loop over the
observations.  ``CENSORED`` holds a data ``if`` inside a loop of ``N``
observations (censoring through ``normal_lccdf``).
"""

import numpy as np

from nutpie_tpu_torch.models.radon import _zero_sum_basis, simulate_radon_data

RADON = """
data {
  int<lower=1> N; int<lower=2> J;
  array[N] int<lower=1, upper=J> county;
  vector[N] floor_x; vector[N] y;
  matrix[J, J - 1] basis;
}
parameters {
  real intercept;
  vector[J - 1] county_raw_z;
  real<lower=0> county_sd;
  real floor_effect;
  vector[J - 1] cf_raw_z;
  real<lower=0> cf_sd;
  real<lower=0> sigma;
}
transformed parameters {
  vector[J] county_effect = (basis * county_raw_z) * county_sd;
  vector[J] cf_effect = (basis * cf_raw_z) * cf_sd;
}
model {
  intercept ~ normal(0, 10);
  county_raw_z ~ std_normal();
  cf_raw_z ~ std_normal();
  county_sd ~ normal(0, 1);
  cf_sd ~ normal(0, 1);
  floor_effect ~ normal(0, 2);
  sigma ~ normal(0, 1.5);
  LIKELIHOOD
}
"""
RADON_VECTOR = RADON.replace("LIKELIHOOD", """y ~ normal(intercept + county_effect[county]
    + floor_effect * floor_x + cf_effect[county] .* floor_x, sigma);""")
RADON_LOOP = RADON.replace("LIKELIHOOD", """for (n in 1:N)
    y[n] ~ normal(intercept + county_effect[county[n]] + floor_effect * floor_x[n]
                  + cf_effect[county[n]] * floor_x[n], sigma);""")

CENSORED = """
data { int<lower=1> N; vector[N] y; array[N] int<lower=0, upper=1> cens; real c; }
parameters { real mu; real<lower=0> sigma; }
model {
  mu ~ normal(0, 5);
  sigma ~ normal(0, 2);
  for (n in 1:N) {
    if (cens[n] == 1) target += normal_lccdf(c | mu, sigma);
    else y[n] ~ normal(mu, sigma);
  }
}
"""


def radon_data() -> dict:
    """``simulate_radon_data(42)`` with 1-based counties and the zero-sum
    basis of 85 counties."""
    y, cidx, floor_x, _ = simulate_radon_data(42)
    return dict(N=len(y), J=85, county=cidx + 1, floor_x=floor_x, y=y,
                basis=_zero_sum_basis(85))


def censored_data(n: int = 64, c: float = 2.5) -> dict:
    """``n`` draws of N(1, 2) from seed 3, censored above ``c``."""
    y = 1.0 + 2.0 * np.random.default_rng(3).standard_normal(n)
    return dict(N=n, y=np.minimum(y, c), cens=(y > c).astype(np.int64), c=c)
