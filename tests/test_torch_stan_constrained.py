"""Stan's constrained parameter types in both packages.

One program declares every constraint transform (simplex, ordered,
positive_ordered, unit_vector, sum_to_zero_vector, the Cholesky factors,
corr_matrix, cov_matrix, lower/upper bounds, offset/multiplier and an
array of simplexes); as in ``test_torch_stan_logp.py``, its logp (rtol
1e-12), gradient (rtol 1e-10) and expansion (rtol 1e-12) at 4 seeded
points are held to the JAX package's.  vmap's per-example fallback
warning is an error here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu as nj
import nutpie_tpu_torch as nt

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

torch.set_num_threads(1)

CODE = """
parameters {
  simplex[4] s; ordered[3] o; positive_ordered[2] po; unit_vector[3] u;
  sum_to_zero_vector[4] z; cholesky_factor_corr[3] Lc; cholesky_factor_cov[3] Lv;
  corr_matrix[3] R; cov_matrix[2] S; real<lower=-1, upper=2> b;
  vector<offset=1, multiplier=3>[2] om; array[2] simplex[3] as;
}
model {
  s ~ dirichlet([1.5, 2, 1, 3]'); o ~ normal(0, 2); po ~ exponential(1);
  z ~ normal(0, 1); Lc ~ lkj_corr_cholesky(2); to_vector(Lv) ~ normal(0, 3);
  R ~ lkj_corr(1.5); S ~ wishart(4, [[1, 0.2], [0.2, 1]]); om ~ normal(1, 3);
  for (i in 1:2) as[i] ~ dirichlet([2, 2, 2]');
}
generated quantities { real ssum = sum(s); }
"""


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def models():
    return (nj.compile_stan_model(code=CODE)._make_model(0),
            nt.compile_stan_model(CODE)._make_model(0))


def test_constrained_logp_and_gradient_match_jax(models):
    jm, tm = models
    assert jm.ndim == tm.ndim
    x = np.random.default_rng(3).normal(size=(4, tm.ndim)) * 0.5
    lj = np.asarray(jax.vmap(jm.logp_fn)(jnp.asarray(x)))
    gj = np.asarray(jax.vmap(jax.grad(jm.logp_fn))(jnp.asarray(x)))
    lt, gt = tm.logp_and_grad(torch.as_tensor(x))
    assert _rel(lt.numpy(), lj) < 1e-12, (lt, lj)
    assert _rel(gt.numpy(), gj) < 1e-10


def test_constrained_expand_matches_jax(models):
    jm, tm = models
    x = np.random.default_rng(4).normal(size=(3, tm.ndim)) * 0.5
    jout = jax.vmap(jm.expand_fn)(jnp.asarray(x))
    tout = tm.expand_fn(torch.as_tensor(x))
    assert set(jout) == set(tout)
    for k in jout:
        assert tuple(tout[k].shape) == tuple(np.shape(jout[k])), k
        assert _rel(tout[k].numpy(), np.asarray(jout[k])) < 1e-12, k
