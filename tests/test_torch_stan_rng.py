"""Stan's ``_rng`` functions and the generated quantities' keys.

- Keys: the port's key data, splits and fold-ins equal ``jax.random``'s
  bit for bit, and so do the expansion's per-(chain, draw) keys
  (``sample.expand_keys`` against ``nutpie_tpu/sample.py:524-540``).
- Draws that ``jax.random`` computes in closed form from uniforms or
  normals agree with the JAX package's draw by draw, from the same keys:
  uniforms bit for bit, normals to 1 ULP in the median and 16 at most
  (XLA's erfinv and log1p round differently in the tails), the formulas
  built on them to
  1e-13 of max(1, |x|) (XLA's and torch's logarithms round differently),
  integers exactly.
- Draws from rejection samplers (``jax.random``'s loop until accepted;
  the port runs a fixed number of rounds) are held in distribution:
  4,000 draws from keys ``fold_in(key(0), i)``, a Kolmogorov-Smirnov test
  against scipy at p > 1e-3 (Pearson's chi-square for integer laws; the
  seed is fixed), one case per name, and
  the large-mean branches of Poisson and binomial and the boosted gamma
  as cases of their own.
- An expansion that draws: the golden Stan model's ``y_rep`` for given
  positions and keys equals ``mu + sigma * normal(key)``.

float64 on the CPU; vmap's per-example fallback warning is an error here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch
from torch.func import vmap

import nutpie_tpu_torch as nt
from nutpie_tpu.frontends.stan import stanlib as J
from nutpie_tpu_torch.frontends.stan import stanlib as T
from nutpie_tpu_torch.frontends.stan import rng, xp
from nutpie_tpu_torch.ops import threefry
from nutpie_tpu_torch.sample import expand_keys

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

torch.set_num_threads(1)

S3 = np.array([[2.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.5]])
SIMPLEX = np.array([0.2, 0.5, 0.3])
LOGITS = np.array([0.3, -1.2, 0.8])
CUTS = np.array([-0.5, 0.7])
LOG_OMEGA = np.random.default_rng(0).normal(size=(3, 6))
GAMMA_T = np.array([[0.8, 0.1, 0.1], [0.2, 0.6, 0.2], [0.25, 0.25, 0.5]])

CLOSED = {
    "normal_rng": (0.7, 1.3), "std_normal_rng": (), "uniform_rng": (-1.5, 2.5),
    "lognormal_rng": (0.2, 0.6), "exponential_rng": (1.7,), "cauchy_rng": (0.3, 2.0),
    "double_exponential_rng": (0.3, 1.5), "weibull_rng": (1.8, 2.2),
    "bernoulli_rng": (0.35,), "bernoulli_logit_rng": (-0.4,),
    "categorical_rng": (SIMPLEX,), "categorical_logit_rng": (LOGITS,),
    "multi_normal_rng": (LOGITS, S3), "ordered_logistic_rng": (0.4, CUTS),
    "skew_normal_rng": (0.5, 1.2, 2.0), "rayleigh_rng": (1.4,),
    "pareto_type_2_rng": (-0.2, 1.5, 3.0), "pareto_rng": (0.5, 2.5),
    "frechet_rng": (2.5, 1.3), "gumbel_rng": (0.4, 1.1), "logistic_rng": (0.4, 1.1),
    "hmm_latent_rng": (LOG_OMEGA, GAMMA_T, SIMPLEX),
}

# name -> (args, scipy distribution of the draw, or of one coordinate)
IN_DISTRIBUTION = {
    "gamma_rng": ((2.5, 1.5), st.gamma(2.5, scale=1 / 1.5)),
    "gamma_rng[boosted]": ((0.4, 2.0), st.gamma(0.4, scale=0.5)),
    "inv_gamma_rng": ((3.0, 2.0), st.invgamma(3.0, scale=2.0)),
    "beta_rng": ((2.0, 3.5), st.beta(2.0, 3.5)),
    "chi_square_rng": ((4.5,), st.chi2(4.5)),
    "student_t_rng": ((4.0, 0.5, 1.5), st.t(4.0, loc=0.5, scale=1.5)),
    "binomial_rng": ((12, 0.3), st.binom(12, 0.3)),
    "binomial_rng[btrs]": ((200, 0.35), st.binom(200, 0.35)),
    "poisson_rng": ((3.5,), st.poisson(3.5)),
    "poisson_rng[ptrs]": ((42.0,), st.poisson(42.0)),
    "poisson_log_rng": ((1.2,), st.poisson(np.exp(1.2))),
    "dirichlet_rng": ((np.array([1.5, 2.0, 3.0]),), st.beta(1.5, 5.0)),
    "beta_binomial_rng": ((15, 2.0, 3.0), st.betabinom(15, 2.0, 3.0)),
    "von_mises_rng": ((0.5, 2.5), st.vonmises(2.5, loc=0.5)),
    "inv_chi_square_rng": ((5.0,), st.invgamma(2.5, scale=0.5)),
    "scaled_inv_chi_square_rng": ((5.0, 1.3), st.invgamma(2.5, scale=5.0 * 1.3**2 / 2)),
    "neg_binomial_rng": ((3.0, 0.8), st.nbinom(3.0, 0.8 / 1.8)),
    "neg_binomial_2_rng": ((4.0, 2.5), st.nbinom(2.5, 2.5 / 6.5)),
    "discrete_range_rng": ((2, 7), st.randint(2, 8)),
}
N_DRAWS = 4000


def _torch_arg(a):
    return torch.tensor(a) if isinstance(a, np.ndarray) else a


def _port_draws(name, args, n):
    kd = threefry.fold_in_data(threefry.key(0), torch.arange(n))
    fn = T.RNG_FUNCTIONS[name]
    targs = [_torch_arg(a) for a in args]
    with xp.evaluation(torch.float64, "cpu"):
        return vmap(lambda k: xp.asarray(fn(k, *targs)))(kd).numpy()


def _jax_draws(name, args, n):
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.arange(n))
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    return np.asarray(jax.vmap(lambda k: jnp.asarray(J.RNG_FUNCTIONS[name](k, *jargs)))(keys))


def test_every_rng_function_is_covered():
    names = set(CLOSED) | {k.split("[")[0] for k in IN_DISTRIBUTION}
    assert names == set(J.RNG_FUNCTIONS) == set(T.RNG_FUNCTIONS)


def test_keys_split_and_fold_in_bitwise():
    k = jax.random.key(12345)
    kd = threefry.key(12345)
    for _ in range(5):
        k, sub = jax.random.split(k)
        kd, sub_t = rng.split(kd)
        assert np.array_equal(np.asarray(jax.random.key_data(sub)), sub_t.numpy())
        assert np.array_equal(np.asarray(jax.random.key_data(k)), kd.numpy())
    folded = jax.random.fold_in(k, 77)
    assert np.array_equal(np.asarray(jax.random.key_data(folded)), rng.fold_in(kd, 77).numpy())


def test_expansion_keys_are_the_jax_samplers():
    seed, C, L, start = 2026, 3, 5, 40
    master = jax.random.key(seed ^ 0x6A09E667)
    want = np.stack([
        np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.fold_in(master, c), start + d))) for d in range(L)])
        for c in range(C)])
    assert np.array_equal(expand_keys(seed, C, L, start, "cpu").numpy(), want)


@pytest.mark.parametrize("name", sorted(CLOSED))
def test_closed_form_draws_match_jax(name):
    args = CLOSED[name]
    got = _port_draws(name, args, 64)
    want = _jax_draws(name, args, 64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
        return
    # the formulas' transcendental functions round differently in XLA and
    # torch (XLA's log1p differs by up to about 100 ulp on the CPU)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.all(err <= 1e-13), float(err.max())


def test_uniforms_bitwise_and_normals_to_a_few_ulp():
    got_u = _port_draws("uniform_rng", (0.0, 1.0), 256)
    want_u = _jax_draws("uniform_rng", (0.0, 1.0), 256)
    assert np.array_equal(got_u, want_u)
    got, want = _port_draws("std_normal_rng", (), 256), _jax_draws("std_normal_rng", (), 256)
    ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(got), np.abs(want)))
    # XLA's erfinv and log1p round differently in the tails (-log1p(-u^2))
    assert np.median(ulps) <= 1 and ulps.max() <= 16, (np.median(ulps), ulps.max())


@pytest.mark.parametrize("case", sorted(IN_DISTRIBUTION))
def test_rejection_draws_in_distribution(case):
    args, dist = IN_DISTRIBUTION[case]
    draws = _port_draws(case.split("[")[0], args, N_DRAWS)
    assert np.all(np.isfinite(draws))
    if draws.ndim == 2:  # dirichlet: the first coordinate's beta marginal
        assert np.allclose(draws.sum(-1), 1.0)
        draws = draws[:, 0]
    if hasattr(dist, "pmf"):
        p = _chi2_pvalue(draws, dist)
    else:
        p = st.kstest(draws, dist.cdf).pvalue
    assert p > 1e-3, p


def _chi2_pvalue(draws, dist):
    """Pearson's goodness of fit of integer draws: one bin per value from
    the 1e-4 to the 1 - 1e-4 quantile, the tails folded into the end bins
    (the KS statistic does not apply to a discrete law)."""
    assert np.array_equal(draws, np.round(draws))
    lo, hi = int(dist.ppf(1e-4)), int(dist.ppf(1 - 1e-4))
    ks = np.arange(lo, hi + 1)
    probs = dist.pmf(ks)
    probs[0] += dist.cdf(lo - 1)
    probs[-1] += dist.sf(hi)
    obs = np.array([np.sum(np.clip(draws, lo, hi) == k) for k in ks])
    exp = probs * len(draws)
    keep = exp >= 5
    obs = np.append(obs[keep], obs[~keep].sum())
    exp = np.append(exp[keep], exp[~keep].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    stat = float(np.sum((obs - exp) ** 2 / exp))
    return float(st.chi2.sf(stat, len(exp) - 1))


def test_expansion_draws_from_its_keys():
    code = """
    data { int N; vector[N] y; }
    parameters { real mu; real<lower=0> sigma; }
    model { y ~ normal(mu, sigma); }
    generated quantities { real y_rep = normal_rng(mu, sigma); }
    """
    m = nt.compile_stan_model(code).with_data(N=3, y=np.array([1.0, 2.0, 0.5]))._make_model(0)
    assert m.expand_needs_rng
    x = torch.tensor([[0.3, -0.2], [1.0, 0.4]], dtype=torch.float64)
    keys = expand_keys(7, 2, 1, 10, "cpu").reshape(2, 2)
    out = m.expand_fn(x, keys)["y_rep"].numpy()
    for i in range(2):
        k = jax.random.wrap_key_data(jnp.asarray(keys[i].numpy().astype(np.uint32)))
        # the GQ block's first _rng call takes the second half of split(key)
        sub = jax.random.split(k)[1]
        want = float(x[i, 0]) + np.exp(float(x[i, 1])) * float(jax.random.normal(sub, ()))
        assert abs(out[i] - want) <= 1e-14 * max(1.0, abs(want))
