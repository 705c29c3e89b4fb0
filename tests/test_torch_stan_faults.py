"""Known faults of the JAX package's Stan library, right in the port.

Each case is held against scipy (or an exact value), not against
``nutpie_tpu``, and shows the JAX package's gap beside it (ROADMAP queue
3, "known faults in the reference itself"):

- ``multi_normal``, ``multi_normal_cholesky``, ``multi_student_t`` and
  ``multi_student_t_cholesky`` with ``array[N] vector[K]`` observations
  (``nutpie_tpu/frontends/stan/stanlib.py:218, 231, 375, 1245`` solve one
  K x N right-hand side): each row's density, directly and through a
  Stan program.
- ``skew_normal_lcdf`` in the skewed tail (``:1555`` cancels to 0 and
  returns log(1e-300)).
- ``owens_t`` for |a| > 1 (``:1539`` integrates [0, a] without reducing).
- ``discrete_range_lpmf`` outside its support (``:1279`` has no check).
- ``betaln`` (and every density built on it) for 8 <= b, where JAX's
  branch is off by up to 3e-7 relative.

float64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as ss
import scipy.stats as st
import torch

import nutpie_tpu_torch as nt
from nutpie_tpu.frontends.stan import stanlib as J
from nutpie_tpu_torch.frontends.stan import stanlib as T
from nutpie_tpu_torch.frontends.stan import xp

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

torch.set_num_threads(1)

_R = np.random.default_rng(11)
N, K = 5, 3
Y = _R.normal(size=(N, K))
MU = np.array([0.2, -0.1, 0.4])
SIGMA = np.array([[1.5, 0.3, 0.2], [0.3, 1.0, -0.1], [0.2, -0.1, 0.8]])
L = np.linalg.cholesky(SIGMA)
NU = 4.5

CASES = {
    "multi_normal": ((Y, MU, SIGMA), st.multivariate_normal(MU, SIGMA).logpdf(Y)),
    "multi_normal_cholesky": ((Y, MU, L), st.multivariate_normal(MU, SIGMA).logpdf(Y)),
    "multi_student_t": ((Y, NU, MU, SIGMA), st.multivariate_t(MU, SIGMA, df=NU).logpdf(Y)),
    "multi_student_t_cholesky": ((Y, NU, MU, L),
                                 st.multivariate_t(MU, SIGMA, df=NU).logpdf(Y)),
}


def _t(a):
    return torch.tensor(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("name", sorted(CASES))
def test_multivariate_density_of_an_array_of_vectors(name):
    args, want = CASES[name]
    with xp.evaluation(torch.float64, "cpu"):
        got = T.DISTRIBUTIONS[name](*[_t(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    try:
        jgot = np.asarray(J.DISTRIBUTIONS[name](*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                                  else a for a in args]))
        jax_right = jgot.shape == want.shape and np.allclose(jgot, want, rtol=1e-8)
    except Exception:  # the reference crashes on this input
        jax_right = False
    assert not jax_right


def test_multi_normal_over_an_array_of_vectors_in_a_program():
    code = """
    data { int N; int K; array[N] vector[K] y; vector[K] mu; cov_matrix[K] S; }
    parameters { real a; }
    model { y ~ multi_normal(mu + a, S); }
    """
    m = nt.compile_stan_model(code).with_data(N=N, K=K, y=Y, mu=MU, S=SIGMA)._make_model(0)
    lp, _ = m.logp_and_grad(torch.tensor([[0.0], [0.5]], dtype=torch.float64))
    for i, a in enumerate((0.0, 0.5)):
        want = st.multivariate_normal(MU + a, SIGMA).logpdf(Y).sum()
        assert abs(float(lp[i]) - want) < 1e-12 * abs(want)


# log F(z; alpha) by a 50-digit mpmath integral of the positive form
# (1/pi) int_alpha^inf exp(-z^2 (1 + x^2) / 2) / (1 + x^2) dx, with
# breakpoints every 1 / (z^2 alpha) (scipy's skewnorm.logcdf is off by up to
# 1e-4 here, at (-1, 12))
SKEW_TAIL = {
    (-3.0, 5.0): -125.22228881457536212,
    (-10.0, 1.0): -106.46257030102446247,
    (-1.0, 12.0): -81.126627554849198,
    (-2.0, 6.0): -81.953691874201212,
    (-4.0, 3.0): -87.337536506498136,
}


@pytest.mark.parametrize("z,alpha", sorted(SKEW_TAIL))
def test_skew_normal_lcdf_in_the_skewed_tail(z, alpha):
    want = SKEW_TAIL[(z, alpha)]
    with xp.evaluation(torch.float64, "cpu"):
        got = float(T.LCDFS["skew_normal"](z, 0.0, 1.0, alpha))
    assert abs(got - want) < 1e-13 * abs(want), (got, want)
    assert abs(st.skewnorm.logcdf(z, alpha) - want) < 1e-5 * abs(want)
    jgot = float(J.LCDFS["skew_normal"](z, 0.0, 1.0, alpha))
    assert abs(jgot - want) > 1.0  # the reference's cancellation: log(1e-300)


@pytest.mark.parametrize("h,a", [(0.5, 3.0), (2.0, 10.0), (-1.0, -5.0), (0.1, 50.0),
                                 (3.0, 1.5), (2.0, 1000.0), (0.2, 200.0)])
def test_owens_t_beyond_unit_a(h, a):
    with xp.evaluation(torch.float64, "cpu"):
        got = float(T.owens_t(h, a))
    want = ss.owens_t(h, a)
    assert abs(got - want) < 1e-12 * max(abs(want), 1e-3)
    if abs(a) >= 200:  # where the reference's quadrature misses the integrand
        assert abs(float(J.owens_t(h, a)) - want) > 1e-6


def test_discrete_range_outside_its_support():
    with xp.evaluation(torch.float64, "cpu"):
        got = T.discrete_range_lpmf(torch.tensor([0, 2, 4, 5, 9]), 2, 5).numpy()
    want = st.randint(2, 6).logpmf([0, 2, 4, 5, 9])
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-15)
    assert np.isfinite(np.asarray(J.discrete_range_lpmf(jnp.asarray([0, 9]), 2, 5))).all()


@pytest.mark.parametrize("a,b", [(1.0, 10.0), (3.0, 8.0), (2.0, 8.0), (0.5, 20.0)])
def test_betaln_past_eight(a, b):
    with xp.evaluation(torch.float64, "cpu"):
        got = float(T.FUNCTIONS["lbeta"](a, b))
        beta_lp = float(T.DISTRIBUTIONS["beta"](0.3, a, b))
    want = ss.betaln(a, b)
    assert abs(got - want) < 1e-14 * abs(want)
    assert abs(beta_lp - st.beta(a, b).logpdf(0.3)) < 1e-12 * max(1.0, abs(beta_lp))
    assert abs(float(J.FUNCTIONS["lbeta"](a, b)) - want) > 1e-9 * abs(want)
