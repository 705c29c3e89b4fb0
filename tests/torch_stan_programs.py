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

# Bob Carpenter's Stan case study "Predator-Prey Population Dynamics: the
# Lotka-Volterra model in Stan" (posteriordb hudson_lynx_hare-lotka_volterra),
# as written there with the old ODE interface, the omitted index ``y[ , k]``
# spelled ``y[:, k]``; LOTKA_VOLTERRA_NEW is the same model through
# ``ode_rk45_tol`` with a vector right-hand side
LOTKA_VOLTERRA = """
functions {
  array[] real dz_dt(real t, array[] real z, array[] real theta,
                     array[] real x_r, array[] int x_i) {
    real u = z[1];
    real v = z[2];
    real alpha = theta[1];
    real beta = theta[2];
    real gamma = theta[3];
    real delta = theta[4];
    real du_dt = (alpha - beta * v) * u;
    real dv_dt = (-gamma + delta * u) * v;
    return { du_dt, dv_dt };
  }
}
data {
  int<lower=0> N;
  array[N] real ts;
  array[2] real y_init;
  array[N, 2] real<lower=0> y;
}
parameters {
  array[4] real<lower=0> theta;
  array[2] real<lower=0> z_init;
  array[2] real<lower=0> sigma;
}
transformed parameters {
  array[N, 2] real z = integrate_ode_rk45(dz_dt, z_init, 0, ts, theta,
                                          rep_array(0.0, 0), rep_array(0, 0),
                                          1e-5, 1e-3, 5e2);
}
model {
  theta[{1, 3}] ~ normal(1, 0.5);
  theta[{2, 4}] ~ normal(0.05, 0.05);
  sigma ~ lognormal(-1, 1);
  z_init ~ lognormal(log(10), 1);
  for (k in 1:2) {
    y_init[k] ~ lognormal(log(z_init[k]), sigma[k]);
    y[:, k] ~ lognormal(log(z[:, k]), sigma[k]);
  }
}
generated quantities {
  array[2] real y_init_rep;
  array[N, 2] real y_rep;
  for (k in 1:2) {
    y_init_rep[k] = lognormal_rng(log(z_init[k]), sigma[k]);
    for (n in 1:N)
      y_rep[n, k] = lognormal_rng(log(z[n, k]), sigma[k]);
  }
}
"""
LOTKA_VOLTERRA_NEW = LOTKA_VOLTERRA.replace("""  array[] real dz_dt(real t, array[] real z, array[] real theta,
                     array[] real x_r, array[] int x_i) {""", """  vector dz_dt(real t, vector z, array[] real theta) {""").replace(
    "return { du_dt, dv_dt };", "return [du_dt, dv_dt]';").replace(
    """array[N, 2] real z = integrate_ode_rk45(dz_dt, z_init, 0, ts, theta,
                                          rep_array(0.0, 0), rep_array(0, 0),
                                          1e-5, 1e-3, 5e2);""",
    """array[N] vector[2] z = ode_rk45_tol(dz_dt, to_vector(z_init), 0, ts,
                                       1e-5, 1e-3, 500, theta);""")
# the case study's posterior means, where the data are simulated
LV_THETA = (0.55, 0.028, 0.80, 0.024)
LV_Z_INIT = (33.9, 5.9)


def lotka_volterra_data(seed: int = 0, sigma: float = 0.25) -> dict:
    """The pelt counts' stand-in: the system integrated at the case study's
    posterior means by scipy (``solve_ivp``, rtol 1e-10) at ts = 1..20,
    with lognormal noise of sd ``sigma`` drawn from ``seed`` on ``y`` and
    on ``y_init`` (t = 0)."""
    from scipy.integrate import solve_ivp

    a, b, c, d = LV_THETA

    def rhs(_t, z):
        return [(a - b * z[1]) * z[0], (-c + d * z[0]) * z[1]]

    ts = np.arange(1.0, 21.0)
    sol = solve_ivp(rhs, (0.0, 20.0), LV_Z_INIT, t_eval=ts, rtol=1e-10, atol=1e-10)
    rng = np.random.default_rng(seed)
    y = sol.y.T * np.exp(sigma * rng.standard_normal((len(ts), 2)))
    y_init = np.asarray(LV_Z_INIT) * np.exp(sigma * rng.standard_normal(2))
    return dict(N=len(ts), ts=ts, y_init=y_init, y=y)


# one small program for each functional that loops or quadratures
# (``FUNCTIONAL_CASES[name] = (code, data)``), the name in ``NAME``:
# ODEs of a damped oscillator with a time-dependent term (new and old
# interfaces, the tolerance forms, the adjoint's control form), a 2-d
# algebraic system, an index-1 DAE and a Gaussian integral
_ODE_NEW = """
functions {
  vector rhs(real t, vector y, vector th, real c) {
    return [th[1] * y[2], -th[2] * y[1] - c * t * y[2]]';
  }
}
data { int N; array[N] real ts; array[N] vector[2] yobs; real c; }
parameters { vector<lower=0>[2] th; vector[2] y0; }
model {
  array[N] vector[2] ys = CALL;
  th ~ lognormal(0, 0.5);
  y0 ~ normal(1, 1);
  for (n in 1:N) yobs[n] ~ normal(ys[n], 0.3);
}
"""
_ODE_OLD = """
functions {
  array[] real rhs(real t, array[] real y, array[] real th, array[] real x_r,
                   array[] int x_i) {
    return { th[1] * y[2], -th[2] * y[1] - x_r[1] * t * y[2] };
  }
}
data { int N; array[N] real ts; array[N, 2] real yobs; array[1] real x_r; }
parameters { array[2] real<lower=0> th; array[2] real y0; }
model {
  array[N, 2] real ys = CALL;
  th ~ lognormal(0, 0.5);
  y0 ~ normal(1, 1);
  for (n in 1:N) yobs[n] ~ normal(ys[n], 0.3);
}
"""
_ALGEBRA = """
functions {
  vector sys(vector y, vector th, array[] real x_r, array[] int x_i) {
    return [y[1] - th[1] + 0.1 * square(y[2]), y[1] * y[2] - th[2]]';
  }
  vector sys2(vector y, vector th) {
    return [y[1] - th[1] + 0.1 * square(y[2]), y[1] * y[2] - th[2]]';
  }
}
data { vector[2] guess; }
parameters { vector<lower=0>[2] th; }
model {
  vector[2] r = CALL;
  th ~ lognormal(0, 0.3);
  r ~ normal(1, 0.5);
}
"""
_DAE = """
functions {
  vector res(real t, vector yy, vector yp, vector th) {
    return [yp[1] + th[1] * yy[1] - th[2] * yy[2], yy[2] - 0.5 * yy[1]]';
  }
}
data { int N; array[N] real ts; array[N] vector[2] yobs; }
parameters { vector<lower=0>[2] th; }
model {
  vector[2] yy0 = [1.0, 0.5]';
  real d = -th[1] + 0.5 * th[2];
  vector[2] yp0 = [d, 0.5 * d]';
  array[N] vector[2] ys = CALL;
  th ~ lognormal(0, 0.5);
  for (n in 1:N) yobs[n] ~ normal(ys[n], 0.1);
}
"""
_INTEGRATE = """
functions {
  real integrand(real x, real xc, array[] real th, array[] real x_r,
                 array[] int x_i) {
    return exp(-square(x - th[1]) / (2 * square(th[2]))) * (1 + 0.1 * x * x);
  }
}
parameters { real mu; real<lower=0> s; }
model {
  mu ~ normal(0, 1);
  s ~ lognormal(0, 0.5);
  target += log(integrate_1d(integrand, BOUNDS, {mu, s}, rep_array(0.0, 0),
                             rep_array(0, 0)));
}
"""
_NEW_CALLS = {
    "ode_rk45": "ode_rk45(rhs, y0, 0.0, ts, th, c)",
    "ode_bdf": "ode_bdf(rhs, y0, 0.0, ts, th, c)",
    "ode_adams": "ode_adams(rhs, y0, 0.0, ts, th, c)",
    "ode_ckrk": "ode_ckrk(rhs, y0, 0.0, ts, th, c)",
    "ode_rk45_tol": "ode_rk45_tol(rhs, y0, 0.0, ts, 1e-7, 1e-7, 1000, th, c)",
    "ode_bdf_tol": "ode_bdf_tol(rhs, y0, 0.0, ts, 1e-7, 1e-7, 1000, th, c)",
    "ode_adams_tol": "ode_adams_tol(rhs, y0, 0.0, ts, 1e-7, 1e-7, 1000, th, c)",
    "ode_ckrk_tol": "ode_ckrk_tol(rhs, y0, 0.0, ts, 1e-7, 1e-7, 1000, th, c)",
    "ode_adjoint_tol_ctl": ("ode_adjoint_tol_ctl(rhs, y0, 0.0, ts, 1e-6, [1e-7, 1e-7]', 1e-7, "
                            "[1e-6, 1e-6]', 1e-6, 1e-6, 1000, 150, 1, 2, 2, th, c)"),
}
_OLD_CALLS = {
    "integrate_ode": "integrate_ode(rhs, y0, 0.0, ts, th, x_r, rep_array(0, 0))",
    "integrate_ode_rk45": "integrate_ode_rk45(rhs, y0, 0.0, ts, th, x_r, rep_array(0, 0))",
    "integrate_ode_bdf": ("integrate_ode_bdf(rhs, y0, 0.0, ts, th, x_r, rep_array(0, 0), "
                          "1e-8, 1e-8, 1000)"),
    "integrate_ode_adams": ("integrate_ode_adams(rhs, y0, 0.0, ts, th, x_r, rep_array(0, 0), "
                            "1e-8, 1e-8, 1000)"),
}
_ALGEBRA_CALLS = {
    "algebra_solver": "algebra_solver(sys, guess, th, rep_array(0.0, 0), rep_array(0, 0))",
    "algebra_solver_newton": ("algebra_solver_newton(sys, guess, th, rep_array(0.0, 0), "
                              "rep_array(0, 0), 1e-10, 1e-9, 100)"),
    "solve_newton": "solve_newton(sys2, guess, th)",
    "solve_newton_tol": "solve_newton_tol(sys2, guess, 1e-3, 1e-10, 100, th)",
    "solve_powell": "solve_powell(sys2, guess, th)",
    "solve_powell_tol": "solve_powell_tol(sys2, guess, 1e-10, 1e-10, 100, th)",
}
_DAE_CALLS = {
    "dae": "dae(res, yy0, yp0, 0.0, ts, th)",
    "dae_tol": "dae_tol(res, yy0, yp0, 0.0, ts, 1e-4, 1e-9, 1000, th)",
}
INTEGRATE_BOUNDS = {
    "finite": "-1, 2",
    "parameter": "mu - 1, mu + 2",
    "upper_infinite": "0, positive_infinity()",
    "lower_infinite": "negative_infinity(), 0.5",
    "infinite": "negative_infinity(), positive_infinity()",
}


def _ode_data(old: bool) -> dict:
    ts = np.array([0.5, 1.0, 2.0, 3.0])
    yobs = np.random.default_rng(4).normal(size=(4, 2)) * 0.3 + np.array([1.0, 0.5])
    data = dict(N=4, ts=ts, yobs=yobs)
    data.update(dict(x_r=np.array([0.2])) if old else dict(c=0.2))
    return data


def _dae_data(ts) -> dict:
    ts = np.asarray(ts)
    yobs = 0.9 * np.exp(-0.5 * ts)[:, None] * np.array([1.0, 0.5])
    return dict(N=len(ts), ts=ts, yobs=yobs)


def _cases() -> dict:
    cases = {}
    for calls, code, data in ((_NEW_CALLS, _ODE_NEW, lambda: _ode_data(False)),
                              (_OLD_CALLS, _ODE_OLD, lambda: _ode_data(True)),
                              (_ALGEBRA_CALLS, _ALGEBRA, lambda: dict(guess=np.ones(2)))):
        for name, call in calls.items():
            cases[name] = (code.replace("CALL", call), data)
    # the default dae asks for h = 1e-5, so its grid covers short intervals
    cases["dae"] = (_DAE.replace("CALL", _DAE_CALLS["dae"]), lambda: _dae_data([2e-4, 4e-4]))
    cases["dae_tol"] = (_DAE.replace("CALL", _DAE_CALLS["dae_tol"]),
                        lambda: _dae_data([0.1, 0.25]))
    cases["integrate_1d"] = (_INTEGRATE.replace("BOUNDS", INTEGRATE_BOUNDS["finite"]), dict)
    return cases


# name -> (program, data factory); each program's parameters sit near 0 in
# the unconstrained space
FUNCTIONAL_CASES = _cases()
