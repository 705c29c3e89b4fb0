"""Stan programs' log densities, gradients and expansions in both packages.

The same program and numpy data go through ``nutpie_tpu``'s and
``nutpie_tpu_torch``'s ``compile_stan_model(...).with_data(...)``; the same
seeded unconstrained points for 4 chains (float64, CPU) go through the JAX
interpreter's ``logp`` with ``jax.grad`` and the port's batched logp with
autograd: logp to rtol 1e-12, gradients to rtol 1e-10 (each relative to
the largest magnitude, at least 1).  Programs: the Stan radon in both forms
(vectorised, and the loop whose body runs as one vmap over n), eight
schools, a logistic regression over a matrix, user functions, truncation, transformed data, a
loop that carries state (unrolled), tuples and complex numbers,
``reduce_sum`` and ``map_rect``.  A program with radon's unconstrained
layout is held to ``nutpie_tpu_torch.models.radon``: its logp differences
and gradient to 1e-12.  The expansion (constrained parameters,
transformed parameters, deterministic generated quantities) to rtol
1e-12.  The constrained types are in ``test_torch_stan_constrained.py``.
vmap's per-example fallback warning is an error here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu as nj
import nutpie_tpu_torch as nt
from nutpie_tpu_torch.frontends.stan import interpreter as tinterp
from torch_stan_programs import CENSORED, RADON_LOOP, RADON_VECTOR, censored_data, radon_data

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

torch.set_num_threads(1)

_R = np.random.default_rng(7)

PROGRAMS = {
    "radon_vector": (RADON_VECTOR, radon_data),
    "radon_loop": (RADON_LOOP, radon_data),
    "eight_schools": ("""
data { int<lower=0> J; vector[J] y; vector<lower=0>[J] sigma; }
parameters { real mu; real<lower=0> tau; vector[J] theta_raw; }
transformed parameters { vector[J] theta = mu + tau * theta_raw; }
model { mu ~ normal(0, 5); tau ~ cauchy(0, 5); theta_raw ~ std_normal();
        y ~ normal(theta, sigma); }
generated quantities { real tau2 = square(tau); }
""", lambda: dict(J=8, y=np.array([28., 8, -3, 7, -1, 1, 18, 12]),
                  sigma=np.array([15., 10, 16, 11, 9, 11, 10, 18]))),
    "logistic_matrix": ("""
data { int N; int K; matrix[N, K] X; array[N] int<lower=0, upper=1> y; }
parameters { real alpha; vector[K] beta; }
model { alpha ~ normal(0, 2); beta ~ normal(0, 1);
        y ~ bernoulli_logit(alpha + X * beta); }
generated quantities { vector[N] eta = alpha + X * beta; }
""", lambda: dict(N=40, K=5, X=_R.normal(size=(40, 5)),
                  y=(_R.uniform(size=40) < 0.4).astype(np.int64))),
    "user_functions": ("""
functions {
  real my_lpdf(real x, real m) { return -0.5 * square(x - m); }
  vector shift(vector v, real d) { return v + d; }
  real twice(real x) { real y = x; y *= 2; return y; }
}
data { int N; vector[N] y; }
parameters { real m; real<lower=0> s; }
model { m ~ my(1.0); y ~ normal(shift(rep_vector(m, N), twice(0.25)), s);
        s ~ lognormal(0, 1); }
""", lambda: dict(N=6, y=_R.normal(size=6))),
    "truncation": ("""
data { int N; vector[N] y; real L; real U; }
parameters { real mu; real<lower=0> sigma; }
model { mu ~ normal(0, 3); sigma ~ normal(0, 2);
        for (n in 1:N) y[n] ~ normal(mu, sigma) T[L, U];
        mu ~ normal(0, 5) T[-10, ];
        sigma ~ student_t(3, 0, 1) T[, 20]; }
""", lambda: dict(N=8, y=_R.uniform(-1, 2, size=8), L=-1.5, U=2.5)),
    "transformed_data": ("""
data { int N; vector[N] x; }
transformed data {
  real xm = mean(x); vector[N] xc = x - xm; int K = N / 2;
  vector[K] head_x = head(xc, K); real noise = normal_rng(0, 1);
}
parameters { real a; real<lower=0> s; }
model { xc ~ normal(a, s); head_x ~ normal(a + noise * 0.0, s); s ~ exponential(1); }
""", lambda: dict(N=10, x=_R.normal(size=10))),
    "carried_loop": ("""
data { int N; vector[N] y; }
parameters { real mu; real<lower=0> sigma; real<lower=-1, upper=1> phi; }
model {
  vector[N] m;
  real acc = 0;
  m[1] = mu;
  for (n in 2:N) { m[n] = mu + phi * (y[n - 1] - mu); acc += square(y[n] - m[n]); }
  y ~ normal(m, sigma);
  target += -1e-3 * acc;
  mu ~ normal(0, 2); sigma ~ normal(0, 1);
}
""", lambda: dict(N=40, y=np.cumsum(_R.normal(size=40)) * 0.3)),
    "vmapped_loop": ("""
data { int N; vector[N] y; array[N] int g; }
parameters { vector[3] a; real<lower=0> s; }
model { a ~ normal(0, 1); s ~ normal(0, 1);
        for (n in 1:N) target += normal_lpdf(y[n] | a[g[n]], s); }
""", lambda: dict(N=48, y=_R.normal(size=48), g=_R.integers(1, 4, 48))),
    "tuples": ("""
data { tuple(real, array[2] int) d; }
parameters { tuple(real, real<lower=0>) p; }
transformed parameters { tuple(real, real) q = (p.1 * 2, p.2 + d.1); }
model { p.1 ~ normal(d.2[1], 1); p.2 ~ exponential(d.2[2]); q.2 ~ normal(3, 2); }
""", lambda: {"d": (1.5, np.array([1, 2]))}),
    "complex": ("""
parameters { real x; real<lower=0> r; }
transformed parameters {
  complex z = to_complex(x, r);
  complex w = z * z + conj(z);
}
model { x ~ normal(0, 1); r ~ exponential(1);
        target += -0.1 * abs(w) + 0.01 * get_real(w) - 0.01 * get_imag(w); }
generated quantities { real zr = get_real(z * 2); }
""", lambda: {}),
    "reduce_sum": ("""
functions {
  real partial(array[] real ys, int start, int end, real mu, real s) {
    return normal_lpdf(ys | mu, s);
  }
}
data { int N; array[N] real y; }
parameters { real mu; real<lower=0> s; }
model { target += reduce_sum(partial, y, 3, mu, s); mu ~ normal(0, 1); s ~ normal(0, 1); }
""", lambda: dict(N=12, y=_R.normal(size=12))),
    "map_rect": ("""
functions {
  vector job(vector phi, vector theta, data array[] real xr, data array[] int xi) {
    return [normal_lpdf(xr[1] | phi[1] + theta[1], 1)]';
  }
}
data { array[3, 1] real xr; array[3, 0] int xi; }
parameters { vector[1] phi; array[3] vector[1] theta; }
model { phi ~ normal(0, 1); for (j in 1:3) theta[j] ~ normal(0, 1);
        target += sum(map_rect(job, phi, theta, xr, xi)); }
""", lambda: dict(xr=_R.normal(size=(3, 1)), xi=np.zeros((3, 0), np.int64))),
}


def _models(name):
    code, data = PROGRAMS[name]
    d = data()
    jm = nj.compile_stan_model(code=code).with_data(**d)._make_model(0)
    tm = nt.compile_stan_model(code).with_data(**d)._make_model(0)
    return jm, tm


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_logp_and_gradient_match_jax(name):
    jm, tm = _models(name)
    assert jm.ndim == tm.ndim
    x = np.random.default_rng(3).normal(size=(4, tm.ndim)) * 0.5
    lj = np.asarray(jax.vmap(jm.logp_fn)(jnp.asarray(x)))
    gj = np.asarray(jax.vmap(jax.grad(jm.logp_fn))(jnp.asarray(x)))
    lt, gt = tm.logp_and_grad(torch.as_tensor(x))
    assert lt.dtype == torch.float64
    assert _rel(lt.numpy(), lj) < 1e-12, (lt, lj)
    assert _rel(gt.numpy(), gj) < 1e-10


@pytest.mark.parametrize("name", ["eight_schools", "logistic_matrix", "complex", "tuples"])
def test_expand_matches_jax(name):
    jm, tm = _models(name)
    x = np.random.default_rng(4).normal(size=(3, tm.ndim)) * 0.5
    jout = jax.vmap(jm.expand_fn)(jnp.asarray(x))
    tout = tm.expand_fn(torch.as_tensor(x))
    assert set(jout) == set(tout)
    assert [v.name for v in tm.expanded_variables] == [v.name for v in jm.expanded_variables]
    for k in jout:
        assert tuple(tout[k].shape) == tuple(np.shape(jout[k])), k
        assert _rel(tout[k].numpy(), np.asarray(jout[k])) < 1e-12, k


def test_stan_radon_equals_the_radon_model_up_to_a_constant():
    stan = nt.compile_stan_model(RADON_VECTOR).with_data(**radon_data())._make_model(0)
    ref = nt.models.radon()
    assert stan.ndim == ref.ndim == 173
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(4, 173)) * 0.3)
    ls, gs = stan.logp_and_grad(x)
    lr, gr = ref.logp_and_grad(x)
    diff = (ls - lr).numpy()
    assert np.abs(diff - diff[0]).max() < 1e-12 * np.abs(lr.numpy()).max()
    assert _rel(gs.numpy(), gr.numpy()) < 1e-12


def test_the_loop_form_runs_as_one_batched_body(monkeypatch):
    """The radon loop takes the vmap tier (one batched evaluation over n);
    a loop that writes outer state unrolls."""
    taken = []
    inner = tinterp.StanInterpreter._exec_for_batched

    def spy(self, stmt, env, ctx, lo, hi):
        ok = inner(self, stmt, env, ctx, lo, hi)
        taken.append(ok)
        return ok

    monkeypatch.setattr(tinterp.StanInterpreter, "_exec_for_batched", spy)
    for name, want in (("radon_loop", True), ("carried_loop", False)):
        taken.clear()
        _, tm = _models(name)
        tm.logp_and_grad(torch.zeros(2, tm.ndim, dtype=torch.float64))
        assert taken == [want], (name, taken)


def test_a_loop_that_fails_to_batch_is_tried_once(monkeypatch):
    """A loop whose body reads data at the loop variable (a data ``if``)
    cannot be batched; the first call finds that out and unrolls, and later
    calls unroll straight away, issuing none of the failed attempt's
    operations again.  The logp is the same on every call."""
    taken = []
    inner = tinterp.StanInterpreter._exec_for_batched

    def spy(self, stmt, env, ctx, lo, hi):
        ok = inner(self, stmt, env, ctx, lo, hi)
        taken.append(ok)
        return ok

    monkeypatch.setattr(tinterp.StanInterpreter, "_exec_for_batched", spy)
    model = nt.compile_stan_model(CENSORED).with_data(**censored_data())._make_model(0)
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(3, model.ndim)))
    first = [t.clone() for t in model.logp_and_grad(x)]
    for _ in range(2):
        again = model.logp_and_grad(x)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert taken == [False], taken


def test_a_parameter_if_is_a_compile_error():
    code = "parameters { real x; } model { if (x > 0) x ~ normal(0, 1); }"
    with pytest.raises(nt.frontends.stan.StanCompileError, match="depending on parameters"):
        nt.compile_stan_model(code)._make_model(0).logp_and_grad(
            torch.zeros(2, 1, dtype=torch.float64))
