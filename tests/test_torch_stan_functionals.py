"""Stan's looping functionals in the port against the JAX package, on the CPU.

The same Stan program and numpy data go through both packages'
``compile_stan_model(...).with_data(...)``; the same seeded unconstrained
points go through the JAX interpreter's ``logp`` with ``jax.grad`` and the
port's batched logp with autograd, float64: logp and gradient to 1e-9
relative plus 1e-12 absolute, for ``integrate_1d`` (finite, parameter,
half-infinite and infinite bounds), the Newton family, the new ODE
interfaces and ``ode_adjoint_tol_ctl``, ``dae`` and ``dae_tol``, and the
Lotka-Volterra case study at 8 points.  The case study as written (the
old interface) has the JAX package's values, and in the port the new
interface's gradient, where the JAX package raises (its adjoint takes
``x_i``'s float0 cotangent; ROADMAP queue 3).  A fleet of chains that stop
at different attempts equals each chain run alone, bit for bit.  A 2-chain
frozen chunk of the case study through the port's step runner (its plain
version) matches the JAX runner.  ``dae``'s clamp of the substeps warns,
and ``max_num_steps`` stays a compile error.  The route: a program that
calls a solver is marked ``eager_logp`` before anything runs and takes
the step route under NUTS, with or without flow, and the MCLMC route
under MCLMC, with or without flow (each runner calls it eagerly between
its kernel's launches); ``integrate_1d`` alone keeps the graph route.

vmap's per-example fallback warning is an error here.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu as nj
import nutpie_tpu_torch as nt
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu_torch.convert import state_from_arrays, state_to_arrays
from nutpie_tpu_torch.frontends.stan import StanCompileError
from nutpie_tpu_torch.frontends.stan import functionals as F
from nutpie_tpu_torch.sample import _make_settings, config_from_settings, route
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import NutsConfig
from nutpie_tpu_torch.sampler.run import make_chunk_runner
from torch_parity import assert_state_close, jax_state_arrays
from torch_stan_programs import (
    _INTEGRATE,
    FUNCTIONAL_CASES,
    INTEGRATE_BOUNDS,
    LOTKA_VOLTERRA,
    LOTKA_VOLTERRA_NEW,
    LV_THETA,
    LV_Z_INIT,
    lotka_volterra_data,
)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
# the case study's posterior means in the unconstrained space (theta,
# z_init, sigma: all log-transformed)
LV_CENTER = np.log(np.array(LV_THETA + LV_Z_INIT + (0.25, 0.25)))


def _pair(code, data):
    jm = nj.compile_stan_model(code=code).with_data(**data)._make_model(0)
    tm = nt.compile_stan_model(code).with_data(**data)._make_model(0)
    return jm, tm


def _jax_logp_grad(jm, x):
    logp, grad = jax.jit(jax.vmap(jax.value_and_grad(jm.logp_fn)))(jnp.asarray(x))
    return np.asarray(logp), np.asarray(grad)


def _assert_matches_jax(code, data, n=3, scale=0.3, seed=3, center=0.0):
    jm, tm = _pair(code, data)
    x = center + np.random.default_rng(seed).normal(size=(n, tm.ndim)) * scale
    lj, gj = _jax_logp_grad(jm, x)
    lt, gt = tm.logp_and_grad(torch.as_tensor(x))
    assert np.isfinite(lj).all() and np.isfinite(gj).all()
    np.testing.assert_allclose(lt.numpy(), lj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=ATOL)
    return tm


@pytest.mark.parametrize("bounds", sorted(INTEGRATE_BOUNDS))
def test_integrate_1d_matches_jax(bounds):
    _assert_matches_jax(_INTEGRATE.replace("BOUNDS", INTEGRATE_BOUNDS[bounds]), {})


@pytest.mark.parametrize("name", ["algebra_solver", "solve_newton", "solve_newton_tol",
                                  "solve_powell_tol"])
def test_algebraic_solver_and_implicit_gradient_match_jax(name):
    code, data = FUNCTIONAL_CASES[name]
    _assert_matches_jax(code, data())


@pytest.mark.parametrize("name", ["ode_rk45", "ode_rk45_tol", "ode_bdf", "ode_adjoint_tol_ctl"])
def test_ode_and_adjoint_gradient_match_jax(name):
    code, data = FUNCTIONAL_CASES[name]
    _assert_matches_jax(code, data())


@pytest.mark.parametrize("name", ["dae", "dae_tol"])
def test_dae_matches_jax(name):
    code, data = FUNCTIONAL_CASES[name]
    _assert_matches_jax(code, data(), n=2)


def test_dae_max_num_steps_is_a_compile_error():
    code, data = FUNCTIONAL_CASES["dae_tol"]
    code = code.replace("1e-4, 1e-9, 1000, th", "1e-4, 1e-9, 12, th")
    jm, tm = _pair(code, data())
    x = np.zeros((1, tm.ndim))
    with pytest.raises(nj.frontends.stan.StanCompileError, match="max_num_steps=12"):
        jax.vmap(jm.logp_fn)(jnp.asarray(x))
    with pytest.raises(StanCompileError, match="max_num_steps=12"):
        tm.logp_and_grad(torch.as_tensor(x))


def test_dae_clamp_warns_once_when_data_are_bound():
    """The default ``dae`` asks for h = 1e-5: over a unit interval 100,000
    substeps, which the grid clamps to 256.  Times from the data warn when
    the data are bound; times the model block computes warn at the first
    evaluation; each call site once."""
    code, data = FUNCTIONAL_CASES["dae"]
    with pytest.warns(UserWarning, match=r"asks for up to 100000 TR-BDF2 substeps.* takes 256 "
                                         r"on 1 of its 1 intervals"):
        model = nt.compile_stan_model(code).with_data(**data() | dict(N=1, ts=[1.0],
                                                                      yobs=np.ones((1, 2))))
        interp = model._interpreter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        F.check_dae_grids(interp)
    # the initial time from the model block: known only where it runs
    late = code.replace("dae(res, yy0, yp0, 0.0, ts, th)", "dae(res, yy0, yp0, t0, ts, th)").replace(
        "vector[2] yy0", "real t0 = 0.0;\n  vector[2] yy0")
    late_model = nt.compile_stan_model(late).with_data(**data() | dict(N=1, ts=[0.003],
                                                                       yobs=np.ones((1, 2))))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m = late_model._make_model(0)
    with pytest.warns(UserWarning, match="asks for up to 300 TR-BDF2 substeps"):
        m.logp_fn(torch.zeros(1, m.ndim, dtype=torch.float64))


@pytest.fixture(scope="module")
def lotka_volterra():
    data = lotka_volterra_data()
    jm, tm = _pair(LOTKA_VOLTERRA_NEW, data)
    x = LV_CENTER + np.random.default_rng(8).normal(size=(8, 8)) * 0.2
    return dict(data=data, jm=jm, tm=tm, x=x, jax=_jax_logp_grad(jm, x),
                port=tm.logp_and_grad(torch.as_tensor(x)))


def test_lotka_volterra_logp_and_gradient_match_jax(lotka_volterra):
    lj, gj = lotka_volterra["jax"]
    lt, gt = lotka_volterra["port"]
    assert lotka_volterra["tm"].ndim == 8 and lotka_volterra["tm"].eager_logp
    np.testing.assert_allclose(lt.numpy(), lj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=ATOL)


def test_old_interface_values_match_jax_and_gradient_equals_the_new(lotka_volterra):
    """The case study as written: its logp is the JAX package's; its
    gradient, which the JAX package cannot take (``x_i``'s float0
    cotangent reaches ``ravel_pytree`` in ``_odeint_rev``), equals the new
    interface's in the port."""
    jm, tm = _pair(LOTKA_VOLTERRA, lotka_volterra["data"])
    x = lotka_volterra["x"]
    lt, gt = tm.logp_and_grad(torch.as_tensor(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(jax.vmap(jm.logp_fn)(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    ln, gn = lotka_volterra["port"]
    np.testing.assert_allclose(lt.numpy(), ln.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(gt.numpy(), gn.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="float0"):
        jax.grad(jm.logp_fn)(jnp.asarray(x[0]))


def test_a_fleet_equals_each_chain_alone(lotka_volterra):
    """Six chains whose solves stop after different numbers of attempts:
    each chain's logp and gradient in the fleet are its bits alone."""
    tm = lotka_volterra["tm"]
    x = LV_CENTER + np.random.default_rng(9).uniform(-1.0, 1.0, size=(6, 8))
    lf, gf = tm.logp_and_grad(torch.as_tensor(x))
    fwd, bwd = F.ATTEMPTS["forward"].sum(1), F.ATTEMPTS["backward"].sum(1)
    assert len(set(fwd.tolist())) > 1 and len(set(bwd.tolist())) > 1, (fwd, bwd)
    for c in range(6):
        lc, gc = tm.logp_and_grad(torch.as_tensor(x[c:c + 1]))
        assert torch.equal(lc[0], lf[c]) and torch.equal(gc[0], gf[c]), c
        assert int(F.ATTEMPTS["forward"].sum()) == int(fwd[c])


def test_lotka_volterra_frozen_chunk_matches_the_jax_runner(lotka_volterra):
    """Two chains started near the posterior (JAX's init and step search),
    one frozen 1-draw chunk at maxdepth 3 through both runners: ints exact,
    floats to rtol 1e-6 / atol 1e-8."""
    chains, draws, tune, maxdepth = 2, 1, 50, 3
    center = jnp.asarray(LV_CENTER)
    jm = dataclasses.replace(
        lotka_volterra["jm"],
        init_point_fn=lambda key, mean: mean + jax.random.uniform(
            key, mean.shape, minval=-0.1, maxval=0.1, dtype=mean.dtype))
    jcfg = JNutsConfig(maxdepth=maxdepth, adapt=JAdaptConfig(num_tune=tune))
    jstates, ok = jinit_chains(jm, jcfg, 5, chains, center, jnp.float64)
    assert bool(np.all(ok))
    jrun = jmake_chunk_runner(jm, jcfg, draws, jnp.float64, adapt_frozen=True)
    js, jb = jrun(jax.tree_util.tree_map(jnp.copy, jstates), 0, draws,
                  jmake_schedule(jcfg.adapt, tune))
    cfg = NutsConfig(maxdepth=maxdepth, adapt=AdaptConfig(num_tune=tune))
    run = make_chunk_runner(lotka_volterra["tm"], cfg, draws, torch.float64, adapt_frozen=True)
    ts, tb = run(state_from_arrays(jax_state_arrays(jstates)), 0, draws,
                 make_schedule(cfg.adapt, tune))
    assert_state_close(state_to_arrays(ts), jax_state_arrays(js), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.scalars.numpy(), np.asarray(jb.scalars), rtol=1e-6, atol=1e-8)


def test_the_route_is_decided_before_anything_runs():
    """Every looping functional marks the model; ``integrate_1d`` does not.
    A marked model takes the step route under NUTS, with or without flow
    adaptation, and the MCLMC route under MCLMC, with or without flow."""
    for name, (code, data) in FUNCTIONAL_CASES.items():
        model = nt.compile_stan_model(code).with_data(**data())._make_model(0)
        assert model.eager_logp == (name != "integrate_1d"), name
    code, data = FUNCTIONAL_CASES["solve_newton"]
    model = nt.compile_stan_model(code).with_data(**data())._make_model(0)
    assert route(NutsConfig(), model) == "step"
    for sampler, adaptation, want in (("mclmc", "diag", "mclmc"), ("nuts", "flow", "step"),
                                      ("mclmc", "flow", "mclmc")):
        cfg = config_from_settings(_make_settings(sampler, adaptation, 0))
        assert route(cfg, model) == want, (sampler, adaptation)
    # a solver called only from generated quantities leaves the log density capturable
    gq = ("functions { vector sys(vector y, real a) { return [y[1] - a]'; } }\n"
          "parameters { real a; } model { a ~ normal(0, 1); }\n"
          "generated quantities { vector[1] r = solve_newton(sys, [1.0]', a); }")
    assert not nt.compile_stan_model(gq)._make_model(0).eager_logp
