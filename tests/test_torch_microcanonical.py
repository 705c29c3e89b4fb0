"""NUTS with the microcanonical kinetic in the port, against the JAX
package, on the CPU in float64.

- The step runner (``make_chunk_runner``, the plain halves K2 runs) under
  ``kinetic="microcanonical"`` against JAX's ``make_chunk_runner``: eight
  schools under the diagonal metric and a 12-d correlated Gaussian under
  the low-rank one, 8 chains, maxdepth 6, from one state carried by
  ``convert.py``.  A frozen 16-draw chunk after JAX's warmup: ints exact,
  floats to rtol 1e-6 / atol 1e-8 (the bars of ``test_torch_step_runner``);
  a warmup chunk from draw 0: ints, step counts and Welford counts exact.
- ``find_initial_step``'s isokinetic probe against JAX's, to rtol 1e-10.
- Ports of ``tests/test_sample.py``'s microcanonical tests through
  ``sample(microcanonical_trajectory=True, device="cpu")``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu.models as jm
import nutpie_tpu_torch
import nutpie_tpu_torch.models as tm
from nutpie_tpu.model import make_model as jmake_model
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.nuts import LowRankConfig as JLowRankConfig
from nutpie_tpu.sampler.run import find_initial_step as jfind_initial_step
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu_torch.convert import state_from_arrays, state_to_arrays
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS, LowRankConfig, NutsConfig
from nutpie_tpu_torch.sampler.run import find_initial_step, make_chunk_runner
from nutpie_tpu_torch.sampler.step_kernel import step_kernel
from test_torch_mclmc_sample import correlated_gaussian
from torch_parity import assert_state_close, jax_state_arrays

torch.set_num_threads(1)

CHAINS, TUNE, CHUNK, MAXDEPTH = 8, 32, 16, 6


def _copy(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


def _jax_correlated(dim=12, seed=0):
    """The JAX twin of ``correlated_gaussian``."""
    _, cov = correlated_gaussian(dim=dim, seed=seed)
    prec = jnp.asarray(np.linalg.inv(cov))
    return jmake_model(dim, lambda x: -0.5 * x @ prec @ x,
                       param_vars=[("x", np.float64, (dim,), ("unconstrained_parameter",))])


def _models(name):
    if name == "low_rank":
        return _jax_correlated(), correlated_gaussian(dim=12)[0]
    return jm.eight_schools(), tm.eight_schools()


@pytest.fixture(scope="module", params=["diag", "low_rank"])
def fleet(request):
    low_rank = request.param == "low_rank"
    jmodel, model = _models(request.param)
    jcfg = JNutsConfig(maxdepth=MAXDEPTH, kinetic="microcanonical",
                       low_rank=JLowRankConfig(eigval_cutoff=1.5) if low_rank else None,
                       adapt=JAdaptConfig(num_tune=TUNE))
    cfg = NutsConfig(maxdepth=MAXDEPTH, kinetic="microcanonical",
                     low_rank=LowRankConfig(eigval_cutoff=1.5) if low_rank else None,
                     adapt=AdaptConfig(num_tune=TUNE))
    jsched = jmake_schedule(jcfg.adapt, TUNE)
    states, _ = jinit_chains(jmodel, jcfg, 5, CHAINS, np.zeros(jmodel.ndim), jnp.float64)
    fresh = _copy(states)
    warm = jmake_chunk_runner(jmodel, jcfg, CHUNK, jnp.float64)
    for start in range(0, TUNE, CHUNK):
        states, _ = warm(states, start, CHUNK, jsched)
    return dict(jmodel=jmodel, jcfg=jcfg, jsched=jsched, fresh=fresh, warm=_copy(states),
                model=model, cfg=cfg, sched=make_schedule(cfg.adapt, TUNE))


def _port_run(fleet, state, start, adapt_frozen):
    run = make_chunk_runner(fleet["model"], fleet["cfg"], CHUNK, torch.float64,
                            adapt_frozen=adapt_frozen)
    return run(state_from_arrays(jax_state_arrays(state)), start, CHUNK, fleet["sched"])


def test_frozen_chunk_matches_jax(fleet):
    jrun = jmake_chunk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64,
                              adapt_frozen=True)
    js, jb = jrun(_copy(fleet["warm"]), TUNE, CHUNK, fleet["jsched"])
    launches = step_kernel.launches
    ts, tb = _port_run(fleet, fleet["warm"], TUNE, True)
    assert step_kernel.launches == launches  # CPU tensors run the plain version
    assert_state_close(state_to_arrays(ts), jax_state_arrays(js), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(tb.scalars.numpy(), np.asarray(jb.scalars), rtol=1e-6,
                               atol=1e-8)
    # the isokinetic edges' kinetic weights move
    ke = state_to_arrays(ts)["flts"][:, 10:12]
    assert np.any(ke != 0.0)


def test_warmup_chunk_matches_jax(fleet):
    jrun = jmake_chunk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64)
    js, jb = jrun(_copy(fleet["fresh"]), 0, CHUNK, fleet["jsched"])
    ts, tb = _port_run(fleet, fleet["fresh"], 0, False)
    got, ref = state_to_arrays(ts), jax_state_arrays(js)
    np.testing.assert_array_equal(got["ints"], ref["ints"])
    ns = SCALAR_SLOTS["n_steps"]
    np.testing.assert_array_equal(tb.scalars[..., ns].numpy(), np.asarray(jb.scalars)[..., ns])
    for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
        np.testing.assert_array_equal(got[f"adapt.{acc}.count"], ref[f"adapt.{acc}.count"])
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-3,
                               atol=1e-3)


def test_find_initial_step_matches_jax(fleet):
    """The isokinetic probe from the fresh fleet's state (its step reset)."""
    js = _copy(fleet["fresh"])
    js = js._replace(adapt=js.adapt._replace(da=js.adapt.da._replace(
        log_step=jnp.full((CHAINS,), np.log(0.1)))))
    jout = jax.vmap(lambda s: jfind_initial_step(
        fleet["jcfg"], jax.value_and_grad(fleet["jmodel"].logp_fn), s))(js)
    out = find_initial_step(fleet["cfg"], fleet["model"].logp_and_grad,
                            state_from_arrays(jax_state_arrays(js)))
    np.testing.assert_allclose(out.adapt_flt("log_step").numpy(),
                               np.asarray(jout.adapt.da.log_step), rtol=1e-10)


def test_microcanonical_trajectory():
    model = compile_model_def(tm.std_normal(4, mu=0.5, sigma=1.5))
    common = dict(chains=4, tune=400, seed=9, device="cpu", progress_bar=False)
    trace = nutpie_tpu_torch.sample(model, draws=800, microcanonical_trajectory=True,
                                    **common)
    x = np.asarray(trace.posterior["x"].values)
    assert abs(x.mean() - 0.5) < 0.1
    assert abs(x.std() - 1.5) < 0.15
    div = np.asarray(trace.sample_stats["diverging"].values)
    assert div.mean() < 0.01
    trace2 = nutpie_tpu_torch.sample(model, draws=200, **common)
    assert not np.allclose(x[:, :200], np.asarray(trace2.posterior["x"].values))


def test_microcanonical_low_rank():
    model_def, _ = correlated_gaussian(dim=6)
    trace = nutpie_tpu_torch.sample(
        compile_model_def(model_def), chains=4, draws=200, tune=200, seed=10,
        progress_bar=False, adaptation="low_rank", microcanonical_trajectory=True,
        device="cpu")
    x = np.asarray(trace.posterior["x"].values)
    assert abs(x.mean()) < 0.6


def test_kinetic_is_checked():
    with pytest.raises(ValueError, match="kinetic"):
        NutsConfig(kinetic="relativistic")
