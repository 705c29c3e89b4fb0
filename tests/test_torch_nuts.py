"""The torch NUTS machine and chunk runner against the JAX package.

A radon fleet of 8 chains is warmed by JAX and carried over with
``nutpie_tpu_torch.convert``; both packages then step the same state.

- ``machine_step``: 40 steps with the same momenta (JAX's normals fed to
  both): integer decisions exact, floats to rtol 1e-6 (the two logp
  implementations round differently, ~1e-15 per gradient, and leapfrog
  integration amplifies that along a trajectory).
- The chunk runner's plain version against the JAX megakernel in Pallas
  interpret mode (``tile=4``) over one chunk of 16 draws: frozen, ints
  exact and floats to rtol 1e-6 / atol 1e-8 (as ``test_megakernel.py``
  allows the kernel against the XLA runner); warmup from a fresh fleet,
  ints, step counts and Welford counts exact, positions to 1e-3 and the
  adapted metric and step size to 1e-4 (adaptation feeds rounding
  differences back through the step size every draw).  The same warmup
  chunk at those bars under Adam, a fixed step size, and a target
  integration time with an extra doubling: the branches the chunk kernel
  K1 runs for them (``csrc/adapt.cuh``, ``csrc/warp.cuh:depth_limit``).
- ``convert`` carries a state both ways, with the four divergence rows of
  ``store_divergences`` too.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nutpie_tpu.models import radon as jax_radon
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.megakernel import make_megakernel_chunk_runner as jmk_runner
from nutpie_tpu.sampler.nuts import init_buffers as jinit_buffers
from nutpie_tpu.sampler.nuts import machine_step as jmachine_step
from nutpie_tpu.sampler.nuts import start_draw as jstart_draw
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu.sampler.state import state_with as jstate_with
from nutpie_tpu_torch.convert import state_from_arrays, state_to_arrays
from nutpie_tpu_torch.models import radon
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.megakernel import chunk_kernel, make_megakernel_chunk_runner
from nutpie_tpu_torch.sampler.nuts import (
    SCALAR_SLOTS,
    NutsConfig,
    init_buffers,
    machine_step,
    start_draw,
)
from nutpie_tpu_torch.sampler.state import state_with
from nutpie_tpu_torch.sample import route
from torch_parity import assert_state_close, jax_state_arrays

torch.set_num_threads(1)

CHAINS, TUNE, CHUNK = 8, 64, 16


@pytest.fixture(scope="module")
def fleet():
    jmodel = jax_radon(gather="onehot")
    jcfg = JNutsConfig(adapt=JAdaptConfig(num_tune=TUNE))
    jsched = jmake_schedule(jcfg.adapt, TUNE)
    states, _ = jinit_chains(jmodel, jcfg, 5, CHAINS, np.zeros(jmodel.ndim), jnp.float64)
    fresh = jax.tree_util.tree_map(jnp.copy, states)
    warm = jmake_chunk_runner(jmodel, jcfg, 32, jnp.float64)
    for start in range(0, TUNE, 32):
        states, _ = warm(states, start, 32, jsched)
    cfg = NutsConfig(adapt=AdaptConfig(num_tune=TUNE))
    return dict(jmodel=jmodel, jcfg=jcfg, jsched=jsched, fresh=fresh,
                warm=jax.tree_util.tree_map(jnp.copy, states), model=radon(),
                cfg=cfg, sched=make_schedule(cfg.adapt, TUNE))


def _copy(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


def test_convert_round_trip(fleet):
    arrays = jax_state_arrays(fleet["warm"])
    state = state_from_arrays(arrays)
    assert state.vecs.shape == (CHAINS, 14, 173) and state.ckpt_p.shape == (CHAINS, 10, 173)
    assert state.adapt_vecs.shape == (CHAINS, 9, 173) and state.adapt_flts.shape == (CHAINS, 12)
    assert state.key.dtype == torch.int64 and state.ints.dtype == torch.int32
    back = state_to_arrays(state)
    assert back.keys() == arrays.keys()
    for name, value in arrays.items():
        np.testing.assert_array_equal(back[name], np.asarray(value), err_msg=name)
    # a state with the divergence rows (store_divergences): 18 rows, the
    # last four NaN at a draw start, set where a draw diverged
    jcfg = JNutsConfig(store_divergences=True, adapt=JAdaptConfig(num_tune=TUNE))
    div_state, _ = jinit_chains(fleet["jmodel"], jcfg, 5, CHAINS,
                                np.zeros(fleet["jmodel"].ndim), jnp.float64)
    arrays = jax_state_arrays(div_state)
    arrays["vecs"] = arrays["vecs"].copy()
    arrays["vecs"][::2, 14:] = np.arange(4 * 173).reshape(4, 173)
    state = state_from_arrays(arrays)
    assert state.vecs.shape == (CHAINS, 18, 173)
    assert torch.isnan(state.vecs[1::2, 14:]).all()
    back = state_to_arrays(state)
    for name, value in arrays.items():
        np.testing.assert_array_equal(back[name], np.asarray(value), err_msg=name)


@pytest.mark.parametrize("adapt_frozen", [True, False])
def test_machine_step_matches_jax(fleet, adapt_frozen):
    # adapting steps run under a longer warmup schedule, so the draws that
    # complete within the 40 steps are tuning draws
    num_tune = TUNE if adapt_frozen else 300
    jsched = jmake_schedule(fleet["jcfg"].adapt, num_tune)
    sched = make_schedule(fleet["cfg"].adapt, num_tune)
    jmodel, jcfg = fleet["jmodel"], fleet["jcfg"]
    dim = jmodel.ndim
    snap = jstate_with(_copy(fleet["warm"]), done=False)
    mom = jax.vmap(lambda k: jax.vmap(lambda d: jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(k, 1), d), (dim,), jnp.float64))(
        TUNE + jnp.arange(CHUNK)))(snap.rng_key)
    jit_u = jax.vmap(lambda k: jax.vmap(lambda d: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(k, 2), d), (), jnp.float64))(
        TUNE + jnp.arange(CHUNK)))(snap.rng_key)

    js = jax.vmap(partial(jstart_draw, jcfg, jsched))(snap, mom[:, 0], jit_u[:, 0])
    jb = jinit_buffers(jcfg, CHUNK, dim, jnp.float64, n_chains=CHAINS)
    step = jax.jit(jax.vmap(
        partial(jmachine_step, jcfg, lambda x, a: jmodel.logp_and_grad(x),
                adapt_frozen=adapt_frozen),
        in_axes=(None, 0, 0, None, None, 0, 0),
    ))
    for _ in range(40):
        js, jb = step(jsched, mom, jit_u, TUNE, CHUNK, js, jb)

    cfg, model = fleet["cfg"], fleet["model"]
    ts = state_with(state_from_arrays(jax_state_arrays(snap)), done=False)
    tmom = torch.tensor(np.array(mom))
    tjit = torch.tensor(np.array(jit_u))
    ts = start_draw(cfg, sched, ts, tmom[:, 0], tjit[:, 0])
    tb = init_buffers(CHUNK, dim, torch.float64, CHAINS)
    for _ in range(40):
        ts, tb = machine_step(cfg, model.logp_and_grad, sched, tmom, tjit, TUNE, CHUNK,
                              ts, tb, adapt_frozen=adapt_frozen)

    assert_state_close(state_to_arrays(ts), jax_state_arrays(js), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.scalars.numpy(), np.asarray(jb.scalars), rtol=1e-6, atol=1e-8)
    assert int((ts.ints[:, 0] - TUNE).sum()) > 0  # some draws completed


def test_runner_frozen_matches_jax_megakernel(fleet):
    jrun = jmk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64, tile=4,
                      interpret=True)
    js, jb = jrun(_copy(fleet["warm"]), TUNE, CHUNK, fleet["jsched"])
    run = make_megakernel_chunk_runner(fleet["model"], fleet["cfg"], CHUNK, torch.float64)
    launches = chunk_kernel.launches
    ts, tb = run(state_from_arrays(jax_state_arrays(fleet["warm"])), TUNE, CHUNK,
                 fleet["sched"])
    assert chunk_kernel.launches == launches  # CPU tensors run the plain version
    assert_state_close(state_to_arrays(ts), jax_state_arrays(js), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.scalars.numpy(), np.asarray(jb.scalars), rtol=1e-6, atol=1e-8)


def test_runner_warmup_matches_jax_megakernel(fleet):
    jrun = jmk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64, tile=4,
                      interpret=True, adapt_frozen=False)
    js, jb = jrun(_copy(fleet["fresh"]), 0, CHUNK, fleet["jsched"])
    run = make_megakernel_chunk_runner(fleet["model"], fleet["cfg"], CHUNK, torch.float64,
                                       adapt_frozen=False)
    ts, tb = run(state_from_arrays(jax_state_arrays(fleet["fresh"])), 0, CHUNK,
                 fleet["sched"])
    got, ref = state_to_arrays(ts), jax_state_arrays(js)
    np.testing.assert_array_equal(got["ints"], ref["ints"])
    ns = SCALAR_SLOTS["n_steps"]
    np.testing.assert_array_equal(tb.scalars[..., ns].numpy(), np.asarray(jb.scalars)[..., ns])
    for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
        np.testing.assert_array_equal(got[f"adapt.{acc}.count"], ref[f"adapt.{acc}.count"])
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["adapt.inv_mass"], ref["adapt.inv_mass"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["adapt.da.log_step_bar"], ref["adapt.da.log_step_bar"],
                               rtol=1e-4, atol=1e-6)


# (AdaptConfig fields, NutsConfig fields, draws) of each option K1 runs;
# Adam and the fixed step keep the fresh fleet's early steps small for
# longer, so their deeper trees take 8 draws to keep each case within
# about 30 s in the Pallas interpreter
OPTIONS = {
    "adam": ({"method": "adam"}, {}, 8),
    "fixed_step": ({"method": 0.05}, {}, 8),
    "target_time": ({}, {"target_time": 0.3, "extra_doublings": 1}, CHUNK),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_runner_warmup_options_match_jax_megakernel(fleet, option):
    adapt, nuts, limit = OPTIONS[option]
    jcfg = JNutsConfig(adapt=JAdaptConfig(num_tune=TUNE, **adapt), **nuts)
    cfg = NutsConfig(adapt=AdaptConfig(num_tune=TUNE, **adapt), **nuts)
    jrun = jmk_runner(fleet["jmodel"], jcfg, CHUNK, jnp.float64, tile=4, interpret=True,
                      adapt_frozen=False)
    js, jb = jrun(_copy(fleet["fresh"]), 0, limit, jmake_schedule(jcfg.adapt, TUNE))
    run = make_megakernel_chunk_runner(fleet["model"], cfg, CHUNK, torch.float64,
                                       adapt_frozen=False)
    assert route(cfg, fleet["model"]) == "megakernel"
    ts, tb = run(state_from_arrays(jax_state_arrays(fleet["fresh"])), 0, limit,
                 make_schedule(cfg.adapt, TUNE))
    got, ref = state_to_arrays(ts), jax_state_arrays(js)
    np.testing.assert_array_equal(got["ints"], ref["ints"])
    ns = SCALAR_SLOTS["n_steps"]
    np.testing.assert_array_equal(tb.scalars[..., ns].numpy(), np.asarray(jb.scalars)[..., ns])
    for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg", "adam"):
        np.testing.assert_array_equal(got[f"adapt.{acc}.count"], ref[f"adapt.{acc}.count"])
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["adapt.inv_mass"], ref["adapt.inv_mass"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["adapt.da.log_step_bar"], ref["adapt.da.log_step_bar"],
                               rtol=1e-4, atol=1e-6)
    if option == "adam":
        assert (got["adapt.adam.count"] == limit).all()
    elif option == "fixed_step":
        assert np.allclose(got["adapt.da.log_step_bar"], np.log(0.05), rtol=0, atol=0)
    else:
        # each draw's depth within its limit from its own step size, which
        # some draws reach
        scal = tb.scalars[:, :limit].numpy()
        eps = scal[..., SCALAR_SLOTS["step_size"]]
        cap = np.clip(np.ceil(np.log2(np.maximum(0.3 / eps, 1.0))) + 1, 1, 10)
        depth = scal[..., SCALAR_SLOTS["depth"]]
        assert (depth <= cap).all() and (depth == cap).any()
