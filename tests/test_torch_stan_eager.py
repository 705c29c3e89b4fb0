"""A solver-bearing Stan program under MCLMC and flow adaptation, in the
port against the JAX package, on the CPU in float64.

The Lotka-Volterra case study through the new ODE interface
(``tests/torch_stan_programs.py:LOTKA_VOLTERRA_NEW``; the old interface's
gradient raises in JAX) is marked ``eager_logp``: its log density reads
the device to stop, so the runners call it between their kernels'
launches instead of replaying a graph.  Two chains start within 0.1 of
the posterior means (JAX's init and step search), and each test runs one
chunk through the JAX runner and the port's from the same converted
state:

- the port's MCLMC init (its NUTS step search included) against JAX's:
  keys and counters exact, floats to rtol 1e-9 / atol 1e-12;
- one frozen MCLMC chunk: ints, keys and ``diverging`` exact, floats to
  rtol 1e-6 / atol 1e-8;
- one frozen NUTS chunk under seeded flows whose couplings act: ints and
  step counts exact, floats to rtol 1e-6 / atol 1e-8;
- one NUTS warmup chunk that ends with a flow update (a window of 2 rows,
  Adam from the first update, 3 steps): the flow update counts, the
  windows' validity and the step counts exact, floats to rtol 1e-6 /
  atol 1e-8;
- one MCLMC warmup chunk with the same flow update: the same bars.

The route of such a model under each sampler and adaptation is
``tests/test_torch_stan_functionals.py``'s.  The solver's loop runs the
same chains the same number of attempts in both packages here, so the
bars are the frozen chunks' of the other runner tests; a Dormand-Prince
attempt that parts by one would part the draws far more.

vmap's per-example fallback warning is an error here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu as nj
import nutpie_tpu.sampler.mclmc as jmc
import nutpie_tpu_torch as nt
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu.transforms.flow import FlowConfig as JFlowConfig
from nutpie_tpu_torch.convert import (
    mclmc_state_from_arrays,
    mclmc_state_to_arrays,
    state_from_arrays,
    state_to_arrays,
)
from nutpie_tpu_torch.ops import threefry
from nutpie_tpu_torch.sampler import mclmc as pmc
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS, NutsConfig
from nutpie_tpu_torch.sampler.run import make_chunk_runner
from nutpie_tpu_torch.transforms.flow import FlowConfig
from test_torch_flow_runner import _perturb
from test_torch_mclmc import assert_bufs_close, assert_mclmc_close, jax_mclmc_arrays
from torch_parity import assert_state_close, flow_arrays, jax_state_arrays
from torch_stan_programs import LOTKA_VOLTERRA_NEW, LV_THETA, LV_Z_INIT, lotka_volterra_data

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

torch.set_num_threads(1)

CHAINS, TUNE, SEED, MAXDEPTH = 2, 50, 5, 2
RTOL, ATOL = 1e-6, 1e-8
# the case study's posterior means in the unconstrained space
LV_CENTER = np.log(np.array(LV_THETA + LV_Z_INIT + (0.25, 0.25)))
# a small flow: a window of 2 rows fills in one 2-draw chunk, and the
# first update trains with Adam (no diagonal phase).  Each logp+grad of
# the case study takes most of a second here (host-bound), so the chunks
# are short and the trees stop at depth 2
FLOW = dict(num_layers=2, hidden=8, window=2, train_steps=3, num_diag_updates=0)
FLOW_CHUNK = 2


@pytest.fixture(scope="module")
def lv():
    data = lotka_volterra_data()
    jm = nj.compile_stan_model(code=LOTKA_VOLTERRA_NEW).with_data(**data)._make_model(0)
    tm = nt.compile_stan_model(LOTKA_VOLTERRA_NEW).with_data(**data)._make_model(0)
    assert tm.eager_logp
    jm = dataclasses.replace(
        jm, init_point_fn=lambda key, mean: mean + jax.random.uniform(
            key, mean.shape, minval=-0.1, maxval=0.1, dtype=mean.dtype))
    return jm, tm


def _mclmc_arrays(state) -> dict:
    out = jax_mclmc_arrays(state)
    if state.floww is not None:
        out.update(flow_arrays(state.floww, "floww"))
    return out


def _mclmc_pair(lv, flow):
    jm, tm = lv
    jcfg = jmc.MclmcConfig(adapt=JAdaptConfig(num_tune=TUNE),
                           flow=JFlowConfig(**FLOW) if flow else None)
    cfg = pmc.MclmcConfig(adapt=AdaptConfig(num_tune=TUNE),
                          flow=FlowConfig(**FLOW) if flow else None)
    states, ok = jmc.init_mclmc_chains(jm, jcfg, SEED, CHAINS, jnp.asarray(LV_CENTER),
                                       jnp.float64)
    assert bool(np.all(ok))
    return jcfg, cfg, states


def _mclmc_chunk(lv, start, chunk, states, jcfg, cfg):
    jm, tm = lv
    arrays = _mclmc_arrays(states)
    port = mclmc_state_from_arrays(arrays)
    js, jb = jmc.make_mclmc_chunk_runner(jm, jcfg, chunk, jnp.float64)(
        states, start, chunk, jmake_schedule(jcfg.adapt, TUNE))
    ts, tb = pmc.make_mclmc_chunk_runner(tm, cfg, chunk, torch.float64)(
        port, start, chunk, make_schedule(cfg.adapt, TUNE))
    assert_bufs_close(tb, jb, chunk, rtol=RTOL, atol=ATOL)
    got, ref = mclmc_state_to_arrays(ts), _mclmc_arrays(js)
    assert_mclmc_close(got, ref, rtol=RTOL, atol=ATOL)
    return got, ref


def test_mclmc_init_and_frozen_chunk_match_jax(lv):
    """The port's MCLMC init (the NUTS init search, whose probes of decided
    chains evaluate at their start) against JAX's: keys and counters
    exact, floats to rtol 1e-9 / atol 1e-12 (the solves' bar in
    ``test_torch_stan_functionals.py``).  Then a 2-draw chunk after tuning
    (the draw counters moved to the end of tuning) through the JAX runner
    and the port's eager plain path."""
    jcfg, cfg, states = _mclmc_pair(lv, flow=False)
    tm = dataclasses.replace(lv[1], init_point_fn=lambda kd, mean: mean + threefry.uniform(
        kd, (mean.shape[-1],), mean.dtype, -0.1, 0.1))
    port, ok = pmc.init_mclmc_chains(tm, cfg, SEED, CHAINS, LV_CENTER, torch.float64)
    assert bool(ok.all())
    assert_mclmc_close(mclmc_state_to_arrays(port), _mclmc_arrays(states), rtol=1e-9,
                       atol=1e-12)
    states = states._replace(draw_idx=jnp.full_like(states.draw_idx, TUNE))
    _mclmc_chunk(lv, TUNE, 2, states, jcfg, cfg)


def test_mclmc_flow_warmup_chunk_matches_jax(lv):
    """A warmup chunk under the initial flows whose end fills the window
    and trains each chain's flow (3 Adam steps), then re-bases the chain
    through the model's eager log density."""
    jcfg, cfg, states = _mclmc_pair(lv, flow=True)
    got, ref = _mclmc_chunk(lv, 0, FLOW_CHUNK, states, jcfg, cfg)
    np.testing.assert_array_equal(got["floww.flow_updates"], [1] * CHAINS)


def _nuts_pair(lv, flow_train: bool):
    jm, tm = lv
    jcfg = JNutsConfig(maxdepth=MAXDEPTH, flow=JFlowConfig(**FLOW),
                       adapt=JAdaptConfig(num_tune=TUNE, update_mass_matrix=False))
    cfg = NutsConfig(maxdepth=MAXDEPTH, flow=FlowConfig(**FLOW),
                     adapt=AdaptConfig(num_tune=TUNE, update_mass_matrix=False))
    states, ok = jinit_chains(jm, jcfg, SEED, CHAINS, jnp.asarray(LV_CENTER), jnp.float64)
    assert bool(np.all(ok))
    # seeded flows whose couplings act, unless the chunk trains them
    arrays = jax_state_arrays(states) if flow_train else _perturb(jax_state_arrays(states))
    return jcfg, cfg, arrays, states


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "warmup_flow_update"])
def test_nuts_flow_chunk_matches_jax(lv, frozen):
    """Frozen: one draw under seeded flows (the JAX runner's
    ``flow_train=False, adapt_frozen=True``).  Warmup: a 2-draw chunk from
    draw 0 whose end trains the flows."""
    from torch_parity import jax_state_from_arrays

    jm, tm = lv
    jcfg, cfg, arrays, template = _nuts_pair(lv, flow_train=not frozen)
    chunk = 1 if frozen else FLOW_CHUNK
    jrun = jmake_chunk_runner(jm, jcfg, chunk, jnp.float64, flow_train=not frozen,
                              adapt_frozen=frozen)
    js, jb = jrun(jax_state_from_arrays(template, arrays), 0, chunk,
                  jmake_schedule(jcfg.adapt, TUNE))
    run = make_chunk_runner(tm, cfg, chunk, torch.float64, adapt_frozen=frozen)
    ts, tb = run(state_from_arrays(arrays), 0, chunk, make_schedule(cfg.adapt, TUNE))
    got, ref = state_to_arrays(ts), jax_state_arrays(js)
    assert_state_close(got, ref, rtol=RTOL, atol=ATOL)
    ns = SCALAR_SLOTS["n_steps"]
    np.testing.assert_array_equal(tb.scalars[..., ns].numpy(), np.asarray(jb.scalars)[..., ns])
    for name in ("position", "scalars", "gradient"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got["adapt.flow_updates"], [0 if frozen else 1] * CHAINS)
