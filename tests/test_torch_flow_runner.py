"""The step runner under flow adaptation against the JAX package's runner.

Four chains of ``funnel(dim=4, scale=1.0)`` start from the JAX package's
initialization under a small flow (two couplings, hidden 8); each chain's
flow is then moved to seeded non-identity parameters (couplings that act)
in both packages alike.  On the CPU in float64:

- a frozen chunk (the JAX runner's ``flow_train=False, adapt_frozen=True``)
  with and without ``use_orbit``, with ``store_transformed``: ints and step
  counts exact, floats to rtol 1e-6 / atol 1e-8 (the state, the draws in
  model space, the Fisher distance, the transformed rows, the orbit rows);
- two warmup chunks, the second ending with the chains' first flow
  updates (the window fills): the first chunk's step counts, the flow
  update counts and the windows' validity exact, floats to the warmup bars
  of ``test_torch_step_runner.py`` (adaptation feeds rounding back);
- the reference's fault: a trapped chain, rescued at a chunk's end, has
  that chunk converted through the donor's flow by the JAX runner and
  through its own by the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu.models as jm
import nutpie_tpu_torch.models as tm
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu.transforms.flow import FlowConfig as JFlowConfig
from nutpie_tpu_torch.convert import state_from_arrays, state_to_arrays
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS, NutsConfig
from nutpie_tpu_torch.sampler.run import make_chunk_runner
from nutpie_tpu_torch.sampler.state import flow_params
from nutpie_tpu_torch.transforms.flow import FlowConfig, chunk_to_model_space
from torch_parity import assert_state_close, jax_state_arrays, jax_state_from_arrays

torch.set_num_threads(1)

CHAINS, TUNE, CHUNK, MAXDEPTH, DIM = 4, 64, 16, 5, 4
FLOW = dict(num_layers=2, hidden=8, window=32, train_steps=5, num_diag_updates=1)


def _perturb(arrays: dict, seed: int = 5, scale: float = 0.15) -> dict:
    """Each chain's flow moved to seeded parameters that act."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    for name, s in (("mu", 0.3), ("log_sigma", 0.2), ("w2", scale), ("b2", 0.05)):
        leaf = f"adapt.flow.{name}"
        out[leaf] = s * rng.standard_normal(np.shape(arrays[leaf]))
    return out


def _fleet(use_orbit: bool, store_transformed: bool = False, n_chains: int = CHAINS,
           model="funnel"):
    jmodel = jm.funnel(dim=DIM, scale=1.0) if model == "funnel" else jm.std_normal(DIM)
    tmodel = tm.funnel(dim=DIM, scale=1.0) if model == "funnel" else tm.std_normal(DIM)
    jcfg = JNutsConfig(maxdepth=MAXDEPTH, store_transformed=store_transformed,
                       flow=JFlowConfig(use_orbit=use_orbit, **FLOW),
                       adapt=JAdaptConfig(num_tune=TUNE, update_mass_matrix=False))
    cfg = NutsConfig(maxdepth=MAXDEPTH, store_transformed=store_transformed,
                     flow=FlowConfig(use_orbit=use_orbit, **FLOW),
                     adapt=AdaptConfig(num_tune=TUNE, update_mass_matrix=False))
    states, _ = jinit_chains(jmodel, jcfg, 11, n_chains, np.zeros(jmodel.ndim), jnp.float64)
    arrays = _perturb(jax_state_arrays(states))
    return dict(jmodel=jmodel, jcfg=jcfg, jsched=jmake_schedule(jcfg.adapt, TUNE),
                model=tmodel, cfg=cfg, sched=make_schedule(cfg.adapt, TUNE),
                arrays=arrays, template=states)


def _jax_state(fleet, arrays=None):
    return jax_state_from_arrays(fleet["template"], arrays or fleet["arrays"])


def _close(got, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("use_orbit", [False, True])
def test_frozen_flow_chunk_matches_jax(use_orbit):
    fleet = _fleet(use_orbit, store_transformed=True)
    jrun = jmake_chunk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64,
                              flow_train=False, adapt_frozen=True)
    js, jb = jrun(_jax_state(fleet), 0, CHUNK, fleet["jsched"])
    run = make_chunk_runner(fleet["model"], fleet["cfg"], CHUNK, torch.float64,
                            adapt_frozen=True)
    ts, tb = run(state_from_arrays(fleet["arrays"]), 0, CHUNK, fleet["sched"])
    assert_state_close(state_to_arrays(ts), jax_state_arrays(js), rtol=1e-6, atol=1e-8)
    ns = SCALAR_SLOTS["n_steps"]
    np.testing.assert_array_equal(tb.scalars[..., ns].numpy(), np.asarray(jb.scalars)[..., ns])
    names = ["position", "scalars", "gradient", "transformed_position", "transformed_gradient",
             "transformation_mu"]
    if use_orbit:
        names += ["orbit_position", "orbit_gradient"]
    for name in names:
        _close(getattr(tb, name), getattr(jb, name), 1e-6, 1e-8, name)
    fd = tb.scalars[..., SCALAR_SLOTS["fisher_distance"]].numpy()
    assert np.isfinite(fd).all() and (fd > 0).all()
    assert np.isfinite(tb.position.numpy()).all()


@pytest.mark.parametrize("use_orbit", [False, True])
def test_warmup_flow_chunks_match_jax(use_orbit):
    """Two warmup chunks: at the second's end the window holds 32 rows and
    the flows update (a diagonal refit) and the chains are re-based."""
    fleet = _fleet(use_orbit)
    jrun = jmake_chunk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64)
    run = make_chunk_runner(fleet["model"], fleet["cfg"], CHUNK, torch.float64)
    js, ts = _jax_state(fleet), state_from_arrays(fleet["arrays"])
    for k, start in enumerate((0, CHUNK)):
        js, jb = jrun(js, start, CHUNK, fleet["jsched"])
        ts, tb = run(ts, start, CHUNK, fleet["sched"])
        got, ref = state_to_arrays(ts), jax_state_arrays(js)
        ns = SCALAR_SLOTS["n_steps"]
        if k == 0:  # no warmup has amplified rounding yet
            np.testing.assert_array_equal(tb.scalars[..., ns].numpy(),
                                          np.asarray(jb.scalars)[..., ns])
        np.testing.assert_array_equal(got["adapt.flow_updates"], ref["adapt.flow_updates"])
        np.testing.assert_array_equal(got["adapt.win_valid"], ref["adapt.win_valid"])
        for leaf in ("adapt.flow.mu", "adapt.flow.log_sigma", "adapt.flow.w2"):
            _close(got[leaf], ref[leaf], 1e-3, 1e-3, leaf)
        _close(tb.position, jb.position, 1e-3, 1e-3, "position")
        _close(got["adapt.da.log_step_bar"], ref["adapt.da.log_step_bar"], 1e-4, 1e-6,
               "log_step_bar")
    assert np.asarray(ref["adapt.flow_updates"]).max() >= 1  # a flow trained


def test_rescue_converts_with_the_chunks_flow():
    """The reference's fault (ROADMAP.md queue 3): chain 0 is trapped far
    out (tiny step size) through a warmup chunk that ends where the rescue
    acts; the rescue teleports the donor's flow into it before the JAX
    runner converts the chunk, so the JAX package expresses chain 0's draws
    through the donor's flow, and the port through chain 0's own.  The
    base-space draws agree; the other chains' converted draws agree."""
    fleet = _fleet(False, store_transformed=True, n_chains=8, model="std_normal")
    arrays = dict(fleet["arrays"])
    vecs = np.array(arrays["vecs"])
    vecs[0, :, :] = np.where(np.arange(vecs.shape[1])[:, None] < 14, 30.0, vecs[0])
    arrays["vecs"] = vecs
    flts = np.array(arrays["flts"])
    flts[0, 0] = -0.5 * 900.0 * DIM  # logp at z = 30 under a near-identity flow
    arrays["flts"] = flts
    for leaf in ("adapt.da.log_step", "adapt.da.log_step_bar", "adapt.da.mu"):
        a = np.array(arrays[leaf])
        a[0] = np.log(1e-6)
        arrays[leaf] = a
    ints = np.array(arrays["ints"])
    ints[:, 0] = CHUNK  # every chain at draw 16: the chunk [16, 32) ends where the rescue acts
    arrays["ints"] = ints
    jrun = jmake_chunk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64)
    run = make_chunk_runner(fleet["model"], fleet["cfg"], CHUNK, torch.float64)
    state0 = state_from_arrays(arrays)
    js, jb = jrun(_jax_state(fleet, arrays), CHUNK, CHUNK, fleet["jsched"])
    ts, tb = run(state0, CHUNK, CHUNK, fleet["sched"])
    z = tb.transformed_position
    _close(z, jb.transformed_position, 1e-6, 1e-8, "base-space draws")
    # chain 0 was trapped and took the donor's state
    assert float(state0.logp[0]) < -1000 and float(ts.logp[0]) > -100
    own, _, _ = chunk_to_model_space(fleet["cfg"].flow, flow_params(state0), z)
    np.testing.assert_allclose(tb.position[0].numpy(), own[0].numpy(), rtol=1e-12)
    gap = np.abs(tb.position[0].numpy() - np.asarray(jb.position)[0]).max()
    assert gap > 1e-2, gap
    _close(tb.position[1:], np.asarray(jb.position)[1:], 1e-3, 1e-3, "other chains")
