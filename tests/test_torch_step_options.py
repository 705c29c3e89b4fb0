"""Step-size and depth options and the divergence rows through the step
runner, against the JAX package.

Adam and a fixed step size take their own branch of the per-draw
adaptation, ``target_integration_time`` (with ``extra_doublings``) its own
per-draw depth limit, and ``store_divergences`` the four divergence rows
of the state and their buffers (the step kernel K2's instantiation with
those rows, ``csrc/step_kernel.cu``; the branches in ``csrc/adapt.cuh``
and ``csrc/warp.cuh:depth_limit``).  Each runs the port's step runner
(``sampler/run.py:make_chunk_runner``, its plain version on the CPU)
against ``nutpie_tpu/sampler/run.py:make_chunk_runner`` on 8 chains
(maxdepth 6, float64) with 16 tuning draws: the warmup chunk of those 16
draws from a fresh fleet, then a frozen chunk of 16 posterior draws from
the state the JAX warmup chunk left, as ``test_torch_step_settings.py``
does, at its bars: the warmup chunk's ints, step counts and Welford counts
exact and positions to 1e-3; the frozen chunk's ints exact and floats to
rtol 1e-6 / atol 1e-8.  The fixed step 0.25 with a target time of 2.0
puts the ratio at exactly 8, a power of two.  The divergence rows run on
the centered eight schools, which diverges, under the diagonal and the
low-rank metric; their buffers are held to the same bars and must be NaN
exactly where a draw did not diverge (a divergence there is an energy
error above 10, so that 16 draws of 8 chains have some).
``tests/test_torch_step_kernel_cuda.py`` holds K2 to its plain version in
the same options on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu.models as jm
import nutpie_tpu_torch.models as tm
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.nuts import LowRankConfig as JLowRankConfig
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu_torch.convert import state_from_arrays, state_to_arrays
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import DIV_BUFFERS, SCALAR_SLOTS, LowRankConfig, NutsConfig
from nutpie_tpu_torch.sampler.run import make_chunk_runner
from torch_parity import assert_state_close, jax_state_arrays

torch.set_num_threads(1)

CHAINS, TUNE, CHUNK, MAXDEPTH = 8, 16, 16, 6
# (model's centered flag, NutsConfig fields, AdaptConfig fields, low rank)
OPTIONS = {
    "adam": (False, {}, {"method": "adam"}, False),
    "fixed_step": (False, {}, {"method": 0.1}, False),
    "target_time": (False, {"target_time": 2.0, "extra_doublings": 1}, {"method": 0.25},
                    False),
    # a divergence at an energy error of 10 (not 1000): in 16 draws of 8
    # chains the centered model then diverges in both chunks
    "store_divergences": (True, {"store_divergences": True, "max_energy_error": 10.0}, {},
                          False),
    "adam_low_rank": (False, {}, {"method": "adam"}, True),
    "store_divergences_low_rank": (True, {"store_divergences": True, "max_energy_error": 10.0},
                                   {}, True),
}


@functools.lru_cache(maxsize=None)
def _fresh_fleet(centered: bool, low_rank: bool, store_divergences: bool):
    """A fresh JAX fleet; options that leave the initial state alone share it."""
    jmodel = jm.eight_schools(centered=centered)
    jcfg = JNutsConfig(maxdepth=MAXDEPTH, adapt=JAdaptConfig(num_tune=TUNE),
                       low_rank=JLowRankConfig() if low_rank else None,
                       store_divergences=store_divergences)
    states, _ = jinit_chains(jmodel, jcfg, 7, CHAINS, np.zeros(jmodel.ndim), jnp.float64)
    return states


def _buffers(bufs, names) -> dict:
    return {name: np.asarray(getattr(bufs, name)) for name in names}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax(option):
    centered, nuts, adapt, low_rank = OPTIONS[option]
    nuts = {"maxdepth": MAXDEPTH, **nuts}
    jmodel, model = jm.eight_schools(centered=centered), tm.eight_schools(centered=centered)
    jcfg = JNutsConfig(adapt=JAdaptConfig(num_tune=TUNE, **adapt),
                       low_rank=JLowRankConfig() if low_rank else None, **nuts)
    cfg = NutsConfig(adapt=AdaptConfig(num_tune=TUNE, **adapt),
                     low_rank=LowRankConfig() if low_rank else None, **nuts)
    jsched, sched = jmake_schedule(jcfg.adapt, TUNE), make_schedule(cfg.adapt, TUNE)
    fresh = jax.tree_util.tree_map(
        jnp.copy, _fresh_fleet(centered, low_rank, cfg.store_divergences))
    port_state = state_from_arrays(jax_state_arrays(fresh))

    jrun = jmake_chunk_runner(jmodel, jcfg, CHUNK, jnp.float64)
    run = make_chunk_runner(model, cfg, CHUNK, torch.float64)
    div = list(DIV_BUFFERS) if cfg.store_divergences else []

    # warmup chunk from the fresh fleet
    js, jb = jrun(fresh, 0, CHUNK, jsched)
    ts, tb = run(port_state, 0, CHUNK, sched)
    got, ref = state_to_arrays(ts), jax_state_arrays(js)
    np.testing.assert_array_equal(got["ints"], ref["ints"])
    ns = SCALAR_SLOTS["n_steps"]
    np.testing.assert_array_equal(tb.scalars[..., ns].numpy(), np.asarray(jb.scalars)[..., ns])
    for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
        np.testing.assert_array_equal(got[f"adapt.{acc}.count"], ref[f"adapt.{acc}.count"])
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-3, atol=1e-3)
    if adapt.get("method") == "adam":
        np.testing.assert_array_equal(got["adapt.adam.count"], ref["adapt.adam.count"])
        assert (got["adapt.adam.count"] > 0).all()

    # frozen chunk (posterior draws) from the state the JAX warmup chunk left
    warm = state_from_arrays(jax_state_arrays(js))
    js2, jb2 = jrun(js, CHUNK, CHUNK, jsched)
    ts2, tb2 = run(warm, CHUNK, CHUNK, sched)
    assert_state_close(state_to_arrays(ts2), jax_state_arrays(js2), rtol=1e-6, atol=1e-8)
    for name in ["position", "scalars"] + div:
        np.testing.assert_allclose(getattr(tb2, name).numpy(), np.asarray(getattr(jb2, name)),
                                   rtol=1e-6, atol=1e-8, err_msg=name)

    scal = tb2.scalars
    depth = scal[..., SCALAR_SLOTS["depth"]]
    diverging = (scal[..., SCALAR_SLOTS["diverging"]] > 0).numpy()
    if option == "fixed_step":
        # past tuning every draw runs the fixed step exactly
        assert np.allclose(scal[..., SCALAR_SLOTS["step_size_bar"]].numpy(), 0.1, rtol=1e-15)
    elif option == "target_time":
        # 2.0 / 0.25 = 8 = 2^3: a depth limit of 3 + 1 extra doubling
        assert bool((depth <= 4).all()) and bool((depth == 4).any())
    elif cfg.store_divergences:
        assert diverging.any(), "no divergence in the frozen chunk"
        for name, value in _buffers(tb2, div).items():
            finite = np.isfinite(value).all(axis=-1)
            nan = np.isnan(value).all(axis=-1)
            np.testing.assert_array_equal(finite, diverging, err_msg=name)
            np.testing.assert_array_equal(nan, ~diverging, err_msg=name)
