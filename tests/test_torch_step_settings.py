"""Four sampler settings through the step runner, against the JAX package.

``step_size_jitter``, ``mindepth > 1``, ``check_turning=False`` and the
draw-based mass-matrix estimate (``use_grad_based_estimate=False``, the
``adaptation="draw_diag"`` setting) each take their own branch of the
machine step and of the step kernel K2 (``csrc/step_kernel.cu``,
``csrc/adapt.cuh``).  Each runs the port's step runner
(``sampler/run.py:make_chunk_runner``, its plain version on the CPU)
against ``nutpie_tpu/sampler/run.py:make_chunk_runner`` on 8 chains of
``eight_schools()`` (maxdepth 6) with 16 tuning draws: the warmup chunk
of those 16 draws from a fresh fleet, then a frozen chunk of 16 posterior
draws (past tuning the adaptation is off) from the state the JAX warmup
chunk left, both through one runner of each package (one JAX compile per
setting).  Bars as in ``test_torch_step_runner.py``: the warmup chunk's
ints, step counts and Welford counts exact and positions to 1e-3; the
frozen chunk's ints exact and floats to rtol 1e-6 / atol 1e-8.  ``tests/test_torch_step_kernel_cuda.py``
holds K2 to its plain version in the same four settings on the card.
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
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu_torch.convert import state_from_arrays, state_to_arrays
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS, NutsConfig
from nutpie_tpu_torch.sampler.run import make_chunk_runner
from torch_parity import assert_state_close, jax_state_arrays

torch.set_num_threads(1)

CHAINS, TUNE, CHUNK, MAXDEPTH = 8, 16, 16, 6
# (NutsConfig fields, AdaptConfig fields) of each setting; check_turning=False
# runs every tree to maxdepth, so it takes a smaller one
SETTINGS = {
    "step_size_jitter": ({}, {"step_size_jitter": 0.3}),
    "mindepth": ({"mindepth": 3}, {}),
    "no_turning_check": ({"check_turning": False, "maxdepth": 4}, {}),
    "draw_diag": ({}, {"use_grad_based_estimate": False}),
}


@functools.lru_cache(maxsize=None)
def _fresh_fleet(maxdepth: int):
    """A fresh JAX fleet; the settings leave the initial state alone, so the
    settings of one maxdepth share it (and its compile)."""
    jmodel = jm.eight_schools()
    jcfg = JNutsConfig(maxdepth=maxdepth, adapt=JAdaptConfig(num_tune=TUNE))
    states, _ = jinit_chains(jmodel, jcfg, 7, CHAINS, np.zeros(jmodel.ndim), jnp.float64)
    return states


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_setting_matches_jax(setting):
    nuts, adapt = SETTINGS[setting]
    nuts = {"maxdepth": MAXDEPTH, **nuts}
    jmodel, model = jm.eight_schools(), tm.eight_schools()
    jcfg = JNutsConfig(adapt=JAdaptConfig(num_tune=TUNE, **adapt), **nuts)
    cfg = NutsConfig(adapt=AdaptConfig(num_tune=TUNE, **adapt), **nuts)
    jsched, sched = jmake_schedule(jcfg.adapt, TUNE), make_schedule(cfg.adapt, TUNE)
    # a copy: the JAX runner donates its input
    fresh = jax.tree_util.tree_map(jnp.copy, _fresh_fleet(nuts["maxdepth"]))
    port_state = state_from_arrays(jax_state_arrays(fresh))

    jrun = jmake_chunk_runner(jmodel, jcfg, CHUNK, jnp.float64)
    run = make_chunk_runner(model, cfg, CHUNK, torch.float64)

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

    # frozen chunk (posterior draws) from the state the JAX warmup chunk left
    warm = state_from_arrays(jax_state_arrays(js))
    js2, jb2 = jrun(js, CHUNK, CHUNK, jsched)
    ts2, tb2 = run(warm, CHUNK, CHUNK, sched)
    assert_state_close(state_to_arrays(ts2), jax_state_arrays(js2), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb2.position.numpy(), np.asarray(jb2.position),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb2.scalars.numpy(), np.asarray(jb2.scalars),
                               rtol=1e-6, atol=1e-8)
    # the setting took effect: jitter spreads a chain's step sizes, and
    # mindepth and a missing turning check bound a draw's depth from below
    # (a divergence ends a draw at any depth)
    depth = tb2.scalars[..., SCALAR_SLOTS["depth"]]
    kept = tb2.scalars[..., SCALAR_SLOTS["diverging"]] == 0
    if setting == "step_size_jitter":
        eps = tb2.scalars[..., SCALAR_SLOTS["step_size"]]
        assert bool((eps.std(dim=1) > 0).all())
    elif setting == "mindepth":
        assert bool((depth[kept] >= 3).all())
    elif setting == "no_turning_check":
        assert bool((depth[kept] == 4).all())
