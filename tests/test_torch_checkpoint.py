"""Checkpoint and resume of the port, against uninterrupted runs and the
JAX package.

- A resumed run reproduces the uninterrupted run bitwise: eight schools,
  2 chains, resumed mid-run; and 64 chains on the funnel, where the
  fleet's tree-depth cap binds (below).
- A checkpoint of another model is refused with ``ValueError``.
- State parity: both packages run the same model, seed and settings with
  ``checkpoint=``; each reads its own file back, and the port's state
  matches the JAX package's (ints and key bits exact, floats to rtol 1e-6 /
  atol 1e-8).

CPU, float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu
import nutpie_tpu.models as jm
import nutpie_tpu_torch
import nutpie_tpu_torch.models as tm
from nutpie_tpu.checkpoint import load_state as jload_state
from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
from nutpie_tpu.sample import _make_settings as jmake_settings
from nutpie_tpu.sample import _nuts_config_from_settings as jnuts_config
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu_torch.checkpoint import load_state
from nutpie_tpu_torch.convert import state_to_arrays
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.sample import _make_settings, nuts_config_from_settings
from nutpie_tpu_torch.sampler.run import init_chains
from torch_parity import assert_state_close, jax_state_arrays

torch.set_num_threads(1)


def _raw(model, **kwargs):
    return nutpie_tpu_torch.sample(model, device="cpu", progress_bar=False,
                                   return_raw_trace=True, **kwargs)


def _assert_suffix(resumed: dict, full: dict, start: int) -> None:
    """Every array of ``resumed`` equals draws ``start:`` of ``full`` bitwise."""
    np.testing.assert_array_equal(resumed["position"], full["position"][:, start:])
    for group in ("stats", "expanded"):
        assert resumed[group].keys() == full[group].keys()
        for name, ref in full[group].items():
            np.testing.assert_array_equal(resumed[group][name], ref[:, start:],
                                          err_msg=name)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    model = compile_model_def(tm.eight_schools())
    # maxdepth 6 keeps the first warmup draws' trees short on the CPU
    common = dict(chains=2, tune=40, seed=11, chunk_size=16, maxdepth=6)
    full = nutpie_tpu_torch.sample(model, draws=40, device="cpu", progress_bar=False,
                                   **common)
    ckpt = tmp_path / "state.npz"
    # the first 48 of 80 draws (3 chunks of 16), checkpointed
    nutpie_tpu_torch.sample(model, draws=8, device="cpu", progress_bar=False,
                            checkpoint=str(ckpt), **common)
    assert ckpt.exists()
    resumed = nutpie_tpu_torch.sample(model, draws=40, device="cpu", progress_bar=False,
                                      resume_from=str(ckpt), **common)
    # the resumed trace holds draws 48..80, the last 32 posterior draws
    for name in ("mu", "tau", "theta"):
        np.testing.assert_array_equal(resumed.posterior[name].values,
                                      full.posterior[name].values[:, -32:])
    for name in ("n_steps", "step_size", "energy", "diverging"):
        np.testing.assert_array_equal(resumed.sample_stats[name].values,
                                      full.sample_stats[name].values[:, -32:])


def test_resume_keeps_the_fleet_depth_cap(tmp_path):
    """64 chains on the 10-d funnel, 24 tuning draws in chunks of 4, resumed
    at draw 28.  The fleet cap is measured on warmup chunks up to the
    freeze at draw 22 (``freeze_share``), here at depth 5, and many draws
    after the resume point stop there, below ``maxdepth`` 10.  The port's
    checkpoint carries the cap, so the resumed run is the uninterrupted
    run bitwise.  The JAX package's resume differs here: its checkpoint
    holds only the machine state, so its resumed run starts again from
    ``initial_depth_cap`` 8 and, past the freeze, never measures the cap
    again; its trees then grow deeper than the uninterrupted run's."""
    model = compile_model_def(tm.funnel())
    common = dict(chains=64, tune=24, seed=3, chunk_size=4)
    full = _raw(model, draws=8, **common)
    ckpt = tmp_path / "state.npz"
    _raw(model, draws=4, checkpoint=str(ckpt), **common)
    settings = _make_settings("nuts", "diag", 3)
    template, _ = init_chains(model._make_model(3), nuts_config_from_settings(settings), 3,
                              64, np.zeros(model.n_dim), torch.float64)
    _, done, cap, _ = load_state(ckpt, template)
    assert done == 28 and cap < settings.maxdepth
    depth = full["stats"]["depth"][:, 28:]
    assert int((depth == cap).sum()) > 0, "the cap binds no draw after the resume point"
    assert depth.max() == cap
    resumed = _raw(model, draws=8, resume_from=str(ckpt), **common)
    _assert_suffix(resumed, full, 28)


def test_resume_shape_mismatch_rejected(tmp_path):
    ckpt = tmp_path / "s.npz"
    _raw(compile_model_def(tm.std_normal(3)), chains=2, draws=10, tune=10, seed=1,
         checkpoint=str(ckpt))
    with pytest.raises(ValueError, match="shape"):
        _raw(compile_model_def(tm.eight_schools()), chains=2, draws=10, tune=10, seed=1,
             resume_from=str(ckpt))


def test_checkpoint_state_matches_jax(tmp_path):
    """Eight schools, 8 chains, maxdepth 6, 16 warmup and 16 posterior draws
    in 16-draw chunks, seed 21, each package's checkpoint read by its own
    ``load_state``."""
    seed, chains = 21, 8
    common = dict(chains=chains, tune=16, draws=16, seed=seed, chunk_size=16,
                  progress_bar=False, maxdepth=6)
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jmodel = jax_compile(jm.eight_schools())
    nutpie_tpu.sample(jmodel, checkpoint=str(jpath), **common)
    model = compile_model_def(tm.eight_schools())
    nutpie_tpu_torch.sample(model, device="cpu", checkpoint=str(tpath), **common)

    jsettings = jmake_settings("nuts", "diag", seed)
    jsettings.update(num_tune=16, num_draws=16, maxdepth=6)
    jtemplate, _ = jinit_chains(jmodel._make_model(seed), jnuts_config(jsettings), seed,
                                chains, np.zeros(10), jnp.float64)
    jstates, jdone, _ = jload_state(jpath, jtemplate)
    settings = _make_settings("nuts", "diag", seed)
    settings.update(num_tune=16, num_draws=16, maxdepth=6)
    template, _ = init_chains(model._make_model(seed), nuts_config_from_settings(settings),
                              seed, chains, np.zeros(10), torch.float64)
    states, done, _, meta = load_state(tpath, template)
    assert done == jdone == 32 and meta["seed"] == seed
    assert_state_close(state_to_arrays(states), jax_state_arrays(jstates),
                       rtol=1e-6, atol=1e-8)
