"""``sample(adaptation="flow")`` of the port, on the CPU in float64.

- The trace of ``tests/test_flow.py::test_flow_transformed_stats``' tiny
  configuration with ``store_transformed``, in both packages from one
  seed: the same statistics with the same shapes and dtypes, the first
  chunk's step counts exact and its draws, transformed rows and Fisher
  distances to rtol 1e-8 (no flow has trained before its end); the
  moments of that test.
- ``use_orbit`` (``train_on_orbit``) stores the orbit rows as statistics,
  as the JAX trace does.
- A flow run checkpointed in warmup (paused after its first chunks) and
  resumed reproduces the uninterrupted run bitwise, NUTS and MCLMC: the
  flows, their windows and update counts ride in the checkpoint.
- The MCLMC flow moments of ``tests/test_mclmc.py::test_mclmc_flow``
  (its model, bars and seed; a smaller flow, trained every 200 draws, for
  the CPU's time).
"""

import time

import numpy as np
import pytest
import torch

import nutpie_tpu
import nutpie_tpu.models as jm
import nutpie_tpu_torch
import nutpie_tpu_torch.models as tm
from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
from nutpie_tpu_torch.checkpoint import load_state
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.sample import _make_settings, config_from_settings
from nutpie_tpu_torch.sampler.mclmc import init_mclmc_chains
from nutpie_tpu_torch.sampler.run import init_chains

torch.set_num_threads(1)

DEADLINE_S = 120
TINY = dict(num_layers=2, hidden=8, train_steps=50, window=64)


def _sample(model, **kwargs):
    return nutpie_tpu_torch.sample(model, device="cpu", progress_bar=False, **kwargs)


def test_trace_layout_and_first_chunk_match_jax():
    common = dict(chains=2, draws=100, tune=200, seed=5, adaptation="flow",
                  store_transformed=True)
    ref = nutpie_tpu.sample(jax_compile(jm.std_normal(3)).with_transform_adapt(**TINY),
                            progress_bar=False, **common)
    got = _sample(compile_model_def(tm.std_normal(3)).with_transform_adapt(**TINY), **common)
    rs, gs = ref.sample_stats, got.sample_stats
    assert list(gs.data_vars) == list(rs.data_vars)
    for group in ("sample_stats", "warmup_sample_stats", "posterior", "warmup_posterior"):
        for name, arr in getattr(ref, group).data_vars.items():
            other = getattr(got, group)[name]
            assert other.shape == arr.shape and other.dtype == arr.dtype, (group, name)
    for name in ("transformed_position", "transformed_gradient", "transformation_mu"):
        assert name in gs, name
    L = 64  # the chunk: transform_update_freq
    ws, rws = got.warmup_sample_stats, ref.warmup_sample_stats
    np.testing.assert_array_equal(ws["n_steps"].values[:, :L], rws["n_steps"].values[:, :L])
    for name in ("transformed_position", "transformed_gradient", "fisher_distance", "logp"):
        np.testing.assert_allclose(ws[name].values[:, :L], rws[name].values[:, :L],
                                   rtol=1e-8, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(got.warmup_posterior["x"].values[:, :L],
                               ref.warmup_posterior["x"].values[:, :L], rtol=1e-8, atol=1e-10)
    x = np.asarray(got.posterior["x"].values)
    assert abs(x.mean()) < 0.25
    assert abs(x.std() - 1.0) < 0.25


def test_train_on_orbit_stores_orbit_rows():
    m = compile_model_def(tm.std_normal(2)).with_transform_adapt(
        num_layers=2, hidden=8, train_steps=5, window=32)
    trace = _sample(m, chains=2, tune=32, draws=16, seed=4, adaptation="flow",
                    train_on_orbit=True, chunk_size=16)
    stats = trace.sample_stats
    for name in ("orbit_position", "orbit_gradient", "fisher_distance"):
        assert name in stats, name
    assert stats["orbit_position"].shape == (2, 16, 2)
    assert np.isfinite(stats["orbit_position"].values).all()


def _warmup_checkpoint(model, tmp_path, **common):
    """A flow run paused after its first chunks, and the checkpoint it wrote
    at the start of its last chunk, in warmup."""
    ckpt = tmp_path / "flow.npz"
    handle = _sample(model, blocking=False, checkpoint=str(ckpt), **common)
    t0 = time.monotonic()
    while handle._draws_done < 32:
        assert time.monotonic() - t0 < DEADLINE_S, "timed out waiting for two chunks"
        time.sleep(0.01)
    handle.pause()
    assert handle.wait_paused(DEADLINE_S)
    handle.cancel()
    return ckpt


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_flow_checkpoint_resumes_bitwise(sampler, tmp_path):
    m = compile_model_def(tm.funnel(3, scale=1.0)).with_transform_adapt(
        num_layers=2, hidden=8, train_steps=5, window=32, num_diag_updates=1)
    common = dict(chains=2, tune=96, seed=8, adaptation="flow", chunk_size=16,
                  sampler=sampler)
    full = _sample(m, draws=16, return_raw_trace=True, **common)
    ckpt = _warmup_checkpoint(m, tmp_path, draws=16, **common)
    settings = _make_settings(sampler, "flow", 8)
    settings.update(dict(num_chains=2, num_tune=96, num_draws=16, chunk_size=16))
    cfg = config_from_settings(settings, m._transform_adapt_args, "cpu")
    init = init_mclmc_chains if sampler == "mclmc" else init_chains
    template, _ = init(m._make_model(8), cfg, 8, 2, np.zeros(4), torch.float64, device="cpu")
    state, start, _, _ = load_state(ckpt, template)
    assert 16 <= start < 96, start  # resumed in warmup
    assert state.flow_updates is not None and state.win_draws.shape == (2, 32, 4)
    resumed = _sample(m, draws=16, return_raw_trace=True, resume_from=str(ckpt), **common)
    np.testing.assert_array_equal(resumed["position"], full["position"][:, start:])
    for group in ("stats", "expanded"):
        assert resumed[group].keys() == full[group].keys()
        for name, ref in full[group].items():
            np.testing.assert_array_equal(resumed[group][name], ref[:, start:], err_msg=name)


def test_mclmc_flow_moments():
    model = compile_model_def(tm.std_normal(4, mu=1.0, sigma=3.0)).with_transform_adapt(
        num_layers=2, hidden=8, train_steps=50)
    trace = _sample(model, sampler="mclmc", adaptation="flow", chains=4, draws=2000,
                    tune=800, seed=17, transform_update_freq=200)
    x = np.asarray(trace.posterior["x"].values)
    assert abs(x.mean() - 1.0) < 0.3
    assert abs(x.std() - 3.0) < 0.5
