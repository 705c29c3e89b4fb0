"""``sample(device="cpu")`` with the step-size, depth and storage options,
and ``CompiledModel.benchmark_logp``: the port's counterparts of
``tests/test_sample.py:test_target_integration_time`` and
``:test_store_options`` and of ``tests/test_api.py:test_benchmark_logp``.

- A fixed step of 0.25 and a target integration time of 2.0 (the ratio
  exactly 8) with the U-turn check off: every draw has depth 3, and 5 with
  two extra doublings; with the U-turn check on and a target of 50 the
  U-turn still ends trees earlier.
- The stored statistics, now with the four divergence rows and
  ``divergence_message``; on the centered eight schools the rows are
  finite exactly where a draw diverged and the message is set there.
- ``benchmark_logp`` returns the batches asked for and positive rates.
- The divergence rows under low-rank adaptation, where draws diverge.
"""

import numpy as np
import torch

import nutpie_tpu_torch
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.models import eight_schools, std_normal
from nutpie_tpu_torch.sample import DIVERGENCE_MESSAGE

torch.set_num_threads(1)

DIV_STATS = ("divergence_start", "divergence_end", "divergence_momentum",
             "divergence_start_gradient")


def _depth(**kwargs):
    trace = nutpie_tpu_torch.sample(
        compile_model_def(std_normal(2)), chains=2, draws=50, tune=50, seed=6, maxdepth=10,
        step_size_adapt_method="0.25", device="cpu", **kwargs)
    return np.asarray(trace.sample_stats["depth"].values)


def test_target_integration_time():
    depth = _depth(check_turning=False, target_integration_time=2.0)
    assert depth.max() == 3 and depth.min() == 3
    # extra_doublings extend past the time-determined depth
    assert _depth(check_turning=False, target_integration_time=2.0,
                  extra_doublings=2).max() == 5
    # the U-turn criterion still ends trees earlier when it is on
    assert _depth(target_integration_time=50.0).max() < 8


def test_store_options():
    trace = nutpie_tpu_torch.sample(
        compile_model_def(std_normal(2)), chains=2, draws=80, tune=80, seed=5,
        store_gradient=True, store_mass_matrix=True, store_divergences=True,
        store_unconstrained=True, store_transformed=True, device="cpu")
    stats = trace.sample_stats
    for name in ("gradient", "mass_matrix_inv", "mass_matrix_stds", *DIV_STATS,
                 "divergence_message", "unconstrained_draw"):
        assert name in stats, name
    # the transformed draws exist only under flow adaptation
    assert "transformed_position" not in stats
    grad = np.asarray(stats["gradient"].values)
    x = np.asarray(stats["unconstrained_draw"].values)
    np.testing.assert_allclose(grad, -x, rtol=1e-10)  # the std normal's gradient is -x


def test_divergence_rows_where_draws_diverge():
    raw = nutpie_tpu_torch.sample(
        compile_model_def(eight_schools(centered=True)), chains=4, tune=40, draws=40,
        seed=3, maxdepth=6, store_divergences=True, device="cpu", return_raw_trace=True)
    stats = raw["stats"]
    diverging = stats["diverging"]
    assert diverging.any()
    for name in DIV_STATS:
        assert stats[name].shape == diverging.shape + (10,)
        np.testing.assert_array_equal(np.isfinite(stats[name]).all(axis=-1), diverging)
        np.testing.assert_array_equal(np.isnan(stats[name]).all(axis=-1), ~diverging)
    message = stats["divergence_message"]
    assert message.dtype == object
    assert (message[diverging] == DIVERGENCE_MESSAGE).all() and (message[~diverging] == "").all()


def test_benchmark_logp():
    model = compile_model_def(std_normal(4))
    out = model.benchmark_logp(np.zeros(4), num_evals=3, cores=[1, 2], device="cpu")
    try:
        import pandas  # noqa: F401

        assert list(out["batch"]) == [1, 2]
        assert (out["evals_per_sec"] > 0).all()
    except ImportError:
        assert out["batch"] == [1, 2]
        assert all(rate > 0 for rate in out["evals_per_sec"])


def test_low_rank_divergence_rows():
    """Under low-rank adaptation too, the rows are finite exactly where a
    draw diverged (here at an energy error above 10, so that some do)."""
    raw = nutpie_tpu_torch.sample(
        compile_model_def(eight_schools(centered=True)), adaptation="low_rank",
        store_divergences=True, max_energy_error=10.0, chains=2, tune=40, draws=20,
        seed=3, maxdepth=6, device="cpu", return_raw_trace=True)
    stats = raw["stats"]
    assert stats["diverging"].any()
    for name in DIV_STATS:
        np.testing.assert_array_equal(np.isfinite(stats[name]).all(axis=-1),
                                      stats["diverging"])
