"""The slice as a whole on the CPU, and the route.

- The route: radon goes to the chunk kernel K1, with Adam, a fixed step
  size or a target integration time too; eight schools, the GLM and a
  ``from_pyfunc`` model go to the step runner, with those options too.
- ``sample(device="cpu")`` on eight schools against ``nutpie_tpu.sample``
  (8 chains x (100 tune + 150 draws), maxdepth 6, 25-draw chunks): the
  first chunk's step counts equal, posterior means within 4 Monte Carlo
  standard errors.
"""

import numpy as np
import pytest
import torch

import nutpie_tpu
import nutpie_tpu.models as jm
import nutpie_tpu_torch
import nutpie_tpu_torch.models as tm
from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
from nutpie_tpu_torch.diagnostics import ess
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def, from_pyfunc
from nutpie_tpu_torch.sample import nuts_config_from_settings, route
from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
from nutpie_tpu_torch.sampler.step_kernel import step_kernel
from nutpie_tpu_torch.settings import NutsSettings

torch.set_num_threads(1)


# ------------------------------------------------------------- the route


def _normal_pyfunc():
    return from_pyfunc(3, lambda: (lambda x: -0.5 * torch.sum(x * x, dim=1)))


def _cfg(**settings):
    s = NutsSettings.Diag(0)
    s.update(settings)
    return nuts_config_from_settings(s)


def test_route_radon_to_chunk_kernel_others_to_step_kernel():
    cfg = _cfg()
    assert route(cfg, tm.radon()) == "megakernel"
    assert route(cfg, tm.eight_schools()) == "step"
    assert route(cfg, tm.logistic_glm(n_data=16, dim=4)) == "step"
    assert route(cfg, _normal_pyfunc()._make_model(0)) == "step"


@pytest.mark.parametrize("settings", [
    dict(step_size_adapt_method="adam"),
    dict(step_size_adapt_method=0.1),
    dict(target_integration_time=2.0),
])
def test_route_refuses_what_neither_kernel_runs(settings):
    """Once refused, these options now run in both kernels: radon keeps the
    chunk kernel and eight schools the step kernel."""
    cfg = _cfg(**settings)
    assert route(cfg, tm.radon()) == "megakernel"
    assert route(cfg, tm.eight_schools()) == "step"


def test_pyfunc_samples_through_step_runner_on_cpu():
    launches = (step_kernel.launches, chunk_kernel.launches)
    tr = nutpie_tpu_torch.sample(_normal_pyfunc(), chains=4, tune=20, draws=20, seed=5,
                                 device="cpu")
    assert (step_kernel.launches, chunk_kernel.launches) == launches
    x = np.asarray(tr.posterior["x"].values)
    assert x.shape == (4, 20, 3) and np.isfinite(x).all()


# ------------------------------------------------------- the slice as a whole

RUN = dict(chains=8, tune=100, draws=150, seed=11, chunk_size=25, maxdepth=6)


@pytest.fixture(scope="module")
def traces():
    port = nutpie_tpu_torch.sample(compile_model_def(tm.eight_schools()), device="cpu", **RUN)
    ref = nutpie_tpu.sample(jax_compile(jm.eight_schools()), progress_bar=False, **RUN)
    return port, ref


def test_sample_first_chunk_step_counts_match_jax(traces):
    port, ref = traces
    np.testing.assert_array_equal(
        np.asarray(port.warmup_sample_stats["n_steps"].values)[:, :RUN["chunk_size"]],
        np.asarray(ref.warmup_sample_stats["n_steps"].values)[:, :RUN["chunk_size"]],
    )


def test_sample_posterior_means_agree_with_jax(traces):
    port, ref = traces
    for name in ("mu", "tau", "theta"):
        a = np.asarray(port.posterior[name].values)
        b = np.asarray(ref.posterior[name].values)
        assert a.shape == b.shape and np.isfinite(a).all()
        mcse2 = np.var(a, axis=(0, 1)) / ess(a) + np.var(b, axis=(0, 1)) / ess(b)
        gap = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
        assert np.all(gap <= 4.0 * np.sqrt(mcse2)), (name, gap, np.sqrt(mcse2))
