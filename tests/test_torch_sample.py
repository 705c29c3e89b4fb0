"""End to end: ``nutpie_tpu_torch.sample(device="cpu")`` against
``nutpie_tpu.sample`` on radon, 8 chains x (64 tune + 64 draws).

Both runs use ``maxdepth=6`` (to bound the CPU time of the early-warmup
trees) and 16-draw chunks.  Checked: the initial states equal JAX's
``init_chains`` (ints exact, floats to 1e-12); the first chunk's step
counts are identical; the traces have the same groups, variables, shapes,
statistics and dtypes; and posterior means agree within 5 combined Monte
Carlo standard errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu
import nutpie_tpu_torch
from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
from nutpie_tpu.models import radon as jax_radon
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu_torch.convert import state_to_arrays
from nutpie_tpu_torch.diagnostics import ess
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.models import radon
from nutpie_tpu_torch.sampler import AdaptConfig, NutsConfig
from nutpie_tpu_torch.sampler.run import init_chains
from torch_parity import assert_state_close, jax_state_arrays

torch.set_num_threads(1)

RUN = dict(chains=8, tune=64, draws=64, seed=11, chunk_size=16, maxdepth=6)
MONITORED = ("intercept", "county_sd", "floor_effect", "county_floor_sd", "sigma")


@pytest.fixture(scope="module")
def traces():
    port = nutpie_tpu_torch.sample(compile_model_def(radon()), device="cpu", **RUN)
    ref = nutpie_tpu.sample(jax_compile(jax_radon()), progress_bar=False, **RUN)
    return port, ref


def test_init_chains_match_jax():
    cfg = NutsConfig(maxdepth=6, adapt=AdaptConfig(num_tune=64))
    jcfg = JNutsConfig(maxdepth=6, adapt=JAdaptConfig(num_tune=64))
    model, jmodel = radon(), jax_radon()
    states, ok = init_chains(model, cfg, 11, 8, np.zeros(model.ndim), torch.float64)
    jstates, jok = jinit_chains(jmodel, jcfg, 11, 8, np.zeros(jmodel.ndim), jnp.float64)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert_state_close(state_to_arrays(states), jax_state_arrays(jstates), rtol=1e-12)


def _groups(trace):
    return set(trace.groups) if not hasattr(trace, "children") else set(trace.children)


def test_first_chunk_step_counts_match(traces):
    port, ref = traces
    np.testing.assert_array_equal(
        np.asarray(port.warmup_sample_stats["n_steps"].values)[:, :16],
        np.asarray(ref.warmup_sample_stats["n_steps"].values)[:, :16],
    )


def test_trace_layout_matches(traces):
    port, ref = traces
    assert _groups(port) == _groups(ref)
    for group in _groups(ref):
        p, r = port[group], ref[group]
        assert set(p.data_vars) == set(r.data_vars), group
        for name in r.data_vars:
            assert p[name].shape == r[name].shape, (group, name)
            assert p[name].dtype == r[name].dtype, (group, name)
            assert tuple(p[name].dims) == tuple(r[name].dims), (group, name)


def test_posterior_means_agree(traces):
    port, ref = traces
    for name in MONITORED + ("county_effect",):
        a = np.asarray(port.posterior[name].values)
        b = np.asarray(ref.posterior[name].values)
        if a.ndim == 3:
            a, b = a[..., ::6], b[..., ::6]
        assert np.isfinite(a).all()
        mcse2 = np.var(a, axis=(0, 1)) / ess(a) + np.var(b, axis=(0, 1)) / ess(b)
        gap = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
        assert np.all(gap <= 5.0 * np.sqrt(mcse2)), (name, gap, np.sqrt(mcse2))
