"""The eager routes of K3 and of K2 under flow adaptation, on the card.

These tests need a CUDA device and ``nvcc``; without them they skip.  Run
them on the card with ``python -m pytest --noconftest
tests/test_torch_stan_eager_cuda.py`` (``chip_smoke.py``'s
``stan_ode_mclmc`` and ``stan_ode_flow`` phases run the same checks at the
runs' shapes).

- K3's eager loop (``kick`` and ``settle`` launched one draw after another,
  the log density called between them) against the runner's graph replay,
  on a model that is not marked ``eager_logp`` (a logistic GLM of dim 16,
  37 chains, float64 and float32; the eager branch forced by marking a copy
  of the model): a warmup chunk from draw 0 and a frozen chunk, bitwise.
  K3 draws its refresh normals from the state's draw counter on the
  device either way.
- The Lotka-Volterra case study (its ODE solve reads the device to stop),
  4 chains, float64: one MCLMC draw through K3 on the eager route against
  K3's plain version (ints and ``diverging`` exact, floats to rtol 1e-6 /
  atol 1e-8), no graph replay; one NUTS draw under seeded flows through K2
  on the eager route against K2's plain version (ints exact, floats to the
  same bars), no graph replay.

vmap's per-example fallback warning is an error here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nutpie_tpu_torch as nt
from nutpie_tpu_torch.models import logistic_glm
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.mclmc import MclmcChunkRunner, MclmcConfig, init_mclmc_chains
from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
from nutpie_tpu_torch.sampler.nuts import NutsConfig
from nutpie_tpu_torch.sampler.run import init_chains, make_chunk_runner
from nutpie_tpu_torch.sampler.step_kernel import step_kernel
from nutpie_tpu_torch.transforms.flow import FlowConfig
from torch_stan_programs import LOTKA_VOLTERRA_NEW, LV_THETA, LV_Z_INIT, lotka_volterra_data

pytestmark = [pytest.mark.cuda,
              pytest.mark.filterwarnings("error:There is a performance drop")]

TUNE, CHUNK = 16, 4


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k3_eager_loop_is_bitwise_its_graph_replay(dtype):
    model = logistic_glm(n_data=256, dim=16)
    eager = dataclasses.replace(model, eager_logp=True)
    cfg = MclmcConfig(adapt=AdaptConfig(num_tune=TUNE))
    sched = make_schedule(cfg.adapt, TUNE)
    states, ok = init_mclmc_chains(model, cfg, 5, 37, np.zeros(model.ndim), dtype,
                                   device="cuda")
    assert bool(ok.all())
    for start in (0, TUNE):  # a warmup chunk, then a frozen one
        replays, launches = mclmc_kernel.replays, mclmc_kernel.launches
        s_g, b_g = MclmcChunkRunner(model, cfg, CHUNK, dtype)(states, start, CHUNK, sched)
        torch.cuda.synchronize()
        assert mclmc_kernel.replays - replays == CHUNK
        replays = mclmc_kernel.replays
        s_e, b_e = MclmcChunkRunner(eager, cfg, CHUNK, dtype)(states, start, CHUNK, sched)
        torch.cuda.synchronize()
        assert mclmc_kernel.replays == replays, "the eager route replayed a graph"
        assert mclmc_kernel.launches - launches == 2 * (1 + 2 * cfg.steps_per_draw * CHUNK)
        for name in ("position", "scalars", "diverging"):
            assert _same(getattr(b_e, name), getattr(b_g, name)), (start, name)
        for name, t in s_g.tensors().items():
            assert _same(s_e.tensors()[name], t), (start, name)
        states = s_g


@pytest.fixture(scope="module")
def lv():
    model = nt.compile_stan_model(LOTKA_VOLTERRA_NEW).with_data(
        **lotka_volterra_data())._make_model(0)
    assert model.eager_logp
    return model, np.log(np.array(LV_THETA + LV_Z_INIT + (0.25, 0.25)))


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, equal_nan=True)


def test_lotka_volterra_through_k3_on_the_eager_route(lv):
    model, center = lv
    cfg = MclmcConfig(adapt=AdaptConfig(num_tune=TUNE))
    sched = make_schedule(cfg.adapt, TUNE)
    states, ok = init_mclmc_chains(model, cfg, 7, 4, center, torch.float64, device="cuda",
                                   step_search=False)
    assert bool(ok.all())
    # the draw counters at the end of tuning, where the frozen chunk starts:
    # K3 keys its refresh normals by the state's counter, the plain version
    # by the chunk's draws
    states = states.replace(ints=states.ints.clone().index_fill_(
        1, torch.tensor([0], device="cuda"), TUNE))
    replays, launches = mclmc_kernel.replays, mclmc_kernel.launches
    s_k, b_k = MclmcChunkRunner(model, cfg, 1, torch.float64)(states, TUNE, 1, sched)
    torch.cuda.synchronize()
    assert mclmc_kernel.replays == replays and mclmc_kernel.launches > launches
    s_p, b_p = MclmcChunkRunner(model, cfg, 1, torch.float64, plain=True)(states, TUNE, 1,
                                                                          sched)
    torch.cuda.synchronize()
    assert torch.equal(s_k.ints, s_p.ints) and torch.equal(b_k.diverging, b_p.diverging)
    for a, b in ((b_k.position, b_p.position), (b_k.scalars, b_p.scalars),
                 (s_k.vecs, s_p.vecs), (s_k.flts, s_p.flts)):
        _close(a, b)


def test_lotka_volterra_through_k2_under_flow_on_the_eager_route(lv):
    model, center = lv
    flow = FlowConfig(num_layers=2, hidden=8, window=2, train_steps=3, num_diag_updates=0)
    cfg = NutsConfig(maxdepth=2, flow=flow,
                     adapt=AdaptConfig(num_tune=TUNE, update_mass_matrix=False))
    sched = make_schedule(cfg.adapt, TUNE, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, 9, 4, center, torch.float64, device="cuda",
                             step_search=False)
    assert bool(ok.all())
    rng = np.random.default_rng(5)
    states = states.replace(flow_w2=torch.as_tensor(
        0.15 * rng.standard_normal(tuple(states.flow_w2.shape)), device="cuda"))
    replays, launches = step_kernel.replays, step_kernel.launches
    s_k, b_k = make_chunk_runner(model, cfg, 1, torch.float64, adapt_frozen=True)(
        states, 0, 1, sched)
    torch.cuda.synchronize()
    assert step_kernel.replays == replays and step_kernel.launches > launches
    s_p, b_p = make_chunk_runner(model, cfg, 1, torch.float64, adapt_frozen=True,
                                 plain=True)(states, 0, 1, sched)
    torch.cuda.synchronize()
    assert torch.equal(s_k.ints, s_p.ints)
    for a, b in ((b_k.position, b_p.position), (b_k.scalars, b_p.scalars),
                 (s_k.vecs, s_p.vecs)):
        _close(a, b)
