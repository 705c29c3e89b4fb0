"""PyMC models on the card, through the PyTorch linker's stand-in.

These tests need a CUDA device and ``nvcc``; without them they skip.  Run
them on the card with ``python -m pytest --noconftest
tests/test_torch_pymc_cuda.py`` (``chip_smoke.py``'s ``pymc`` phase runs
radon at the main path's width).  ``tests/torch_fake_pymc.py`` stands in
for pymc and pytensor; its linker builds the graph's constants when it
lowers the graph, on the default device of the lowering.

- Radon written as a PyMC model (173 parameters, 919 observations), float64,
  37 chains: the lowered graph's constants sit on the card (a CPU constant
  would fail the first call), the log density and its gradient are
  captured in a CUDA graph whose replay gives the eager call's values,
  the card's values equal the CPU's (rtol 1e-12), and they equal
  ``nutpie_tpu_torch.models.radon()``'s up to a constant (1e-10 of the
  log density's size, the gradient to 1e-10 relative).
- The linear regression through K2 in the step runner, float64, 4 and 37
  chains: one frozen 2-draw chunk, its machine steps replayed from the
  runner's graphs with the lowered log density in them, against K2's plain
  version: ints exact, floats to rtol 1e-6 / atol 1e-8.
"""

import numpy as np
import pytest
import torch

import nutpie_tpu_torch as nt
import torch_fake_pymc
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import NutsConfig
from nutpie_tpu_torch.sampler.run import init_chains, make_chunk_runner
from nutpie_tpu_torch.sampler.step_kernel import step_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert torch_fake_pymc.install(monkeypatch)


def _rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


def test_radon_logp_on_the_card_is_captured_and_equals_radon():
    model = nt.compile_pymc_model(torch_fake_pymc.radon_model()[0])._make_model(0)
    assert model.ndim == 173
    x_host = np.random.default_rng(5).normal(size=(37, model.ndim)) * 0.3
    x = torch.as_tensor(x_host, device="cuda")
    lk, gk = model.logp_and_grad(x)  # lowers the graph for the card
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.logp_and_grad(x)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        lg, gg = model.logp_and_grad(x)
    graph.replay()
    torch.cuda.synchronize()
    assert _rel(lg, lk) < 1e-12 and _rel(gg, gk) < 1e-12
    lc, gc = model.logp_and_grad(torch.as_tensor(x_host))
    assert _rel(lk, lc) < 1e-12 and _rel(gk, gc) < 1e-12
    lr, gr = nt.models.radon().logp_and_grad(x)
    offset = (lk - lr).cpu()
    assert float(offset.max() - offset.min()) < 1e-10 * float(lr.abs().max())
    assert _rel(gk, gr) < 1e-10


@pytest.mark.parametrize("n_chains", [4, 37])
def test_linear_regression_through_k2_in_graphs(n_chains):
    model = nt.compile_pymc_model(torch_fake_pymc.linear_regression_model()[0])._make_model(0)
    cfg = NutsConfig(adapt=AdaptConfig(num_tune=100))
    sched = make_schedule(cfg.adapt, 100, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, 3, n_chains, np.zeros(model.ndim), torch.float64,
                             device="cuda")
    assert bool(ok.all())
    replays = step_kernel.replays
    s_k, b_k = make_chunk_runner(model, cfg, 2, torch.float64, adapt_frozen=True)(
        states, 0, 2, sched)
    torch.cuda.synchronize()
    assert step_kernel.replays > replays, "no graph replay"
    s_p, b_p = make_chunk_runner(model, cfg, 2, torch.float64, adapt_frozen=True,
                                 plain=True)(states, 0, 2, sched)
    torch.cuda.synchronize()
    assert torch.equal(s_k.ints, s_p.ints)
    torch.testing.assert_close(b_k.position, b_p.position, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(b_k.scalars, b_p.scalars, rtol=1e-6, atol=1e-8, equal_nan=True)
