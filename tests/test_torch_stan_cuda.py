"""Stan programs on the card, float64: logp, gradient and a chunk through K2.

These tests need a CUDA device and ``nvcc``; without them they skip.  Run
them on the card with ``python -m pytest --noconftest
tests/test_torch_stan_cuda.py`` (``chip_smoke.py``'s ``stan_parity`` phase
runs the same checks at 64 chains).  Two programs: the Stan radon at the
main path's width (173 parameters, 919 observations) at 4 and 37 chains,
and a model whose loop over 64 observations holds a data ``if``
(censoring through ``normal_lccdf``; the loop unrolls, each branch chosen
on the host).  For each, the logp and gradient on the card equal the
CPU's to rounding (rtol 1e-12 / 1e-10), and one frozen chunk through K2,
its machine steps replayed from the runner's CUDA graphs with the Stan
log density captured in them, equals K2's plain version: ints exact,
floats to rtol 1e-6 / atol 1e-8.  vmap's per-example fallback warning is
an error here.
"""

import numpy as np
import pytest
import torch

import nutpie_tpu_torch as nt
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import NutsConfig
from nutpie_tpu_torch.sampler.run import init_chains, make_chunk_runner
from nutpie_tpu_torch.sampler.step_kernel import step_kernel
from torch_stan_programs import CENSORED, RADON_VECTOR, censored_data, radon_data

pytestmark = [pytest.mark.cuda,
              pytest.mark.filterwarnings("error:There is a performance drop")]

@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _radon():
    return nt.compile_stan_model(RADON_VECTOR).with_data(**radon_data())._make_model(0)


def _censored():
    return nt.compile_stan_model(CENSORED).with_data(**censored_data())._make_model(0)


def _rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


def _check(model, n_chains, seed):
    x = np.random.default_rng(seed).normal(size=(n_chains, model.ndim)) * 0.3
    lk, gk = model.logp_and_grad(torch.as_tensor(x, device="cuda"))
    lc, gc = model.logp_and_grad(torch.as_tensor(x))
    assert _rel(lk, lc) < 1e-12 and _rel(gk, gc) < 1e-10

    cfg = NutsConfig(adapt=AdaptConfig(num_tune=100))
    sched = make_schedule(cfg.adapt, 100, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, seed, n_chains, np.zeros(model.ndim),
                             torch.float64, device="cuda")
    assert bool(ok.all())
    replays = step_kernel.replays
    kernel = make_chunk_runner(model, cfg, 2, torch.float64, adapt_frozen=True)
    plain = make_chunk_runner(model, cfg, 2, torch.float64, adapt_frozen=True, plain=True)
    s_k, b_k = kernel(states, 0, 2, sched)
    torch.cuda.synchronize()
    assert step_kernel.replays > replays, "no graph replay"
    s_p, b_p = plain(states, 0, 2, sched)
    torch.cuda.synchronize()
    assert torch.equal(s_k.ints, s_p.ints)
    torch.testing.assert_close(b_k.position, b_p.position, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(b_k.scalars, b_p.scalars, rtol=1e-6, atol=1e-8,
                               equal_nan=True)


@pytest.mark.parametrize("n_chains", [4, 37])
def test_stan_radon_on_the_card(n_chains):
    _check(_radon(), n_chains, 11)


@pytest.mark.parametrize("n_chains", [4, 37])
def test_data_if_in_a_loop_on_the_card(n_chains):
    _check(_censored(), n_chains, 12)
