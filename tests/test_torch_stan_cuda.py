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
floats to rtol 1e-6 / atol 1e-8.  The Lotka-Volterra case study takes
the eager route (its ODE solve reads the device to stop): its logp and
gradient equal the CPU's, and K2 around it is bitwise its plain version.
vmap's per-example fallback warning is an error here.
"""

import inspect

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


def test_lotka_volterra_on_the_eager_route():
    """The Lotka-Volterra case study (its ODE solve loops until the data
    say stop): logp and gradient on the card equal the CPU's (1e-12), and
    a frozen 1-draw chunk through K2 around the eagerly called log density
    (no graph replay) is bitwise its plain version."""
    from torch_stan_programs import LOTKA_VOLTERRA, LV_THETA, LV_Z_INIT, lotka_volterra_data

    model = nt.compile_stan_model(LOTKA_VOLTERRA).with_data(**lotka_volterra_data())._make_model(0)
    assert model.eager_logp
    center = np.log(np.array(LV_THETA + LV_Z_INIT + (0.25, 0.25)))
    x = center + np.random.default_rng(13).uniform(-0.25, 0.25, size=(8, model.ndim))
    lk, gk = model.logp_and_grad(torch.as_tensor(x, device="cuda"))
    lc, gc = model.logp_and_grad(torch.as_tensor(x))
    assert _rel(lk, lc) < 1e-12 and _rel(gk, gc) < 1e-12

    cfg = NutsConfig(adapt=AdaptConfig(num_tune=100), maxdepth=3)
    sched = make_schedule(cfg.adapt, 100, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, 13, 8, center, torch.float64, device="cuda",
                             step_search=False)
    assert bool(ok.all())
    replays, launches = step_kernel.replays, step_kernel.launches
    kernel = make_chunk_runner(model, cfg, 1, torch.float64, adapt_frozen=True)
    plain = make_chunk_runner(model, cfg, 1, torch.float64, adapt_frozen=True, plain=True)
    s_k, b_k = kernel(states, 0, 1, sched)
    torch.cuda.synchronize()
    assert step_kernel.replays == replays and step_kernel.launches > launches
    s_p, b_p = plain(states, 0, 1, sched)
    torch.cuda.synchronize()
    assert torch.equal(s_k.ints, s_p.ints)
    assert torch.equal(b_k.position, b_p.position)


def test_lotka_volterra_solver_graphs_are_kept():
    """The case study's Dormand-Prince graphs are kept across log density
    calls at the same shapes (one set per call site, role and shapes, with
    the model's data on the device): repeated calls, around one at another
    chain count, give the bits of the first, and the second set of shapes
    keeps graphs of its own."""
    from torch_stan_programs import LOTKA_VOLTERRA, LV_THETA, LV_Z_INIT, lotka_volterra_data

    model = nt.compile_stan_model(LOTKA_VOLTERRA).with_data(**lotka_volterra_data())._make_model(0)
    center = np.log(np.array(LV_THETA + LV_Z_INIT + (0.25, 0.25)))
    rng = np.random.default_rng(17)
    x = torch.as_tensor(center + rng.uniform(-0.25, 0.25, size=(8, model.ndim)), device="cuda")
    y = torch.as_tensor(center + rng.uniform(-0.25, 0.25, size=(5, model.ndim)), device="cuda")
    first = model.logp_and_grad(x)
    interp = inspect.getclosurevars(model.logp_fn).nonlocals["interp"]
    cache = interp.device_cache(x.device, torch.float64)
    kept = {k for k in cache if k[0] == "solver"}
    assert {k[2] for k in kept} == {"forward", "backward", "measurement"}
    for _ in range(2):
        again = model.logp_and_grad(x)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
        model.logp_and_grad(y)
    assert len({k for k in cache if k[0] == "solver"}) == 2 * len(kept)
