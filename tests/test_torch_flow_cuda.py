"""K2 and K3 under flow adaptation against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``; without them they skip.  Run
them on the card with ``python -m pytest --noconftest
tests/test_torch_flow_cuda.py`` (``chip_smoke.py``'s ``flow_parity`` phase
runs the same comparisons at full width).  The log density is the
pulled-back one of ``funnel(dim=16, scale=1.0)`` under seeded flows whose
couplings act, float64, 8 chains: K2 under the fixed metric on a fresh
8-draw warmup window (ints, step counts and Welford counts exact, floats
to 1e-3) and the 8-draw frozen chunk after it (ints exact, floats to rtol
1e-6 / atol 1e-8), without and with the orbit reservoir (its rows and
buffers held too), and with the orbit reservoir beside the divergence rows
of ``store_divergences`` (a ``max_energy_error`` of 0.5 forces divergent
draws; the divergence buffers held too, finite exactly where a draw
diverged); K3 under the fixed metric on a warmup chunk of
``std_normal(4, 1, 3)``, whose windows must not run.  Then ``sample()``
with flow adaptation on the card, NUTS and MCLMC, launches every step
through its kernel.
"""

import numpy as np
import pytest
import torch

from nutpie_tpu_torch.models import funnel, std_normal
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import DIV_BUFFERS, NutsConfig
from nutpie_tpu_torch.sampler.run import init_chains, make_chunk_runner
from nutpie_tpu_torch.sampler.state import FLOW_FIELDS
from nutpie_tpu_torch.sampler.step_kernel import step_kernel
from nutpie_tpu_torch.transforms.flow import FlowConfig

pytestmark = pytest.mark.cuda

FLOW = dict(num_layers=2, hidden=8, window=32, train_steps=5, num_diag_updates=1)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def perturbed_flows(states, seed: int = 3):
    """The state with each chain's flow moved to seeded parameters that act."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    for name, scale in (("flow_mu", 0.3), ("flow_log_sigma", 0.2), ("flow_w2", 0.15),
                        ("flow_b2", 0.05)):
        t = getattr(states, name)
        noise = torch.randn(t.shape, generator=gen, dtype=torch.float64)
        out[name] = (scale * noise).to(device=t.device, dtype=t.dtype)
    return states.replace(**out)


def _fleet(use_orbit: bool, n_chains: int = 8, dim: int = 16, **nuts):
    model = funnel(dim=dim - 1, scale=1.0)
    cfg = NutsConfig(maxdepth=6, flow=FlowConfig(use_orbit=use_orbit, **FLOW),
                     adapt=AdaptConfig(num_tune=100, update_mass_matrix=False), **nuts)
    states, ok = init_chains(model, cfg, 5, n_chains, np.zeros(model.ndim), torch.float64,
                             device="cuda")
    assert bool(ok.all())
    return model, cfg, make_schedule(cfg.adapt, 100), perturbed_flows(states)


def _both(model, cfg, sched, states, start, chunk, frozen):
    k = make_chunk_runner(model, cfg, chunk, torch.float64, adapt_frozen=frozen)(
        states, start, chunk, sched)
    p = make_chunk_runner(model, cfg, chunk, torch.float64, adapt_frozen=frozen, plain=True)(
        states, start, chunk, sched)
    torch.cuda.synchronize()
    return k, p


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=rtol, atol=atol,
                               err_msg=what)


def _div_rows_held(b_k, b_p, rtol, atol):
    """The divergence buffers against the plain version's, finite exactly
    where the kernel's draw diverged; the count of divergent draws."""
    written = ~torch.isnan(b_k.scalars[..., 0])
    for name in DIV_BUFFERS:
        _close(getattr(b_k, name), getattr(b_p, name), rtol, atol, name)
        finite = torch.isfinite(getattr(b_k, name)).all(-1)
        assert torch.equal(finite[written], b_k.diverging[written]), name
    return int(b_k.diverging.sum())


@pytest.mark.parametrize("use_orbit, nuts", [
    pytest.param(False, {}, id="False"), pytest.param(True, {}, id="True"),
    pytest.param(True, dict(store_divergences=True, max_energy_error=0.5),
                 id="True-divergences")])
def test_k2_fixed_metric_matches_plain(use_orbit, nuts):
    _needs_card()
    model, cfg, sched, states = _fleet(use_orbit, **nuts)
    before = step_kernel.launches
    (s_k, b_k), (s_p, b_p) = _both(model, cfg, sched, states, 0, 8, False)
    assert step_kernel.launches > before
    assert torch.equal(s_k.ints, s_p.ints)
    # the fixed metric: the inverse mass stays at ones, the Welford windows run on
    assert bool((s_k.inv_mass == 1.0).all())
    _close(s_k.adapt_flts, s_p.adapt_flts, 1e-3, 1e-3, "adapt_flts")
    _close(s_k.adapt_vecs, s_p.adapt_vecs, 1e-3, 1e-3, "adapt_vecs")
    _close(b_k.position, b_p.position, 1e-3, 1e-3, "warmup draws")
    if cfg.use_orbit:
        _close(b_k.orbit_position, b_p.orbit_position, 1e-3, 1e-3, "warmup orbit rows")
    divergent = _div_rows_held(b_k, b_p, 1e-3, 1e-3) if cfg.store_divergences else 0
    (f_k, fb_k), (f_p, fb_p) = _both(model, cfg, sched, s_k, 8, 8, True)
    assert torch.equal(f_k.ints, f_p.ints)
    names = ["position", "scalars", "gradient"]
    if use_orbit:
        names += ["orbit_position", "orbit_gradient"]
        _close(f_k.orbit, f_p.orbit, 1e-6, 1e-8, "orbit rows")
    for name in names:
        _close(getattr(fb_k, name), getattr(fb_p, name), 1e-6, 1e-8, name)
    _close(f_k.vecs, f_p.vecs, 1e-6, 1e-8, "vecs")
    if cfg.store_divergences:
        divergent += _div_rows_held(fb_k, fb_p, 1e-6, 1e-8)
        assert divergent > 0, "no draw diverged"
    for name in FLOW_FIELDS:  # a frozen chunk leaves the flows alone
        assert torch.equal(getattr(f_k, name), getattr(s_k, name)), name


def test_k3_fixed_metric_matches_plain():
    _needs_card()
    from nutpie_tpu_torch.sampler.mclmc import MclmcConfig, init_mclmc_chains
    from nutpie_tpu_torch.sampler.mclmc import make_mclmc_chunk_runner

    model = std_normal(4, mu=1.0, sigma=3.0)
    cfg = MclmcConfig(flow=FlowConfig(**FLOW),
                      adapt=AdaptConfig(num_tune=100, update_mass_matrix=False))
    sched = make_schedule(cfg.adapt, 100)
    states, ok = init_mclmc_chains(model, cfg, 9, 8, np.zeros(4), torch.float64, device="cuda")
    states = perturbed_flows(states)
    k = make_mclmc_chunk_runner(model, cfg, 16, torch.float64)(states, 0, 16, sched)
    p = make_mclmc_chunk_runner(model, cfg, 16, torch.float64, plain=True)(states, 0, 16, sched)
    torch.cuda.synchronize()
    (s_k, b_k), (s_p, b_p) = k, p
    assert torch.equal(s_k.ints, s_p.ints)
    # no window ran: the adaptation rows are the initial ones
    assert torch.equal(s_k.adapt_vecs, states.adapt_vecs)
    assert torch.equal(s_k.adapt_flts, states.adapt_flts)
    for name in ("position", "scalars", "gradient"):
        _close(getattr(b_k, name), getattr(b_p, name), 1e-6, 1e-8, name)


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_flow_sample_on_card(sampler):
    _needs_card()
    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel

    kernel = step_kernel if sampler == "nuts" else mclmc_kernel
    m = compile_model_def(std_normal(4, mu=1.0, sigma=3.0)).with_transform_adapt(**FLOW)
    before = kernel.launches
    trace = nt.sample(m, sampler=sampler, adaptation="flow", chains=16, tune=64, draws=64,
                      seed=3, progress_bar=False, chunk_size=16)
    assert kernel.launches > before
    x = np.asarray(trace.posterior["x"].values)
    assert x.shape == (16, 64, 4) and np.isfinite(x).all()
