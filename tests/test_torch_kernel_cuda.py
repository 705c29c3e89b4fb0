"""The CUDA chunk kernel against its plain torch version, on the card.

These tests need a CUDA device and ``nvcc``; without them they skip.  Run
them on the card with ``python -m pytest tests/test_torch_kernel_cuda.py``
(``chip_smoke.py`` runs the same comparison at full size).  Integer
decisions must be exact; floats to rtol 1e-6 / atol 1e-8 on a frozen
chunk and 1e-3 on a warmup chunk, whose adaptation feeds rounding
differences back through the step size.  At 16 chains, each option and
setting with a branch of its own in the kernel: Adam, a fixed step size,
a target integration time with an extra doubling, step size jitter,
``mindepth`` 3, no U-turn check and the draw-based mass matrix estimate.
"""

import numpy as np
import pytest
import torch

from nutpie_tpu_torch.models import radon
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.megakernel import chunk_kernel, plain_chunk
from nutpie_tpu_torch.sampler.nuts import NutsConfig
from nutpie_tpu_torch.sampler.run import draw_randoms, init_chains

pytestmark = pytest.mark.cuda


# 37 chains divide neither a block's chains nor the card's resident slots,
# so the chain queue runs dry part-way through a block
@pytest.fixture(params=[4, 37])
def card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = radon()
    cfg = NutsConfig(maxdepth=8, adapt=AdaptConfig(num_tune=100))
    sched = make_schedule(cfg.adapt, 100)
    states, _ = init_chains(model, cfg, 4, request.param, np.zeros(model.ndim),
                            torch.float64, device="cuda")
    return model, cfg, sched, states


def _both(model, cfg, sched, states, start, frozen, chunk=8):
    mom, jit = draw_randoms(states.key, start, chunk, model.ndim, torch.float64)
    before = chunk_kernel.launches
    k = chunk_kernel(cfg, model, sched, start, chunk, states, mom, jit, frozen)
    assert chunk_kernel.launches == before + 1
    p = plain_chunk(cfg, model, sched, start, chunk, states.clone(), mom, jit, frozen)
    torch.cuda.synchronize()
    return k, p


def test_kernel_matches_plain_version(card):
    model, cfg, sched, states = card
    (sk, bk), (sp, bp) = _both(model, cfg, sched, states, 0, False)
    assert torch.equal(sk.ints, sp.ints)
    torch.testing.assert_close(bk.position, bp.position, rtol=1e-3, atol=1e-3, equal_nan=True)
    (fk, fbk), (fp, fbp) = _both(model, cfg, sched, sk, 8, True)
    assert torch.equal(fk.ints, fp.ints)
    for a, b in ((fbk.position, fbp.position), (fbk.scalars, fbp.scalars),
                 (fk.vecs, fp.vecs), (fk.flts, fp.flts)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, equal_nan=True)


# (NutsConfig fields, AdaptConfig fields) of each option or setting with a
# branch of its own in the kernel (tests/test_torch_nuts.py and
# tests/test_torch_step_settings.py hold the plain version to JAX)
OPTIONS = {
    "adam": ({}, {"method": "adam"}),
    "fixed_step": ({}, {"method": 0.05}),
    "target_time": ({"target_time": 0.3, "extra_doublings": 1}, {}),
    "step_size_jitter": ({}, {"step_size_jitter": 0.3}),
    "mindepth": ({"mindepth": 3}, {}),
    "no_turning_check": ({"check_turning": False, "maxdepth": 4}, {}),
    "draw_diag": ({}, {"use_grad_based_estimate": False}),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_options_match_plain_version(option):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nuts, adapt = OPTIONS[option]
    model = radon()
    cfg = NutsConfig(**{"maxdepth": 8, **nuts}, adapt=AdaptConfig(num_tune=100, **adapt))
    sched = make_schedule(cfg.adapt, 100)
    states, _ = init_chains(model, cfg, 4, 16, np.zeros(model.ndim), torch.float64,
                            device="cuda")
    (sk, bk), (sp, bp) = _both(model, cfg, sched, states, 0, False)
    assert torch.equal(sk.ints, sp.ints)
    torch.testing.assert_close(bk.position, bp.position, rtol=1e-3, atol=1e-3, equal_nan=True)
    torch.testing.assert_close(sk.adapt_flts, sp.adapt_flts, rtol=1e-3, atol=1e-3)
    (fk, fbk), (fp, fbp) = _both(model, cfg, sched, sk, 8, True)
    assert torch.equal(fk.ints, fp.ints)
    for a, b in ((fbk.position, fbp.position), (fbk.scalars, fbp.scalars),
                 (fk.vecs, fp.vecs), (fk.flts, fp.flts)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, equal_nan=True)
