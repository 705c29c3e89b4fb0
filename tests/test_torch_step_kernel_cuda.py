"""The CUDA step kernel (K2) against its plain torch version, on the card.

These tests need a CUDA device and ``nvcc``; without them they skip.  Run
them on the card with ``python -m pytest tests/test_torch_step_kernel_cuda.py``
(``chip_smoke.py`` runs the same comparison at full size).  Both run the
same torch log density; in float64 the integer decisions must be exact,
positions to rtol 1e-3 on a warmup chunk (adaptation feeds rounding
differences back through the step size) and floats to rtol 1e-6 / atol
1e-8 on the frozen chunk that follows.  Models, for each diagonal form of
``step_kernel.diag_plan``: logistic GLMs of dim 16 and 64 (the held form:
16 lanes a chain, double2 chunks, one and two a lane), the 1000-d and the
33-d Gaussian (the strided form: 32 lanes), at 4 and 37 chains (37 leaves
part of the last block's groups without a chain).  Eight schools, 16 chains, runs each of
four settings with their own branches (step size jitter, ``mindepth``,
no U-turn check, the draw-based mass matrix estimate).  The runner's
CUDA-graph replays give the bits of the same launches made eagerly.  The
low-rank branch: the 40-d Gaussian with a metric of rank 8 whose last
three slots are padded, at 4 and 37 chains, with the stored gradients,
inverse masses and eigenvalues held too; then, at 16 chains, a shape for
each form of ``step_kernel.low_rank_plan`` on an H100: dim 1000 at rank 32
(256,000 bytes a basis in float64: streamed through a ring), dim 500 at
rank 32 (staged by TMA) and dim 33 at rank 5 with two slots padded (660
bytes a basis, not 16-byte aligned: staged by loads).  The options with
branches of their own: Adam, a fixed step size and a target integration
time on the dim-16 GLM, Adam under the low-rank metric on the 40-d
Gaussian, and the divergence rows (the instantiations that carry them) on
the centered eight schools (held form and the low-rank branch) and the
33-d Gaussian (strided), their buffers held too.
"""

import numpy as np
import pytest
import torch

from nutpie_tpu_torch.models import eight_schools, ill_conditioned_gaussian, logistic_glm
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import (
    LowRankConfig,
    NutsConfig,
    init_buffers,
    start_draw,
)
from nutpie_tpu_torch.sampler.run import (
    CUDA_UNROLL,
    draw_randoms,
    init_chains,
    make_chunk_runner,
)
from nutpie_tpu_torch.sampler.state import state_with
from nutpie_tpu_torch.sampler.step_kernel import step_kernel

pytestmark = pytest.mark.cuda

MODELS = {
    "glm": lambda: logistic_glm(n_data=256, dim=16),
    "glm64": lambda: logistic_glm(n_data=256, dim=64),
    "gaussian1000": lambda: ill_conditioned_gaussian(dim=1000),
    "gaussian33": lambda: ill_conditioned_gaussian(dim=33),
}


@pytest.fixture(params=[(m, c) for m in MODELS for c in (4, 37)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    name, n_chains = request.param
    model = MODELS[name]()
    cfg = NutsConfig(maxdepth=8, adapt=AdaptConfig(num_tune=100))
    sched = make_schedule(cfg.adapt, 100)
    states, _ = init_chains(model, cfg, 4, n_chains, np.zeros(model.ndim),
                            torch.float64, device="cuda")
    return model, cfg, sched, states


def _both(model, cfg, sched, states, start, frozen, chunk=8):
    before = step_kernel.launches
    k = make_chunk_runner(model, cfg, chunk, torch.float64, adapt_frozen=frozen)(
        states, start, chunk, sched)
    launches = step_kernel.launches - before
    # one begin, then replays of CUDA_UNROLL advance launches each
    assert launches > 1 and (launches - 1) % CUDA_UNROLL == 0
    p = make_chunk_runner(model, cfg, chunk, torch.float64, adapt_frozen=frozen,
                          plain=True)(states, start, chunk, sched)
    torch.cuda.synchronize()
    return k, p


def test_step_kernel_matches_plain_version(card):
    model, cfg, sched, states = card
    (sk, bk), (sp, bp) = _both(model, cfg, sched, states, 0, False)
    assert torch.equal(sk.ints, sp.ints)
    torch.testing.assert_close(bk.position, bp.position, rtol=1e-3, atol=1e-3, equal_nan=True)
    (fk, fbk), (fp, fbp) = _both(model, cfg, sched, sk, 8, True)
    assert torch.equal(fk.ints, fp.ints)
    for a, b in ((fbk.position, fbp.position), (fbk.scalars, fbp.scalars),
                 (fk.vecs, fp.vecs), (fk.flts, fp.flts)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, equal_nan=True)


def test_done_chains_hand_their_committed_position(card):
    """Once every chain is done, a step hands the logp each chain's
    committed position and changes nothing."""
    model, cfg, sched, states = card
    (sk, _), _ = _both(model, cfg, sched, states, 0, True)
    assert bool(sk.done.all())
    mom, jit = draw_randoms(sk.key, 8, 8, model.ndim, torch.float64)
    bufs = init_buffers(8, model.ndim, torch.float64, sk.vecs.shape[0], device="cuda")
    state = sk.clone()
    steps = step_kernel.chunk(cfg, sched, 8, 8, state, mom, jit, bufs, True)
    z_new, carry = steps.begin(state)
    assert torch.equal(z_new, sk.position)
    logp, grad = model.logp_and_grad(z_new)
    steps.advance(state, z_new, carry, logp, grad)
    torch.cuda.synchronize()
    for name, t in sk.tensors().items():
        assert torch.equal(t, state.tensors()[name]), name
    assert bool(torch.isnan(bufs.position).all())


def _eager(model, cfg, sched, states, start, frozen, chunk=8):
    """The runner's chunk with its launches made one by one, no graph."""
    n_chains, _, dim = states.vecs.shape
    mom, jit = draw_randoms(states.key, start, chunk, dim, torch.float64)
    bufs = init_buffers(chunk, dim, torch.float64, n_chains, device="cuda", cfg=cfg)
    st = start_draw(cfg, sched, state_with(states, done=False), mom[:, 0], jit[:, 0]).clone()
    steps = step_kernel.chunk(cfg, sched, start, chunk, st, mom, jit, bufs, frozen)
    z_new, carry = steps.begin(st)
    while not bool(st.done.all()):
        logp, grad = model.logp_and_grad(z_new)
        st, z_new, carry = steps.advance(st, z_new, carry, logp, grad)
    return st, bufs


def test_graph_replay_is_eager_launch(card):
    """A frozen chunk replayed from CUDA graphs has the bits of the same
    chunk launched eagerly."""
    model, cfg, sched, states = card
    (sk, _), _ = _both(model, cfg, sched, states, 0, False)
    replays = step_kernel.replays
    gk, gb = make_chunk_runner(model, cfg, 8, torch.float64, adapt_frozen=True)(
        sk, 8, 8, sched)
    assert step_kernel.replays > replays
    ek, eb = _eager(model, cfg, sched, sk, 8, True)
    torch.cuda.synchronize()
    for name, t in gk.tensors().items():
        assert torch.equal(t.view(torch.int64) if t.is_floating_point() else t,
                           ek.tensors()[name].view(torch.int64)
                           if t.is_floating_point() else ek.tensors()[name]), name
    assert torch.equal(gb.position.view(torch.int64), eb.position.view(torch.int64))


# (NutsConfig fields, AdaptConfig fields) of each setting with a branch of
# its own (tests/test_torch_step_settings.py holds the plain version to JAX)
SETTINGS = {
    "step_size_jitter": ({}, {"step_size_jitter": 0.3}),
    "mindepth": ({"mindepth": 3}, {}),
    "no_turning_check": ({"check_turning": False, "maxdepth": 4}, {}),
    "draw_diag": ({}, {"use_grad_based_estimate": False}),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_settings_match_plain_version(setting):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nuts, adapt = SETTINGS[setting]
    model = eight_schools()
    cfg = NutsConfig(**{"maxdepth": 6, **nuts}, adapt=AdaptConfig(num_tune=100, **adapt))
    sched = make_schedule(cfg.adapt, 100)
    states, _ = init_chains(model, cfg, 6, 16, np.zeros(model.ndim), torch.float64,
                            device="cuda")
    (sk, bk), (sp, bp) = _both(model, cfg, sched, states, 0, False)
    assert torch.equal(sk.ints, sp.ints)
    torch.testing.assert_close(bk.position, bp.position, rtol=1e-3, atol=1e-3, equal_nan=True)
    (fk, fbk), (fp, fbp) = _both(model, cfg, sched, sk, 8, True)
    assert torch.equal(fk.ints, fp.ints)
    for a, b in ((fbk.position, fbp.position), (fbk.scalars, fbp.scalars),
                 (fk.vecs, fp.vecs), (fk.flts, fp.flts)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, equal_nan=True)


# (chains, dim, rank, padded slots) and the plan's form on an H100
LR_CASES = {
    "lowrank-4": (4, 40, 8, 3),                     # staged, TMA
    "lowrank-37": (37, 40, 8, 3),
    "lowrank-streamed-1000x32": (16, 1000, 32, 0),  # streamed, TMA
    "lowrank-staged-500x32": (16, 500, 32, 0),      # staged, TMA
    "lowrank-unaligned-33x5": (16, 33, 5, 2),       # staged, loads
}


@pytest.fixture(params=list(LR_CASES.values()), ids=list(LR_CASES))
def lr_card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_chains, dim, rank, padded = request.param
    model = ill_conditioned_gaussian(dim=dim)
    cfg = NutsConfig(maxdepth=8, low_rank=LowRankConfig(max_rank=rank),
                     store_mass_matrix=True, adapt=AdaptConfig(num_tune=100))
    sched = make_schedule(cfg.adapt, 100)
    states, _ = init_chains(model, cfg, 5, n_chains, np.zeros(dim), torch.float64,
                            device="cuda")
    rng = np.random.default_rng(n_chains)
    basis = np.zeros((n_chains, dim, rank))
    log_eigs = np.zeros((n_chains, rank))
    for c in range(n_chains):
        basis[c, :, :rank - padded], _ = np.linalg.qr(rng.standard_normal((dim, rank - padded)))
        log_eigs[c, :rank - padded] = 2.0 * rng.standard_normal(rank - padded)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cuda")
    return model, cfg, sched, states.replace(lr_basis=t(basis), lr_log_eigs=t(log_eigs))


def test_low_rank_branch_matches_plain_version(lr_card):
    model, cfg, sched, states = lr_card
    (sk, bk), (sp, bp) = _both(model, cfg, sched, states, 0, False)
    assert torch.equal(sk.ints, sp.ints)
    torch.testing.assert_close(bk.position, bp.position, rtol=1e-3, atol=1e-3, equal_nan=True)
    (fk, fbk), (fp, fbp) = _both(model, cfg, sched, sk, 8, True)
    assert torch.equal(fk.ints, fp.ints)
    for a, b in ((fbk.position, fbp.position), (fbk.scalars, fbp.scalars),
                 (fbk.gradient, fbp.gradient), (fbk.mass_matrix_inv, fbp.mass_matrix_inv),
                 (fbk.mass_matrix_eigvals, fbp.mass_matrix_eigvals),
                 (fk.vecs, fp.vecs), (fk.flts, fp.flts)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, equal_nan=True)
    assert torch.isfinite(fbk.mass_matrix_eigvals).all()


# (model, NutsConfig fields, AdaptConfig fields, low rank) of each option
# (tests/test_torch_step_options.py holds the plain version to JAX); the
# divergence rows' cases diverge at an energy error of 10 or 1
OPTIONS = {
    "adam": ("glm", {}, {"method": "adam"}, False),
    "fixed_step": ("glm", {}, {"method": 0.1}, False),
    "target_time": ("glm", {"target_time": 0.5, "extra_doublings": 1}, {}, False),
    "adam_low_rank": ("gaussian40", {}, {"method": "adam"}, True),
    "store_divergences_held": ("centered_eight_schools",
                               {"store_divergences": True, "max_energy_error": 10.0}, {},
                               False),
    "store_divergences_strided": ("gaussian33",
                                  {"store_divergences": True, "max_energy_error": 1.0}, {},
                                  False),
    "store_divergences_low_rank": ("centered_eight_schools",
                                   {"store_divergences": True, "max_energy_error": 10.0}, {},
                                   True),
}
OPTION_MODELS = {
    "glm": MODELS["glm"],
    "gaussian40": lambda: ill_conditioned_gaussian(dim=40),
    "centered_eight_schools": lambda: eight_schools(centered=True),
    "gaussian33": MODELS["gaussian33"],
}
DIV_BUFFERS = ("divergence_start", "divergence_end", "divergence_momentum",
               "divergence_start_gradient")


@pytest.mark.parametrize("option", list(OPTIONS))
def test_options_match_plain_version(option):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    name, nuts, adapt, low_rank = OPTIONS[option]
    model = OPTION_MODELS[name]()
    cfg = NutsConfig(**{"maxdepth": 8, **nuts}, adapt=AdaptConfig(num_tune=100, **adapt),
                     low_rank=LowRankConfig() if low_rank else None)
    sched = make_schedule(cfg.adapt, 100)
    states, _ = init_chains(model, cfg, 6, 16, np.zeros(model.ndim), torch.float64,
                            device="cuda")
    div = DIV_BUFFERS if cfg.store_divergences else ()
    (sk, bk), (sp, bp) = _both(model, cfg, sched, states, 0, False)
    assert torch.equal(sk.ints, sp.ints)
    torch.testing.assert_close(bk.position, bp.position, rtol=1e-3, atol=1e-3, equal_nan=True)
    (fk, fbk), (fp, fbp) = _both(model, cfg, sched, sk, 8, True)
    assert torch.equal(fk.ints, fp.ints)
    for a, b in ((fbk.position, fbp.position), (fbk.scalars, fbp.scalars),
                 (fk.vecs, fp.vecs), (fk.flts, fp.flts),
                 *((getattr(fbk, n), getattr(fbp, n)) for n in div)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, equal_nan=True)
    for bufs in (bk, fbk):
        diverging = bufs.diverging
        for n in div:
            assert torch.equal(torch.isfinite(getattr(bufs, n)).all(dim=-1), diverging), n
