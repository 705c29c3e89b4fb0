"""The MCLMC kernel (K3) and K2's microcanonical instantiations against
their plain torch versions, on the card.

These tests need a CUDA device and ``nvcc``; without them they skip.  Run
them on the card with ``python -m pytest --noconftest
tests/test_torch_mclmc_cuda.py`` (``chip_smoke.py`` runs the same
comparisons at full size).  Both sides run the same torch log density;
K3 draws its refresh normals, the plain version takes them from
``draw_normals``.  K3 in float64: a logistic GLM of dim 16 at 4 and 37
chains under each trajectory kind and three steps a draw (the held form),
the GLM at dim 66 (the strided form), and the low-rank metric: the 40-d
Gaussian at rank 8 (staged by TMA), the 33-d at rank 5 (staged by loads),
the 1000-d at rank 32 (streamed) and the 1100-d at rank 8; the strided
form and the 33-d at rank 5 again with a forced divergence at
``max_energy_error`` 0.05 (the draw's end reads the normals it kept): a warmup chunk
from draw 0 across an early switch (ints and ``diverging`` exact, floats to rtol 1e-3), then a
frozen chunk (floats to rtol 1e-6 / atol 1e-8); the graph's replays give
the bits of the same launches made one by one.  K3 in float32 under the
low-rank metric (the 40-d at rank 8 staged by TMA, the 33-d at rank 5 by
loads): a frozen chunk after the kernel's own warmup at chip_smoke's
float32 bars, at least 99.9% of ``diverging`` flags equal and 99% of draws
within 1e-3 (relative to 1 + abs x).  K2 micro: the GLM and the low-rank
Gaussian through the step runner, ints exact, at the float64 bars.
"""

import numpy as np
import pytest
import torch

from nutpie_tpu_torch.models import ill_conditioned_gaussian, logistic_glm
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.mclmc import (
    MclmcChunkRunner,
    MclmcConfig,
    init_buffers,
    init_mclmc_chains,
    init_scratch,
    update_low_rank,
)
from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
from nutpie_tpu_torch.sampler.nuts import LowRankConfig, NutsConfig
from nutpie_tpu_torch.sampler.run import init_chains, make_chunk_runner

pytestmark = pytest.mark.cuda

TUNE, CHUNK = 16, 8
# (model, MclmcConfig fields, K3's form)
CASES = {
    "micro": ("glm", {}, "held"),
    "euclidean": ("glm", {"trajectory": "euclidean"}, "held"),
    "then_micro": ("glm", {"trajectory": "euclidean_then_microcanonical"}, "held"),
    "steps3": ("glm", {"steps_per_draw": 3}, "held"),
    "strided": ("glm66", {}, "strided"),
    # a forced divergence where rows are not held: the draw's end reads the
    # last step's normals kept in the work row
    "strided_divergence": ("glm66", {"max_energy_error": 0.05}, "strided"),
    "low_rank": ("gaussian40", {"low_rank": LowRankConfig(eigval_cutoff=1.5, max_rank=8)},
                 "staged"),
    "low_rank_loads": ("gaussian33", {"low_rank": LowRankConfig(eigval_cutoff=1.5,
                                                                max_rank=5)}, "staged"),
    "low_rank_divergence": ("gaussian33", {"low_rank": LowRankConfig(eigval_cutoff=1.5,
                                                                     max_rank=5),
                                           "max_energy_error": 0.05}, "staged"),
    "low_rank_streamed": ("gaussian1000", {"low_rank": LowRankConfig(eigval_cutoff=1.5,
                                                                     max_rank=32)}, "streamed"),
    "low_rank_dim1100": ("gaussian1100", {"low_rank": LowRankConfig(eigval_cutoff=1.5,
                                                                           max_rank=8)},
                                "staged"),
}
MODELS = {"glm": lambda: logistic_glm(n_data=256, dim=16),
          "glm66": lambda: logistic_glm(n_data=256, dim=66),
          "gaussian40": lambda: ill_conditioned_gaussian(dim=40),
          "gaussian33": lambda: ill_conditioned_gaussian(dim=33),
          "gaussian1000": lambda: ill_conditioned_gaussian(dim=1000),
          "gaussian1100": lambda: ill_conditioned_gaussian(dim=1100)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close(a, b, rtol, atol):
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol, equal_nan=True)


def _eager(model, cfg, sched, states, start):
    """The chunk through K3 with its launches made one by one."""
    st = states.clone()
    C, _, dim = st.vecs.shape
    dtype = st.vecs.dtype
    bufs = init_buffers(cfg, CHUNK, C, dim, dtype, "cuda")
    steps = mclmc_kernel.chunk(cfg, sched, start, CHUNK, st, bufs,
                               init_scratch(C, dim, dtype, "cuda"))
    z = steps.begin(st)
    for _ in range(CHUNK * cfg.steps_per_draw):
        _, g = model.logp_and_grad(z)
        z = steps.kick(st, z, g)
        logp, g = model.logp_and_grad(z)
        z = steps.settle(st, z, logp, g)
    return update_low_rank(cfg, st, bufs, start, CHUNK, sched), bufs


def _mclmc_both(model, cfg, sched, states, start, graph=False):
    dtype = states.vecs.dtype
    before = mclmc_kernel.launches
    if graph:
        k = MclmcChunkRunner(model, cfg, CHUNK, dtype)(states, start, CHUNK, sched)
    else:
        k = _eager(model, cfg, sched, states, start)
    assert mclmc_kernel.launches - before == 1 + 2 * cfg.steps_per_draw * CHUNK
    p = MclmcChunkRunner(model, cfg, CHUNK, dtype, plain=True)(states, start, CHUNK, sched)
    torch.cuda.synchronize()
    return k, p


def _check(k, p, rtol, atol):
    (sk, bk), (sp, bp) = k, p
    assert torch.equal(sk.ints, sp.ints)
    assert torch.equal(bk.diverging, bp.diverging)
    for a, b in ((bk.position, bp.position), (bk.scalars, bp.scalars), (sk.vecs, sp.vecs),
                 (sk.flts, sp.flts), (sk.adapt_vecs, sp.adapt_vecs)):
        _close(a, b, rtol, atol)


@pytest.mark.parametrize("n_chains", [4, 37])
@pytest.mark.parametrize("case", list(CASES))
def test_mclmc_kernel_matches_plain_version(case, n_chains):
    _need_card()
    name, fields, form = CASES[case]
    model = MODELS[name]()
    cfg = MclmcConfig(adapt=AdaptConfig(num_tune=TUNE, early_switch_freq=4), **fields)
    sched = make_schedule(cfg.adapt, TUNE)
    states, _ = init_mclmc_chains(model, cfg, 4, n_chains, np.zeros(model.ndim),
                                  torch.float64, device="cuda")
    rank = 0 if cfg.low_rank is None else cfg.low_rank.max_rank
    assert mclmc_kernel.plan(n_chains, model.ndim, rank, torch.float64, "cuda").form == form
    k, p = _mclmc_both(model, cfg, sched, states, 0)
    _check(k, p, 1e-3, 1e-3)
    sk, _ = k
    sk, _ = MclmcChunkRunner(model, cfg, CHUNK, torch.float64)(sk, CHUNK, CHUNK, sched)
    k, p = _mclmc_both(model, cfg, sched, sk, TUNE)
    _check(k, p, 1e-6, 1e-8)
    (gk, gbk), _ = _mclmc_both(model, cfg, sched, sk, TUNE, graph=True)
    assert torch.equal(gbk.position, k[1].position) and torch.equal(gk.vecs, k[0].vecs)


@pytest.mark.parametrize("name, rank", [("gaussian40", 8), ("gaussian33", 5)])
def test_mclmc_kernel_float32_low_rank(name, rank):
    _need_card()
    model = MODELS[name]()
    cfg = MclmcConfig(adapt=AdaptConfig(num_tune=TUNE, early_switch_freq=4),
                      low_rank=LowRankConfig(eigval_cutoff=1.5, max_rank=rank))
    sched = make_schedule(cfg.adapt, TUNE)
    assert mclmc_kernel.plan(37, model.ndim, rank, torch.float32, "cuda").form == "staged"
    states, _ = init_mclmc_chains(model, cfg, 4, 37, np.zeros(model.ndim), torch.float32,
                                  device="cuda")
    states, _ = MclmcChunkRunner(model, cfg, TUNE, torch.float32)(states, 0, TUNE, sched)
    (_, bk), (_, bp) = _mclmc_both(model, cfg, sched, states, TUNE)
    assert (bk.diverging == bp.diverging).double().mean() >= 0.999
    pk, pp = bk.position, bp.position
    assert ((pk - pp).abs() <= 1e-3 * (1.0 + pp.abs())).all(-1).double().mean() >= 0.99


@pytest.mark.parametrize("name", ["glm", "gaussian40"])
def test_micro_step_kernel_matches_plain_version(name):
    _need_card()
    model = MODELS[name]()
    low_rank = LowRankConfig(eigval_cutoff=1.5, max_rank=8) if name == "gaussian40" else None
    cfg = NutsConfig(maxdepth=6, kinetic="microcanonical", low_rank=low_rank,
                     adapt=AdaptConfig(num_tune=100))
    sched = make_schedule(cfg.adapt, 100)
    states, _ = init_chains(model, cfg, 4, 8, np.zeros(model.ndim), torch.float64,
                            device="cuda")

    def both(st, start, frozen):
        k = make_chunk_runner(model, cfg, CHUNK, torch.float64, adapt_frozen=frozen)(
            st, start, CHUNK, sched)
        p = make_chunk_runner(model, cfg, CHUNK, torch.float64, adapt_frozen=frozen,
                              plain=True)(st, start, CHUNK, sched)
        torch.cuda.synchronize()
        return k, p

    (sk, bk), (sp, bp) = both(states, 0, False)
    assert torch.equal(sk.ints, sp.ints)
    _close(bk.position, bp.position, 1e-3, 1e-3)
    (fk, fbk), (fp, fbp) = both(sk, CHUNK, True)
    assert torch.equal(fk.ints, fp.ints)
    for a, b in ((fbk.position, fbp.position), (fbk.scalars, fbp.scalars), (fk.vecs, fp.vecs),
                 (fk.flts, fp.flts)):
        _close(a, b, 1e-6, 1e-8)
