"""The step runner (``sampler/run.py:make_chunk_runner``) against the JAX
package's ``run.make_chunk_runner``, on the CPU.

16 chains of ``eight_schools()`` and of ``ill_conditioned_gaussian(dim=40)``
(maxdepth 6) are initialized and warmed by JAX and carried over with
``nutpie_tpu_torch.convert``; both runners (JAX at ``unroll=1``) then run
the same chunk.  Bars as in ``test_torch_nuts.py``: a frozen 16-draw chunk
has ints exact and floats to rtol 1e-6 / atol 1e-8; a warmup chunk from
a fresh fleet has ints, step counts and Welford counts exact, positions
to 1e-3, and metric and step size to 1e-4 (adaptation feeds rounding
differences back through the step size every draw).  The port's
``unroll=4`` is bitwise equal to its ``unroll=1``, and the runner's loop
(the first half of a chunk's first step, then one log density and one
``advance`` per machine step) gives the bits of an explicit loop of the
machine step's halves, ``leapfrog_begin`` / logp / ``leapfrog_finish``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu.models as jm
import nutpie_tpu_torch.models as tm
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu_torch.convert import state_from_arrays, state_to_arrays
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import (
    SCALAR_SLOTS,
    NutsConfig,
    init_buffers,
    leapfrog_begin,
    leapfrog_finish,
    start_draw,
)
from nutpie_tpu_torch.sampler.run import draw_randoms, make_chunk_runner, rescue_trapped
from nutpie_tpu_torch.sampler.state import state_with
from nutpie_tpu_torch.sampler.step_kernel import step_kernel
from torch_parity import assert_state_close, jax_state_arrays

torch.set_num_threads(1)

CHAINS, TUNE, CHUNK, MAXDEPTH = 16, 64, 16, 6
MODELS = {
    "eight_schools": dict(),
    "ill_conditioned_gaussian": dict(dim=40),
}


def _copy(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


@pytest.fixture(scope="module", params=list(MODELS))
def fleet(request):
    name = request.param
    jmodel = getattr(jm, name)(**MODELS[name])
    jcfg = JNutsConfig(maxdepth=MAXDEPTH, adapt=JAdaptConfig(num_tune=TUNE))
    jsched = jmake_schedule(jcfg.adapt, TUNE)
    states, _ = jinit_chains(jmodel, jcfg, 3, CHAINS, np.zeros(jmodel.ndim), jnp.float64)
    fresh = _copy(states)
    warm = jmake_chunk_runner(jmodel, jcfg, CHUNK, jnp.float64)
    for start in range(0, TUNE, CHUNK):
        states, _ = warm(states, start, CHUNK, jsched)
    cfg = NutsConfig(maxdepth=MAXDEPTH, adapt=AdaptConfig(num_tune=TUNE))
    return dict(jmodel=jmodel, jcfg=jcfg, jsched=jsched, fresh=fresh, warm=_copy(states),
                model=getattr(tm, name)(**MODELS[name]), cfg=cfg,
                sched=make_schedule(cfg.adapt, TUNE))


def _port_run(fleet, state, start, adapt_frozen, unroll=1):
    run = make_chunk_runner(fleet["model"], fleet["cfg"], CHUNK, torch.float64,
                            adapt_frozen=adapt_frozen, unroll=unroll)
    return run(state_from_arrays(jax_state_arrays(state)), start, CHUNK, fleet["sched"])


def test_frozen_chunk_matches_jax(fleet):
    jrun = jmake_chunk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64,
                              adapt_frozen=True)
    js, jb = jrun(_copy(fleet["warm"]), TUNE, CHUNK, fleet["jsched"])
    launches = step_kernel.launches
    ts, tb = _port_run(fleet, fleet["warm"], TUNE, True)
    assert step_kernel.launches == launches  # CPU tensors run the plain version
    assert_state_close(state_to_arrays(ts), jax_state_arrays(js), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tb.scalars.numpy(), np.asarray(jb.scalars), rtol=1e-6, atol=1e-8)
    assert np.isfinite(tb.position.numpy()).all()


def test_warmup_chunk_matches_jax(fleet):
    jrun = jmake_chunk_runner(fleet["jmodel"], fleet["jcfg"], CHUNK, jnp.float64)
    js, jb = jrun(_copy(fleet["fresh"]), 0, CHUNK, fleet["jsched"])
    ts, tb = _port_run(fleet, fleet["fresh"], 0, False)
    got, ref = state_to_arrays(ts), jax_state_arrays(js)
    np.testing.assert_array_equal(got["ints"], ref["ints"])
    ns = SCALAR_SLOTS["n_steps"]
    np.testing.assert_array_equal(tb.scalars[..., ns].numpy(), np.asarray(jb.scalars)[..., ns])
    for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
        np.testing.assert_array_equal(got[f"adapt.{acc}.count"], ref[f"adapt.{acc}.count"])
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["adapt.inv_mass"], ref["adapt.inv_mass"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["adapt.da.log_step_bar"], ref["adapt.da.log_step_bar"],
                               rtol=1e-4, atol=1e-6)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.parametrize("start,frozen", [(0, False), (TUNE, True)])
def test_unroll_is_bitwise_neutral(fleet, start, frozen):
    """Stepping past the chunk's end is a no-op: unroll=4 gives unroll=1's bits."""
    state = fleet["fresh"] if start == 0 else fleet["warm"]
    s1, b1 = _port_run(fleet, state, start, frozen, unroll=1)
    s4, b4 = _port_run(fleet, state, start, frozen, unroll=4)
    for name, t in s1.tensors().items():
        assert torch.equal(_bits(t), _bits(s4.tensors()[name])), name
    for a, b in ((b1.position, b4.position), (b1.scalars, b4.scalars)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("start,frozen", [(0, False), (TUNE, True)])
def test_advance_loop_matches_begin_finish_loop(fleet, start, frozen):
    """The runner's begin-once / advance loop gives the bits of the explicit
    begin / logp / finish loop over the same chunk."""
    state = fleet["fresh"] if start == 0 else fleet["warm"]
    s_run, b_run = _port_run(fleet, state, start, frozen)
    cfg, sched, model = fleet["cfg"], fleet["sched"], fleet["model"]
    st = state_from_arrays(jax_state_arrays(state))
    n_chains, _, dim = st.vecs.shape
    mom, jit = draw_randoms(st.key, start, CHUNK, dim, torch.float64)
    bufs = init_buffers(CHUNK, dim, torch.float64, n_chains, cfg=cfg)
    st = start_draw(cfg, fleet["sched"], state_with(st, done=False), mom[:, 0], jit[:, 0])
    while not bool(st.done.all()):
        z_new, carry = leapfrog_begin(cfg, st)
        logp, grad = model.logp_and_grad(z_new)
        st, _ = leapfrog_finish(cfg, sched, mom, jit, start, CHUNK, st, z_new, carry,
                                logp, grad, bufs, frozen)
    if not frozen:
        st = rescue_trapped(st, start, CHUNK, sched)
    for name, t in st.tensors().items():
        assert torch.equal(_bits(t), _bits(s_run.tensors()[name])), name
    for a, b in ((bufs.position, b_run.position), (bufs.scalars, b_run.scalars)):
        assert torch.equal(_bits(a), _bits(b))
