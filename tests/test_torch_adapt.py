"""The torch port's warmup adaptation against ``nutpie_tpu.sampler.adapt``.

Same inputs through both, batched over chains on the port side and vmapped
on the JAX side; every value to 1e-12 relative (the arithmetic is the same
expression by expression; sums over coordinates may round differently).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nutpie_tpu.sampler import adapt as ja
from nutpie_tpu.sampler.state import DualAvgState
from nutpie_tpu_torch.convert import adapt_from_arrays, adapt_to_arrays
from nutpie_tpu_torch.sampler import adapt as ta

torch.set_num_threads(1)

C, DIM, TUNE = 6, 11, 100


def _adapt_arrays(adapt) -> dict:
    out = {}
    for f in ("log_step", "log_step_bar", "hbar", "mu", "count"):
        out[f"adapt.da.{f}"] = np.asarray(getattr(adapt.da, f))
    for f in ("m", "v", "count"):
        out[f"adapt.adam.{f}"] = np.asarray(getattr(adapt.adam, f))
    out["adapt.inv_mass"] = np.asarray(adapt.inv_mass)
    for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
        for f in ("mean", "m2", "count"):
            out[f"adapt.{acc}.{f}"] = np.asarray(getattr(getattr(adapt, acc), f))
    return out


def _assert_arrays_close(got: dict, ref: dict, rtol=1e-12):
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=rtol, atol=1e-300,
                                   err_msg=name)


@pytest.fixture(scope="module")
def history():
    """A batch of JAX adaptation states after a few tuning draws."""
    cfg = ja.AdaptConfig(num_tune=TUNE)
    sched = ja.make_schedule(cfg, TUNE)
    rng = np.random.default_rng(0)
    grad0 = jnp.asarray(rng.standard_normal((C, DIM)) * 3.0)
    adapt = jax.vmap(lambda g: ja.diag_adapt_init(cfg, g, jnp.float64))(grad0)
    upd = jax.jit(jax.vmap(
        lambda a, d, x, g, acc, div: ja.diag_adapt_update(cfg, sched, a, d, x, g, acc, div),
        in_axes=(0, None, 0, 0, 0, 0),
    ))
    for d in range(7):
        x = jnp.asarray(rng.standard_normal((C, DIM)) * np.linspace(0.5, 3, DIM))
        g = jnp.asarray(rng.standard_normal((C, DIM)))
        acc = jnp.asarray(rng.uniform(0.3, 1.0, C))
        adapt = upd(adapt, d, x, g, acc, jnp.zeros(C, bool))
    return cfg, sched, adapt, rng


@pytest.mark.parametrize("draw_idx,method", [
    (7, "dual_average"),    # plain draw
    (9, "dual_average"),    # early-phase window switch: (9 + 1) % 10 == 0
    (95, "dual_average"),   # frozen mass matrix (>= freeze_start)
    (8, "adam"),
    (8, 0.25),              # fixed step size
])
def test_diag_adapt_update_matches_jax(history, draw_idx, method):
    cfg, sched, adapt, rng = history
    cfg = dataclasses.replace(cfg, method=method)
    x = rng.standard_normal((C, DIM)) * 2.0
    g = rng.standard_normal((C, DIM))
    g[3, 4] = np.nan                      # a nonfinite draw is skipped
    accept = rng.uniform(0.0, 1.0, C)
    diverging = np.zeros(C, bool)
    diverging[1] = True                   # a divergent draw is skipped
    ref = jax.vmap(
        lambda a, xx, gg, acc, div: ja.diag_adapt_update(cfg, sched, a, draw_idx, xx, gg, acc, div)
    )(adapt, jnp.asarray(x), jnp.asarray(g), jnp.asarray(accept), jnp.asarray(diverging))

    tcfg = ta.AdaptConfig(**dataclasses.asdict(cfg))
    tsched = ta.make_schedule(tcfg, TUNE)
    av, af = adapt_from_arrays(_adapt_arrays(adapt))
    nv, nf = ta.diag_adapt_update(
        tcfg, tsched, av, af, torch.full((C,), draw_idx, dtype=torch.int32),
        torch.as_tensor(x), torch.as_tensor(g), torch.as_tensor(accept),
        torch.as_tensor(diverging),
    )
    _assert_arrays_close(adapt_to_arrays(nv, nf), _adapt_arrays(ref))


def test_dual_avg_update_crashed_regime():
    cfg = ja.AdaptConfig(num_tune=TUNE)
    log_step = np.array([-9.0, -1.0, 0.5, -20.0])
    log_step_bar = np.array([-1.0, -1.2, 0.4, -2.0])   # rows 0 and 3 crashed
    da = DualAvgState(
        log_step=jnp.asarray(log_step), log_step_bar=jnp.asarray(log_step_bar),
        hbar=jnp.asarray([0.3, -0.1, 0.05, 0.6]), mu=jnp.asarray([0.0, -0.5, 1.0, -1.0]),
        count=jnp.asarray([3.0, 10.0, 1.0, 40.0]),
    )
    accept = jnp.asarray([0.1, 0.9, 0.8, 0.0])
    ref = jax.vmap(lambda d, a: ja.dual_avg_update(cfg, d, a))(da, accept)
    got = ta.dual_avg_update(
        ta.AdaptConfig(num_tune=TUNE),
        {"log_step": torch.as_tensor(log_step), "log_step_bar": torch.as_tensor(log_step_bar),
         "hbar": torch.tensor(np.array(da.hbar)), "mu": torch.tensor(np.array(da.mu)),
         "da_count": torch.tensor(np.array(da.count))},
        torch.tensor(np.array(accept)),
    )
    assert log_step[0] < log_step_bar[0] - math.log(8.0)
    for jname, tname in (("log_step", "log_step"), ("log_step_bar", "log_step_bar"),
                         ("hbar", "hbar"), ("mu", "mu"), ("count", "da_count")):
        np.testing.assert_allclose(got[tname].numpy(), np.asarray(getattr(ref, jname)),
                                   rtol=1e-12, err_msg=jname)


@pytest.mark.parametrize("pool_mass,pool_step", [(True, False), (False, True), (True, True)])
def test_pool_adapt_state_matches_jax(history, pool_mass, pool_step):
    _, _, adapt, _ = history
    ref = ja.pool_adapt_state(adapt, pool_mass=pool_mass, pool_step=pool_step)
    av, af = adapt_from_arrays(_adapt_arrays(adapt))
    nv, nf = ta.pool_adapt_state(av, af, pool_mass=pool_mass, pool_step=pool_step)
    _assert_arrays_close(adapt_to_arrays(nv, nf), _adapt_arrays(ref))


def test_schedule_and_init_match_jax():
    cfg = ja.AdaptConfig(num_tune=TUNE)
    js = ja.make_schedule(cfg, 300, 7)
    ts = ta.make_schedule(ta.AdaptConfig(num_tune=TUNE), 300, 7)
    assert (ts.num_tune, ts.early_end, ts.freeze_start, ts.depth_cap) == tuple(
        int(v) for v in js
    )
    g = np.array([[0.0, 1e-8, 2.0, -300.0]])
    ref = ja.diag_adapt_init(cfg, jnp.asarray(g[0]), jnp.float64)
    av, af = ta.diag_adapt_init(ta.AdaptConfig(num_tune=TUNE), torch.as_tensor(g), torch.float64)
    got = adapt_to_arrays(av, af)
    for name, value in _adapt_arrays(ref).items():
        np.testing.assert_allclose(got[name][0], value, rtol=1e-12, err_msg=name)
