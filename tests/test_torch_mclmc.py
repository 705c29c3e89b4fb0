"""MCLMC (``sampler/mclmc.py``) and ``threefry.split`` against the JAX
package, on the CPU in float64.

- ``threefry.split`` equals ``jax.random.split`` bit for bit (the
  partitionable counter layout), also under MCLMC's per-draw fold-ins.
- ``apply_A`` / ``apply_At`` / ``update_velocity`` / ``partial_refresh``
  against ``nutpie_tpu/sampler/mclmc.py``'s to rtol 1e-12 (the diagonal
  and the low-rank metric).
- ``init_mclmc_chains`` against JAX's: keys and counters exact, floats to
  rtol 1e-12.
- The chunk runner (the plain pieces K3 runs) against JAX's
  ``make_mclmc_chunk_runner`` from one state carried by ``convert.py``: a
  warmup chunk from draw 0 across the early mass-matrix switch and a
  frozen chunk after tuning, for each trajectory kind, three steps a
  draw, the fixed step size, a forced divergence and low-rank adaptation
  with its boundary update.  Ints, keys and ``diverging`` exact; floats to
  rtol 1e-10 / atol 1e-12: the two packages sum in different orders, and
  over 16 draws of the adaptation the largest difference measured was
  below 1e-12 relative.  The low-rank metric after the boundary update is
  compared through its implied matrix (eigenvectors are defined up to
  sign) to rtol 1e-6 / atol 1e-8: the estimator's eigendecompositions
  (LAPACK here, XLA's there) turn the draws' 1e-16 differences into up to
  2e-7 relative, the sensitivity ``test_torch_low_rank.py`` measures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu.models as jm
import nutpie_tpu.sampler.mclmc as jmc
import nutpie_tpu_torch.models as tm
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.low_rank import LowRankMetric as JLowRankMetric
from nutpie_tpu.sampler.nuts import LowRankConfig as JLowRankConfig
from nutpie_tpu_torch.convert import mclmc_state_from_arrays, mclmc_state_to_arrays
from nutpie_tpu_torch.ops import threefry as tf
from nutpie_tpu_torch.sampler import mclmc as pmc
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import LowRankConfig

torch.set_num_threads(1)

CHAINS, CHUNK, SEED = 8, 16, 4
RTOL, ATOL = 1e-10, 1e-12
METRIC_RTOL, METRIC_ATOL = 1e-6, 1e-8


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 5])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_split_matches_jax(seed, n):
    key = jax.random.key(seed)
    ref = np.asarray(jax.random.key_data(jax.random.split(key, n)))
    np.testing.assert_array_equal(tf.split(tf.key(seed), n).numpy(), ref)
    # MCLMC's per-draw keys, and split(k, 1) is not k
    base = jax.random.fold_in(jax.random.fold_in(key, 4), 17)
    ref = np.asarray(jax.random.key_data(jax.random.split(base, n)))
    got = tf.split(tf.fold_in_data(tf.fold_in_data(tf.key(seed), 4), 17), n)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(ref[0], np.asarray(jax.random.key_data(base)))


def _metric(rng, C, dim, R):
    q = np.stack([np.linalg.qr(rng.standard_normal((dim, R)))[0] for _ in range(C)])
    return q, rng.normal(0.0, 1.0, (C, R))


@pytest.mark.parametrize("rank", [0, 3])
def test_dynamics_match_jax(rank):
    rng = np.random.default_rng(1)
    C, dim = 5, 7
    inv_mass = rng.uniform(0.2, 3.0, (C, dim))
    u = rng.standard_normal((C, dim))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    g = rng.standard_normal((C, dim)) * 3.0
    z = rng.standard_normal((C, dim))
    step = rng.uniform(-0.8, 0.8, C)
    basis, log_eigs = _metric(rng, C, dim, rank) if rank else (None, None)
    t = lambda a: None if a is None else torch.as_tensor(a)
    for c in range(C):
        metric = None if not rank else JLowRankMetric(jnp.asarray(basis[c]),
                                                      jnp.asarray(log_eigs[c]))
        ref_a = np.asarray(jmc._apply_A(jnp.asarray(inv_mass[c]), metric, jnp.asarray(u[c])))
        ref_at = np.asarray(jmc._apply_At(jnp.asarray(inv_mass[c]), metric, jnp.asarray(g[c])))
        got_a = pmc.apply_A(t(inv_mass), t(basis), t(log_eigs), t(u))[c].numpy()
        got_at = pmc.apply_At(t(inv_mass), t(basis), t(log_eigs), t(g))[c].numpy()
        np.testing.assert_allclose(got_a, ref_a, rtol=1e-12)
        np.testing.assert_allclose(got_at, ref_at, rtol=1e-12)
    ref_u, ref_dke = jax.vmap(jmc._update_velocity, in_axes=(0, 0, 0, None))(
        jnp.asarray(u), jnp.asarray(g), jnp.asarray(step), dim)
    got_u, got_dke = pmc.update_velocity(t(u), t(g), t(step), dim)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(ref_u), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got_dke.numpy(), np.asarray(ref_dke), rtol=1e-12)
    # the refresh draws its normals from the step's key
    keys = jax.random.split(jax.random.key(3), C)
    eps, L = 0.3, 2.0 * np.sqrt(dim)
    ref = jax.vmap(lambda uu, k: jmc._partial_refresh(uu, k, eps, L, jnp.float64))(
        jnp.asarray(u), keys)
    normals = tf.normal(torch.as_tensor(np.asarray(jax.random.key_data(keys)).astype(np.int64)),
                        (dim,), torch.float64)
    got = pmc.partial_refresh(t(u), normals, torch.full((C,), eps, dtype=torch.float64), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-15)


def jax_mclmc_arrays(state) -> dict:
    """Flatten a JAX ``MclmcState`` for ``convert``."""
    key = state.rng_key
    if getattr(key, "dtype", None) != np.uint32:
        key = jax.random.key_data(key)
    out = {"rng_key": np.asarray(key)}
    for name in ("position", "gradient", "velocity", "logp", "log_eps", "draw_idx",
                 "total_steps", "divergence_count"):
        out[name] = np.asarray(getattr(state, name))
    out["adapt.inv_mass"] = np.asarray(state.inv_mass)
    for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
        w = getattr(state, acc)
        for f in ("mean", "m2", "count"):
            out[f"adapt.{acc}.{f}"] = np.asarray(getattr(w, f))
    if state.metric is not None:
        out["adapt.metric.basis"] = np.asarray(state.metric.basis)
        out["adapt.metric.log_eigs"] = np.asarray(state.metric.log_eigs)
    return out


def _implied(arrays: dict) -> np.ndarray:
    """``U diag(exp(l) - 1) U^T``: eigenvectors are defined up to sign."""
    U, lg = arrays["adapt.metric.basis"], arrays["adapt.metric.log_eigs"]
    return np.einsum("cdr,cr,cer->cde", U, np.expm1(lg), U)


def assert_mclmc_close(got: dict, ref: dict, rtol=RTOL, atol=ATOL):
    assert got.keys() == ref.keys()
    if "adapt.metric.basis" in ref:
        np.testing.assert_allclose(_implied(got), _implied(ref), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg="implied metric")
    for name, r in ref.items():
        if name == "adapt.metric.basis":
            continue
        if name == "adapt.metric.log_eigs":
            np.testing.assert_allclose(got[name], r, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                       err_msg=name)
        elif name in ("rng_key", "draw_idx", "total_steps", "divergence_count") \
                or name.endswith(".count"):
            np.testing.assert_array_equal(got[name], r, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], r, rtol=rtol, atol=atol, err_msg=name)


def assert_bufs_close(b: pmc.MclmcBuffers, jb, limit: int, rtol=RTOL, atol=ATOL):
    cut = lambda x: np.asarray(x)[:, :limit]
    np.testing.assert_array_equal(b.diverging.numpy()[:, :limit], cut(jb.diverging))
    for name in ("position", "logp", "energy_error", "step_size"):
        got = getattr(b, name).numpy()[:, :limit]
        np.testing.assert_allclose(got, cut(getattr(jb, name)), rtol=rtol, atol=atol,
                                   err_msg=name)
    for name in ("gradient", "mass_matrix_inv"):
        if getattr(jb, name) is not None:
            np.testing.assert_allclose(getattr(b, name).numpy()[:, :limit],
                                       cut(getattr(jb, name)), rtol=rtol, atol=atol,
                                       err_msg=name)


# (model, model kwargs, num_tune, MclmcConfig fields)
CASES = {
    "microcanonical": ("eight_schools", {}, 32, {}),
    "euclidean": ("eight_schools", {}, 32, {"trajectory": "euclidean"}),
    "euclidean_then_micro": ("eight_schools", {}, 24,
                             {"trajectory": "euclidean_then_microcanonical"}),
    "steps3": ("eight_schools", {}, 32, {"steps_per_draw": 3, "store_mass_matrix": True,
                                         "store_gradient": True}),
    "fixed_step": ("eight_schools", {}, 32, {"dynamic_step_size": False, "step_size": 0.3}),
    "divergence": ("eight_schools", {}, 32, {"max_energy_error": 0.05}),
    "low_rank": ("ill_conditioned_gaussian", {"dim": 12}, 32, {"low_rank": True}),
}


def _configs(fields: dict, tune: int):
    fields = dict(fields)
    lr = fields.pop("low_rank", False)
    jcfg = jmc.MclmcConfig(adapt=JAdaptConfig(num_tune=tune),
                           low_rank=JLowRankConfig(eigval_cutoff=1.5) if lr else None,
                           **fields)
    cfg = pmc.MclmcConfig(adapt=AdaptConfig(num_tune=tune),
                          low_rank=LowRankConfig(eigval_cutoff=1.5) if lr else None, **fields)
    return jcfg, cfg


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_runner_matches_jax(case):
    name, kwargs, tune, fields = CASES[case]
    jmodel, model = getattr(jm, name)(**kwargs), getattr(tm, name)(**kwargs)
    jcfg, cfg = _configs(fields, tune)
    jsched, sched = jmake_schedule(jcfg.adapt, tune), make_schedule(cfg.adapt, tune)
    states, _ = jmc.init_mclmc_chains(jmodel, jcfg, SEED, CHAINS, np.zeros(jmodel.ndim),
                                      jnp.float64)
    jrun = jmc.make_mclmc_chunk_runner(jmodel, jcfg, CHUNK, jnp.float64)
    run = pmc.make_mclmc_chunk_runner(model, cfg, CHUNK, torch.float64)
    # a warmup chunk from draw 0, across the early switch at draw 9 (and,
    # with low rank, ending with a boundary update)
    port = mclmc_state_from_arrays(jax_mclmc_arrays(states))
    port, bufs = run(port, 0, CHUNK, sched)
    states, jbufs = jrun(states, 0, CHUNK, jsched)
    assert_bufs_close(bufs, jbufs, CHUNK)
    assert_mclmc_close(mclmc_state_to_arrays(port), jax_mclmc_arrays(states))
    if case == "divergence":
        assert 0 < int(np.asarray(jbufs.diverging).sum()) < jbufs.diverging.size
    # the rest of tuning in JAX, then a frozen chunk (a ragged limit)
    for start in range(CHUNK, tune, CHUNK):
        states, _ = jrun(states, start, min(CHUNK, tune - start), jsched)
    limit = CHUNK - 3
    port = mclmc_state_from_arrays(jax_mclmc_arrays(states))
    port, bufs = run(port, tune, limit, sched)
    states, jbufs = jrun(states, tune, limit, jsched)
    assert_bufs_close(bufs, jbufs, limit)
    assert_mclmc_close(mclmc_state_to_arrays(port), jax_mclmc_arrays(states))


@pytest.mark.parametrize("low_rank", [False, True])
def test_init_matches_jax(low_rank):
    jcfg, cfg = _configs({"low_rank": low_rank}, 20)
    jmodel, model = jm.eight_schools(), tm.eight_schools()
    states, jok = jmc.init_mclmc_chains(jmodel, jcfg, 11, CHAINS, np.zeros(jmodel.ndim),
                                        jnp.float64)
    port, ok = pmc.init_mclmc_chains(model, cfg, 11, CHAINS, np.zeros(model.ndim),
                                     torch.float64)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert_mclmc_close(mclmc_state_to_arrays(port), jax_mclmc_arrays(states), rtol=1e-12,
                       atol=1e-14)


def test_config_refuses_flow():
    """A flow configuration is taken (flow adaptation is ported); an unknown
    trajectory is refused."""
    from nutpie_tpu_torch.transforms.flow import FlowConfig

    cfg = pmc.MclmcConfig(flow=FlowConfig(num_layers=2))
    assert cfg.need_gradient and cfg.flow.num_layers == 2
    with pytest.raises(ValueError, match="trajectory"):
        pmc.MclmcConfig(trajectory="spiral")
    assert dataclasses.replace(pmc.MclmcConfig(), steps_per_draw=2).steps_per_draw == 2
