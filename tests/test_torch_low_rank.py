"""The port's low-rank mass matrix against the JAX package's, on the CPU.

Inputs come from seeded numpy and go through both packages (JAX on the
CPU with x64, torch in float64):

- the metric operations (``lr_velocity``, ``lr_velocity_rows``,
  ``lr_sample_momentum``) on a random orthonormal basis with two padded
  slots, per chain against the JAX functions, to rtol 1e-12;
- ``estimate_low_rank`` on a window of 16 draws at dim 10 (r = dim) and 8
  draws at dim 40 (r = 2W < dim, some rows invalid): the implied matrices
  ``U diag(lambda - 1) U^T`` to 1e-8 of their largest entry, the sorted
  log eigenvalues to 1e-9, padded slots exactly zero; and the JAX test's
  covariance recovery on the port alone.  At r < dim the window is rank
  deficient and its null directions enter the geometric mean through
  factors of 1/gamma: at the default gamma 1e-5 the estimator itself
  moves the implied matrix by 3e-8 to 1.5e-7 of its largest entry when its
  inputs move by 1e-15 relative (at gamma 1e-3 by 2e-10), so no two
  implementations can agree to 1e-8 there.  That case is held to 1e-8 at
  gamma 1e-3, and at gamma 1e-5 to ten times the port's own sensitivity,
  measured in the test by that perturbation;
- the step runner with ``low_rank`` (plain version) against
  ``nutpie_tpu.sampler.run.make_chunk_runner`` on the correlated Gaussian
  of ``tests/test_low_rank.py`` (dim 8), 4 chains, 16-draw chunks,
  ``num_tune`` 64, from a JAX state with a non-identity metric carried
  across by ``convert``: a warmup chunk whose end falls where the metric
  update is due, and a frozen chunk.  Ints and step counts exact,
  positions, logp and adaptation state to 1e-10, the metric after the
  boundary to 1e-8 through the implied matrix;
- ``sample(adaptation="low_rank", device="cpu")`` on that model with the
  JAX test's settings and bars (2 chains x (600 tune + 800 draws));
- the trace's ``store_gradient`` / ``store_mass_matrix`` statistics
  against the JAX trace's names, shapes and dtypes on eight schools;
- the route: radon with low-rank or ``store_gradient`` takes the step
  kernel, diagonal radon the chunk kernel;
- a low-rank state carried JAX -> port -> JAX bitwise by ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu
import nutpie_tpu.models as jm
import nutpie_tpu_torch
import nutpie_tpu_torch.models as tm
from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
from nutpie_tpu.model import make_model as jmake_model
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler import low_rank as jlr
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.nuts import LowRankConfig as JLowRankConfig
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu_torch.convert import state_from_arrays, state_to_arrays
from nutpie_tpu_torch.diagnostics import ess
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.model import make_model
from nutpie_tpu_torch.sample import nuts_config_from_settings, route
from nutpie_tpu_torch.sampler import low_rank as tlr
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS, LowRankConfig, NutsConfig
from nutpie_tpu_torch.sampler.run import make_chunk_runner
from nutpie_tpu_torch.settings import NutsSettings
from torch_parity import (
    assert_state_close,
    jax_state_arrays,
    jax_state_from_arrays,
    t64,
)

torch.set_num_threads(1)


def _basis(rng, dim: int, rank: int, padded: int):
    """A random orthonormal basis and log eigenvalues, the last ``padded``
    slots zero (lambda = 1)."""
    q = np.zeros((dim, rank))
    q[:, :rank - padded], _ = np.linalg.qr(rng.standard_normal((dim, rank - padded)))
    log_eigs = 1.5 * rng.standard_normal(rank)
    log_eigs[rank - padded:] = 0.0
    return q, log_eigs


def _implied(basis, log_eigs) -> np.ndarray:
    return np.asarray(tlr.implied_matrix(t64(basis), t64(log_eigs)))


# --------------------------------------------------------- metric operations


def test_metric_ops_match_jax():
    rng = np.random.default_rng(0)
    C, dim, R = 3, 12, 4
    metrics = [_basis(rng, dim, R, 2) for _ in range(C)]
    basis = np.stack([m[0] for m in metrics])
    log_eigs = np.stack([m[1] for m in metrics])
    inv_mass = rng.uniform(0.2, 3.0, (C, dim))
    p = rng.standard_normal((C, dim))
    P = rng.standard_normal((C, 5, dim))
    args = (t64(inv_mass), t64(basis), t64(log_eigs))
    got = {
        "velocity": tlr.lr_velocity(*args, t64(p)),
        "rows": tlr.lr_velocity_rows(*args, t64(P)),
        "momentum": tlr.lr_sample_momentum(*args, t64(p)),
    }
    for c in range(C):
        m = jlr.LowRankMetric(basis=jnp.asarray(basis[c]), log_eigs=jnp.asarray(log_eigs[c]))
        im = jnp.asarray(inv_mass[c])
        ref = {
            "velocity": jlr.lr_velocity(im, m, jnp.asarray(p[c])),
            "rows": jlr.lr_velocity_rows(im, m, jnp.asarray(P[c])),
            "momentum": jlr.lr_sample_momentum(im, m, jnp.asarray(p[c])),
        }
        for name, value in ref.items():
            np.testing.assert_allclose(got[name][c].numpy(), np.asarray(value),
                                       rtol=1e-12, atol=1e-14, err_msg=name)
    # all slots padded: the diagonal metric's momentum to the bit, its
    # velocity to rounding (s * (s * p) against inv_mass * p)
    zb, zl = torch.zeros((C, dim, R), dtype=torch.float64), torch.zeros((C, R), dtype=torch.float64)
    assert torch.equal(tlr.lr_sample_momentum(t64(inv_mass), zb, zl, t64(p)),
                       t64(p) / torch.sqrt(t64(inv_mass)))
    torch.testing.assert_close(tlr.lr_velocity(t64(inv_mass), zb, zl, t64(p)),
                               t64(inv_mass) * t64(p), rtol=1e-15, atol=0)


# ---------------------------------------------------------- the estimator


def _window(rng, C, W, dim, n_invalid):
    u = rng.standard_normal((dim, 2))
    cov = np.eye(dim) + 20.0 * (u @ u.T) / dim
    chol = np.linalg.cholesky(cov)
    draws = np.einsum("ij,cwj->cwi", chol, rng.standard_normal((C, W, dim)))
    grads = -draws @ np.linalg.inv(cov) + 0.01 * rng.standard_normal((C, W, dim))
    valid = np.ones((C, W), bool)
    valid[:, W - n_invalid:] = False
    draws[:, W - 1] = np.nan  # an invalid row may hold anything
    inv_mass = rng.uniform(0.5, 2.0, (C, dim))
    return draws, grads, valid, inv_mass


@pytest.mark.parametrize("W,dim,n_invalid,gamma", [
    (16, 10, 1, 1e-5), (8, 40, 2, 1e-3), (8, 40, 2, 1e-5)])
def test_estimate_low_rank_matches_jax(W, dim, n_invalid, gamma):
    rng = np.random.default_rng(W * dim)
    C, max_rank, cutoff = 2, 32, 1.5
    draws, grads, valid, inv_mass = _window(rng, C, W, dim, n_invalid)
    estimate = lambda d, g: tlr.estimate_low_rank(
        d, g, torch.as_tensor(valid), t64(inv_mass), max_rank, cutoff, gamma)
    got = estimate(t64(draws), t64(grads))
    r = min(2 * W, dim)
    tol, eig_tol = 1e-8, 1e-9
    if r < dim and gamma < 1e-3:
        # the estimator's own sensitivity (see the module docstring)
        moved = estimate(t64(draws) * (1 + 1e-15), t64(grads) * (1 + 1e-15))
        a, b = _implied(got.basis, got.log_eigs), _implied(moved.basis, moved.log_eigs)
        tol = 10 * float(np.abs(a - b).max() / np.abs(a).max())
        eig_tol = 10 * float((got.log_eigs - moved.log_eigs).abs().max())
        assert tol > 1e-8  # the case is as ill-conditioned as the docstring says
    assert got.basis.shape == (C, dim, max_rank) and got.log_eigs.shape == (C, max_rank)
    assert bool((got.basis[:, :, r:] == 0).all()) and bool((got.log_eigs[:, r:] == 0).all())
    kept = 0
    for c in range(C):
        ref = jlr.estimate_low_rank(
            jnp.asarray(draws[c]), jnp.asarray(grads[c]), jnp.asarray(valid[c]),
            jnp.asarray(inv_mass[c]), max_rank, cutoff, gamma)
        a = _implied(got.basis[c:c + 1], got.log_eigs[c:c + 1])[0]
        b = _implied(np.asarray(ref.basis)[None], np.asarray(ref.log_eigs)[None])[0]
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())
        np.testing.assert_allclose(np.sort(got.log_eigs[c].numpy()),
                                   np.sort(np.asarray(ref.log_eigs)), rtol=0, atol=eig_tol)

        # a dropped slot is exactly zero, as in the JAX function
        zero = got.log_eigs[c] == 0
        assert bool((got.basis[c][:, zero] == 0).all())
        kept += int((~zero).sum())
    assert kept > 0


def test_estimate_recovers_covariance():
    """``tests/test_low_rank.py:51-74`` on the port alone."""
    rng = np.random.default_rng(1)
    dim, W = 6, 64
    u = rng.standard_normal((dim, 1))
    u /= np.linalg.norm(u)
    cov = np.eye(dim) + 30.0 * (u @ u.T)
    chol = np.linalg.cholesky(cov)
    draws = (chol @ rng.standard_normal((dim, W))).T
    grads = -(draws @ np.linalg.inv(cov))
    metric = tlr.estimate_low_rank(
        t64(draws)[None], t64(grads)[None], torch.ones((1, W), dtype=torch.bool),
        torch.ones((1, dim), dtype=torch.float64), max_rank=4, eigval_cutoff=2.0,
        gamma=1e-8)
    minv = np.eye(dim) + _implied(metric.basis, metric.log_eigs)[0]
    top_true, top_est = np.linalg.eigvalsh(cov)[-1], np.linalg.eigvalsh(minv)[-1]
    assert 0.5 * top_true < top_est < 2.0 * top_true


# ------------------------------------------------------------ the step runner

DIM, CHAINS, TUNE, CHUNK, CUTOFF = 8, 4, 64, 16, 3.0


def _correlated_cov(dim=DIM, seed=0):
    """``tests/test_low_rank.py:_correlated_gaussian``'s covariance."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((dim, 1))
    u /= np.linalg.norm(u)
    return np.eye(dim) + 40.0 * (u @ u.T)


def _models():
    cov = _correlated_cov()
    prec = np.linalg.inv(cov)
    jprec = jnp.asarray(prec)
    var = [("x", np.float64, (DIM,), ("unconstrained_parameter",))]
    jmodel = jmake_model(DIM, lambda x: -0.5 * x @ jprec @ x, param_vars=var)
    tprec = torch.as_tensor(prec)
    tmodel = make_model(
        DIM, lambda x: -0.5 * torch.sum((x @ tprec.to(x)) * x, dim=1), param_vars=var)
    return jmodel, tmodel, cov


def _copy(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


@pytest.fixture(scope="module")
def fleet():
    jmodel, tmodel, _ = _models()
    jcfg = JNutsConfig(low_rank=JLowRankConfig(eigval_cutoff=CUTOFF),
                       adapt=JAdaptConfig(num_tune=TUNE))
    jsched = jmake_schedule(jcfg.adapt, TUNE)
    states, _ = jinit_chains(jmodel, jcfg, 5, CHAINS, np.zeros(DIM), jnp.float64)
    # a non-identity metric, carried across from here on
    rng = np.random.default_rng(7)
    metrics = [_basis(rng, DIM, 32, 29) for _ in range(CHAINS)]
    states = states._replace(adapt=states.adapt._replace(metric=jlr.LowRankMetric(
        basis=jnp.asarray(np.stack([m[0] for m in metrics])),
        log_eigs=jnp.asarray(np.stack([m[1] for m in metrics])))))
    warm = jmake_chunk_runner(jmodel, jcfg, CHUNK, jnp.float64)
    states, _ = warm(states, 0, CHUNK, jsched)  # ends at 16 <= early_end: not due
    at16 = _copy(states)
    js16, jb16 = warm(_copy(at16), CHUNK, CHUNK, jsched)  # ends at 32: due
    states = _copy(js16)  # the runner donates its input
    for start in range(2 * CHUNK, TUNE, CHUNK):

        states, _ = warm(states, start, CHUNK, jsched)
    frozen = jmake_chunk_runner(jmodel, jcfg, CHUNK, jnp.float64, adapt_frozen=True)
    js64, jb64 = frozen(_copy(states), TUNE, CHUNK, jsched)
    cfg = NutsConfig(low_rank=LowRankConfig(eigval_cutoff=CUTOFF),
                     adapt=AdaptConfig(num_tune=TUNE))
    return dict(model=tmodel, cfg=cfg, sched=make_schedule(cfg.adapt, TUNE),
                at16=at16, warm16=(js16, jb16), at64=states, frozen64=(js64, jb64))


def _port(fleet, state, start, frozen):
    run = make_chunk_runner(fleet["model"], fleet["cfg"], CHUNK, torch.float64,
                            adapt_frozen=frozen)
    return run(state_from_arrays(jax_state_arrays(state)), start, CHUNK, fleet["sched"])


def _check_chunk(ts, tb, js, jb, metric_tol):
    got, ref = state_to_arrays(ts), jax_state_arrays(js)
    metric = {k: (got.pop(k), ref.pop(k)) for k in ("adapt.metric.basis", "adapt.metric.log_eigs")}
    assert_state_close(got, ref, rtol=1e-10, atol=1e-10)
    ns = SCALAR_SLOTS["n_steps"]
    np.testing.assert_array_equal(tb.scalars[..., ns].numpy(), np.asarray(jb.scalars)[..., ns])
    for name in ("position", "scalars", "gradient"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)
    a = _implied(*(m[0] for m in metric.values()))
    b = _implied(*(m[1] for m in metric.values()))
    np.testing.assert_allclose(a, b, rtol=0, atol=metric_tol * np.abs(b).max())
    return b


def test_warmup_chunk_with_metric_update_matches_jax(fleet):
    ts, tb = _port(fleet, fleet["at16"], CHUNK, False)
    js, jb = fleet["warm16"]
    implied = _check_chunk(ts, tb, js, jb, 1e-8)
    before = _implied(*(jax_state_arrays(fleet["at16"])[k]
                        for k in ("adapt.metric.basis", "adapt.metric.log_eigs")))
    assert not np.allclose(implied, before)  # the update happened
    assert bool((ts.lr_log_eigs != 0).any(dim=1).all())  # every chain keeps a slot


def test_frozen_chunk_matches_jax(fleet):
    ts, tb = _port(fleet, fleet["at64"], TUNE, True)
    js, jb = fleet["frozen64"]
    _check_chunk(ts, tb, js, jb, 0.0)


# ---------------------------------------------------------- sample() on the CPU


def test_low_rank_sampling_correlated():
    """``tests/test_low_rank.py:77-93`` through the port's plain version."""
    _, tmodel, cov = _models()
    trace = nutpie_tpu_torch.sample(
        compile_model_def(tmodel), chains=2, draws=800, tune=600, seed=8,
        adaptation="low_rank", mass_matrix_eigval_cutoff=3.0, device="cpu")
    x = np.asarray(trace.posterior["x"].values)
    ratio = np.diag(np.cov(x.reshape(-1, DIM).T)) / np.diag(cov)
    assert np.all(ratio > 0.6) and np.all(ratio < 1.6), ratio
    proj = x @ np.linalg.eigh(cov)[1][:, -1]
    assert float(ess(proj)) > 100


# ----------------------------------------------------------- trace fields

STORE_CASES = [
    dict(adaptation="diag", store_gradient=True, store_mass_matrix=True),
    dict(adaptation="low_rank", store_mass_matrix=True),
]


@pytest.mark.parametrize("kwargs", STORE_CASES, ids=["diag-both", "lr-mass"])

def test_store_buffers_match_jax_trace(kwargs):
    run = dict(chains=2, tune=30, draws=10, seed=4, maxdepth=4, **kwargs)
    port = nutpie_tpu_torch.sample(compile_model_def(tm.eight_schools()), device="cpu", **run)
    ref = nutpie_tpu.sample(jax_compile(jm.eight_schools()), progress_bar=False, **run)
    for group in ("sample_stats", "warmup_sample_stats"):
        p, r = port[group], ref[group]
        assert set(p.data_vars) == set(r.data_vars), group
        for name in r.data_vars:
            assert p[name].shape == r[name].shape, (group, name)
            assert p[name].dtype == r[name].dtype, (group, name)
            assert tuple(p[name].dims) == tuple(r[name].dims), (group, name)
        names = set(r.data_vars)
        assert ("gradient" in names) == kwargs.get("store_gradient", False)
        assert ("mass_matrix_eigvals" in names) == (
            kwargs["adaptation"] == "low_rank" and kwargs.get("store_mass_matrix", False))
    if "mass_matrix_eigvals" in port.sample_stats.data_vars:
        eig = np.asarray(port.sample_stats["mass_matrix_eigvals"].values)
        assert np.isfinite(eig).all() and (eig > 0).all()


# ------------------------------------------------------------- route, convert


def _cfg(adaptation="diag", **settings):
    s = NutsSettings.LowRank(0) if adaptation == "low_rank" else NutsSettings.Diag(0)
    s.update(settings)
    return nuts_config_from_settings(s)


def test_route_of_low_rank_and_stored_buffers():
    radon = tm.radon()
    assert route(_cfg(), radon) == "megakernel"
    assert route(_cfg("low_rank"), radon) == "step"
    assert route(_cfg(store_gradient=True), radon) == "step"
    assert route(_cfg(store_mass_matrix=True), radon) == "step"
    assert route(_cfg("low_rank"), tm.eight_schools()) == "step"


def test_convert_round_trip_of_low_rank_state(fleet):
    state = fleet["at16"]
    arrays = jax_state_arrays(state)
    port = state_from_arrays(arrays)
    assert port.lr_basis.shape == (CHAINS, DIM, 32) and port.lr_log_eigs.shape == (CHAINS, 32)
    back = jax_state_from_arrays(state, state_to_arrays(port))
    a, b = jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(back)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            x, y = jax.random.key_data(x), jax.random.key_data(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8))
