"""``sample(sampler="mclmc")`` of the port, on the CPU in float64.

- Ports of ``tests/test_mclmc.py``'s tests without flow (moments of a
  normal, determinism, the fixed step size, the two euclidean trajectory
  kinds, low-rank preconditioning of a correlated Gaussian) and of
  ``tests/test_api.py``'s ``MclmcSettings`` test, at their bars.
- The same run in both packages from one seed: draws and statistics to
  rtol 1e-10, ints and ``diverging`` exact, under each trajectory kind
  with the diagonal and the low-rank metric (the low-rank posterior after
  a boundary update to 1e-6: the estimator's eigendecompositions amplify
  rounding, ``test_torch_mclmc.py``).
- A checkpointed run resumed at a chunk boundary reproduces the
  uninterrupted run bitwise; pause and abort act at chunk boundaries.
- The Zarr layout of an MCLMC run is the JAX package's.
- Flow adaptation with MCLMC runs (``test_torch_flow_sample.py`` holds its
  moments and its checkpoint).
"""

import json
import time

import numpy as np
import pytest
import torch

import nutpie_tpu
import nutpie_tpu.models as jm
import nutpie_tpu_torch
import nutpie_tpu_torch.models as tm
from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
from nutpie_tpu.storage.stores import MemoryStore as JMemoryStore
from nutpie_tpu_torch import MclmcSettings
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def, from_pyfunc
from nutpie_tpu_torch.model import make_model
from nutpie_tpu_torch.storage.stores import MemoryStore
from nutpie_tpu_torch.storage.zarr_writer import read_zarr_array

torch.set_num_threads(1)

DEADLINE_S = 60


def _sample(model, **kwargs):
    return nutpie_tpu_torch.sample(model, sampler="mclmc", device="cpu",
                                   progress_bar=False, **kwargs)


def test_mclmc_normal_moments():
    model = compile_model_def(tm.std_normal(4, mu=2.0, sigma=1.5))
    trace = _sample(model, chains=4, draws=2000, tune=600, seed=21)
    x = np.asarray(trace.posterior["x"].values)
    assert x.shape == (4, 2000, 4)
    assert abs(x.mean() - 2.0) < 0.15
    assert abs(x.std() - 1.5) < 0.2
    stats = trace.sample_stats
    assert "energy_error" in stats
    assert "step_size" in stats


def test_mclmc_determinism():
    model = compile_model_def(tm.std_normal(2))
    kwargs = dict(chains=2, draws=200, tune=200)
    t1 = _sample(model, seed=5, **kwargs)
    t2 = _sample(model, seed=5, **kwargs)
    np.testing.assert_array_equal(np.asarray(t1.posterior["x"].values),
                                  np.asarray(t2.posterior["x"].values))


def test_mclmc_fixed_step_size():
    model = compile_model_def(tm.std_normal(2))
    trace = _sample(model, chains=2, draws=100, tune=100, seed=2,
                    dynamic_step_size=False, step_size=0.3)
    eps = np.asarray(trace.sample_stats["step_size"].values)
    np.testing.assert_allclose(eps, 0.3)


@pytest.mark.parametrize("traj", ["euclidean", "euclidean_then_microcanonical"])
def test_mclmc_trajectory_kinds(traj):
    model = compile_model_def(tm.std_normal(3, mu=1.0, sigma=2.0))
    trace = _sample(model, chains=4, draws=1500, tune=500, seed=33, trajectory=traj)
    x = np.asarray(trace.posterior["x"].values)
    assert abs(x.mean() - 1.0) < 0.2
    assert abs(x.std() - 2.0) < 0.3


def correlated_gaussian(dim=8, factor=40.0, seed=0):
    """``tests/test_mclmc.py:_correlated_gaussian``, batched in torch."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((dim, 1))
    u /= np.linalg.norm(u)
    cov = np.eye(dim) + factor * (u @ u.T)
    prec_np = np.linalg.inv(cov)
    cache = {}

    def logp(x):
        key = (x.device, x.dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(prec_np, dtype=x.dtype, device=x.device)
        return -0.5 * torch.sum((x @ cache[key]) * x, dim=1)

    return make_model(dim, logp, param_vars=[("x", np.float64, (dim,),
                                              ("unconstrained_parameter",))]), cov


def test_mclmc_low_rank():
    model_def, cov = correlated_gaussian()
    trace = _sample(compile_model_def(model_def), adaptation="low_rank", chains=8,
                    draws=3000, tune=1200, seed=11)
    x = np.asarray(trace.posterior["x"].values).reshape(-1, 8)
    ratio = np.var(x, axis=0) / np.diag(cov)
    assert ratio.min() > 0.5, ratio
    assert ratio.max() < 1.5, ratio


def test_mclmc_settings():
    s = MclmcSettings.Diag(seed=1)
    s.update({"step_size": 0.7, "trajectory": "euclidean"})
    assert s.step_size == 0.7
    assert s.trajectory_kind == "euclidean"
    with pytest.raises(ValueError, match="Unknown trajectory"):
        s.update({"trajectory": "spiral"})


# (adaptation, trajectory, extra settings)
PARITY = {
    "micro_diag": ("diag", "microcanonical", {"store_mass_matrix": True}),
    "euclidean_diag": ("diag", "euclidean", {"subsample_frequency": 2}),
    "then_micro_low_rank": ("low_rank", "euclidean_then_microcanonical",
                            {"mass_matrix_eigval_cutoff": 1.5, "store_gradient": True}),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_sample_matches_jax(case):
    adaptation, traj, extra = PARITY[case]
    common = dict(sampler="mclmc", adaptation=adaptation, trajectory=traj, chains=4,
                  tune=40, draws=24, seed=19, chunk_size=16, progress_bar=False,
                  return_raw_trace=True, **extra)
    ours = nutpie_tpu_torch.sample(compile_model_def(tm.eight_schools()), device="cpu",
                                   **common)
    ref = nutpie_tpu.sample(jax_compile(jm.eight_schools()), **common)
    assert ours["stats"].keys() == ref["stats"].keys()
    rtol, atol = (1e-6, 1e-8) if adaptation == "low_rank" else (1e-10, 1e-12)
    np.testing.assert_allclose(ours["position"], ref["position"], rtol=rtol, atol=atol)
    for name, want in ref["stats"].items():
        got = ours["stats"][name]
        assert got.dtype == np.asarray(want).dtype, name
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def test_resume_is_bitwise(tmp_path):
    model = compile_model_def(tm.eight_schools())
    common = dict(chains=2, tune=32, seed=3, chunk_size=16, return_raw_trace=True)
    full = _sample(model, draws=32, **common)
    path = tmp_path / "mclmc.npz"
    _sample(model, draws=0, checkpoint=path, **common)
    resumed = _sample(model, draws=32, resume_from=path, **common)
    np.testing.assert_array_equal(resumed["position"], full["position"][:, 32:])
    for name, want in full["stats"].items():
        np.testing.assert_array_equal(resumed["stats"][name], want[:, 32:], err_msg=name)
    # a NUTS run cannot resume from an MCLMC checkpoint
    with pytest.raises(ValueError, match="checkpoint"):
        nutpie_tpu_torch.sample(model, device="cpu", progress_bar=False, chains=2, tune=32,
                                draws=8, seed=3, chunk_size=16, resume_from=path)


def _until(cond, what: str):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_pause_and_abort():
    m = from_pyfunc(3, lambda: (lambda x: -0.5 * torch.sum(x * x, dim=1)))
    h = _sample(m, chains=2, tune=20, draws=100_000, seed=1, chunk_size=8, blocking=False)
    _until(lambda: h._draws_done >= 16, "two chunks")
    h.pause()
    time.sleep(0.3)  # the chunk in flight may still land
    paused_at = h._draws_done
    time.sleep(0.3)
    assert h._draws_done == paused_at, "the loop ran on while paused"
    h.resume()
    _until(lambda: h._draws_done > paused_at, "the resumed loop")
    partial = h.abort()
    assert h.is_finished
    n = partial.posterior["x"].shape[1] + partial.warmup_posterior["x"].shape[1]
    assert n == h._draws_done and n % 8 == 0


def _strip_library(doc):
    if isinstance(doc, dict):
        return {k: _strip_library(v) for k, v in doc.items()
                if not k.startswith("inference_library")}
    return doc


def test_zarr_layout_matches_jax():
    common = dict(sampler="mclmc", chains=2, tune=16, draws=16, seed=13, chunk_size=16,
                  progress_bar=False)
    ours, ref = MemoryStore(), JMemoryStore()
    nutpie_tpu_torch.sample(compile_model_def(tm.eight_schools()), device="cpu",
                            zarr_store=ours, **common)
    nutpie_tpu.sample(jax_compile(jm.eight_schools()), zarr_store=ref, **common)
    assert sorted(ours.mapping) == sorted(ref.mapping)
    for key in ref.mapping:
        name = key.rsplit("/", 1)[-1]
        if name in (".zarray", ".zgroup", ".zattrs", ".zmetadata"):
            assert _strip_library(json.loads(ours.mapping[key])) == \
                _strip_library(json.loads(ref.mapping[key])), key
    for arr in ("warmup_sample_stats/n_steps", "sample_stats/diverging"):
        np.testing.assert_array_equal(read_zarr_array(ours, arr), read_zarr_array(ref, arr))


def test_flow_refused():
    """Flow adaptation with MCLMC, refused until it was ported, now runs: a
    short run with a small flow, MCLMC's statistics and finite draws."""
    m = compile_model_def(tm.eight_schools()).with_transform_adapt(
        num_layers=2, hidden=8, train_steps=5, window=32)
    trace = _sample(m, adaptation="flow", chains=2, tune=48, draws=16, seed=3, chunk_size=16)
    assert list(trace.sample_stats.data_vars) == ["logp", "energy_error", "diverging",
                                                  "step_size", "n_steps"]
    theta = np.asarray(trace.posterior["theta"].values)
    assert theta.shape == (2, 16, 8) and np.isfinite(theta).all()
