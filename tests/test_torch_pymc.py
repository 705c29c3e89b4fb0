"""The port's PyMC frontend against the JAX package's, on the CPU in float64.

pymc and pytensor are not installed, so both frontends run against
stand-ins of the modules they import: ``tests/fake_pymc.py`` (graphs in
JAX, for ``nutpie_tpu``) and ``tests/torch_fake_pymc.py`` (graphs in torch,
lowered by a stand-in of PyTensor's PyTorch linker, for
``nutpie_tpu_torch``).  Each test installs the JAX stand-in, computes the
JAX frontend's arrays as numpy, then installs the torch stand-in and
builds the port's model.  Every model of ``tests/test_pymc_stub.py`` and
``tests/test_pymc_edge_cases.py`` is written twice, in JAX and in torch,
neither derived from the other:

- logp and gradient at seeded points to rtol 1e-12 / atol 1e-12, under
  both gradient backends (the JAX package's ``"jax"`` against the port's
  ``"pytorch"``, and ``"pytensor"`` in both);
- initial points bitwise, under the default jitter, ``jitter_rvs``,
  ``initial_points`` and ``adapt_diag``;
- the expand outputs to 1e-12, the variables' names, shapes and dims
  (the anonymous and the partial dims among them), coords and the
  reparameterized names;
- ``with_data`` and its shape error, C- and F-ordered data, and freezing
  after ``with_data``; ``var_names``; the zero-size variable through a
  short ``sample()``; float32; the option checks;
- a short ``sample()`` of ``linear_regression_model`` in both packages
  from one seed: the same trace layout, the first chunk's step counts
  exact and its draws to rtol 1e-8, the posterior means within 5 combined
  Monte Carlo standard errors.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fake_pymc
import nutpie_tpu
import nutpie_tpu_torch
import torch_fake_pymc
from nutpie_tpu.frontends.pymc import compile_pymc_model as jax_compile_pymc
from nutpie_tpu_torch.diagnostics import ess

torch.set_num_threads(1)

RTOL = ATOL = 1e-12
POINTS = 4


# --------------------------------------------------------- the models, twice


def _jax_specs():
    """``name -> (model, x_dim)`` of the JAX stand-in (the edge cases of
    ``tests/test_pymc_edge_cases.py``, as written there)."""
    def zero_size():
        def logp(env, data):
            return -0.5 * jnp.sum(env["a"] ** 2) - 0.5 * env["b"] ** 2
        return dict(value_vars=[("a", (0,)), ("b", ())], free_rvs=["a", "b"], logp=logp,
                    outputs=[("a", lambda env, data: env["a"]),
                             ("b", lambda env, data: env["b"])],
                    initial={"a": np.zeros(0), "b": np.array(0.0)}, data={})

    def flat_prior():
        def logp(env, data):
            return -0.5 * (jnp.asarray(data["y"]) - env["mu"]) ** 2
        return dict(value_vars=[("mu", ())], free_rvs=["mu"], logp=logp,
                    outputs=[("mu", lambda env, data: env["mu"])],
                    initial={"mu": np.array(0.0)}, data={"y": np.array(1.5)})

    def missing_data():
        y_obs = np.random.default_rng(0).normal(2.0, 1.0, 8)

        def logp(env, data):
            mu = env["mu"]
            lp = -0.5 * jnp.sum((jnp.asarray(data["y_obs"]) - mu) ** 2)
            lp += -0.5 * jnp.sum((env["y_unobserved"] - mu) ** 2)
            return lp - 0.5 * mu ** 2 / 100.0

        def combined(env, data):
            out = jnp.zeros(10).at[np.arange(8)].set(jnp.asarray(data["y_obs"]))
            return out.at[np.array([8, 9])].set(env["y_unobserved"])
        return dict(value_vars=[("mu", ()), ("y_unobserved", (2,))],
                    free_rvs=["mu", "y_unobserved"], logp=logp,
                    outputs=[("mu", lambda env, data: env["mu"]),
                             ("y_unobserved", lambda env, data: env["y_unobserved"]),
                             ("y", combined)],
                    initial={"mu": np.array(0.0), "y_unobserved": np.zeros(2)},
                    data={"y_obs": y_obs})

    def names():
        def logp(env, data):
            return -0.5 * env["a b"] ** 2 - 0.5 * jnp.sum(env["sub::x"] ** 2)
        return dict(value_vars=[("a b", ()), ("sub::x", (2,))], free_rvs=["a b", "sub::x"],
                    logp=logp, outputs=[("a b", lambda env, data: env["a b"]),
                                        ("sub::x", lambda env, data: env["sub::x"])],
                    initial={"a b": np.array(0.0), "sub::x": np.zeros(2)}, data={})

    def matrix(dims):
        def logp(env, data):
            return -0.5 * jnp.sum(env["m"] ** 2)
        return dict(value_vars=[("m", (2, 3))], free_rvs=["m"], logp=logp,
                    outputs=[("m", lambda env, data: env["m"])],
                    initial={"m": np.zeros((2, 3))}, data={}, coords={"row": ["r0", "r1"]},
                    dims={"m": dims})

    return {"zero_size": zero_size, "flat_prior": flat_prior, "missing_data": missing_data,
            "non_identifier_names": names, "anonymous_dims": lambda: matrix(("row",)),
            "partial_dims": lambda: matrix(("row", None))}


def _torch_specs():
    """The same models with their graphs in torch."""
    def zero_size():
        def logp(env, data):
            return -0.5 * torch.sum(env["a"] ** 2) - 0.5 * env["b"] ** 2
        return dict(value_vars=[("a", (0,)), ("b", ())], free_rvs=["a", "b"], logp=logp,
                    outputs=[("a", lambda env, data: env["a"]),
                             ("b", lambda env, data: env["b"])],
                    initial={"a": np.zeros(0), "b": np.array(0.0)}, data={})

    def flat_prior():
        def logp(env, data):
            return -0.5 * (data["y"] - env["mu"]) ** 2
        return dict(value_vars=[("mu", ())], free_rvs=["mu"], logp=logp,
                    outputs=[("mu", lambda env, data: env["mu"])],
                    initial={"mu": np.array(0.0)}, data={"y": np.array(1.5)})

    def missing_data():
        y_obs = np.random.default_rng(0).normal(2.0, 1.0, 8)

        def logp(env, data):
            mu = env["mu"]
            lp = -0.5 * torch.sum((data["y_obs"] - mu) ** 2)
            lp = lp - 0.5 * torch.sum((env["y_unobserved"] - mu) ** 2)
            return lp - 0.5 * mu ** 2 / 100.0

        def combined(env, data):
            # observed rows 0..7, the imputed ones 8 and 9
            return torch.cat([data["y_obs"], env["y_unobserved"]])
        return dict(value_vars=[("mu", ()), ("y_unobserved", (2,))],
                    free_rvs=["mu", "y_unobserved"], logp=logp,
                    outputs=[("mu", lambda env, data: env["mu"]),
                             ("y_unobserved", lambda env, data: env["y_unobserved"]),
                             ("y", combined)],
                    initial={"mu": np.array(0.0), "y_unobserved": np.zeros(2)},
                    data={"y_obs": y_obs})

    def names():
        def logp(env, data):
            return -0.5 * env["a b"] ** 2 - 0.5 * torch.sum(env["sub::x"] ** 2)
        return dict(value_vars=[("a b", ()), ("sub::x", (2,))], free_rvs=["a b", "sub::x"],
                    logp=logp, outputs=[("a b", lambda env, data: env["a b"]),
                                        ("sub::x", lambda env, data: env["sub::x"])],
                    initial={"a b": np.array(0.0), "sub::x": np.zeros(2)}, data={})

    def matrix(dims):
        def logp(env, data):
            return -0.5 * torch.sum(env["m"] ** 2)
        return dict(value_vars=[("m", (2, 3))], free_rvs=["m"], logp=logp,
                    outputs=[("m", lambda env, data: env["m"])],
                    initial={"m": np.zeros((2, 3))}, data={}, coords={"row": ["r0", "r1"]},
                    dims={"m": dims})

    return {"zero_size": zero_size, "flat_prior": flat_prior, "missing_data": missing_data,
            "non_identifier_names": names, "anonymous_dims": lambda: matrix(("row",)),
            "partial_dims": lambda: matrix(("row", None))}


CASES = ["linear_regression", *_jax_specs()]


def _jax_model(case):
    if case == "linear_regression":
        return fake_pymc.linear_regression_model()[0]
    return fake_pymc.FakeModel(_jax_specs()[case]())


def _torch_model(case):
    if case == "linear_regression":
        return torch_fake_pymc.linear_regression_model()[0]
    return torch_fake_pymc.FakeModel(_torch_specs()[case]())


class Pair:
    """Installs each stand-in in turn: ``jax(case, **kw)`` compiles under
    ``fake_pymc``, ``port(case, **kw)`` under ``torch_fake_pymc``."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch

    def jax(self, case, **kwargs):
        for name in [n for n in sys.modules if n.split(".")[0] in ("pymc", "pytensor")]:
            self.mp.delitem(sys.modules, name)  # the torch stand-in, if installed
        assert fake_pymc.install(self.mp)
        return jax_compile_pymc(_jax_model(case), **kwargs)

    def port(self, case, **kwargs):
        assert torch_fake_pymc.install(self.mp)
        return nutpie_tpu_torch.compile_pymc_model(_torch_model(case), **kwargs)


@pytest.fixture
def pair(monkeypatch):
    return Pair(monkeypatch)


def _points(ndim, seed=1):
    return np.random.default_rng(seed).standard_normal((POINTS, ndim))


def _key_data(k: int):
    return np.asarray(jax.random.key_data(jax.random.key(k)))


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("backend", ["autograd", "pytensor"])
@pytest.mark.parametrize("case", CASES)
def test_logp_and_gradient_match_jax(pair, case, backend):
    jm = pair.jax(case, gradient_backend="jax" if backend == "autograd" else "pytensor")
    jm = jm._make_model(0)
    x = _points(jm.ndim)
    lj, gj = jax.vmap(jm.logp_and_grad)(jnp.asarray(x))
    tm = pair.port(case, gradient_backend="pytorch" if backend == "autograd" else "pytensor")
    tm = tm._make_model(0)
    assert (tm.logp_grad_fn is None) == (backend == "autograd")
    lt, gt = tm.logp_and_grad(torch.as_tensor(x))
    assert lt.dtype == gt.dtype == torch.float64 and gt.shape == x.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("options", [
    {}, {"jitter_rvs": ["beta"]},
    {"initial_points": {"sigma": 2.0}, "default_initialization_strategy": "adapt_diag"},
    {"initial_points": {"beta": [0.5, -0.5, 1.0]}, "jitter_rvs": ["sigma"]},
], ids=["jitter", "jitter_rvs", "adapt_diag", "override_and_jitter_rvs"])
def test_initial_points_match_jax_bitwise(pair, options):
    jm = pair.jax("linear_regression", **options)._make_model(0)
    ref = [np.asarray(jm.initial_position(jax.random.key(k), jnp.zeros(4))) for k in range(3)]
    tm = pair.port("linear_regression", **options)._make_model(0)
    keys = torch.as_tensor(np.stack([_key_data(k) for k in range(3)]).astype(np.int64))
    got = tm.initial_position(keys, torch.zeros(4, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(got, np.stack(ref))
    if "adapt_diag" in str(options):
        np.testing.assert_array_equal(got[0], got[1])
        assert abs(got[0, 3] - math.log(2.0)) < 1e-12


@pytest.mark.parametrize("case", CASES)
def test_expand_and_metadata_match_jax(pair, case):
    jc = pair.jax(case)
    jm = jc._make_model(0)
    x = _points(jm.ndim, seed=2)
    ref = {k: np.asarray(v) for k, v in jax.vmap(jm.expand_fn)(jnp.asarray(x)).items()}
    tc = pair.port(case)
    tm = tc._make_model(0)
    got = tm.expand_fn(torch.as_tensor(x))
    # (jax.vmap returns the dict's keys sorted)
    assert list(got) == [v.name for v in tm.expanded_variables] and set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r, rtol=RTOL, atol=ATOL, err_msg=name)
    meta = lambda m: [(v.name, v.shape, tuple(v.dims), v.start_idx, v.end_idx)
                      for v in (*m.expanded_variables, *m.param_variables)]
    assert meta(tm) == meta(jm)
    assert tm.coords == jm.coords and tm.dim_sizes == jm.dim_sizes
    assert tm.reparameterized_names == jm.reparameterized_names
    assert tm.unconstrained_labels == jm.unconstrained_labels
    assert tc.n_dim == jc.n_dim and tc.dims == jc.dims and tc.coords == jc.coords
    if case == "partial_dims":
        assert tm.expanded_variables[0].dims == ("row", "m_dim_1")


def test_with_data_swap_shape_error_and_fortran_order(pair):
    _, X, y, _ = fake_pymc.linear_regression_model()
    y2 = X @ np.array([2.0, 2.0, 2.0]) + 0.3 * np.random.default_rng(7).standard_normal(len(y))
    x = _points(4, seed=3)
    jl = np.asarray(jax.vmap(pair.jax("linear_regression").with_data(y=y2)._make_model(0)
                             .logp_fn)(jnp.asarray(x)))
    compiled = pair.port("linear_regression")
    lt = compiled.with_data(y=y2)._make_model(0).logp_fn(torch.as_tensor(x))
    np.testing.assert_allclose(lt.numpy(), jl, rtol=RTOL, atol=ATOL)
    lf = pair.port("linear_regression").with_data(
        X=np.asfortranarray(X), y=y2)._make_model(0).logp_fn(torch.as_tensor(x))
    np.testing.assert_array_equal(lf.numpy(), lt.numpy())
    with pytest.raises(ValueError, match="shape"):
        compiled.with_data(y=np.zeros(3))._make_model(0)


def test_freeze_after_with_data(pair):
    """The overrides apply before freezing: the swapped data are live in
    the compiled log density, and the frozen model keeps its data when the
    model's data change after it was made."""
    x = torch.zeros(1, 4, dtype=torch.float64)
    compiled = pair.port("linear_regression", freeze_model=True)
    _, _, y, _ = torch_fake_pymc.linear_regression_model()
    made = compiled._make_model(0)
    l_orig = float(made.logp_fn(x))
    l_swapped = float(compiled.with_data(y=y * 2)._make_model(0).logp_fn(x))
    assert compiled._model._frozen
    assert l_swapped != l_orig
    assert float(made.logp_fn(x)) == l_orig
    jc = pair.jax("linear_regression", freeze_model=True)
    jl = float(jc.with_data(y=y * 2)._make_model(0).logp_fn(jnp.zeros(4)))
    np.testing.assert_allclose(l_swapped, jl, rtol=RTOL)


def test_var_names_match_jax(pair):
    for var_names in (["beta"], ["beta", "sigma"]):
        jm = pair.jax("linear_regression", var_names=var_names)._make_model(0)
        tm = pair.port("linear_regression", var_names=var_names)._make_model(0)
        assert [v.name for v in tm.expanded_variables] == var_names
        assert [v.name for v in tm.expanded_variables] == [v.name for v in jm.expanded_variables]
        assert tm.reparameterized_names == jm.reparameterized_names


def test_float32_evaluates_the_float64_graph(pair):
    """A float32 point meets the float64 graph: the port casts it in and the
    results out, within float32 rounding of the JAX frontend's float64
    values (JAX promotes a float32 point against float64 data the same
    way); the gradient is float32."""
    jm = pair.jax("linear_regression")._make_model(0)
    x = _points(4, seed=4).astype(np.float32)
    lj, gj = jax.vmap(jm.logp_and_grad)(jnp.asarray(x, jnp.float64))
    tm = pair.port("linear_regression")._make_model(0)
    lt, gt = tm.logp_and_grad(torch.as_tensor(x))
    assert lt.dtype == gt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-5)
    expanded = tm.expand_fn(torch.as_tensor(x))
    assert all(v.dtype == torch.float32 for v in expanded.values())


def test_option_validation(pair):
    model = torch_fake_pymc.linear_regression_model()[0]
    pair.port("linear_regression")  # installs the torch stand-in
    for backend in ("jax", "numba"):
        with pytest.raises(ValueError, match=f"backend='{backend}'"):
            nutpie_tpu_torch.compile_pymc_model(model, backend=backend)
    with pytest.raises(ValueError, match="strategy"):
        nutpie_tpu_torch.compile_pymc_model(model, default_initialization_strategy="nope")
    with pytest.raises(ValueError, match="gradient_backend"):
        nutpie_tpu_torch.compile_pymc_model(model, gradient_backend="jax")


def test_requires_pymc():
    with pytest.raises(ImportError, match="pymc"):
        nutpie_tpu_torch.compile_pymc_model(object())


def test_zero_size_variable_samples(pair):
    tr = nutpie_tpu_torch.sample(pair.port("zero_size"), chains=2, tune=30, draws=20, seed=0,
                                 device="cpu", progress_bar=False)
    assert np.asarray(tr.posterior["a"].values).shape == (2, 20, 0)
    assert np.isfinite(np.asarray(tr.posterior["b"].values)).all()


RUN = dict(chains=2, tune=100, draws=100, seed=3, chunk_size=16, progress_bar=False,
           store_unconstrained=True)


def test_sample_trace_matches_jax(pair):
    ref = nutpie_tpu.sample(pair.jax("linear_regression"), **RUN)
    port = nutpie_tpu_torch.sample(pair.port("linear_regression"), device="cpu", **RUN)
    groups = set(ref.groups) if not hasattr(ref, "children") else set(ref.children)
    got = set(port.groups) if not hasattr(port, "children") else set(port.children)
    assert got == groups
    for group in groups:
        p, r = port[group], ref[group]
        assert set(p.data_vars) == set(r.data_vars), group
        for name in r.data_vars:
            assert p[name].shape == r[name].shape, (group, name)
            assert p[name].dtype == r[name].dtype, (group, name)
            assert tuple(p[name].dims) == tuple(r[name].dims), (group, name)
    L = RUN["chunk_size"]
    np.testing.assert_array_equal(port.warmup_sample_stats["n_steps"].values[:, :L],
                                  ref.warmup_sample_stats["n_steps"].values[:, :L])
    for name in ("beta", "sigma", "mu"):
        np.testing.assert_allclose(port.warmup_posterior[name].values[:, :L],
                                   ref.warmup_posterior[name].values[:, :L], rtol=1e-8,
                                   atol=1e-10, err_msg=name)
        a, b = np.asarray(port.posterior[name].values), np.asarray(ref.posterior[name].values)
        mcse2 = np.var(a, axis=(0, 1)) / ess(a) + np.var(b, axis=(0, 1)) / ess(b)
        gap = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
        assert np.all(gap <= 5.0 * np.sqrt(mcse2)), (name, gap, np.sqrt(mcse2))
