"""Minimal pymc/pytensor stand-ins driving ``nutpie_tpu_torch/frontends/pymc.py``.

pymc and pytensor are installed neither here nor on the card's host, so
the port's PyMC frontend would otherwise never run.  This module mirrors
``tests/fake_pymc.py``'s API surface with its graphs computed in torch
(no JAX here, so the card's script can load it): a graph node's
``compute(env, consts)`` is plain torch on one point, and the PyTorch
linker's ``pytorch_funcify`` builds each node's constants (the model's
data) as tensors when it lowers the graph, with ``torch.as_tensor`` as
PyTensor's ``pytorch_typify`` does, so they land on the default device of
the lowering.  ``pytensor.tensor.grad`` gives nodes that differentiate the
cost with ``torch.func.grad``, which composes with ``vmap``.  Install with
:func:`install`; build fixture models with :func:`linear_regression_model`
and :func:`radon_model`.

This is a test fixture, not a PyMC reimplementation: anything the frontend
does not call is absent.
"""

from __future__ import annotations

import copy
import math
import sys
import types

import numpy as np
import torch


class Var:
    """A graph node: inputs have no compute; outputs map (env, consts) ->
    value, ``consts`` being ``data`` as the linker built it."""

    def __init__(self, name, compute=None, data=None, dtype="float64"):
        self.name = name
        self.compute = compute
        self.data = data
        self.dtype = dtype

    def __repr__(self):
        return f"<Var {self.name}>"


# --------------------------------------------------------------- pytensor


def pytorch_typify(data):
    """A constant as the PyTorch linker builds it (on the default device)."""
    return torch.as_tensor(data)


def _make_pytensor_modules():
    pytensor = types.ModuleType("pytensor")
    compile_mod = types.ModuleType("pytensor.compile")
    mode_mod = types.ModuleType("pytensor.compile.mode")
    graph_mod = types.ModuleType("pytensor.graph")
    fg_mod = types.ModuleType("pytensor.graph.fg")
    rewr_mod = types.ModuleType("pytensor.graph.rewriting")
    rewr_basic = types.ModuleType("pytensor.graph.rewriting.basic")
    link_mod = types.ModuleType("pytensor.link")
    link_torch = types.ModuleType("pytensor.link.pytorch")
    dispatch_mod = types.ModuleType("pytensor.link.pytorch.dispatch")
    tensor_mod = types.ModuleType("pytensor.tensor")

    class FunctionGraph:
        def __init__(self, inputs, outputs, clone=True):
            self.inputs = list(inputs)
            self.outputs = list(outputs)

    class GraphRewriter:
        pass

    class _Mode:
        # a plain callable (not a GraphRewriter), exercising the
        # `rewriter(graph)` branch of _torchify
        optimizer = staticmethod(lambda graph: None)

    def get_mode(name):
        assert name == "PYTORCH"
        return _Mode()

    def pytorch_funcify(graph):
        names = [v.name for v in graph.inputs]
        outs = graph.outputs
        consts = [{k: pytorch_typify(v) for k, v in (o.data or {}).items()} for o in outs]

        def fn(*vals):
            env = dict(zip(names, vals))
            return [o.compute(env, c) for o, c in zip(outs, consts)]

        return fn

    def grad(cost, wrt):
        def make(name):
            def compute(env, consts):
                keys = list(env.keys())

                def as_fn(*a):
                    return cost.compute(dict(zip(keys, a)), consts)

                return torch.func.grad(as_fn, argnums=keys.index(name))(
                    *[env[k] for k in keys])

            return Var(name + "_grad", compute, data=cost.data)

        return [make(v.name) for v in wrt]

    fg_mod.FunctionGraph = FunctionGraph
    rewr_basic.GraphRewriter = GraphRewriter
    mode_mod.get_mode = get_mode
    dispatch_mod.pytorch_funcify = pytorch_funcify
    dispatch_mod.pytorch_typify = pytorch_typify
    tensor_mod.grad = grad
    pytensor.compile = compile_mod
    compile_mod.mode = mode_mod
    pytensor.graph = graph_mod
    graph_mod.fg = fg_mod
    graph_mod.rewriting = rewr_mod
    rewr_mod.basic = rewr_basic
    pytensor.link = link_mod
    link_mod.pytorch = link_torch
    link_torch.dispatch = dispatch_mod
    pytensor.tensor = tensor_mod
    return {
        "pytensor": pytensor,
        "pytensor.compile": compile_mod,
        "pytensor.compile.mode": mode_mod,
        "pytensor.graph": graph_mod,
        "pytensor.graph.fg": fg_mod,
        "pytensor.graph.rewriting": rewr_mod,
        "pytensor.graph.rewriting.basic": rewr_basic,
        "pytensor.link": link_mod,
        "pytensor.link.pytorch": link_torch,
        "pytensor.link.pytorch.dispatch": dispatch_mod,
        "pytensor.tensor": tensor_mod,
    }


# ------------------------------------------------------------------- pymc


class FakeModel:
    """What CompiledPyMCModel needs from a pm.Model.

    ``spec`` wires everything:
      value_vars: [(value_name, shape)]
      free_rvs: [rv_name] aligned with value_vars
      logp: (env, consts) -> scalar (torch; includes jacobian terms)
      outputs: [(name, (env, consts) -> value)] constrained RVs + deterministics
      initial: {value_name: np.ndarray} transformed-space initial point
      data: {name: np.ndarray} pm.Data values (swappable via set_data)
      coords / dims / override_transforms
    """

    def __init__(self, spec):
        self._spec = spec
        self.coords = dict(spec.get("coords", {}))
        self.named_vars_to_dims = dict(spec.get("dims", {}))
        self._data = {k: np.asarray(v) for k, v in spec.get("data", {}).items()}
        self.value_vars = [Var(n) for n, _ in spec["value_vars"]]
        self.free_RVs = [Var(n) for n in spec["free_rvs"]]
        self._frozen = False

    def initial_point(self, random_seed=0):
        return {k: np.asarray(v) for k, v in self._spec["initial"].items()}

    def logp(self, jacobian=True, sum=True):
        assert jacobian and sum
        return Var("__logp__", self._spec["logp"], data=self._data)

    @property
    def unobserved_value_vars(self):
        return [Var(name, fn, data=self._data) for name, fn in self._spec["outputs"]]

    # pm.set_data target
    def _set_data(self, updates):
        for key, value in updates.items():
            if key not in self._data:
                raise KeyError(f"unknown shared variable {key!r}")
            value = np.asarray(value)
            if value.shape != self._data[key].shape:
                raise ValueError(
                    f"shared variable {key!r} has shape "
                    f"{self._data[key].shape}, got {value.shape}"
                )
            self._data[key] = value

    # pm.Model context manager protocol (with model: pm.set_data(...))
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _make_pymc_modules():
    pm = types.ModuleType("pymc")
    init_mod = types.ModuleType("pymc.initial_point")
    util_mod = types.ModuleType("pymc.util")
    model_mod = types.ModuleType("pymc.model")
    transform_mod = types.ModuleType("pymc.model.transform")
    opt_mod = types.ModuleType("pymc.model.transform.optimization")

    def set_data(updates, model=None):
        model._set_data(updates)

    def freeze_dims_and_data(model):
        """A frozen copy whose data are constants: later ``set_data`` calls
        on the model leave it as it is (as pymc's returns a new model)."""
        model._frozen = True
        frozen = copy.copy(model)
        frozen._data = {k: np.array(v) for k, v in model._data.items()}
        return frozen

    def make_initial_point_fn(model, jitter_rvs, overrides, return_transformed):
        assert return_transformed
        spec = model._spec
        to_transformed = spec.get("override_transforms", {})

        def fn(seed):
            point = {k: np.asarray(v) for k, v in spec["initial"].items()}
            if overrides:
                for rv, value in overrides.items():
                    value_name, tf = to_transformed.get(rv.name, (rv.name, lambda v: v))
                    point[value_name] = np.asarray(tf(np.asarray(value)))
            return point

        return fn

    def get_default_varnames(var_iterator, include_transformed):
        assert not include_transformed
        return [v for v in var_iterator if not v.name.endswith("__")]

    pm.set_data = set_data
    pm.Model = FakeModel
    init_mod.make_initial_point_fn = make_initial_point_fn
    util_mod.get_default_varnames = get_default_varnames
    pm.initial_point = init_mod
    pm.util = util_mod
    pm.model = model_mod
    model_mod.transform = transform_mod
    transform_mod.optimization = opt_mod
    opt_mod.freeze_dims_and_data = freeze_dims_and_data
    return {
        "pymc": pm,
        "pymc.initial_point": init_mod,
        "pymc.util": util_mod,
        "pymc.model": model_mod,
        "pymc.model.transform": transform_mod,
        "pymc.model.transform.optimization": opt_mod,
    }


def install(monkeypatch=None):
    """Install the stand-ins into ``sys.modules`` (through ``monkeypatch``
    where given, else for the rest of the process), in place of any other
    stand-in (a module without a file).  Returns False, and installs
    nothing, where real pymc exists."""
    try:
        import pymc

        if getattr(pymc, "__file__", None) is not None:
            return False  # real pymc present; use it
    except ImportError:
        pass
    for name, mod in {**_make_pytensor_modules(), **_make_pymc_modules()}.items():
        if monkeypatch is None:
            sys.modules[name] = mod
        else:
            monkeypatch.setitem(sys.modules, name, mod)
    return True


# ----------------------------------------------------------- fixture models


def linear_regression_model(N=40, K=3, seed=0):
    """y ~ N(X beta, sigma); beta[K] (dims coef), sigma log-transformed,
    deterministic mu = X beta (dims obs): the data of
    ``fake_pymc.linear_regression_model`` from the same seed."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, K))
    true_beta = np.array([1.0, -0.5, 0.25])[:K]
    y = X @ true_beta + 0.3 * rng.standard_normal(N)

    def logp(env, data):
        beta, s = env["beta"], env["sigma_log__"]
        sigma = torch.exp(s)
        resid = data["y"] - data["X"] @ beta
        n = data["y"].shape[0]
        ll = -0.5 * torch.sum(resid ** 2) / sigma ** 2 - n * s - 0.5 * n * math.log(2 * math.pi)
        lp_beta = -0.5 * torch.sum(beta ** 2) / 100.0
        # HalfNormal(1) on sigma + log-jacobian of the exp transform
        lp_sigma = -0.5 * sigma ** 2 + s
        return ll + lp_beta + lp_sigma

    outputs = [
        ("beta", lambda env, data: env["beta"]),
        ("sigma", lambda env, data: torch.exp(env["sigma_log__"])),
        ("mu", lambda env, data: data["X"] @ env["beta"]),
    ]
    spec = dict(
        value_vars=[("beta", (K,)), ("sigma_log__", ())],
        free_rvs=["beta", "sigma"],
        logp=logp,
        outputs=outputs,
        initial={"beta": np.zeros(K), "sigma_log__": np.array(0.0)},
        data={"X": X, "y": y},
        coords={"coef": [f"b{i}" for i in range(K)], "obs": list(range(N))},
        dims={"beta": ("coef",), "mu": ("obs",)},
        override_transforms={
            "beta": ("beta", lambda v: v),
            "sigma": ("sigma_log__", lambda v: np.log(v)),
        },
    )
    return FakeModel(spec), X, y, true_beta


_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _normal(x, sigma):
    """log N(x | 0, sigma), summed."""
    return torch.sum(-0.5 * (x / sigma) ** 2 - math.log(sigma) - _HALF_LOG_2PI)


def _half_normal_log(s, sigma):
    """log HalfNormal(exp(s) | sigma) + s, the log transform's jacobian."""
    return math.log(2.0) - _HALF_LOG_2PI - math.log(sigma) - 0.5 * (torch.exp(s) / sigma) ** 2 + s


def radon_model(seed: int = 42):
    """Radon as PyMC writes it (``bench.py``'s model, the data of
    ``nutpie_tpu_torch.models.radon``): intercept ~ N(0, 10), county_raw
    and county_floor_raw ~ ZeroSumNormal(1) over the 85 counties, their
    HalfNormal(1) scales, floor_effect ~ N(0, 2), sigma ~ HalfNormal(1.5),
    the county effects as deterministics.  PyMC's value variables: the
    zero-sum effects (84 coordinates each, mapped to the 85 counties by
    ``models/radon.py``'s orthonormal basis of the sum-zero subspace, so
    the transform's jacobian is 0) and the ``*_log__`` scales, in the
    layout of ``models/radon.py``: its log density plus a constant.
    Returns the model and the county names."""
    from nutpie_tpu_torch.models.radon import _zero_sum_basis, simulate_radon_data

    y, county, floor_x, counties = simulate_radon_data(seed)
    J = len(counties)

    def effects(env, data):
        county_raw = data["basis"] @ env["county_raw_zerosum__"]
        cf_raw = data["basis"] @ env["county_floor_raw_zerosum__"]
        return (county_raw, cf_raw, county_raw * torch.exp(env["county_sd_log__"]),
                cf_raw * torch.exp(env["county_floor_sd_log__"]))

    def logp(env, data):
        county_raw, cf_raw, county_effect, cf_effect = effects(env, data)
        idx = data["county"]
        mu = (env["intercept"] + county_effect[idx] + env["floor_effect"] * data["floor"]
              + cf_effect[idx] * data["floor"])
        sigma = torch.exp(env["sigma_log__"])
        n = data["y"].shape[0]
        ll = (torch.sum(-0.5 * ((data["y"] - mu) / sigma) ** 2) - n * env["sigma_log__"]
              - n * _HALF_LOG_2PI)
        # ZeroSumNormal(1): a normal over the J - 1 free directions
        zsn = (-0.5 * torch.sum(county_raw ** 2) - 0.5 * torch.sum(cf_raw ** 2)
               - 2 * (J - 1) * _HALF_LOG_2PI)
        return (ll + zsn + _normal(env["intercept"], 10.0) + _normal(env["floor_effect"], 2.0)
                + _half_normal_log(env["county_sd_log__"], 1.0)
                + _half_normal_log(env["county_floor_sd_log__"], 1.0)
                + _half_normal_log(env["sigma_log__"], 1.5))

    outputs = [
        ("intercept", lambda env, data: env["intercept"]),
        ("county_raw", lambda env, data: effects(env, data)[0]),
        ("county_sd", lambda env, data: torch.exp(env["county_sd_log__"])),
        ("floor_effect", lambda env, data: env["floor_effect"]),
        ("county_floor_raw", lambda env, data: effects(env, data)[1]),
        ("county_floor_sd", lambda env, data: torch.exp(env["county_floor_sd_log__"])),
        ("sigma", lambda env, data: torch.exp(env["sigma_log__"])),
        ("county_effect", lambda env, data: effects(env, data)[2]),
        ("county_floor_effect", lambda env, data: effects(env, data)[3]),
    ]
    value_vars = [("intercept", ()), ("county_raw_zerosum__", (J - 1,)),
                  ("county_sd_log__", ()), ("floor_effect", ()),
                  ("county_floor_raw_zerosum__", (J - 1,)), ("county_floor_sd_log__", ()),
                  ("sigma_log__", ())]
    initial = {name: np.zeros(shape) for name, shape in value_vars}
    initial["sigma_log__"] = np.array(np.log(1.5))
    spec = dict(
        value_vars=value_vars,
        free_rvs=["intercept", "county_raw", "county_sd", "floor_effect", "county_floor_raw",
                  "county_floor_sd", "sigma"],
        logp=logp,
        outputs=outputs,
        initial=initial,
        data={"y": y, "county": county.astype(np.int64), "floor": floor_x,
              "basis": _zero_sum_basis(J)},
        coords={"county": list(counties)},
        dims={name: ("county",) for name in ("county_raw", "county_floor_raw", "county_effect",
                                             "county_floor_effect")},
    )
    return FakeModel(spec), counties
