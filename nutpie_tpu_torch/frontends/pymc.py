"""PyMC frontend: compile a PyMC model to the port's batched torch ABI.

The port of ``nutpie_tpu/frontends/pymc.py``.  Where the JAX package lowers
the PyTensor graph with PyTensor's JAX linker, this one lowers it with
PyTensor's PyTorch linker (``get_mode("PYTORCH")``, its rewriter, then
``pytensor.link.pytorch.dispatch.pytorch_funcify``).  The lowered function
is written for one point; ``torch.func.vmap`` batches it over chains, as
the Stan interpreter is batched (``frontends/stan/api.py``), so on the card
the step runner captures it in its CUDA graphs around K2.

The linker builds the graph's constants (frozen data, ``pm.Data`` values)
as tensors when it lowers the graph.  The graph is therefore lowered once
per device, at its first evaluation there, under that device as the
default, so its constants are built on the device the run uses and the
captured log density makes no host copy.  The graph computes in its own
dtype (PyTensor's ``floatX``, float64 by default): the inputs are cast to
their variables' dtype and the outputs to the evaluation's, so a float32
run evaluates a float64 graph as the JAX frontend's does under x64.

Mirrored semantics:
- the flat unconstrained vector joining every value variable in order
- ``gradient_backend``: ``"pytorch"`` (autograd through the lowered log
  density, the counterpart of the JAX package's ``"jax"``) or
  ``"pytensor"`` (PyTensor's gradient graph lowered with the log density)
- the expand function (constrained variables and deterministics), dims,
  coords and the reparameterized names
- seeded jittered initial points (``initial_points``, ``jitter_rvs``,
  ``default_initialization_strategy``)
- ``with_data`` applied before ``freeze_model`` freezes the model

Requires ``pymc`` and ``pytensor`` (not bundled): ``compile_pymc_model``
raises ImportError without them; this module imports without them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from ..model import CompiledModel, ModelDef, make_model
from ..ops import threefry


def _flat_jitter_mask(order, sizes, offsets, ndim, jitter_value_names,
                      enable=True):
    """0/1 mask over the flat unconstrained vector selecting the value-var
    slices that receive U(-1,1) init jitter (reference semantics:
    ``jitter_rvs`` limits jitter to those RVs; ``adapt_diag`` strategy
    disables it entirely).  Pure numpy -- unit-testable without pymc."""
    mask = np.zeros(ndim)
    if not enable:
        return mask
    for name in order:
        if jitter_value_names is None or name in jitter_value_names:
            mask[offsets[name] : offsets[name] + sizes[name]] = 1.0
    return mask


def _require_pymc():
    try:
        import pymc  # noqa: F401
        import pytensor  # noqa: F401
    except ImportError as err:
        raise ImportError(
            "compile_pymc_model requires pymc and pytensor to be installed"
        ) from err


def _torchify(inputs, outputs, device):
    """Lower a PyTensor graph to a torch callable of one point, its
    constants built on ``device``."""
    from pytensor.compile.mode import get_mode
    from pytensor.graph.fg import FunctionGraph
    from pytensor.graph.rewriting.basic import GraphRewriter
    from pytensor.link.pytorch.dispatch import pytorch_funcify

    mode = get_mode("PYTORCH")
    graph = FunctionGraph(inputs=inputs, outputs=list(outputs), clone=True)
    rewriter = mode.optimizer
    if isinstance(rewriter, GraphRewriter):
        rewriter.rewrite(graph)
    else:
        rewriter(graph)
    with torch.device(device):
        return pytorch_funcify(graph)


class _Lowered:
    """A graph lowered once per device, at its first evaluation there;
    called with the per-point inputs batched over a leading chains axis,
    each cast to its input variable's dtype (the graph's ``floatX``)."""

    def __init__(self, inputs, outputs):
        self.inputs, self.outputs = list(inputs), list(outputs)
        self.dtypes = [getattr(torch, str(v.dtype)) for v in self.inputs]
        self.by_device: dict = {}

    def __call__(self, parts: list) -> list:
        device = parts[0].device
        fn = self.by_device.get(device)
        if fn is None:
            fn = self.by_device[device] = _torchify(self.inputs, self.outputs, device)
        parts = [p.to(dtype) for p, dtype in zip(parts, self.dtypes)]
        return list(vmap(lambda *p: tuple(fn(*p)))(*parts))


@dataclasses.dataclass(frozen=True)
class CompiledPyMCModel(CompiledModel):
    """Compiled PyMC model (PyTorch backend)."""

    _model: Any = None
    _var_names: Optional[tuple] = None
    _gradient_backend: str = "pytorch"
    _shared_overrides: dict = dataclasses.field(default_factory=dict)
    _jitter_scale: float = 1.0
    _transform_adapt_args: dict = dataclasses.field(default_factory=dict)
    # freeze_dims_and_data is applied at _make_model time, AFTER the
    # with_data overrides: freezing first turns pm.Data into constants that
    # pm.set_data can no longer update
    _freeze: bool = True
    _initial_points: Optional[dict] = None
    _jitter_names: Optional[tuple] = None  # None = jitter all free RVs
    _init_strategy: str = "jitter+adapt_diag"

    def __post_init__(self):
        object.__setattr__(self, "coords", dict(self._model.coords))
        dims = {
            name: tuple(d)
            for name, d in getattr(self._model, "named_vars_to_dims", {}).items()
        }
        object.__setattr__(self, "dims", dims)

    @property
    def n_dim(self) -> int:
        ip = self._model.initial_point(random_seed=0)
        return int(sum(np.asarray(v).size for v in ip.values()))

    def with_data(self, **updates: Any) -> "CompiledPyMCModel":
        """Return a copy with shared (pm.Data) variables replaced.

        Shape validation happens when pm.set_data applies the overrides at
        ``_make_model`` time.
        """
        merged = dict(self._shared_overrides)
        for key, value in updates.items():
            merged[key] = np.asarray(value)
        return dataclasses.replace(self, _shared_overrides=merged)

    def _make_model(self, seed: int) -> ModelDef:
        import pymc as pm
        from pymc.initial_point import make_initial_point_fn
        from pymc.util import get_default_varnames

        model = self._model
        if self._shared_overrides:
            with model:
                pm.set_data(dict(self._shared_overrides), model=model)
        if self._freeze:
            from pymc.model.transform.optimization import freeze_dims_and_data

            model = freeze_dims_and_data(model)

        value_vars = list(model.value_vars)
        ip = model.initial_point(random_seed=seed)
        order = [v.name for v in value_vars]
        shapes = {name: np.asarray(ip[name]).shape for name in order}
        sizes = {name: int(np.prod(shapes[name], dtype=int)) for name in order}
        ndim = sum(sizes.values())
        offsets = {}
        off = 0
        for name in order:
            offsets[name] = off
            off += sizes[name]

        def split(x):
            return [x[:, offsets[n]: offsets[n] + sizes[n]].reshape((x.shape[0],) + shapes[n])
                    for n in order]

        # ---- logp (+grad by autograd) on the flat vector, batched
        logp_graph = model.logp(jacobian=True, sum=True)
        logp_parts = _Lowered(value_vars, [logp_graph])

        def logp_fn(x):
            (out,) = logp_parts(split(x))
            return out.to(x.dtype)

        logp_fn.__qualname__ = "pymc_logp"

        # gradient_backend="pytensor": the gradient graph derived in
        # PyTensor (its rewrites see the original graph) and lowered with
        # the log density; "pytorch" differentiates the lowered logp
        logp_grad_fn = None
        if self._gradient_backend == "pytensor":
            import pytensor.tensor as pt

            grad_graphs = pt.grad(logp_graph, value_vars)
            both_parts = _Lowered(value_vars, [logp_graph, *grad_graphs])

            def logp_grad_fn(x):
                outs = both_parts(split(x))
                grad = torch.cat([g.reshape(x.shape[0], -1).to(x.dtype) for g in outs[1:]],
                                 dim=1)
                return outs[0].to(x.dtype).detach(), grad.detach()

        # ---- expand: constrained RVs + deterministics
        vars_to_sample = list(
            get_default_varnames(model.unobserved_value_vars, include_transformed=False)
        )
        if self._var_names is not None:
            keep = set(self._var_names)
            vars_to_sample = [v for v in vars_to_sample if v.name in keep]
        expand_parts = _Lowered(value_vars, vars_to_sample)
        expand_names = [v.name for v in vars_to_sample]

        def expand_fn(x):
            outs = expand_parts(split(x)) if expand_names else []
            return {name: out.to(x.dtype) for name, out in zip(expand_names, outs)}

        # expanded shapes from one evaluation at the initial point, on the host
        flat_ip = np.concatenate(
            [np.asarray(ip[name], np.float64).ravel() for name in order]
        ) if ndim else np.zeros(0)
        probe = expand_fn(torch.as_tensor(flat_ip)[None])
        dims_lookup = dict(self.dims)

        def _guard_dims(name, shape):
            # rank-mismatched dims fall back to auto-generated names
            dims = dims_lookup.get(name)
            if dims is not None and len(dims) != len(shape):
                return None
            return dims

        expanded_vars = [
            (name, np.dtype(np.float64), tuple(probe[name].shape[1:]),
             _guard_dims(name, tuple(probe[name].shape[1:])))
            for name in expand_names
        ]
        param_vars = []
        reparameterized = []
        for name in order:
            param_vars.append((name, np.dtype(np.float64), shapes[name],
                               _guard_dims(name, shapes[name])))
            if name not in expand_names:
                reparameterized.append(name)

        # ---- initial point function: pymc's seeded init (+ user
        # initial_points overrides) with per-RV jitter control
        overrides = None
        if self._initial_points is not None:
            overrides = {
                rv: self._initial_points[rv.name]
                for rv in model.free_RVs
                if rv.name in self._initial_points
            }
        ipfn = make_initial_point_fn(
            model=model,
            jitter_rvs=set(),
            overrides=overrides,
            return_transformed=True,
        )
        base_point = ipfn(seed)
        base_flat = np.concatenate(
            [np.asarray(base_point[name], np.float64).ravel() for name in order]
        ) if ndim else np.zeros(0)
        # map requested jitter RV names (untransformed) to value-var slices
        rv_to_value = {rv.name: value.name for rv, value in zip(model.free_RVs, model.value_vars)}
        jitter_value_names = (
            None if self._jitter_names is None
            else {rv_to_value.get(n, n) for n in self._jitter_names}
        )
        jitter_mask = _flat_jitter_mask(
            order, sizes, offsets, ndim, jitter_value_names,
            enable=self._init_strategy.startswith("jitter"),
        )
        jitter_scale = self._jitter_scale

        def init_point_fn(key_data, init_mean):
            dtype, device = init_mean.dtype, init_mean.device
            jitter = threefry.uniform(key_data, (ndim,), dtype, -jitter_scale, jitter_scale)
            base = torch.as_tensor(base_flat, dtype=dtype, device=device)
            mask = torch.as_tensor(jitter_mask, dtype=dtype, device=device)
            return base + mask * jitter

        return make_model(
            ndim,
            logp_fn,
            expand_fn=expand_fn,
            expanded_vars=expanded_vars,
            param_vars=param_vars,
            coords={k: list(v) for k, v in model.coords.items() if v is not None},
            init_point_fn=init_point_fn,
            reparameterized_names=reparameterized,
            logp_grad_fn=logp_grad_fn,
        )


def compile_pymc_model(
    model,
    *,
    backend: str = "pytorch",
    gradient_backend: str = "pytorch",
    initial_points=None,
    jitter_rvs=None,
    var_names: Optional[Sequence[str]] = None,
    freeze_model: Optional[bool] = None,
    **kwargs,
) -> CompiledPyMCModel:
    """Compile a PyMC model for sampling (reference ``compile_pymc.py:523``).

    Only ``backend="pytorch"`` is supported: the PyTensor graph is lowered
    with PyTensor's PyTorch linker.  ``"jax"`` and ``"numba"`` raise.
    """
    _require_pymc()
    if backend not in ("pytorch", None):
        raise ValueError(
            f"nutpie_tpu_torch does not take backend={backend!r}: it only supports "
            "backend='pytorch' (the PyTensor graph is lowered with PyTensor's PyTorch "
            "linker and runs in the sampler's torch log density)"
        )
    if freeze_model is None:
        freeze_model = True
    strategy = kwargs.pop("default_initialization_strategy", "jitter+adapt_diag")
    if strategy not in ("jitter+adapt_diag", "adapt_diag"):
        raise ValueError(f"Unknown default_initialization_strategy: {strategy!r}")
    if gradient_backend not in ("pytorch", "pytensor", None):
        raise ValueError(f"Unknown gradient_backend: {gradient_backend!r}")
    return CompiledPyMCModel(
        _model=model,
        _var_names=tuple(var_names) if var_names is not None else None,
        _gradient_backend=gradient_backend or "pytorch",
        _freeze=bool(freeze_model),
        _initial_points=dict(initial_points) if initial_points else None,
        _jitter_names=(
            tuple(rv if isinstance(rv, str) else rv.name for rv in jitter_rvs)
            if jitter_rvs is not None else None
        ),
        _init_strategy=strategy,
    )
