"""Generic Python-function frontend.

Analog of the reference's pyfunc backend
(``python/nutpie/compiled_pyfunc.py:108-155``): the user provides factory
functions returning a log density and optionally an expand function.  Here
both are batched torch callables: ``logp_fn(x[C, ndim]) -> [C]`` and
``expand_fn(x[N, ndim]) -> dict[name, [N, *shape]]``.  Such a model
samples on the card through the step kernel: each leapfrog evaluates
``logp_fn`` once over all chains, takes the gradient with autograd, and
hands both to the kernel.  On the CPU (``device="cpu"``) the same steps
run the kernel's plain version.

The log density runs where the chains are, so every constant it uses
must follow ``x.device`` and ``x.dtype``: build data tensors once per
device and dtype (for example in a dict keyed by ``(x.device,
x.dtype)``) rather than converting numpy arrays inside each call.  Rows
of ``x`` are chains and must not be mixed: row ``i`` of the result may
depend on row ``i`` of ``x`` only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..model import CompiledModel, ModelDef, make_model


@dataclasses.dataclass(frozen=True)
class PyFuncModel(CompiledModel):
    """Compiled model wrapping user-supplied torch functions."""

    _ndim: int = 0
    _make_logp_fn: Callable = None
    _make_expand_fn: Optional[Callable] = None
    _make_initial_point_fn: Optional[Callable] = None
    _expanded_vars: tuple = ()
    _param_vars: Optional[tuple] = None
    _coords: dict = dataclasses.field(default_factory=dict)
    _dims: dict = dataclasses.field(default_factory=dict)
    _shared_data: dict = dataclasses.field(default_factory=dict)
    _transform_adapt_args: dict = dataclasses.field(default_factory=dict)
    _reparameterized_names: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "coords", dict(self._coords))
        object.__setattr__(self, "dims", dict(self._dims))

    @property
    def n_dim(self) -> int:
        return self._ndim

    @property
    def shapes(self):
        return {name: tuple(shape) for name, _, shape, _ in self._expanded_vars}

    def with_data(self, **updates: Any) -> "PyFuncModel":
        """Swap shared data (same shapes) passed to the factory functions."""
        shared = dict(self._shared_data)
        for key, value in updates.items():
            if key not in shared:
                raise KeyError(f"Unknown shared data variable: {key}")
            old = np.asarray(shared[key])
            new = np.asarray(value)
            if old.shape != new.shape:
                raise ValueError(
                    f"Shared variable {key} has shape {old.shape}, "
                    f"got {new.shape}"
                )
            shared[key] = new
        return dataclasses.replace(self, _shared_data=shared)

    def _make_model(self, seed: int) -> ModelDef:
        kwargs = dict(self._shared_data)

        def build(factory):
            if factory is None:
                return None
            return factory(**kwargs) if kwargs else factory()

        return make_model(
            self._ndim,
            build(self._make_logp_fn),
            expand_fn=build(self._make_expand_fn),
            expanded_vars=list(self._expanded_vars) or None,
            param_vars=list(self._param_vars) if self._param_vars else None,
            coords=self._coords,
            init_point_fn=build(self._make_initial_point_fn),
            reparameterized_names=self._reparameterized_names,
        )


def from_pyfunc(
    ndim: int,
    make_logp_fn: Callable,
    make_expand_fn: Optional[Callable] = None,
    expanded_dtypes: Optional[Sequence] = None,
    expanded_shapes: Optional[Sequence] = None,
    expanded_names: Optional[Sequence[str]] = None,
    *,
    coords: Optional[dict] = None,
    dims: Optional[dict] = None,
    shared_data: Optional[dict] = None,
    make_initial_point_fn: Optional[Callable] = None,
    raw_logp_fn: Optional[Callable] = None,
    reparameterized_names: Optional[Sequence[str]] = None,
    param_vars: Optional[Sequence] = None,
) -> PyFuncModel:
    """Build a compiled model from batched torch functions.

    Signature mirrors the reference (``compiled_pyfunc.py:108-155``):
    ``make_logp_fn(**shared_data)`` returns ``x[C, ndim] -> [C]``, whose
    constants follow ``x.device`` and ``x.dtype`` (see the module note);
    ``make_expand_fn(**shared_data)`` returns ``x[N, ndim] -> dict`` whose
    outputs match ``expanded_names/shapes/dtypes``; ``raw_logp_fn`` is
    accepted for compatibility and unused.
    """
    dims = dict(dims or {})
    expanded_vars = []
    if expanded_names is not None:
        if expanded_shapes is None or expanded_dtypes is None:
            raise ValueError(
                "expanded_names requires expanded_shapes and expanded_dtypes"
            )
        for name, dtype, shape in zip(expanded_names, expanded_dtypes, expanded_shapes):
            expanded_vars.append(
                (name, np.dtype(dtype), tuple(shape), dims.get(name))
            )
    return PyFuncModel(
        _ndim=ndim,
        _make_logp_fn=make_logp_fn,
        _make_expand_fn=make_expand_fn,
        _make_initial_point_fn=make_initial_point_fn,
        _expanded_vars=tuple(expanded_vars),
        _param_vars=tuple(param_vars) if param_vars else None,
        _coords=dict(coords or {}),
        _dims=dims,
        _shared_data=dict(shared_data or {}),
        _reparameterized_names=tuple(reparameterized_names or ()),
    )


@dataclasses.dataclass(frozen=True)
class CompiledModelDef(CompiledModel):
    """Adapter exposing a raw :class:`ModelDef` as a CompiledModel."""

    model_def: ModelDef = None
    _transform_adapt_args: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "coords", dict(self.model_def.coords))
        object.__setattr__(
            self,
            "dims",
            {v.name: tuple(v.dims or ()) for v in self.model_def.expanded_variables},
        )

    @property
    def n_dim(self) -> int:
        return self.model_def.ndim

    def _make_model(self, seed: int) -> ModelDef:
        return self.model_def


def compile_model_def(model_def: ModelDef) -> CompiledModelDef:
    return CompiledModelDef(model_def=model_def)
