"""Public Stan frontend API, mirroring the reference's compile_stan.py."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import torch
from torch.func import vmap

from ...model import CompiledModel, ModelDef, make_model
from . import xp
from .errors import StanRuntimeError
from .functionals import solver_calls
from .interpreter import StanInterpreter
from .parser import parse


def _batched_logp(interp: StanInterpreter):
    """``x [C, dim] -> [C]``: the per-chain log density under vmap, in the
    dtype and on the device of ``x``."""

    def logp(x: torch.Tensor) -> torch.Tensor:
        with xp.evaluation(x.dtype, x.device, interp.device_cache(x.device, x.dtype)):
            return vmap(interp.logp)(x)

    logp.__qualname__ = "stan_logp"
    return logp


def _batched_expand(interp: StanInterpreter):
    """``(x [N, dim], keys [N, 2] or None) -> dict[name, [N, ...]]``."""

    def expand(x: torch.Tensor, keys: Optional[torch.Tensor] = None) -> dict:
        with xp.evaluation(x.dtype, x.device, interp.device_cache(x.device, x.dtype)):
            if keys is None:
                return vmap(interp.expand)(x)
            return vmap(interp.expand)(x, keys)

    return expand


@dataclasses.dataclass(frozen=True)
class CompiledStanModel(CompiledModel):
    """A parsed Stan model, optionally bound to data.

    Mirrors the reference's ``CompiledStanModel`` (``compile_stan.py:27-101``):
    ``with_data`` binds/replaces the data, ``with_coords``/``with_dims``
    attach trace metadata.  Instead of holding a dlopened C++ library the
    model holds the parsed AST; binding data resolves shapes and constraint
    transforms and yields batched torch logp/expand functions.  A program
    whose log density calls a solver that loops until the data say stop
    (an ODE, DAE or algebraic solver: ``functionals.solver_calls``) gets a
    model marked ``eager_logp``, which the runners call eagerly around
    their kernels (K2 under NUTS, K3 under MCLMC, with or without flow)
    instead of capturing it in a CUDA graph.
    """

    code: str = ""
    _data: Optional[dict] = None
    _data_seed: int = 0
    _dims: dict = dataclasses.field(default_factory=dict)
    _coords: dict = dataclasses.field(default_factory=dict)
    model_name: str = "model"
    _transform_adapt_args: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "coords", dict(self._coords))
        object.__setattr__(self, "dims", dict(self._dims))
        object.__setattr__(self, "_program", parse(self.code))

    def with_data(self, *, seed=None, **data: Any) -> "CompiledStanModel":
        return dataclasses.replace(
            self, _data=dict(data), _data_seed=int(seed or 0)
        )

    def with_coords(self, **coords: Any) -> "CompiledStanModel":
        merged = dict(self._coords)
        merged.update(coords)
        return dataclasses.replace(self, _coords=merged)

    def with_dims(self, **dims: Any) -> "CompiledStanModel":
        merged = dict(self._dims)
        merged.update(dims)
        return dataclasses.replace(self, _dims=merged)

    def _interpreter(self) -> StanInterpreter:
        data = self._data
        if data is None:
            # models without a data block can sample immediately
            if self._program.data:
                missing = ", ".join(d.name for d in self._program.data)
                raise StanRuntimeError(
                    f"Model data was not provided (missing: {missing}); "
                    f"call .with_data(...)"
                )
            data = {}
        return StanInterpreter(self._program, data, seed=self._data_seed)

    @property
    def n_dim(self) -> int:
        return self._interpreter().ndim

    @property
    def shapes(self):
        interp = self._interpreter()
        return {name: shape for name, _, shape, _ in interp.output_variables()}

    def _make_model(self, seed: int) -> ModelDef:
        # the model is seed-independent; memoize so repeated sample() calls
        # reuse the same ModelDef and with it the data it holds on each
        # device, once per (device, dtype) (StanInterpreter.device_cache)
        cached = getattr(self, "_model_def_cache", None)
        if cached is not None:
            return cached
        interp = self._interpreter()
        expanded_vars = [
            (name, dtype, shape, self._dims.get(name))
            for name, dtype, shape, _ in interp.output_variables()
        ]
        model = make_model(
            interp.ndim,
            _batched_logp(interp),
            expand_fn=_batched_expand(interp),
            expand_needs_rng=interp.uses_gq_rng,
            expanded_vars=expanded_vars,
            param_vars=interp.param_variables(),
            coords=self._coords,
            eager_logp=bool(solver_calls(self._program)),
        )
        object.__setattr__(self, "_model_def_cache", model)
        return model


def compile_stan_model(
    code: Optional[str] = None,
    *,
    filename: Optional[str] = None,
    extra_compile_args: Optional[list] = None,
    extra_stanc_args: Optional[list] = None,
    dims: Optional[dict] = None,
    coords: Optional[dict] = None,
    model_name: Optional[str] = None,
    cleanup: bool = True,
    cache: bool = True,
    prune_cache: bool = True,
) -> CompiledStanModel:
    """Compile a Stan model to torch (reference ``compile_stan.py:250-386``).

    ``extra_compile_args``/``extra_stanc_args``/``cleanup``/``cache`` are
    accepted for API compatibility; there is no C++ toolchain involved
    (the parse takes milliseconds), so they are no-ops.
    """
    if code is None and filename is None:
        raise ValueError("Either code or filename must be provided")
    if code is None:
        code = Path(filename).read_text()
    if model_name is None:
        model_name = Path(filename).stem if filename else "model"
    # parses eagerly, so syntax errors surface here
    return CompiledStanModel(
        code=code,
        _dims=dict(dims or {}),
        _coords=dict(coords or {}),
        model_name=model_name,
    )


def prune_stan_cache() -> None:
    """No-op: the Stan compiler keeps no on-disk artifact cache.

    (The reference prunes its BridgeStan .so cache,
    ``compile_stan.py:151-224``; here compilation is instant.)
    """
