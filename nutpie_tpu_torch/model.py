"""The model ABI: what the sampler core consumes.

A model is a batched torch log density: ``logp_fn(x: [C, dim]) -> [C]``,
one value per chain.  Its gradient comes from autograd over the whole
batch (``ModelDef.logp_and_grad``), so one call evaluates every chain.

Error protocol (as in ``nutpie_tpu/model.py``): a nonfinite logp or
gradient makes the trajectory's energy error nonfinite, which the NUTS
machine treats as a divergence and continues sampling.

``kernel_model`` names a device-side log density that the CUDA chunk
kernel can evaluate in place of ``logp_fn`` (``models/radon.py``).  Models
without one run on the card through the step kernel, which calls
``logp_and_grad`` once per leapfrog for every chain; such a logp must
keep its constants on ``x.device`` in ``x.dtype``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .ops import threefry
from .variables import Variable, resolve_variables, unconstrained_coord_labels


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A fully resolved model, ready for the sampler core.

    Attributes
    ----------
    ndim:
        Dimension of the unconstrained parameter vector.
    logp_fn:
        Batched ``x[C, ndim] -> [C]`` log density in torch.
    expand_fn:
        Batched ``x[N, ndim] -> dict[name, [N, *shape]]`` posterior
        expansion.  Defaults to slicing the flat vector into the parameter
        variables.
    expand_needs_rng:
        The expansion draws random numbers (a Stan program's generated
        quantities with ``_rng`` calls): ``expand_fn(x, keys[N, 2])`` then
        takes one Threefry key per row (``sample.expand_keys``).
    expanded_variables / param_variables:
        Metadata for the expanded outputs and the unconstrained slices.
    init_point_fn:
        Optional ``(key_data[C, 2], init_mean[ndim]) -> x[C, ndim]``.
        Defaults to ``init_mean + U(-2, 2)`` drawn with the key's Threefry
        stream, as ``jax.random.uniform`` draws it.
    logp_grad_fn:
        Optional batched ``x -> (logp, grad)`` override of the autograd
        gradient (a model with an analytic gradient installs it here).
    kernel_model:
        Device-side log density for the CUDA chunk kernel, or None.
    eager_logp:
        The log density reads the device to decide when to stop (a Stan
        program's ODE, DAE or algebraic solver), so no CUDA graph can hold
        it: the step runner calls it eagerly around K2 on the card, and
        the MCLMC runner around K3, under flow adaptation too.
    """

    ndim: int
    logp_fn: Callable[[torch.Tensor], torch.Tensor]
    expand_fn: Optional[Callable[[torch.Tensor], dict]] = None
    expand_needs_rng: bool = False
    expanded_variables: tuple[Variable, ...] = ()
    param_variables: tuple[Variable, ...] = ()
    dim_sizes: dict = dataclasses.field(default_factory=dict)
    coords: dict = dataclasses.field(default_factory=dict)
    init_point_fn: Optional[Callable] = None
    reparameterized_names: tuple[str, ...] = ()
    logp_grad_fn: Optional[Callable] = None
    kernel_model: Optional[Any] = None
    eager_logp: bool = False

    def __post_init__(self):
        if not self.param_variables:
            var = Variable(
                name="x",
                dtype=np.dtype(np.float64),
                shape=(self.ndim,),
                dims=("unconstrained_parameter",),
                start_idx=0,
                end_idx=self.ndim,
            )
            object.__setattr__(self, "param_variables", (var,))
        if self.expand_fn is None:
            params = self.param_variables
            object.__setattr__(
                self,
                "expand_fn",
                lambda x: {
                    v.name: x[:, v.start_idx : v.end_idx].reshape(
                        (x.shape[0],) + v.shape
                    )
                    for v in params
                },
            )
            if not self.expanded_variables:
                object.__setattr__(
                    self, "expanded_variables", tuple(self.param_variables)
                )

    @property
    def unconstrained_labels(self) -> list[str]:
        return unconstrained_coord_labels(self.param_variables)

    def logp_and_grad(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched ``(logp [C], grad [C, ndim])``, by default through autograd."""
        if self.logp_grad_fn is not None:
            return self.logp_grad_fn(x)
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            logp = self.logp_fn(xg)
            (grad,) = torch.autograd.grad(logp.sum(), xg)
        return logp.detach(), grad

    def initial_position(self, key_data: torch.Tensor,
                         init_mean: torch.Tensor) -> torch.Tensor:
        if self.init_point_fn is not None:
            return self.init_point_fn(key_data, init_mean)
        jitter = threefry.uniform(
            key_data, (self.ndim,), init_mean.dtype, -2.0, 2.0
        )
        return init_mean + jitter


class CompiledModel:
    """Base class for compiled models (reference ``sample.py:17-59``).

    Frontends subclass this; ``sample()`` consumes it via ``_make_model``.
    """

    dims: dict[str, tuple[str, ...]]
    coords: dict[str, Any]

    def __init__(self, dims=None, coords=None):
        self.dims = dict(dims or {})
        self.coords = dict(coords or {})

    @property
    def n_dim(self) -> int:
        raise NotImplementedError

    @property
    def shapes(self) -> Optional[dict[str, tuple[int, ...]]]:
        model = self._make_model(0)
        return {v.name: v.shape for v in model.expanded_variables}

    def _make_model(self, seed: int) -> ModelDef:
        raise NotImplementedError

    def with_data(self, **updates: Any) -> "CompiledModel":
        raise NotImplementedError(
            f"{type(self).__name__} does not support with_data"
        )

    def with_transform_adapt(self, **kwargs: Any) -> "CompiledModel":
        """A copy whose flow adaptation takes these ``FlowConfig`` options
        (``nutpie_tpu/model.py:147-155``; they win over the settings')."""
        merged = dict(getattr(self, "_transform_adapt_args", {}), **kwargs)
        if dataclasses.is_dataclass(self):
            return dataclasses.replace(self, _transform_adapt_args=merged)
        new = copy.copy(self)
        new._transform_adapt_args = merged
        return new

    def benchmark_logp(self, point, num_evals: int, cores: int | Sequence[int] = 1,
                       device="cuda"):
        """Time gradient evaluations (``nutpie_tpu/model.py:157-188``).

        On a GPU the counterpart of concurrent cores is the number of chains
        evaluated in one batched call, so ``cores`` is the batch size (a list
        is accepted).  Each batch is evaluated once untimed, then
        ``num_evals`` times between two synchronizations of ``device``, in
        the point's dtype (float64 for an integer point).
        Returns a pandas DataFrame (``batch``, ``time`` in seconds a call,
        ``evals_per_sec``) when pandas is available, else a dict of those
        columns.
        """
        device = torch.device(device)
        model = self._make_model(0)
        point = torch.as_tensor(np.asarray(point), device=device)
        if not point.is_floating_point():
            point = point.to(torch.float64)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        times: dict[str, list] = {"batch": [], "time": [], "evals_per_sec": []}
        for batch in [cores] if isinstance(cores, int) else list(cores):
            xs = point.expand(batch, model.ndim).contiguous()
            model.logp_and_grad(xs)
            sync()
            start = time.perf_counter()
            for _ in range(num_evals):
                model.logp_and_grad(xs)
            sync()
            elapsed = (time.perf_counter() - start) / num_evals
            times["batch"].append(batch)
            times["time"].append(elapsed)
            times["evals_per_sec"].append(batch / elapsed)
        try:
            import pandas as pd
        except ImportError:
            return times
        return pd.DataFrame(times)


def make_model(
    ndim: int,
    logp_fn: Callable,
    *,
    expand_fn: Optional[Callable] = None,
    expand_needs_rng: bool = False,
    expanded_vars: Optional[
        Sequence[tuple[str, Any, tuple[int, ...], Optional[Sequence[str]]]]
    ] = None,
    param_vars: Optional[
        Sequence[tuple[str, Any, tuple[int, ...], Optional[Sequence[str]]]]
    ] = None,
    coords: Optional[dict] = None,
    init_point_fn: Optional[Callable] = None,
    reparameterized_names: Sequence[str] = (),
    logp_grad_fn: Optional[Callable] = None,
    kernel_model: Optional[Any] = None,
    eager_logp: bool = False,
) -> ModelDef:
    """Convenience constructor resolving variable metadata."""
    dim_sizes: dict[str, int] = {}
    pvars = evars = None
    if param_vars is not None:
        pvars, dim_sizes = resolve_variables(
            [(n, np.dtype(d), tuple(s), dm) for n, d, s, dm in param_vars],
            dim_sizes,
        )
        total = sum(v.num_elements for v in pvars)
        if total != ndim:
            raise ValueError(
                f"param_vars cover {total} unconstrained elements but ndim "
                f"is {ndim}"
            )
    if expanded_vars is not None:
        evars, dim_sizes = resolve_variables(
            [(n, np.dtype(d), tuple(s), dm) for n, d, s, dm in expanded_vars],
            dim_sizes,
        )
    return ModelDef(
        ndim=ndim,
        logp_fn=logp_fn,
        expand_fn=expand_fn,
        expand_needs_rng=expand_needs_rng,
        expanded_variables=tuple(evars) if evars is not None else (),
        param_variables=tuple(pvars) if pvars is not None else (),
        dim_sizes=dim_sizes,
        coords=dict(coords or {}),
        init_point_fn=init_point_fn,
        reparameterized_names=tuple(reparameterized_names),
        logp_grad_fn=logp_grad_fn,
        kernel_model=kernel_model,
        eager_logp=eager_logp,
    )
