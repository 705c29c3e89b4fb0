"""``sample()``: blocking NUTS sampling of a compiled model, in torch.

Same settings vocabulary and trace layout as ``nutpie_tpu.sample`` (and
the reference's ``nutpie.sample``).  The run is a loop of chunks: chain
initialization, then warmup chunks through the chunk runner with the
per-draw adaptation on, then posterior chunks with it frozen; pooling, the
trapped-chain rescue and the fleet depth cap act at chunk boundaries.
Each chunk's draws are expanded (batched over ``[C*L, dim]``) and copied
to the host, and the chunks are assembled into the trace.

Route: one decision, taken before anything runs (``route``).  A model
with a ``kernel_model`` (radon) whose configuration the chunk kernel K1
supports runs each chunk as one K1 launch; any other model whose
configuration the step kernel K2 supports runs through the step runner
(``sampler/run.py:make_chunk_runner``), one batched torch logp and one K2
launch per machine step, replayed from a CUDA graph on the card; anything
else raises ``NotImplementedError``
naming its ``ROADMAP.md`` item.  The route is the same on every device:
``device=None`` means CUDA, where the kernels run, and ``device="cpu"``
runs their plain versions.  ``precision="auto"`` is float32 on CUDA and
float64 on the CPU.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from . import __version__ as _version
from .model import CompiledModel, ModelDef
from .sampler import megakernel, step_kernel
from .sampler.adapt import AdaptConfig, make_schedule
from .sampler.megakernel import make_megakernel_chunk_runner
from .sampler.nuts import (
    _FLOW_ITEM,
    _MCLMC_ITEM,
    DIV_BUFFERS,
    SCALAR_SLOTS,
    LowRankConfig,
    NutsConfig,
)
from .sampler.run import fleet_depth_cap, init_chains, make_chunk_runner, resolve_dtype
from .settings import NutsSettings
from .trace import assemble_trace

__all__ = ["sample"]

_CONTROL_ITEM = "ROADMAP.md queue 1: background control and progress"
_CHECKPOINT_ITEM = "ROADMAP.md queue 1: checkpoint"
_STORAGE_ITEM = "ROADMAP.md queue 1: storage/Zarr"


def _make_settings(sampler: str, adaptation: str, seed) -> NutsSettings:
    if sampler == "mclmc":
        raise NotImplementedError(f"the MCLMC sampler: {_MCLMC_ITEM}")
    if sampler != "nuts":
        raise ValueError(
            f"Unknown sampler '{sampler}'. Expected one of: 'nuts', 'mclmc'."
        )
    if adaptation == "low_rank":
        return NutsSettings.LowRank(seed)
    if adaptation == "flow":
        return NutsSettings.Flow(seed)
    if adaptation in ("diag", "draw_diag"):
        settings = NutsSettings.Diag(seed)
        if adaptation == "draw_diag":
            settings.use_grad_based_mass_matrix = False
        return settings
    raise ValueError(
        f"Unknown adaptation strategy '{adaptation}'. "
        f"Expected one of: 'diag', 'draw_diag', 'low_rank', 'flow'."
    )


def nuts_config_from_settings(settings: NutsSettings) -> NutsConfig:
    """Settings tree -> NutsConfig (the JAX package's, without its flow
    branch)."""
    if settings.adaptation == "flow":
        raise NotImplementedError(f"flow adaptation: {_FLOW_ITEM}")
    ao = settings.adapt_options
    ss = ao.step_size_settings
    mm = ao.mass_matrix_options
    low_rank = None
    if settings.adaptation == "low_rank":
        low_rank = LowRankConfig(eigval_cutoff=mm.eigval_cutoff, gamma=mm.gamma,
                                 window=ao.mass_matrix_switch_freq)
    adapt = AdaptConfig(
        num_tune=settings.num_tune,
        target_accept=ss.target_accept,
        initial_step=ss.initial_step,
        gamma=ss.adapt_options.dual_average.gamma,
        t0=ss.adapt_options.dual_average.t0,
        kappa=ss.adapt_options.dual_average.kappa,
        max_step_size=ss.adapt_options.dual_average.max_step_size,
        method=ss.adapt_options.method,
        adam_lr=ss.adapt_options.adam.learning_rate,
        adam_beta1=ss.adapt_options.adam.beta1,
        adam_beta2=ss.adapt_options.adam.beta2,
        step_size_jitter=ss.jitter,
        switch_freq=ao.mass_matrix_switch_freq,
        early_switch_freq=ao.early_mass_matrix_switch_freq,
        early_phase_share=ao.early_phase_share,
        freeze_share=ao.freeze_share,
        use_grad_based_estimate=getattr(mm, "use_grad_based_estimate", True),
    )
    return NutsConfig(
        maxdepth=settings.maxdepth,
        mindepth=settings.mindepth,
        check_turning=settings.check_turning,
        kinetic=settings.trajectory_kind,
        target_time=settings.target_integration_time,
        extra_doublings=settings.extra_doublings,
        max_energy_error=settings.max_energy_error,
        store_gradient=settings.store_gradient,
        store_mass_matrix=mm.store_mass_matrix,
        store_divergences=settings.store_divergences,
        store_transformed=settings.store_transformed,
        low_rank=low_rank,
        adapt=adapt,
    )


def default_chunk_size(settings, n_chains: int, dim: int, itemsize: int) -> int:
    """Draws per chunk: ~256 MB of [dim]-row buffers (the draws and the
    stored gradients, mass matrices and divergence rows), clipped to
    [8, 128]."""
    if settings.chunk_size is not None:
        return max(1, int(settings.chunk_size))
    mm = settings.adapt_options.mass_matrix_options
    n_vec_buffers = (1 + settings.store_gradient + 4 * settings.store_divergences
                     + bool(mm.store_mass_matrix))
    bytes_per_draw = n_chains * (dim * itemsize * n_vec_buffers + 128)
    return int(np.clip((256 * 1024 * 1024) // max(bytes_per_draw, 1), 8, 128))


def chunk_length(settings, n_chains: int, dim: int, itemsize: int) -> int:
    """The run's chunk length.  Without a ``chunk_size``, low-rank
    adaptation puts the chunk boundaries, where its metric updates, on the
    mass-matrix switch cadence, as the JAX package does."""
    total = settings.num_tune + settings.num_draws
    if settings.adaptation == "low_rank" and settings.chunk_size is None:
        return min(max(settings.adapt_options.mass_matrix_switch_freq, 1), max(total, 1))
    return min(default_chunk_size(settings, n_chains, dim, itemsize), max(total, 1))


def resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sample(device='cuda') needs a CUDA device; pass device='cpu' to "
            "run the plain torch version on the CPU"
        )
    return device


_SCALAR_DTYPES = {
    "depth": np.int32,
    "n_steps": np.int32,
    "index_in_trajectory": np.int32,
    "maxdepth_reached": bool,
    "diverging": bool,
}


# the optional buffers that become statistics of the trace
_OPTIONAL_STATS = ("gradient", "mass_matrix_inv", "mass_matrix_eigvals", *DIV_BUFFERS)
# the message a divergent draw carries beside its divergence rows
DIVERGENCE_MESSAGE = "energy error exceeded max_energy_error (or was non-finite)"


def chunk_to_host(bufs, expanded: dict, limit: int,
                  store_unconstrained: bool = False,
                  store_gradient: bool = False) -> dict:
    """One chunk's buffers -> host arrays cut to the draws produced.

    The optional buffers become statistics under the JAX trace's names;
    the gradient only when ``store_gradient`` asked for it (low-rank
    adaptation allocates it for its own update).  With the divergence
    buffers comes ``divergence_message``, as in ``nutpie_tpu/sample.py``:
    the message at a divergent draw, empty elsewhere."""
    cut = lambda x: x[:, :limit].detach().cpu().numpy()
    packed = cut(bufs.scalars)
    stats = {}
    for name in _OPTIONAL_STATS:
        value = getattr(bufs, name)
        if value is not None and (name != "gradient" or store_gradient):
            stats[name] = cut(value)
    for name, slot in SCALAR_SLOTS.items():
        if name == "fisher_distance":
            continue  # flow adaptation only
        arr = packed[..., slot]
        dt = _SCALAR_DTYPES.get(name)
        if dt is bool:
            arr = arr > 0.5
        elif dt is not None:
            arr = arr.astype(dt)
        stats[name] = arr
    if "mass_matrix_inv" in stats:
        stats["mass_matrix_stds"] = np.sqrt(stats["mass_matrix_inv"])
    if "divergence_start" in stats:
        stats["divergence_message"] = np.where(
            stats["diverging"], DIVERGENCE_MESSAGE, "").astype(object)
    position = cut(bufs.position)
    if store_unconstrained:
        stats["unconstrained_draw"] = position
    return {
        "position": position,
        "stats": stats,
        "expanded": {k: cut(v) for k, v in expanded.items()},
    }


def expand_chunk(model: ModelDef, position: torch.Tensor) -> dict:
    """Expand ``[C, L, dim]`` positions in one batched call over ``C*L`` rows."""
    C, L, dim = position.shape
    with torch.no_grad():
        out = model.expand_fn(position.reshape(C * L, dim))
    return {k: v.reshape((C, L) + tuple(v.shape[1:])) for k, v in out.items()}


# the chunk runner of each route
RUNNERS = {"megakernel": make_megakernel_chunk_runner, "step": make_chunk_runner}


def route(cfg: NutsConfig, model: ModelDef) -> str:
    """The chunk runner for this model and configuration, on every device:
    ``"megakernel"`` (K1) or ``"step"`` (K2 around the model's torch logp).
    Raises ``NotImplementedError`` naming the ``ROADMAP.md`` item of what
    neither kernel runs (``step_kernel.unsupported``: each of its refusals
    holds for whichever kernel the configuration would take)."""
    why = step_kernel.unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"no kernel runs this configuration yet: {why}")
    if model.kernel_model is not None and megakernel.supports(cfg):
        return "megakernel"
    return "step"


def run_chains(model: ModelDef, cfg: NutsConfig, settings: NutsSettings,
               init_mean, dtype, device, runner: str) -> list:
    """Init + the chunk loop through the ``runner`` route; returns the host
    chunks (``chunk_to_host``)."""
    n_chains = settings.num_chains
    num_tune, total = settings.num_tune, settings.num_tune + settings.num_draws
    itemsize = torch.tensor([], dtype=dtype).element_size()
    chunk_len = chunk_length(settings, n_chains, model.ndim, itemsize)
    states, ok = init_chains(
        model, cfg, settings.seed, n_chains, init_mean, dtype, device=device,
        num_try_init=settings.num_try_init,
    )
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise RuntimeError(
            f"Logp function returned error for initial positions of {bad} "
            f"chains (tried {settings.num_try_init} points per chain)"
        )
    pool = dict(pool_step_size=settings.pool_step_size,
                pool_mass_matrix=settings.pool_mass_matrix)
    make_runner = RUNNERS[runner]
    warm = make_runner(model, cfg, chunk_len, dtype, adapt_frozen=False, **pool)
    post = make_runner(model, cfg, chunk_len, dtype, adapt_frozen=True, **pool)
    # fleet-relative work cap: a static cap before the first measurement,
    # then the fleet's, frozen with the mass matrix (>= 64 chains only)
    sched = make_schedule(
        cfg.adapt, num_tune, cfg.initial_depth_cap if n_chains >= 64 else None
    )
    cap_until = num_tune - int(cfg.adapt.freeze_share * num_tune)
    chunks = []
    start = 0
    while start < total:
        limit = min(chunk_len, total - start)
        run_chunk = warm if start < num_tune else post
        states, bufs = run_chunk(states, start, limit, sched)
        if n_chains >= 64 and start + limit <= cap_until:
            sched = sched._replace(depth_cap=fleet_depth_cap(cfg, bufs, limit))
        expanded = expand_chunk(model, bufs.position)
        chunks.append(chunk_to_host(bufs, expanded, limit, settings.store_unconstrained,
                                    settings.store_gradient))
        start += limit
    return chunks


def sample(
    compiled_model: CompiledModel,
    *,
    draws: Optional[int] = None,
    tune: Optional[int] = None,
    chains: Optional[int] = None,
    cores: Optional[int] = None,
    seed: Optional[int] = None,
    save_warmup: bool = True,
    progress_bar: bool = True,
    sampler: str = "nuts",
    adaptation: str = "diag",
    init_mean: Optional[np.ndarray] = None,
    return_raw_trace: bool = False,
    blocking: bool = True,
    progress_callback: Any = None,
    progress_template: Optional[str] = None,
    progress_style: Optional[str] = None,
    progress_rate: int = 100,
    zarr_store: Any = None,
    store_unconstrained: bool = False,
    checkpoint: Any = None,
    checkpoint_every: int = 1,
    resume_from: Any = None,
    device=None,
    **kwargs,
):
    """Sample the posterior of a compiled model.

    Parameters mirror ``nutpie_tpu.sample``; ``cores`` is ignored (chains
    run batched on the device) and ``progress_bar`` draws nothing in this
    slice.  Extra keyword settings include ``precision``, ``chunk_size``,
    ``pool_mass_matrix`` and ``pool_step_size``.  ``device`` defaults to
    CUDA.  Not yet ported (each raises ``NotImplementedError``):
    non-blocking runs and progress callbacks, Zarr storage, checkpoints,
    MCLMC and flow adaptation.  ``store_transformed`` stores nothing
    without flow adaptation, as in the JAX package.
    """
    if not blocking or progress_callback is not None or progress_template \
            or progress_style:
        raise NotImplementedError(
            f"non-blocking runs and progress rendering: {_CONTROL_ITEM}"
        )
    if zarr_store is not None:
        raise NotImplementedError(f"zarr_store: {_STORAGE_ITEM}")
    if checkpoint is not None or resume_from is not None:
        raise NotImplementedError(f"checkpoint/resume_from: {_CHECKPOINT_ITEM}")

    updates = dict(kwargs)
    if "use_grad_based_mass_matrix" in updates:
        if not updates.pop("use_grad_based_mass_matrix"):
            if adaptation not in ("diag", "draw_diag"):
                raise ValueError(
                    "`use_grad_based_mass_matrix=False` requires diag adaptation"
                )
            adaptation = "draw_diag"
    settings = _make_settings(sampler, adaptation, seed)
    if tune is not None:
        updates["num_tune"] = tune
    if draws is not None:
        updates["num_draws"] = draws
    if chains is not None:
        updates["num_chains"] = chains
    settings.update(updates)
    if store_unconstrained:
        settings.store_unconstrained = True
    if settings.seed is None:
        settings.seed = int(np.random.default_rng().integers(0, 2**63 - 1))

    cfg = nuts_config_from_settings(settings)
    model = compiled_model._make_model(int(settings.seed))
    runner = route(cfg, model)
    device = resolve_device(device)
    dtype = resolve_dtype(settings.precision, device)
    # HMC energies need full-precision products: TF32 would inject O(1e-3)
    # relative error into logp and its gradient (the JAX package forces
    # "highest" matmul precision for the same reason)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if init_mean is None:
        init_mean = np.zeros(model.ndim)
    chunks = run_chains(model, cfg, settings, init_mean, dtype, device, runner)
    raw = {
        "position": np.concatenate([c["position"] for c in chunks], axis=1),
        "stats": {k: np.concatenate([c["stats"][k] for c in chunks], axis=1)
                  for k in chunks[0]["stats"]},
        "expanded": {k: np.concatenate([c["expanded"][k] for c in chunks], axis=1)
                     for k in chunks[0]["expanded"]},
    }
    if return_raw_trace:
        return raw
    return _assemble(compiled_model, model, settings, raw, save_warmup,
                     store_unconstrained)


def _assemble(compiled_model, model: ModelDef, settings, raw: dict,
              save_warmup: bool, store_unconstrained: bool):
    dims_map = {v.name: tuple(v.dims or ()) for v in model.expanded_variables}
    coords = dict(model.coords)
    coords.update(compiled_model.coords)
    coords["unconstrained_parameter"] = np.asarray(
        model.unconstrained_labels, dtype=object
    )
    unconstrained = None
    if store_unconstrained:
        unconstrained = {}
        for v in model.param_variables:
            arr = raw["position"][:, :, v.start_idx : v.end_idx]
            unconstrained[v.name] = arr.reshape(arr.shape[:2] + v.shape)
            dims_map.setdefault(v.name, tuple(v.dims or ()))
    attrs = {
        "inference_library": "nutpie_tpu_torch",
        "inference_library_version": _version,
        "inference_library_settings": settings.as_json(),
    }
    return assemble_trace(
        expanded=raw["expanded"],
        stats=raw["stats"],
        unconstrained=unconstrained,
        num_tune=settings.num_tune,
        save_warmup=save_warmup,
        dims_map=dims_map,
        coords=coords,
        attrs=attrs,
        reparameterized_names=tuple(model.reparameterized_names),
    )
