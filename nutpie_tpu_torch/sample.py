"""``sample()``: NUTS sampling of a compiled model, in torch.

Same settings vocabulary, trace layout and control surface as
``nutpie_tpu.sample`` (and the reference's ``nutpie.sample``).  Every call
runs in a background thread (``_BackgroundSampler``), which ``blocking=False``
returns as a handle: pause, resume, abort, cancel, inspect and wait, with
progress callbacks and renderers (``progress.py``), checkpoints
(``checkpoint.py``) and streaming Zarr storage (``storage/``) between
chunks.  The run is a loop of chunks: chain initialization, then warmup
chunks through the chunk runner with the per-draw adaptation on, then
posterior chunks with it frozen; pooling, the trapped-chain rescue and the
fleet depth cap act at chunk boundaries.  The loop is double-buffered:
chunk k+1 is launched, expanded (batched over ``[C*L, dim]``) and its
copies to the host started (``ChunkTransfer``: pinned buffers and a copy
stream on the card) before chunk k is converted, stored and reported.

Route: one decision, taken before anything runs (``route``).  A model
with a ``kernel_model`` (radon) whose configuration the chunk kernel K1
supports runs each chunk as one K1 launch; any other model whose
configuration the step kernel K2 supports runs through the step runner
(``sampler/run.py:make_chunk_runner``), one batched torch logp and one K2
launch per machine step, replayed from a CUDA graph on the card;
``sampler="mclmc"`` runs through the MCLMC runner
(``sampler/mclmc.py:make_mclmc_chunk_runner``), two batched torch logps
and two launches of the MCLMC kernel K3 a step, one draw's steps replayed
from a CUDA graph on the card; anything else raises
``NotImplementedError`` naming its ``ROADMAP.md`` item.  The route is the same on every device:
``device=None`` means CUDA, where the kernels run, and ``device="cpu"``
runs their plain versions.  ``precision="auto"`` is float32 on CUDA and
float64 on the CPU.

Inside an initialized process group (``parallel.initialize_distributed``)
every rank calls ``sample()`` with the same arguments and runs its slice
of the fleet on its own device; the chunk-boundary operations gather
across ranks (``parallel/mesh.py``), so the draws are bit for bit those of
one process sampling the whole fleet.  Each chunk's buffers are gathered
to rank 0 on the device, where the trace, progress, Zarr storage and
checkpoints run over the whole fleet; rank 0 decides pause and abort and
broadcasts its decision at every chunk boundary.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
import traceback
import warnings
from typing import Any, Optional

import numpy as np
import torch

from . import __version__ as _version
from .checkpoint import load_state, save_state
from .model import CompiledModel, ModelDef
from .ops import threefry
from .parallel.mesh import (
    ChainMesh,
    broadcast_flag,
    chain_mesh,
    gather_chains,
    gather_to_root,
)
from .progress import ChainProgress, make_progress_handlers
from .sampler import megakernel, step_kernel
from .sampler.adapt import AdaptConfig, make_schedule
from .sampler.megakernel import make_megakernel_chunk_runner
from .sampler.mclmc import (
    MCLMC_SCALAR_SLOTS,
    MclmcConfig,
    init_mclmc_chains,
    make_mclmc_chunk_runner,
)
from .sampler.nuts import (
    DIV_BUFFERS,
    SCALAR_SLOTS,
    LowRankConfig,
    NutsConfig,
)
from .sampler.run import fleet_depth_cap, init_chains, make_chunk_runner, resolve_dtype
from .settings import MclmcSettings, NutsSettings
from .storage.sink import ZarrTraceSink
from .trace import assemble_trace, open_zarr_trace
from .transforms.flow import FlowConfig

__all__ = ["sample"]


def _make_settings(sampler: str, adaptation: str, seed):
    if sampler == "nuts":
        cls = NutsSettings
    elif sampler == "mclmc":
        cls = MclmcSettings
    else:
        raise ValueError(
            f"Unknown sampler '{sampler}'. Expected one of: 'nuts', 'mclmc'."
        )
    if adaptation == "low_rank":
        return cls.LowRank(seed)
    if adaptation == "flow":
        return cls.Flow(seed)
    if adaptation in ("diag", "draw_diag"):
        settings = cls.Diag(seed)
        if adaptation == "draw_diag":
            settings.use_grad_based_mass_matrix = False
        return settings
    raise ValueError(
        f"Unknown adaptation strategy '{adaptation}'. "
        f"Expected one of: 'diag', 'draw_diag', 'low_rank', 'flow'."
    )


def _apply_f32_flow_recipe(args: dict, precision: str, device) -> None:
    """The JAX package's float32 flow-training recipe
    (``nutpie_tpu/sample.py:62-80``), as it is: where the run resolves to
    float32, learning rate 3e-4, 1600 steps and the cosine decay, unless
    the user set them."""
    if resolve_dtype(precision, torch.device("cuda" if device is None else device)) \
            == torch.float32:
        args.setdefault("learning_rate", 3e-4)
        args.setdefault("train_steps", 1600)
        args.setdefault("lr_decay", True)


def flow_config(settings, transform_args: Optional[dict], device,
                orbit: bool) -> FlowConfig:
    """The flow's configuration from the settings' ``flow`` options and the
    model's ``with_transform_adapt`` arguments (those win), the update
    cadence ``transform_update_freq``, ``use_orbit`` from
    ``use_orbit_for_training`` (NUTS), and the float32 recipe."""
    ao = settings.adapt_options
    args = dict(getattr(ao, "flow", {}) or {})
    args.update(transform_args or {})
    if orbit:
        args.setdefault("use_orbit", getattr(ao, "use_orbit_for_training", False))
    _apply_f32_flow_recipe(args, settings.precision, device)
    known = {f.name for f in dataclasses.fields(FlowConfig)}
    return FlowConfig(update_freq=getattr(ao, "transform_update_freq", 64),
                      **{k: v for k, v in args.items() if k in known})


def nuts_config_from_settings(settings: NutsSettings, transform_args: Optional[dict] = None,
                              device=None) -> NutsConfig:
    """Settings tree -> NutsConfig (``nutpie_tpu/sample.py:82-150``);
    ``transform_args`` are the model's ``with_transform_adapt`` arguments,
    ``device`` the run's (the float32 flow recipe follows its precision)."""
    ao = settings.adapt_options
    ss = ao.step_size_settings
    mm = getattr(ao, "mass_matrix_options", None)
    low_rank = flow = None
    if settings.adaptation == "low_rank":
        low_rank = LowRankConfig(eigval_cutoff=mm.eigval_cutoff, gamma=mm.gamma,
                                 window=ao.mass_matrix_switch_freq)
    elif settings.adaptation == "flow":
        flow = flow_config(settings, transform_args, device, orbit=True)
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
        switch_freq=getattr(ao, "mass_matrix_switch_freq", 80),
        early_switch_freq=getattr(ao, "early_mass_matrix_switch_freq", 10),
        early_phase_share=getattr(ao, "early_phase_share", 0.3),
        freeze_share=getattr(ao, "freeze_share", 0.1),
        use_grad_based_estimate=getattr(mm, "use_grad_based_estimate", True),
        update_mass_matrix=flow is None,
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
        store_mass_matrix=getattr(mm, "store_mass_matrix", False),
        store_divergences=settings.store_divergences,
        store_transformed=settings.store_transformed,
        low_rank=low_rank,
        flow=flow,
        adapt=adapt,
    )


def mclmc_config_from_settings(settings: MclmcSettings, transform_args: Optional[dict] = None,
                               device=None) -> MclmcConfig:
    """Settings tree -> MclmcConfig (``nutpie_tpu/sample.py:276-329``)."""
    ao = settings.adapt_options
    ss = ao.step_size_settings
    mm = getattr(ao, "mass_matrix_options", None)
    low_rank = flow = None
    if settings.adaptation == "low_rank":
        low_rank = LowRankConfig(eigval_cutoff=getattr(mm, "eigval_cutoff", 100.0),
                                 gamma=getattr(mm, "gamma", 1e-5),
                                 window=getattr(ao, "mass_matrix_switch_freq", 80))
    elif settings.adaptation == "flow":
        flow = flow_config(settings, transform_args, device, orbit=False)
    adapt = AdaptConfig(
        num_tune=settings.num_tune,
        switch_freq=getattr(ao, "mass_matrix_switch_freq", 80),
        early_switch_freq=getattr(ao, "early_mass_matrix_switch_freq", 10),
        use_grad_based_estimate=getattr(mm, "use_grad_based_estimate", True),
        target_accept=ss.target_accept,
        initial_step=ss.initial_step,
        update_mass_matrix=flow is None,
    )
    return MclmcConfig(
        step_size=settings.step_size,
        momentum_decoherence_length=settings.momentum_decoherence_length,
        steps_per_draw=max(1, int(round(settings.subsample_frequency))),
        dynamic_step_size=settings.dynamic_step_size,
        max_energy_error=settings.max_energy_error,
        trajectory=settings.trajectory_kind,
        store_gradient=settings.store_gradient,
        store_mass_matrix=getattr(mm, "store_mass_matrix", False),
        low_rank=low_rank,
        flow=flow,
        adapt=adapt,
    )


def config_from_settings(settings, transform_args: Optional[dict] = None, device=None):
    """The sampler's configuration: ``NutsConfig`` or ``MclmcConfig``."""
    if isinstance(settings, MclmcSettings):
        return mclmc_config_from_settings(settings, transform_args, device)
    return nuts_config_from_settings(settings, transform_args, device)


def default_chunk_size(settings, n_chains: int, dim: int, itemsize: int) -> int:
    """Draws per chunk: ~256 MB of [dim]-row buffers (the draws and the
    stored gradients, mass matrices and divergence rows), clipped to
    [8, 128]."""
    if settings.chunk_size is not None:
        return max(1, int(settings.chunk_size))
    mm = getattr(settings.adapt_options, "mass_matrix_options", None)
    n_vec_buffers = (1 + settings.store_gradient + 4 * settings.store_divergences
                     + bool(getattr(mm, "store_mass_matrix", False)))
    bytes_per_draw = n_chains * (dim * itemsize * n_vec_buffers + 128)
    return int(np.clip((256 * 1024 * 1024) // max(bytes_per_draw, 1), 8, 128))


def chunk_length(settings, n_chains: int, dim: int, itemsize: int) -> int:
    """The run's chunk length.  Without a ``chunk_size``, low-rank
    adaptation puts the chunk boundaries, where its metric updates, on the
    mass-matrix switch cadence, and flow adaptation, where its flows train,
    on ``transform_update_freq``, as the JAX package does."""
    total = settings.num_tune + settings.num_draws
    if settings.adaptation == "low_rank" and settings.chunk_size is None:
        return min(max(settings.adapt_options.mass_matrix_switch_freq, 1), max(total, 1))
    if settings.adaptation == "flow" and settings.chunk_size is None:
        freq = getattr(settings.adapt_options, "transform_update_freq", 64)
        return min(max(freq, 1), max(total, 1))
    return min(default_chunk_size(settings, n_chains, dim, itemsize), max(total, 1))


def run_mesh(device, n_chains: int) -> Optional[ChainMesh]:
    """The mesh of the initialized process group for a fleet of
    ``n_chains`` (``ChainMesh.for_chains``; a device given must be the
    group's), or None outside a group."""
    if not (torch.distributed.is_available() and torch.distributed.is_initialized()):
        return None
    return chain_mesh(device).for_chains(n_chains)


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
_OPTIONAL_STATS = ("gradient", "mass_matrix_inv", "mass_matrix_eigvals", *DIV_BUFFERS,
                   "transformed_position", "transformed_gradient", "transformation_mu",
                   "orbit_position", "orbit_gradient")
# the message a divergent draw carries beside its divergence rows
DIVERGENCE_MESSAGE = "energy error exceeded max_energy_error (or was non-finite)"


def chunk_to_host(bufs: dict, expanded: dict, limit: int,
                  store_unconstrained: bool = False, mclmc_steps: Optional[int] = None,
                  flow: bool = False) -> dict:
    """One chunk's host arrays (``ChunkBuffers`` or ``MclmcBuffers`` fields
    and expanded variables by name, ``[C, L, ...]``) cut to the draws
    produced and copied out of the transfer's buffers.

    The optional buffers become statistics under the JAX trace's names.
    With the divergence buffers comes ``divergence_message``, as in
    ``nutpie_tpu/sample.py``: the message at a divergent draw, empty
    elsewhere.  ``fisher_distance`` is a statistic under flow adaptation
    (``flow``) only, as in the JAX package.  An MCLMC chunk (``mclmc_steps``: its steps a draw) has
    MCLMC's statistics, in the JAX package's order and dtypes: ``logp``,
    ``energy_error``, ``diverging``, ``step_size``, ``n_steps`` (int32),
    then the optional buffers."""
    cut = lambda x: np.array(x[:, :limit])
    packed = cut(bufs["scalars"])
    if mclmc_steps is not None:
        stats = {name: packed[..., slot] for name, slot in MCLMC_SCALAR_SLOTS.items()}
        stats["diverging"] = stats["diverging"] > 0.5
        stats["n_steps"] = np.full(packed.shape[:2], mclmc_steps, dtype=np.int32)
        stats.update({name: cut(bufs[name]) for name in ("gradient", "mass_matrix_inv")
                      if name in bufs})
    else:
        stats = {name: cut(bufs[name]) for name in _OPTIONAL_STATS if name in bufs}
    for name, slot in SCALAR_SLOTS.items():
        if mclmc_steps is not None or (name == "fisher_distance" and not flow):
            continue  # MCLMC has its own; the Fisher distance is flow adaptation's
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
    position = cut(bufs["position"])
    if store_unconstrained:
        stats["unconstrained_draw"] = position
    return {
        "position": position,
        "stats": stats,
        "expanded": {k: cut(v) for k, v in expanded.items()},
    }


def expand_keys(seed: int, C: int, L: int, chunk_start: int, device) -> torch.Tensor:
    """The generated quantities' keys of a chunk, ``[C, L, 2]``: chain c's
    draw d (absolute) takes ``fold_in(fold_in(key(seed ^ 0x6A09E667), c),
    d)``, as ``nutpie_tpu/sample.py:524-540`` derives them, so a draw's
    random numbers do not depend on the chunking."""
    master = threefry.key(seed ^ 0x6A09E667, device)
    ckeys = threefry.fold_in_data(master, torch.arange(C, device=device))
    draws = torch.arange(L, device=device) + int(chunk_start)
    return threefry.fold_in_data(ckeys[:, None, :], draws[None, :])


def expand_chunk(model: ModelDef, position: torch.Tensor, chunk_start: int = 0,
                 seed: int = 0) -> dict:
    """Expand ``[C, L, dim]`` positions in one batched call over ``C*L`` rows
    (with one key a row where the expansion draws random numbers)."""
    C, L, dim = position.shape
    with torch.no_grad():
        if model.expand_needs_rng:
            keys = expand_keys(seed, C, L, chunk_start, position.device)
            out = model.expand_fn(position.reshape(C * L, dim), keys.reshape(C * L, 2))
        else:
            out = model.expand_fn(position.reshape(C * L, dim))
    return {k: v.reshape((C, L) + tuple(v.shape[1:])) for k, v in out.items()}


class ChunkTransfer:
    """Device-to-host copies of the chunks in flight.

    ``start(tensors)`` begins one chunk's copies and returns a ticket;
    ``fetch(ticket)`` waits for them and returns numpy arrays by name.  On
    the card each chunk's tensors are copied into pinned host buffers with
    ``non_blocking`` copies on a copy stream, which first waits on an event
    recorded on the compute stream after the chunk's work (the kernel, the
    expansion, the progress snapshot), so the copies overlap whatever the
    compute stream runs next.  Two sets of pinned buffers, one per chunk in
    flight, are allocated at the first chunk and then alternate; the
    caller copies a fetched chunk out of its set before the set's next
    ``start`` (two chunks later).  A ticket keeps the chunk's device
    tensors alive until it is fetched, so the allocator cannot hand their
    memory to the compute stream while the copy stream reads it.  On the
    CPU the tensors are on the host already and ``fetch`` returns views.
    ``pinned_bytes`` counts both sets, ``alloc_s`` the host seconds their
    allocation took, ``wait_s`` the host seconds ``fetch`` waited for
    copies.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._sets: list = [None, None]
        self._next = 0
        self.pinned_bytes = 0
        self.alloc_s = self.wait_s = 0.0

    def _pinned(self, tensors: dict) -> dict:
        i, self._next = self._next, self._next ^ 1
        host = self._sets[i]
        if host is None or any(host[k].shape != t.shape or host[k].dtype != t.dtype
                               for k, t in tensors.items()):
            t0 = time.perf_counter()
            host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for k, t in tensors.items()}
            self.alloc_s += time.perf_counter() - t0
            self._sets[i] = host
            self.pinned_bytes = sum(v.numel() * v.element_size()
                                    for h in self._sets if h is not None
                                    for v in h.values())
        return host

    def start(self, tensors: dict):
        if not self.cuda:
            return tensors
        # contiguous on the compute stream, so the copy stream allocates nothing
        tensors = {k: t.contiguous() for k, t in tensors.items()}
        host = self._pinned(tensors)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.stream.device))
        self.stream.wait_event(ready)
        with torch.cuda.stream(self.stream):
            for k, t in tensors.items():
                host[k].copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.stream)
        return host, done, tensors

    def fetch(self, ticket) -> dict:
        if not self.cuda:
            return {k: t.detach().numpy() for k, t in ticket.items()}
        host, done, _ = ticket
        t0 = time.perf_counter()
        done.synchronize()
        self.wait_s += time.perf_counter() - t0
        return {k: v.numpy() for k, v in host.items()}


# the chains' counters and step sizes the progress snapshot reads
_SNAPSHOT = ("draw_idx", "divergence_count", "total_steps", "eps")
# the control state rank 0 broadcasts at a chunk boundary
_GO, _PAUSED, _STOP = 0, 1, 2


# the chunk runner of each route
RUNNERS = {"megakernel": make_megakernel_chunk_runner, "step": make_chunk_runner,
           "mclmc": make_mclmc_chunk_runner}


def route(cfg, model: ModelDef) -> str:
    """The chunk runner for this model and configuration, on every device:
    ``"megakernel"`` (K1), ``"step"`` (K2 around the model's torch logp) or,
    for an ``MclmcConfig``, ``"mclmc"`` (K3 around it).  Raises
    ``NotImplementedError`` naming the ``ROADMAP.md`` item of what no
    kernel runs (``step_kernel.unsupported``: each of its refusals holds
    for whichever kernel the configuration would take).  Flow adaptation
    takes ``"step"`` (K2 around the pulled-back log density) or, under
    MCLMC, ``"mclmc"``.  A model whose log density runs eagerly
    (``ModelDef.eager_logp``) takes the same routes, ``"step"`` under NUTS
    and ``"mclmc"`` under MCLMC, with or without flow: each runner then
    calls it between its kernel's launches instead of replaying a graph."""
    if isinstance(cfg, MclmcConfig):
        return "mclmc"
    why = step_kernel.unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"no kernel runs this configuration yet: {why}")
    if model.kernel_model is not None and megakernel.supports(cfg):
        return "megakernel"
    return "step"


class _BackgroundSampler:
    """Drives the chunked device loop in a background thread; the handle
    ``sample(blocking=False)`` returns.

    The port of ``nutpie_tpu/sample.py:_BackgroundSampler``.  The loop is
    double-buffered: it launches chunk k+1, queues its expansion, progress
    snapshot and copies to the host (``ChunkTransfer``), and only then
    converts, stores, streams and reports chunk k.  Pause and abort act at
    chunk boundaries.  The thread runs under the run's device, on its
    default stream.

    Inside a process group each rank runs its slice of the fleet, and rank
    0 (``rank``) holds the whole fleet's trace, progress, Zarr sink and
    checkpoint; the other ranks take no progress handler or store.  The
    control methods act on rank 0 and raise on the others.
    """

    def __init__(self, compiled_model: CompiledModel, settings, init_mean,
                 *, device=None, progress_bar: bool = True, progress_callback=None,
                 save_warmup: bool = True, return_raw_trace: bool = False,
                 progress_template=None, progress_style=None, progress_rate: int = 100,
                 store=None, store_unconstrained: bool = False, checkpoint=None,
                 checkpoint_every: int = 1, resume_from=None):
        self._checkpoint_path = checkpoint
        self._checkpoint_every = max(1, int(checkpoint_every))
        self._resume_from = resume_from
        self._resume_offset = 0
        self._compiled_model = compiled_model
        self._settings = settings
        self._save_warmup = save_warmup
        self._return_raw_trace = return_raw_trace
        self._store_unconstrained = store_unconstrained
        self._zarr_store = store
        if settings.seed is None:
            settings.seed = int(np.random.default_rng().integers(0, 2**63 - 1))
        self._seed = int(settings.seed)

        # everything that can refuse the run does so here, before anything runs
        self._mesh = run_mesh(device, settings.num_chains)
        self._device = resolve_device(device if self._mesh is None else self._mesh.device)
        self.rank = 0 if self._mesh is None else self._mesh.rank
        self._cfg = config_from_settings(
            settings, getattr(compiled_model, "_transform_adapt_args", None), self._device)
        self._model: ModelDef = compiled_model._make_model(self._seed)
        self.route = route(self._cfg, self._model)
        self._dtype = resolve_dtype(settings.precision, self._device)
        self._n_chains = settings.num_chains
        self._num_tune = settings.num_tune
        self._total = settings.num_tune + settings.num_draws
        self._init_mean = np.asarray(
            np.zeros(self._model.ndim) if init_mean is None else init_mean)
        itemsize = torch.tensor([], dtype=self._dtype).element_size()
        self._chunk_len = chunk_length(settings, self._n_chains, self._model.ndim, itemsize)
        if self.rank != 0:
            progress_bar = progress_callback = self._zarr_store = None
        self._handlers = make_progress_handlers(
            progress_bar, progress_callback, progress_rate, progress_template, progress_style,
        )
        # the zarr writer in use ("native" or "threads" for a local store)
        self.zarr_writer: Optional[str] = None
        # host seconds the chains' initialization took (None until it ends)
        self.init_s: Optional[float] = None
        self._transfer: Optional[ChunkTransfer] = None
        # the fleet depth cap the last chunk ran under (NUTS)
        self._depth_cap = None

        # control state
        self._pause_evt = threading.Event()
        # set once the loop is parked by pause() with every launched chunk stored
        self._parked_evt = threading.Event()
        self._abort_evt = threading.Event()
        self._finished_evt = threading.Event()
        self._lock = threading.Lock()
        self._chunks: list = []
        self._draws_done = 0
        self._error: Optional[BaseException] = None
        self._progress: list = []
        self._start_time = time.monotonic()
        # the first divergent draws of each chain (the counts are in
        # ChainProgress.divergences); renderers show only a handful
        self._divergent_draws: list = [[] for _ in range(self._n_chains)]
        self._max_divergent_draws = 100

        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- device loop

    def _run(self) -> None:
        try:
            if self._device.type == "cuda":
                # the device's default stream, as a blocking run always had:
                # the allocator caches memory per stream, so a stream of each
                # run's own would strand every earlier run's cache
                with torch.cuda.device(self._device):
                    self._run_inner()
            else:
                self._run_inner()
        except BaseException as err:  # surfaced in wait()
            self._error = err
        finally:
            self._finished_evt.set()
            for h in self._handlers:
                try:
                    h.finalize(self._progress)
                except Exception:
                    traceback.print_exc(file=sys.stderr)

    def _run_inner(self) -> None:
        model, cfg, settings = self._model, self._cfg, self._settings
        n_chains, dtype, device = self._n_chains, self._dtype, self._device
        mesh = self._mesh
        mclmc = self.route == "mclmc"
        init = init_mclmc_chains if mclmc else init_chains
        t0 = time.perf_counter()
        states, ok = init(
            model, cfg, self._seed, n_chains, self._init_mean, dtype, device=device,
            num_try_init=settings.num_try_init, mesh=mesh,
        )
        ok = gather_chains(ok, mesh)  # every rank refuses the same fleet
        self.init_s = time.perf_counter() - t0
        if not bool(ok.all()):
            bad = int((~ok).sum())
            raise RuntimeError(
                f"Logp function returned error for initial positions of {bad} "
                f"chains (tried {settings.num_try_init} points per chain)"
            )
        make_runner = RUNNERS[self.route]
        if mclmc:
            # one runner: MCLMC adapts while tuning, with no pooling
            warm = post = make_runner(model, cfg, self._chunk_len, dtype)
        else:
            pool = dict(pool_step_size=settings.pool_step_size,
                        pool_mass_matrix=settings.pool_mass_matrix, mesh=mesh)
            warm = make_runner(model, cfg, self._chunk_len, dtype, adapt_frozen=False,
                               **pool)
            post = make_runner(model, cfg, self._chunk_len, dtype, adapt_frozen=True,
                               **pool)
        # fleet-relative work cap (NUTS only): a static cap before the first
        # measurement, then the fleet's, frozen with the mass matrix (>= 64
        # chains only: with few chains the median is noise)
        capped = not mclmc and n_chains >= 64
        sched = make_schedule(
            cfg.adapt, self._num_tune, cfg.initial_depth_cap if capped else None
        )
        cap_until = self._num_tune - int(cfg.adapt.freeze_share * self._num_tune)

        # resume BEFORE building the zarr sink: the sink's layout appends
        # from the resumed draw offset
        start = 0
        ckpt_meta = {"seed": self._seed, "settings": settings.as_dict()}
        if self._resume_from is not None:
            states, start, depth_cap, meta = load_state(self._resume_from, states, mesh)
            if depth_cap is not None:
                sched = sched._replace(depth_cap=depth_cap)
            self._resume_offset = start
            if meta.get("seed") != self._seed:
                warnings.warn("resuming a run that was started with a different seed",
                              stacklevel=2)

        sink = sink_dims = sink_coords = None
        if self._zarr_store is not None:
            sink = ZarrTraceSink(
                self._zarr_store, n_chains=n_chains, num_tune=self._num_tune,
                num_draws=settings.num_draws, save_warmup=self._save_warmup,
                chunk_draws=min(16, self._chunk_len), start_offset=self._resume_offset,
                attrs=self._attrs(),
            )
            self.zarr_writer = sink.writer
            sink_dims = {v.name: tuple(v.dims or ()) for v in model.expanded_variables}
            sink_coords = dict(model.coords)
            sink_coords["unconstrained_parameter"] = np.asarray(
                model.unconstrained_labels, dtype=object)

        transfer = self._transfer = ChunkTransfer(device)
        chunk_idx = 0
        stopped = False
        pending = None  # (start, limit, ticket) of the chunk in flight
        while (start < self._total and not stopped) or pending is not None:
            launched = None
            if start < self._total and not stopped:
                if self._pause_evt.is_set() and not self._abort_evt.is_set():
                    # park with the chunk in flight stored, so no draw lands
                    # while paused; the other ranks wait at this boundary
                    if pending is not None:
                        self._finish_chunk(*pending, sink, sink_dims, sink_coords)
                        pending = None
                    self._parked_evt.set()
                    while self._pause_evt.is_set() and not self._abort_evt.is_set():
                        self._signal(_PAUSED)
                        time.sleep(0.01)
                stopped = not self._signal(_STOP if self._abort_evt.is_set() else _GO)
                if not stopped:
                    if (self._checkpoint_path is not None and chunk_idx > 0
                            and chunk_idx % self._checkpoint_every == 0):
                        # states holds exactly `start` draws
                        save_state(self._checkpoint_path, states, start,
                                   None if mclmc else sched.depth_cap, ckpt_meta, mesh)
                    limit = min(self._chunk_len, self._total - start)
                    run_chunk = warm if start < self._num_tune else post
                    states, bufs = run_chunk(states, start, limit, sched)
                    if capped and start + limit <= cap_until:
                        sched = sched._replace(
                            depth_cap=fleet_depth_cap(cfg, bufs, limit, mesh))
                    self._depth_cap = None if mclmc else sched.depth_cap
                    tensors = self._chunk_tensors(states, bufs, start)
                    launched = (start, limit,
                                None if tensors is None else transfer.start(tensors))
                    start += limit
                    chunk_idx += 1
            if pending is not None:
                self._finish_chunk(*pending, sink, sink_dims, sink_coords)
            pending = launched
        if self._checkpoint_path is not None and self._draws_done > 0:
            save_state(self._checkpoint_path, states, self._draws_done,
                       None if mclmc else sched.depth_cap, ckpt_meta, mesh)
        if sink is not None:
            sink.finalize(self._draws_done)

    def _signal(self, flag: int) -> bool:
        """Rank 0's control state at a chunk boundary (``_GO``, ``_PAUSED``,
        ``_STOP``), broadcast through the run's group; whether to launch the
        next chunk.  Another rank waits here while rank 0 is paused."""
        if self.rank == 0:
            return broadcast_flag(flag, self._mesh) == _GO
        while True:
            flag = broadcast_flag(_GO, self._mesh)
            if flag != _PAUSED:
                return flag == _GO

    def _chunk_tensors(self, states, bufs, chunk_start: int) -> Optional[dict]:
        """The device tensors of a launched chunk that the host reads, by
        ``group/name``: its buffers (the gradient only where the user asked
        for it; low-rank adaptation allocates it for its own update), its
        expansion and the progress snapshot (small copies of the chains'
        counters and step sizes, taken after the chunk).  Inside a group the
        buffers and the snapshot are the whole fleet's, gathered to rank 0,
        which expands them; None on the other ranks."""
        kept = {k: v for k, v in bufs._asdict().items()
                if v is not None and (k != "gradient" or self._settings.store_gradient)}
        snap = {k: getattr(states, k).clone() for k in _SNAPSHOT}
        if self._mesh is not None:
            kept, snap = gather_to_root(kept, self._mesh), gather_to_root(snap, self._mesh)
            if self.rank != 0:
                return None
        out = {f"bufs/{k}": v for k, v in kept.items()}
        for k, v in expand_chunk(self._model, kept["position"], chunk_start,
                                 self._seed).items():
            out[f"expanded/{k}"] = v
        out.update({f"snap/{k}": v for k, v in snap.items()})
        return out

    def _finish_chunk(self, p_start: int, p_limit: int, ticket, sink, sink_dims,
                      sink_coords) -> None:
        if self.rank != 0:
            with self._lock:
                self._draws_done = p_start + p_limit
            return
        host: dict = {"bufs": {}, "expanded": {}, "snap": {}}
        for key, arr in self._transfer.fetch(ticket).items():
            group, name = key.split("/", 1)
            host[group][name] = arr
        chunk = chunk_to_host(host["bufs"], host["expanded"], p_limit,
                              self._store_unconstrained,
                              self._cfg.steps_per_draw if self.route == "mclmc" else None,
                              flow=self._cfg.flow is not None)
        with self._lock:
            # zarr runs stream to the store and return a store-backed trace;
            # holding every chunk on the host as well would defeat streaming
            if sink is None or self._return_raw_trace:
                self._chunks.append(chunk)
            self._draws_done = p_start + p_limit
            div_rows = chunk["stats"]["diverging"]
            for c in np.flatnonzero(div_rows.any(axis=1)):
                room = self._max_divergent_draws - len(self._divergent_draws[c])
                if room > 0:
                    idxs = np.flatnonzero(div_rows[c])[:room] + p_start
                    self._divergent_draws[c].extend(int(i) for i in idxs)
        if sink is not None:
            sink.append_chunk(chunk, p_start, sink_dims, sink_coords)
        self._update_progress(host["snap"], chunk["stats"]["n_steps"])

    def _update_progress(self, snap: dict, last_n_steps) -> None:
        if not self._handlers:
            return
        draw_idx, divergences = snap["draw_idx"], snap["divergence_count"]
        total_steps, eps = snap["total_steps"], snap["eps"]
        runtime_ms = (time.monotonic() - self._start_time) * 1000.0
        progress = [
            ChainProgress(
                chain_index=c,
                finished_draws=int(min(draw_idx[c], self._total)),
                total_draws=self._total,
                divergences=int(divergences[c]),
                tuning=bool(draw_idx[c] < self._num_tune),
                started=True,
                finished=bool(draw_idx[c] >= self._total),
                latest_num_steps=int(last_n_steps[c, -1]),
                total_num_steps=int(total_steps[c]),
                step_size=float(eps[c]),
                runtime_ms=runtime_ms,
                divergent_draws=list(self._divergent_draws[c]),
            )
            for c in range(self._n_chains)
        ]
        self._progress = progress
        for h in self._handlers:
            h.update(progress)

    # --------------------------------------------------------------- assembly

    def _attrs(self) -> dict:
        return {
            "inference_library": "nutpie_tpu_torch",
            "inference_library_version": _version,
            "inference_library_settings": self._settings.as_json(),
        }

    def _collect(self) -> Optional[dict]:
        with self._lock:
            if not self._chunks:
                return None
            chunks = list(self._chunks)
        cat = lambda key: {k: np.concatenate([c[key][k] for c in chunks], axis=1)
                           for k in chunks[0][key]}
        return {
            "position": np.concatenate([c["position"] for c in chunks], axis=1),
            "stats": cat("stats"),
            "expanded": cat("expanded"),
        }

    def _extract(self, raw: Optional[dict]):
        if self._return_raw_trace and raw is not None:
            return raw
        if self._zarr_store is not None and not self._return_raw_trace \
                and self._draws_done > 0:
            # a store-backed trace: arrays load from the store on access
            return open_zarr_trace(self._zarr_store)
        if raw is None:
            raise RuntimeError("No draws were produced")
        model = self._model
        dims_map = {v.name: tuple(v.dims or ()) for v in model.expanded_variables}
        coords = dict(model.coords)
        coords.update(self._compiled_model.coords)
        coords["unconstrained_parameter"] = np.asarray(
            model.unconstrained_labels, dtype=object
        )
        unconstrained = None
        if self._store_unconstrained:
            unconstrained = {}
            for v in model.param_variables:
                arr = raw["position"][:, :, v.start_idx : v.end_idx]
                unconstrained[v.name] = arr.reshape(arr.shape[:2] + v.shape)
                dims_map.setdefault(v.name, tuple(v.dims or ()))
        return assemble_trace(
            expanded=raw["expanded"],
            stats=raw["stats"],
            unconstrained=unconstrained,
            num_tune=max(0, self._num_tune - self._resume_offset),
            save_warmup=self._save_warmup,
            dims_map=dims_map,
            coords=coords,
            attrs=self._attrs(),
            reparameterized_names=tuple(model.reparameterized_names),
        )

    # ---------------------------------------------------------------- control

    def wait(self, timeout: Optional[float] = None):
        """Block until sampling finishes and return the trace: the whole
        fleet's on rank 0, and None on the other ranks of a process group.

        Raises ``TimeoutError`` if ``timeout`` (seconds) elapses first, and
        re-raises an error of the sampling thread.
        """
        self._finished_evt.wait(timeout)
        if not self._finished_evt.is_set():
            raise TimeoutError("Sampling did not finish within the timeout")
        self._thread.join()
        if self._error is not None:
            raise self._error
        if self.rank != 0:
            return None
        return self._extract(self._collect())

    def _on_root(self, what: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f"{what}() acts on rank 0 of the process group, which "
                               f"broadcasts it to every rank; this is rank {self.rank}")

    def pause(self):
        """Pause the sampler (at the next chunk boundary)."""
        self._on_root("pause")
        self._pause_evt.set()

    def wait_paused(self, timeout: Optional[float] = None) -> bool:
        """Wait until a paused sampler is parked at a chunk boundary, every
        chunk it launched stored; False if ``timeout`` (seconds) elapses
        first."""
        return self._parked_evt.wait(timeout)

    def resume(self):
        """Resume a paused sampler."""
        self._on_root("resume")
        self._parked_evt.clear()
        self._pause_evt.clear()

    def abort(self):
        """Abort sampling and return the partial trace (None if no draws)."""
        self._on_root("abort")
        self._abort_evt.set()
        self._pause_evt.clear()
        self._thread.join()
        if self._error is not None:
            raise self._error
        raw = self._collect()
        if raw is None and (self._zarr_store is None or self._draws_done == 0):
            return None
        return self._extract(raw)

    def cancel(self):
        """Abort sampling and discard all draws."""
        self._on_root("cancel")
        self._abort_evt.set()
        self._pause_evt.clear()
        self._thread.join()

    def inspect(self):
        """Snapshot the current partial trace while sampling continues
        (None on the ranks other than 0)."""
        if self.rank != 0:
            return None
        return self._extract(self._collect())

    @property
    def is_finished(self) -> bool:
        return self._finished_evt.is_set()

    @property
    def draws_done(self) -> int:
        """Draws of each chain finished so far (on rank 0, stored)."""
        with self._lock:
            return self._draws_done

    @property
    def depth_cap(self) -> Optional[int]:
        """The fleet's tree-depth cap the last chunk ran under (None under
        MCLMC, or before the first chunk)."""
        cap = self._depth_cap
        return None if cap is None else int(cap)

    @property
    def transfer(self) -> Optional[ChunkTransfer]:
        """The run's device-to-host copies (pinned bytes, allocation and
        wait seconds), once the loop has started."""
        return self._transfer

    def __del__(self):
        try:
            self._abort_evt.set()
            self._pause_evt.clear()
        except Exception:
            pass


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
    run batched on the device).  Every call runs in a background thread
    (``_BackgroundSampler``): ``blocking=False`` returns its handle
    (``wait``, ``pause``, ``resume``, ``abort``, ``cancel``, ``inspect``,
    ``is_finished``); otherwise the call waits for the trace, and
    ``KeyboardInterrupt`` aborts with the partial trace.  Progress goes to
    ``progress_callback`` and, with ``progress_bar``, to a terminal bar on
    stderr (HTML in Jupyter or marimo).  ``zarr_store`` streams the trace
    into a Zarr store (``zarr_store.LocalStore``, or any store with a
    transport) and returns a trace backed by it; ``checkpoint`` saves the
    chains' state every ``checkpoint_every`` chunks and at the end, and
    ``resume_from`` continues from such a file.  Extra keyword settings
    include ``precision``, ``chunk_size``, ``pool_mass_matrix`` and
    ``pool_step_size``.  ``device`` defaults to CUDA.  Inside an
    initialized process group (``parallel.initialize_distributed``) every
    rank calls ``sample()`` with the same arguments, ``device`` defaults to
    the rank's own, and the call returns the whole fleet's trace on rank 0
    and None on the other ranks (which take no progress handler, store or
    control call).  ``sampler="mclmc"``
    runs MCLMC (``MclmcSettings``).  ``adaptation="flow"`` trains a
    normalizing flow per chain at warmup chunk boundaries (every
    ``transform_update_freq`` draws; the flow's options through the model's
    ``with_transform_adapt``) and samples in its base space under an
    identity metric; ``store_transformed`` then stores the base-space draws,
    gradients and the flow's mu, and stores nothing without flow
    adaptation, as in the JAX package.
    """
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
    # HMC energies need full-precision products: TF32 would inject O(1e-3)
    # relative error into logp and its gradient (the JAX package forces
    # "highest" matmul precision for the same reason)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    background = _BackgroundSampler(
        compiled_model, settings, init_mean, device=device,
        progress_bar=progress_bar, progress_callback=progress_callback,
        save_warmup=save_warmup, return_raw_trace=return_raw_trace,
        progress_template=progress_template, progress_style=progress_style,
        progress_rate=progress_rate, store=zarr_store,
        store_unconstrained=store_unconstrained, checkpoint=checkpoint,
        checkpoint_every=checkpoint_every, resume_from=resume_from,
    )
    if not blocking:
        return background
    try:
        return background.wait()
    except KeyboardInterrupt:
        if background.rank != 0:
            raise
        return background.abort()
    except BaseException:
        if background.rank == 0:
            background.cancel()
        raise
