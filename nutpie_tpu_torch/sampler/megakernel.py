"""Chunk runner over the hand-written CUDA chunk kernel (whole chunk per launch).

Ports ``nutpie_tpu/sampler/megakernel.py``: ``run_chunk(states,
chunk_start, limit, sched) -> (states, bufs)`` pools the adaptation state
(optional), draws the chunk's per-draw randoms, runs ``start_draw`` and
then ``machine_step`` until every chain has produced ``limit`` draws, and
applies the trapped-chain rescue after warmup chunks.  Pooling and the
rescue read across chains through the runner's mesh (``parallel/mesh.py``),
so a fleet split over the ranks of a group runs each rank's slice in one
launch of its own.

The middle part is ``chunk_kernel``, the wrapper of the CUDA kernel in
``csrc/megakernel.cu``: on CUDA tensors it launches the kernel (one warp
per chain in persistent blocks that take chains from a queue, the radon
log density evaluated in the kernel) and counts the launch; on CPU
tensors it runs the plain version,
``plain_chunk``, a host loop over ``nuts.machine_step``.  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..model import ModelDef
from ..ops import build
from ..parallel.mesh import ChainMesh
from .abi import MkConfig, dtype_suffix, raise_on, sampler_config, schedule_tensor
from .adapt import Schedule
from .nuts import (
    LeapfrogUniformTable,
    NutsConfig,
    init_buffers,
    machine_step,
    start_draw,
)
from .run import draw_randoms, pool_chunk_start, rescue_trapped
from .state import NutsMachineState, state_with

# the kernel is compiled for up to 8 coordinates per lane of a warp
MAX_KERNEL_DIM = 8 * 32


def supports(cfg: NutsConfig) -> bool:
    """Whether the CUDA chunk kernel handles this configuration.

    Exactly the JAX kernel's exclusions
    (``nutpie_tpu/sampler/megakernel.py:62-71``): no flow or low-rank
    adaptation (nor the fixed metric, which only flow reaches in the JAX
    package), no microcanonical kinetic, no ``store_*`` buffer;
    ``sample.route`` sends those to the step kernel.  Every step-size
    method and ``target_integration_time`` run in the kernel.  It also
    needs a model with a ``kernel_model`` (the radon log density it
    evaluates in place); ``sample.route`` checks both.
    """
    return (
        cfg.flow is None
        and cfg.adapt.update_mass_matrix
        and cfg.low_rank is None
        and cfg.kinetic != "microcanonical"
        and not cfg.store_divergences
        and not cfg.store_gradient
        and not cfg.store_mass_matrix
    )


def kernel_config(cfg: NutsConfig, kernel_model, n_chains: int, dim: int,
                  depth_slots: int, chunk_len: int, adapt_frozen: bool) -> MkConfig:
    return sampler_config(
        cfg, n_chains, dim, depth_slots, chunk_len, adapt_frozen,
        n_counties=kernel_model.n_counties,
        n_obs=kernel_model.n_obs,
        n_seg=kernel_model.partition.n_seg,
        obs_rows=kernel_model.obs_rows,
    )


# cfg, scal, key, 12 state/buffer pointers, obs, basis, part, queue; grid; stream
_ENTRY_ARGS = [ctypes.c_void_p] * 18 + [ctypes.c_int, ctypes.c_void_p]

# what nutpie_megakernel_geometry_* reports, in its order
GEOMETRY_FIELDS = (
    "coords_per_lane", "chains_per_block", "smem_bytes_per_block",
    "blocks_per_sm", "sm_count", "registers_per_thread",
    "local_bytes_per_thread", "model_data_bytes", "chain_slice_bytes",
    "max_threads_per_block",
)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the kernel library's entry points."""
    for name in ("nutpie_megakernel_chunk_f32", "nutpie_megakernel_chunk_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _ENTRY_ARGS
        fn.restype = ctypes.c_int
    for name in ("nutpie_megakernel_geometry_f32", "nutpie_megakernel_geometry_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.nutpie_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nutpie_cuda_error_string.restype = ctypes.c_char_p
    return lib


def query_geometry(lib, mk_cfg: MkConfig, dtype) -> dict:
    """What was compiled for this configuration and how it fits on the card
    (``GEOMETRY_FIELDS``, plus the resident chains per SM)."""
    out = (ctypes.c_int32 * len(GEOMETRY_FIELDS))()
    fn = getattr(lib, f"nutpie_megakernel_geometry_{dtype_suffix(dtype)}")
    raise_on(lib, fn(ctypes.byref(mk_cfg), out), "chunk kernel geometry")
    geo = dict(zip(GEOMETRY_FIELDS, out))
    geo["resident_chains_per_sm"] = geo["chains_per_block"] * geo["blocks_per_sm"]
    return geo


def launch_grid(n_chains: int, chains_per_block: int, blocks_per_sm: int,
                sm_count: int) -> int:
    """Blocks of one launch: every resident block slot of the card, but no
    more blocks than chains (warp w of block b starts with chain
    b + blocks * w, so every block gets one)."""
    if min(chains_per_block, blocks_per_sm, sm_count) < 1:
        raise RuntimeError(
            f"chunk kernel does not fit on the card: {chains_per_block} chains "
            f"per block, {blocks_per_sm} blocks per SM, {sm_count} SMs"
        )
    return max(1, min(sm_count * blocks_per_sm, n_chains))


def launch(lib, mk_cfg: MkConfig, scal: torch.Tensor, states: NutsMachineState,
           mom: torch.Tensor, jit: torch.Tensor, pos: torch.Tensor,
           scalars: torch.Tensor, data: dict, queue: torch.Tensor, grid: int,
           stream: int) -> int:
    """Call the C entry point; ``states`` is updated in place.  Returns its code."""
    fn = getattr(lib, f"nutpie_megakernel_chunk_{dtype_suffix(states.vecs.dtype)}")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    return fn(
        ctypes.byref(mk_cfg), ptr(scal), ptr(states.key), ptr(states.vecs),
        ptr(states.ckpt_p), ptr(states.ckpt_s), ptr(states.flts),
        ptr(states.ints), ptr(states.adapt_vecs), ptr(states.adapt_flts),
        ptr(mom), ptr(jit), ptr(pos), ptr(scalars), ptr(data["obs"]),
        ptr(data["basis"]), ptr(data["part"]), ptr(queue), int(grid),
        ctypes.c_void_p(stream),
    )


def plain_chunk(cfg: NutsConfig, model: ModelDef, sched: Schedule,
                chunk_start: int, limit: int, states: NutsMachineState,
                mom: torch.Tensor, jit: torch.Tensor, adapt_frozen: bool):
    """The kernel's plain version: start_draw, then machine_step until done."""
    n_chains, chunk_len, dim = mom.shape
    bufs = init_buffers(chunk_len, dim, states.vecs.dtype, n_chains,
                        device=states.vecs.device)
    states = state_with(states, done=False)
    states = start_draw(cfg, sched, states, mom[:, 0], jit[:, 0])
    uniforms = LeapfrogUniformTable(states.key)
    while not bool(states.done.all()):
        states, bufs = machine_step(
            cfg, model.logp_and_grad, sched, mom, jit, chunk_start, limit,
            states, bufs, adapt_frozen=adapt_frozen, uniforms=uniforms,
        )
    return states, bufs


class ChunkKernel:
    """Wrapper of the CUDA chunk kernel, with its launch count.

    ``launches`` is a plain integer, raised by one at each kernel launch
    and nowhere else; the plain version on CPU tensors leaves it alone.
    """

    name = "megakernel_chunk"
    source = "nutpie_tpu_torch/csrc/megakernel.cu"
    replaces = "nutpie_tpu/sampler/megakernel.py:368"

    def __init__(self):
        self.launches = 0
        self._data: dict = {}
        self._geometry: dict = {}

    def library(self):
        return bind(build.load("megakernel"))

    def _kernel_data(self, kernel_model, device, dtype) -> dict:
        key = (id(kernel_model), str(device), dtype)
        if key not in self._data:
            self._data[key] = (kernel_model, kernel_model.tensors(device, dtype))
        return self._data[key][1]

    def geometry(self, mk_cfg: MkConfig, dtype, device) -> dict:
        """``query_geometry`` once per device, dtype and data shape."""
        key = (str(device), dtype, mk_cfg.dim, mk_cfg.depth_slots,
               mk_cfg.n_counties, mk_cfg.n_seg, mk_cfg.obs_rows, mk_cfg.step_method)
        if key not in self._geometry:
            with torch.cuda.device(device):
                self._geometry[key] = query_geometry(self.library(), mk_cfg, dtype)
        return self._geometry[key]

    def __call__(self, cfg: NutsConfig, model: ModelDef, sched: Schedule,
                 chunk_start: int, limit: int, states: NutsMachineState,
                 mom: torch.Tensor, jit: torch.Tensor, adapt_frozen: bool):
        if not states.vecs.is_cuda:
            return plain_chunk(cfg, model, sched, chunk_start, limit, states,
                               mom, jit, adapt_frozen)
        n_chains, chunk_len, dim = mom.shape
        dtype = states.vecs.dtype
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"chunk kernel takes float32 or float64, got {dtype}")
        out = states.clone()
        tensors = list(out.tensors().values()) + [mom, jit]
        for t in tensors:
            if not t.is_cuda or not t.is_contiguous() or t.device != out.vecs.device:
                raise ValueError("chunk kernel needs contiguous tensors on one CUDA device")
        if out.key.dtype != torch.int64 or out.ints.dtype != torch.int32:
            raise TypeError("key data must be int64 and ints int32")
        if mom.dtype != dtype or jit.dtype != dtype:
            raise TypeError("randoms must have the state's dtype")
        km = model.kernel_model
        if dim != 5 + 2 * (km.n_counties - 1):
            raise ValueError(f"kernel model expects dim {5 + 2 * (km.n_counties - 1)}, got {dim}")
        if dim > MAX_KERNEL_DIM:
            raise ValueError(f"chunk kernel takes at most {MAX_KERNEL_DIM} dimensions, got {dim}")
        lib = self.library()
        device = out.vecs.device
        mk_cfg = kernel_config(cfg, km, n_chains, dim, out.ckpt_p.shape[1],
                               chunk_len, adapt_frozen)
        geo = self.geometry(mk_cfg, dtype, device)
        grid = launch_grid(n_chains, geo["chains_per_block"], geo["blocks_per_sm"],
                           geo["sm_count"])
        bufs = init_buffers(chunk_len, dim, dtype, n_chains, device=device)
        scal = schedule_tensor(chunk_start, limit, sched, device)
        data = self._kernel_data(km, device, dtype)
        # the chain queue: each warp takes its next chain from this counter
        queue = torch.zeros(1, dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = launch(lib, mk_cfg, scal, out, mom, jit, bufs.position,
                          bufs.scalars, data, queue, grid, stream)
        raise_on(lib, code, "chunk kernel launch")
        self.launches += 1
        return out, bufs


chunk_kernel = ChunkKernel()


class MegakernelChunkRunner:
    """``run_chunk(states, chunk_start, limit, sched) -> (states, bufs)``."""

    def __init__(self, model: ModelDef, cfg: NutsConfig, chunk_len: int, dtype,
                 adapt_frozen: bool = True, pool_step_size: bool = False,
                 pool_mass_matrix: bool = False, mesh: Optional[ChainMesh] = None):
        self.model = model
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.dtype = dtype
        self.adapt_frozen = adapt_frozen
        self.pool_step_size = pool_step_size
        self.pool_mass_matrix = pool_mass_matrix
        self.mesh = mesh

    def __call__(self, states: NutsMachineState, chunk_start: int, limit: int,
                 sched: Schedule):
        states = pool_chunk_start(states, self.pool_mass_matrix, self.pool_step_size,
                                  self.mesh)
        dim = states.vecs.shape[-1]
        mom, jit = draw_randoms(states.key, int(chunk_start), self.chunk_len,
                                dim, self.dtype)
        states, bufs = chunk_kernel(
            self.cfg, self.model, sched, int(chunk_start), int(limit), states,
            mom, jit, self.adapt_frozen,
        )
        if not self.adapt_frozen:
            states = rescue_trapped(states, int(chunk_start), int(limit), sched, self.mesh)
        return states, bufs


def make_megakernel_chunk_runner(model: ModelDef, cfg: NutsConfig, chunk_len: int,
                                 dtype, adapt_frozen: bool = True,
                                 pool_step_size: bool = False,
                                 pool_mass_matrix: bool = False,
                                 mesh: Optional[ChainMesh] = None) -> MegakernelChunkRunner:
    """Build the chunk runner (same call semantics as the JAX function;
    ``mesh``: the ranks the fleet is split over)."""
    return MegakernelChunkRunner(
        model, cfg, chunk_len, dtype, adapt_frozen=adapt_frozen,
        pool_step_size=pool_step_size, pool_mass_matrix=pool_mass_matrix, mesh=mesh,
    )
