"""Wrapper of the CUDA step kernel (K2): the machine step around a torch logp.

A machine step splits at the log density into a first half (uniforms,
direction, the slot-(D-1) stash, first half-kick, drift; writes ``z_new``)
and a second half (everything after the gradient).  ``csrc/step_kernel.cu``
runs them as one launch per machine step: ``advance`` takes the second half
of step k and the first half of step k + 1 for every chain, after one
batched ``model.logp_and_grad(z_new)``; ``begin`` runs a chunk's first
first half alone.  The plain version is ``nuts.leapfrog_begin`` and, for
``advance``, ``nuts.leapfrog_finish`` followed by ``nuts.leapfrog_begin``.

``step_kernel.chunk(...)`` prepares one chunk and returns its steps:

- on CUDA tensors, ``KernelSteps``: it checks device, dtype, shape and
  contiguity once, decides the launch (``diag_plan`` for the diagonal
  metric, ``low_rank_plan`` for the low-rank one), allocates the chunk's
  scratch (``z_new [C, dim]``, the step's uniforms ``[C, 3]``, the stagnant
  flags ``[C]`` and, under the low-rank metric, the velocities the kernel
  keeps beside the trajectory's edges and checkpoints, ``[C, 2, dim]`` and
  ``[C, D, dim]``, filled here from the chunk's starting state by the plain
  metric) with ``torch.empty``, and each ``begin``/``advance`` launches the
  kernel on the current stream, raising if the launch fails.  The kernel
  updates the chunk's state tensors and buffers **in place**: the caller
  hands it a state of its own (the chunk runner clones once per chunk) and
  gets the same tensors back.  ``z_new`` is rewritten at every step, so a
  log density must not keep its input.  The launches may be captured in a
  CUDA graph (``StepGraph``): a launch takes torch's current stream, the
  capture stream under capture, and its arguments are fixed at capture;
- on CPU tensors, ``PlainSteps``: the plain halves, with the uniforms from
  a ``LeapfrogUniformTable``.

Under the microcanonical kinetic (``NutsConfig.kinetic``) the kernel runs
its MICRO instantiations: the isokinetic velocity half-updates around the
drift along ``A u``, with the chunk's scratch rows ``mc_rows [C, 2, dim]``
(the first half's velocity, carried to the second half, and the
pulled-back gradient of the low-rank metric) and ``mc_dke [C]``.

The diagonal metric runs ``diag_plan``'s form: held, 8 (float32) or 16
(float64) lanes of a warp per chain, each thread owning at most two chunks
of coordinates moved by 16-byte vector loads, where dim <= 64 allows; or
strided, 32 lanes per chain over any dim.
Under low-rank adaptation the state carries the metric (``lr_basis [C,
dim, R]``, ``lr_log_eigs [C, R]``, R <= 32) and the kernel takes its
low-rank branch: a block of ``LR_WARPS`` warps per chain with the chain's
basis in shared memory.  ``low_rank_plan`` decides how, from the shapes
and the card's shared memory, before anything runs: the whole basis
staged once per launch where it fits, or streamed through a ring of tiles
where it does not; by TMA bulk copies where a chain's basis is 16-byte
aligned, by the warps' own loads where not.  Both plans travel in
``MkConfig`` (``lr_rank`` 0 for the diagonal metric), and the kernel
refuses a launch whose plan or rows do not match what it was built for.
The commit also writes the optional buffers the chunk has (``gradient``,
``mass_matrix_inv``, ``mass_matrix_eigvals``, and with ``store_divergences``
the four divergence buffers from the state's divergence rows, which the
kernel's instantiations with those rows carry: ``vecs`` then has 18 rows).

Flow adaptation runs the kernel under a fixed metric (``MkConfig.
fixed_metric``, from ``update_mass_matrix=False``: the Welford windows run
on, the inverse mass stays, the step-size shift is 0), a runtime field of
every instantiation.  With ``use_orbit`` the state carries the orbit
reservoir's rows (``orbit [C, 2, dim]``): each step's first half draws the
reservoir's uniform beside the step's three (``orbit_u [C]``, scratch), the
second half replaces the rows by the new point and its gradient with
probability one over the draw's leaves, and the commit writes them into
the ``orbit_position`` / ``orbit_gradient`` buffers.

There is no fallback between the two.  ``launches`` counts the kernel's
launches the card executes (one per machine step and one per chunk),
graph replays included, and nothing else.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import build, graphs
from .abi import MkConfig, dtype_suffix, raise_on, sampler_config, schedule_tensor
from .adapt import Schedule
from .nuts import (
    ChunkBuffers,
    LeapfrogUniformTable,
    DIV_BUFFERS,
    NutsConfig,
    leapfrog_begin,
    leapfrog_finish,
    n_vec_rows,
    turn_velocity_rows,
)
from .state import N_ADAPT_FLT, N_ADAPT_VEC, N_FLT, N_INT, VEC_SLOTS, NutsMachineState

def unsupported(cfg: NutsConfig) -> Optional[str]:
    """What of this configuration the step kernel leaves out, or None."""
    if cfg.low_rank is not None and not 0 < cfg.low_rank.max_rank <= MAX_RANK:
        return f"low-rank max_rank {cfg.low_rank.max_rank}: the step kernel takes 1..{MAX_RANK}"
    return None


# the largest low-rank metric the kernel takes (one rank per lane)
MAX_RANK = 32
# the low-rank instantiations (csrc/lowrank.cuh: kLrWarps, kTileRows,
# kRingStages): warps per chain, basis rows per tile (one warp's block of
# coordinates), and the ring slots per warp of the streamed form (a copy in
# flight while the warp reads a tile)
LR_WARPS = 8
TILE_ROWS = 32
RING_STAGES = 2
# threads an SM holds
SM_THREADS = 2048


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


def lr_smem_bytes(dim: int, rank: int, itemsize: int, streamed: bool) -> int:
    """Dynamic shared memory of a low-rank block, as ``LrLayout`` in
    ``csrc/lowrank.cuh`` lays it out (chip_smoke's build phase holds the
    two equal on the card): the barriers (one per tile staged, one per ring
    slot streamed), the reductions' scratch and each warp's coefficients,
    then the tiles (the whole basis staged, ``LR_WARPS * RING_STAGES``
    slots streamed)."""
    n_tiles = -(-dim // TILE_ROWS)
    n_bars = LR_WARPS * RING_STAGES if streamed else n_tiles
    red = _align(n_bars * 8, 16)
    coef = red + LR_WARPS * 32 * itemsize
    tiles = _align(coef + LR_WARPS * 32 * itemsize, 128)
    if streamed:
        return tiles + LR_WARPS * RING_STAGES * TILE_ROWS * rank * itemsize
    return tiles + _align(dim * rank * itemsize, 16)


@dataclass(frozen=True)
class LowRankPlan:
    """How the low-rank instantiations run one launch (``low_rank_plan``)."""

    form: str           # "staged": read once a launch; "streamed": twice an application
    copy: str           # "tma": bulk copies; "loads": the warps' own loads
    warps: int          # warps per chain (a block runs one chain at a time)
    stages: int         # ring slots per warp (streamed; 0 staged)
    basis_bytes: int    # one chain's basis
    smem_bytes: int     # dynamic shared memory of a block
    blocks_per_sm: int  # resident blocks an SM's shared memory and threads allow
    grid: int           # persistent blocks of a launch: every resident slot, at most a chain each
    chains_per_block: int  # the most chains a block runs in turn


def low_rank_plan(n_chains: int, dim: int, rank: int, itemsize: int, smem_per_block: int,
                  sm_count: int, smem_per_sm: int, reserved_per_block: int = 0,
                  aligned: bool = True) -> LowRankPlan:
    """The low-rank launch for these shapes on a card with this shared
    memory (bytes a block may opt in to, per SM, and kept by the system per
    block) and these SMs: the basis staged whole if it fits a block beside
    the barriers and scratch, else streamed through a ring of
    ``RING_STAGES`` tiles per warp; bulk copies where a chain's basis is
    16-byte aligned (``aligned``: the tensor's start is), else loads.
    Raises if neither fits."""
    if not 0 < rank <= MAX_RANK or dim < 1 or n_chains < 1:
        raise ValueError(f"low-rank plan of {n_chains} chains, dim {dim}, rank {rank}")
    basis = dim * rank * itemsize
    form, stages = "staged", 0
    smem = lr_smem_bytes(dim, rank, itemsize, False)
    if smem > smem_per_block:
        form, stages = "streamed", RING_STAGES
        smem = lr_smem_bytes(dim, rank, itemsize, True)
    if smem > smem_per_block:
        raise RuntimeError(
            f"the low-rank step kernel does not fit: dim {dim}, rank {rank}, {itemsize}-byte "
            f"values need {smem} bytes of shared memory a block streamed, the card allows "
            f"{smem_per_block}")
    threads = LR_WARPS * 32
    blocks = min(smem_per_sm // (smem + reserved_per_block), SM_THREADS // threads)
    if blocks < 1 or sm_count < 1:
        raise RuntimeError(f"the low-rank step kernel does not fit: {smem} bytes a block, "
                           f"{smem_per_sm} an SM, {sm_count} SMs")
    return LowRankPlan(
        form=form, copy="tma" if aligned and basis % 16 == 0 else "loads", warps=LR_WARPS,
        stages=stages, basis_bytes=basis, smem_bytes=smem, blocks_per_sm=blocks,
        grid=min(n_chains, blocks * sm_count),
        chains_per_block=-(-n_chains // min(n_chains, blocks * sm_count)))


# the diagonal instantiations (csrc/step_kernel.cu: DiagForms): threads a
# block, and the chunks a thread of the held form owns in registers
BLOCK_THREADS = 128
HELD = 2


def diag_forms(itemsize: int) -> tuple:
    """(lanes a chain, coordinates a chunk, chunks held) of each diagonal
    instantiation, in ``DiagForms``' order: held (16-byte chunks, as many
    lanes as tile a warp's 32 coordinates) and strided (32 lanes, single
    coordinates, any number a thread)."""
    vec = 16 // itemsize
    return ((32 // vec, vec, HELD), (32, 1, 0))


@dataclass(frozen=True)
class DiagPlan:
    """How the diagonal instantiations run one launch (``diag_plan``)."""

    form: str              # "held" or "strided"
    lanes: int             # lanes of a warp per chain: 8 or 16 held, 32 strided
    vec: int               # coordinates a chunk, moved by one load or store
    held: int              # chunks a thread holds in registers (0: any number)
    coords_per_lane: int   # the most coordinates a thread owns
    chains_per_block: int
    grid: int              # blocks of a launch
    one_wave_blocks_per_sm: int  # resident blocks an SM needs to run the grid in one wave


def diag_plan(n_chains: int, dim: int, itemsize: int, sm_count: int) -> DiagPlan:
    """The diagonal launch for these shapes on a card with ``sm_count`` SMs.

    The held form where ``dim`` is a multiple of the 16-byte chunk (4
    coordinates in float32, 2 in float64) and each of its 8 (float32) or
    16 (float64) lanes owns at most ``HELD`` chunks, that is dim <= 64:
    a lane then owns 2-8 coordinates, several chains share a warp, and
    the next step's drift stays in registers.  Else the strided form, 32
    lanes striding over any dim."""
    if n_chains < 1 or dim < 1 or sm_count < 1 or itemsize not in (4, 8):
        raise ValueError(f"diagonal plan of {n_chains} chains, dim {dim}, "
                         f"{itemsize}-byte values, {sm_count} SMs")
    held_form, strided_form = diag_forms(itemsize)
    lanes, vec, held = held_form
    form = "held"
    if dim % vec or dim // vec > held * lanes:
        (lanes, vec, held), form = strided_form, "strided"
    per_block = BLOCK_THREADS // lanes
    grid = -(-n_chains // per_block)
    return DiagPlan(form=form, lanes=lanes, vec=vec, held=held,
                    coords_per_lane=vec * -(-(dim // vec) // lanes),
                    chains_per_block=per_block, grid=grid,
                    one_wave_blocks_per_sm=-(-grid // sm_count))


def plan_fields(plan) -> dict:
    """A plan's ``MkConfig`` fields (``LowRankPlan`` or ``DiagPlan``); the
    other plan's stay 0."""
    if isinstance(plan, LowRankPlan):
        return {"lr_streamed": int(plan.form == "streamed"), "lr_tma": int(plan.copy == "tma"),
                "lr_grid": plan.grid}
    if isinstance(plan, DiagPlan):
        return {"step_lanes": plan.lanes, "step_vec": plan.vec, "step_held": plan.held,
                "step_grid": plan.grid}
    return {}


class StepPtrs(ctypes.Structure):
    """Mirror of ``StepPtrs`` in ``csrc/step_kernel.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "scal", "key", "vecs", "ckpt_p", "ckpt_s", "flts", "ints", "adapt_vecs",
        "adapt_flts", "mom", "jit", "pos_out", "scal_out", "z_new", "u3",
        "stagnant", "logp", "grad", "lr_basis", "lr_log_eigs", "edge_v", "ckpt_v",
        "grad_out", "minv_out", "eig_out", "div_start_out", "div_end_out", "div_mom_out",
        "div_grad_out", "mc_rows", "mc_dke", "orbit", "orbit_u", "orbit_pos_out",
        "orbit_grad_out",
    )]


# what nutpie_step_geometry_* reports, in its order: for each diagonal form
# (``diag_forms``' order), without and then with the divergence rows
# ("div_"), and the same four instantiations for Adam ("adam_"), its
# registers and spill bytes a thread and the blocks an SM holds, their
# threads a block; the low-rank instantiation's registers, spill bytes and
# threads, the registers and spill bytes of its Adam instantiation, of the
# one with the rows and of Adam's with the rows, then for a low-rank plan
# its dynamic shared memory and the blocks an SM holds
DIAG_FORM_TAGS = tuple(f"{method}{rows}{form}" for method in ("", "adam_")
                       for rows in ("", "div_") for form in ("held", "strided"))
_DIAG_FIELDS = ("registers", "local_bytes", "blocks_per_sm")
_LR_TAGS = ("lr", "adam_lr", "div_lr", "adam_div_lr")
# then the microcanonical kinetic's instantiations ("micro_"): the eight
# diagonal ones, and the four low-rank ones' registers and spill bytes
GEOMETRY_FIELDS = tuple(f"{tag}_{field}" for tag in DIAG_FORM_TAGS
                        for field in _DIAG_FIELDS) + (
    "threads_per_block", "lr_registers", "lr_local_bytes", "lr_threads_per_block",
    "adam_lr_registers", "adam_lr_local_bytes", "div_lr_registers", "div_lr_local_bytes",
    "adam_div_lr_registers", "adam_div_lr_local_bytes", "lr_smem_bytes", "lr_blocks_per_sm",
) + tuple(f"micro_{tag}_{field}" for tag in DIAG_FORM_TAGS for field in _DIAG_FIELDS) + tuple(
    f"micro_{tag}_{field}" for tag in _LR_TAGS for field in ("registers", "local_bytes"))
# what nutpie_step_device reports, in its order
DEVICE_FIELDS = ("smem_per_block", "smem_per_sm", "sm_count", "reserved_per_block")


def bind(lib: ctypes.CDLL, sfx: str) -> ctypes.CDLL:
    """Set the C signatures of the entry points of the kernel library of
    one dtype (``sfx``: "f32" or "f64")."""
    for half in ("begin", "advance"):
        fn = getattr(lib, f"nutpie_step_{half}_{sfx}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = getattr(lib, f"nutpie_step_geometry_{sfx}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return bind_device(lib)


def bind_device(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the device query and the error string,
    which every library built from the step kernel's source holds."""
    lib.nutpie_step_device.argtypes = [ctypes.c_void_p]
    lib.nutpie_step_device.restype = ctypes.c_int
    lib.nutpie_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nutpie_cuda_error_string.restype = ctypes.c_char_p
    return lib


class PlainSteps:
    """The kernel's plain version over one chunk (CPU tensors)."""

    def __init__(self, cfg: NutsConfig, sched: Schedule, chunk_start: int,
                 limit: int, states: NutsMachineState, mom: torch.Tensor,
                 jit: torch.Tensor, bufs: ChunkBuffers, adapt_frozen: bool):
        self.cfg, self.sched = cfg, sched
        self.chunk_start, self.limit = chunk_start, limit
        self.mom, self.jit, self.bufs = mom, jit, bufs
        self.adapt_frozen = adapt_frozen
        self.uniforms = LeapfrogUniformTable(states.key)

    def begin(self, states: NutsMachineState):
        return leapfrog_begin(self.cfg, states, self.uniforms)

    def advance(self, states: NutsMachineState, z_new, carry, logp, grad):
        """The step's second half, then the next step's first:
        ``(states, z_new, carry)``."""
        states, _ = leapfrog_finish(
            self.cfg, self.sched, self.mom, self.jit, self.chunk_start,
            self.limit, states, z_new, carry, logp, grad, self.bufs,
            self.adapt_frozen,
        )
        return (states, *leapfrog_begin(self.cfg, states, self.uniforms))


def metric_rank(cfg: NutsConfig, states: NutsMachineState) -> int:
    """R of the state's low-rank metric (0: diagonal), checked against the
    configuration."""
    R = 0 if cfg.low_rank is None else cfg.low_rank.max_rank
    if (states.lr_basis is None) != (R == 0) or (states.lr_log_eigs is None) != (R == 0):
        raise ValueError("the state's low-rank metric does not match the configuration")
    if not 0 <= R <= MAX_RANK:
        raise ValueError(f"step kernel takes a low-rank metric of rank <= {MAX_RANK}, got {R}")
    return R


def _check_chunk(cfg: NutsConfig, states: NutsMachineState, mom, jit, bufs: ChunkBuffers,
                 R: int):
    """Device, dtype, shape and contiguity of everything a chunk launches on."""
    dtype = states.vecs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"step kernel takes float32 or float64, got {dtype}")
    C, _, dim = states.vecs.shape
    D = states.ckpt_p.shape[1]
    L = mom.shape[1]
    shapes = {
        "key": (C, 2), "vecs": (C, n_vec_rows(cfg), dim), "ckpt_p": (C, D, dim),
        "ckpt_s": (C, D, dim), "flts": (C, N_FLT), "ints": (C, N_INT),
        "adapt_vecs": (C, N_ADAPT_VEC, dim), "adapt_flts": (C, N_ADAPT_FLT),
        "lr_basis": (C, dim, R), "lr_log_eigs": (C, R),
        "mom": (C, L, dim), "jit": (C, L), "position": (C, L, dim),
        "scalars": (C, L, bufs.scalars.shape[-1]),
        "gradient": (C, L, dim), "mass_matrix_inv": (C, L, dim),
        "mass_matrix_eigvals": (C, L, R), **{name: (C, L, dim) for name in DIV_BUFFERS},
        "orbit": (C, 2, dim), "orbit_position": (C, L, dim), "orbit_gradient": (C, L, dim),
    }
    optional = {name: getattr(bufs, name)
                for name in ("gradient", "mass_matrix_inv", "mass_matrix_eigvals", *DIV_BUFFERS,
                             "orbit_position", "orbit_gradient")
                if getattr(bufs, name) is not None}
    if cfg.store_divergences and len(optional.keys() & DIV_BUFFERS.keys()) != len(DIV_BUFFERS):
        raise ValueError("step kernel: store_divergences needs the four divergence buffers")
    if cfg.use_orbit != (states.orbit is not None) or cfg.use_orbit != (
            bufs.orbit_position is not None and bufs.orbit_gradient is not None):
        raise ValueError("step kernel: use_orbit needs the state's orbit rows and both "
                         "orbit buffers, and nothing else has them")
    # the state's fields the kernel reads (a flow's are the log density's)
    tensors = dict({k: t for k, t in states.tensors().items() if k in shapes}, mom=mom,
                   jit=jit, position=bufs.position, scalars=bufs.scalars, **optional)
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"step kernel: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if not t.is_cuda or t.device != states.vecs.device or not t.is_contiguous():
            raise ValueError("step kernel needs contiguous tensors on one CUDA device")
        want = {"key": torch.int64, "ints": torch.int32}.get(name, dtype)
        if t.dtype != want:
            raise TypeError(f"step kernel: {name} is {t.dtype}, expected {want}")
    if D < 2:
        raise ValueError(f"step kernel needs at least 2 checkpoint slots, got {D}")


class KernelSteps:
    """One chunk's launches of the CUDA step kernel (CUDA tensors)."""

    def __init__(self, owner: "StepKernel", cfg: NutsConfig, sched: Schedule,
                 chunk_start: int, limit: int, states: NutsMachineState,
                 mom: torch.Tensor, jit: torch.Tensor, bufs: ChunkBuffers,
                 adapt_frozen: bool):
        R = metric_rank(cfg, states)
        _check_chunk(cfg, states, mom, jit, bufs, R)
        self.owner = owner
        self.lib = owner.library(states.vecs.dtype)
        self.states = states
        self.dtype = states.vecs.dtype
        self.device = states.vecs.device
        C, _, dim = states.vecs.shape
        self.shape = (C, dim)
        # the launch, decided here before anything runs
        if R:
            self.plan = owner.plan(C, dim, R, self.dtype, self.device,
                                   aligned=states.lr_basis.data_ptr() % 16 == 0)
        else:
            self.plan = owner.diag_plan(C, dim, self.dtype, self.device)
        self.cfg = sampler_config(cfg, C, dim, states.ckpt_p.shape[1],
                                  mom.shape[1], adapt_frozen, lr_rank=R,
                                  **plan_fields(self.plan))
        sfx = dtype_suffix(self.dtype)
        self.fns = {half: getattr(self.lib, f"nutpie_step_{half}_{sfx}")
                    for half in ("begin", "advance")}
        # the chunk's scratch, and everything the pointers below refer to
        self.z_new = torch.empty((C, dim), dtype=self.dtype, device=self.device)
        self.u3 = torch.empty((C, 3), dtype=torch.float32, device=self.device)
        self.stagnant = torch.empty((C,), dtype=torch.int32, device=self.device)
        self.edge_v = self.ckpt_v = None
        if R:
            edges = states.vecs[:, [VEC_SLOTS["p_minus"], VEC_SLOTS["p_plus"]]]
            self.edge_v = turn_velocity_rows(cfg, states, edges).contiguous()
            self.ckpt_v = turn_velocity_rows(cfg, states, states.ckpt_p).contiguous()
        # the microcanonical kinetic's rows (the first half's velocity, the
        # pulled-back gradient) and the first half's kinetic change
        self.mc_rows = self.mc_dke = None
        if cfg.micro:
            self.mc_rows = torch.empty((C, 2, dim), dtype=self.dtype, device=self.device)
            self.mc_dke = torch.empty((C,), dtype=self.dtype, device=self.device)
        # use_orbit: each step's reservoir uniform (first half -> second)
        self.orbit_u = (torch.empty((C,), dtype=torch.float32, device=self.device)
                        if cfg.use_orbit else None)
        self.scal = schedule_tensor(chunk_start, limit, sched, self.device)
        self.keep = (mom, jit, bufs)
        ptr = lambda t: None if t is None else t.data_ptr()
        self.ptrs = StepPtrs(
            scal=ptr(self.scal), key=ptr(states.key), vecs=ptr(states.vecs),
            ckpt_p=ptr(states.ckpt_p), ckpt_s=ptr(states.ckpt_s),
            flts=ptr(states.flts), ints=ptr(states.ints),
            adapt_vecs=ptr(states.adapt_vecs), adapt_flts=ptr(states.adapt_flts),
            mom=ptr(mom), jit=ptr(jit), pos_out=ptr(bufs.position),
            scal_out=ptr(bufs.scalars), z_new=ptr(self.z_new), u3=ptr(self.u3),
            stagnant=ptr(self.stagnant), logp=None, grad=None,
            lr_basis=ptr(states.lr_basis), lr_log_eigs=ptr(states.lr_log_eigs),
            edge_v=ptr(self.edge_v), ckpt_v=ptr(self.ckpt_v), grad_out=ptr(bufs.gradient),
            minv_out=ptr(bufs.mass_matrix_inv), eig_out=ptr(bufs.mass_matrix_eigvals),
            div_start_out=ptr(bufs.divergence_start), div_end_out=ptr(bufs.divergence_end),
            div_mom_out=ptr(bufs.divergence_momentum),
            div_grad_out=ptr(bufs.divergence_start_gradient),
            mc_rows=ptr(self.mc_rows), mc_dke=ptr(self.mc_dke), orbit=ptr(states.orbit),
            orbit_u=ptr(self.orbit_u), orbit_pos_out=ptr(bufs.orbit_position),
            orbit_grad_out=ptr(bufs.orbit_gradient),
        )

    def _launch(self, half: str, states: NutsMachineState) -> None:
        if states.vecs is not self.states.vecs:
            raise ValueError("the step kernel updates its chunk's state in place; "
                             "pass the state the chunk was prepared with")
        with torch.cuda.device(self.device):
            # the current stream: the capture stream while a graph captures
            stream = torch.cuda.current_stream(self.device).cuda_stream
            code = self.fns[half](ctypes.byref(self.cfg), ctypes.byref(self.ptrs),
                                  ctypes.c_void_p(stream))
        raise_on(self.lib, code, f"step kernel {half} launch")
        # a captured launch runs, and counts, at each replay of its graph
        if torch.cuda.is_current_stream_capturing():
            self.owner.captured += 1
        else:
            self.owner.launches += 1

    def begin(self, states: NutsMachineState):
        self._launch("begin", states)
        return self.z_new, None

    def advance(self, states: NutsMachineState, z_new, carry, logp, grad):
        """The step's second half, then the next step's first:
        ``(states, z_new, carry)`` (the same tensors, updated)."""
        C, dim = self.shape
        if tuple(logp.shape) != (C,) or tuple(grad.shape) != (C, dim):
            raise ValueError(f"log density gave shapes {tuple(logp.shape)} and "
                             f"{tuple(grad.shape)}, expected {(C,)} and {(C, dim)}")
        if logp.device != self.device or grad.device != self.device:
            raise ValueError("the log density's outputs must be on the state's device")
        logp = logp.detach().to(self.dtype).contiguous()
        grad = grad.detach().to(self.dtype).contiguous()
        if grad.data_ptr() % 16:
            grad = grad.clone()  # a fresh allocation: vector loads need 16 bytes
        self.ptrs.logp, self.ptrs.grad = logp.data_ptr(), grad.data_ptr()
        self._launch("advance", states)
        return states, self.z_new, None


class StepGraph:
    """Machine steps of one chunk captured once in a CUDA graph and replayed.

    ``capture(fn)`` runs ``fn`` (log densities and ``advance`` launches on
    one chunk's ``KernelSteps``) under capture (``ops.graphs.capture``),
    into the memory pool ``pool`` (one the caller's earlier graphs used, or
    a new one); ``replay()`` runs it on the current stream and adds its step
    kernel launches to ``launches``.  The work is queued, not run, by the
    capture.
    """

    def __init__(self, owner: "StepKernel", device):
        self.owner = owner
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        self.launches = 0

    def capture(self, fn, pool=None) -> None:
        before = self.owner.captured
        graphs.capture(fn, self.device, self.graph, pool)
        self.launches = self.owner.captured - before

    def replay(self) -> None:
        self.graph.replay()
        self.owner.launches += self.launches
        self.owner.replays += 1


class StepKernel:
    """Wrapper of the CUDA step kernel, with its launch count.

    ``launches`` is a plain integer, raised by one at each kernel launch
    the card executes (``begin`` and ``advance`` alike; a graph's replay
    adds the launches it captured) and nowhere else; the plain version on
    CPU tensors leaves it alone.  ``replays`` counts graph replays,
    ``capture_s`` the host seconds the step runner spent capturing them,
    and ``captured`` the launches recorded under capture.
    """

    name = "step_kernel"
    source = "nutpie_tpu_torch/csrc/step_kernel.cu"
    replaces = "nutpie_tpu/sampler/run.py:432-440 (XLA loop body)"

    def __init__(self):
        self.launches = 0
        self.replays = 0
        self.capture_s = 0.0
        self.captured = 0
        self._devices: dict = {}

    def library(self, dtype):
        """The kernel library of ``dtype``'s instantiations (each dtype's
        compiles in an nvcc process of its own, ``ops/build.py:VARIANTS``)."""
        sfx = dtype_suffix(dtype)
        return bind(build.load(f"step_kernel_{sfx}"), sfx)

    def device_limits(self, device) -> dict:
        """``DEVICE_FIELDS`` of a CUDA device, queried once (through the
        library that holds the query alone)."""
        device = torch.device(device)
        key = device.index if device.index is not None else torch.cuda.current_device()
        if key not in self._devices:
            lib = bind_device(build.load("step_device"))
            out = (ctypes.c_int32 * len(DEVICE_FIELDS))()
            with torch.cuda.device(key):
                raise_on(lib, lib.nutpie_step_device(out), "step kernel device query")
            self._devices[key] = dict(zip(DEVICE_FIELDS, out))
        return self._devices[key]

    def plan(self, n_chains: int, dim: int, rank: int, dtype, device,
             aligned: bool = True) -> LowRankPlan:
        """``low_rank_plan`` on ``device``'s shared memory and SMs."""
        d = self.device_limits(device)
        return low_rank_plan(n_chains, dim, rank, torch.empty((), dtype=dtype).element_size(),
                             d["smem_per_block"], d["sm_count"], d["smem_per_sm"],
                             d["reserved_per_block"], aligned=aligned)

    def diag_plan(self, n_chains: int, dim: int, dtype, device) -> DiagPlan:
        """``diag_plan`` on ``device``'s SMs."""
        return diag_plan(n_chains, dim, torch.empty((), dtype=dtype).element_size(),
                         self.device_limits(device)["sm_count"])

    def geometry(self, dtype, n_chains: int = 1, dim: int = 1, rank: int = 0,
                 device="cuda") -> dict:
        """Registers, spill bytes and resident blocks of the kernels as
        compiled, and for a low-rank metric of ``rank`` at these shapes, its
        plan's shared memory and the blocks an SM holds (0 at rank 0)."""
        lib = self.library(dtype)
        plan = self.plan(n_chains, dim, rank, dtype, device) if rank else None
        mk = MkConfig(n_chains=n_chains, dim=dim, depth_slots=2, lr_rank=rank,
                      **plan_fields(plan))
        out = (ctypes.c_int32 * len(GEOMETRY_FIELDS))()
        fn = getattr(lib, f"nutpie_step_geometry_{dtype_suffix(dtype)}")
        with torch.cuda.device(torch.device(device)):
            raise_on(lib, fn(ctypes.byref(mk), out), "step kernel geometry")
        return dict(zip(GEOMETRY_FIELDS, out))

    def chunk(self, cfg: NutsConfig, sched: Schedule, chunk_start: int, limit: int,
              states: NutsMachineState, mom: torch.Tensor, jit: torch.Tensor,
              bufs: ChunkBuffers, adapt_frozen: bool):
        """The steps of one chunk: ``begin(states) -> (z_new, carry)`` and
        ``advance(states, z_new, carry, logp, grad) -> (states, z_new,
        carry)``.  On CUDA tensors ``states`` and ``bufs`` are updated in
        place."""
        args = (cfg, sched, int(chunk_start), int(limit), states, mom, jit, bufs,
                adapt_frozen)
        if states.vecs.is_cuda:
            return KernelSteps(self, *args)
        return PlainSteps(*args)


step_kernel = StepKernel()
