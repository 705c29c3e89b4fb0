"""Wrapper of the CUDA MCLMC step kernel (K3): the integrator between the
log-density calls, and each draw's end.

``csrc/mclmc.cu`` runs the three pieces of ``mclmc.PlainMclmcSteps`` as
launches, for every chain at once: ``begin`` (a chunk's first position
half-step), ``kick`` (after the midpoint's gradient: the velocity update
for the draw's trajectory kind and the second half-step) and ``settle``
(after the end's log density: the energy error, the partial refresh, at a
draw's last step the whole draw end with its commit, then the next
half-step).  ``mclmc_kernel.chunk(...)`` prepares one chunk:

- on CUDA tensors, ``KernelMclmcSteps``: it checks device, dtype, shape
  and contiguity once, decides the launch (``mclmc_plan``: K2's diagonal
  plan, held or strided, or K2's low-rank plan, staged or streamed, by TMA
  or loads; K3's low-rank block lays out the same shared memory as K2's,
  ``LrLayout``), and each piece launches the kernel on the current
  stream, raising if the launch fails.  The kernel updates the chunk's
  state, buffers and scratch **in place**; the state's step counters and
  the scratch's step within the draw live on the device, so one draw's
  launches may be captured in a CUDA graph (``step_kernel.StepGraph``)
  and replayed for every draw of the chunk.  The kernel draws the refresh
  normals itself: no normals tensor is made;
- on CPU tensors, ``PlainMclmcSteps``, with the chunk's normals from
  ``mclmc.draw_normals``.

There is no fallback between the two.  ``launches`` counts the launches
the card executes (one ``begin`` a chunk, a ``kick`` and a ``settle`` a
step), graph replays included, and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from ..ops import build
from . import mclmc
from .abi import MkConfig, dtype_suffix, raise_on, schedule_tensor
from .adapt import Schedule
from .mclmc import (
    N_M_FLT,
    N_M_INT,
    N_M_VEC,
    N_MCLMC_SCALARS,
    N_RUN_FLT,
    TRAJECTORIES,
    MclmcBuffers,
    MclmcConfig,
    MclmcScratch,
    MclmcState,
    decoherence_length,
    refresh_keys,
)
from .state import N_ADAPT_FLT, N_ADAPT_VEC
from .step_kernel import (
    MAX_RANK,
    DiagPlan,
    LowRankPlan,
    diag_plan,
    low_rank_plan,
    plan_fields,
    step_kernel,
)


class McConfig(ctypes.Structure):
    """Mirror of ``McConfig`` in ``csrc/mclmc.cu``: the adaptation's fields
    that ``csrc/adapt.cuh`` reads, the sizes and the launch plan (the
    low-rank metric's rank and ``lr_*`` fields, or the diagonal form's
    ``step_*`` fields, ``plan_fields``) travel in ``mk``."""

    _fields_ = [
        ("mk", MkConfig),
        ("max_energy_error", ctypes.c_double),
        ("euclid_max_energy_error", ctypes.c_double),
        ("log_target_eevpd", ctypes.c_double),
        ("log_min_step", ctypes.c_double),
        ("decoherence_length", ctypes.c_double),
        ("steps_per_draw", ctypes.c_int32),
        ("trajectory", ctypes.c_int32),
        ("dynamic_step_size", ctypes.c_int32),
    ]


class McPtrs(ctypes.Structure):
    """Mirror of ``McPtrs`` in ``csrc/mclmc.cu``.  ``keys`` is the key ABI
    of the refresh normals: ``[C, 2]`` int32, the two 32-bit words of
    ``fold_in(chain_key, 4)``, folded on the host once a chunk
    (``mclmc.refresh_keys``); the kernel folds in the absolute draw and the
    step within it."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "scal", "vecs", "flts", "ints", "adapt_vecs", "adapt_flts", "lr_basis",
        "lr_log_eigs", "keys", "z", "velocity", "run_flts", "step", "logp", "grad",
        "pos_out", "scal_out", "grad_out", "minv_out", "work",
    )]


# the pieces, as csrc/mclmc.cu numbers them
PIECES = {"begin": 0, "kick": 1, "settle": 2}
# what nutpie_mclmc_geometry_* reports, in its order: registers and spill
# bytes a thread of the held, the strided and the low-rank form (the most
# over the three pieces), threads a diagonal and a low-rank block, and for
# a low-rank plan its dynamic shared memory and the blocks an SM holds
GEOMETRY_FIELDS = ("held_registers", "held_local_bytes", "strided_registers",
                   "strided_local_bytes", "lr_registers", "lr_local_bytes",
                   "threads_per_block", "lr_threads_per_block", "lr_smem_bytes",
                   "lr_blocks_per_sm")
Plan = Union[DiagPlan, LowRankPlan]


def mclmc_plan(n_chains: int, dim: int, rank: int, itemsize: int, smem_per_block: int,
               sm_count: int, smem_per_sm: int, reserved_per_block: int = 0,
               aligned: bool = True) -> Plan:
    """K3's launch at these shapes on a card with this shared memory and
    these SMs, decided before anything runs: under a low-rank metric of
    ``rank`` K2's ``low_rank_plan`` (K3's block lays out the same shared
    memory: the basis staged whole where it fits, else streamed; TMA where
    a chain's basis is 16-byte aligned, else loads), else K2's
    ``diag_plan`` (held where dim <= 64 is a multiple of the 16-byte chunk,
    else strided).  Raises where no form takes the shapes."""
    if dim < 2:
        raise ValueError(f"the MCLMC kernel needs dim >= 2, got {dim}")
    if rank:
        return low_rank_plan(n_chains, dim, rank, itemsize, smem_per_block, sm_count,
                             smem_per_sm, reserved_per_block, aligned=aligned)
    return diag_plan(n_chains, dim, itemsize, sm_count)


def mc_config(cfg: MclmcConfig, n_chains: int, dim: int, chunk_len: int, rank: int,
              plan: Plan = None) -> McConfig:
    ac = cfg.adapt
    mk = MkConfig(min_variance=ac.min_variance, max_variance=ac.max_variance,
                  use_grad_based_estimate=int(ac.use_grad_based_estimate),
                  switch_freq=ac.switch_freq, early_switch_freq=ac.early_switch_freq,
                  n_chains=n_chains, dim=dim, chunk_len=chunk_len, lr_rank=rank,
                  fixed_metric=int(not ac.update_mass_matrix), **plan_fields(plan))
    return McConfig(
        mk=mk,
        max_energy_error=cfg.max_energy_error,
        euclid_max_energy_error=min(cfg.max_energy_error, 5.0),
        log_target_eevpd=math.log(cfg.target_eevpd),
        log_min_step=math.log(1e-6),
        decoherence_length=decoherence_length(cfg, dim),
        steps_per_draw=cfg.steps_per_draw,
        trajectory=TRAJECTORIES.index(cfg.trajectory),
        dynamic_step_size=int(cfg.dynamic_step_size),
    )


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"nutpie_mclmc_launch_{sfx}")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"nutpie_mclmc_geometry_{sfx}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.nutpie_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nutpie_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_chunk(cfg: MclmcConfig, states: MclmcState, keys, bufs: MclmcBuffers,
                 scratch: MclmcScratch, R: int) -> None:
    """Device, dtype, shape and contiguity of everything a chunk launches on."""
    dtype = states.vecs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"MCLMC kernel takes float32 or float64, got {dtype}")
    C, _, dim = states.vecs.shape
    L = bufs.position.shape[1]
    shapes = {
        "key": (C, 2), "vecs": (C, N_M_VEC, dim), "flts": (C, N_M_FLT), "ints": (C, N_M_INT),
        "adapt_vecs": (C, N_ADAPT_VEC, dim), "adapt_flts": (C, N_ADAPT_FLT),
        "lr_basis": (C, dim, R), "lr_log_eigs": (C, R), "keys": (C, 2),
        "position": (C, L, dim), "scalars": (C, L, N_MCLMC_SCALARS), "gradient": (C, L, dim),
        "mass_matrix_inv": (C, L, dim), "z": (C, dim), "velocity": (C, dim),
        "run_flts": (C, N_RUN_FLT), "step": (C,),
    }
    # the state's fields the kernel reads (a flow's are the log density's)
    tensors = dict({k: t for k, t in states.tensors().items() if k in shapes}, keys=keys,
                   position=bufs.position,
                   scalars=bufs.scalars, z=scratch.z, velocity=scratch.velocity,
                   run_flts=scratch.flts, step=scratch.step)
    for name in ("gradient", "mass_matrix_inv"):
        if getattr(bufs, name) is not None:
            tensors[name] = getattr(bufs, name)
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"MCLMC kernel: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if not t.is_cuda or t.device != states.vecs.device or not t.is_contiguous():
            raise ValueError("MCLMC kernel needs contiguous tensors on one CUDA device")
        want = {"key": torch.int64, "ints": torch.int32, "step": torch.int32,
                "keys": torch.int32}.get(name, dtype)
        if t.dtype != want:
            raise TypeError(f"MCLMC kernel: {name} is {t.dtype}, expected {want}")


class KernelMclmcSteps:
    """One chunk's launches of K3 (CUDA tensors)."""

    def __init__(self, owner: "MclmcKernel", cfg: MclmcConfig, sched: Schedule,
                 chunk_start: int, limit: int, states: MclmcState, bufs: MclmcBuffers,
                 scratch: MclmcScratch):
        R = 0 if cfg.low_rank is None else cfg.low_rank.max_rank
        if (states.lr_basis is None) != (R == 0):
            raise ValueError("the state's low-rank metric does not match the configuration")
        if not 0 <= R <= MAX_RANK:
            raise ValueError(f"MCLMC kernel takes a low-rank metric of rank <= {MAX_RANK}")
        # the refresh normals' key: fold_in(key, 4) once a chunk, as int32 words
        keys = refresh_keys(states.key)
        _check_chunk(cfg, states, keys, bufs, scratch, R)
        self.owner = owner
        self.lib = owner.library()
        self.states = states
        self.dtype = states.vecs.dtype
        self.device = states.vecs.device
        C, _, dim = states.vecs.shape
        self.shape = (C, dim)
        # the launch, decided here before anything runs
        aligned = R == 0 or states.lr_basis.data_ptr() % 16 == 0
        self.plan = owner.plan(C, dim, R, self.dtype, self.device, aligned=aligned)
        self.cfg = mc_config(cfg, C, dim, bufs.position.shape[1], R, self.plan)
        self.fn = getattr(self.lib, f"nutpie_mclmc_launch_{dtype_suffix(self.dtype)}")
        self.scal = schedule_tensor(chunk_start, limit, sched, self.device)
        # a row of each chain's own for the forms that hold no rows in
        # registers (strided, low-rank): the pulled-back gradient, the
        # estimates, a divergent draw's normals
        self.work = (None if self.plan.form == "held"
                     else torch.empty((C, dim), dtype=self.dtype, device=self.device))
        self.scratch = scratch
        self.keep = (keys, bufs)
        ptr = lambda t: None if t is None else t.data_ptr()
        self.ptrs = McPtrs(
            scal=ptr(self.scal), vecs=ptr(states.vecs), flts=ptr(states.flts),
            ints=ptr(states.ints), adapt_vecs=ptr(states.adapt_vecs),
            adapt_flts=ptr(states.adapt_flts), lr_basis=ptr(states.lr_basis),
            lr_log_eigs=ptr(states.lr_log_eigs), keys=ptr(keys), z=ptr(scratch.z),
            velocity=ptr(scratch.velocity), run_flts=ptr(scratch.flts),
            step=ptr(scratch.step), logp=None, grad=None, pos_out=ptr(bufs.position),
            scal_out=ptr(bufs.scalars), grad_out=ptr(bufs.gradient),
            minv_out=ptr(bufs.mass_matrix_inv), work=ptr(self.work),
        )

    def _launch(self, piece: str, states: MclmcState, logp=None, grad=None) -> None:
        if states.vecs is not self.states.vecs:
            raise ValueError("the MCLMC kernel updates its chunk's state in place; "
                             "pass the state the chunk was prepared with")
        C, dim = self.shape
        if grad is not None:
            if tuple(grad.shape) != (C, dim) or grad.device != self.device:
                raise ValueError(f"log density gave a gradient of shape {tuple(grad.shape)} "
                                 f"on {grad.device}, expected {(C, dim)} on {self.device}")
            grad = grad.detach().to(self.dtype).contiguous()
            if grad.data_ptr() % 16:
                grad = grad.clone()  # a fresh allocation: vector loads need 16 bytes
            self.ptrs.grad = grad.data_ptr()
        if logp is not None:
            if tuple(logp.shape) != (C,) or logp.device != self.device:
                raise ValueError(f"log density gave shape {tuple(logp.shape)}, expected {(C,)}")
            logp = logp.detach().to(self.dtype).contiguous()
            self.ptrs.logp = logp.data_ptr()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            code = self.fn(PIECES[piece], ctypes.byref(self.cfg), ctypes.byref(self.ptrs),
                           ctypes.c_void_p(stream))
        raise_on(self.lib, code, f"MCLMC kernel {piece} launch")
        if torch.cuda.is_current_stream_capturing():
            self.owner.captured += 1
        else:
            self.owner.launches += 1

    def begin(self, states: MclmcState):
        self._launch("begin", states)
        return self.scratch.z

    def kick(self, states: MclmcState, z, grad):
        self._launch("kick", states, grad=grad)
        return self.scratch.z

    def settle(self, states: MclmcState, z, logp, grad):
        self._launch("settle", states, logp=logp, grad=grad)
        return self.scratch.z


class MclmcKernel:
    """Wrapper of K3, with its launch count.

    ``launches`` is raised by one at each launch the card executes (a graph
    replay adds the launches it captured) and nowhere else; ``replays``
    counts graph replays, ``capture_s`` the host seconds of the captures,
    ``captured`` the launches recorded under capture.
    """

    name = "mclmc_kernel"
    source = "nutpie_tpu_torch/csrc/mclmc.cu"
    replaces = "nutpie_tpu/sampler/mclmc.py:173-319 (XLA scan body)"

    def __init__(self):
        self.launches = 0
        self.replays = 0
        self.capture_s = 0.0
        self.captured = 0

    def library(self):
        return bind(build.load("mclmc"))

    def plan(self, n_chains: int, dim: int, rank: int, dtype, device,
             aligned: bool = True) -> Plan:
        """``mclmc_plan`` on ``device``'s shared memory and SMs (the step
        kernel's device query)."""
        d = step_kernel.device_limits(device)
        return mclmc_plan(n_chains, dim, rank, torch.empty((), dtype=dtype).element_size(),
                          d["smem_per_block"], d["sm_count"], d["smem_per_sm"],
                          d["reserved_per_block"], aligned=aligned)

    def geometry(self, dtype, n_chains: int = 1, dim: int = 2, rank: int = 0,
                 device="cuda") -> dict:
        """Registers and spill bytes of each form as compiled, and for a
        low-rank metric of ``rank`` at these shapes its plan's shared memory
        and the blocks an SM holds (0 at rank 0)."""
        lib = self.library()
        plan = self.plan(n_chains, dim, rank, dtype, device) if rank else None
        mk = MkConfig(n_chains=n_chains, dim=dim, lr_rank=rank, **plan_fields(plan))
        out = (ctypes.c_int32 * len(GEOMETRY_FIELDS))()
        fn = getattr(lib, f"nutpie_mclmc_geometry_{dtype_suffix(dtype)}")
        with torch.cuda.device(torch.device(device)):
            raise_on(lib, fn(ctypes.byref(mk), out), "MCLMC kernel geometry")
        return dict(zip(GEOMETRY_FIELDS, out))

    def chunk(self, cfg: MclmcConfig, sched: Schedule, chunk_start: int, limit: int,
              states: MclmcState, bufs: MclmcBuffers, scratch: MclmcScratch):
        """The pieces of one chunk: ``begin(states) -> z``, ``kick(states, z,
        grad) -> z``, ``settle(states, z, logp, grad) -> z``.  On CPU
        tensors the plain pieces, with the chunk's normals drawn here."""
        args = (cfg, sched, int(chunk_start), int(limit), states, bufs, scratch)
        if states.vecs.is_cuda:
            return KernelMclmcSteps(self, *args)
        return mclmc.plain_steps(*args)


mclmc_kernel = MclmcKernel()
