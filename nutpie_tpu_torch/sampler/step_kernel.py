"""Wrapper of the CUDA step kernel (K2): the machine step around a torch logp.

``csrc/step_kernel.cu`` runs one machine step as two launches,
``step_begin`` (uniforms, direction, the slot-(D-1) stash, first
half-kick, drift; writes ``z_new``) and ``step_finish`` (everything after
the gradient), around one batched ``model.logp_and_grad(z_new)`` call.
The plain version is the pair ``nuts.leapfrog_begin`` /
``nuts.leapfrog_finish``.

``step_kernel.chunk(...)`` prepares one chunk and returns its steps:

- on CUDA tensors, ``KernelSteps``: it checks device, dtype, shape and
  contiguity once, allocates the chunk's scratch (``z_new [C, dim]``, the
  step's uniforms ``[C, 3]`` and the stagnant flags ``[C]``) with
  ``torch.empty``, and each ``begin``/``finish`` launches the kernel on
  the current stream, raising if the launch fails.  The kernel updates
  the chunk's state tensors and buffers **in place**: the caller hands it
  a state of its own (the chunk runner clones once per chunk) and gets
  the same tensors back.  ``z_new`` is rewritten at every step, so a log
  density must not keep its input;
- on CPU tensors, ``PlainSteps``: the plain halves, with the uniforms from
  a ``LeapfrogUniformTable``.

There is no fallback between the two.  ``launches`` counts kernel
launches (two per machine step) and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops import build
from .abi import MkConfig, dtype_suffix, raise_on, sampler_config, schedule_tensor
from .adapt import Schedule
from .nuts import (
    ChunkBuffers,
    LeapfrogUniformTable,
    NutsConfig,
    leapfrog_begin,
    leapfrog_finish,
)
from .state import N_ADAPT_FLT, N_ADAPT_VEC, N_FLT, N_INT, N_VEC, NutsMachineState

ADAM_ITEM = "ROADMAP.md queue 1: Adam and fixed step sizes on the card"
TARGET_TIME_ITEM = "ROADMAP.md queue 1: target_integration_time on the card"
FIXED_METRIC_ITEM = "ROADMAP.md queue 1: a fixed mass matrix on the card"


def unsupported(cfg: NutsConfig) -> Optional[str]:
    """What of this configuration the step kernel leaves out, with its
    ``ROADMAP.md`` item, or None.  (The port's ``NutsConfig`` already
    refuses low-rank, flow, microcanonical and ``store_*`` configurations.)"""
    if cfg.adapt.method != "dual_average":
        return f"step size method {cfg.adapt.method!r}: {ADAM_ITEM}"
    if cfg.target_time is not None:
        return f"target_integration_time: {TARGET_TIME_ITEM}"
    if not cfg.adapt.update_mass_matrix:
        return f"update_mass_matrix=False: {FIXED_METRIC_ITEM}"
    return None


class StepPtrs(ctypes.Structure):
    """Mirror of ``StepPtrs`` in ``csrc/step_kernel.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "scal", "key", "vecs", "ckpt_p", "ckpt_s", "flts", "ints", "adapt_vecs",
        "adapt_flts", "mom", "jit", "pos_out", "scal_out", "z_new", "u3",
        "stagnant", "logp", "grad",
    )]


# what nutpie_step_geometry_* reports, in its order
GEOMETRY_FIELDS = ("begin_registers", "begin_local_bytes", "finish_registers",
                   "finish_local_bytes", "threads_per_block")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the kernel library's entry points."""
    for half in ("begin", "finish"):
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"nutpie_step_{half}_{sfx}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"nutpie_step_geometry_{sfx}")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
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

    def finish(self, states: NutsMachineState, z_new, carry, logp, grad):
        states, _ = leapfrog_finish(
            self.cfg, self.sched, self.mom, self.jit, self.chunk_start,
            self.limit, states, z_new, carry, logp, grad, self.bufs,
            self.adapt_frozen,
        )
        return states


def _check_chunk(states: NutsMachineState, mom, jit, bufs: ChunkBuffers):
    """Device, dtype, shape and contiguity of everything a chunk launches on."""
    dtype = states.vecs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"step kernel takes float32 or float64, got {dtype}")
    C, n_vec, dim = states.vecs.shape
    D = states.ckpt_p.shape[1]
    L = mom.shape[1]
    shapes = {
        "key": (C, 2), "vecs": (C, N_VEC, dim), "ckpt_p": (C, D, dim),
        "ckpt_s": (C, D, dim), "flts": (C, N_FLT), "ints": (C, N_INT),
        "adapt_vecs": (C, N_ADAPT_VEC, dim), "adapt_flts": (C, N_ADAPT_FLT),
        "mom": (C, L, dim), "jit": (C, L), "position": (C, L, dim),
        "scalars": (C, L, bufs.scalars.shape[-1]),
    }
    tensors = dict(states.tensors(), mom=mom, jit=jit, position=bufs.position,
                   scalars=bufs.scalars)
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
        _check_chunk(states, mom, jit, bufs)
        self.owner = owner
        self.lib = owner.library()
        self.states = states
        self.dtype = states.vecs.dtype
        self.device = states.vecs.device
        C, _, dim = states.vecs.shape
        self.shape = (C, dim)
        self.cfg = sampler_config(cfg, C, dim, states.ckpt_p.shape[1],
                                  mom.shape[1], adapt_frozen)
        sfx = dtype_suffix(self.dtype)
        self.fns = {half: getattr(self.lib, f"nutpie_step_{half}_{sfx}")
                    for half in ("begin", "finish")}
        # the chunk's scratch, and everything the pointers below refer to
        self.z_new = torch.empty((C, dim), dtype=self.dtype, device=self.device)
        self.u3 = torch.empty((C, 3), dtype=torch.float32, device=self.device)
        self.stagnant = torch.empty((C,), dtype=torch.int32, device=self.device)
        self.scal = schedule_tensor(chunk_start, limit, sched, self.device)
        self.keep = (mom, jit, bufs)
        ptr = lambda t: t.data_ptr()
        self.ptrs = StepPtrs(
            scal=ptr(self.scal), key=ptr(states.key), vecs=ptr(states.vecs),
            ckpt_p=ptr(states.ckpt_p), ckpt_s=ptr(states.ckpt_s),
            flts=ptr(states.flts), ints=ptr(states.ints),
            adapt_vecs=ptr(states.adapt_vecs), adapt_flts=ptr(states.adapt_flts),
            mom=ptr(mom), jit=ptr(jit), pos_out=ptr(bufs.position),
            scal_out=ptr(bufs.scalars), z_new=ptr(self.z_new), u3=ptr(self.u3),
            stagnant=ptr(self.stagnant), logp=None, grad=None,
        )

    def _launch(self, half: str, states: NutsMachineState) -> None:
        if states.vecs is not self.states.vecs:
            raise ValueError("the step kernel updates its chunk's state in place; "
                             "pass the state the chunk was prepared with")
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            code = self.fns[half](ctypes.byref(self.cfg), ctypes.byref(self.ptrs),
                                  ctypes.c_void_p(stream))
        raise_on(self.lib, code, f"step kernel {half} launch")
        self.owner.launches += 1

    def begin(self, states: NutsMachineState):
        self._launch("begin", states)
        return self.z_new, None

    def finish(self, states: NutsMachineState, z_new, carry, logp, grad):
        C, dim = self.shape
        if tuple(logp.shape) != (C,) or tuple(grad.shape) != (C, dim):
            raise ValueError(f"log density gave shapes {tuple(logp.shape)} and "
                             f"{tuple(grad.shape)}, expected {(C,)} and {(C, dim)}")
        if logp.device != self.device or grad.device != self.device:
            raise ValueError("the log density's outputs must be on the state's device")
        logp = logp.detach().to(self.dtype).contiguous()
        grad = grad.detach().to(self.dtype).contiguous()
        self.ptrs.logp, self.ptrs.grad = logp.data_ptr(), grad.data_ptr()
        self._launch("finish", states)
        return states


class StepKernel:
    """Wrapper of the CUDA step kernel, with its launch count.

    ``launches`` is a plain integer, raised by one at each kernel launch
    (``begin`` and ``finish`` alike) and nowhere else; the plain version
    on CPU tensors leaves it alone.
    """

    name = "step_kernel"
    source = "nutpie_tpu_torch/csrc/step_kernel.cu"
    replaces = "nutpie_tpu/sampler/run.py:432-440 (XLA loop body)"

    def __init__(self):
        self.launches = 0

    def library(self):
        return bind(build.load("step_kernel"))

    def geometry(self, dtype) -> dict:
        """Registers and spill bytes of the two kernels as compiled."""
        lib = self.library()
        out = (ctypes.c_int32 * len(GEOMETRY_FIELDS))()
        fn = getattr(lib, f"nutpie_step_geometry_{dtype_suffix(dtype)}")
        raise_on(lib, fn(out), "step kernel geometry")
        return dict(zip(GEOMETRY_FIELDS, out))

    def chunk(self, cfg: NutsConfig, sched: Schedule, chunk_start: int, limit: int,
              states: NutsMachineState, mom: torch.Tensor, jit: torch.Tensor,
              bufs: ChunkBuffers, adapt_frozen: bool):
        """The steps of one chunk: ``begin(states) -> (z_new, carry)`` and
        ``finish(states, z_new, carry, logp, grad) -> states``.  On CUDA
        tensors ``states`` and ``bufs`` are updated in place."""
        args = (cfg, sched, int(chunk_start), int(limit), states, mom, jit, bufs,
                adapt_frozen)
        if states.vecs.is_cuda:
            return KernelSteps(self, *args)
        return PlainSteps(*args)


step_kernel = StepKernel()
