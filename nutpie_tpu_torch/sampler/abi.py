"""The C ABI shared by the CUDA kernels' wrappers.

``MkConfig`` mirrors the struct of the same name in ``csrc/layout.cuh``,
the static configuration both kernels take (the radon sizes are used by
the chunk kernel only and stay 0 for the step kernel; the low-rank
metric's rank ``lr_rank`` and its launch plan, ``lr_streamed`` to
``lr_grid``, and the diagonal plan, ``step_lanes`` to ``step_grid``, are
the step kernel's and stay 0 for the chunk kernel; so do
``store_divergences`` and ``micro``, the microcanonical kinetic, which
only the step kernel takes; ``fixed_metric``, an inverse mass that is
never re-estimated, is the step and MCLMC kernels').  The schedule
scalars travel as one int32 tensor on the device, so a ``depth_cap`` that
lives on the device needs no host round trip.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .adapt import Schedule
from .nuts import NutsConfig


class MkConfig(ctypes.Structure):
    """Mirror of ``MkConfig`` in ``csrc/layout.cuh``."""

    _fields_ = [
        ("max_energy_error", ctypes.c_double),
        ("step_size_jitter", ctypes.c_double),
        ("target_accept", ctypes.c_double),
        ("gamma", ctypes.c_double),
        ("t0", ctypes.c_double),
        ("kappa", ctypes.c_double),
        ("max_step_size", ctypes.c_double),
        ("min_variance", ctypes.c_double),
        ("max_variance", ctypes.c_double),
        ("adam_lr", ctypes.c_double),
        ("adam_beta1", ctypes.c_double),
        ("adam_beta2", ctypes.c_double),
        ("log_fixed_step", ctypes.c_double),
        ("target_time", ctypes.c_double),
        ("n_chains", ctypes.c_int32),
        ("dim", ctypes.c_int32),
        ("depth_slots", ctypes.c_int32),
        ("chunk_len", ctypes.c_int32),
        ("maxdepth", ctypes.c_int32),
        ("mindepth", ctypes.c_int32),
        ("check_turning", ctypes.c_int32),
        ("adapt_frozen", ctypes.c_int32),
        ("use_grad_based_estimate", ctypes.c_int32),
        ("has_jitter", ctypes.c_int32),
        ("switch_freq", ctypes.c_int32),
        ("early_switch_freq", ctypes.c_int32),
        ("step_method", ctypes.c_int32),
        ("has_target_time", ctypes.c_int32),
        ("extra_doublings", ctypes.c_int32),
        ("store_divergences", ctypes.c_int32),
        ("n_counties", ctypes.c_int32),
        ("n_obs", ctypes.c_int32),
        ("n_seg", ctypes.c_int32),
        ("obs_rows", ctypes.c_int32),
        ("lr_rank", ctypes.c_int32),
        ("lr_streamed", ctypes.c_int32),
        ("lr_tma", ctypes.c_int32),
        ("lr_grid", ctypes.c_int32),
        ("step_lanes", ctypes.c_int32),
        ("step_vec", ctypes.c_int32),
        ("step_held", ctypes.c_int32),
        ("step_grid", ctypes.c_int32),
        ("micro", ctypes.c_int32),
        ("fixed_metric", ctypes.c_int32),
    ]


# AdaptConfig.method -> StepMethod in csrc/layout.cuh (a float is a fixed step)
STEP_METHODS = {"dual_average": 0, "adam": 1}
STEP_FIXED = 2


def step_method(method) -> tuple:
    """``(StepMethod, log of the fixed step or 0)`` of ``AdaptConfig.method``."""
    if isinstance(method, (int, float)) and not isinstance(method, bool):
        return STEP_FIXED, math.log(float(method))
    if method not in STEP_METHODS:
        raise ValueError(f"unknown step size method {method!r}")
    return STEP_METHODS[method], 0.0


def sampler_config(cfg: NutsConfig, n_chains: int, dim: int, depth_slots: int,
                   chunk_len: int, adapt_frozen: bool, **model_sizes) -> MkConfig:
    """``MkConfig`` from the sampler's configuration; ``model_sizes`` sets
    the radon fields (``n_counties``, ``n_obs``, ``n_seg``, ``obs_rows``)
    or the step kernel's ``lr_*`` and ``step_*`` fields."""
    ac = cfg.adapt
    method, log_fixed = step_method(ac.method)
    return MkConfig(
        max_energy_error=cfg.max_energy_error,
        step_size_jitter=ac.step_size_jitter or 0.0,
        target_accept=ac.target_accept,
        gamma=ac.gamma,
        t0=ac.t0,
        kappa=ac.kappa,
        max_step_size=ac.max_step_size,
        min_variance=ac.min_variance,
        max_variance=ac.max_variance,
        adam_lr=ac.adam_lr,
        adam_beta1=ac.adam_beta1,
        adam_beta2=ac.adam_beta2,
        log_fixed_step=log_fixed,
        target_time=0.0 if cfg.target_time is None else cfg.target_time,
        n_chains=n_chains,
        dim=dim,
        depth_slots=depth_slots,
        chunk_len=chunk_len,
        maxdepth=cfg.maxdepth,
        mindepth=cfg.mindepth,
        check_turning=int(cfg.check_turning),
        adapt_frozen=int(adapt_frozen),
        use_grad_based_estimate=int(ac.use_grad_based_estimate),
        has_jitter=int(ac.step_size_jitter is not None),
        switch_freq=ac.switch_freq,
        early_switch_freq=ac.early_switch_freq,
        step_method=method,
        has_target_time=int(cfg.target_time is not None),
        extra_doublings=cfg.extra_doublings,
        store_divergences=int(cfg.store_divergences),
        micro=int(cfg.kinetic == "microcanonical"),
        fixed_metric=int(not ac.update_mass_matrix),
        **model_sizes,
    )


def dtype_suffix(dtype) -> str:
    """The suffix of a kernel library's entry points for ``dtype``."""
    return "f64" if dtype == torch.float64 else "f32"


def raise_on(lib, code: int, what: str) -> None:
    """Raise if a kernel library's entry point returned a CUDA error."""
    if code != 0:
        msg = lib.nutpie_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: {msg} ({code})")


def schedule_tensor(chunk_start: int, limit: int, sched: Schedule, device) -> torch.Tensor:
    """The six int32 schedule scalars, on the device.

    The host's scalars go up from pinned memory without waiting for the
    device, and a ``depth_cap`` that is a device tensor (``fleet_depth_cap``)
    is joined there, so launching a chunk makes no host sync.
    """
    device = torch.device(device)
    cap = sched.depth_cap
    head = [chunk_start, limit, sched.num_tune, sched.early_end, sched.freeze_start]
    if not isinstance(cap, torch.Tensor):
        head.append(int(cap))
    host = torch.tensor(head, dtype=torch.int32)
    if device.type == "cuda":
        host = host.pin_memory()
    out = host.to(device, non_blocking=True)
    if isinstance(cap, torch.Tensor):
        out = torch.cat([out, cap.to(device=device, dtype=torch.int32).reshape(1)])
    return out
