"""Microcanonical Langevin Monte Carlo (MCLMC), batched over chains, in torch.

The port of ``nutpie_tpu/sampler/mclmc.py`` (the reference's experimental
``sampler="mclmc"``): isokinetic Langevin dynamics with partial momentum
decoherence, preconditioned by the gradient-based diagonal mass matrix of
NUTS or its low-rank correction, with the two other trajectory kinds
(``euclidean``: unadjusted underdamped Langevin with an OU refresh of a
Gaussian momentum; ``euclidean_then_microcanonical``: euclidean for the
first half of warmup).  There is no tree and no accept/reject: every chain
takes ``steps_per_draw`` integrator steps a draw, in lockstep.

A step is a position half-step, the log density at the midpoint, the
velocity update from its gradient, a second position half-step, the log
density at the end, the energy error and the partial refresh.  The plain
version here runs it in three pieces, split at the two log densities, the
pieces the kernel K3 (``csrc/mclmc.cu``) runs as launches:

- ``begin``: a chunk's first position half-step (writes ``z``, the point
  handed to the log density);
- ``kick``: after the midpoint's gradient, the velocity update and the
  second position half-step (writes the step's end into ``z``);
- ``settle``: after the end's log density, the energy error and the
  partial refresh, at a draw's last step the draw's end (the divergence
  rejection with a fresh velocity, the EEVPD step-size rule, the Welford
  windows with their switches and the inverse-mass estimate, the commit
  into the chunk buffers), then the next step's first position half-step.

The state (``MclmcState``) packs position, gradient and velocity rows, the
float and integer scalars and the same adaptation rows as the NUTS state
(inverse mass and four Welford pairs; of ``adapt_flts`` only the Welford
counts are used), plus the low-rank metric's factors under low-rank
adaptation.  What a draw carries between the pieces (the running velocity,
the running log density, the step's kinetic-energy change, the sums of the
energy errors and of their squares, the step within the draw) lives in the
chunk's scratch (``MclmcScratch``), so the state is the JAX state's.

Randomness: the draw with absolute index d keys its steps by
``split(fold_in(fold_in(key, 4), d), steps_per_draw)``; step j's refresh
draws ``normal(keys[j], (dim,))`` and a divergent draw's fresh velocity is
the same normals of its last step.  Under the partitionable layout
``split(k, S)[j]`` is ``fold_in(k, j)``, so step j's key is
``fold_in(fold_in(fold_in(key, 4), d), j)``.  The plain version takes a
chunk's ``[C, L, steps_per_draw, dim]`` from ``draw_normals`` before it
runs; the kernel draws each step's normals itself from ``refresh_keys``
(``fold_in(key, 4)``), as ``step_normals`` mirrors.

Flow adaptation (``MclmcConfig.flow``): the dynamics run in each chain's
flow base space under an identity metric whose windows do not run
(``update_mass_matrix=False``); the log densities are the pulled-back
one under the chunk's flows, and at the chunk's end warmup chunks train
the flows (``transforms.flow.chunk_flow_update``) and every chunk's draws
go to model space through the flow that drew them
(``nutpie_tpu/sampler/mclmc.py:380-418``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import torch

from ..model import ModelDef
from ..ops import threefry
from ..transforms.flow import (
    FlowConfig,
    init_flow_window,
    pulled_back,
)
from .adapt import (
    ADAPT_VEC_SLOTS,
    WELFORD,
    AdaptConfig,
    Schedule,
    _estimate_inv_mass,
    init_inv_mass_from_gradient,
    welford_add,
)
from .isokinetic import apply_A, apply_At, iso_metric, update_velocity
from .low_rank import estimate_low_rank, identity_metric
from .nuts import LowRankConfig, NutsConfig
from .state import (
    N_ADAPT_FLT,
    N_ADAPT_VEC,
    FlowStateFields,
    flow_boundary,
    flow_fields,
    flow_params,
    where as _w,
)

TRAJECTORIES = ("microcanonical", "euclidean", "euclidean_then_microcanonical")


@dataclasses.dataclass(frozen=True)
class MclmcConfig:
    """Static MCLMC configuration (``nutpie_tpu/sampler/mclmc.py:39-67``)."""

    step_size: float = 0.5
    momentum_decoherence_length: float = 2.0
    steps_per_draw: int = 1
    dynamic_step_size: bool = True
    max_energy_error: float = 1000.0
    target_eevpd: float = 5e-4
    trajectory: str = "microcanonical"
    store_gradient: bool = False
    store_mass_matrix: bool = False
    low_rank: Optional[LowRankConfig] = None
    flow: Optional[FlowConfig] = None
    adapt: AdaptConfig = dataclasses.field(
        default_factory=lambda: AdaptConfig(num_tune=300)
    )

    def __post_init__(self):
        if self.trajectory not in TRAJECTORIES:
            raise ValueError(f"unknown MCLMC trajectory {self.trajectory!r}")
        if self.steps_per_draw < 1:
            raise ValueError("steps_per_draw must be at least 1")

    @property
    def need_gradient(self) -> bool:
        """The chunk keeps its draws' gradients: asked for, or read by the
        low-rank or the flow boundary update."""
        return self.store_gradient or self.low_rank is not None or self.flow is not None


# rows of MclmcState.vecs, slots of flts and ints
M_VEC = {"position": 0, "gradient": 1, "velocity": 2}
M_FLT = {"logp": 0, "log_eps": 1}
M_INT = {"draw_idx": 0, "total_steps": 1, "divergence_count": 2}
N_M_VEC, N_M_FLT, N_M_INT = len(M_VEC), len(M_FLT), len(M_INT)


@dataclasses.dataclass
class MclmcState(FlowStateFields):
    """The MCLMC state of C chains (the JAX ``MclmcState``, packed; under
    flow adaptation the JAX state's ``floww`` in ``FlowStateFields``)."""

    key: torch.Tensor         # [C, 2] int64 raw Threefry key data
    vecs: torch.Tensor        # [C, 3, dim] position, gradient, velocity
    flts: torch.Tensor        # [C, 2] logp, log_eps
    ints: torch.Tensor        # [C, 3] int32 draw_idx, total_steps, divergence_count
    adapt_vecs: torch.Tensor  # [C, 9, dim] inverse mass, four Welford pairs
    adapt_flts: torch.Tensor  # [C, 12] (the Welford counts' slots)
    lr_basis: Optional[torch.Tensor] = None     # [C, dim, R]
    lr_log_eigs: Optional[torch.Tensor] = None  # [C, R]

    def replace(self, **changes) -> "MclmcState":
        return dataclasses.replace(self, **changes)

    def clone(self) -> "MclmcState":
        return MclmcState(**{k: v.clone() for k, v in self.tensors().items()})

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    @property
    def position(self):
        return self.vecs[:, M_VEC["position"]]

    @property
    def gradient(self):
        return self.vecs[:, M_VEC["gradient"]]

    @property
    def velocity(self):
        return self.vecs[:, M_VEC["velocity"]]

    @property
    def logp(self):
        return self.flts[:, M_FLT["logp"]]

    @property
    def log_eps(self):
        return self.flts[:, M_FLT["log_eps"]]

    @property
    def eps(self):
        return torch.exp(self.log_eps)

    @property
    def draw_idx(self):
        return self.ints[:, M_INT["draw_idx"]]

    @property
    def total_steps(self):
        return self.ints[:, M_INT["total_steps"]]

    @property
    def divergence_count(self):
        return self.ints[:, M_INT["divergence_count"]]

    @property
    def inv_mass(self):
        return self.adapt_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]]


# the packed per-draw scalars of the chunk buffers (n_steps is the
# configuration's steps_per_draw and is not stored)
MCLMC_SCALAR_SLOTS = {"logp": 0, "energy_error": 1, "diverging": 2, "step_size": 3}
N_MCLMC_SCALARS = len(MCLMC_SCALAR_SLOTS)


class MclmcBuffers(NamedTuple):
    """One chunk's draws (NaN until written)."""

    position: torch.Tensor                          # [C, L, dim]
    scalars: torch.Tensor                           # [C, L, 4]
    gradient: Optional[torch.Tensor] = None         # [C, L, dim] (need_gradient)
    mass_matrix_inv: Optional[torch.Tensor] = None  # [C, L, dim] (store_mass_matrix)

    def _slot(self, name):
        return self.scalars[..., MCLMC_SCALAR_SLOTS[name]]

    @property
    def logp(self):
        return self._slot("logp")

    @property
    def energy_error(self):
        return self._slot("energy_error")

    @property
    def diverging(self):
        return self._slot("diverging") > 0.5

    @property
    def step_size(self):
        return self._slot("step_size")


def init_buffers(cfg: MclmcConfig, chunk_len: int, n_chains: int, dim: int, dtype,
                 device=None) -> MclmcBuffers:
    f = lambda *shape: torch.full((n_chains, chunk_len) + shape, math.nan, dtype=dtype,
                                  device=device)
    return MclmcBuffers(
        position=f(dim), scalars=f(N_MCLMC_SCALARS),
        gradient=f(dim) if cfg.need_gradient else None,
        mass_matrix_inv=f(dim) if cfg.store_mass_matrix else None,
    )


# the chunk's scratch: what a draw carries between the pieces
RUN_FLT = {"logp": 0, "dke": 1, "de_sum": 2, "de2_sum": 3}
N_RUN_FLT = len(RUN_FLT)


class MclmcScratch(NamedTuple):
    z: torch.Tensor          # [C, dim] the point handed to the log density
    velocity: torch.Tensor   # [C, dim] the running velocity
    flts: torch.Tensor       # [C, 4] running logp, the step's dke, sum and sum of squares of de
    step: torch.Tensor       # [C] int32 the step within the draw


def init_scratch(n_chains: int, dim: int, dtype, device) -> MclmcScratch:
    return MclmcScratch(
        z=torch.zeros((n_chains, dim), dtype=dtype, device=device),
        velocity=torch.zeros((n_chains, dim), dtype=dtype, device=device),
        flts=torch.zeros((n_chains, N_RUN_FLT), dtype=dtype, device=device),
        step=torch.zeros((n_chains,), dtype=torch.int32, device=device),
    )


# ------------------------------------------------------------- the dynamics


def partial_refresh(u, z, eps, L: float):
    """Projective partial refresh of a unit velocity with normals ``z``."""
    nu = torch.sqrt(torch.expm1(2.0 * eps / L))
    un = u + nu[:, None] * z
    return un / torch.sqrt(torch.sum(un * un, dim=-1))[:, None]


def _normalize(u):
    return u / torch.sqrt(torch.clamp(torch.sum(u * u, dim=-1), min=1e-30))[:, None]


def decoherence_length(cfg: MclmcConfig, dim: int) -> float:
    return cfg.momentum_decoherence_length * math.sqrt(float(dim))


def use_micro(cfg: MclmcConfig, sched: Schedule, draw_idx: torch.Tensor) -> torch.Tensor:
    """Per chain: the draw runs isokinetic dynamics."""
    if cfg.trajectory == "euclidean":
        return torch.zeros_like(draw_idx, dtype=torch.bool)
    if cfg.trajectory == "euclidean_then_microcanonical":
        return draw_idx >= sched.num_tune // 2
    return torch.ones_like(draw_idx, dtype=torch.bool)


def draw_normals(keys: torch.Tensor, chunk_start: int, chunk_len: int, steps: int,
                 dim: int, dtype) -> torch.Tensor:
    """The chunk's refresh normals ``[C, L, steps, dim]``: step j of draw d
    draws ``normal(split(fold_in(fold_in(key, 4), d), steps)[j], (dim,))``."""
    draw_ids = chunk_start + torch.arange(chunk_len, dtype=torch.int64, device=keys.device)
    base = threefry.fold_in_data(threefry.fold_in_data(keys, 4)[:, None, :], draw_ids[None, :])
    return threefry.normal(threefry.split(base, steps), (dim,), dtype)


def refresh_keys(keys: torch.Tensor) -> torch.Tensor:
    """The refresh normals' key that K3 takes (``McPtrs.keys``): the words
    of ``fold_in(key, 4)`` as int32 ``[C, 2]`` (bit patterns of the uint32
    words), folded once a chunk."""
    k = threefry.fold_in_data(keys, 4)
    return torch.where(k >= 2**31, k - 2**32, k).to(torch.int32)


def step_normals(keys4: torch.Tensor, draw_idx, step, dim: int, dtype) -> torch.Tensor:
    """Step ``step`` of draw ``draw_idx`` (absolute; ints or ``[C]``
    tensors) from ``refresh_keys``' words ``keys4 [C, 2]``: ``normal(fold_in(
    fold_in(keys4, d), j), (dim,))``, ``[C, dim]``, as K3's settle draws it
    (``csrc/mclmc.cu``: StepNormals)."""
    k = keys4.to(torch.int64) & threefry.MASK32
    k = threefry.fold_in_data(k, draw_idx)
    return threefry.normal(threefry.fold_in_data(k, step), (dim,), dtype)


class PlainMclmcSteps:
    """K3's plain version over one chunk: the three pieces in torch, on any
    device.  ``states`` and ``bufs`` and the scratch are updated in place,
    as the kernel updates them."""

    def __init__(self, cfg: MclmcConfig, sched: Schedule, chunk_start: int, limit: int,
                 states: MclmcState, normals: torch.Tensor, bufs: MclmcBuffers,
                 scratch: MclmcScratch):
        self.cfg, self.sched = cfg, sched
        self.chunk_start, self.limit = chunk_start, limit
        self.normals, self.bufs, self.scratch = normals, bufs, scratch
        self.dim = states.vecs.shape[2]
        self.L = decoherence_length(cfg, self.dim)

    def _half_step(self, s: MclmcState, x, u):
        """x + 0.5 eps A u at the state's step size."""
        return x + (0.5 * s.eps)[:, None] * apply_A(*iso_metric(self.cfg, s), u)

    def _start_draw(self, s: MclmcState, rows=None):
        """A draw's start: the entry velocity (normalized where the draw is
        isokinetic), the running values reset, the first half-step."""
        sc = self.scratch
        micro = use_micro(self.cfg, self.sched, s.draw_idx)
        u0 = _w(micro, _normalize(s.velocity), s.velocity)
        z = self._half_step(s, s.position, u0)
        flts = torch.stack([s.logp, torch.zeros_like(s.logp), torch.zeros_like(s.logp),
                            torch.zeros_like(s.logp)], dim=1)
        if rows is None:
            rows = torch.ones_like(micro)
        sc.velocity.copy_(_w(rows, u0, sc.velocity))
        sc.z.copy_(_w(rows, z, sc.z))
        sc.flts.copy_(_w(rows, flts, sc.flts))
        sc.step.copy_(torch.where(rows, torch.zeros_like(sc.step), sc.step))

    def begin(self, states: MclmcState):
        self._start_draw(states)
        return self.scratch.z

    def kick(self, states: MclmcState, z, grad):
        """The velocity update from the midpoint's gradient and the second
        position half-step."""
        cfg, sc = self.cfg, self.scratch
        dtype = states.vecs.dtype
        eps = states.eps
        g_z = -apply_At(*iso_metric(self.cfg, states), grad.to(dtype))
        u = sc.velocity
        micro = use_micro(cfg, self.sched, states.draw_idx)
        u_m, dke_m = update_velocity(u, g_z, eps, self.dim)
        u_e = u - eps[:, None] * g_z
        dke_e = 0.5 * (torch.sum(u_e * u_e, dim=-1) - torch.sum(u * u, dim=-1))
        u = _w(micro, u_m, u_e)
        sc.velocity.copy_(u)
        sc.flts[:, RUN_FLT["dke"]] = torch.where(micro, dke_m, dke_e)
        sc.z.copy_(self._half_step(states, z, u))
        return sc.z

    def settle(self, states: MclmcState, z, logp, grad):
        """The energy error and the partial refresh; a draw's end at its
        last step; then the next step's first half-step."""
        cfg, sc, s = self.cfg, self.scratch, states
        dtype = s.vecs.dtype
        logp = logp.to(dtype)
        grad = grad.to(dtype)
        F = RUN_FLT
        C = s.vecs.shape[0]
        rows = torch.arange(C, device=z.device)
        d = (s.draw_idx - self.chunk_start).long()
        j = sc.step.long()
        de = sc.flts[:, F["dke"]] + (sc.flts[:, F["logp"]] - logp)
        sc.flts[:, F["de_sum"]] += de
        sc.flts[:, F["de2_sum"]] += de * de
        sc.flts[:, F["logp"]] = logp
        eps = s.eps
        micro = use_micro(cfg, self.sched, s.draw_idx)
        xi = self.normals[rows, d.clamp(0, self.normals.shape[1] - 1), j]
        u = sc.velocity
        u_rm = partial_refresh(u, xi, eps, self.L)
        c = torch.exp(-eps / self.L)
        u_re = c[:, None] * u + torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))[:, None] * xi
        sc.velocity.copy_(_w(micro, u_rm, u_re))
        sc.step.add_(1)
        last = sc.step >= cfg.steps_per_draw
        if bool(last.any()):
            self._end_draw(s, z, logp, grad, xi, micro, last)
        # the next step of this draw, or the next draw's start
        more = ~last
        if bool(more.any()):
            sc.z.copy_(_w(more, self._half_step(s, z, sc.velocity), sc.z))
        nxt = last & ((s.draw_idx - self.chunk_start) < self.limit)
        if bool(nxt.any()):
            self._start_draw(s, nxt)
        return sc.z

    def _end_draw(self, s: MclmcState, z, logp, grad, xi, micro, last):
        """The draw's end for the chains at their last step: rejection,
        step size, Welford windows, inverse mass, commit."""
        cfg, sched, sc = self.cfg, self.sched, self.scratch
        F = RUN_FLT
        dim = self.dim
        S = cfg.steps_per_draw
        de_total = sc.flts[:, F["de_sum"]]
        var_e = sc.flts[:, F["de2_sum"]] / S
        thr = torch.where(micro, torch.full_like(de_total, cfg.max_energy_error),
                          torch.full_like(de_total, min(cfg.max_energy_error, 5.0)))
        diverging = (~torch.isfinite(de_total)) | (torch.abs(de_total) > thr)
        x = _w(diverging, s.position, z)
        g = _w(diverging, s.gradient, grad)
        lp = torch.where(diverging, s.logp, logp)
        fresh = _w(micro, xi / torch.sqrt(torch.sum(xi * xi, dim=-1))[:, None], xi)
        u = _w(diverging, fresh, sc.velocity)

        draw_idx = s.draw_idx
        tuning = draw_idx < sched.num_tune
        log_eps = s.log_eps
        if cfg.dynamic_step_size:
            eevpd = torch.maximum(var_e / dim, torch.full_like(var_e, 1e-20))
            adj = 0.2 * (math.log(cfg.target_eevpd) - torch.log(eevpd))
            hi = torch.where(micro, torch.full_like(adj, 0.3), torch.full_like(adj, 0.1))
            adj = torch.minimum(torch.maximum(adj, torch.full_like(adj, -0.3)), hi)
            adj = torch.where(diverging, torch.full_like(adj, -0.5), adj)
            new_log_eps = torch.where(tuning, log_eps + adj, log_eps)
            new_log_eps = torch.maximum(new_log_eps,
                                        torch.full_like(new_log_eps, math.log(1e-6)))
        else:
            new_log_eps = log_eps

        adapt_vecs, adapt_flts = s.adapt_vecs, s.adapt_flts
        if cfg.adapt.update_mass_matrix:  # off under flow: the flow holds the geometry
            adapt_vecs, adapt_flts = mclmc_adapt_update(cfg.adapt, sched, adapt_vecs,
                                                        adapt_flts, draw_idx, x, g,
                                                        tuning & ~diverging, tuning)

        # the commit, at the draw's row of the chunk
        d = (draw_idx - self.chunk_start).long().clamp(0, self.bufs.position.shape[1] - 1)
        at_rows = torch.nonzero(last).squeeze(1)
        at = (at_rows, d[at_rows])
        b = self.bufs
        scal = torch.stack([lp, de_total, diverging.to(lp.dtype), s.eps], dim=1)
        b.position[at] = x[at_rows]
        b.scalars[at] = scal[at_rows]
        inv_mass = adapt_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]]
        if b.gradient is not None:
            b.gradient[at] = g[at_rows]
        if b.mass_matrix_inv is not None:
            b.mass_matrix_inv[at] = inv_mass[at_rows]

        m = last
        s.vecs.copy_(_w(m, torch.stack([x, g, u], dim=1), s.vecs))
        s.flts.copy_(_w(m, torch.stack([lp, new_log_eps], dim=1), s.flts))
        ints = torch.stack([draw_idx + 1, s.total_steps + S,
                            s.divergence_count + diverging.to(torch.int32)], dim=1)
        s.ints.copy_(_w(m, ints.to(torch.int32), s.ints))
        s.adapt_vecs.copy_(_w(m, adapt_vecs, s.adapt_vecs))
        s.adapt_flts.copy_(_w(m, adapt_flts, s.adapt_flts))
        sc.step.copy_(torch.where(m, torch.zeros_like(sc.step), sc.step))


def plain_steps(cfg: MclmcConfig, sched: Schedule, chunk_start: int, limit: int,
                states: MclmcState, bufs: MclmcBuffers,
                scratch: MclmcScratch) -> PlainMclmcSteps:
    """The plain pieces of one chunk, with the chunk's refresh normals from
    ``draw_normals`` (K3 draws its own)."""
    _, _, dim = states.vecs.shape
    normals = draw_normals(states.key, chunk_start, bufs.position.shape[1],
                           cfg.steps_per_draw, dim, states.vecs.dtype)
    return PlainMclmcSteps(cfg, sched, chunk_start, limit, states, normals, bufs, scratch)


def mclmc_adapt_update(cfg: AdaptConfig, sched: Schedule, adapt_vecs, adapt_flts,
                       draw_idx, x, g, ok, tuning):
    """MCLMC's per-draw metric update (``mclmc.py:263-293``): Welford adds
    where ``ok`` (tuning and not diverging), the estimate from the current
    window before the switch (no rate limit, no step-size shift), kept
    where tuning and not frozen, then the switch."""
    acc = {}
    for name, (mi, vi, ci) in WELFORD.items():
        val = x if name.startswith("draws") else g
        mean, m2, count = adapt_vecs[:, mi], adapt_vecs[:, vi], adapt_flts[:, ci]
        n_mean, n_m2, n_count = welford_add(mean, m2, count, val)
        acc[name] = (_w(ok, n_mean, mean), _w(ok, n_m2, m2), torch.where(ok, n_count, count))
    frozen = draw_idx >= sched.freeze_start
    freq = torch.where(draw_idx < sched.early_end,
                       torch.full_like(draw_idx, cfg.early_switch_freq),
                       torch.full_like(draw_idx, cfg.switch_freq))
    switch = tuning & ~frozen & (draw_idx > 0) & (torch.remainder(draw_idx + 1, freq) == 0)
    old = adapt_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]]
    inv_mass = _estimate_inv_mass(cfg, acc["draws_cur"], acc["grads_cur"], old)
    inv_mass = _w(tuning & ~frozen, inv_mass, old)
    for kind in ("draws", "grads"):
        cur, bg = acc[f"{kind}_cur"], acc[f"{kind}_bg"]
        acc[f"{kind}_cur"] = tuple(_w(switch, b, c) for c, b in zip(cur, bg))
        acc[f"{kind}_bg"] = tuple(_w(switch, torch.zeros_like(b), b) for b in bg)
    vecs, flts = adapt_vecs.clone(), adapt_flts.clone()
    vecs[:, ADAPT_VEC_SLOTS["inv_mass"]] = inv_mass
    for name, (mi, vi, ci) in WELFORD.items():
        mean, m2, count = acc[name]
        vecs[:, mi], vecs[:, vi], flts[:, ci] = mean, m2, count
    return vecs, flts


def update_low_rank(cfg: MclmcConfig, states: MclmcState, bufs: MclmcBuffers,
                    chunk_start: int, limit: int, sched: Schedule) -> MclmcState:
    """The low-rank factors from the chunk's valid draws and gradients with
    the state's inverse mass, kept where due: the chunk ends after the
    early phase and no later than the freeze, with at least 8 valid draws
    (``mclmc.py:355-378``).  A chunk whose end rules the update out for
    every chain skips the estimate, which changes nothing."""
    end = chunk_start + limit
    if cfg.low_rank is None or not (sched.early_end < end <= sched.freeze_start):
        return states
    lr = cfg.low_rank
    rows = torch.arange(bufs.position.shape[1], device=bufs.position.device)
    valid = (rows[None, :] < limit) & ~bufs.diverging
    new = estimate_low_rank(bufs.position, bufs.gradient, valid, states.inv_mass,
                            lr.max_rank, lr.eigval_cutoff, lr.gamma)
    due = valid.sum(dim=1) >= 8
    return states.replace(lr_basis=_w(due, new.basis, states.lr_basis).contiguous(),
                          lr_log_eigs=_w(due, new.log_eigs, states.lr_log_eigs).contiguous())


class MclmcChunkRunner:
    """``run_chunk(states, chunk_start, limit, sched) -> (states, bufs)``.

    Per chunk (``nutpie_tpu/sampler/mclmc.py:321-378``): ``limit`` draws
    of ``steps_per_draw`` steps, each two
    batched ``model.logp_and_grad`` calls with a ``kick`` and a ``settle``
    after them, then the low-rank update.  Draws past ``limit`` are not
    run (the JAX runner masks their state and the host drops their rows).
    There is no pooling and no depth cap.

    On CUDA tensors the pieces are K3's launches (``mclmc_kernel``), which
    draw the refresh normals in the kernel: one draw's steps, the log
    densities with their autograd and the launches, are captured once per
    chunk in a CUDA graph and replayed ``limit`` times (the draw counter is
    the state's, on the device).  A log density that cannot be captured
    raises.  Under flow adaptation the log density is the pulled-back one
    under the chunk's flows (its own copy of the state's flow fields, read
    by the graph by address), and the chunk ends with the flow update of
    warmup chunks and the draws' conversion to model space through the
    flows that drew them.  ``plain=True`` runs the plain version on any device (the
    comparisons on the card use it), with the chunk's normals from
    ``draw_normals``, as the plain pieces on CPU tensors take them.
    """

    def __init__(self, model: ModelDef, cfg: MclmcConfig, chunk_len: int, dtype,
                 plain: bool = False):
        from .run import eager_unsupported

        why = eager_unsupported(cfg, model)
        if why is not None:
            raise NotImplementedError(why)
        self.model = model
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.dtype = dtype
        self.plain = plain
        self._pool = self._graph = None

    def __call__(self, states: MclmcState, chunk_start: int, limit: int, sched: Schedule):
        from .mclmc_kernel import KernelMclmcSteps, mclmc_kernel

        cfg, model = self.cfg, self.model
        chunk_start, limit = int(chunk_start), int(limit)
        C, _, dim = states.vecs.shape
        device = states.vecs.device
        bufs = init_buffers(cfg, self.chunk_len, C, dim, self.dtype, device)
        scratch = init_scratch(C, dim, self.dtype, device)
        states = states.clone()  # the chunk's own, updated in place
        chunk_flow = flow_params(states)
        logp_and_grad = pulled_back(cfg.flow, model.logp_and_grad, chunk_flow)
        if self.plain:
            steps = plain_steps(cfg, sched, chunk_start, limit, states, bufs, scratch)
        else:  # K3 on the card, drawing its normals; the plain pieces on the CPU
            steps = mclmc_kernel.chunk(cfg, sched, chunk_start, limit, states, bufs, scratch)
        z = steps.begin(states)

        def one_draw():
            z_ = z
            for _ in range(cfg.steps_per_draw):
                _, g_mid = logp_and_grad(z_)
                z_ = steps.kick(states, z_, g_mid)
                logp, g = logp_and_grad(z_)
                z_ = steps.settle(states, z_, logp, g)

        if isinstance(steps, KernelMclmcSteps):
            graph = self._capture(steps, z, one_draw, logp_and_grad)
            for _ in range(limit):
                graph.replay()
        else:
            for _ in range(limit):
                one_draw()
        states = update_low_rank(cfg, states, bufs, chunk_start, limit, sched)
        if cfg.flow is not None:
            states, bufs = mclmc_flow_chunk_end(cfg, model, states, bufs, chunk_flow,
                                                chunk_start, limit, sched)
        return states, bufs

    def _capture(self, steps, z, one_draw, logp_and_grad):
        """One draw of this chunk in a CUDA graph (``step_kernel.StepGraph``);
        the log density runs once first on a side stream."""
        from .mclmc_kernel import mclmc_kernel
        from .step_kernel import StepGraph

        t0 = time.perf_counter()
        device = z.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            logp_and_grad(z.clone())
        torch.cuda.current_stream(device).wait_stream(side)
        graph = StepGraph(mclmc_kernel, device)
        try:
            graph.capture(one_draw, self._pool)
        except Exception as err:
            name = getattr(self.model.logp_fn, "__qualname__", repr(self.model.logp_fn))
            raise RuntimeError(
                f"the log density {name} cannot be captured in a CUDA graph, which "
                f"the MCLMC runner on the card replays: {err}.  A captured log density "
                "keeps its constants on the device (built once per device and dtype), "
                "makes no host sync and copies no host data to the device after its "
                "first call") from err
        self._pool, self._graph = graph.graph.pool(), graph
        mclmc_kernel.capture_s += time.perf_counter() - t0
        return graph


def mclmc_flow_chunk_end(cfg: MclmcConfig, model: ModelDef, states: MclmcState,
                         bufs: MclmcBuffers, chunk_flow, chunk_start: int, limit: int,
                         sched: Schedule):
    """Flow adaptation's chunk boundary (``nutpie_tpu/sampler/mclmc.py:380-418``,
    through ``state.flow_boundary``): in warmup chunks each chain's flow
    trains on the chunk's valid rows (``row < limit``, not divergent) and
    the chain is re-based; then the chunk's draws go to model space through
    ``chunk_flow``, the flows that drew them (logp ``logp_z - logdet``, the
    gradient pushed through)."""
    out = flow_boundary(cfg.flow, model.logp_and_grad, states, chunk_flow, bufs.position,
                        bufs.gradient, bufs.diverging, limit, chunk_start < sched.num_tune)
    vecs, flts = states.vecs.clone(), states.flts.clone()
    vecs[:, M_VEC["position"]] = out.position
    vecs[:, M_VEC["gradient"]] = out.gradient
    flts[:, M_FLT["logp"]] = out.logp
    states = states.replace(vecs=vecs, flts=flts, **out.fields)
    scalars = bufs.scalars.clone()
    slot = MCLMC_SCALAR_SLOTS["logp"]
    scalars[..., slot] = scalars[..., slot] - out.logdets
    return states, bufs._replace(position=out.xs, scalars=scalars, gradient=out.grads_x)


def make_mclmc_chunk_runner(model: ModelDef, cfg: MclmcConfig, chunk_len: int, dtype,
                            plain: bool = False) -> MclmcChunkRunner:
    """The MCLMC chunk runner (the JAX function's call semantics)."""
    return MclmcChunkRunner(model, cfg, chunk_len, dtype, plain=plain)


def init_mclmc_chains(model: ModelDef, cfg: MclmcConfig, seed: int, n_chains: int,
                      init_mean, dtype, device="cpu", num_try_init: int = 100,
                      mesh=None):
    """Positions from the NUTS init search (``run.init_chains``, with its
    step search and init-quality retry), then the MCLMC state: a unit
    velocity from ``normal(fold_in(key, 5))``, the gradient-based initial
    inverse mass, ``log(step_size)``, empty Welford windows, under
    low-rank adaptation the identity metric, and under flow adaptation an
    identity inverse mass with each chain's initial flow and empty window
    (the initial flow is an exact identity, so base space is model space).
    Under a ``mesh`` (``parallel.ChainMesh``), this rank's slice of the
    fleet, as ``run.init_chains`` gives it."""
    from .run import init_chains

    nuts_states, ok = init_chains(model, NutsConfig(adapt=cfg.adapt), seed, n_chains,
                                  init_mean, dtype, device=device,
                                  num_try_init=num_try_init, mesh=mesh)
    key = nuts_states.key
    pos, grad, logp = nuts_states.position, nuts_states.gradient, nuts_states.logp
    C, dim = pos.shape
    u = threefry.normal(threefry.fold_in_data(key, 5), (dim,), dtype)
    u = u / torch.sqrt(torch.sum(u * u, dim=-1))[:, None]
    adapt_vecs = torch.zeros((C, N_ADAPT_VEC, dim), dtype=dtype, device=pos.device)
    adapt_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]] = (
        1.0 if cfg.flow is not None else init_inv_mass_from_gradient(grad).to(dtype))
    adapt_flts = torch.zeros((C, N_ADAPT_FLT), dtype=dtype, device=pos.device)
    flts = torch.stack([logp.to(dtype), torch.full_like(logp, math.log(cfg.step_size),
                                                        dtype=dtype)], dim=1)
    metric = {}
    if cfg.low_rank is not None:
        basis, log_eigs = identity_metric(C, dim, cfg.low_rank.max_rank, dtype, pos.device)
        metric = dict(lr_basis=basis, lr_log_eigs=log_eigs)
    if cfg.flow is not None:
        metric = flow_fields(init_flow_window(cfg.flow, dim, key, dtype))
    states = MclmcState(
        key=key.clone(),
        vecs=torch.stack([pos.to(dtype), grad.to(dtype), u], dim=1).contiguous(),
        flts=flts.contiguous(),
        ints=torch.zeros((C, N_M_INT), dtype=torch.int32, device=pos.device),
        adapt_vecs=adapt_vecs, adapt_flts=adapt_flts, **metric,
    )
    return states, ok
