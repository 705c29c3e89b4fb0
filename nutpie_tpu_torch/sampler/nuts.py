"""Vectorized No-U-Turn sampler as a per-leapfrog state machine, in torch.

Same algorithm as ``nutpie_tpu/sampler/nuts.py``: multinomial NUTS with
biased progressive sampling and the generalized (momentum-sum) U-turn
criterion, checked on subtrees through a checkpoint stack, divergence on
a large or nonfinite energy error, and warmup adaptation inline.  Every
chain advances by exactly one leapfrog per ``machine_step``; a chain that
finishes its draw refreshes its momentum and continues, so chains never
wait for each other inside a chunk.

Here the functions are written batched over a leading chains axis with
per-chain masks (no vmap), and the chunk buffers are updated in place by
indexed assignment.  This is the plain version of the CUDA chunk kernel
(``csrc/machine_step.cuh``) and of the step kernel (``csrc/step_kernel.cu``),
which run the same steps for one chain per warp.  The metric is the
diagonal one or, with ``NutsConfig.low_rank``, the low-rank modified one
(``low_rank.py``), applied through ``metric_velocity``,
``metric_velocity_rows`` and ``metric_momentum`` at every site where the
JAX machine step applies it.  The kinetic is the exact-normal one.  With
``store_divergences`` the state carries four more rows (``DIV_SLOTS``):
the start, its gradient, the end and the momentum of a draw's divergent
leapfrog, NaN until one diverges, committed with the draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..ops import threefry
from .adapt import AdaptConfig, Schedule, diag_adapt_init, diag_adapt_update
from .low_rank import identity_metric, lr_sample_momentum, lr_velocity, lr_velocity_rows
from .state import (
    ADAPT_FLT_SLOTS,
    DIV_SLOTS,
    FLT_SLOTS,
    INT_SLOTS,
    N_FLT,
    N_INT,
    N_VEC_BASE,
    N_VEC_DIV,
    VEC_SLOTS,
    NutsMachineState,
    tree_where,
    where as _w,
)

_FLOW_ITEM = "ROADMAP.md queue 1: flow adaptation"
_MCLMC_ITEM = "ROADMAP.md queue 1: MCLMC and the microcanonical kinetic"


@dataclasses.dataclass(frozen=True)
class LowRankConfig:
    """Low-rank mass-matrix options (``nutpie_tpu/sampler/nuts.py:66-75``)."""

    eigval_cutoff: float = 100.0
    gamma: float = 1e-5
    max_rank: int = 32
    # the window: the metric recomputes at chunk boundaries from the
    # chunk's draws, so chunks follow the mass-matrix switch cadence
    window: int = 80


@dataclasses.dataclass(frozen=True)
class NutsConfig:
    """Static sampler configuration (see ``nutpie_tpu/sampler/nuts.py``)."""

    maxdepth: int = 10
    mindepth: int = 0
    check_turning: bool = True
    kinetic: str = "exact_normal"
    target_time: Optional[float] = None
    extra_doublings: int = 0
    # fleet-relative work bound (run.fleet_depth_cap), engaged at >= 64 chains
    depth_cap_factor: float = 2.0
    # depth cap for warmup chunks before the first fleet measurement exists
    initial_depth_cap: int = 8
    max_energy_error: float = 1000.0
    store_gradient: bool = False
    store_mass_matrix: bool = False
    store_divergences: bool = False
    # the transformed draws exist only under flow adaptation (the JAX
    # package allocates them there alone), so without flow it is a no-op
    store_transformed: bool = False
    low_rank: Optional[LowRankConfig] = None
    flow: Optional[object] = None
    adapt: AdaptConfig = dataclasses.field(
        default_factory=lambda: AdaptConfig(num_tune=300)
    )

    def __post_init__(self):
        if self.flow is not None:
            raise NotImplementedError(f"flow adaptation: {_FLOW_ITEM}")
        if self.kinetic != "exact_normal":
            raise NotImplementedError(f"{self.kinetic} kinetic: {_MCLMC_ITEM}")


def n_vec_rows(cfg: NutsConfig) -> int:
    """Rows of the state's ``vecs``: 18 with the divergence rows, else 14."""
    return N_VEC_DIV if cfg.store_divergences else N_VEC_BASE


def metric_velocity(cfg: NutsConfig, s, p: torch.Tensor) -> torch.Tensor:
    """v = M^{-1} p for the active metric of state ``s`` (``p [C, dim]``)."""
    if cfg.low_rank is not None:
        return lr_velocity(s.inv_mass, s.lr_basis, s.lr_log_eigs, p)
    return s.inv_mass * p


def metric_velocity_rows(cfg: NutsConfig, s, P: torch.Tensor) -> torch.Tensor:
    """``metric_velocity`` of every row of ``P [C, k, dim]``."""
    if cfg.low_rank is not None:
        return lr_velocity_rows(s.inv_mass, s.lr_basis, s.lr_log_eigs, P)
    return P * s.inv_mass[:, None, :]


def metric_momentum(cfg: NutsConfig, s, gauss: torch.Tensor) -> torch.Tensor:
    """p ~ N(0, M) from standard normals ``gauss [C, dim]``."""
    if cfg.low_rank is not None:
        return lr_sample_momentum(s.inv_mass, s.lr_basis, s.lr_log_eigs, gauss)
    return gauss / torch.sqrt(s.inv_mass)


# slot layout of the packed per-draw scalar statistics buffer; integers and
# booleans are stored in the float dtype and restored on the host
SCALAR_SLOTS = {
    "logp": 0,
    "energy": 1,
    "depth": 2,
    "maxdepth_reached": 3,
    "diverging": 4,
    "step_size": 5,
    "step_size_bar": 6,
    "n_steps": 7,
    "mean_tree_accept": 8,
    "index_in_trajectory": 9,
    "fisher_distance": 10,
}
N_SCALAR_SLOTS = 12


class ChunkBuffers(NamedTuple):
    """Per-chain output buffers for one chunk of draws (NaN until written).

    The optional ones are allocated only where ``init_buffers`` is given a
    configuration that asks for them (the JAX package's ``ChunkBuffers``).
    """

    position: torch.Tensor  # [C, L, dim] unconstrained draws
    scalars: torch.Tensor   # [C, L, N_SCALAR_SLOTS]
    # [C, L, dim] if store_gradient or low_rank (the boundary update reads it)
    gradient: Optional[torch.Tensor] = None
    mass_matrix_inv: Optional[torch.Tensor] = None      # [C, L, dim] if store_mass_matrix
    mass_matrix_eigvals: Optional[torch.Tensor] = None  # [C, L, R] (low_rank)
    # [C, L, dim] each if store_divergences: NaN where the draw did not diverge
    divergence_start: Optional[torch.Tensor] = None
    divergence_end: Optional[torch.Tensor] = None
    divergence_momentum: Optional[torch.Tensor] = None
    divergence_start_gradient: Optional[torch.Tensor] = None

    def _slot(self, name):
        return self.scalars[..., SCALAR_SLOTS[name]]

    @property
    def n_steps(self):
        return self._slot("n_steps").to(torch.int32)

    @property
    def diverging(self):
        return self._slot("diverging") > 0.5

    @property
    def depth(self):
        return self._slot("depth").to(torch.int32)


# the divergence buffers and the state row each commits
DIV_BUFFERS = {
    "divergence_start": "div_start",
    "divergence_end": "div_end",
    "divergence_momentum": "div_mom",
    "divergence_start_gradient": "div_start_grad",
}


def init_buffers(chunk_len: int, dim: int, dtype, n_chains: int,
                 device=None, cfg: Optional[NutsConfig] = None) -> ChunkBuffers:
    """The chunk's buffers; ``cfg`` adds the optional ones it asks for."""
    f = lambda *shape: torch.full((n_chains,) + shape, math.nan, dtype=dtype,
                                  device=device)
    L = chunk_len
    cfg = cfg or NutsConfig()
    lr = cfg.low_rank
    div = {name: f(L, dim) for name in DIV_BUFFERS} if cfg.store_divergences else {}
    return ChunkBuffers(
        position=f(L, dim),
        scalars=f(L, N_SCALAR_SLOTS),
        gradient=f(L, dim) if cfg.store_gradient or lr is not None else None,
        mass_matrix_inv=f(L, dim) if cfg.store_mass_matrix else None,
        mass_matrix_eigvals=(f(L, lr.max_rank)
                             if lr is not None and cfg.store_mass_matrix else None),
        **div,
    )


def _pack(slots: dict, n: int, values: dict, dtype) -> torch.Tensor:
    rows = [None] * n
    for name, idx in slots.items():
        rows[idx] = values[name].to(dtype)
    return torch.stack(rows, dim=1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _logaddexp(a, b):
    """``jnp.logaddexp``: equal infinities (and NaNs) give ``a + b``."""
    amax = torch.maximum(a, b)
    delta = a - b
    return torch.where(
        torch.isnan(delta), a + b,
        amax + torch.log1p(torch.exp(-torch.abs(delta))),
    )


def start_draw(cfg: NutsConfig, sched: Schedule, state: NutsMachineState,
               gauss: torch.Tensor, jitter_u: torch.Tensor) -> NutsMachineState:
    """Refresh momentum and reset trajectory/subtree state for a new draw."""
    dtype = state.vecs.dtype
    position, gradient, logp = state.position, state.gradient, state.logp
    tuning = state.draw_idx < sched.num_tune
    log_eps = torch.where(tuning, state.adapt_flt("log_step"),
                          state.adapt_flt("log_step_bar"))
    eps = torch.exp(log_eps)
    if cfg.adapt.step_size_jitter is not None:
        eps = eps * (1.0 + cfg.adapt.step_size_jitter * (2.0 * jitter_u - 1.0))
    p0 = metric_momentum(cfg, state, gauss)
    ke = 0.5 * _dot(p0, metric_velocity(cfg, state, p0))
    h0 = -logp + ke
    zeros = torch.zeros_like(logp)
    zeros_i = torch.zeros_like(state.draw_idx)
    rows = [position, p0, gradient, position, p0, gradient, p0,
            torch.zeros_like(position), position, gradient, position, gradient,
            position, gradient]
    if cfg.store_divergences:
        rows += [torch.full_like(position, math.nan)] * len(DIV_SLOTS)
    vecs = torch.stack(rows, dim=1)
    flts = _pack(FLT_SLOTS, N_FLT, dict(
        logp=logp, eps=eps, h0=h0, logw_traj=zeros, prop_logp=logp,
        prop_energy=h0, logw_sub=torch.full_like(logp, -math.inf),
        sprop_logp=logp, sprop_energy=h0, sum_acc=zeros, ke_minus=zeros,
        ke_plus=zeros,
    ), dtype)
    ints = _pack(INT_SLOTS, N_INT, dict(
        draw_idx=state.draw_idx, prop_idx=zeros_i, depth=zeros_i,
        direction=torch.ones_like(zeros_i), left_idx=zeros_i,
        right_idx=zeros_i, n_leaves=zeros_i, n_leaf=zeros_i,
        sprop_idx=zeros_i, ckpt_top=zeros_i, total_steps=state.total_steps,
        divergence_count=state.divergence_count, diverging=zeros_i,
        turning_sub=zeros_i, done=state.ints[:, INT_SLOTS["done"]],
    ), torch.int32)
    return state.replace(vecs=vecs, flts=flts, ints=ints)


def init_machine_state(cfg: NutsConfig, key: torch.Tensor, position, gradient,
                       logp, dtype) -> NutsMachineState:
    """Initial state of C chains (before the first chunk)."""
    n, dim = position.shape
    device = position.device
    D = max(cfg.maxdepth, 2)
    position = position.to(dtype)
    gradient = gradient.to(dtype)
    adapt_vecs, adapt_flts = diag_adapt_init(cfg.adapt, gradient, dtype)
    vecs = torch.zeros((n, n_vec_rows(cfg), dim), dtype=dtype, device=device)
    vecs[:, VEC_SLOTS["position"]] = position
    vecs[:, VEC_SLOTS["gradient"]] = gradient
    vecs[:, N_VEC_BASE:] = math.nan
    flts = torch.zeros((n, N_FLT), dtype=dtype, device=device)
    flts[:, FLT_SLOTS["logp"]] = logp.to(dtype)
    flts[:, FLT_SLOTS["eps"]] = cfg.adapt.initial_step
    flts[:, FLT_SLOTS["logw_sub"]] = -math.inf
    ints = torch.zeros((n, N_INT), dtype=torch.int32, device=device)
    ints[:, INT_SLOTS["direction"]] = 1
    metric = {}
    if cfg.low_rank is not None:
        basis, log_eigs = identity_metric(n, dim, cfg.low_rank.max_rank, dtype, device)
        metric = dict(lr_basis=basis, lr_log_eigs=log_eigs)
    return NutsMachineState(
        key=key, adapt_vecs=adapt_vecs, adapt_flts=adapt_flts, vecs=vecs,
        ckpt_p=torch.zeros((n, D, dim), dtype=dtype, device=device),
        ckpt_s=torch.zeros((n, D, dim), dtype=dtype, device=device),
        flts=flts, ints=ints, **metric,
    )


def leapfrog_uniforms(key: torch.Tensor, total_steps: torch.Tensor, dtype):
    """The three per-leapfrog uniforms ``uniform(fold_in(fold_in(k, 3), t), (3,))``."""
    ku = threefry.fold_in_data(
        threefry.fold_in_data(key, 3), total_steps.to(torch.int64)
    )
    return threefry.uniform3(ku).to(dtype)


class LeapfrogUniformTable:
    """``leapfrog_uniforms`` served from a table of the next ``window`` steps.

    Each chain's stream is indexed by its leapfrog count, which advances by
    one per active step, so a table of ``window`` consecutive counts per
    chain is refilled (in one batched hash) only every ``window`` steps.
    Same values as ``leapfrog_uniforms``; fewer, larger torch calls.
    """

    def __init__(self, key: torch.Tensor, window: int = 128):
        self.k3 = threefry.fold_in_data(key, 3)
        self.window = window
        self.base = None
        self.table = None
        self.rows = torch.arange(key.shape[0], device=key.device)

    def __call__(self, key, total_steps: torch.Tensor, dtype):
        ts = total_steps.to(torch.int64)
        if self.base is None or bool(
            ((ts - self.base) >= self.window).any() | (ts < self.base).any()
        ):
            self.base = ts.clone()
            steps = self.base[:, None] + torch.arange(self.window, device=ts.device)
            self.table = threefry.uniform3(
                threefry.fold_in_data(self.k3[:, None, :], steps)
            )
        return self.table[self.rows, ts - self.base].to(dtype)


def _trailing_zeros(n: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of positive int32s, in integer arithmetic.

    (A float log2 of the lowest set bit is not exact on every device: on
    CUDA it can land just below the integer.)
    """
    lsb = n & -n
    powers = 2 ** torch.arange(1, 31, dtype=n.dtype, device=n.device)
    return (lsb[:, None] >= powers).sum(dim=1).to(torch.int32)


class LeapfrogCarry(NamedTuple):
    """What ``leapfrog_finish`` takes over from ``leapfrog_begin``."""

    u3: torch.Tensor         # [C, 3] the step's uniforms
    direction: torch.Tensor  # [C] int32, +1 or -1
    ckpt_p: torch.Tensor     # [C, D, dim] with slot D-1's stash
    p_half: torch.Tensor     # [C, dim] momentum after the first half-kick
    stagnant: torch.Tensor   # [C] bool: the step left the position unchanged


def leapfrog_begin(cfg: NutsConfig, s: NutsMachineState,
                   uniforms=leapfrog_uniforms):
    """The machine step up to the log density: ``(z_new [C, dim], carry)``.

    Draws the step's uniforms, picks the direction at a doubling's start
    (stashing the old edge momentum in checkpoint slot D-1), takes the
    first half-kick and the drift.  ``z_new`` is the row handed to the
    log density; a done chain hands its committed position, which is
    finite, and its step is masked out in ``leapfrog_finish``.
    ``uniforms(key, total_steps, dtype)`` gives the per-leapfrog uniforms
    (``leapfrog_uniforms`` or a ``LeapfrogUniformTable``).
    """
    dtype = s.vecs.dtype
    D = s.ckpt_p.shape[1]
    V, I = VEC_SLOTS, INT_SLOTS
    vec = lambda name: s.vecs[:, V[name]]
    in_p_minus, in_p_plus = vec("p_minus"), vec("p_plus")
    active = ~(s.ints[:, I["done"]] > 0)

    # ------------------------------------------------ scalar randomness
    u3 = uniforms(s.key, s.ints[:, I["total_steps"]], dtype)

    # ------------------------------------------------ doubling start
    at_start = s.ints[:, I["n_leaf"]] == 0
    new_dir = torch.where(u3[:, 0] < 0.5, -1, 1).to(torch.int32)
    direction = torch.where(at_start, new_dir, s.ints[:, I["direction"]])
    fwd = direction > 0

    # slot D-1 stashes the old edge momentum for the cross U-turn checks
    edge_p_old = _w(fwd, in_p_plus, in_p_minus)
    ckpt_p = s.ckpt_p.clone()
    ckpt_p[:, D - 1] = _w(at_start & active, edge_p_old, ckpt_p[:, D - 1])

    # ------------------------------------------------ leapfrog, first half
    z_e = _w(fwd, vec("z_plus"), vec("z_minus"))
    p_e = _w(fwd, in_p_plus, in_p_minus)
    g_e = _w(fwd, vec("g_plus"), vec("g_minus"))
    eps_s = (direction.to(dtype) * s.flts[:, FLT_SLOTS["eps"]])[:, None]
    p_half = p_e + 0.5 * eps_s * g_e
    z_new = z_e + eps_s * metric_velocity(cfg, s, p_half)
    # an unintegrable step (eps below the position's resolution) counts as
    # a divergence, as in the JAX package
    stagnant = torch.all(z_new == z_e, dim=1)
    z_new = _w(active, z_new, vec("position"))
    return z_new, LeapfrogCarry(u3, direction, ckpt_p, p_half, stagnant)


def machine_step(cfg: NutsConfig, logp_and_grad, sched: Schedule,
                 mom_gauss: torch.Tensor, jitter_us: torch.Tensor,
                 chunk_start: int, limit: int, s: NutsMachineState,
                 bufs: ChunkBuffers, adapt_frozen: bool = False,
                 uniforms=leapfrog_uniforms):
    """Advance every chain by one leapfrog step.

    ``mom_gauss [C, L, dim]`` and ``jitter_us [C, L]`` are the chunk's
    per-draw randoms; ``bufs`` is updated in place where draws complete.
    ``adapt_frozen=True`` leaves the adaptation state untouched.
    ``uniforms(key, total_steps, dtype)`` gives the per-leapfrog uniforms
    (``leapfrog_uniforms`` or a ``LeapfrogUniformTable``).  The step is
    ``leapfrog_begin``, one batched ``logp_and_grad``, ``leapfrog_finish``.
    """
    z_new, carry = leapfrog_begin(cfg, s, uniforms)
    logp_new, g_new = logp_and_grad(z_new)
    return leapfrog_finish(cfg, sched, mom_gauss, jitter_us, chunk_start, limit,
                           s, z_new, carry, logp_new, g_new, bufs, adapt_frozen)


def leapfrog_finish(cfg: NutsConfig, sched: Schedule, mom_gauss: torch.Tensor,
                    jitter_us: torch.Tensor, chunk_start: int, limit: int,
                    s: NutsMachineState, z_new: torch.Tensor, carry: LeapfrogCarry,
                    logp_new: torch.Tensor, g_new: torch.Tensor,
                    bufs: ChunkBuffers, adapt_frozen: bool = False):
    """The machine step after the log density at ``z_new``: the second
    half-kick, the leaf, the subtree and trajectory checks, draw completion
    (commit, adaptation, the next ``start_draw``).  Returns ``(state, bufs)``;
    ``bufs`` is updated in place where draws complete."""
    dtype = s.vecs.dtype
    D = s.ckpt_p.shape[1]
    C = s.vecs.shape[0]
    L = mom_gauss.shape[1]
    V, F, I = VEC_SLOTS, FLT_SLOTS, INT_SLOTS
    vec = lambda name: s.vecs[:, V[name]]
    flt = lambda name: s.flts[:, F[name]]
    int_ = lambda name: s.ints[:, I[name]]

    in_p_minus, in_p_plus = vec("p_minus"), vec("p_plus")
    in_rho, in_rho_sub = vec("rho"), vec("rho_sub")
    in_eps, in_h0 = flt("eps"), flt("h0")
    in_logw_traj, in_logw_sub = flt("logw_traj"), flt("logw_sub")
    in_draw_idx, in_depth = int_("draw_idx"), int_("depth")
    in_n_leaf, in_n_leaves = int_("n_leaf"), int_("n_leaves")
    in_total_steps = int_("total_steps")
    in_diverging = int_("diverging") > 0
    in_turning_sub = int_("turning_sub") > 0
    in_done = int_("done") > 0
    active = ~in_done
    u3, direction, ckpt_p = carry.u3, carry.direction, carry.ckpt_p
    fwd = direction > 0
    ckpt_s = s.ckpt_s.clone()

    # ------------------------------------------------ leapfrog, second half
    eps_s = (direction.to(dtype) * in_eps)[:, None]
    logp_new = logp_new.to(dtype)
    g_new = g_new.to(dtype)
    p_new = carry.p_half + 0.5 * eps_s * g_new
    v_new = metric_velocity(cfg, s, p_new)
    ke = 0.5 * _dot(p_new, v_new)
    h = -logp_new + ke

    # ------------------------------------------------ leaf processing
    n = in_n_leaf + 1
    e_err = h - in_h0
    finite = torch.isfinite(e_err)
    div_leaf = (~finite) | (e_err > cfg.max_energy_error) | carry.stagnant
    lw = torch.where(div_leaf, torch.full_like(e_err, -math.inf), -e_err)
    acc = torch.where(
        finite, torch.exp(torch.clamp(-e_err, max=0.0)), torch.zeros_like(e_err)
    )

    sum_acc = _w(active, flt("sum_acc") + acc, flt("sum_acc"))
    n_leaves = _w(active, in_n_leaves + 1, in_n_leaves)
    total_steps = _w(active, in_total_steps + 1, in_total_steps)

    abs_idx = torch.where(fwd, int_("right_idx") + 1, int_("left_idx") - 1)
    right_idx = _w(active & fwd, int_("right_idx") + 1, int_("right_idx"))
    left_idx = _w(active & ~fwd, int_("left_idx") - 1, int_("left_idx"))

    # progressive multinomial within the subtree
    logw_sub_new = _logaddexp(in_logw_sub, lw)
    take = torch.log(u3[:, 1]) < (lw - logw_sub_new)
    take = take & ~torch.isnan(lw - logw_sub_new)
    m_take = active & take
    sprop_z = _w(m_take, z_new, vec("sprop_z"))
    sprop_g = _w(m_take, g_new, vec("sprop_g"))
    sprop_logp = _w(m_take, logp_new, flt("sprop_logp"))
    sprop_energy = _w(m_take, h, flt("sprop_energy"))
    sprop_idx = _w(m_take, abs_idx, int_("sprop_idx"))

    rho_sub_new = in_rho_sub + p_new

    # checkpoint stack: push at odd leaves, check+pop at even leaves
    odd = (n % 2) == 1
    top = int_("ckpt_top")
    push = active & odd
    rows = torch.arange(C, device=top.device)
    top_c = top.long().clamp(0, D - 1)
    ckpt_p[rows, top_c] = _w(push, p_new, ckpt_p[rows, top_c])
    ckpt_s[rows, top_c] = _w(push, in_rho_sub, ckpt_s[rows, top_c])
    top_after_push = torch.where(push, top + 1, top)

    tz = _trailing_zeros(n)
    even = active & ~odd
    if cfg.check_turning:
        slots = torch.arange(D, device=top.device)[None, :]
        slot_mask = (slots < top_after_push[:, None]) & (
            slots >= (top_after_push - tz)[:, None]
        )
        rho_ab = rho_sub_new[:, None, :] - ckpt_s                 # [C, D, dim]
        d_a = torch.sum(rho_ab * metric_velocity_rows(cfg, s, ckpt_p), dim=2)
        d_b = torch.sum(rho_ab * v_new[:, None, :], dim=2)
        turn_vec = (d_a <= 0) | (d_b <= 0)
        turning_here = torch.any(turn_vec & slot_mask, dim=1)
        turning_sub_mid = in_turning_sub | (even & turning_here)
    else:
        turning_sub_mid = in_turning_sub
    top_new = torch.where(
        even, top_after_push - torch.clamp(tz - 1, min=0), top_after_push
    )

    # ------------------------------------------------ subtree completion
    full = n >= (1 << in_depth)
    sub_invalid = div_leaf | turning_sub_mid
    sub_done = active & (full | sub_invalid)
    merge_ok = sub_done & ~sub_invalid

    # biased progressive sampling at the merge
    log_ratio = logw_sub_new - in_logw_traj
    take2 = torch.log(u3[:, 2]) < log_ratio
    take2 = take2 & ~torch.isnan(log_ratio)
    m_take2 = merge_ok & take2
    prop_z = _w(m_take2, sprop_z, vec("prop_z"))
    prop_g = _w(m_take2, sprop_g, vec("prop_g"))
    prop_logp = _w(m_take2, sprop_logp, flt("prop_logp"))
    prop_energy = _w(m_take2, sprop_energy, flt("prop_energy"))
    prop_idx = _w(m_take2, sprop_idx, int_("prop_idx"))

    logw_traj = _w(merge_ok, _logaddexp(in_logw_traj, logw_sub_new), in_logw_traj)
    rho_full = in_rho + rho_sub_new
    rho = _w(merge_ok, rho_full, in_rho)

    # U-turn checks on the merged trajectory (main + cross checks)
    if cfg.check_turning:
        far_p = _w(fwd, in_p_minus, in_p_plus)
        first_new_p = ckpt_p[:, 0]
        edge_old_p = ckpt_p[:, D - 1]
        v_far = metric_velocity(cfg, s, far_p)
        v_first_new = metric_velocity(cfg, s, first_new_p)
        v_edge_old = metric_velocity(cfg, s, edge_old_p)

        def turn(r, va, vb):
            return (_dot(r, va) <= 0) | (_dot(r, vb) <= 0)

        t1 = turn(rho_full, v_far, v_new)
        t2 = turn(in_rho + first_new_p, v_far, v_first_new)
        t3 = turn(rho_sub_new + edge_old_p, v_edge_old, v_new)
        turning_traj = merge_ok & (t1 | t2 | t3)
        turning_traj = turning_traj & ((in_depth + 1) >= cfg.mindepth)
    else:
        turning_traj = torch.zeros_like(merge_ok)

    if cfg.target_time is not None:
        # target / eps as a true division in eps's dtype, as the JAX package
        # computes it (a float over a tensor would multiply by 1 / eps)
        ratio = torch.div(torch.full_like(in_eps, cfg.target_time), in_eps)
        req = torch.ceil(torch.log2(torch.clamp(ratio, min=1.0)))
        req = req.to(torch.int32) + cfg.extra_doublings
        depth_limit = torch.clamp(req, max(cfg.mindepth, 1), cfg.maxdepth)
    else:
        depth_limit = torch.full_like(in_depth, cfg.maxdepth)
    depth_limit = torch.clamp(
        torch.minimum(depth_limit, torch.as_tensor(sched.depth_cap, dtype=torch.int32,
                                                   device=depth_limit.device)),
        min=max(cfg.mindepth, 1),
    )
    ended_by_depth = merge_ok & ((in_depth + 1) >= depth_limit)
    draw_done = sub_done & (sub_invalid | turning_traj | ended_by_depth)

    # next doubling (when merged and continuing)
    next_doubling = merge_ok & ~draw_done
    depth = _w(next_doubling, in_depth + 1, in_depth)
    n_leaf = _w(active, torch.where(next_doubling, torch.zeros_like(n), n), in_n_leaf)
    rho_sub = _w(active, _w(next_doubling, torch.zeros_like(rho_sub_new), rho_sub_new),
                 in_rho_sub)
    logw_sub = _w(active, torch.where(next_doubling, torch.full_like(logw_sub_new, -math.inf),
                                      logw_sub_new), in_logw_sub)
    turning_sub = _w(active, turning_sub_mid & ~next_doubling, in_turning_sub)
    top_new = torch.where(next_doubling, torch.zeros_like(top_new), top_new)
    ckpt_top = _w(active, top_new, top)

    # edge updates from the leapfrog
    z_plus = _w(active & fwd, z_new, vec("z_plus"))
    p_plus = _w(active & fwd, p_new, in_p_plus)
    g_plus = _w(active & fwd, g_new, vec("g_plus"))
    z_minus = _w(active & ~fwd, z_new, vec("z_minus"))
    p_minus = _w(active & ~fwd, p_new, in_p_minus)
    g_minus = _w(active & ~fwd, g_new, vec("g_minus"))

    # divergence location: the edge the step left, and where it went
    div_rows = []
    if cfg.store_divergences:
        m_div = active & div_leaf
        edge = lambda plus, minus: _w(fwd, vec(plus), vec(minus))
        div_values = {"div_start": edge("z_plus", "z_minus"),
                      "div_start_grad": edge("g_plus", "g_minus"),
                      "div_end": z_new, "div_mom": edge("p_plus", "p_minus")}
        div_rows = [_w(m_div, div_values[name], s.vecs[:, slot])
                    for name, slot in DIV_SLOTS.items()]

    diverging = _w(active, in_diverging | div_leaf, in_diverging)

    # ------------------------------------------------ draw completion
    idx = in_draw_idx - chunk_start
    idx_c = torch.clamp(idx, 0, L - 1).long()
    accept_mean = sum_acc / torch.clamp(n_leaves, min=1).to(dtype)
    md_reached = ended_by_depth & ~turning_traj
    tuning = in_draw_idx < sched.num_tune
    step_size_bar = torch.exp(s.adapt_flt("log_step_bar"))

    slot_values = {
        "logp": prop_logp,
        "energy": prop_energy,
        "depth": in_depth + 1,
        "maxdepth_reached": md_reached,
        "diverging": diverging,
        "step_size": in_eps,
        "step_size_bar": step_size_bar,
        "n_steps": n_leaves,
        "mean_tree_accept": accept_mean,
        "index_in_trajectory": prop_idx,
        "fisher_distance": torch.zeros_like(in_eps),
    }
    scalar_row = torch.zeros((C, N_SCALAR_SLOTS), dtype=dtype, device=in_eps.device)
    for name, value in slot_values.items():
        scalar_row[:, SCALAR_SLOTS[name]] = value.to(dtype)
    done_rows = torch.nonzero(draw_done).squeeze(1)
    if done_rows.numel():
        at = (done_rows, idx_c[done_rows])
        bufs.position[at] = prop_z[done_rows]
        bufs.scalars[at] = scalar_row[done_rows]
        if bufs.gradient is not None:
            bufs.gradient[at] = prop_g[done_rows]
        if bufs.mass_matrix_inv is not None:
            bufs.mass_matrix_inv[at] = s.inv_mass[done_rows]
        if bufs.mass_matrix_eigvals is not None:
            bufs.mass_matrix_eigvals[at] = torch.exp(s.lr_log_eigs[done_rows])
        if cfg.store_divergences:
            for buf, row in DIV_BUFFERS.items():
                getattr(bufs, buf)[at] = div_rows[DIV_SLOTS[row] - N_VEC_BASE][done_rows]

    # adaptation (tuning draws only)
    adapt_vecs, adapt_flts = s.adapt_vecs, s.adapt_flts
    if not adapt_frozen and bool((draw_done & tuning).any()):
        new_vecs, new_flts = diag_adapt_update(
            cfg.adapt, sched, adapt_vecs, adapt_flts, in_draw_idx, prop_z,
            prop_g, accept_mean, diverging,
        )
        upd = draw_done & tuning
        adapt_vecs = _w(upd, new_vecs, adapt_vecs)
        adapt_flts = _w(upd, new_flts, adapt_flts)
        # at the end of tuning, freeze the step size at its averaged value
        end_of_tuning = draw_done & (in_draw_idx == sched.num_tune - 1)
        ls, lsb = ADAPT_FLT_SLOTS["log_step"], ADAPT_FLT_SLOTS["log_step_bar"]
        adapt_flts = adapt_flts.clone()
        adapt_flts[:, ls] = torch.where(end_of_tuning, adapt_flts[:, lsb],
                                        adapt_flts[:, ls])

    divergence_count = _w(draw_done & diverging, int_("divergence_count") + 1,
                          int_("divergence_count"))
    draw_idx = _w(draw_done, in_draw_idx + 1, in_draw_idx)
    done = in_done | (draw_done & (idx + 1 >= limit))

    # ------------------------------------------------ reassemble packed state
    vecs = torch.stack(
        [z_minus, p_minus, g_minus, z_plus, p_plus, g_plus, rho, rho_sub,
         prop_z, prop_g, sprop_z, sprop_g,
         _w(draw_done, prop_z, vec("position")),
         _w(draw_done, prop_g, vec("gradient"))] + div_rows,
        dim=1,
    )
    state = s.replace(
        adapt_vecs=adapt_vecs,
        adapt_flts=adapt_flts,
        vecs=vecs,
        ckpt_p=ckpt_p,
        ckpt_s=ckpt_s,
        flts=_pack(FLT_SLOTS, N_FLT, dict(
            logp=_w(draw_done, prop_logp, flt("logp")),
            eps=in_eps, h0=in_h0, logw_traj=logw_traj, prop_logp=prop_logp,
            prop_energy=prop_energy, logw_sub=logw_sub,
            sprop_logp=sprop_logp, sprop_energy=sprop_energy,
            sum_acc=sum_acc, ke_minus=flt("ke_minus"), ke_plus=flt("ke_plus"),
        ), dtype),
        ints=_pack(INT_SLOTS, N_INT, dict(
            draw_idx=draw_idx, prop_idx=prop_idx, depth=depth,
            direction=_w(active, direction, int_("direction")),
            left_idx=left_idx, right_idx=right_idx, n_leaves=n_leaves,
            n_leaf=n_leaf, sprop_idx=sprop_idx, ckpt_top=ckpt_top,
            total_steps=total_steps, divergence_count=divergence_count,
            diverging=diverging, turning_sub=turning_sub, done=done,
        ), torch.int32),
    )

    # start the next draw for chains that completed one and aren't done
    restart = draw_done & ~done
    if bool(restart.any()):
        next_idx_c = torch.clamp(idx + 1, 0, L - 1).long()
        started = start_draw(
            cfg, sched, state,
            mom_gauss[rows, next_idx_c], jitter_us[rows, next_idx_c],
        )
        state = tree_where(restart, started, state)
    return state, bufs
