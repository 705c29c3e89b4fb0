"""Chain initialization and the chunk-boundary fleet operations.

Ported from ``nutpie_tpu/sampler/run.py``, batched over chains with host
loops where the JAX package used ``while_loop``:

- ``find_initial_step``: the reasonable-step-size search at the initial
  position (4-leapfrog probes, crossing ``target_accept``; isokinetic
  under the microcanonical kinetic).
- ``make_init_fn`` / ``init_chains``: seeded jittered init points retried
  until logp and gradient are finite, then the init-quality retry that
  redraws pathological chains.
- ``fleet_depth_cap`` and ``rescue_trapped``: cross-chain statistics at
  chunk boundaries.  Medians average the two middle values, as numpy's
  and ``jnp.median`` do (``torch.median`` returns the lower one).
- Every function that reads across chains takes the fleet's mesh
  (``parallel.ChainMesh``; None: one rank): it gathers the whole fleet's
  input in chain order, computes what one process computes, and keeps
  this rank's rows (``parallel/mesh.py``).
- ``update_low_rank``: the low-rank metric's chunk-boundary update
  (``nutpie_tpu/sampler/run.py:450-475``), after the rescue.
- ``flow_chunk_end``: flow adaptation's chunk boundary
  (``nutpie_tpu/sampler/run.py:477-549``), after the rescue: the Fisher
  distance of each draw, the flow update of warmup chunks, the draws in
  model space.
- ``draw_randoms``: the per-draw momentum normals and jitter uniforms,
  keyed by absolute draw index, so streams do not depend on chunking.
- ``make_chunk_runner``: the chunk runner of every model without a
  device-side log density: the step kernel's ``begin``, then machine
  steps, each one batched ``model.logp_and_grad`` and the kernel's
  ``advance``; on the card ``unroll`` of them are captured once per chunk
  in a CUDA graph and replayed.

Randomness derives from ``fold_in`` chains of the per-chain key exactly as
in the JAX package, so both draw the same numbers from the same seed.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..model import ModelDef
from ..ops import threefry
from ..parallel.mesh import ChainMesh, chain_row, gather_chains, local_rows, shard_chains
from ..transforms.flow import pulled_back
from ..transforms.flow import median as _median
from .adapt import Schedule, flts_set, pool_adapt_state
from .isokinetic import apply_A, apply_At, iso_metric, update_velocity
from .low_rank import estimate_low_rank
from .nuts import (
    SCALAR_SLOTS,
    NutsConfig,
    init_buffers,
    init_machine_state,
    metric_momentum,
    metric_velocity,
    start_draw,
)
from .state import (
    FLOW_FIELDS,
    WINDOW_FIELDS,
    NutsMachineState,
    flow_boundary,
    flow_params,
    state_with,
    tree_where,
    where,
)
from .step_kernel import KernelSteps, PlainSteps, StepGraph, step_kernel

# machine steps a CUDA graph holds, replayed between two "all done?" reads
# on the card (one small device-to-host copy each); on the CPU every step
# checks
CUDA_UNROLL = 8


def resolve_dtype(precision: str, device) -> torch.dtype:
    if precision == "float64":
        return torch.float64
    if precision == "float32":
        return torch.float32
    # auto: float32 on CUDA, float64 on the CPU (the test setting)
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def find_initial_step(cfg: NutsConfig, logp_and_grad, state: NutsMachineState,
                      max_iters: int = 32) -> NutsMachineState:
    """Stan-style reasonable-step-size search at the initial position.

    Doubles/halves the step size until the worst energy error of a
    4-leapfrog probe crosses ``log(target_accept)``, backs off a factor 4
    and starts dual averaging there.  Each chain's result is the JAX
    function's under ``jax.vmap``; the probes of chains whose outcome is
    already decided evaluate at their start instead (``accept_prob``).
    """
    dtype = state.vecs.dtype
    key = threefry.fold_in_data(state.key, 6)
    dim = state.position.shape[1]
    gauss = threefry.normal(key, (dim,), dtype)
    if cfg.micro:
        # the isokinetic probe: a unit velocity and h0 = -logp, the kinetic
        # weight accumulated along the probe (nutpie_tpu/sampler/run.py:65-95)
        metric = iso_metric(cfg, state)
        p0 = gauss / torch.clamp(torch.sqrt(torch.sum(gauss * gauss, dim=1)),
                                 min=1e-30)[:, None]
        h0 = -state.logp
    else:
        p0 = metric_momentum(cfg, state, gauss)
        h0 = -state.logp + 0.5 * torch.sum(p0 * metric_velocity(cfg, state, p0), dim=1)

    def accept_prob(log_eps, live, settled, n_steps: int = 4):
        # the worst energy error of each chain's probe.  A chain that is not
        # ``live``, or whose probe is ``settled`` (its outcome decided by
        # the worst error so far), evaluates the log density at its start
        # instead of moving on: its result is not read, and each chain's
        # row is its own, so the live chains' bits are the same, while a
        # chain that has reached a costly region (an ODE solve at its step
        # cap) no longer holds the fleet there
        eps = torch.exp(log_eps)[:, None]
        z, p, g = state.position, p0, state.gradient
        worst = torch.zeros_like(log_eps)
        ke = torch.zeros_like(log_eps)
        for _ in range(n_steps):
            live = live & ~settled(worst)
            if cfg.micro:
                u_half, dke1 = update_velocity(p, -apply_At(*metric, g), 0.5 * eps[:, 0], dim)
                z = z + eps * apply_A(*metric, u_half)
                logp_new, g = logp_and_grad(torch.where(live[:, None], z, state.position))
                g = g.to(dtype)
                p, dke2 = update_velocity(u_half, -apply_At(*metric, g), 0.5 * eps[:, 0], dim)
                ke = ke + dke1 + dke2
                h = -logp_new.to(dtype) + ke
            else:
                p_half = p + 0.5 * eps * g
                z = z + eps * metric_velocity(cfg, state, p_half)
                logp_new, g = logp_and_grad(torch.where(live[:, None], z, state.position))
                g = g.to(dtype)
                p = p_half + 0.5 * eps * g
                h = -logp_new.to(dtype) + 0.5 * torch.sum(
                    p * metric_velocity(cfg, state, p), dim=1)
            a = h0 - h
            a = torch.where(torch.isfinite(a), a, torch.full_like(a, -math.inf))
            worst = torch.where(live, torch.minimum(worst, a), worst)
        return worst

    log_target = math.log(cfg.adapt.target_accept)
    log_eps = state.adapt_flt("log_step")
    # the first probe sets the direction and whether the search runs at
    # all (a non-finite probe stops it): settled once the worst is -inf
    a0 = accept_prob(log_eps, torch.ones_like(log_eps, dtype=torch.bool),
                     lambda worst: worst == -math.inf)
    direction = torch.where(a0 > log_target, 1.0, -1.0).to(dtype)
    keep_going = a0 > -math.inf
    for _ in range(max_iters):
        if not bool(keep_going.any()):
            break
        log_eps_new = log_eps + direction * math.log(2.0)
        # a later probe decides only whether it crosses log_target, which
        # the worst so far settles once it is at or below it
        a = accept_prob(log_eps_new, keep_going, lambda worst: worst <= log_target)
        crossed = torch.where(direction > 0, a <= log_target, a > log_target)
        log_eps_out = torch.where(crossed & (direction > 0), log_eps, log_eps_new)
        log_eps = torch.where(keep_going, log_eps_out, log_eps)
        keep_going = keep_going & ~crossed
    log_eps = log_eps - math.log(4.0)
    log_eps = torch.clamp(log_eps, math.log(1e-10), math.log(1e3))
    adapt_flts = flts_set(
        state.adapt_flts, {"log_step": log_eps, "log_step_bar": log_eps, "mu": log_eps}
    )
    return state.replace(adapt_flts=adapt_flts)


def make_init_fn(model: ModelDef, cfg: NutsConfig, dtype,
                 num_try_init: int = 100, step_search: bool = True):
    """Chain initialization: ``init_fn(chain_keys [C, 2], init_mean) -> (state, ok)``."""

    def init_fn(chain_keys: torch.Tensor, init_mean: torch.Tensor):
        init_base = threefry.fold_in_data(chain_keys, 0)

        def try_init(t: int):
            pos = model.initial_position(
                threefry.fold_in_data(init_base, t), init_mean
            ).to(dtype)
            logp, grad = model.logp_and_grad(pos)
            ok = torch.isfinite(logp) & torch.all(torch.isfinite(grad), dim=1)
            return pos, logp.to(dtype), grad.to(dtype), ok

        pos, logp, grad, ok = try_init(0)
        t = 1
        while t < num_try_init and not bool(ok.all()):
            pos2, logp2, grad2, ok2 = try_init(t)
            retry = ~ok
            pos = torch.where(retry[:, None], pos2, pos)
            logp = torch.where(retry, logp2, logp)
            grad = torch.where(retry[:, None], grad2, grad)
            ok = torch.where(retry, ok2, ok)
            t += 1
        state = init_machine_state(cfg, chain_keys, pos, grad, logp, dtype)
        if step_search:
            state = find_initial_step(cfg, model.logp_and_grad, state)
        return state, ok

    return init_fn


def chain_keys(seed: int, n_chains: int, device) -> torch.Tensor:
    """``fold_in(key(seed), i)`` for each chain ``i`` (``[C, 2]``)."""
    master = threefry.key(seed, device=device)
    return threefry.fold_in_data(
        master, torch.arange(n_chains, dtype=torch.int64, device=device)
    )


def init_chains(model: ModelDef, cfg: NutsConfig, seed: int, n_chains: int,
                init_mean, dtype, device="cpu", num_try_init: int = 100,
                step_search: bool = True, init_fn=None,
                mesh: Optional[ChainMesh] = None):
    """Initialize the chains; returns the batched state and a success flag.

    ``n_chains`` is the whole fleet's count; under a ``mesh`` the result is
    this rank's slice of it, from its slice of the fleet's keys, and the
    outlier screen's medians run over the gathered fleet."""
    if init_fn is None:
        init_fn = make_init_fn(model, cfg, dtype, num_try_init, step_search)
    keys = chain_keys(seed, n_chains, device)
    if mesh is not None:
        mesh = mesh.for_chains(n_chains)
        keys = shard_chains(keys, mesh)
    init_mean = torch.as_tensor(np.asarray(init_mean), dtype=dtype, device=device)
    states, ok = init_fn(keys, init_mean)
    if step_search and n_chains >= 8:
        # init-quality retry: redraw chains with a step size far below the
        # fleet's (a stiff position) or a logp far below the fleet's (far
        # from the typical set); same outlier statistic as rescue_trapped
        for round_ in range(2):
            ls = gather_chains(states.adapt_flt("log_step"), mesh).cpu().numpy()
            bad = ls < np.median(ls) - np.log(100.0)
            lp = gather_chains(states.logp, mesh).cpu().numpy()
            med = np.median(lp)
            mad = np.median(np.abs(lp - med))
            bad |= (med - lp) > 50.0 * (mad + 10.0)
            if not bad.any():
                break
            retry_keys = threefry.fold_in_data(keys, 1000 + round_)
            states2, ok2 = init_fn(retry_keys, init_mean)
            bad_t = torch.as_tensor(bad[local_rows(mesh, n_chains)], device=ok.device)
            states = tree_where(bad_t, states2, states)
            ok = torch.where(bad_t, ok2, ok)
    return states, ok


def fleet_depth_cap(cfg: NutsConfig, bufs, limit: int,
                    mesh: Optional[ChainMesh] = None) -> torch.Tensor:
    """Fleet-relative tree-depth cap from one warmup chunk's step counts
    (the whole fleet's, gathered under a ``mesh``).

    ``ceil(log2(factor * median steps/draw))`` clipped to ``[4, maxdepth]``,
    the median over the chunk's non-NaN step counts averaging the two middle
    values (``2**30`` where there is none), as ``jnp.nanmedian`` in the JAX
    package.  A 0-d int32 tensor on the buffers' device, computed there
    without a host round trip: the counts are sorted with NaN last and the
    middle ones gathered at indices taken from the device's count.
    """
    ns = gather_chains(bufs.scalars[:, :limit, SCALAR_SLOTS["n_steps"]], mesh).reshape(-1)
    s, _ = torch.sort(ns)  # NaN sorts last
    n = (~torch.isnan(ns)).sum().reshape(1)
    lo = torch.clamp((n - 1) // 2, min=0)
    med = 0.5 * (torch.gather(s, 0, lo) + torch.gather(s, 0, n // 2))
    med = torch.where((n > 0) & torch.isfinite(med), med,
                      torch.full_like(med, 2.0 ** 30)).reshape(())
    return torch.clamp(
        _ceil_log2(cfg.depth_cap_factor * torch.clamp(med, min=1.0)), 4, cfg.maxdepth
    )


def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(x))`` for positive x, exact at powers of two (via frexp)."""
    mantissa, exponent = torch.frexp(x)
    return torch.where(mantissa == 0.5, exponent - 1, exponent).to(torch.int32)


def rescue_trapped(states: NutsMachineState, chunk_start: int, limit: int,
                   sched: Schedule, mesh: Optional[ChainMesh] = None) -> NutsMachineState:
    """Teleport trapped chains onto the median-logp chain (early warmup).

    A chain whose logp sits ~1000 sigma below the fleet's at a tiny step
    size is locally self-consistent and globally dead; only the fleet can
    see it.  Its position, step size and mass matrix (the low-rank metric
    too) are replaced by the donor's; its own RNG stream decorrelates it
    again.  Under a ``mesh`` the statistics run over the gathered fleet's
    logp and the donor's rows come from the rank that holds it.
    """
    end = chunk_start + limit
    if not (end >= 32 and end * 4 <= sched.num_tune * 3):
        return states
    logp = gather_chains(states.logp, mesh)
    n_chains = logp.shape[0]
    med = _median(logp)
    mad = _median(torch.abs(logp - med))
    trapped = ((med - logp) > 50.0 * (mad + 10.0))[local_rows(mesh, n_chains)]
    donor = torch.argsort(logp, stable=True)[n_chains // 2]

    def teleport(leaf):
        # the donor's row by a device index: indexing by a 0-d tensor
        # would read it on the host
        return where(trapped, chain_row(leaf, donor, mesh).expand_as(leaf), leaf)

    # the adaptation state whole, as the JAX package's tree_map over `adapt`:
    # under flow adaptation the flow and its training window too
    names = ("vecs", "flts", "adapt_vecs", "adapt_flts", "lr_basis", "lr_log_eigs",
             *FLOW_FIELDS, *WINDOW_FIELDS)
    return states.replace(**{name: teleport(t) for name, t in states.tensors().items()
                             if name in names})


def update_low_rank(cfg: NutsConfig, states: NutsMachineState, bufs,
                    chunk_start: int, limit: int, sched: Schedule) -> NutsMachineState:
    """The low-rank metric's update at a chunk's end.

    Each chain's metric is re-estimated from the chunk's valid draws
    (``row < limit`` and not divergent) and gradients with its current
    inverse mass, and replaced where the update is due: the chunk ends
    after the early phase and no later than the freeze, with at least 8
    valid draws.  The JAX package computes the estimate for every chunk and
    keeps the old metric where it is not due; here a chunk whose end rules
    the update out for every chain skips the estimate, which changes
    nothing.
    """
    end = chunk_start + limit
    if cfg.low_rank is None or not (sched.early_end < end <= sched.freeze_start):
        return states
    lr = cfg.low_rank
    rows = torch.arange(bufs.position.shape[1], device=bufs.position.device)
    valid = (rows[None, :] < limit) & ~bufs.diverging
    new = estimate_low_rank(bufs.position, bufs.gradient, valid, states.inv_mass,
                            lr.max_rank, lr.eigval_cutoff, lr.gamma)
    due = valid.sum(dim=1) >= 8
    return states.replace(lr_basis=where(due, new.basis, states.lr_basis),
                          lr_log_eigs=where(due, new.log_eigs, states.lr_log_eigs))


def flow_chunk_end(cfg: NutsConfig, model: ModelDef, states: NutsMachineState, bufs,
                   chunk_flow, chunk_start: int, limit: int, sched: Schedule,
                   train: bool):
    """Flow adaptation's chunk boundary, after the rescue
    (``nutpie_tpu/sampler/run.py:477-549``).

    Each draw's Fisher distance ``mean((z + grad_z)^2)`` goes into its
    scalars slot, from the committed base-space rows (the JAX machine step
    computes it at the commit from the same rows).  With
    ``store_transformed`` the base-space rows become the
    ``transformed_position`` / ``transformed_gradient`` buffers and the
    chunk flow's mu ``transformation_mu``.  Where ``train`` (warmup
    chunks), ``state.flow_boundary`` trains each chain's flow on the
    chunk's valid rows (with ``use_orbit`` the orbit rows after them) and
    re-bases the chain.  Last, the chunk's draws go to model space through
    ``chunk_flow``, the flow that drew them: ``x = F(z)``, logp ``logp_z -
    logdet``, the gradient pushed through the flow.  (The JAX package
    converts through the flow after the rescue, which for a trapped chain
    is the donor's: ROADMAP.md queue 3 lists that fault of the reference.)
    """
    fcfg = cfg.flow
    slots = SCALAR_SLOTS
    scalars = bufs.scalars.clone()
    scalars[..., slots["fisher_distance"]] = torch.mean(
        torch.square(bufs.position + bufs.gradient), dim=-1)
    bufs = bufs._replace(scalars=scalars)
    if cfg.store_transformed:
        C, L, dim = bufs.position.shape
        bufs = bufs._replace(
            transformed_position=bufs.position, transformed_gradient=bufs.gradient,
            transformation_mu=chunk_flow.mu[:, None, :].expand(C, L, dim).contiguous())
    orbit = (bufs.orbit_position, bufs.orbit_gradient) if fcfg.use_orbit else None
    out = flow_boundary(fcfg, model.logp_and_grad, states, chunk_flow, bufs.position,
                        bufs.gradient, bufs.diverging, limit, chunk_start < sched.num_tune,
                        train=train, orbit=orbit)
    if train:
        states = state_with(states.replace(**out.fields), position=out.position,
                            gradient=out.gradient, logp=out.logp)
    scalars = bufs.scalars.clone()
    scalars[..., slots["logp"]] = scalars[..., slots["logp"]] + (-out.logdets)
    return states, bufs._replace(position=out.xs, scalars=scalars, gradient=out.grads_x)


def draw_randoms(keys: torch.Tensor, chunk_start: int, chunk_len: int,
                 dim: int, dtype):
    """Per-draw momentum normals ``[C, L, dim]`` and jitter uniforms ``[C, L]``.

    ``normal(fold_in(fold_in(key, 1), d), (dim,))`` and
    ``uniform(fold_in(fold_in(key, 2), d), ())`` for absolute draw index d.
    """
    draw_ids = chunk_start + torch.arange(chunk_len, dtype=torch.int64,
                                          device=keys.device)
    mom_keys = threefry.fold_in_data(
        threefry.fold_in_data(keys, 1)[:, None, :], draw_ids[None, :]
    )
    jit_keys = threefry.fold_in_data(
        threefry.fold_in_data(keys, 2)[:, None, :], draw_ids[None, :]
    )
    return (
        threefry.normal(mom_keys, (dim,), dtype),
        threefry.uniform(jit_keys, (), dtype),
    )


def pool_chunk_start(states: NutsMachineState, pool_mass_matrix: bool,
                     pool_step_size: bool, mesh: Optional[ChainMesh] = None
                     ) -> NutsMachineState:
    """Cross-chain pooling of the adaptation state at a chunk's start, a
    chunk-boundary collective outside the kernels: over the gathered
    fleet's rows under a ``mesh``, this rank's rows kept."""
    if not (pool_mass_matrix or pool_step_size):
        return states
    adapt_vecs, adapt_flts = pool_adapt_state(
        gather_chains(states.adapt_vecs, mesh), gather_chains(states.adapt_flts, mesh),
        pool_mass=pool_mass_matrix, pool_step=pool_step_size,
    )
    rows = local_rows(mesh, adapt_vecs.shape[0])
    return states.replace(adapt_vecs=adapt_vecs[rows], adapt_flts=adapt_flts[rows])


class StepChunkRunner:
    """``run_chunk(states, chunk_start, limit, sched) -> (states, bufs)``.

    Per chunk, in the order of ``nutpie_tpu/sampler/run.py:make_chunk_runner``:
    pooling at the chunk's start, the per-draw randoms, ``start_draw``,
    then machine steps until every chain has produced ``limit`` draws, then
    the trapped-chain rescue after warmup chunks and the low-rank metric's
    update (``update_low_rank``).  The step kernel's ``begin`` takes the
    chunk's first step up to the log density; each machine step is then one
    ``model.logp_and_grad`` over all chains and the kernel's ``advance``
    (the step's second half and the next step's first), the same arithmetic
    in the same order as the plain halves.  A done chain is fully masked, so
    stepping past the last chain's end is a no-op, and the loop reads "all
    done" only every ``unroll`` steps.

    On the card those ``unroll`` machine steps, the log density with its
    autograd and the ``advance`` launch, are captured once per chunk in a
    CUDA graph (``StepGraph``; the run's graphs share one memory pool) and
    replayed until every chain is done.  The capture is the card's path:
    a log density that cannot be captured (one that syncs with the host,
    or copies host data to the device after its first call) raises.  A
    model marked ``eager_logp`` (its log density decides on the device
    when to stop, as a Stan program's ODE solver does) takes the eager
    route instead, decided before anything runs: the same K2 launches,
    with the log density called between them, under flow adaptation too
    (the pulled-back log density calls the model's eagerly, and the flow's
    training at the chunk's end never calls the model).  ``plain=True``
    runs the kernel's plain version, step by step, on any device (the
    comparisons on the card use it).
    """

    def __init__(self, model: ModelDef, cfg: NutsConfig, chunk_len: int, dtype,
                 pool_mass_matrix: bool = False, unroll=None,
                 adapt_frozen: bool = False, pool_step_size: bool = False,
                 plain: bool = False, mesh: Optional[ChainMesh] = None):
        self.model = model
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.dtype = dtype
        self.pool_mass_matrix = pool_mass_matrix
        self.unroll = unroll
        self.adapt_frozen = adapt_frozen
        self.pool_step_size = pool_step_size
        self.plain = plain
        self.mesh = mesh
        # the memory pool of the run's graphs, kept by its last graph
        self._pool = self._graph = None

    def __call__(self, states: NutsMachineState, chunk_start: int, limit: int,
                 sched: Schedule):
        cfg = self.cfg
        chunk_start, limit = int(chunk_start), int(limit)
        states = pool_chunk_start(states, self.pool_mass_matrix, self.pool_step_size,
                                  self.mesh)
        n_chains, _, dim = states.vecs.shape
        mom, jit = draw_randoms(states.key, chunk_start, self.chunk_len, dim, self.dtype)
        bufs = init_buffers(self.chunk_len, dim, self.dtype, n_chains,
                            device=states.vecs.device, cfg=cfg)
        # every chain begins the chunk at a draw boundary; the copy is the
        # chunk's own, which the kernel updates in place
        states = start_draw(cfg, sched, state_with(states, done=False),
                            mom[:, 0], jit[:, 0]).clone()
        chunk_flow = flow_params(states)
        logp_and_grad = pulled_back(cfg.flow, self.model.logp_and_grad, chunk_flow)
        args = (cfg, sched, chunk_start, limit, states, mom, jit, bufs,
                self.adapt_frozen)
        steps = PlainSteps(*args) if self.plain else step_kernel.chunk(*args)
        unroll = self.unroll or (CUDA_UNROLL if states.vecs.is_cuda else 1)
        z_new, carry = steps.begin(states)
        if isinstance(steps, KernelSteps) and not self.model.eager_logp:
            graph = self._capture(steps, states, z_new, unroll, logp_and_grad)
            while True:
                graph.replay()
                if bool(states.done.all()):
                    break
        else:
            while True:
                for _ in range(unroll):
                    logp, grad = logp_and_grad(z_new)
                    states, z_new, carry = steps.advance(states, z_new, carry, logp, grad)
                if bool(states.done.all()):
                    break
        if not self.adapt_frozen:
            states = rescue_trapped(states, chunk_start, limit, sched, self.mesh)
        states = update_low_rank(cfg, states, bufs, chunk_start, limit, sched)
        if cfg.flow is not None:
            states, bufs = flow_chunk_end(cfg, self.model, states, bufs, chunk_flow,
                                          chunk_start, limit, sched,
                                          train=not self.adapt_frozen)
        return states, bufs

    def _capture(self, steps: KernelSteps, states: NutsMachineState, z_new,
                 unroll: int, logp_and_grad) -> StepGraph:
        """``unroll`` machine steps of this chunk in a CUDA graph; the log
        density runs once first on a side stream (torch's warm-up before a
        capture), which also builds its per-device constants."""
        t0 = time.perf_counter()
        device = states.vecs.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            logp_and_grad(z_new)
        torch.cuda.current_stream(device).wait_stream(side)

        def machine_steps():
            z = z_new
            for _ in range(unroll):
                logp, grad = logp_and_grad(z)
                _, z, _ = steps.advance(states, z, None, logp, grad)

        graph = StepGraph(step_kernel, device)
        try:
            graph.capture(machine_steps, self._pool)
        except Exception as err:
            name = getattr(self.model.logp_fn, "__qualname__", repr(self.model.logp_fn))
            raise RuntimeError(
                f"the log density {name} cannot be captured in a CUDA graph, which "
                f"the step runner on the card replays: {err}.  A captured log density "
                "keeps its constants on the device (built once per device and dtype), "
                "makes no host sync and copies no host data to the device after its "
                "first call") from err
        self._pool, self._graph = graph.graph.pool(), graph
        step_kernel.capture_s += time.perf_counter() - t0
        return graph


def make_chunk_runner(model: ModelDef, cfg: NutsConfig, chunk_len: int, dtype,
                      pool_mass_matrix: bool = False, unroll=None,
                      adapt_frozen: bool = False, pool_step_size: bool = False,
                      plain: bool = False, mesh: Optional[ChainMesh] = None
                      ) -> StepChunkRunner:
    """Build the step runner (the JAX function's call semantics; its
    ``flow_train`` is ``not adapt_frozen``).  ``unroll=None`` captures ``CUDA_UNROLL`` machine steps a
    graph on the card and checks for the chunk's end every step on the
    CPU.  ``mesh``: the ranks the fleet is split over (pooling and the
    rescue gather through it)."""
    return StepChunkRunner(model, cfg, chunk_len, dtype,
                           pool_mass_matrix=pool_mass_matrix, unroll=unroll,
                           adapt_frozen=adapt_frozen, pool_step_size=pool_step_size,
                           plain=plain, mesh=mesh)
