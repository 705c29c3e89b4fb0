#!/usr/bin/env python3
"""Quickest proof that the torch port runs on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one JSON line):

1. ``build``: torch version, the card's name and power limit, and the
   build of the chunk kernel (``nutpie_tpu_torch/csrc/megakernel.cu``) and
   the step kernel (``csrc/step_kernel.cu``) from the sources in the
   checkout with ``nvcc``, one process each, together; their registers
   and spill bytes (any spill of either in either dtype fails), and the
   step kernel's low-rank plan at the low-rank path's shapes in both
   dtypes, whose shared memory must be what the kernel lays out.
2. ``parity``: the kernel against its plain torch version on the card, on
   radon at full width (173 parameters, 919 observations), 64 chains:
   one fresh warmup chunk of 8 draws in float64 (ints, step counts and
   Welford counts exact; positions to rtol 1e-3), one frozen chunk of 8
   draws from the state that follows (ints exact; floats to rtol 1e-6,
   atol 1e-8), and one fresh float32 warmup chunk (finite; shares of equal
   step counts and of close draws above their limits).
3. ``main``: ``sample()`` on radon, 2048 chains x (300 tune + 300 draws),
   pooled mass matrix and step size, on CUDA in float32, with the kernel's
   launch count set to 0 just before and read just after: every chunk must
   have gone through the kernel.  Prints wall time, gradients/s, the
   minimum bulk ESS over the benchmark's monitored columns, min-ESS/s and
   posterior divergences.
4. ``warmup``: the kernel against its plain version at the main path's
   shapes (2048 chains, [2048, 128] buffers) in windows on the warmup's
   events (``WINDOWS``: a fresh fleet's first draws, the mass-matrix
   switches, the step-size freeze at draw 270, the end of tuning), while
   the kernel carries the fleet through the main path's warmup chunks
   with pooling, rescue and the fleet depth cap between them as in
   ``sample()``.  Float64 from a fresh fleet, windows of up to 8 draws:
   ints, step counts and Welford counts exact, positions and adaptation
   state to rtol 1e-3.  Float32 from another fresh fleet, windows of 4
   draws: finite draws and adaptation state, and per window the shares of
   equal step counts and of close draws and the fleet's step size within
   ``F32_WARM_BARS``.
5. ``timing``: the kernel and its plain version on one posterior chunk at
   the main path's shapes (2048 chains, 128 draws, float32, the state the
   float32 warmup left), timed with CUDA events, beside the least time the
   card could take for the same work: operations counted from the
   kernel's code for this chunk's trees over 67 TFLOP/s float32, bytes
   over 3.35 TB/s.  The two are held against each other at these shapes:
   in float32, at least 99.9% of the step counts equal and 99% of the
   draws within 1e-3 (relative to 1 + |x|); from the same state in
   float64, ints exact and floats to rtol 1e-6 / atol 1e-8.
6. ``profile``: the main path once more under ``torch.profiler``: device
   time by kernel and the device's idle share of the wall time; then the
   GLM path (below) at full width with tune and draws cut to
   ``GLM_PROFILE_TUNE`` + ``GLM_PROFILE_DRAWS``: device time split into the
   step kernel, the log density's matrix products and other work, and
   the idle share.

The generic card path (the step kernel K2, ``csrc/step_kernel.cu``: one
``advance`` launch per machine step after one batched torch logp, and
one ``begin`` launch per chunk; the step runner replays its machine steps
from a CUDA graph) at the logistic GLM's width from ``bench_glm.py``
(10,240 chains, 64 coefficients, 2048 observations, chunk 32):

7. ``step_parity``: K2 (its ``begin`` and ``advance``) against its plain
   version (``leapfrog_begin``, and ``leapfrog_finish`` then
   ``leapfrog_begin``) on the card, both running the same torch logp.
   Float64 at full width, 64 chains: one
   fresh 8-draw warmup window from draw 0 (ints, step counts and Welford
   counts exact, positions and adaptation state to rtol 1e-3), then a
   16-draw frozen chunk (ints exact, floats to rtol 1e-6 / atol 1e-8).
   Float64 ``ill_conditioned_gaussian(dim=1000)``, 16 chains, an 8-draw
   frozen chunk: ints and step counts exact (lanes stride past 256
   coordinates).  Float64 eight schools, 16 chains, in each of four
   settings with branches of their own (``SETTINGS``: step size jitter,
   ``mindepth`` 3, no U-turn check, the draw-based mass matrix): an
   8-draw warmup window and an 8-draw frozen chunk at those bars.  Beside
   the GLM readings, the plain version on the CPU
   against the card's from the same state: how far two plain versions
   that round differently part over the same draws.  Float32 at the main shapes, from a fleet the step
   runner warmed through the 300 tuning draws: one frozen 32-draw chunk,
   at least 99.9% of step counts equal and 99% of draws within 1e-3
   (relative to 1 + abs x); and the same chunk's graph replays bitwise
   equal to its launches made one by one.
8. ``glm``: ``sample()`` on the GLM, 10,240 chains x (300 tune + 300
   draws), chunk 32, seed 42, float32, default settings, no pooling, with
   both kernels' launch counts set to 0 just before: K2 launched once per
   chunk and once per machine step (the steps counted from the draws'
   step counts, rounded up to the graph's ``CUDA_UNROLL`` steps per chunk),
   its graph replays and capture seconds printed, and K1
   not at all.  Draws finite, max split R-hat over ``bench_glm.py``'s
   monitored columns below 1.05, every posterior mean within
   ``LAPLACE_SD_TOL`` posterior sd of the mode of a numpy Laplace
   approximation of the same data and within ``IMPORTANCE_SD_TOL`` of
   the posterior mean by importance sampling from that approximation.  Prints wall, gradients/s, min bulk-ESS, ESS/s, min-ESS per
   gradient, posterior divergences and the host wall per machine step.
9. ``step_timing``: one frozen 32-draw chunk at the GLM main shapes, step
   by step, launched one by one: K2's ``advance`` and the logp+grad call
   by CUDA events around each call (and by device time under
   ``torch.profiler``, which splits the logp's matrix products from the
   rest), the plain ``advance`` (finish then begin) by CUDA events, the
   byte bound beside them (``step_bytes``: each row the fused launch
   touches read once and written once) and the diagonal plan with its
   resident chains an SM; then the whole chunk through the runner's
   CUDA graphs at ``unroll`` 1, 4, 8 and 16 (host wall, and the machine
   steps each ran).  Then the
   same for K2's low-rank branch at the low-rank path's shapes (below):
   one frozen 16-draw chunk of the float32 parity fleet, K2 with R = 32
   and with R = 0 (the same fleet without its metric), the logp+grad
   call by CUDA events (and over the first ``LR_DEVICE_STEPS`` steps by
   device time under ``torch.profiler``, reported beside them), the plain
   ``advance`` over its first ``LR_PLAIN_STEPS`` steps, the
   byte bound with each machine step reading the chain's basis once, the basis
   bytes as the plan's form reads them, the plan (form, warps, shared
   memory) and the library yardstick of the metric part (two
   ``torch.bmm`` per application for every chain, times the applications
   a step).

K2's low-rank branch (``adaptation="low_rank"``) on the 1000-d
ill-conditioned Gaussian (``nutpie_tpu/models/analytic.py:166``,
BASELINE's 1000-d target) at 1024 chains, max_rank 32, chunk 80:

10. ``lowrank_parity``: K2 against its plain halves on the card.  Float64,
    16 chains, metrics from the port's ``estimate_low_rank`` on each
    chain's window of exact posterior draws and gradients, one case for
    each form of ``step_kernel.low_rank_plan`` (``LR_F64_CASES``): the
    path's shapes (dim 1000, R 32, 256,000 bytes a basis: streamed) with a
    cutoff that keeps all 32 slots and with the default 100, under which
    this target keeps none (the branch's arithmetic on an all-padded
    metric); dim 500, R 32 (staged by TMA); dim 33, R 5 with two slots
    padded (660 bytes a basis, not 16-byte aligned: staged by loads).  Each
    runs a warmup window from draw 0 (8 draws; 4 for the last two, whose
    trees stop at depth 6; ints, step counts and Welford counts exact,
    floats to 1e-3), then a frozen chunk (16 draws; 8 for the last two)
    (ints exact, floats and the stored gradients to rtol 1e-6 / atol
    1e-8).  Float32 at the main shapes, one frozen 16-draw chunk: at least
    99.9% of step counts equal and 99% of draws within 1e-3 (relative to 1
    + abs x).
11. ``lowrank``: ``sample(adaptation="low_rank")``, 1024 chains x (300
    tune + ``LR_DRAWS`` draws), float32, seed 42, default settings but the
    eigenvalue cutoff ``LR_CUTOFF`` (see there): K2 launched once per
    chunk and once per machine step, its graph replays and capture
    seconds printed, every chunk with R = 32, K1 never; the
    boundary updates at draws 160 and 240 (timed with a synchronize on
    each side), after which at least 90% of chains keep a slot; max split
    R-hat over ``LR_MONITORED`` below 1.05; each monitored column's
    variance, and the variance along the covariance's largest and
    smallest eigenvectors, within ``LR_VAR_BAND`` of the truth.  Prints
    wall, gradients/s, leapfrogs per draw, min bulk-ESS, ESS/s, min-ESS
    per gradient, posterior divergences and the host wall per machine
    step.  The profile phase runs this
    path once more with tune and draws cut to ``LR_PROFILE_TUNE`` +
    ``LR_PROFILE_DRAWS`` and the switch cadence to ``LR_PROFILE_SWITCH``
    (boundary updates at draws 2, 4 and 6): K2, the matrix products,
    the boundary's QR and eigendecompositions, copies and idle.

The options path (every NUTS step-size and depth option and the
divergence rows on the card):

12. ``options_parity``: each kernel against its plain version with the
    options on, float64, 16 chains, maxdepth 6, an 8-draw warmup window then an 8-draw
    frozen chunk at the parity bars: K1 on radon under Adam, a fixed step,
    a target integration time with an extra doubling, and the four
    settings of ``SETTINGS``; K2 on the GLM under Adam, a fixed step and a
    target time, on the centered eight schools with the divergence rows
    (their four buffers held too, and finite exactly where a draw
    diverged) under the diagonal and the low-rank metric, and under the
    low-rank metric with Adam.  Float32 at the
    GLM's main shapes with the divergence rows: one frozen 32-draw chunk
    at the float32 share bars.  K2's advance a step on that chunk with and
    without the rows, and K1's posterior chunk under Adam's configuration
    beside the default's, by CUDA events.
13. ``options``: ``sample()`` at full width: radon with Adam through K1
    (2048 chains x (300 + 300), the main phase's configuration; K1
    launched once a chunk; its readings beside the main phase's; as in
    the JAX package, Adam's step collapses on radon in warmup, to below a
    tenth of dual averaging's, which is held, and the posterior's R-hat
    is read); radon with the fixed step ``RADON_FIXED_EPS``, a target
    integration time of ``RADON_TARGET_STEPS`` steps, one extra doubling
    and no U-turn check, through K1: every posterior draw that did not
    diverge has depth 4 and 15 leapfrogs (1 + 2 + 4 + 8; the divergent
    ones are counted); the GLM at ``bench_glm.py``'s width with the divergence
    rows through K2 (10,240 chains x (300 + ``GLM_DIV_DRAWS``)): K2
    launched once a chunk and once a machine step, the four statistics of
    shape [chains, draws, 64], finite exactly where a draw diverged (warmup
    included), and the glm phase's posterior bars.

Every phase that reads split R-hat and bulk ESS (``column_diagnostics``)
also computes them on the card with ``diagnostics_device`` and holds
them to the host's to rtol ``DIAG_RTOL``.

Then the script's seconds, the kernels line (K1, and K2 with its
low-rank branch), the card line, and the last line

``{"ok": true, "device": {...}}``.  Every phase runs even after one
fails; any failed phase makes the script exit non-zero with no result
line, and so does ``--phases`` with fewer than all phases.  Without CUDA, or without the package beside it, the
script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# the main path's sizes (bench.py's radon configuration, draws cut to 300)
CHAINS, TUNE, DRAWS, CHUNK = 2048, 300, 300, 128
# 8 draws a parity chunk keep the whole run near ten minutes
PARITY_CHAINS, PARITY_CHUNK = 64, 8
# a chain count that divides neither the chains per block nor the card's
# resident chain slots, so the chain queue runs dry part-way through blocks
RAGGED_CHAINS = 61
# published peaks of one H100 SXM (dense, no tensor cores for float32)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# operations per coordinate, counted from csrc/machine_step.cuh (adds,
# multiplies, divides, exps, logs, square roots; compares and selects are
# not counted): every leapfrog (p_half 2, z_new 3, p_new 2, v_new 1,
# kinetic energy 2, rho_sub + p 1, rho + rho_sub 1), every checkpoint
# slot of a subtree U-turn check (rho difference 1, two dots with one mass
# product 5), every merged subtree's trajectory checks (three mass
# products, two sums, six dots), and every draw's momentum (sqrt, divide,
# kinetic energy 3)
OPS_LEAPFROG_PER_COORD = 12
OPS_SUBTREE_CHECK_PER_COORD = 6
OPS_MERGE_PER_COORD = 17
OPS_START_DRAW_PER_COORD = 5
# the scalars of each leapfrog (counted once, though every lane of the
# chain's warp computes them): energy error, acceptance, the multinomial
# and biased-progressive choices with their logaddexp
OPS_LEAF_SCALAR = 18
# benchmark's monitored columns: intercept, both log-sds, log-sigma and a
# spread of county effects
MONITORED = [0, 85, 86, 171, 172] + list(range(1, 85, 6))
# float32 kernel against its plain version: the share of draws with equal
# step counts, and of draws whose every coordinate is within
# F32_TOL * (1 + |x|).  A rounding difference can flip one tree decision,
# after which that chain's draws part ways (and, while tuning, so do its
# step size and mass matrix), so the float32 bar is a share of the draws.
F32_TOL = 1e-3
F32_MIN_SHARE_STEPS = 0.999
F32_MIN_SHARE_DRAWS = 0.99
# float32 bars in the warmup windows: least share of equal step counts,
# least share of close draws, largest per-draw difference of the fleet's
# mean log step size.  The per-draw adaptation carries float32 rounding
# past 1e-3 within a few draws for a few percent of the chains, and within
# two draws for many in a fresh fleet, whose positions are not held
# (PERF.md, Findings).  A wrong switch or freeze moves every chain's step size.
F32_WARM_BARS = {"early": (0.9, 0.0, 1e-2), "late": (0.999, 0.9, 1e-3)}
# warmup windows (first draw, draws) in which the kernel is held against
# its plain version at the main path's shapes: the first draws of a fresh
# fleet, the early switch at draw 89 with the end of the early phase at 90,
# the switches at 159 and 239, the step-size freeze at 270 and the end of
# tuning at 299.  The per-draw adaptation feeds every rounding difference
# back into the step size and mass matrix, so over a long stretch even two
# plain versions part ways (PERF.md, Findings); over 2048 chains float64 stays
# within 1e-3 for about 8 draws (4 at a fresh start), float32 for about 4.
WINDOWS = {
    "float64": ((0, 4), (84, 8), (154, 8), (234, 8), (266, 8), (292, 8)),
    "float32": ((0, 4), (87, 4), (156, 4), (236, 4), (268, 4), (296, 4)),
}
EARLY_END = 90
# the GLM path (bench_glm.py:17-22; its 700 draws cut to 300) and its
# monitored columns (bench_glm.py:68)
GLM_CHAINS, GLM_TUNE, GLM_DRAWS, GLM_CHUNK = 10240, 300, 300, 32
GLM_N_DATA, GLM_DIM = 2048, 64
GLM_MONITORED = list(range(0, GLM_DIM, max(1, GLM_DIM // 24)))
# the GLM profile's cut of tune and draws (the trace of every launch of the
# whole path would be too large, and the profiler's processing grows with
# its events: 64 + 64 until the low-rank path joined the script)
GLM_PROFILE_TUNE, GLM_PROFILE_DRAWS = 32, 32
STEP_PARITY_CHAINS, ILL_DIM, ILL_CHAINS = 64, 1000, 16
# posterior means of the GLM against the Laplace approximation, in
# posterior sd: catches a wrong gradient, not a subtle bias
LAPLACE_SD_TOL = 0.25
# ... and against the posterior mean by importance sampling from the
# Laplace approximation (20,000 draws, effective size about 12,000, so
# about 0.01 sd of Monte Carlo error): the mean and the mode of this
# posterior differ by up to 0.24 sd, its skew
IMPORTANCE_SD_TOL = 0.05
UNROLLS = (1, 4, 8, 16)
# the card's diagnostics (diagnostics_device) against the host's, float64
DIAG_RTOL = 1e-6
# where the GLM path runs
DEVICE = "cuda"
# the low-rank path: the 1000-d ill-conditioned Gaussian
# (nutpie_tpu/models/analytic.py:166, BASELINE's "1000-d ill-conditioned
# Gaussian"; condition 1e4, a random rotation) under adaptation="low_rank"
# at 1024 chains, float32, chunk 80 (the low-rank rule: the switch
# cadence), max_rank 32; its monitored columns, and the band each
# column's variance (and the variance along the covariance's largest and
# smallest eigenvectors) must fall in, relative to the truth
# draws cut from 200 to 40: every tree of this target runs to the depth
# cap (about 500 leapfrogs a draw), and 300 + 200 draws took 234 s on an
# H100 80GB HBM3 at 700 W
LR_DIM, LR_CHAINS, LR_TUNE, LR_DRAWS, LR_CHUNK, LR_RANK = 1000, 1024, 300, 40, 80, 32
LR_MONITORED = list(range(0, LR_DIM, 16))
LR_VAR_BAND = (0.8, 1.25)
# the main path's eigenvalue cutoff: at the default 100 the gradient-based
# diagonal already brings every direction of this target within a factor
# of 100 (the standardized spectrum spans about 0.01-104), so the estimator
# keeps no slot and the branch would run on an all-padded metric; 3.0 is
# the JAX package's own low-rank sampling test's setting
LR_CUTOFF = 3.0
# the low-rank parity fleets: float64 at 16 chains, float32 at the main
# shapes; each starts from posterior draws with the metric the port's
# estimator gives on a window of LR_WINDOW posterior draws and gradients
# (cutoff LR_CUTOFF_ALL keeps all 32 slots, the default 100 pads some)
LR_PARITY_CHAINS, LR_WINDOW, LR_CUTOFF_ALL = 16, 80, 1.0 + 1e-6
# the float64 parity cases (tag, dim, rank, cutoff, slots padded after the
# estimate, maxdepth (None: the default), draws of the warmup window and of
# the frozen chunk) and the form each takes on an H100 (low_rank_plan): the
# path's shapes, whose 256,000-byte basis streams, with every slot kept and
# at the default cutoff (every slot padded); dim 500, staged by TMA; dim 33
# at rank 5, whose 660-byte bases are not 16-byte aligned and stage by
# loads, with two slots padded.  The last two keep the script's time: their
# trees stop at depth 6 (every code path of the step still runs: checks,
# merges, draws ended by a U-turn and by the depth limit) over 4 + 8 draws
LR_F64_CASES = (
    ("all_slots", LR_DIM, LR_RANK, LR_CUTOFF_ALL, 0, None, (8, 16)),
    ("default_cutoff", LR_DIM, LR_RANK, 100.0, 0, None, (8, 16)),
    ("dim500", 500, LR_RANK, LR_CUTOFF_ALL, 0, 6, (4, 8)),
    ("dim33_rank5", 33, 5, LR_CUTOFF_ALL, 2, 6, (4, 8)),
)
LR_F32_CHUNK = 16
# plain machine steps timed at the low-rank shapes (each is a few ms), and
# the kernel's steps timed by device time under the profiler (reported
# beside the CUDA-event times the kernels line and its share of bound use)
LR_PLAIN_STEPS = 64
LR_DEVICE_STEPS = 128
# the low-rank profile's cut: tune, draws and the switch cadence (so the
# chunk length), which put boundary updates at draws 2, 4 and 6.  A tree of
# this target runs to the depth cap, hundreds of machine steps a draw, and
# the profiler's processing grows with the events: 32 draws took 8.5
# minutes on top of the run
LR_PROFILE_TUNE, LR_PROFILE_DRAWS, LR_PROFILE_SWITCH = 6, 2, 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def radon_ops_per_grad(n_obs: int, n_c: int) -> int:
    """Operations of one radon logp + gradient, line by line from csrc/radon.cuh."""
    k = n_c - 1
    effects = 2 * (2 * n_c * k)             # county_raw, cf_raw: basis @ z
    observations = 12 * n_obs               # mu 5, residual 2, r^2 2, ac 1, bc 2
    counties = 10 * n_c                     # two effects, two divides, four sums
    zero_sum_grad = 2 * (2 * k * n_c) + 3 * 2 * k   # basis^T (A, B), -z + acc * sd
    squares = 2 * 2 * k                     # |county_raw_z|^2, |county_floor_raw_z|^2
    scalars = 55                            # three exps, logp, five gradients
    return effects + observations + counties + zero_sum_grad + squares + scalars


def chunk_ops(scalars, limit: int, dim: int, n_obs: int, n_c: int) -> dict:
    """Operations this chunk's trees needed, from each draw's depth and steps.

    Subtrees before a draw's last one are full (a doubling needs a valid
    merge), and a subtree of n leaves checks the n - popcount(n) checkpoint
    slots its even leaves pop, so a draw of depth d and n steps made
    n - (d - 1) - popcount(n_last) slot checks, n_last = n - 2^(d-1) + 1.
    Merges count the d - 1 doublings; a draw's last merge is left out.
    """
    import numpy as np

    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    s = scalars[:, :limit].double().cpu().numpy()
    n = s[..., SCALAR_SLOTS["n_steps"]].astype(np.int64).reshape(-1)
    d = s[..., SCALAR_SLOTS["depth"]].astype(np.int64).reshape(-1)
    n_last = n - (2 ** (d - 1) - 1)
    assert (d >= 1).all() and (n_last >= 1).all() and (n_last <= 2 ** (d - 1)).all(), \
        "step counts and depths disagree"
    popcount = sum((n_last >> b) & 1 for b in range(32))
    leapfrogs = int(n.sum())
    checks = int((n - (d - 1) - popcount).sum())
    merges = int((d - 1).sum())
    draws = int(n.size)
    ops = (leapfrogs * (radon_ops_per_grad(n_obs, n_c) + OPS_LEAF_SCALAR
                        + OPS_LEAPFROG_PER_COORD * dim)
           + checks * OPS_SUBTREE_CHECK_PER_COORD * dim
           + merges * OPS_MERGE_PER_COORD * dim
           + draws * OPS_START_DRAW_PER_COORD * dim)
    return {"ops": ops, "leapfrogs": leapfrogs, "subtree_checks": checks,
            "merges": merges, "draws": draws}


def chunk_bytes(n_chains: int, chunk_len: int, dim: int, depth_slots: int,
                itemsize: int, data_bytes: int) -> int:
    """Bytes a chunk must move: state in and out, randoms in, draws out."""
    state = ((14 + 2 * depth_slots + 9) * dim + 12 + 12) * itemsize + 15 * 4 + 16
    randoms = chunk_len * (dim + 1) * itemsize
    outputs = chunk_len * (dim + 12) * itemsize
    return n_chains * (2 * state + randoms + outputs) + data_bytes


def max_rel(a, b) -> float:
    """Largest difference relative to the largest magnitude of ``b``."""
    import torch

    a, b = a.double(), b.double()
    m = torch.isfinite(a) & torch.isfinite(b)
    if not bool(m.any()):
        return 0.0
    return float((a[m] - b[m]).abs().max() / b[m].abs().max().clamp(min=1e-30))


def nan_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and bool(
        torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    )


def assert_close(name, a, b, rtol, atol):
    import torch

    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError(f"{name}: NaN patterns differ")
    m = ~torch.isnan(a)
    torch.testing.assert_close(a[m], b[m], rtol=rtol, atol=atol, msg=lambda s: f"{name}: {s}")


def max_abs(a, b) -> float:
    return float((a - b).abs().nan_to_num(0).max())


def phase_build(ctx):
    import torch

    from nutpie_tpu_torch.ops import build
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import DIAG_FORM_TAGS, step_kernel

    t0 = time.perf_counter()
    libs = build.build_all(["megakernel", "step_kernel"])  # one nvcc each, together
    lib_path = libs["megakernel"]
    chunk_kernel.library()
    step_kernel.library()
    seconds = time.perf_counter() - t0
    ctx["card"] = card_line()
    # what was compiled, at the main path's configuration
    # (K1's Adam instantiations too: adapt.cuh, step_size_update)
    geometry = {}
    for dtype in (torch.float32, torch.float64):
        model, cfg, _, _ = _setup(0, dtype, 0)
        adam = dataclasses.replace(cfg, adapt=dataclasses.replace(cfg.adapt, method="adam"))
        name = str(dtype).removeprefix("torch.")
        for tag, c in ((name, cfg), (f"{name}_adam", adam)):
            geometry[tag] = chunk_kernel.geometry(_main_kernel_config(model, c), dtype,
                                                  torch.device("cuda"))
    ctx["geometry"] = geometry
    # K2's instantiations in both dtypes, with the low-rank plan of the
    # low-rank path's shapes (float32 stages the basis, float64 streams it)
    # and the diagonal plan of the GLM's, with the chains an SM holds
    k2, plans, diag = {}, {}, {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).removeprefix("torch.")
        k2[name] = step_kernel.geometry(dt, LR_CHAINS, LR_DIM, LR_RANK)
        plans[name] = dataclasses.asdict(step_kernel.plan(LR_CHAINS, LR_DIM, LR_RANK, dt, DEVICE))
        diag[name] = _diag_plan_reading(step_kernel, k2[name], GLM_CHAINS, GLM_DIM, dt)
    ctx["k2_geometry"], ctx["glm_plan"] = k2, diag
    emit({
        "phase": "build", "torch": torch.__version__,
        "cuda": torch.version.cuda, "card": ctx["card"],
        "kind": torch.cuda.get_device_name(0),
        "library": os.path.relpath(str(lib_path), ROOT),
        "build_seconds": round(seconds, 3),
        "geometry": geometry,
        "step_kernel": {
            "library": os.path.relpath(str(libs["step_kernel"]), ROOT),
            "geometry": k2,
            "low_rank_plan": plans,
            "glm_diag_plan": diag,
        },
    })
    for tag in ("float32", "float32_adam"):
        g32 = geometry[tag]
        assert g32["resident_chains_per_sm"] >= 10 and g32["local_bytes_per_thread"] == 0, g32
    for dt, geo in k2.items():
        assert all(v == 0 for k, v in geo.items() if k.endswith("local_bytes")), \
            f"the step kernel spills in {dt}: {geo}"
        # the plan's shared memory is what the kernel lays out, and fits
        assert geo["lr_smem_bytes"] == plans[dt]["smem_bytes"], (geo, plans[dt])
        assert geo["lr_blocks_per_sm"] >= 1, geo
        assert all(geo[f"{tag}_blocks_per_sm"] >= 1 for tag in DIAG_FORM_TAGS), geo


def _diag_plan_reading(kernel, geometry: dict, n_chains: int, dim: int, dtype) -> dict:
    """K2's diagonal plan at these shapes, the blocks its form an SM holds
    as compiled, the chains that makes resident an SM and the waves of the
    launch."""
    plan = kernel.diag_plan(n_chains, dim, dtype, DEVICE)
    tag = plan.form
    blocks = geometry[f"{tag}_blocks_per_sm"]
    sms = kernel.device_limits(DEVICE)["sm_count"]
    return {**dataclasses.asdict(plan),
            "registers": geometry[f"{tag}_registers"], "blocks_per_sm": blocks,
            "resident_chains_per_sm": blocks * plan.chains_per_block,
            "waves": -(-plan.grid // (blocks * sms))}


def _main_kernel_config(model, cfg):
    """The kernel's configuration at the main path's shapes."""
    from nutpie_tpu_torch.sampler.megakernel import kernel_config

    return kernel_config(cfg, model.kernel_model, CHAINS, model.ndim,
                         max(cfg.maxdepth, 2), CHUNK, True)


def _setup(n_chains, dtype, seed):
    import numpy as np

    from nutpie_tpu_torch.models import radon
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import NutsConfig
    from nutpie_tpu_torch.sampler.run import init_chains

    model = radon()
    cfg = NutsConfig(adapt=AdaptConfig(num_tune=TUNE))
    # the main path's static cap before the first fleet measurement
    sched = make_schedule(cfg.adapt, TUNE, cfg.initial_depth_cap)
    if n_chains == 0:
        return model, cfg, sched, None
    states, ok = init_chains(model, cfg, seed, n_chains, np.zeros(model.ndim),
                             dtype, device="cuda")
    assert bool(ok.all()), "chain initialization failed"
    return model, cfg, sched, states


def _run_both(model, cfg, sched, states, start, chunk_len, limit, frozen):
    """The kernel and its plain version on one chunk from the same state."""
    import torch

    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel, plain_chunk
    from nutpie_tpu_torch.sampler.run import draw_randoms

    mom, jit = draw_randoms(states.key, start, chunk_len, model.ndim, states.vecs.dtype)
    s_k, b_k = chunk_kernel(cfg, model, sched, start, limit, states, mom, jit, frozen)
    torch.cuda.synchronize()
    s_p, b_p = plain_chunk(cfg, model, sched, start, limit, states.clone(), mom, jit, frozen)
    torch.cuda.synchronize()
    return (s_k, b_k), (s_p, b_p)


def _check_warmup_f64(tag, limit, s_k, b_k, s_p, b_p) -> float:
    """Warmup chunk in float64: integer decisions and Welford counts exact.

    Floats to rtol 1e-3: adaptation feeds rounding differences back
    through the step size and mass matrix every draw.
    """
    import torch

    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS
    from nutpie_tpu_torch.sampler.state import ADAPT_FLT_SLOTS

    ns = SCALAR_SLOTS["n_steps"]
    assert torch.equal(s_k.ints, s_p.ints), f"{tag}: ints differ"
    assert nan_equal(b_k.scalars[:, :limit, ns], b_p.scalars[:, :limit, ns]), \
        f"{tag}: n_steps differ"
    for name in ("draws_cur_count", "grads_cur_count", "draws_bg_count", "grads_bg_count"):
        slot = ADAPT_FLT_SLOTS[name]
        assert torch.equal(s_k.adapt_flts[:, slot], s_p.adapt_flts[:, slot]), f"{tag}: {name}"
    for name, a, b in (("position", b_k.position[:, :limit], b_p.position[:, :limit]),
                       ("adapt_vecs", s_k.adapt_vecs, s_p.adapt_vecs),
                       ("adapt_flts", s_k.adapt_flts, s_p.adapt_flts)):
        assert_close(f"{tag}: {name}", a, b, 1e-3, 1e-3)
    return max_abs(b_k.position[:, :limit], b_p.position[:, :limit])


def _f32_shares(limit, s_k, b_k, b_p) -> dict:
    """Float32 kernel against plain: finite draws, shares that agree.

    The draws, the committed position and gradient and the adaptation
    state must be finite; the trajectory's edges and log weights may not
    be (a divergent leaf).
    """
    import torch

    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS
    from nutpie_tpu_torch.sampler.state import VEC_SLOTS

    ns = SCALAR_SLOTS["n_steps"]
    pk, pp = b_k.position[:, :limit], b_p.position[:, :limit]
    committed = s_k.vecs[:, [VEC_SLOTS["position"], VEC_SLOTS["gradient"]]]
    for name, t in (("position", pk), ("scalars", b_k.scalars[:, :limit]),
                    ("committed position and gradient", committed),
                    ("adapt_vecs", s_k.adapt_vecs), ("adapt_flts", s_k.adapt_flts)):
        assert bool(torch.isfinite(t).all()), f"float32 {name} not finite"
    steps = float((b_k.scalars[:, :limit, ns] == b_p.scalars[:, :limit, ns])
                  .double().mean())
    draws = float(((pk - pp).abs() <= F32_TOL * (1.0 + pp.abs())).all(-1).double().mean())
    return {"share_equal_n_steps": steps, "share_draws_within_tol": draws,
            "max_rel_diff_position": max_rel(pk, pp), **_fleet_diffs(limit, b_k, b_p)}


def _fleet_diffs(limit, b_k, b_p) -> dict:
    """Largest per-draw difference of the fleet's mean log step size and steps."""
    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    sk, sp = b_k.scalars[:, :limit].double(), b_p.scalars[:, :limit].double()
    eps, ns = SCALAR_SLOTS["step_size"], SCALAR_SLOTS["n_steps"]
    log_eps = (sk[..., eps].log().mean(0) - sp[..., eps].log().mean(0)).abs()
    steps = (sk[..., ns].mean(0) / sp[..., ns].mean(0) - 1.0).abs()
    return {"max_diff_fleet_log_step": float(log_eps.max()),
            "max_rel_diff_fleet_n_steps": float(steps.max())}


def _check_frozen_f64(tag, s_k, b_k, s_p, b_p) -> float:
    """Frozen chunk in float64: ints and step counts exact, floats to rtol
    1e-6 / atol 1e-8."""
    import torch

    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    ns = SCALAR_SLOTS["n_steps"]
    assert torch.equal(s_k.ints, s_p.ints), f"{tag}: ints differ"
    assert nan_equal(b_k.scalars[..., ns], b_p.scalars[..., ns]), f"{tag}: n_steps differ"
    for name, a, b in (("position", b_k.position, b_p.position),
                       ("scalars", b_k.scalars, b_p.scalars),
                       ("vecs", s_k.vecs, s_p.vecs),
                       ("flts", s_k.flts, s_p.flts)):
        assert_close(f"{tag} {name}", a, b, 1e-6, 1e-8)
    return max_abs(b_k.position, b_p.position)


def phase_parity(ctx):
    import torch

    chunk = PARITY_CHUNK
    readings = {}
    for n_chains, seed in ((PARITY_CHAINS, 11), (RAGGED_CHAINS, 17)):
        model, cfg, sched, states = _setup(n_chains, torch.float64, seed)
        (s_k, b_k), (s_p, b_p) = _run_both(model, cfg, sched, states, 0, chunk, chunk, False)
        warm_err = _check_warmup_f64(f"{n_chains}-chain warmup", chunk, s_k, b_k, s_p, b_p)
        # frozen chunk from the state that follows (the kernel's)
        (f_k, fb_k), (f_p, fb_p) = _run_both(model, cfg, sched, s_k, chunk, chunk, chunk, True)
        frozen_err = _check_frozen_f64(f"{n_chains}-chain frozen", f_k, fb_k, f_p, fb_p)
        readings[n_chains] = {
            "f64_warmup": {"ints_equal": True, "n_steps_equal": True,
                           "welford_counts_equal": True,
                           "max_abs_err_position": warm_err, "rtol": 1e-3},
            "f64_frozen": {"ints_equal": True, "n_steps_equal": True,
                           "max_abs_err_position": frozen_err, "rtol": 1e-6, "atol": 1e-8},
        }

    # one fresh float32 warmup chunk
    model32, cfg32, sched32, st32 = _setup(PARITY_CHAINS, torch.float32, 13)
    (g_k, gb_k), (_, gb_p) = _run_both(model32, cfg32, sched32, st32, 0, chunk, chunk, False)
    f32 = _f32_shares(chunk, g_k, gb_k, gb_p)
    emit({
        "phase": "parity", "chains": PARITY_CHAINS, "chunk": chunk,
        **readings[PARITY_CHAINS],
        "ragged": {"chains": RAGGED_CHAINS, **readings[RAGGED_CHAINS]},
        "f32_warmup": {"all_finite": True, **f32},
    })
    # 8 draws from a fresh fleet outrun float32's horizon (WINDOWS), so
    # only the step counts are held here; the warmup phase holds the draws
    assert f32["share_equal_n_steps"] >= F32_WARM_BARS["early"][0], f32


def _assert_f32_warm(r: dict) -> None:
    steps, draws, log_step = F32_WARM_BARS["early" if r["start"] < EARLY_END else "late"]
    assert r["share_equal_n_steps"] >= steps, r
    assert r["share_draws_within_tol"] >= draws, r
    assert r["max_diff_fleet_log_step"] <= log_step, r


def column_diagnostics(post, columns):
    """Bulk ESS and split R-hat of each monitored column of ``post [C, N,
    dim]``, the columns in threads (numpy's sorts and FFTs release the GIL),
    each held against ``diagnostics_device`` on the card on a float64 copy
    of the column (rtol ``DIAG_RTOL``)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from nutpie_tpu_torch import diagnostics_device
    from nutpie_tpu_torch.diagnostics import ess_from_samples, rhat_from_samples

    def one(c):
        x = np.ascontiguousarray(post[:, :, c])
        return ess_from_samples(x), rhat_from_samples(x)

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        pairs = list(pool.map(one, columns))
    ess, rhat = [e for e, _ in pairs], [r for _, r in pairs]
    for c, e, r in zip(columns, ess, rhat):
        x = torch.as_tensor(np.ascontiguousarray(post[:, :, c]), device=DEVICE,
                            dtype=torch.float64)
        for name, host, dev in (("bulk ESS", e, diagnostics_device.ess_bulk(x)),
                                ("split R-hat", r, diagnostics_device.rhat(x))):
            dev = float(dev)
            assert math.isclose(dev, host, rel_tol=DIAG_RTOL) or (
                math.isnan(dev) and math.isnan(host)), \
                f"column {c}: {name} on the card {dev}, on the host {host}"
    return ess, rhat


def phase_main(ctx):
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.sample import default_chunk_size
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.settings import NutsSettings

    compiled = compile_model_def(nt.models.radon())
    settings = NutsSettings.Diag(42)
    settings.update(num_chains=CHAINS, num_tune=TUNE, num_draws=DRAWS)
    chunk_len = min(default_chunk_size(settings, CHAINS, compiled.n_dim, 4), TUNE + DRAWS)
    assert chunk_len == CHUNK, chunk_len
    n_chunks = math.ceil((TUNE + DRAWS) / chunk_len)

    torch.cuda.synchronize()
    chunk_kernel.launches = 0
    t0 = time.perf_counter()
    raw = nt.sample(compiled, chains=CHAINS, tune=TUNE, draws=DRAWS, seed=42,
                    pool_mass_matrix=True, pool_step_size=True, device="cuda",
                    return_raw_trace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chunk_kernel.launches
    assert launches == n_chunks, f"kernel launched {launches} times for {n_chunks} chunks"

    pos = raw["position"]
    assert pos.shape == (CHAINS, TUNE + DRAWS, compiled.n_dim), pos.shape
    assert pos.dtype == np.float32, pos.dtype
    assert np.isfinite(pos).all(), "non-finite draws"
    for name, v in raw["expanded"].items():
        assert np.isfinite(v).all(), f"non-finite {name}"
    n_steps = raw["stats"]["n_steps"]
    grads = int(n_steps.astype(np.int64).sum())
    post = pos[:, TUNE:, :]
    ess, rhat = column_diagnostics(post, MONITORED)
    min_ess = float(np.min(ess))
    assert np.isfinite(min_ess) and min_ess > 0, ess
    assert max(rhat) < 1.05, f"split R-hat {max(rhat)} on a monitored column"
    div_post = int(raw["stats"]["diverging"][:, TUNE:].sum())
    ctx["launches"] = launches
    readings = {"wall_s": wall, "gradients": grads, "grads_per_s": grads / wall,
                "min_bulk_ess": min_ess, "min_ess_per_s": min_ess / wall,
                "min_ess_per_grad": min_ess / grads, "max_rhat": float(max(rhat)),
                "posterior_divergences": div_post}
    eps = raw["stats"]["step_size"][:, TUNE:]
    ctx["main_readings"] = dict(readings, step_size=float(np.median(eps)))
    emit({
        "phase": "main", "chains": CHAINS, "tune": TUNE, "draws": DRAWS,
        "chunk_len": chunk_len, "chunks": n_chunks, "kernel_launches": launches,
        "dtype": "float32", **readings,
        "posterior_step_size": {"min": float(eps.min()), "median": float(np.median(eps)),
                                "max": float(eps.max())},
        "card": ctx["card"],
    })


def _schedule_events(cfg, sched) -> list:
    """Draws at which the warmup changes course (mass-matrix switches after
    the early phase, the step-size freeze, the end of tuning)."""
    late = [d for d in range(sched.early_end, sched.freeze_start)
            if (d + 1) % cfg.adapt.switch_freq == 0]
    return late + [sched.freeze_start, sched.num_tune - 1]


def _warm_fleet(dtype, seed, check):
    """The main path's warmup, with the kernel held against its plain version
    in the dtype's WINDOWS.

    The kernel carries the fleet along the main path's chunks (pooling at
    each chunk's start, the rescue and the fleet depth cap at its end, as in
    ``sample()``); each window is a call of its own at the main path's
    shapes ([2048, 128] buffers) in which both run from the same state.
    ``check(tag, limit, kernel_state, kernel_bufs, plain_state,
    plain_bufs)`` returns the window's reading.
    """
    import types

    import torch

    from nutpie_tpu_torch.sampler.adapt import pool_adapt_state
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.run import draw_randoms, fleet_depth_cap, rescue_trapped

    model, cfg, sched, states = _setup(CHAINS, dtype, seed)
    windows = WINDOWS[str(dtype).removeprefix("torch.")]
    assert sched.early_end == EARLY_END, sched
    for d in _schedule_events(cfg, sched):
        assert any(s <= d < s + n for s, n in windows), f"no window holds draw {d}"
    cap_until = TUNE - int(cfg.adapt.freeze_share * TUNE)
    bounds = sorted({TUNE, *range(0, TUNE, CHUNK), *(s for s, _ in windows),
                     *(s + n for s, n in windows)})
    readings, steps = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        first = a - a % CHUNK
        if a == first:
            av, af = pool_adapt_state(states.adapt_vecs, states.adapt_flts,
                                      pool_mass=True, pool_step=True)
            states = states.replace(adapt_vecs=av, adapt_flts=af)
            steps = []
        if (a, b - a) in windows:
            (s_k, b_k), (s_p, b_p) = _run_both(model, cfg, sched, states, a,
                                               CHUNK, b - a, False)
            reading = check(f"{dtype} warmup window {a}", b - a, s_k, b_k, s_p, b_p)
            readings.append({"start": a, "limit": b - a,
                             "depth_cap": int(sched.depth_cap), **reading})
        else:
            mom, jit = draw_randoms(states.key, a, CHUNK, model.ndim, dtype)
            s_k, b_k = chunk_kernel(cfg, model, sched, a, b - a, states, mom, jit, False)
        states = s_k
        steps.append(b_k.scalars[:, :b - a])
        if b == min(first + CHUNK, TUNE):
            states = rescue_trapped(states, first, b - first, sched)
            if b <= cap_until:
                whole = types.SimpleNamespace(scalars=torch.cat(steps, 1))
                sched = sched._replace(depth_cap=fleet_depth_cap(cfg, whole, b - first))
    return model, cfg, sched, states, readings


def phase_warmup(ctx):
    import torch

    # every window's reading is printed before a failed one ends the phase
    failed = []

    def check64(tag, limit, s_k, b_k, s_p, b_p):
        reading = _fleet_diffs(limit, b_k, b_p)
        try:
            reading["max_abs_err_position"] = _check_warmup_f64(tag, limit, s_k, b_k,
                                                               s_p, b_p)
        except AssertionError as err:
            failed.append(str(err))
            reading["failed"] = str(err)[:300]
        return reading

    def check32(tag, limit, s_k, b_k, s_p, b_p):
        return _f32_shares(limit, s_k, b_k, b_p)

    *_, r64 = _warm_fleet(torch.float64, 5, check64)
    model, cfg, sched, states, r32 = _warm_fleet(torch.float32, 7, check32)
    ctx["warm32"] = (model, cfg, sched, states)
    emit({
        "phase": "warmup", "chains": CHAINS, "chunk": CHUNK,
        "f64": {"ints_equal": not failed, "n_steps_equal": not failed,
                "welford_counts_equal": not failed, "rtol": 1e-3, "windows": r64},
        "f32": {"all_finite": True, "tol": F32_TOL, "bars": F32_WARM_BARS,
                "windows": r32},
        "card": ctx["card"],
    })
    assert not failed, failed
    for r in r32:
        _assert_f32_warm(r)


def _event_ms(fn, reps: int):
    """Mean ms of ``reps`` calls of ``fn`` between two CUDA events, and the
    calls' results."""
    import torch

    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    outs = [fn() for _ in range(reps)]
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps, outs


def bitwise_equal(a, b) -> bool:
    """Same bits (NaN payloads and signed zeros included)."""
    import torch

    if a.is_floating_point():
        view = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


def _assert_repeatable(outs) -> None:
    """Launches from one state give the same bits: no float atomics, and a
    chain's result does not depend on the warp that took it."""
    (s0, b0), rest = outs[0], outs[1:]
    for s_i, b_i in rest:
        for name, t in s0.tensors().items():
            assert bitwise_equal(t, s_i.tensors()[name]), f"repeated launch: {name} differs"
        for name in ("position", "scalars"):
            assert bitwise_equal(getattr(b0, name), getattr(b_i, name)), \
                f"repeated launch: {name} differs"


def phase_timing(ctx):
    import torch

    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel, plain_chunk
    from nutpie_tpu_torch.sampler.run import draw_randoms
    from nutpie_tpu_torch.sampler.state import NutsMachineState

    dtype = torch.float32
    model, cfg, sched, states = ctx["warm32"]
    mom, jit = draw_randoms(states.key, TUNE, CHUNK, model.ndim, dtype)

    def kernel_once():
        return chunk_kernel(cfg, model, sched, TUNE, CHUNK, states, mom, jit, True)

    kernel_once()  # warm
    reps = 3
    ms, outs = _event_ms(kernel_once, reps)
    _assert_repeatable(outs)
    s_k, b_k = outs[0]
    del outs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_p, b_p = plain_chunk(cfg, model, sched, TUNE, CHUNK, states.clone(), mom, jit, True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)

    f32 = _f32_shares(CHUNK, s_k, b_k, b_p)
    assert f32["share_equal_n_steps"] >= F32_MIN_SHARE_STEPS, f32
    assert f32["share_draws_within_tol"] >= F32_MIN_SHARE_DRAWS, f32

    # float64 from the same state at the same shapes: ints exact, floats to
    # rtol 1e-6 / atol 1e-8, as in the parity phase; then its time
    st64 = NutsMachineState(**{k: v.double() if v.is_floating_point() else v
                               for k, v in states.tensors().items()})
    mom64, jit64 = draw_randoms(st64.key, TUNE, CHUNK, model.ndim, torch.float64)

    def kernel64_once():
        return chunk_kernel(cfg, model, sched, TUNE, CHUNK, st64, mom64, jit64, True)

    k64 = kernel64_once()
    p64 = plain_chunk(cfg, model, sched, TUNE, CHUNK, st64.clone(), mom64, jit64, True)
    torch.cuda.synchronize()
    err64 = _check_frozen_f64("main-shape float64", *k64, *p64)
    del p64
    ms64, outs64 = _event_ms(kernel64_once, reps)
    _assert_repeatable([k64] + outs64)
    del outs64

    km = model.kernel_model
    work = chunk_ops(b_k.scalars, CHUNK, model.ndim, km.n_obs, km.n_counties)
    work64 = chunk_ops(k64[1].scalars, CHUNK, model.ndim, km.n_obs, km.n_counties)
    data_bytes = sum(t.numel() * t.element_size()
                     for t in km.tensors("cpu", dtype).values())
    nbytes = chunk_bytes(CHAINS, CHUNK, model.ndim, states.ckpt_p.shape[1], 4, data_bytes)
    t_ops, t_bytes = 1e3 * work["ops"] / PEAK_F32_OPS, 1e3 * nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes)
    ctx.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               max_abs_err=err64)
    emit({
        "phase": "timing", "chains": CHAINS, "chunk": CHUNK, "dtype": "float32",
        "kernel_ms": ms, "plain_ms": plain_ms, **work,
        "ops_per_leapfrog": work["ops"] / work["leapfrogs"],
        "bytes": nbytes, "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
        "share_of_bound": bound_ms / ms, "repeated_launches_bitwise_equal": reps,
        "f32_share_equal_n_steps": f32["share_equal_n_steps"],
        "f32_share_draws_within_tol": f32["share_draws_within_tol"],
        "f32_tol": F32_TOL, "f64_ints_equal": True, "f64_max_abs_err_position": err64,
        "f64_kernel_ms": ms64, "f64_leapfrogs": work64["leapfrogs"],
        "resident_chains_per_sm": ctx["geometry"]["float32"]["resident_chains_per_sm"],
        "card": ctx["card"],
    })


def _device_rows(prof) -> list:
    """(self device seconds, name, count) of each device-side event: an
    operator's row on the host side carries its kernels' time too and
    would count it twice."""
    import torch

    return sorted(
        ((float(ev.self_device_time_total) / 1e6, ev.key, ev.count)
         for ev in prof.key_averages()
         if ev.device_type != torch.autograd.DeviceType.CPU
         and ev.self_device_time_total > 0),
        reverse=True,
    )


def _profiled_sample(compiled, **kwargs):
    """``sample()`` on the card under ``torch.profiler``: (wall s, device
    rows, K2's launches in the run, K2's launches the trace holds).  The
    step runner replays its machine steps from CUDA graphs; the trace's
    count of K2 launches says whether it saw the kernels inside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    torch.cuda.synchronize()
    launches = step_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nt.sample(compiled, device=DEVICE, return_raw_trace=True, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    traced = sum(n for _, name, n in rows if _is_k2(name))
    return wall, rows, step_kernel.launches - launches, traced


def _is_gemm(name: str) -> bool:
    return any(k in name.lower() for k in ("gemm", "cutlass", "xmma", "gemv"))


def _is_linalg(name: str) -> bool:
    """A kernel of the library QR or eigendecomposition (cuSOLVER, MAGMA)."""
    return any(k in name.lower() for k in (
        "geqr", "orgqr", "ormqr", "larf", "syev", "sytrd", "steqr", "stedc", "syevj",
        "cusolver", "magma", "householder", "potrf", "trsm", "trmm", "jacobi"))


def phase_profile(ctx):
    """Where the main paths' time goes: device time by kernel, idle share."""
    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def

    wall, rows, _, _ = _profiled_sample(
        compile_model_def(nt.models.radon()), chains=CHAINS, tune=TUNE,
        draws=DRAWS, seed=43, pool_mass_matrix=True, pool_step_size=True)
    device_s = sum(r[0] for r in rows)
    kernel_s = sum(r[0] for r in rows if "megakernel_chunk" in r[1])
    copy_s = sum(r[0] for r in rows if r[1].startswith("Memcpy"))
    top = lambda rows: [{"name": k[:80], "count": n, "self_device_ms": d * 1e3}
                        for d, k, n in rows[:8]]

    glm_wall, glm_rows, glm_launches, glm_traced = _profiled_sample(
        compile_model_def(nt.models.logistic_glm(n_data=GLM_N_DATA, dim=GLM_DIM)),
        chains=GLM_CHAINS, tune=GLM_PROFILE_TUNE, draws=GLM_PROFILE_DRAWS,
        seed=44, chunk_size=GLM_CHUNK, precision="float32")
    glm_device = sum(r[0] for r in glm_rows)
    k2 = sum(r[0] for r in glm_rows if _is_k2(r[1]))
    gemm = sum(r[0] for r in glm_rows if _is_gemm(r[1]))
    glm_copy = sum(r[0] for r in glm_rows if r[1].startswith("Memcpy"))
    emit({
        "phase": "profile", "wall_s_profiled": wall, "device_busy_s": device_s,
        "device_idle_share": max(0.0, 1.0 - device_s / wall),
        "chunk_kernel_s": kernel_s, "memcpy_s": copy_s,
        "other_device_s": device_s - kernel_s - copy_s,
        "top_device_events": top(rows),
        "glm": {
            "chains": GLM_CHAINS, "tune": GLM_PROFILE_TUNE, "draws": GLM_PROFILE_DRAWS,
            "wall_s_profiled": glm_wall, "device_busy_s": glm_device,
            "device_idle_share": max(0.0, 1.0 - glm_device / glm_wall),
            "k2_launches": glm_launches, "k2_launches_traced": glm_traced,
            "step_advance_s": k2, "logp_matmul_s": gemm, "memcpy_s": glm_copy,
            "other_device_s": glm_device - k2 - gemm - glm_copy,
            "top_device_events": top(glm_rows),
        },
        "lowrank": _lowrank_profile(top),
        "card": ctx["card"],
    })


def _lowrank_profile(top) -> dict:
    """The low-rank path under the profiler, tune and draws cut to one
    boundary update: device time split into K2, the logp's matrix products,
    the boundary update's QR and eigendecompositions, copies and the rest."""
    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def

    wall, rows, launches, traced = _profiled_sample(
        compile_model_def(nt.models.ill_conditioned_gaussian(dim=LR_DIM)),
        adaptation="low_rank", chains=LR_CHAINS, tune=LR_PROFILE_TUNE,
        draws=LR_PROFILE_DRAWS, mass_matrix_switch_freq=LR_PROFILE_SWITCH,
        mass_matrix_eigval_cutoff=LR_CUTOFF, seed=45, precision="float32")
    device = sum(r[0] for r in rows)
    k2 = sum(r[0] for r in rows if _is_k2(r[1]))
    gemm = sum(r[0] for r in rows if _is_gemm(r[1]))
    linalg = sum(r[0] for r in rows if _is_linalg(r[1]) and not _is_gemm(r[1]))
    copy = sum(r[0] for r in rows if r[1].startswith("Memcpy"))
    return {
        "chains": LR_CHAINS, "tune": LR_PROFILE_TUNE, "draws": LR_PROFILE_DRAWS,
        "switch_freq": LR_PROFILE_SWITCH,
        "wall_s_profiled": wall, "device_busy_s": device,
        "device_idle_share": max(0.0, 1.0 - device / wall),
        "k2_launches": launches, "k2_launches_traced": traced,
        "step_advance_s": k2, "matmul_s": gemm, "qr_eigh_s": linalg, "memcpy_s": copy,
        "other_device_s": device - k2 - gemm - linalg - copy,
        "top_device_events": top(rows),
    }


# ---------------------------------------------------------------- GLM path


def _glm_model():
    from nutpie_tpu_torch.models import logistic_glm

    return logistic_glm(n_data=GLM_N_DATA, dim=GLM_DIM)


def _fleet(model, tune, n_chains, dtype, seed):
    """A fresh fleet on the card, with the schedule's static depth cap."""
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import NutsConfig

    cfg = NutsConfig(adapt=AdaptConfig(num_tune=tune))
    sched = make_schedule(cfg.adapt, tune, cfg.initial_depth_cap)
    return cfg, sched, _init(model, cfg, n_chains, dtype, seed)


def _steps_both(model, cfg, sched, states, start, chunk_len, limit, frozen):
    """The step runner through K2 and through its plain version, from one state."""
    import torch

    from nutpie_tpu_torch.sampler.run import make_chunk_runner

    dtype = states.vecs.dtype
    kernel = make_chunk_runner(model, cfg, chunk_len, dtype, adapt_frozen=frozen)
    plain = make_chunk_runner(model, cfg, chunk_len, dtype, adapt_frozen=frozen, plain=True)
    k = kernel(states, start, limit, sched)
    torch.cuda.synchronize()
    p = plain(states, start, limit, sched)
    torch.cuda.synchronize()
    return k, p


def _glm_warm_fleet(seed):
    """A float32 GLM fleet at the main shapes carried through the 300
    tuning draws by the step runner, as ``sample()`` carries it (the fleet
    depth cap between chunks)."""
    import torch

    from nutpie_tpu_torch.sampler.run import fleet_depth_cap, make_chunk_runner

    model = _glm_model()
    cfg, sched, states = _fleet(model, GLM_TUNE, GLM_CHAINS, torch.float32, seed)
    warm = make_chunk_runner(model, cfg, GLM_CHUNK, torch.float32, adapt_frozen=False)
    cap_until = GLM_TUNE - int(cfg.adapt.freeze_share * GLM_TUNE)
    for start in range(0, GLM_TUNE, GLM_CHUNK):
        limit = min(GLM_CHUNK, GLM_TUNE - start)
        states, bufs = warm(states, start, limit, sched)
        if start + limit <= cap_until:
            sched = sched._replace(depth_cap=fleet_depth_cap(cfg, bufs, limit))
    return model, cfg, sched, states


def _plain_on_cpu(model, cfg, sched, states, start, chunk_len, limit, frozen):
    """The plain version on the CPU from the card's state: how far two
    plain versions that round differently part over the same chunk."""
    from nutpie_tpu_torch.sampler.run import make_chunk_runner
    from nutpie_tpu_torch.sampler.state import NutsMachineState

    cpu = NutsMachineState(**{k: v.cpu() for k, v in states.tensors().items()})
    run = make_chunk_runner(model, cfg, chunk_len, states.vecs.dtype,
                            adapt_frozen=frozen, plain=True)
    return run(cpu, start, limit, sched)


def _yardstick(limit, plain_card, plain_cpu) -> dict:
    """The card's plain version against the CPU's on one chunk."""
    import torch

    (s_g, b_g), (s_c, b_c) = plain_card, plain_cpu
    pos_g, pos_c = b_g.position[:, :limit].cpu(), b_c.position[:, :limit]
    return {"ints_equal": bool(torch.equal(s_g.ints.cpu(), s_c.ints)),
            "max_abs_diff_position": max_abs(pos_g, pos_c)}


def _held(failed: list, check, *args):
    """``check(*args)``; an AssertionError is kept in ``failed`` (and its
    reading is None) so that every reading of the phase is printed."""
    try:
        return check(*args)
    except AssertionError as err:
        failed.append(str(err)[:600])
        return None


def glm_f64_parity(failed: list) -> dict:
    """K2 against its plain version on the GLM at full width in float64,
    64 chains: a fresh 8-draw warmup window, then a 16-draw frozen chunk;
    beside each, the plain version on the CPU against the card's.  Failed
    bars go to ``failed``."""
    import torch

    model = _glm_model()
    cfg, sched, states = _fleet(model, GLM_TUNE, STEP_PARITY_CHAINS, torch.float64, 21)
    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, states, 0, 8, 8, False)
    warm_err = _held(failed, _check_warmup_f64, "GLM warmup window", 8, s_k, b_k, s_p, b_p)
    warm_yard = _yardstick(8, (s_p, b_p),
                           _plain_on_cpu(model, cfg, sched, states, 0, 8, 8, False))
    warm_share = float(((b_k.position - b_p.position).abs()
                        <= 1e-3 * (1.0 + b_p.position.abs())).double().mean())
    (f_k, fb_k), (f_p, fb_p) = _steps_both(model, cfg, sched, s_k, 8, 16, 16, True)
    frozen_err = _held(failed, _check_frozen_f64, "GLM frozen chunk", f_k, fb_k, f_p, fb_p)
    frozen_yard = _yardstick(16, (f_p, fb_p),
                             _plain_on_cpu(model, cfg, sched, s_k, 8, 16, 16, True))
    return {"chains": STEP_PARITY_CHAINS, "n_data": GLM_N_DATA, "dim": GLM_DIM,
            "warmup": {"draws": 8, "held": warm_err is not None,
                       "ints_equal": bool(torch.equal(s_k.ints, s_p.ints)),
                       "max_abs_err_position": max_abs(b_k.position, b_p.position),
                       "share_within_1e-3": warm_share, "rtol": 1e-3,
                       "plain_card_vs_cpu": warm_yard},
            "frozen": {"draws": 16, "held": frozen_err is not None,
                       "ints_equal": bool(torch.equal(f_k.ints, f_p.ints)),
                       "max_abs_err_position": max_abs(fb_k.position, fb_p.position),
                       "rtol": 1e-6, "atol": 1e-8,
                       "plain_card_vs_cpu": frozen_yard}}


def _prepared(cfg, sched, states, start: int, chunk: int, frozen: bool, plain: bool = False):
    """One chunk prepared as the step runner prepares it (the per-draw
    randoms, the buffers, start_draw, the chunk's own copy of the state),
    and its steps: K2's, or the plain version's (``plain``)."""
    from nutpie_tpu_torch.sampler.nuts import init_buffers, start_draw
    from nutpie_tpu_torch.sampler.run import draw_randoms
    from nutpie_tpu_torch.sampler.state import state_with
    from nutpie_tpu_torch.sampler.step_kernel import PlainSteps, step_kernel

    n_chains, _, dim = states.vecs.shape
    dtype = states.vecs.dtype
    mom, jit = draw_randoms(states.key, start, chunk, dim, dtype)
    bufs = init_buffers(chunk, dim, dtype, n_chains, device=DEVICE, cfg=cfg)
    st = start_draw(cfg, sched, state_with(states, done=False), mom[:, 0], jit[:, 0]).clone()
    args = (cfg, sched, start, chunk, st, mom, jit, bufs, frozen)
    return st, bufs, PlainSteps(*args) if plain else step_kernel.chunk(*args)


def _eager_chunk(model, cfg, sched, states, start: int, chunk: int, frozen: bool):
    """A frozen chunk through K2 with its launches made one by one, no
    graph: (state, buffers, machine steps)."""
    st, bufs, steps = _prepared(cfg, sched, states, start, chunk, frozen)
    z_new, carry = steps.begin(st)
    n = 0
    while not bool(st.done.all()):
        logp, grad = model.logp_and_grad(z_new)
        st, z_new, carry = steps.advance(st, z_new, carry, logp, grad)
        n += 1
    return st, bufs, n


# the settings with branches of their own in K2 (NutsConfig fields,
# AdaptConfig fields), held on eight schools in float64
SETTINGS = {
    "step_size_jitter": ({}, {"step_size_jitter": 0.3}),
    "mindepth": ({"mindepth": 3}, {}),
    "no_turning_check": ({"check_turning": False, "maxdepth": 4}, {}),
    "draw_diag": ({}, {"use_grad_based_estimate": False}),
}
SETTINGS_CHAINS, SETTINGS_DRAWS = 16, 8


def settings_f64_parity(failed: list) -> dict:
    """K2 against its plain version in each of ``SETTINGS``: float64 eight
    schools, 16 chains, an 8-draw warmup window from a fresh fleet, then
    an 8-draw frozen chunk.  Failed bars go to ``failed``."""
    import numpy as np
    import torch

    from nutpie_tpu_torch.models import eight_schools
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import NutsConfig
    from nutpie_tpu_torch.sampler.run import init_chains

    n = SETTINGS_DRAWS
    out = {}
    for tag, (nuts, adapt) in SETTINGS.items():
        model = eight_schools()
        cfg = NutsConfig(**{"maxdepth": 6, **nuts}, adapt=AdaptConfig(num_tune=GLM_TUNE, **adapt))
        sched = make_schedule(cfg.adapt, GLM_TUNE)
        states, ok = init_chains(model, cfg, 27, SETTINGS_CHAINS, np.zeros(model.ndim),
                                 torch.float64, device=DEVICE)
        assert bool(ok.all()), "chain initialization failed"
        (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, states, 0, n, n, False)
        warm = _held(failed, _check_warmup_f64, f"{tag} warmup window", n, s_k, b_k, s_p, b_p)
        (f_k, fb_k), (f_p, fb_p) = _steps_both(model, cfg, sched, s_k, n, n, n, True)
        frozen = _held(failed, _check_frozen_f64, f"{tag} frozen chunk", f_k, fb_k, f_p, fb_p)
        out[tag] = {"warmup_held": warm is not None, "frozen_held": frozen is not None,
                    "max_abs_err_position": max_abs(fb_k.position, fb_p.position)}
    return out


def phase_step_parity(ctx):
    import torch

    from nutpie_tpu_torch.models import ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    ns = SCALAR_SLOTS["n_steps"]
    failed = []

    # float32 at the main shapes, from a fleet the step runner warmed; the
    # graph-replayed chunk against the same launches made one by one
    model32, cfg32, sched32, warm32 = _glm_warm_fleet(25)
    ctx["glm_warm"] = (model32, cfg32, sched32, warm32)
    (g_k, gb_k), (_, gb_p) = _steps_both(model32, cfg32, sched32, warm32, GLM_TUNE,
                                         GLM_CHUNK, GLM_CHUNK, True)
    f32 = _f32_shares(GLM_CHUNK, g_k, gb_k, gb_p)
    e_k, eb_k, _ = _eager_chunk(model32, cfg32, sched32, warm32, GLM_TUNE, GLM_CHUNK, True)
    torch.cuda.synchronize()
    graph_bitwise = (all(bitwise_equal(t, e_k.tensors()[name])
                         for name, t in g_k.tensors().items())
                     and bitwise_equal(gb_k.position, eb_k.position)
                     and bitwise_equal(gb_k.scalars, eb_k.scalars))
    del g_k, gb_k, gb_p, e_k, eb_k

    glm64 = glm_f64_parity(failed)

    ill = ill_conditioned_gaussian(dim=ILL_DIM)
    icfg, isched, istates = _fleet(ill, GLM_TUNE, ILL_CHAINS, torch.float64, 23)
    (i_k, ib_k), (i_p, ib_p) = _steps_both(ill, icfg, isched, istates, 0, 8, 8, True)
    ill_ints = bool(torch.equal(i_k.ints, i_p.ints))
    ill_steps = nan_equal(ib_k.scalars[..., ns], ib_p.scalars[..., ns])
    settings = settings_f64_parity(failed)

    ctx["step_max_abs_err"] = glm64["frozen"]["max_abs_err_position"]
    emit({
        "phase": "step_parity",
        "glm_f64": glm64,
        "gaussian1000_f64": {"chains": ILL_CHAINS, "dim": ILL_DIM, "draws": 8,
                             "ints_equal": ill_ints, "n_steps_equal": ill_steps,
                             "max_rel_diff_position": max_rel(ib_k.position, ib_p.position),
                             "leapfrogs": int(ib_k.scalars[..., ns].nansum())},
        "settings_f64": {"model": "eight_schools", "chains": SETTINGS_CHAINS,
                         "draws": SETTINGS_DRAWS, **settings},
        "glm_f32": {"chains": GLM_CHAINS, "draws": GLM_CHUNK, "all_finite": True,
                    "tol": F32_TOL, "graph_replay_bitwise_eager": graph_bitwise, **f32},
        "failed": failed,
        "card": ctx["card"],
    })
    assert not failed, failed
    assert ill_ints and ill_steps, "1000-d Gaussian: ints or step counts differ"
    assert graph_bitwise, "the graph-replayed chunk differs from its eager launches"
    assert f32["share_equal_n_steps"] >= F32_MIN_SHARE_STEPS, f32
    assert f32["share_draws_within_tol"] >= F32_MIN_SHARE_DRAWS, f32


def _zero_counts(step_kernel, chunk_kernel) -> None:
    """Both kernels' launch counts, K2's graph replays and capture seconds
    set to 0 just before a path runs."""
    step_kernel.launches = step_kernel.replays = chunk_kernel.launches = 0
    step_kernel.capture_s = 0.0


def _assert_step_launches(step_kernel, chunks: int, steps: int, unroll: int) -> None:
    """K2 launched once per chunk (its first half) and once per machine
    step, every machine step from a graph replay of ``unroll`` of them."""
    k2 = step_kernel.launches
    assert k2 == chunks + steps, \
        f"step kernel launched {k2} times for {chunks} chunks and {steps} machine steps"
    assert step_kernel.replays * unroll == steps, \
        f"{step_kernel.replays} graph replays of {unroll} steps for {steps} machine steps"


def machine_steps(n_steps, chunk_len: int, unroll: int) -> int:
    """Machine steps of a run from its draws' step counts ``[C, draws]``:
    each chain takes one leapfrog per step, a chunk runs until its slowest
    chain is done, and the loop replays ``unroll`` steps between two "all
    done" reads."""
    import numpy as np

    total = 0
    for start in range(0, n_steps.shape[1], chunk_len):
        per_chain = n_steps[:, start:start + chunk_len].astype(np.int64).sum(axis=1)
        total += -(-int(per_chain.max()) // unroll) * unroll
    return total


def laplace(X, y, iters: int = 50):
    """Mode and covariance of the Laplace approximation of the GLM's
    posterior (prior N(0, 1) per coefficient), by Newton's method in
    float64."""
    import numpy as np

    X, y = X.astype(np.float64), y.astype(np.float64)
    beta = np.zeros(X.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(X @ beta)))
        grad = X.T @ (y - p) - beta
        hess = X.T @ (X * (p * (1.0 - p))[:, None]) + np.eye(X.shape[1])
        beta = beta + np.linalg.solve(hess, grad)
    p = 1.0 / (1.0 + np.exp(-(X @ beta)))
    hess = X.T @ (X * (p * (1.0 - p))[:, None]) + np.eye(X.shape[1])
    return beta, np.linalg.inv(hess)


def importance_mean(X, y, mode, cov, n: int = 20000, seed: int = 0):
    """The GLM's posterior mean by importance sampling from its Laplace
    approximation (float64 numpy), and the sample's effective size: the
    mean the sampler should reach, where the mode differs from it by the
    posterior's skew."""
    import numpy as np

    X, y = X.astype(np.float64), y.astype(np.float64)
    rng = np.random.default_rng(seed)
    chol = np.linalg.cholesky(cov)
    z = rng.standard_normal((n, len(mode)))
    beta = mode + z @ chol.T
    logits = beta @ X.T
    logp = (y * logits - np.logaddexp(0.0, logits)).sum(1) - 0.5 * (beta * beta).sum(1)
    logw = logp + 0.5 * (z * z).sum(1)
    w = np.exp(logw - logw.max())
    return (w[:, None] * beta).sum(0) / w.sum(), float(w.sum() ** 2 / (w * w).sum())


def phase_glm(ctx):
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.models.analytic import glm_data
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.run import CUDA_UNROLL
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    compiled = compile_model_def(_glm_model())
    torch.cuda.synchronize()
    _zero_counts(step_kernel, chunk_kernel)
    t0 = time.perf_counter()
    raw = nt.sample(compiled, chains=GLM_CHAINS, tune=GLM_TUNE, draws=GLM_DRAWS,
                    seed=42, chunk_size=GLM_CHUNK, precision="float32", device=DEVICE,
                    return_raw_trace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k1 = step_kernel.launches, chunk_kernel.launches
    n_steps = raw["stats"]["n_steps"]
    steps = machine_steps(n_steps, GLM_CHUNK, CUDA_UNROLL)
    chunks = math.ceil((GLM_TUNE + GLM_DRAWS) / GLM_CHUNK)
    assert k1 == 0, f"the chunk kernel launched {k1} times on the GLM path"
    _assert_step_launches(step_kernel, chunks, steps, CUDA_UNROLL)

    pos = raw["position"]
    assert pos.shape == (GLM_CHAINS, GLM_TUNE + GLM_DRAWS, GLM_DIM), pos.shape
    assert pos.dtype == np.float32, pos.dtype
    assert np.isfinite(pos).all(), "non-finite draws"
    grads = int(n_steps.astype(np.int64).sum())
    post = pos[:, GLM_TUNE:, :]
    ess, rhat = column_diagnostics(post, GLM_MONITORED)
    min_ess = float(np.min(ess))
    assert np.isfinite(min_ess) and min_ess > 0, ess
    assert max(rhat) < 1.05, f"split R-hat {max(rhat)} on a monitored column"
    X, y = glm_data(GLM_N_DATA, GLM_DIM)
    mode, cov = laplace(X, y)
    sd = np.sqrt(np.diag(cov))
    mean = post.reshape(-1, GLM_DIM).mean(axis=0, dtype=np.float64)
    dev = np.abs(mean - mode) / sd
    is_mean, is_ess = importance_mean(X, y, mode, cov)
    is_dev = np.abs(mean - is_mean) / sd
    assert is_dev.max() <= IMPORTANCE_SD_TOL, \
        f"posterior mean {is_dev.max()} sd from the importance-sampled mean"
    assert dev.max() <= LAPLACE_SD_TOL, f"posterior mean {dev.max()} sd from the Laplace mode"
    ctx["glm_launches"] = k2
    ctx["glm_graphs"] = {"launches_per_machine_step": k2 / steps,
                         "graph_replays": step_kernel.replays,
                         "capture_s": step_kernel.capture_s}
    emit({
        "phase": "glm", "chains": GLM_CHAINS, "tune": GLM_TUNE, "draws": GLM_DRAWS,
        "n_data": GLM_N_DATA, "dim": GLM_DIM, "chunk_len": GLM_CHUNK, "dtype": "float32",
        "step_kernel_launches": k2, "chunk_kernel_launches": k1, "machine_steps": steps,
        "chunks": chunks, **ctx["glm_graphs"],
        "unroll": CUDA_UNROLL, "wall_s": wall, "host_wall_ms_per_machine_step": 1e3 * wall / steps,
        "gradients": grads, "grads_per_s": grads / wall, "min_bulk_ess": min_ess,
        "min_ess_per_s": min_ess / wall, "min_ess_per_grad": min_ess / grads,
        "max_rhat": float(max(rhat)), "posterior_divergences":
            int(raw["stats"]["diverging"][:, GLM_TUNE:].sum()),
        "laplace_max_dev_sd": float(dev.max()), "laplace_tol_sd": LAPLACE_SD_TOL,
        "importance_mean_max_dev_sd": float(is_dev.max()),
        "importance_tol_sd": IMPORTANCE_SD_TOL, "importance_ess": is_ess,
        "card": ctx["card"],
    })


def step_bytes(scalars, limit: int, n_chains: int, steps: int, dim: int,
               depth_slots: int, itemsize: int, rank: int = 0,
               streamed: bool = False, div_rows: bool = False) -> dict:
    """Bytes the step kernel must move over one frozen chunk (its ``begin``
    launch and ``steps`` advance launches), counted from
    csrc/step_kernel.cu for this chunk's trees: each row a launch touches
    read once and written once.  Left out, so it is a lower bound: the
    multinomial's copies of the proposal rows, and the other edge a
    doubling's first step reads when it turns round (both depend on the
    uniforms).  Subtrees before a draw's last are full, so a draw of depth d
    and n steps has subtrees of 1, 2, ..., 2^(d-2) leaves and a last of
    n_last = n - 2^(d-1) + 1; a subtree of m leaves pushes ceil(m/2)
    checkpoints, and the checks and merges count as in ``chunk_ops``.

    Under a low-rank metric of rank ``rank`` a machine step of an active
    chain also reads the chain's basis and log eigenvalues once (the
    bound).  ``lr_basis_bytes_as_read`` counts the basis as csrc/lowrank.cuh
    reads it: staged, once per launch of an active chain; ``streamed``, once
    per pass: two for the new point's velocity and two for the next drift,
    three for a draw's start (its middle pass expands and projects the same
    tiles).  The checks and merges use the velocities the kernel keeps.

    With the divergence rows (``div_rows``) each draw also reads its four
    rows and writes them to the four buffers, each next draw's start
    writes them (NaN), and each divergent draw's leaf reads the edge's old
    position and writes the four rows."""
    import numpy as np

    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    s = scalars[:, :limit].double().cpu().numpy()
    n = s[..., SCALAR_SLOTS["n_steps"]].astype(np.int64).reshape(-1)
    d = s[..., SCALAR_SLOTS["depth"]].astype(np.int64).reshape(-1)
    n_last = n - (2 ** (d - 1) - 1)
    popcount = sum((n_last >> b) & 1 for b in range(32))
    leapfrogs = int(n.sum())
    checks = int((n - (d - 1) - popcount).sum())
    merges = int((d - 1).sum())
    pushes = int((np.where(d >= 2, 2 ** np.maximum(d - 2, 0), 0) + (n_last + 1) // 2).sum())
    subtrees = int(d.sum())
    draws = int(n.size)
    done_steps = n_chains * steps - leapfrogs
    T, row = itemsize, dim * itemsize
    ints, flts = 15 * 4, 12 * T
    # the chunk's begin: the edge's z, p, g and the inverse mass in, the
    # stash and z_new out; the scalars and the key in, ints, the uniforms
    # and the flag out
    begin = n_chains * (4 * row + 2 * row + 2 * ints + flts + 16 + 12 + 4)
    # an active chain's advance: the edge's p and g, the gradient, z_new,
    # the inverse mass and rho_sub in; the edge's z, p, g, rho_sub and the
    # next z_new out; ints and flts in and out, logp, two uniforms and the
    # flag in, the key in, three uniforms and the flag out.  Pushes,
    # subtree checks (two slot rows each), merges (rho, the far edge, two
    # slots in, rho out), draws (the proposal in, the draw and the committed
    # position and gradient out, the adaptation scalars in, the scalar
    # row), each next draw's start (momentum and inverse mass in, jitter,
    # 12 rows out), each subtree's stash; a done chain's ints
    advance = (leapfrogs * (6 * row + 5 * row + 2 * (ints + flts) + T + 8 + 4 + 16 + 12 + 4)
               + pushes * 2 * row + checks * 2 * row + merges * 5 * row
               + draws * (2 * row + 3 * row + 12 * T + 12 * T)
               + (draws - n_chains) * (2 * row + T + 12 * row)
               + subtrees * row + done_steps * ints)
    out = {"leapfrogs": leapfrogs, "subtree_checks": checks, "merges": merges,
           "pushes": pushes, "draws": draws, "done_chain_steps": done_steps}
    if div_rows:
        divergent = int((s[..., SCALAR_SLOTS["diverging"]] > 0.5).sum())
        advance += (draws * 8 + (draws - n_chains) * 4 + divergent * 5) * row
        out["divergent_draws"] = divergent
    if rank:
        metric = (rank * dim + rank) * T
        begin += n_chains * metric
        advance += leapfrogs * metric
        starts = draws - n_chains
        passes = (4 * leapfrogs + 3 * starts if streamed
                  else leapfrogs + n_chains)
        out["lr_basis_bytes_as_read"] = passes * rank * dim * T
    return {"bytes": begin + advance, "begin_bytes": begin, "advance_bytes": advance, **out}


def step_ops(work: dict, dim: int, rank: int = 0) -> int:
    """Operations of the step kernel for a chunk's trees, per coordinate as
    in ``chunk_ops`` (the machine step's arithmetic, no model); under a
    low-rank metric each application (the drift, the new point's velocity,
    two per draw's start) adds a projection and an expansion (4 dim R) and
    its scalings (3 dim)."""
    ops = (work["leapfrogs"] * (OPS_LEAF_SCALAR + OPS_LEAPFROG_PER_COORD * dim)
           + work["subtree_checks"] * OPS_SUBTREE_CHECK_PER_COORD * dim
           + work["merges"] * OPS_MERGE_PER_COORD * dim
           + work["draws"] * OPS_START_DRAW_PER_COORD * dim)
    if rank:
        apps = 2 * work["leapfrogs"] + 2 * work["draws"]
        ops += apps * (4 * dim * rank + 3 * dim)
    return ops


def _is_k2(name: str) -> bool:
    return "step_advance" in name


def _unroll_sweep(model, cfg, sched, states, chunk: int, start: int = 0):
    """One frozen chunk through the runner's CUDA graphs at each of
    ``UNROLLS`` machine steps a graph, in turns: host wall ms of each run,
    and the machine steps the replays ran."""
    import torch

    from nutpie_tpu_torch.sampler.run import make_chunk_runner
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    ms = {str(u): [] for u in UNROLLS}
    steps = {}
    for u in UNROLLS + UNROLLS[::-1]:
        run = make_chunk_runner(model, cfg, chunk, states.vecs.dtype, adapt_frozen=True,
                                unroll=u)
        replays = step_kernel.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(states, start, chunk, sched)
        torch.cuda.synchronize()
        ms[str(u)].append(1e3 * (time.perf_counter() - t0))
        steps[str(u)] = u * (step_kernel.replays - replays)
    return ms, steps


def phase_step_timing(ctx):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nutpie_tpu_torch.sampler.run import CUDA_UNROLL

    model, cfg, sched, states = ctx["glm_warm"]
    dtype, start, chunk = torch.float32, GLM_TUNE, GLM_CHUNK

    # K2's advance and the logp, step by step, by device time under the
    # profiler (the chunk's begin before it; an "all done" read every
    # CUDA_UNROLL steps)
    st, bufs, steps = _prepared(cfg, sched, states, start, chunk, True)
    z_new, carry = steps.begin(st)
    torch.cuda.synchronize()
    n_steps = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while True:
            logp, grad = model.logp_and_grad(z_new)
            st, z_new, carry = steps.advance(st, z_new, carry, logp, grad)
            n_steps += 1
            if n_steps % CUDA_UNROLL == 0 and bool(st.done.all()):
                break
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    k2_s = sum(r[0] for r in rows if _is_k2(r[1]))
    logp_s = sum(r[0] for r in rows) - k2_s
    gemm_s = sum(r[0] for r in rows if _is_gemm(r[1]))

    # the same steps by CUDA events around each call, with no host read in
    # the loop (stepping a done chain is a no-op), so the host stays ahead
    # of the card and no event pair spans an idle gap
    est, ebufs, esteps = _prepared(cfg, sched, states, start, chunk, True)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
             for _ in range(n_steps)]
    z_new, carry = esteps.begin(est)
    torch.cuda.synchronize()
    for ev in marks:
        ev[0].record()
        logp, grad = model.logp_and_grad(z_new)
        ev[1].record()
        est, z_new, carry = esteps.advance(est, z_new, carry, logp, grad)
        ev[2].record()
    torch.cuda.synchronize()
    assert bool(est.done.all()) and bitwise_equal(ebufs.position, bufs.position)
    event_ms = {part: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / n_steps
                for i, part in enumerate(("logp_grad", "advance"))}

    # the plain advance (finish, then begin), step by step, by CUDA events
    # after a synchronize
    pst, _, plain = _prepared(cfg, sched, states, start, chunk, True, plain=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    plain_ms, plain_steps = 0.0, 0
    z_new, carry = plain.begin(pst)
    while not bool(pst.done.all()):
        logp, grad = model.logp_and_grad(z_new)
        torch.cuda.synchronize()
        ev[0].record()
        pst, z_new, carry = plain.advance(pst, z_new, carry, logp, grad)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms += ev[0].elapsed_time(ev[1])
        plain_steps += 1

    unroll_ms, unroll_steps = _unroll_sweep(model, cfg, sched, states, chunk, start)

    work = step_bytes(bufs.scalars, chunk, GLM_CHAINS, n_steps, GLM_DIM,
                      st.ckpt_p.shape[1], 4)
    t_bytes = 1e3 * work["advance_bytes"] / PEAK_BYTES / n_steps
    t_ops = 1e3 * step_ops(work, GLM_DIM) / PEAK_F32_OPS / n_steps
    k2_ms = event_ms["advance"]
    ctx.update(step_ms=k2_ms, step_device_ms=1e3 * k2_s / n_steps,
               step_plain_ms=plain_ms / plain_steps, step_bound_ms=max(t_bytes, t_ops),
               step_bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({
        "phase": "step_timing", "chains": GLM_CHAINS, "dim": GLM_DIM, "chunk": chunk,
        "dtype": "float32", "machine_steps": n_steps, "plan": ctx["glm_plan"]["float32"],
        "k2_advance_ms_per_step": k2_ms,
        "logp_grad_ms_per_step": event_ms["logp_grad"],
        "k2_advance_device_ms_per_step": 1e3 * k2_s / n_steps,
        "logp_grad_device_ms_per_step": 1e3 * logp_s / n_steps,
        "logp_matmul_device_ms_per_step": 1e3 * gemm_s / n_steps,
        "host_wall_ms_per_step_profiled": 1e3 * profiled_wall / n_steps,
        "plain_advance_ms_per_step": plain_ms / plain_steps,
        "plain_machine_steps": plain_steps,
        "bytes_per_step": work["advance_bytes"] / n_steps, "bytes_bound_ms_per_step": t_bytes,
        "ops_bound_ms_per_step": t_ops, "share_of_bound": max(t_bytes, t_ops) / k2_ms,
        "share_of_bound_device": max(t_bytes, t_ops) / (1e3 * k2_s / n_steps),
        **{k: v for k, v in work.items() if k != "bytes"},
        "unroll_chunk_ms": unroll_ms, "unroll_machine_steps": unroll_steps,
        "top_device_events": [{"name": k[:80], "count": c, "self_device_ms": d * 1e3}
                              for d, k, c in rows[:8]],
        "card": ctx["card"],
    })
    lowrank_step_timing(ctx)


# ---------------------------------------------------------------- low-rank path


def _lr_truth(dim: int = LR_DIM):
    """The ``dim``-d Gaussian's rotation and eigenvalues as
    ``models/analytic.py:ill_conditioned_gaussian`` draws them (seed 0):
    covariance ``Q diag(eigs) Q^T``, eigenvalues ascending."""
    import numpy as np

    rng = np.random.default_rng(0)
    eigs = np.logspace(0, 4, dim)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return q, eigs


def _lr_posterior(n_chains: int, n_draws: int, seed: int, dim: int = LR_DIM):
    """Exact posterior draws ``[C, n, dim]`` and their gradients, float64 on
    the card (normals from numpy)."""
    import numpy as np
    import torch

    q, eigs = _lr_truth(dim)
    qt = torch.as_tensor(q, device=DEVICE)
    e = torch.as_tensor(eigs, device=DEVICE)
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(rng.standard_normal((n_chains, n_draws, dim)), device=DEVICE)
    y = y * torch.sqrt(e)                        # the draws in the eigenbasis
    return y @ qt.T, -(y / e) @ qt.T              # x = Q y, -P x = -Q (y / eigs)


def _lr_fleet(n_chains: int, dtype, seed: int, cutoff: float, dim: int = LR_DIM,
              rank: int = LR_RANK, padded: int = 0, maxdepth=None):
    """A fleet of the low-rank path at stationarity: each chain at an exact
    posterior draw, with the gradient-based diagonal estimate sqrt(var x /
    var g) and the port's low-rank estimate (``estimate_low_rank``) from
    ``LR_WINDOW`` earlier posterior draws and gradients of its own, its last
    ``padded`` slots then padded as the estimator pads (a zero column and a
    zero log eigenvalue), and a step size from the initial step search;
    ``maxdepth`` overrides the default.  Returns the model, config,
    schedule, state and each chain's kept slots."""
    import numpy as np
    import torch

    from nutpie_tpu_torch.models import ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.low_rank import estimate_low_rank
    from nutpie_tpu_torch.sampler.nuts import LowRankConfig, NutsConfig
    from nutpie_tpu_torch.sampler.run import find_initial_step, init_chains
    from nutpie_tpu_torch.sampler.state import ADAPT_VEC_SLOTS, state_with

    model = ill_conditioned_gaussian(dim=dim)
    cfg = NutsConfig(low_rank=LowRankConfig(eigval_cutoff=cutoff, max_rank=rank),
                     adapt=AdaptConfig(num_tune=LR_TUNE),
                     **({} if maxdepth is None else {"maxdepth": maxdepth}))
    sched = make_schedule(cfg.adapt, LR_TUNE, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, seed, n_chains, np.zeros(dim), dtype,
                             device=DEVICE, step_search=False)
    assert bool(ok.all()), "chain initialization failed"
    x, g = _lr_posterior(n_chains, LR_WINDOW + 1, seed, dim)
    win_x, win_g = x[:, :LR_WINDOW], g[:, :LR_WINDOW]
    inv_mass = torch.sqrt(win_x.var(dim=1) / win_g.var(dim=1))
    valid = torch.ones((n_chains, LR_WINDOW), dtype=torch.bool, device=DEVICE)
    lr = cfg.low_rank
    metric = estimate_low_rank(win_x, win_g, valid, inv_mass, lr.max_rank,
                               lr.eigval_cutoff, lr.gamma)
    basis, log_eigs = metric.basis.clone(), metric.log_eigs.clone()
    if padded:
        basis[..., rank - padded:] = 0
        log_eigs[..., rank - padded:] = 0
    pos = x[:, -1].to(dtype)
    logp, grad = model.logp_and_grad(pos)
    adapt_vecs = states.adapt_vecs.clone()
    adapt_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]] = inv_mass.to(dtype)
    states = state_with(states, position=pos, gradient=grad.to(dtype), logp=logp.to(dtype))
    states = states.replace(adapt_vecs=adapt_vecs,
                            lr_basis=basis.to(dtype).contiguous(),
                            lr_log_eigs=log_eigs.to(dtype).contiguous())
    states = find_initial_step(cfg, model.logp_and_grad, states)
    return model, cfg, sched, states, (log_eigs != 0).sum(dim=1)


def _check_lowrank_frozen_f64(tag, s_k, b_k, s_p, b_p) -> float:
    """``_check_frozen_f64`` and the stored gradients."""
    err = _check_frozen_f64(tag, s_k, b_k, s_p, b_p)
    assert_close(f"{tag} gradient", b_k.gradient, b_p.gradient, 1e-6, 1e-8)
    return err


def phase_lowrank_parity(ctx):
    import torch

    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    ns = SCALAR_SLOTS["n_steps"]
    failed = []
    readings = {}
    for tag, dim, rank, cutoff, padded, maxdepth, (n_warm, n_frozen) in LR_F64_CASES:
        model, cfg, sched, states, kept = _lr_fleet(LR_PARITY_CHAINS, torch.float64, 31,
                                                    cutoff, dim, rank, padded, maxdepth)
        plan = step_kernel.plan(LR_PARITY_CHAINS, dim, rank, torch.float64, DEVICE,
                                aligned=states.lr_basis.data_ptr() % 16 == 0)
        (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, states, 0, n_warm, n_warm,
                                             False)
        warm_err = _held(failed, _check_warmup_f64, f"low-rank {tag} warmup", n_warm,
                         s_k, b_k, s_p, b_p)
        (f_k, fb_k), (f_p, fb_p) = _steps_both(model, cfg, sched, s_k, n_warm, n_frozen,
                                               n_frozen, True)
        frozen_err = _held(failed, _check_lowrank_frozen_f64, f"low-rank {tag} frozen",
                           f_k, fb_k, f_p, fb_p)
        readings[tag] = {
            "dim": dim, "rank": rank, "form": plan.form, "copy": plan.copy,
            "smem_bytes": plan.smem_bytes, "padded_slots": padded, "maxdepth": cfg.maxdepth,
            "eigval_cutoff": cutoff, "kept_slots_min": int(kept.min()),
            "kept_slots_max": int(kept.max()),
            "warmup": {"draws": n_warm, "held": warm_err is not None,
                       "ints_equal": bool(torch.equal(s_k.ints, s_p.ints)),
                       "max_abs_err_position": max_abs(b_k.position, b_p.position),
                       "leapfrogs": int(b_k.scalars[..., ns].nansum()), "rtol": 1e-3},
            "frozen": {"draws": n_frozen, "held": frozen_err is not None,
                       "ints_equal": bool(torch.equal(f_k.ints, f_p.ints)),
                       "max_abs_err_position": max_abs(fb_k.position, fb_p.position),
                       "leapfrogs": int(fb_k.scalars[..., ns].nansum()),
                       "rtol": 1e-6, "atol": 1e-8},
        }
        del s_k, b_k, s_p, b_p, f_k, fb_k, f_p, fb_p

    # float32 at the main shapes: one frozen chunk
    model32, cfg32, sched32, st32, kept32 = _lr_fleet(LR_CHAINS, torch.float32, 33, LR_CUTOFF)

    ctx["lr_fleet"] = (model32, cfg32, sched32, st32)
    (g_k, gb_k), (_, gb_p) = _steps_both(model32, cfg32, sched32, st32, 0,
                                         LR_F32_CHUNK, LR_F32_CHUNK, True)
    f32 = _f32_shares(LR_F32_CHUNK, g_k, gb_k, gb_p)
    ctx["lr_max_abs_err"] = readings["all_slots"]["frozen"]["max_abs_err_position"]
    emit({
        "phase": "lowrank_parity", "dim": LR_DIM, "rank": LR_RANK,
        "f64": {"chains": LR_PARITY_CHAINS, **readings},
        "f32": {"chains": LR_CHAINS, "draws": LR_F32_CHUNK, "all_finite": True,
                "kept_slots_min": int(kept32.min()), "kept_slots_max": int(kept32.max()),
                "leapfrogs": int(gb_k.scalars[..., ns].nansum()), "tol": F32_TOL, **f32},
        "failed": failed,
        "card": ctx["card"],
    })
    assert not failed, failed
    assert f32["share_equal_n_steps"] >= F32_MIN_SHARE_STEPS, f32
    assert f32["share_draws_within_tol"] >= F32_MIN_SHARE_DRAWS, f32


def phase_lowrank(ctx):
    import importlib

    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.models import ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler import run as run_module
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.run import CUDA_UNROLL
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    # the module, not the function the package exports under its name

    sample_module = importlib.import_module("nutpie_tpu_torch.sample")

    # the boundary updates and the chunks' expansion and copies to the host,
    # timed (a synchronize on each side), the updates read, and the metric
    # rank of every chunk's kernel steps
    updates, ranks, host = [], set(), {"expand_s": 0.0, "to_host_s": 0.0}
    update_low_rank, chunk = run_module.update_low_rank, step_kernel.chunk
    expand_chunk, chunk_to_host = sample_module.expand_chunk, sample_module.chunk_to_host

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            host[key] += time.perf_counter() - t0
            return out
        return wrapper

    def timed_update(cfg, states, bufs, chunk_start, limit, sched):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update_low_rank(cfg, states, bufs, chunk_start, limit, sched)
        torch.cuda.synchronize()
        if out is not states:
            kept = (out.lr_log_eigs != 0).sum(dim=1)
            updates.append({"end": chunk_start + limit, "seconds": time.perf_counter() - t0,
                            "chains_with_a_kept_slot": int((kept > 0).sum()),
                            "mean_kept_slots": float(kept.double().mean())})
        return out

    def ranked_chunk(*args, **kwargs):
        steps = chunk(*args, **kwargs)
        ranks.add(getattr(steps.cfg, "lr_rank", None))  # None: the plain version
        return steps

    compiled = compile_model_def(ill_conditioned_gaussian(dim=LR_DIM))
    run_module.update_low_rank, step_kernel.chunk = timed_update, ranked_chunk
    sample_module.expand_chunk = timed(expand_chunk, "expand_s")
    sample_module.chunk_to_host = timed(chunk_to_host, "to_host_s")
    try:
        torch.cuda.synchronize()
        _zero_counts(step_kernel, chunk_kernel)
        t0 = time.perf_counter()
        raw = nt.sample(compiled, adaptation="low_rank", chains=LR_CHAINS, tune=LR_TUNE,
                        draws=LR_DRAWS, mass_matrix_eigval_cutoff=LR_CUTOFF, seed=42,
                        precision="float32", device=DEVICE, return_raw_trace=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2, k1 = step_kernel.launches, chunk_kernel.launches
    finally:
        run_module.update_low_rank = update_low_rank
        sample_module.expand_chunk, sample_module.chunk_to_host = expand_chunk, chunk_to_host
        del step_kernel.chunk
    n_steps = raw["stats"]["n_steps"]
    steps = machine_steps(n_steps, LR_CHUNK, CUDA_UNROLL)
    chunks = math.ceil((LR_TUNE + LR_DRAWS) / LR_CHUNK)
    assert k1 == 0, f"the chunk kernel launched {k1} times on the low-rank path"
    _assert_step_launches(step_kernel, chunks, steps, CUDA_UNROLL)
    assert ranks == {LR_RANK}, f"the step kernel ran with metric ranks {ranks}"
    assert [u["end"] for u in updates] == [160, 240], updates
    assert updates[-1]["chains_with_a_kept_slot"] >= 0.9 * LR_CHAINS, updates

    pos = raw["position"]
    assert pos.shape == (LR_CHAINS, LR_TUNE + LR_DRAWS, LR_DIM), pos.shape
    assert pos.dtype == np.float32, pos.dtype
    assert np.isfinite(pos).all(), "non-finite draws"
    grads = int(n_steps.astype(np.int64).sum())
    post = pos[:, LR_TUNE:, :]
    ess, rhat = column_diagnostics(post, LR_MONITORED)
    min_ess = float(np.min(ess))
    q, eigs = _lr_truth()
    flat = post.reshape(-1, LR_DIM)
    true_var = (q * q) @ eigs
    var_ratio = flat[:, LR_MONITORED].astype(np.float64).var(axis=0) / true_var[LR_MONITORED]
    proj = flat @ q[:, [-1, 0]].astype(np.float32)
    proj_ratio = proj.astype(np.float64).var(axis=0) / eigs[[-1, 0]]
    lo, hi = LR_VAR_BAND
    ctx["lr_launches"] = k2
    ctx["lr_graphs"] = {"launches_per_machine_step": k2 / steps,
                        "graph_replays": step_kernel.replays,
                        "capture_s": step_kernel.capture_s}
    emit({
        "phase": "lowrank", "chains": LR_CHAINS, "tune": LR_TUNE, "draws": LR_DRAWS,
        "dim": LR_DIM, "rank": LR_RANK, "chunk_len": LR_CHUNK, "dtype": "float32",
        "step_kernel_launches": k2, "chunk_kernel_launches": k1, "machine_steps": steps,
        "chunks": chunks, **ctx["lr_graphs"], "unroll": CUDA_UNROLL,
        "eigval_cutoff": LR_CUTOFF, "metric_ranks": sorted(ranks, key=str),
        "boundary_updates": updates, **host,
        "wall_s": wall, "host_wall_ms_per_machine_step": 1e3 * wall / steps,
        "gradients": grads, "grads_per_s": grads / wall,
        "leapfrogs_per_draw": float(n_steps.mean()),
        "leapfrogs_per_posterior_draw": float(n_steps[:, LR_TUNE:].mean()),
        "min_bulk_ess": min_ess, "min_ess_per_s": min_ess / wall,
        "min_ess_per_grad": min_ess / grads, "max_rhat": float(max(rhat)),
        "posterior_divergences": int(raw["stats"]["diverging"][:, LR_TUNE:].sum()),
        "var_ratio_min": float(var_ratio.min()), "var_ratio_max": float(var_ratio.max()),
        "var_ratio_top_eigvec": float(proj_ratio[0]),
        "var_ratio_bottom_eigvec": float(proj_ratio[1]), "var_band": LR_VAR_BAND,
        "card": ctx["card"],
    })
    assert np.isfinite(min_ess) and min_ess > 0, ess
    assert max(rhat) < 1.05, f"split R-hat {max(rhat)} on a monitored column"
    assert lo <= var_ratio.min() and var_ratio.max() <= hi, var_ratio
    assert all(lo <= r <= hi for r in proj_ratio), proj_ratio


def _timed_steps(model, cfg, sched, states, chunk: int, start: int = 0):
    """K2's advance and the logp+grad call per machine step over one frozen
    chunk from ``states`` (chunk start ``start``), launched one by one, by
    CUDA events around each call: a first run counts the steps, the timed
    run takes exactly that many with no host read between them.  Returns
    (ms per step by part, steps, the chunk's buffers)."""
    import torch

    from nutpie_tpu_torch.sampler.run import CUDA_UNROLL

    st, bufs, steps = _prepared(cfg, sched, states, start, chunk, True)
    z_new, carry = steps.begin(st)
    n_steps = 0
    while True:
        logp, grad = model.logp_and_grad(z_new)
        st, z_new, carry = steps.advance(st, z_new, carry, logp, grad)
        n_steps += 1
        if n_steps % CUDA_UNROLL == 0 and bool(st.done.all()):
            break
    est, ebufs, esteps = _prepared(cfg, sched, states, start, chunk, True)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(n_steps)]
    z_new, carry = esteps.begin(est)
    torch.cuda.synchronize()
    for ev in marks:
        ev[0].record()
        logp, grad = model.logp_and_grad(z_new)
        ev[1].record()
        est, z_new, carry = esteps.advance(est, z_new, carry, logp, grad)
        ev[2].record()
    torch.cuda.synchronize()
    assert bool(est.done.all()) and bitwise_equal(ebufs.position, bufs.position)
    ms = {part: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / n_steps
          for i, part in enumerate(("logp_grad", "advance"))}
    return ms, n_steps, bufs


def _device_step_ms(model, cfg, sched, states, chunk: int, max_steps: int) -> dict:
    """K2's advance and the logp+grad call per machine step by device time
    under ``torch.profiler``, over the first ``max_steps`` steps of the same
    chunk (a host that falls behind the card stretches an event pair, not a
    kernel's device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st, _, steps = _prepared(cfg, sched, states, 0, chunk, True)
    z_new, carry = steps.begin(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(max_steps):
            logp, grad = model.logp_and_grad(z_new)
            st, z_new, carry = steps.advance(st, z_new, carry, logp, grad)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    k2 = sum(r[0] for r in rows if _is_k2(r[1]))
    dev = {"advance": k2, "logp_grad": sum(r[0] for r in rows) - k2}
    return {k: 1e3 * v / max_steps for k, v in dev.items()}


def _plain_step_ms(model, cfg, sched, states, chunk: int, max_steps: int) -> dict:
    """The plain advance per machine step by CUDA events after a
    synchronize, over the first ``max_steps`` steps of the same chunk."""
    import torch

    st, _, plain = _prepared(cfg, sched, states, 0, chunk, True, plain=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    total, n = 0.0, 0
    z_new, carry = plain.begin(st)
    while n < max_steps and not bool(st.done.all()):
        logp, grad = model.logp_and_grad(z_new)
        torch.cuda.synchronize()
        ev[0].record()
        st, z_new, carry = plain.advance(st, z_new, carry, logp, grad)
        ev[1].record()
        torch.cuda.synchronize()
        total += ev[0].elapsed_time(ev[1])
        n += 1
    return {"advance": total / n, "steps": n}


def _bmm_metric_ms(basis, reps: int = 50) -> float:
    """The library yardstick of the branch's metric part: one application of
    the basis products for every chain, w^T U and then U c, as two
    ``torch.bmm`` calls ([C, 1, dim] x [C, dim, R] and [C, 1, R] x [C, R,
    dim]), ms by CUDA events.  The port never calls it."""
    import torch

    n_chains, dim, _ = basis.shape
    w = torch.randn((n_chains, 1, dim), dtype=basis.dtype, device=basis.device)
    ut = basis.transpose(1, 2)

    def apply():
        torch.bmm(torch.bmm(w, basis), ut)

    apply()
    torch.cuda.synchronize()
    return _event_ms(apply, reps)[0]


def lowrank_step_timing(ctx):
    """K2 at the low-rank path's shapes (1024 chains, dim 1000, float32,
    one frozen 16-draw chunk from the float32 parity fleet) with R = 32 and
    with R = 0 (the same fleet without its low-rank metric), beside the
    logp+grad call, the byte bound, the plain halves and the library
    yardstick of the metric part: two ``torch.bmm`` calls per application
    for every chain (``_bmm_metric_ms``) times the kernel's applications a
    step, counted in whole fleets (two per leapfrog of an active chain, two
    per draw's start)."""
    from nutpie_tpu_torch.sampler.nuts import NutsConfig
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    model, cfg, sched, states = ctx["lr_fleet"]
    chunk = LR_F32_CHUNK
    plan = step_kernel.plan(LR_CHAINS, LR_DIM, LR_RANK, states.vecs.dtype, DEVICE,
                            aligned=states.lr_basis.data_ptr() % 16 == 0)
    bmm_ms = _bmm_metric_ms(states.lr_basis)
    out = {"plan": dataclasses.asdict(plan), "bmm_ms_per_application": bmm_ms}
    ctx["lr_plan"] = f"{plan.form} by {plan.copy}, {plan.warps} warps a chain, " \
                     f"{plan.smem_bytes} bytes of shared memory a block"
    for tag, c, st in (
            ("rank32", cfg, states),
            ("rank0", dataclasses.replace(cfg, low_rank=None),
             states.replace(lr_basis=None, lr_log_eigs=None))):
        assert isinstance(c, NutsConfig)
        rank = 0 if c.low_rank is None else c.low_rank.max_rank
        ms, n_steps, bufs = _timed_steps(model, c, sched, st, chunk)
        device = _device_step_ms(model, c, sched, st, chunk, LR_DEVICE_STEPS)
        plain = _plain_step_ms(model, c, sched, st, chunk, LR_PLAIN_STEPS)
        work = step_bytes(bufs.scalars, chunk, LR_CHAINS, n_steps, LR_DIM,
                          st.ckpt_p.shape[1], 4, rank=rank,
                          streamed=plan.form == "streamed")
        t_bytes = 1e3 * work["advance_bytes"] / PEAK_BYTES / n_steps
        t_ops = 1e3 * step_ops(work, LR_DIM, rank) / PEAK_F32_OPS / n_steps
        k2_ms = ms["advance"]
        out[tag] = {
            "rank": rank, "machine_steps": n_steps, "k2_advance_ms_per_step": k2_ms,
            "logp_grad_ms_per_step": ms["logp_grad"],
            "k2_advance_device_ms_per_step": device["advance"],
            "logp_grad_device_ms_per_step": device["logp_grad"],
            "device_steps": LR_DEVICE_STEPS,
            "plain_advance_ms_per_step": plain["advance"], "plain_machine_steps": plain["steps"],
            "bytes_per_step": work["advance_bytes"] / n_steps, "bytes_bound_ms_per_step": t_bytes,
            "ops_bound_ms_per_step": t_ops, "share_of_bound": max(t_bytes, t_ops) / k2_ms,
            "share_of_bound_device": max(t_bytes, t_ops) / device["advance"],
            **{k: v for k, v in work.items() if k != "bytes"},
        }
        if tag == "rank32":
            out[tag]["unroll_chunk_ms"], out[tag]["unroll_machine_steps"] = _unroll_sweep(
                model, c, sched, st, chunk)
            apps = (2 * work["leapfrogs"] + 2 * (work["draws"] - LR_CHAINS)) / LR_CHAINS
            library = bmm_ms * apps / n_steps
            out[tag].update(metric_applications_per_step=apps / n_steps,
                            library_metric_ms_per_step=library)
            ctx.update(lr_step_ms=k2_ms, lr_step_device_ms=device["advance"],
                       lr_step_plain_ms=plain["advance"],
                       lr_step_bound_ms=max(t_bytes, t_ops), lr_library_ms=library,
                       lr_step_bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "step_timing_lowrank", "chains": LR_CHAINS, "dim": LR_DIM,
          "chunk": chunk, "dtype": "float32", **out, "card": ctx["card"]})


# ---------------------------------------------------------------- options path


# K1's float64 cases on radon (NutsConfig fields, AdaptConfig fields): the
# step-size methods and the target integration time, and the four settings
# with branches of their own (SETTINGS)
K1_OPTIONS = {
    "adam": ({}, {"method": "adam"}),
    "fixed_step": ({}, {"method": 0.05}),
    "target_time": ({"target_time": 0.3, "extra_doublings": 1}, {}),
    **SETTINGS,
}
# K2's float64 cases on the GLM at full width; on the centered eight
# schools with the divergence rows (a divergence at an energy error above
# 10, so that 8 draws of 16 chains have some), under the diagonal and the
# low-rank metric; Adam under the low-rank metric on the 40-d Gaussian
K2_GLM_OPTIONS = {
    "adam": ({}, {"method": "adam"}),
    "fixed_step": ({}, {"method": 0.05}),
    "target_time": ({"target_time": 0.5, "extra_doublings": 1}, {}),
}
OPTIONS_CHAINS, OPTIONS_DRAWS = 16, 8
DIV_STATS = ("divergence_start", "divergence_end", "divergence_momentum",
             "divergence_start_gradient")
# the options phase's fixed step size for radon: the main phase's final
# posterior step size, pooled over the chains at each chunk's start, read
# as its "posterior_step_size" median 0.3294 (min 0.2321, max 0.4210 over
# the draws before the first posterior pooling) on an H100 80GB HBM3 at
# 700 W
RADON_FIXED_EPS = 0.33
# its target integration time, 6 steps: the ratio sits away from a power of
# two, where float32's exp(log(eps)) could tip the ceil either way, so
# every posterior draw runs ceil(log2 6) + 1 = 4 doublings, 15 leapfrogs
RADON_TARGET_STEPS, RADON_EXTRA_DOUBLINGS = 6, 1
# the GLM run with the divergence rows: bench_glm.py's width, draws cut
# from 300 to 100 to keep its host copies near 5 GB (five [10,240, 400, 64]
# float32 arrays)
GLM_DIV_DRAWS = 100


def _assert_rows_where_diverged(tag, bufs) -> None:
    """Each written draw's divergence rows finite exactly where it diverged."""
    import torch

    written = ~torch.isnan(bufs.scalars[..., 0])
    for name in DIV_STATS:
        finite = torch.isfinite(getattr(bufs, name)).all(-1)
        assert torch.equal(finite[written], bufs.diverging[written]), \
            f"{tag} {name}: finite rows differ from the divergent draws"


def _check_div_rows(tag, b_k, b_p, rtol, atol) -> None:
    """The divergence buffers of the kernel against the plain version's,
    and finite exactly where the kernel's draw diverged."""
    for name in DIV_STATS:
        assert_close(f"{tag} {name}", getattr(b_k, name), getattr(b_p, name), rtol, atol)
    _assert_rows_where_diverged(tag, b_k)


def _option_case(failed, tag, both, model, cfg, sched, states, n, div=False) -> dict:
    """One option through a kernel and its plain version (``both``): an
    ``n``-draw warmup window from ``states``, then an ``n``-draw frozen
    chunk from the kernel's state; float64 bars of the parity phases."""
    (s_k, b_k), (s_p, b_p) = both(model, cfg, sched, states, 0, n, n, False)
    warm = _held(failed, _check_warmup_f64, f"{tag} warmup window", n, s_k, b_k, s_p, b_p)
    (f_k, fb_k), (f_p, fb_p) = both(model, cfg, sched, s_k, n, n, n, True)
    frozen = _held(failed, _check_frozen_f64, f"{tag} frozen chunk", f_k, fb_k, f_p, fb_p)
    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    scal = fb_k.scalars
    out = {"warmup_held": warm is not None, "frozen_held": frozen is not None,
           "max_abs_err_position": max_abs(fb_k.position, fb_p.position),
           "max_depth": int(scal[..., SCALAR_SLOTS["depth"]].nan_to_num(0).max()),
           "step_size_bar": float(scal[..., SCALAR_SLOTS["step_size_bar"]].nanmean())}
    if div:
        before = len(failed)
        _held(failed, _check_div_rows, f"{tag} warmup window", b_k, b_p, 1e-3, 1e-3)
        _held(failed, _check_div_rows, f"{tag} frozen chunk", fb_k, fb_p, 1e-6, 1e-8)
        out.update(div_rows_held=len(failed) == before,
                   divergent_draws=int(b_k.diverging.sum() + fb_k.diverging.sum()))
    return out


def _with_div_rows(states):
    """A state with the four divergence rows appended (NaN, as at a draw's
    start)."""
    import torch

    C, _, dim = states.vecs.shape
    nan = torch.full((C, 4, dim), math.nan, dtype=states.vecs.dtype, device=states.vecs.device)
    return states.replace(vecs=torch.cat([states.vecs, nan], dim=1).contiguous())


def _init(model, cfg, n_chains, dtype, seed):
    import numpy as np

    from nutpie_tpu_torch.sampler.run import init_chains

    states, ok = init_chains(model, cfg, seed, n_chains, np.zeros(model.ndim), dtype,
                             device=DEVICE)
    assert bool(ok.all()), "chain initialization failed"
    return states


def phase_options_parity(ctx):
    """Each kernel against its plain version with the options on (float64,
    16 chains, maxdepth 6, an 8-draw warmup window then an 8-draw frozen
    chunk): K1 on
    radon in ``K1_OPTIONS``; K2 on the GLM in ``K2_GLM_OPTIONS``, on the
    centered eight schools with the divergence rows (their buffers too)
    under the diagonal and the low-rank metric, and under the low-rank
    metric with Adam.  Then, at the GLM's main
    shapes in float32 from the warmed fleet, one frozen 32-draw chunk with
    the divergence rows against the plain version (the float32 shares), and
    K2's advance a step with and without them; and K1's posterior chunk
    (the timing phase's) under Adam's configuration beside the default's."""
    import dataclasses as dc

    import torch

    from nutpie_tpu_torch.models import eight_schools, ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.nuts import LowRankConfig, NutsConfig
    from nutpie_tpu_torch.sampler.run import draw_randoms

    failed, n = [], OPTIONS_DRAWS
    f64 = torch.float64

    # maxdepth 6 bounds the plain version's machine steps in a fresh
    # fleet's warmup (the target time's limit still binds below it)
    def config(nuts, adapt, tune=TUNE, **extra):
        cfg = NutsConfig(**{"maxdepth": 6, **nuts}, adapt=AdaptConfig(num_tune=tune, **adapt),
                         **extra)
        return cfg, make_schedule(cfg.adapt, tune, cfg.initial_depth_cap)

    radon_model = _setup(0, f64, 0)[0]
    k1 = {}
    for tag, (nuts, adapt) in K1_OPTIONS.items():
        cfg, sched = config(nuts, adapt)
        states = _init(radon_model, cfg, OPTIONS_CHAINS, f64, 31)
        k1[tag] = _option_case(failed, f"K1 {tag}", _run_both, radon_model, cfg, sched,
                               states, n)
    glm = _glm_model()
    k2 = {}
    for tag, (nuts, adapt) in K2_GLM_OPTIONS.items():
        cfg, sched = config(nuts, adapt, GLM_TUNE)
        states = _init(glm, cfg, OPTIONS_CHAINS, f64, 33)
        k2[f"glm_{tag}"] = _option_case(failed, f"K2 GLM {tag}", _steps_both, glm, cfg,
                                        sched, states, n)
    eight = eight_schools(centered=True)
    cfg, sched = config({"store_divergences": True, "max_energy_error": 10.0}, {}, GLM_TUNE)
    k2["eight_schools_store_divergences"] = _option_case(
        failed, "K2 eight schools divergence rows", _steps_both, eight, cfg, sched,
        _init(eight, cfg, OPTIONS_CHAINS, f64, 35), n, div=True)
    gauss = ill_conditioned_gaussian(dim=40)
    cfg, sched = config({}, {"method": "adam"}, GLM_TUNE, low_rank=LowRankConfig())
    k2["low_rank_adam"] = _option_case(failed, "K2 low-rank Adam", _steps_both, gauss, cfg,
                                       sched, _init(gauss, cfg, OPTIONS_CHAINS, f64, 37), n)
    cfg, sched = config({"store_divergences": True, "max_energy_error": 10.0}, {}, GLM_TUNE,
                        low_rank=LowRankConfig())
    k2["low_rank_store_divergences"] = _option_case(
        failed, "K2 low-rank divergence rows", _steps_both, eight, cfg, sched,
        _init(eight, cfg, OPTIONS_CHAINS, f64, 39), n, div=True)

    # float32 at the GLM's main shapes with the divergence rows
    model32, cfg32, sched32, warm32 = ctx["glm_warm"]
    div32 = dc.replace(cfg32, store_divergences=True)
    warm_div = _with_div_rows(warm32)
    (d_k, db_k), (_, db_p) = _steps_both(model32, div32, sched32, warm_div, GLM_TUNE,
                                         GLM_CHUNK, GLM_CHUNK, True)
    f32 = _f32_shares(GLM_CHUNK, d_k, db_k, db_p)
    f32["divergent_draws"] = int(db_k.diverging.sum())
    _held(failed, _assert_rows_where_diverged, "float32 GLM", db_k)
    del d_k, db_k, db_p
    timed = [_timed_steps(model32, c, sched32, st, GLM_CHUNK, GLM_TUNE)
             for c, st in ((cfg32, warm32), (div32, warm_div), (cfg32, warm32))]
    (base_ms, base_steps, _), (div_ms, div_steps, div_bufs), (base2_ms, _, _) = [
        (ms["advance"], n, b) for ms, n, b in timed]
    div_work = step_bytes(div_bufs.scalars, GLM_CHUNK, GLM_CHAINS, div_steps, GLM_DIM,
                          warm32.ckpt_p.shape[1], 4, div_rows=True)
    div_bound = 1e3 * div_work["advance_bytes"] / PEAK_BYTES / div_steps

    # K1's posterior chunk under Adam's configuration (the same work: the
    # branch acts in tuning draws only) beside the default's
    rmodel, rcfg, rsched, rstates = ctx["warm32"]
    mom, jit = draw_randoms(rstates.key, TUNE, CHUNK, rmodel.ndim, torch.float32)
    adam_cfg = dc.replace(rcfg, adapt=dc.replace(rcfg.adapt, method="adam"))

    def k1_once(c):
        return lambda: chunk_kernel(c, rmodel, rsched, TUNE, CHUNK, rstates, mom, jit, True)

    k1_once(rcfg)()
    k1_default_ms, outs = _event_ms(k1_once(rcfg), 3)
    k1_adam_ms, outs_adam = _event_ms(k1_once(adam_cfg), 3)
    _assert_repeatable(outs + outs_adam)
    del outs, outs_adam

    geo = ctx["k2_geometry"]
    ctx["options_timing"] = {
        "k2_glm_advance_ms_per_step": {"default": [base_ms, base2_ms],
                                       "store_divergences": div_ms,
                                       "machine_steps": [base_steps, div_steps],
                                       "store_divergences_bound_ms": div_bound,
                                       "store_divergences_bound_by": "bytes",
                                       "divergent_draws": div_work["divergent_draws"]},
        "k1_posterior_chunk_ms": {"default": k1_default_ms, "adam_config": k1_adam_ms},
        "k2_div_instantiation": {dt: {f"{form}_{k}": geo[dt][f"div_{form}_{k}"]
                                      for form in ("held", "strided")
                                      for k in ("registers", "local_bytes")}
                                 for dt in geo},
    }
    emit({"phase": "options_parity", "chains": OPTIONS_CHAINS, "draws": n, "dtype": "float64",
          "k1_radon": k1, "k2": k2,
          "glm_f32_store_divergences": {"chains": GLM_CHAINS, "draws": GLM_CHUNK,
                                        "tol": F32_TOL, **f32},
          **ctx["options_timing"], "failed": failed, "card": ctx["card"]})
    assert not failed, failed
    assert f32["share_equal_n_steps"] >= F32_MIN_SHARE_STEPS, f32
    assert f32["share_draws_within_tol"] >= F32_MIN_SHARE_DRAWS, f32


def _radon_run(**kwargs):
    """``sample()`` on radon at the main phase's configuration with
    ``kwargs`` on top, K1's launch count set to 0 just before: (raw trace,
    wall s, K1 launches, K2 launches)."""
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    compiled = compile_model_def(nt.models.radon())
    torch.cuda.synchronize()
    _zero_counts(step_kernel, chunk_kernel)
    t0 = time.perf_counter()
    raw = nt.sample(compiled, chains=CHAINS, tune=TUNE, draws=DRAWS, seed=42,
                    pool_mass_matrix=True, pool_step_size=True, device=DEVICE,
                    return_raw_trace=True, **kwargs)
    torch.cuda.synchronize()
    return raw, time.perf_counter() - t0, chunk_kernel.launches, step_kernel.launches


def _readings(raw, wall, tune, columns) -> dict:
    """Wall, gradients/s, min bulk ESS (and per s and per gradient), max
    split R-hat over ``columns`` and the posterior divergences of a run."""
    import numpy as np

    grads = int(raw["stats"]["n_steps"].astype(np.int64).sum())
    ess, rhat = column_diagnostics(raw["position"][:, tune:, :], columns)
    min_ess = float(np.min(ess))
    return {"wall_s": wall, "gradients": grads, "grads_per_s": grads / wall,
            "min_bulk_ess": min_ess, "min_ess_per_s": min_ess / wall,
            "min_ess_per_grad": min_ess / grads, "max_rhat": float(max(rhat)),
            "posterior_divergences": int(raw["stats"]["diverging"][:, tune:].sum())}


def phase_options(ctx):
    """The options through ``sample()`` on the card at full width: radon
    with Adam through K1; radon with a fixed step and a target integration
    time (the U-turn check off) through K1; the GLM with the divergence
    rows through K2."""
    import numpy as np

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.models.analytic import glm_data
    from nutpie_tpu_torch.sample import nuts_config_from_settings, route
    from nutpie_tpu_torch.sampler.run import CUDA_UNROLL
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel
    from nutpie_tpu_torch.settings import NutsSettings

    def routed(model, **kwargs):
        settings = NutsSettings.Diag(42)
        settings.update(kwargs)
        return route(nuts_config_from_settings(settings), model)

    n_chunks = math.ceil((TUNE + DRAWS) / CHUNK)
    radon_model = nt.models.radon()

    # 1. Adam through K1.  The JAX package's Adam collapses radon's step
    # size in warmup (scripts/adam_radon_reference.py: the matched shift
    # after each growth of the mass matrix outpaces Adam's capped rise), so
    # the posterior does not mix in 300 draws and its R-hat is read, not
    # held to 1.05; the step's collapse is held (below a tenth of dual
    # averaging's), as the reference takes it
    adam = dict(step_size_adapt_method="adam")
    assert routed(radon_model, **adam) == "megakernel"
    raw, wall, k1, k2 = _radon_run(**adam)
    assert (k1, k2) == (n_chunks, 0), f"K1 {k1}, K2 {k2} launches for {n_chunks} chunks"
    assert np.isfinite(raw["position"]).all(), "non-finite draws"
    adam_readings = _readings(raw, wall, TUNE, MONITORED)
    adam_readings["posterior_step_size"] = float(np.median(raw["stats"]["step_size"][:, TUNE:]))
    del raw
    emit({"phase": "options", "run": "radon_adam", "chains": CHAINS, "tune": TUNE,
          "draws": DRAWS, "dtype": "float32", "route": "megakernel", "k1_launches": k1,
          **adam_readings, "dual_averaging": ctx["main_readings"], "card": ctx["card"]})
    assert adam_readings["posterior_step_size"] < 0.1 * ctx["main_readings"]["step_size"], \
        adam_readings

    # 2. a fixed step and a target integration time through K1
    fixed = dict(step_size_adapt_method=RADON_FIXED_EPS, check_turning=False,
                 target_integration_time=RADON_TARGET_STEPS * RADON_FIXED_EPS,
                 extra_doublings=RADON_EXTRA_DOUBLINGS)
    assert routed(radon_model, **fixed) == "megakernel"
    raw, wall, k1, k2 = _radon_run(**fixed)
    assert (k1, k2) == (n_chunks, 0), f"K1 {k1}, K2 {k2} launches for {n_chunks} chunks"
    depth = raw["stats"]["depth"][:, TUNE:]
    steps = raw["stats"]["n_steps"][:, TUNE:]
    diverging = raw["stats"]["diverging"][:, TUNE:]
    eps = raw["stats"]["step_size"][:, TUNE:]
    fixed_readings = _readings(raw, wall, TUNE, MONITORED)
    del raw
    emit({"phase": "options", "run": "radon_fixed_target_time", "chains": CHAINS,
          "tune": TUNE, "draws": DRAWS, "dtype": "float32", "route": "megakernel",
          "k1_launches": k1, "fixed_step": RADON_FIXED_EPS,
          "posterior_step_size": [float(eps.min()), float(eps.max())],
          "target_integration_time": fixed["target_integration_time"],
          "extra_doublings": RADON_EXTRA_DOUBLINGS,
          "posterior_depths": sorted(int(d) for d in np.unique(depth)),
          "posterior_n_steps": sorted(int(d) for d in np.unique(steps)),
          "posterior_divergent_draws": int(diverging.sum()), **fixed_readings,
          "card": ctx["card"]})
    # a divergent draw ends its tree early; every other runs the full limit:
    # 4 doublings of 1, 2, 4 and 8 leapfrogs
    kept = ~diverging
    assert (depth[kept] == 4).all() and (steps[kept] == 15).all(), \
        f"posterior depths {np.unique(depth[kept])}, step counts {np.unique(steps[kept])}"

    # 3. the GLM with the divergence rows through K2
    compiled = compile_model_def(_glm_model())
    div = dict(store_divergences=True)
    assert routed(compiled._make_model(0), **div) == "step"
    import torch

    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel

    torch.cuda.synchronize()
    _zero_counts(step_kernel, chunk_kernel)
    t0 = time.perf_counter()
    raw = nt.sample(compiled, chains=GLM_CHAINS, tune=GLM_TUNE, draws=GLM_DIV_DRAWS,
                    seed=42, chunk_size=GLM_CHUNK, precision="float32", device=DEVICE,
                    return_raw_trace=True, **div)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k1 = step_kernel.launches, chunk_kernel.launches
    n_steps = raw["stats"]["n_steps"]
    msteps = machine_steps(n_steps, GLM_CHUNK, CUDA_UNROLL)
    chunks = math.ceil((GLM_TUNE + GLM_DIV_DRAWS) / GLM_CHUNK)
    assert k1 == 0, f"the chunk kernel launched {k1} times on the GLM path"
    _assert_step_launches(step_kernel, chunks, msteps, CUDA_UNROLL)
    stats = raw["stats"]
    diverging = stats["diverging"]
    shape = (GLM_CHAINS, GLM_TUNE + GLM_DIV_DRAWS, GLM_DIM)
    for name in DIV_STATS:
        assert stats[name].shape == shape, (name, stats[name].shape)
        assert np.array_equal(np.isfinite(stats[name]).all(-1), diverging), name
        assert np.array_equal(np.isnan(stats[name]).all(-1), ~diverging), name
    assert (stats["divergence_message"][diverging] != "").all()
    pos = raw["position"]
    assert np.isfinite(pos).all(), "non-finite draws"
    glm_readings = _readings(raw, wall, GLM_TUNE, GLM_MONITORED)
    post = pos[:, GLM_TUNE:, :]
    X, y = glm_data(GLM_N_DATA, GLM_DIM)
    mode, cov = laplace(X, y)
    sd = np.sqrt(np.diag(cov))
    mean = post.reshape(-1, GLM_DIM).mean(axis=0, dtype=np.float64)
    dev = np.abs(mean - mode) / sd
    is_mean, _ = importance_mean(X, y, mode, cov)
    is_dev = np.abs(mean - is_mean) / sd
    divergent = int(diverging.sum())
    del raw, stats, pos, post
    emit({"phase": "options", "run": "glm_store_divergences", "chains": GLM_CHAINS,
          "tune": GLM_TUNE, "draws": GLM_DIV_DRAWS, "dim": GLM_DIM, "chunk_len": GLM_CHUNK,
          "dtype": "float32", "route": "step", "step_kernel_launches": k2,
          "chunk_kernel_launches": k1, "machine_steps": msteps, "chunks": chunks,
          "graph_replays": step_kernel.replays, "capture_s": step_kernel.capture_s,
          "host_wall_ms_per_machine_step": 1e3 * wall / msteps,
          "divergent_draws": divergent, **glm_readings,
          "laplace_max_dev_sd": float(dev.max()),
          "importance_mean_max_dev_sd": float(is_dev.max()),
          "k2_div_instantiation": ctx["options_timing"]["k2_div_instantiation"],
          "card": ctx["card"]})
    assert glm_readings["max_rhat"] < 1.05, glm_readings
    assert is_dev.max() <= IMPORTANCE_SD_TOL, \
        f"posterior mean {is_dev.max()} sd from the importance-sampled mean"
    assert dev.max() <= LAPLACE_SD_TOL, f"posterior mean {dev.max()} sd from the Laplace mode"


PHASES = {
    "build": phase_build,
    "parity": phase_parity,
    "step_parity": phase_step_parity,
    "lowrank_parity": phase_lowrank_parity,
    "main": phase_main,
    "glm": phase_glm,
    "lowrank": phase_lowrank,
    "warmup": phase_warmup,
    "timing": phase_timing,
    "step_timing": phase_step_timing,
    "options_parity": phase_options_parity,
    "options": phase_options,
    "profile": phase_profile,
}
# phases whose results a later phase reads
NEEDS = {"timing": ("warmup",), "step_timing": ("step_parity", "lowrank_parity"),
         "options_parity": ("warmup", "step_parity"), "options": ("main", "options_parity", "warmup", "step_parity")}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset, for a quick check; a "
                             "partial run prints no result line")
    args = parser.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import nutpie_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: nutpie_tpu_torch not found beside the script ({err})",
              file=sys.stderr)
        return 3

    start = time.perf_counter()
    ctx: dict = {}
    asked = {p for p in args.phases.split(",") if p}
    asked |= {"build"} | {n for p in asked for n in NEEDS.get(p, ())}
    phases = [p for p in PHASES if p in asked]
    # every phase runs, so one call reads them all; any failure fails the run
    failed, seconds = [], {}
    for name in phases:
        t0 = time.perf_counter()
        try:
            PHASES[name](ctx)
        except Exception:
            traceback.print_exc()
            print(f"chip_smoke: phase {name} failed", file=sys.stderr, flush=True)
            failed.append(name)
        seconds[name] = round(time.perf_counter() - t0, 1)
    emit({"phase_seconds": seconds, "total_s": round(time.perf_counter() - start, 1)})
    if failed:
        print(f"chip_smoke: failed phases {failed}; no result line", file=sys.stderr)
        return 1

    full = len(phases) == len(PHASES)
    if full:
        from nutpie_tpu_torch.sampler.megakernel import chunk_kernel

        from nutpie_tpu_torch.sampler.step_kernel import step_kernel

        emit({"kernels": [{
            "name": chunk_kernel.name,
            "route": "cuda",
            "source": chunk_kernel.source,
            "replaces": chunk_kernel.replaces,
            "launches": ctx["launches"],
            "max_abs_err": ctx["max_abs_err"],
            "ms": ctx["ms"],
            "plain_ms": ctx["plain_ms"],
            "bound_ms": ctx["bound_ms"],
            "bound_by": ctx["bound_by"],
            "library_ms": None,
            "resident_chains_per_sm": ctx["geometry"]["float32"]["resident_chains_per_sm"],
            "ms_per_chunk": ctx["ms"],
            "plain_ms_per_chunk": ctx["plain_ms"],
            "options_ms_per_chunk": ctx["options_timing"]["k1_posterior_chunk_ms"],
            "parity": "ok",
        }, {
            "name": step_kernel.name,
            "route": "cuda",
            "source": step_kernel.source,
            "replaces": step_kernel.replaces,
            "launches": ctx["glm_launches"],
            "max_abs_err": ctx["step_max_abs_err"],
            "ms": ctx["step_ms"],
            "plain_ms": ctx["step_plain_ms"],
            "bound_ms": ctx["step_bound_ms"],
            "bound_by": ctx["step_bound_by"],
            "library_ms": None,
            "ms_per_machine_step": ctx["step_ms"],
            "device_ms": ctx["step_device_ms"],
            **ctx["glm_graphs"],
            "plan": ctx["glm_plan"]["float32"],
            "parity": "ok",
            "options_ms_per_machine_step": ctx["options_timing"]["k2_glm_advance_ms_per_step"],
            "divergence_rows_instantiation": ctx["options_timing"]["k2_div_instantiation"],
            "low_rank_branch": {
                "shapes": f"{LR_CHAINS} chains, dim {LR_DIM}, rank {LR_RANK}, float32",
                "plan": ctx["lr_plan"],
                "launches": ctx["lr_launches"],
                **ctx["lr_graphs"],
                "max_abs_err": ctx["lr_max_abs_err"],
                "ms": ctx["lr_step_ms"],
                "device_ms": ctx["lr_step_device_ms"],
                "plain_ms": ctx["lr_step_plain_ms"],
                "bound_ms": ctx["lr_step_bound_ms"],
                "bound_by": ctx["lr_step_bound_by"],
                "library_ms": ctx["lr_library_ms"],
                "library": "two torch.bmm per metric application, times the applications "
                           "a step (the metric part only)",
                "parity": "ok",
            },
        }]})
    print(ctx["card"], flush=True)
    if not full:
        print("chip_smoke: partial run (--phases); no result line", file=sys.stderr)
        return 4
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
