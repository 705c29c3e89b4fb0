#!/usr/bin/env python3
"""Quickest proof that the torch port runs on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one JSON line):

1. ``build``: torch version, the card's name and power limit, and the
   build of the chunk kernel (``nutpie_tpu_torch/csrc/megakernel.cu``)
   from the sources in the checkout with ``nvcc``, its registers and
   spill bytes (any spill fails).  The libraries of the step kernel
   (``csrc/step_kernel.cu``: float32, float64 and its device query) and
   of the MCLMC kernel (``csrc/mclmc.cu``) start to compile beside it, one
   ``nvcc`` process each, while the phases that run K1 alone (``parity``,
   ``main``, ``warmup``, ``timing``) run; ``build_steps``, after them,
   waits for those builds and prints each one's seconds, their registers
   and spill bytes (any spill of K2 in either dtype fails, and of K3 in
   float32), and the step kernel's low-rank plan at the low-rank path's
   shapes in both dtypes, whose shared memory must be what the kernel
   lays out.
2. ``parity``: the kernel against its plain torch version on the card, on
   radon at full width (173 parameters, 919 observations), 64 chains:
   one fresh warmup chunk of ``PARITY_CHUNK`` draws in float64 (ints, step
   counts and Welford counts exact; positions to rtol 1e-3), one frozen
   chunk of as many draws from the state that follows (ints exact; floats
   to rtol 1e-6, atol 1e-8), and one fresh float32 warmup chunk (finite; shares of equal
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
   ``sample()``.  Float64 from a fresh fleet, windows of 2 draws: ints,
   step counts and Welford counts exact, positions and adaptation state
   to rtol 1e-3.  Float32 from another fresh fleet, windows of 2 draws:
   finite draws and adaptation state, and per window the shares of
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
   float64 over the chunk's first ``TIMING_F64_DRAWS`` draws, ints exact
   and floats to rtol 1e-6 / atol 1e-8 (the float64 chunk timed whole).
6. ``profile``: the main path once more under ``torch.profiler``: device
   time by kernel and the device's idle share of the wall time, the
   device-to-host copies into pinned and pageable memory and the seconds
   of them that run under K1 (and under any kernel), beside the readings
   of the single-buffered loop that preceded the background one (same
   card and configuration); then the
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
   fresh ``GLM_F64_WARM``-draw warmup window from draw 0 (ints, step counts
   and Welford counts exact, positions and adaptation state to rtol 1e-3),
   then a ``GLM_F64_FROZEN``-draw frozen chunk (ints exact, floats to rtol
   1e-6 / atol 1e-8).
   Float64 ``ill_conditioned_gaussian(dim=1000)``, 16 chains, a frozen
   chunk of ``ILL_DRAWS``: ints and step counts exact (lanes stride past
   256 coordinates).  Float64 eight schools, 16 chains, in each of four
   settings with branches of their own (``SETTINGS``: step size jitter,
   ``mindepth`` 3, no U-turn check, the draw-based mass matrix): a
   warmup window and a frozen chunk of ``SETTINGS_DRAWS`` each at those
   bars.  Beside
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
8b. ``distributed``: the main paths through ``nutpie_tpu_torch.parallel``
   in a one-rank NCCL group (``initialize_distributed`` with a
   ``tcp://127.0.0.1`` store on ``cuda:0``; the card host has one card):
   radon through K1 at the main phase's settings (2048 chains, seed 42,
   pooled, chunk 128, float32), 300 + ``DIST_DRAWS`` draws, its raw trace
   bitwise the main phase's first draws and its fleet depth cap the main
   phase's; the GLM through K2 (10,240 chains x (``DIST_GLM_TUNE`` +
   ``DIST_GLM_DRAWS``) in chunks of ``DIST_GLM_CHUNK``, pooled), bitwise
   the same run made before the group existed.  Prints the backend, world size, NCCL's version, the
   collectives' calls, bytes and seconds (CUDA events) a chunk boundary,
   and the phase's seconds; the group is destroyed at its end.
9. ``step_timing``: one frozen 32-draw chunk at the GLM main shapes, step
   by step, launched one by one: K2's ``advance`` and the logp+grad call
   by CUDA events around each call (and by device time under
   ``torch.profiler``, which splits the logp's matrix products from the
   rest), the plain ``advance`` (finish then begin) by CUDA events, the
   byte bound beside them (``step_bytes``: each row the fused launch
   touches read once and written once) and the diagonal plan with its
   resident chains an SM; then the whole chunk through the runner's
   CUDA graphs at each of ``UNROLLS`` machine steps a graph (host wall,
   and the machine steps each ran).  Then the
   same for K2's low-rank branch at the low-rank path's shapes (below):
   one frozen ``LR_F32_CHUNK``-draw chunk of the float32 parity fleet, K2 with R = 32
   and with R = 0 (the same fleet without its metric), the logp+grad
   call by CUDA events (and over the first ``LR_DEVICE_STEPS`` steps by
   device time under ``torch.profiler``, reported beside them), the plain
   ``advance`` over its first ``LR_PLAIN_STEPS`` steps, the
   byte bound with each machine step reading the chain's basis once, the basis
   bytes as the plan's form reads them, the plan (form, warps, shared
   memory) and the library yardstick of the metric part (two
   ``torch.bmm`` per application for every chain, times the applications
   a step; by CUDA events and by device time, each reported beside K2's time
   by the same timer).

K2's low-rank branch (``adaptation="low_rank"``) on the 1000-d
ill-conditioned Gaussian (``nutpie_tpu/models/analytic.py:166``,
BASELINE's 1000-d target) at 1024 chains (the path's own run at
``LR_PATH_CHAINS``), max_rank 32, chunk 80:

10. ``lowrank_parity``: K2 against its plain halves on the card.  Float64,
    16 chains, metrics from the port's ``estimate_low_rank`` on each
    chain's window of exact posterior draws and gradients, one case for
    each form of ``step_kernel.low_rank_plan`` (``LR_F64_CASES``): the
    path's shapes (dim 1000, R 32, 256,000 bytes a basis: streamed) with a
    cutoff that keeps all 32 slots and with the default 100, under which
    this target keeps none (the branch's arithmetic on an all-padded
    metric); dim 500, R 32 (staged by TMA); dim 33, R 5 with two slots
    padded (660 bytes a basis, not 16-byte aligned: staged by loads).  Each
    runs a warmup window from draw 0 (2 draws; the last two's trees stop
    at depth 6; ints, step counts and Welford counts exact, floats to
    1e-3), then a frozen chunk (2 draws) (ints exact, floats and the
    stored gradients to rtol 1e-6 / atol 1e-8).  Float32 at the main
    shapes, one frozen ``LR_F32_CHUNK``-draw chunk: at least
    99.9% of step counts equal and 99% of draws within 1e-3 (relative to 1
    + abs x).
11. ``lowrank``: ``sample(adaptation="low_rank")``, ``LR_PATH_CHAINS`` x (300
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

MCLMC and the microcanonical kinetic (the MCLMC kernel K3,
``csrc/mclmc.cu``: a ``begin`` launch a chunk, then a ``kick`` after each
step's midpoint log density and a ``settle`` after its end's, one draw's
launches captured in a CUDA graph and replayed; and K2's MICRO
instantiations for NUTS with ``microcanonical_trajectory=True``):

12a. ``mclmc_parity``: K3 against its plain version
    (``mclmc.PlainMclmcSteps``, with the chunk's normals from
    ``draw_normals``; K3 draws its own) on the card, in each of its forms
    (``mclmc_kernel.mclmc_plan``).  Float64 on the GLM at full width (the
    held form), 64 chains, under a 16-draw tuning schedule with early
    switches every 4 draws (``MCLMC_CASES``: each trajectory kind, three
    steps a draw, a forced divergence at ``max_energy_error`` 0.05): an
    8-draw warmup window from draw 0 across the switch at draw 3 (ints and
    ``diverging`` exact, floats to rtol 1e-3), the kernel's own run to the
    end of tuning, then a 16-draw frozen chunk (ints and ``diverging``
    exact, floats to rtol 1e-6 / atol 1e-8); the same for the strided form
    (``MCLMC_STRIDED_DIM``: the 100-d Gaussian, 16 chains), with and
    without the forced divergence.  Float64
    low-rank frozen chunks (``MCLMC_LR_CASES``, 16 chains): the Gaussian's
    dim 1000 at R 32 (streamed), dim 500 at R 32 (staged by TMA), dim 33 at
    R 5 (staged by loads; again with the forced divergence) and dim 1100 at
    R 8 (staged by TMA, five coordinates a thread).  Float32 at the GLM's main shapes, one frozen
    32-draw chunk, and at the low-rank path's (1024 chains, dim 1000, R 32,
    staged), one frozen ``MCLMC_LR_F32_DRAWS``-draw chunk: at least 99.9%
    of ``diverging`` flags equal and 99% of draws within 1e-3 (relative to
    1 + abs x); the GLM chunk replayed from its graph bitwise equal to its
    launches made one by one, and two runs from one state bitwise equal.
12b. ``mclmc``: ``sample(sampler="mclmc")`` on the GLM, 10,240 chains x
    (``MCLMC_GLM_TUNE`` 1200 + 300; see there why 1200), chunk 32, float32,
    seed 42: K3 launched exactly once a
    chunk and twice a step (every draw from a graph replay), K1 and K2
    never, ``draw_normals`` never called (K3 draws the refresh normals);
    the glm phase's posterior bars.  Then ``adaptation="low_rank"``
    on ``tests/test_mclmc.py``'s correlated Gaussian (dim 8, factor 40) at
    1024 chains with its variance-ratio bar [0.5, 1.5]; then low-rank
    MCLMC on the 1000-d Gaussian, ``LR_PATH_CHAINS`` x (300 + 100), cutoff
    ``LR_CUTOFF``: after the boundary updates at least 90% of chains keep
    a slot; its variance ratios and R-hat are readings.
12c. ``micro``: K2's microcanonical instantiations against the plain
    halves: float64 on the GLM (64 chains; a ``MICRO_GLM_WARM``-draw
    warmup window, see there, and a ``MICRO_FROZEN``-draw frozen chunk, with the CPU's
    plain version over the window beside; a second warmup window of
    ``MICRO_GLM_LATE_WARM`` draws from draw ``MICRO_GLM_LATE``, where the
    trees have left the depth cap, its integers held and its floats read,
    see there), the low-rank cases dim 33 at R
    5 and dim 1000 at R 32 (``MICRO_LR_CASES``) and radon through the step
    route (16 chains), at the parity bars; float32 shares at the GLM's
    main shapes, from the step_parity phase's warmed fleet.
    Then ``sample(microcanonical_trajectory=True)`` on the GLM, 10,240 x
    (300 + ``MICRO_GLM_DRAWS``): K2 launched once a chunk and once a
    machine step, K1 and K3 never, the glm phase's posterior bars, and
    posterior divergences below 1%.
    ``step_timing`` then times K3's kick and settle per step (CUDA events
    and device time) at the GLM's main shapes and the low-rank Gaussian's,
    beside its byte bound (``mclmc_bytes``), its plain pieces and, under
    the low-rank metric, the library yardstick of its metric part (two
    ``torch.bmm`` an application, three applications a step, by events and
    by device time) and the bases read a step as the plan's form reads
    them (counted by construction, not measured), and K2's micro
    ``advance`` at the GLM's.

The options path (every NUTS step-size and depth option and the
divergence rows on the card):

12. ``options_parity``: each kernel against its plain version with the
    options on, float64, 16 chains, maxdepth 6, an ``OPTIONS_DRAWS``-draw
    warmup window then a frozen chunk as long at the parity bars: K1 on radon under Adam, a fixed step,
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

Background sampling (every ``sample()`` call runs the background loop,
double-buffered: chunk k+1 launched and its copies into pinned buffers
started before chunk k is converted):

14. ``control``: radon through K1 at the main configuration with
    ``blocking=False`` and a progress callback: paused at the first
    callback (K1's launch count read 0.2 s after ``pause()`` and again 1 s
    later must not move), resumed, inspected once, waited: the trace is
    bitwise the main phase's, the inspected one bitwise its prefix, the
    last callback 600 draws for every chain; a second run aborted after
    two chunks returns a partial trace bitwise the main phase's prefix
    (the abort's latency printed).  Checkpoint and resume on both routes:
    radon and the GLM (the glm phase's configuration) run 300 + 84 draws
    with ``checkpoint=``, then resume to 300 + 300: the resumed draws and
    statistics bitwise the main and glm phases' last 216 (the
    checkpoint's bytes, save seconds and restored depth cap printed).  A
    busy caller: the GLM cut as the profile phase cuts it, non-blocking,
    while the calling thread runs matrix products on the card; graph
    captures and replays hold and the trace is bitwise the same run made
    blocking.  Host syncs on the K1 route: a radon run under
    ``torch.cuda.set_sync_debug_mode("warn")``, each synchronizing call's
    file:line counted (a reading).  Zarr: radon at the main configuration
    streamed to a ``LocalStore`` in ``/dev/shm`` (else a temporary
    directory) with
    ``return_raw_trace=True``: every array read back with
    ``read_zarr_array`` and through ``open_zarr_trace`` bitwise the raw
    trace, which is bitwise the main phase's prefix (bytes, files, seconds
    and the writer printed; the directory deleted).  That run stores no
    warmup and cuts the draws to ``ZARR_DRAWS`` (see there).

Flow adaptation (the NUTS path through K2 and the MCLMC path through K3,
each under the fixed metric, in each chain's flow base space):

15. ``flow_parity``: K2 under the fixed metric against its plain version
    on the pulled-back log density of ``funnel(dim=101, scale=1.0)`` under
    seeded flows whose couplings act (the gate's flow config), 64 chains,
    float64: a fresh warmup window of ``FLOW_WARM_DRAWS`` (ints, step counts and Welford
    counts exact, floats to 1e-3; the inverse mass stays at ones), then a
    frozen chunk of ``FLOW_FROZEN_DRAWS`` (ints exact, floats to rtol 1e-6 /
    atol 1e-8, the gradients too); the same again with ``use_orbit`` (the orbit rows and
    buffers to the same bars), and with ``use_orbit`` beside the divergence
    rows of ``store_divergences`` (``FLOW_DIV``, 16 chains: a low ``max_energy_error``
    forces divergent draws; the divergence buffers to the same bars, finite
    exactly where a draw diverged); float32 at those shapes (the float32
    fleet's): the fresh warmup window under the warmup phase's early bars,
    then a frozen chunk under the frozen chunks' share bars.  K3 under the
    fixed metric, each chunk through the runner's graph and the flow's
    chunk boundary: on ``std_normal(4, 1, 3)`` under seeded flows at the
    MCLMC flow run's 64 chains, a tuning chunk of ``FLOW_WARM_DRAWS`` from
    draw 0 (where the flag acts: the windows must not run) in float64
    (ints and ``diverging`` exact, floats to K3's warmup bars, rtol 1e-3)
    and in float32 (the run's dtype: K3's float32 share bars); on the
    funnel's 64 chains in float64 (the strided form), a tuning chunk under
    the same bars, the kernel's own run to the end of ``FLOW_K3_TUNE``,
    then a frozen chunk under K3's frozen bars.  ``chunk_flow_update`` on
    the card against the CPU, float64, ``FLOW_TRAIN_STEPS`` Adam steps:
    every output to rtol 1e-6, ``flow_updates`` exact.
16. ``flow``: ``sample(adaptation="flow")`` on the card.  The reference
    gate in float64 (``tests/test_flow.py:242-288``: its model, flow,
    chains, draws, seed and update cadence): 0 divergences, ESS(v) and
    the least ESS over ``x[..., 0:100:10]`` above 1000, the mean Fisher
    distance of the last 200 draws below 0.1, printed beside the JAX
    package's CPU margins (``tests/reference/flow_gate_margins.json``,
    only read).  The same model and flow as a float32 fleet of ``FLOW_FLEET_CHAINS`` chains
    under the float32 recipe: finite draws, v's mean within 0.1 of 0 and
    sd within 0.1 of 1, K2 launched once a chunk and once a machine step
    (all from graph replays), K1 never; divergences, the Fisher tail,
    ESS, ESS/s, gradients/s, the wall, the seconds of each flow training
    and of the captures read.  MCLMC with flow on
    ``tests/test_mclmc.py:98-108``'s Gaussian, 64 chains x (800 + 1000),
    float32, flows trained every ``FLOW_MCLMC_FREQ`` draws: its bars, K3
    launched once a chunk and twice a step.  K2's and K3's fixed-metric
    steps timed (events, device time, the plain version, the byte bound).

The Stan frontend (``compile_stan_model``: the program's interpreter,
batched over chains by ``torch.func.vmap``, captured in the step
runner's CUDA graphs around K2; vmap's per-example fallback warning is an
error for the whole script):

17. ``stan_parity``: float64, ``STAN_PARITY_CHAINS`` chains.  The Stan
    radon (``STAN_RADON``: ``models/radon.py``'s unconstrained layout)
    against ``nt.models.radon()``: its logp equal up to one constant
    (spread under 1e-9) and its gradient to 1e-10, and the card's equal
    to the CPU's (1e-12 / 1e-10); K2 around the Stan logp against its
    plain version over one frozen chunk (``STAN_PARITY_DRAWS``, trees to
    depth ``STAN_PARITY_MAXDEPTH``): ints exact, floats to rtol 1e-6 /
    atol 1e-8, the machine steps replayed from graphs.  The same for
    ``STAN_CENSORED``, a data ``if`` in a loop of 64 observations.  The
    seconds of each part are printed.
18. ``stan``: ``sample()`` on the Stan radon with ``y_new =
    normal_rng(intercept, sigma)``, the main phase's configuration (2048
    chains x (300 + ``STAN_DRAWS``), pooled, seed 42, float32), K1's and
    K2's launch counts set to 0 just before: K1 never, K2 more than once.
    Draws finite, max split R-hat below 1.05, each monitored column's
    mean within 5 combined MCSE of the main phase's K1 trace; the
    logp+grad of the Stan radon and of ``nt.models.radon()`` by CUDA
    events over graph replays (``_logp_graph_ms``) and their ratio;
    ``STAN_YNEW_ROWS`` rows of ``y_new`` recomputed on the CPU from the
    card's positions and keys (to 1e-5 relative).  Then K2 at the same
    shapes (``_stan_k2_main_shapes``): the warmup phase's tuned float32
    fleet as a Stan radon fleet, one frozen ``STAN_F32_DRAWS``-draw chunk
    through the runner's graphs against the plain version (the float32
    shares at ``F32_MIN_SHARE_STEPS`` / ``F32_MIN_SHARE_DRAWS``), and
    K2's ``advance`` a machine step over it by events, by device time
    under ``torch.profiler``, the plain version's, and its byte and
    operation bounds.  Prints wall, gradients/s, min bulk-ESS/s,
    divergences and the wall's split into logp+grad (the machine steps
    times the graph-replay ms), K2 (times its device ms), captures and
    the rest.

Stan's looping functionals (``integrate_1d``, the ODE solvers with their
adjoint, the DAE and algebraic solvers; a log density that calls a
solver reads the device to stop, so the step runner calls it eagerly
around K2):

19. ``stan_functionals_parity``: float64.  Each program of
    ``tests/torch_stan_programs.py:FUNCTIONAL_CASES`` (one per functional,
    22) at ``FUNCTIONAL_POINTS`` points: logp and gradient on the card
    equal the CPU's to 1e-12; the ODE on exponential decay against ``10
    exp(-k t)`` and its gradient in k (``DECAY_TOL``); the Lotka-Volterra
    case study (Carpenter's predator-prey case study, 8 parameters, 20
    output times) at ``LV_PARITY_CHAINS`` points against the CPU, and K2
    around its eager log density bitwise its plain version over one
    frozen chunk (``LV_PARITY_DRAWS``, trees to ``LV_PARITY_MAXDEPTH``;
    every K2 launch eager, no graph replay).
20. ``stan_ode``: ``sample()`` of the case study as written (the old ODE
    interface, its ``CompiledStanModel``) at ``LV_CHAINS`` chains x
    (``LV_TUNE`` + ``LV_DRAWS``), trees to ``LV_MAXDEPTH``, float32, the
    chains started within ``LV_INIT_HALF_WIDTH`` of the posterior means
    (``_lv_near``: ``sample()``'s own start holds the fleet at the solver's
    cap), K1's and K2's counts set to 0 just before: K1 never,
    K2 more than once, no replay.  Draws finite.  A short run: it samples,
    it does not converge.  Prints wall, the init's seconds and calls,
    gradients/s, R-hat over theta, the solver's counts (intervals at the
    cap), the logp+grad ms a call by events, the Dormand-Prince attempts
    an output interval (forward and adjoint, mean and max), K2 at these
    shapes against its plain version (float32 shares, bitwise or not) and
    timed (events, device time, the plain advance, its bound) and the
    wall's split.

The case study under MCLMC and flow adaptation (the runners call its
eager log density between their kernels' launches, no graph replay), and
PyMC models (``compile_pymc_model``, through ``tests/torch_fake_pymc.py``,
a stand-in of pymc and of PyTensor's PyTorch linker in torch):

21. ``stan_ode_mclmc``: ``sample(sampler="mclmc")`` of the case study as
    written at ``LV_MCLMC_CHAINS`` chains x (``LV_MCLMC_TUNE`` +
    ``LV_MCLMC_DRAWS``), float32, the start narrowed (``_lv_near``), one
    chunk: K3 launched once a chunk and twice a draw, no graph replay, K1
    and K2 never; draws finite.  Then K3 at the run's shapes from a fresh
    fleet at the end of tuning: one frozen ``LV_K3_DRAWS``-draw chunk
    through the eager route against the plain version (the float32 shares
    at the GLM's bars, bitwise or not), K3's kick and settle a step by
    events, by device time and replayed from a graph, the plain pieces',
    the byte bound; the wall's split.
22. ``stan_ode_flow``: ``sample(adaptation="flow")`` under NUTS on the case
    study at ``LV_FLOW_CHAINS`` chains x (``LV_FLOW_TUNE`` +
    ``LV_FLOW_DRAWS``), trees to ``LV_FLOW_MAXDEPTH``, the flows
    ``LV_FLOW`` updated every ``LV_FLOW_FREQ`` draws (the first chunk's end
    trains them by Adam), float32: K2 launched, no graph replay, K1 and K3
    never, a flow trained; draws finite.  Then K2 under its fixed metric at
    the run's shapes from a fresh fleet under seeded flows: one frozen
    1-draw chunk against the plain version (the float32 shares), K2's
    advance by events and device time, the plain advance, the bounds.
23. ``pymc``: radon written as a PyMC model (PyMC's value variables: the
    zero-sum effects and the ``*_log__`` scales; 173 parameters, 919
    observations).  Float64: its logp equals ``nt.models.radon()``'s up to
    one constant (spread under 1e-10 of the largest |logp|), its gradient
    to 1e-10, the card's the CPU's to 1e-12; K2 around it against its
    plain version over a frozen ``PYMC_PARITY_DRAWS``-draw chunk, the log
    density captured.  Then ``sample()`` at the main path's configuration
    (2048 chains x (300 + ``PYMC_DRAWS``), pooled, seed 42, float32): K1
    never, K2 with graph replays, R-hat below 1.05, each monitored
    column's mean within ``PYMC_MCSE`` combined MCSE of the main phase's K1
    trace; logp+grad ms a call beside ``nt.models.radon()``'s, the wall's
    split.

Every phase that reads split R-hat and bulk ESS (``column_diagnostics``)
also computes them on the card with ``diagnostics_device`` and holds
them to the host's to rtol ``DIAG_RTOL``.

Then the script's seconds (beside them the three phases above and their
budget of ``NEW_PHASES_BUDGET_S``, and the script's of ``TOTAL_BUDGET_S``),
the kernels line (K1; K2 with its low-rank branch, its microcanonical
instantiations, its fixed metric, the eager route around the case study,
with and without flow, and the PyMC radon; K3 with its low-rank form, its
fixed metric and the eager route around the case study), the card line,
and the last line

``{"ok": true, "device": {...}}``.  Every phase runs even after one
fails; any failed phase makes the script exit non-zero with no result
line, and so does ``--phases`` with fewer than all phases.  Without CUDA, or without the package beside it, the
script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

# the main path's sizes (bench.py's radon configuration, draws cut to 300)
CHAINS, TUNE, DRAWS, CHUNK = 2048, 300, 300, 128
# the control phase's checkpoint: runs of 300 + 84 draws resumed to 300 +
# 300; draw 384 is a chunk boundary of radon's run (128) and the GLM's (32)
RESUME_DRAWS = 84
# the control phase's Zarr run: the main configuration with its posterior
# cut to ZARR_DRAWS draws and no warmup stored.  The layout (the JAX package's) is
# one file per chain, array and 16 draws: the main run's 600 draws would be
# 1.7 M files, and a first cut to 128 posterior draws (311 k files) took 194
# s to read back twice; 100 posterior draws over two device chunks (84 + 16
# rows, re-buffered across them), 272 k files, took 20.37 s to write and
# 44.47 s to read back (chip_smoke, PR 8).  Cut to 50 when the MCLMC and
# microcanonical phases joined the script (its time limit), then to 18 (50
# took 14.56 s to write and 33.22 s to read back with the whole script at
# 1109.1 s of its 1200; 18 took 10.28 and 27.02 s), then to 2 (18 took
# 11.5 and 34.7 s in a 1207.6 s script): the draws lie in one device chunk,
# and their Zarr chunk (2 of 16 draws) is flushed partial
ZARR_DRAWS = 2
# 8 draws a parity chunk kept the whole run near ten minutes; cut to 4
# when the flow phases joined the script, then to 2 (its time limit)
PARITY_CHAINS, PARITY_CHUNK = 64, 2
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
# Both held 4-draw windows when the flow phases joined the script (float64
# held 8 until then: (84, 8), (154, 8), (234, 8), (266, 8), (292, 8)),
# and 2 since (the script's time limit): each still holds its event's draw
WINDOWS = {
    "float64": ((0, 2), (89, 2), (158, 2), (238, 2), (269, 2), (298, 2)),
    "float32": ((0, 2), (89, 2), (158, 2), (238, 2), (269, 2), (298, 2)),
}
EARLY_END = 90
# the GLM path (bench_glm.py:17-22; its 700 draws cut to 300) and its
# monitored columns (bench_glm.py:68)
GLM_CHAINS, GLM_TUNE, GLM_DRAWS, GLM_CHUNK = 10240, 300, 300, 32
# the distributed phase: radon's posterior draws (the main phase's first
# TUNE + DIST_DRAWS), and the GLM's draws, each run twice.  The GLM's run
# took 9.8 s at 32 + 32 in chunks of 32 (the phase 24.4 s of its 20) and
# 6.3 s at 8 + 8 in chunks of 8 (the phase 19.5 s): the first warmup
# draws' trees are the deepest.  4 + 4 in chunks of 4 keeps two
# boundaries, the fleet depth cap measured on the first chunk and a
# frozen posterior chunk
DIST_DRAWS = 128
DIST_GLM_TUNE, DIST_GLM_DRAWS, DIST_GLM_CHUNK = 4, 4, 4
GLM_N_DATA, GLM_DIM = 2048, 64
GLM_MONITORED = list(range(0, GLM_DIM, max(1, GLM_DIM // 24)))
# the GLM profile's cut of tune and draws (the trace of every launch of the
# whole path would be too large, and the profiler's processing grows with
# its events: 64 + 64 until the low-rank path joined the script, 32 + 32
# until the MCLMC and microcanonical phases did, 16 + 16 until the flow
# phases did, then 8 + 8, cut for the script's time limit); the control phase's
# busy caller runs the same cut
GLM_PROFILE_TUNE, GLM_PROFILE_DRAWS = 4, 4
# step_parity's 1000-d Gaussian: its trees run to the depth limit, so its
# plain version is most of the phase (8 draws until the flow phases joined
# the script, then 4, then 2, cut for its time limit)
STEP_PARITY_CHAINS, ILL_DIM, ILL_CHAINS, ILL_DRAWS = 64, 1000, 16, 2
# step_parity's float64 GLM: a fresh warmup window, then a frozen chunk
# (8 + 16 draws until the script outran its time limit on a slower host,
# 4 + 8 until the Stan functionals' phases joined the script)
GLM_F64_WARM, GLM_F64_FROZEN = 2, 4
# the timing phase's float64 chunk is held against its plain version over
# its first draws (the whole 128-draw chunk until a slower host took the
# script past its time limit), and timed whole
TIMING_F64_DRAWS = 32
# the chains of step_parity's CPU yardstick (all 64 until the flow phases
# joined the script)
YARD_CHAINS = 8
# posterior means of the GLM against the Laplace approximation, in
# posterior sd: catches a wrong gradient, not a subtle bias
LAPLACE_SD_TOL = 0.25
# ... and against the posterior mean by importance sampling from the
# Laplace approximation (20,000 draws, effective size about 12,000, so
# about 0.01 sd of Monte Carlo error): the mean and the mode of this
# posterior differ by up to 0.24 sd, its skew
IMPORTANCE_SD_TOL = 0.05
# machine steps a graph in the unroll sweeps: the runner's 8 beside 1 (1, 4,
# 8 and 16 until the Stan functionals' phases joined the script)
UNROLLS = (1, 8)
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
# the low-rank path's own run: 1024 chains at first, then cut to 512 for
# the script's time limit (the run took 95.7 s of a 1207.6 s
# script; the timings and parity phases keep the 1024 chains above), then
# to 256 (512 took 53.7 s of a 1037.4 s script, which a slower host took
# past its 1200 s)
LR_PATH_CHAINS = 256
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
# merges, draws ended by a U-turn and by the depth limit) over 4 + 8 draws.
# The first two ran 8 + 16 draws until the MCLMC and microcanonical phases
# joined the script; cut to 4 + 8 for its time limit
# (4 + 8 until the flow phases joined the script; 4 + 4 then; 2 + 2 since
# a slower host took the script past its time limit)
LR_F64_CASES = (
    ("all_slots", LR_DIM, LR_RANK, LR_CUTOFF_ALL, 0, None, (2, 2)),
    ("default_cutoff", LR_DIM, LR_RANK, 100.0, 0, None, (2, 2)),
    ("dim500", 500, LR_RANK, LR_CUTOFF_ALL, 0, 6, (2, 2)),
    ("dim33_rank5", 33, 5, LR_CUTOFF_ALL, 2, 6, (2, 2)),
)
# the float32 low-rank parity chunk and the low-rank step timing's chunk
# (16 draws at first, then 8, cut for the script's time limit)
LR_F32_CHUNK = 4
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


# the libraries of K2 (its float32 and float64 instantiations, and its
# device query alone) and K3, compiled while the K1 phases run
STEP_LIBS = ("step_kernel_f32", "step_kernel_f64", "step_device", "mclmc")
# one nvcc each, in a process of its own (ops/build.py names its temporary
# output by process, so a library the package builds at once stays whole)
_BUILD_ONE = ("import importlib.util, sys; "
              "spec = importlib.util.spec_from_file_location('build', sys.argv[1]); "
              "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
              "m.build_all(sys.argv[2:])")
_BUILDS: dict = {}


def _start_step_builds() -> None:
    """Start one process for each of ``STEP_LIBS``; a thread each waits
    for it and keeps its end, exit code and output."""
    import threading

    script = os.path.join(ROOT, "nutpie_tpu_torch", "ops", "build.py")
    t0 = time.perf_counter()
    for name in STEP_LIBS:
        proc = subprocess.Popen([sys.executable, "-c", _BUILD_ONE, script, name],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        entry = {"proc": proc, "t0": t0}

        def wait(entry=entry):
            out, err = entry["proc"].communicate()
            entry.update(seconds=time.perf_counter() - entry["t0"], output=out + err)

        entry["thread"] = threading.Thread(target=wait, daemon=True)
        entry["thread"].start()
        _BUILDS[name] = entry


def _stop_step_builds() -> None:
    """End any build process still running (a run cut short)."""
    for entry in _BUILDS.values():
        if entry["proc"].poll() is None:
            entry["proc"].kill()
            entry["proc"].wait()


def phase_build(ctx):
    """K1's library, with K2's and K3's started beside it (``build_steps``
    waits for them)."""
    import torch

    from nutpie_tpu_torch.ops import build
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel

    _start_step_builds()
    t0 = time.perf_counter()
    lib_path = build.build_all(["megakernel"])["megakernel"]
    chunk_kernel.library()
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
    emit({
        "phase": "build", "torch": torch.__version__,
        "cuda": torch.version.cuda, "card": ctx["card"],
        "kind": torch.cuda.get_device_name(0),
        "library": os.path.relpath(str(lib_path), ROOT),
        "build_seconds": round(seconds, 3),
        "building_beside": list(STEP_LIBS),
        "geometry": geometry,
    })
    for tag in ("float32", "float32_adam"):
        g32 = geometry[tag]
        assert g32["resident_chains_per_sm"] >= 10 and g32["local_bytes_per_thread"] == 0, g32


def phase_build_steps(ctx):
    """K2's and K3's libraries (started by ``build``): their registers,
    spill and plans."""
    import torch

    from nutpie_tpu_torch.ops import build
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
    from nutpie_tpu_torch.sampler.step_kernel import DIAG_FORM_TAGS, step_kernel

    t0 = time.perf_counter()
    if not _BUILDS:
        _start_step_builds()
    for entry in _BUILDS.values():
        entry["thread"].join()
    waited = time.perf_counter() - t0
    failed = [f"{name}: {entry['output'][-4000:]}" for name, entry in _BUILDS.items()
              if entry["proc"].returncode != 0]
    assert not failed, "\n".join(failed)
    libs = build.build_all(list(STEP_LIBS))
    step_kernel.library(torch.float32)
    step_kernel.library(torch.float64)
    mclmc_kernel.library()
    seconds = {name: round(entry["seconds"], 3) for name, entry in _BUILDS.items()}
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
    # K3's forms in both dtypes, with its plans at the main paths' shapes:
    # the GLM's (held), the low-rank path's (float32 stages the basis,
    # float64 streams it)
    k3, k3_plans = {}, {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).removeprefix("torch.")
        k3[name] = mclmc_kernel.geometry(dt, LR_CHAINS, LR_DIM, LR_RANK)
        k3_plans[name] = {
            "glm": dataclasses.asdict(mclmc_kernel.plan(GLM_CHAINS, GLM_DIM, 0, dt, DEVICE)),
            "low_rank": dataclasses.asdict(mclmc_kernel.plan(LR_CHAINS, LR_DIM, LR_RANK, dt,
                                                             DEVICE))}
    ctx["k3_geometry"], ctx["k3_plans"] = k3, k3_plans
    emit({
        "phase": "build_steps", "build_seconds": seconds,
        "seconds_waited": round(waited, 3),
        "step_kernel": {
            "library": [os.path.relpath(str(libs[f"step_kernel_{sfx}"]), ROOT)
                        for sfx in ("f32", "f64")],
            "geometry": k2,
            "low_rank_plan": plans,
            "glm_diag_plan": diag,
        },
        "mclmc_kernel": {
            "library": os.path.relpath(str(libs["mclmc"]), ROOT),
            "geometry": k3,
            "plans": k3_plans,
        },
    })
    for dt, geo in k3.items():
        assert all(v == 0 for k, v in geo.items() if k.endswith("local_bytes")), \
            f"the MCLMC kernel spills in {dt}: {geo}"
        assert geo["lr_smem_bytes"] == k3_plans[dt]["low_rank"]["smem_bytes"], (geo, k3_plans)
        assert geo["lr_blocks_per_sm"] >= 1, geo
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


def _check_warmup_ints(tag, limit, s_k, b_k, s_p, b_p) -> bool:
    """Warmup chunk: integer decisions, step counts and Welford counts
    exact."""
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
    return True


def _check_warmup_f64(tag, limit, s_k, b_k, s_p, b_p) -> float:
    """Warmup chunk in float64: integer decisions and Welford counts exact.

    Floats to rtol 1e-3: adaptation feeds rounding differences back
    through the step size and mass matrix every draw.
    """
    _check_warmup_ints(tag, limit, s_k, b_k, s_p, b_p)
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
    handle = nt.sample(compiled, progress_bar=False, chains=CHAINS, tune=TUNE, draws=DRAWS,
                       seed=42, pool_mass_matrix=True, pool_step_size=True, device="cuda",
                       return_raw_trace=True, blocking=False)
    raw = handle.wait()
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
    ctx["main_ess"] = ess  # the stan phase holds its means to this trace
    readings = {"wall_s": wall, "gradients": grads, "grads_per_s": grads / wall,
                "min_bulk_ess": min_ess, "min_ess_per_s": min_ess / wall,
                "min_ess_per_grad": min_ess / grads, "max_rhat": float(max(rhat)),
                "posterior_divergences": div_post}
    eps = raw["stats"]["step_size"][:, TUNE:]
    ctx["main_readings"] = dict(readings, step_size=float(np.median(eps)))
    ctx["main_raw"] = raw  # the control phase holds its runs to it bitwise
    ctx["main_depth_cap"] = handle.depth_cap  # frozen after the chunk ending at 256
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
    # rtol 1e-6 / atol 1e-8, as in the parity phase, over the chunk's first
    # TIMING_F64_DRAWS draws; then the whole chunk's time
    st64 = NutsMachineState(**{k: v.double() if v.is_floating_point() else v
                               for k, v in states.tensors().items()})
    mom64, jit64 = draw_randoms(st64.key, TUNE, CHUNK, model.ndim, torch.float64)

    def kernel64_once():
        return chunk_kernel(cfg, model, sched, TUNE, CHUNK, st64, mom64, jit64, True)

    n64 = TIMING_F64_DRAWS
    mom_n, jit_n = draw_randoms(st64.key, TUNE, n64, model.ndim, torch.float64)
    k64 = chunk_kernel(cfg, model, sched, TUNE, n64, st64, mom_n, jit_n, True)
    p64 = plain_chunk(cfg, model, sched, TUNE, n64, st64.clone(), mom_n, jit_n, True)
    torch.cuda.synchronize()
    err64 = _check_frozen_f64("main-shape float64", *k64, *p64)
    del p64, k64
    kernel64_once()  # warm
    ms64, outs64 = _event_ms(kernel64_once, reps)
    _assert_repeatable(outs64)
    k64 = outs64[0]
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
        "f64_parity_draws": TIMING_F64_DRAWS,
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


def _profiled_sample(compiled, with_prof: bool = False, **kwargs):
    """``sample()`` on the card under ``torch.profiler``: (wall s, device
    rows, K2's launches in the run, K2's launches the trace holds), and the
    profiler itself with ``with_prof``.  The step runner replays its machine
    steps from CUDA graphs; the trace's count of K2 launches says whether it
    saw the kernels inside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    torch.cuda.synchronize()
    launches = step_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nt.sample(compiled, progress_bar=False, device=DEVICE, return_raw_trace=True, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    traced = sum(n for _, name, n in rows if _is_k2(name))
    out = (wall, rows, step_kernel.launches - launches, traced)
    return out + (prof,) if with_prof else out


def _overlap_s(prof, is_a, is_b) -> float:
    """Seconds of device events named ``is_a`` that run while an event
    named ``is_b`` runs (the trace's intervals)."""
    import torch

    spans = lambda match: sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type != torch.autograd.DeviceType.CPU and match(ev.name))
    merged = []
    for start, end in spans(is_b):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    total = 0.0
    for start, end in spans(is_a):
        total += sum(max(0.0, min(end, e) - max(start, s)) for s, e in merged)
    return total / 1e6


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

    wall, rows, _, _, prof = _profiled_sample(
        compile_model_def(nt.models.radon()), with_prof=True, chains=CHAINS, tune=TUNE,
        draws=DRAWS, seed=43, pool_mass_matrix=True, pool_step_size=True)
    device_s = sum(r[0] for r in rows)
    kernel_s = sum(r[0] for r in rows if "megakernel_chunk" in r[1])
    copy_s = sum(r[0] for r in rows if r[1].startswith("Memcpy"))
    dtoh = {kind: sum(r[0] for r in rows if r[1].startswith("Memcpy DtoH")
                      and kind in r[1].lower()) for kind in ("pinned", "pageable")}
    is_dtoh = lambda name: name.startswith("Memcpy DtoH")
    copies = {
        "memcpy_dtoh_pinned_s": dtoh["pinned"], "memcpy_dtoh_pageable_s": dtoh["pageable"],
        "memcpy_dtoh_overlapping_k1_s": _overlap_s(
            prof, is_dtoh, lambda name: "megakernel_chunk" in name),
        "memcpy_dtoh_overlapping_any_kernel_s": _overlap_s(
            prof, is_dtoh, lambda name: not name.startswith("Memcpy")
            and not name.startswith("Memset")),
    }
    del prof
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
        "chunk_kernel_s": kernel_s, "memcpy_s": copy_s, **copies,
        "other_device_s": device_s - kernel_s - copy_s,
        "single_buffered_loop": {"wall_s_profiled": 3.30, "device_idle_share": 0.542,
                                 "memcpy_s": 0.98},
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
    """The plain version on the CPU from the card's state, on its first
    ``YARD_CHAINS`` chains (each chain's steps are its own): how far two
    plain versions that round differently part over the same chunk."""
    from nutpie_tpu_torch.sampler.run import make_chunk_runner
    from nutpie_tpu_torch.sampler.state import NutsMachineState

    cpu = NutsMachineState(**{k: v[:YARD_CHAINS].cpu() for k, v in states.tensors().items()})
    run = make_chunk_runner(model, cfg, chunk_len, states.vecs.dtype,
                            adapt_frozen=frozen, plain=True)
    return run(cpu, start, limit, sched)


def _yardstick(limit, plain_card, plain_cpu) -> dict:
    """The card's plain version against the CPU's on one chunk."""
    import torch

    (s_g, b_g), (s_c, b_c) = plain_card, plain_cpu
    n = s_c.ints.shape[0]
    pos_g, pos_c = b_g.position[:n, :limit].cpu(), b_c.position[:, :limit]
    return {"chains": n, "ints_equal": bool(torch.equal(s_g.ints[:n].cpu(), s_c.ints)),
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
    64 chains: a fresh ``GLM_F64_WARM``-draw warmup window, then a
    ``GLM_F64_FROZEN``-draw frozen chunk;
    beside each, the plain version on the CPU against the card's.  Failed
    bars go to ``failed``."""
    import torch

    model = _glm_model()
    cfg, sched, states = _fleet(model, GLM_TUNE, STEP_PARITY_CHAINS, torch.float64, 21)
    w, n = GLM_F64_WARM, GLM_F64_FROZEN
    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, states, 0, w, w, False)
    warm_err = _held(failed, _check_warmup_f64, "GLM warmup window", w, s_k, b_k, s_p, b_p)
    warm_yard = _yardstick(w, (s_p, b_p),
                           _plain_on_cpu(model, cfg, sched, states, 0, w, w, False))
    warm_share = float(((b_k.position - b_p.position).abs()
                        <= 1e-3 * (1.0 + b_p.position.abs())).double().mean())
    (f_k, fb_k), (f_p, fb_p) = _steps_both(model, cfg, sched, s_k, w, n, n, True)
    frozen_err = _held(failed, _check_frozen_f64, "GLM frozen chunk", f_k, fb_k, f_p, fb_p)
    frozen_yard = _yardstick(n, (f_p, fb_p),
                             _plain_on_cpu(model, cfg, sched, s_k, w, n, n, True))
    return {"chains": STEP_PARITY_CHAINS, "n_data": GLM_N_DATA, "dim": GLM_DIM,
            "warmup": {"draws": w, "held": warm_err is not None,
                       "ints_equal": bool(torch.equal(s_k.ints, s_p.ints)),
                       "max_abs_err_position": max_abs(b_k.position, b_p.position),
                       "share_within_1e-3": warm_share, "rtol": 1e-3,
                       "plain_card_vs_cpu": warm_yard},
            "frozen": {"draws": n, "held": frozen_err is not None,
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
# 8 + 8 draws until the flow phases joined the script
SETTINGS_CHAINS, SETTINGS_DRAWS = 16, 4


def settings_f64_parity(failed: list) -> dict:
    """K2 against its plain version in each of ``SETTINGS``: float64 eight
    schools, 16 chains, a warmup window of ``SETTINGS_DRAWS`` from a fresh
    fleet, then a frozen chunk as long.  Failed bars go to ``failed``."""
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
    (i_k, ib_k), (i_p, ib_p) = _steps_both(ill, icfg, isched, istates, 0, ILL_DRAWS,
                                           ILL_DRAWS, True)
    ill_ints = bool(torch.equal(i_k.ints, i_p.ints))
    ill_steps = nan_equal(ib_k.scalars[..., ns], ib_p.scalars[..., ns])
    settings = settings_f64_parity(failed)

    ctx["step_max_abs_err"] = glm64["frozen"]["max_abs_err_position"]
    emit({
        "phase": "step_parity",
        "glm_f64": glm64,
        "gaussian1000_f64": {"chains": ILL_CHAINS, "dim": ILL_DIM, "draws": ILL_DRAWS,
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
    raw = nt.sample(compiled, progress_bar=False, chains=GLM_CHAINS, tune=GLM_TUNE, draws=GLM_DRAWS,
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
    # the control phase's resumed GLM run is held to these draws bitwise
    cut = GLM_TUNE + RESUME_DRAWS
    ctx["glm_tail"] = {"position": pos[:, cut:].copy(),
                       **{g: {k: v[:, cut:].copy() for k, v in raw[g].items()}
                          for g in ("stats", "expanded")}}
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
    mclmc_step_timing(ctx)


def mclmc_bytes(n_chains: int, draws: int, steps_per_draw: int, dim: int, itemsize: int,
                rank: int = 0, stored_rows: int = 0, lr_form: str = "staged") -> dict:
    """Bytes K3's kicks and settles must move over ``draws`` frozen draws of
    one chunk (no adaptation), counted from csrc/mclmc.cu as what passes
    between launches: each input read once and each output written once,
    however often a launch reads it again, so neither the work row nor the
    state rows a draw's end writes and the next draw's start reads in the
    same launch.  A kick reads the gradient, the inverse mass, the velocity
    and z and writes the velocity and z (6 rows); a settle reads the
    velocity, z and the inverse mass and writes the velocity and z (5
    rows; it draws the step's normals itself from the chain's 8-byte key);
    a draw's end also reads the gradient and writes the state's position,
    gradient and velocity, the draw and ``stored_rows`` more buffers (5 +
    stored_rows rows), save that the chunk's last draw starts no next one
    (no inverse mass read, no velocity or z written).  Scalars: a kick
    reads the draw counter and the step size and writes the kinetic
    change; a settle reads the log density, the step within the draw and
    the chain's state and running scalars and writes the last two; a
    draw's end writes its scalar row; every launch reads the schedule
    once.  Under a low-rank metric of rank ``rank`` each launch that
    applies it must read the chain's basis and log eigenvalues once (every
    kick and every settle but the chunk's last); ``lr_basis_bytes_as_read``
    counts the basis as the kernel reads it in its plan's form ``lr_form``:
    once a launch that applies it when staged, twice an application when
    streamed (A^T g and A u in a kick, A u in a settle)."""
    T, row = itemsize, dim * itemsize
    steps = draws * steps_per_draw
    state = 3 * 4 + 2 * T + 4 * T + 4                # ints, flts, running, step
    kick = 6 * row + 4 + T + T
    settle = 5 * row + T + 2 * state + 8
    per_draw = (5 + stored_rows) * row + 4 * T
    last = 3 * row                                    # the chunk's last settle
    schedule = 6 * 4 * 2 * steps                      # per launch, not per chain
    out = {"steps": steps, "draws": draws}
    total = n_chains * (steps * (kick + settle) + draws * per_draw - last) + schedule
    if rank:
        metric = (rank * dim + rank) * T
        total += n_chains * (2 * steps - 1) * metric
        reads = 2 * steps - 1 if lr_form == "staged" else 6 * steps - 2
        out["lr_basis_bytes_as_read"] = n_chains * reads * rank * dim * T
    out["bytes"] = total
    return out


def _k3_chunk(cfg, sched, states, start: int, chunk: int, plain: bool = False):
    """One MCLMC chunk prepared as the runner prepares it: the state's copy,
    the buffers and scratch, and its pieces (K3's, which draw their own
    normals, or the plain version's, with the chunk's normals)."""
    from nutpie_tpu_torch.sampler.mclmc import init_buffers, init_scratch, plain_steps
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel

    st = states.clone()
    C, _, dim = st.vecs.shape
    dtype = st.vecs.dtype
    bufs = init_buffers(cfg, chunk, C, dim, dtype, DEVICE)
    scratch = init_scratch(C, dim, dtype, DEVICE)
    pieces = plain_steps if plain else mclmc_kernel.chunk
    return st, bufs, pieces(cfg, sched, start, chunk, st, bufs, scratch)


def _k3_timed(model, cfg, sched, states, start: int, draws: int, plain_draws: int) -> dict:
    """K3's kick and settle and the logp+grad calls per draw (one step a
    draw) over ``draws`` frozen draws, by CUDA events around each call and
    by device time under ``torch.profiler``; the plain pieces over
    ``plain_draws`` draws by CUDA events after a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st, bufs, steps = _k3_chunk(cfg, sched, states, start, draws)
    z = steps.begin(st)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(draws)]
    torch.cuda.synchronize()
    for ev in marks:
        ev[0].record()
        _, g = model.logp_and_grad(z)
        ev[1].record()
        z = steps.kick(st, z, g)
        ev[2].record()
        logp, g = model.logp_and_grad(z)
        ev[3].record()
        z = steps.settle(st, z, logp, g)
        ev[4].record()
    torch.cuda.synchronize()
    parts = ("logp_grad_mid", "kick", "logp_grad_end", "settle")
    ms = {p: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / draws
          for i, p in enumerate(parts)}
    # device time
    dst, _, dsteps = _k3_chunk(cfg, sched, states, start, draws)
    z = dsteps.begin(dst)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(draws):
            _, g = model.logp_and_grad(z)
            z = dsteps.kick(dst, z, g)
            logp, g = model.logp_and_grad(z)
            z = dsteps.settle(dst, z, logp, g)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    # the kicks and settles: a kernel a piece (mclmc_piece<1|2, ...>; before
    # the redesign mclmc_kick and mclmc_settle; the chunk's begin ran first)
    k3_s = sum(r[0] for r in rows if any(n in r[1] for n in ("mclmc_piece", "mclmc_kick",
                                                              "mclmc_settle")))
    # the plain pieces
    pst, _, plain = _k3_chunk(cfg, sched, states, start, draws, plain=True)
    z = plain.begin(pst)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    plain_ms = {"kick": 0.0, "settle": 0.0}
    for _ in range(plain_draws):
        _, g = model.logp_and_grad(z)
        torch.cuda.synchronize()
        ev[0].record()
        z = plain.kick(pst, z, g)
        ev[1].record()
        logp, g = model.logp_and_grad(z)
        torch.cuda.synchronize()
        ev[2].record()
        z = plain.settle(pst, z, logp, g)
        ev[3].record()
        torch.cuda.synchronize()
        plain_ms["kick"] += ev[0].elapsed_time(ev[1]) / plain_draws
        plain_ms["settle"] += ev[2].elapsed_time(ev[3]) / plain_draws
    return {"draws": draws, **{f"{k}_ms": v for k, v in ms.items()},
            "k3_ms_per_step": ms["kick"] + ms["settle"],
            "k3_device_ms_per_step": 1e3 * k3_s / draws,
            "plain_kick_ms": plain_ms["kick"], "plain_settle_ms": plain_ms["settle"],
            "plain_ms_per_step": plain_ms["kick"] + plain_ms["settle"],
            "plain_draws": plain_draws}


def mclmc_step_timing(ctx):
    """K3 by the step at the GLM's main shapes and the low-rank Gaussian's,
    beside its byte bound and its plain version; K2's micro advance at the
    GLM's."""
    import torch

    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel

    out = {}
    model = _glm_model()
    cfg, sched = _mclmc_cfg(MCLMC_PARITY_TUNE)
    states = _mclmc_init(model, cfg, GLM_CHAINS, torch.float32, 43)
    states = states.replace(ints=states.ints.clone().index_fill_(
        1, torch.tensor([0], device=DEVICE), MCLMC_PARITY_TUNE))
    glm = _k3_timed(model, cfg, sched, states, MCLMC_PARITY_TUNE, GLM_CHUNK, 8)
    work = mclmc_bytes(GLM_CHAINS, GLM_CHUNK, 1, GLM_DIM, 4)
    glm["bytes_bound_ms_per_step"] = 1e3 * work["bytes"] / PEAK_BYTES / work["steps"]
    glm["share_of_bound"] = glm["bytes_bound_ms_per_step"] / glm["k3_ms_per_step"]
    glm["share_of_bound_device"] = glm["bytes_bound_ms_per_step"] / glm["k3_device_ms_per_step"]
    glm["plan"] = dataclasses.asdict(mclmc_kernel.plan(GLM_CHAINS, GLM_DIM, 0, torch.float32,
                                                       DEVICE))
    out["glm"] = {"chains": GLM_CHAINS, "dim": GLM_DIM, **glm}
    ctx.update(mclmc_ms=glm["k3_ms_per_step"], mclmc_device_ms=glm["k3_device_ms_per_step"],
               mclmc_plain_ms=glm["plain_ms_per_step"],
               mclmc_bound_ms=glm["bytes_bound_ms_per_step"])
    # the low-rank metric at the Gaussian's shapes: K3 does the same work
    # whatever the metric's values, so every chain takes one random
    # orthonormal basis of rank 32 (no estimate to wait for)
    from nutpie_tpu_torch.models import ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler.nuts import LowRankConfig

    lmodel = ill_conditioned_gaussian(dim=LR_DIM)
    lcfg, lsched = _mclmc_cfg(MCLMC_PARITY_TUNE, low_rank=LowRankConfig(max_rank=LR_RANK))
    lstates = _mclmc_init(lmodel, lcfg, LR_CHAINS, torch.float32, 44)
    gen = torch.Generator(device=DEVICE).manual_seed(44)
    q, _ = torch.linalg.qr(torch.randn((LR_DIM, LR_RANK), generator=gen, device=DEVICE))
    lstates = lstates.replace(
        ints=lstates.ints.clone().index_fill_(1, torch.tensor([0], device=DEVICE),
                                              MCLMC_PARITY_TUNE),
        lr_basis=q.expand(LR_CHAINS, LR_DIM, LR_RANK).contiguous(),
        lr_log_eigs=torch.linspace(-2.0, 2.0, LR_RANK, device=DEVICE).expand(
            LR_CHAINS, LR_RANK).contiguous())
    lr = _k3_timed(lmodel, lcfg, lsched, lstates, MCLMC_PARITY_TUNE, 16, 4)
    lplan = mclmc_kernel.plan(LR_CHAINS, LR_DIM, LR_RANK, torch.float32, DEVICE)
    lwork = mclmc_bytes(LR_CHAINS, 16, 1, LR_DIM, 4, rank=LR_RANK, lr_form=lplan.form)
    lr["plan"] = dataclasses.asdict(lplan)
    lr["bytes_bound_ms_per_step"] = 1e3 * lwork["bytes"] / PEAK_BYTES / lwork["steps"]
    # the basis reads of the plan's form, counted by construction (once a
    # launch that applies the metric when staged), not measured
    lr["basis_bytes_as_read_per_step"] = lwork["lr_basis_bytes_as_read"] / lwork["steps"]
    lr["bases_read_per_step"] = lr["basis_bytes_as_read_per_step"] / (
        LR_CHAINS * LR_DIM * LR_RANK * 4)
    lr["basis_reads"] = f"counted from the plan's form ({lplan.form}), not measured"
    lr["share_of_bound"] = lr["bytes_bound_ms_per_step"] / lr["k3_ms_per_step"]
    lr["share_of_bound_device"] = lr["bytes_bound_ms_per_step"] / lr["k3_device_ms_per_step"]
    # the library yardstick of the metric part: three applications a step
    # (A^T g and A u in the kick, A u in the settle), two torch.bmm each, by
    # events and by device time as K3's own
    bmm_ms, bmm_device_ms = _bmm_metric_ms(lstates.lr_basis)
    lr["library_ms_per_step"] = 3 * bmm_ms
    lr["library_device_ms_per_step"] = 3 * bmm_device_ms
    out["lowrank"] = {"chains": LR_CHAINS, "dim": LR_DIM, "rank": LR_RANK, **lr}
    ctx["mclmc_lr"] = out["lowrank"]
    # K2's microcanonical advance at the GLM's main shapes
    mmodel, mcfg, msched, mstates = ctx["micro_fleet"]
    ms, n_steps, mbufs = _timed_steps(mmodel, mcfg, msched, mstates, GLM_CHUNK)
    dev = _device_step_ms(mmodel, mcfg, msched, mstates, GLM_CHUNK, min(n_steps, 64))
    plain = _plain_step_ms(mmodel, mcfg, msched, mstates, GLM_CHUNK, 16)
    work = step_bytes(mbufs.scalars, GLM_CHUNK, GLM_CHAINS, n_steps, GLM_DIM,
                      mstates.ckpt_p.shape[1], 4)
    # the micro rows: the first half's velocity and its kinetic change,
    # written by one launch and read by the next, a leapfrog (the second
    # half writes the new velocity to the edge's momentum row, which
    # advance_bytes counts)
    micro_bytes = work["advance_bytes"] + work["leapfrogs"] * (2 * GLM_DIM * 4 + 2 * 4)
    bound = 1e3 * micro_bytes / PEAK_BYTES / n_steps
    out["k2_micro"] = {"machine_steps": n_steps, "advance_ms": ms["advance"],
                       "logp_grad_ms": ms["logp_grad"], "advance_device_ms": dev["advance"],
                       "plain_advance_ms": plain["advance"],
                       "bytes_bound_ms_per_step": bound,
                       "share_of_bound": bound / ms["advance"]}
    ctx.update(micro_ms=ms["advance"], micro_device_ms=dev["advance"],
               micro_plain_ms=plain["advance"], micro_bound_ms=bound)
    emit({"phase": "step_timing_mclmc", **out, "geometry": ctx["k3_geometry"]["float32"],
          "card": ctx["card"]})


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
        raw = nt.sample(compiled, progress_bar=False, adaptation="low_rank", chains=LR_PATH_CHAINS,
                        tune=LR_TUNE,
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
    assert updates[-1]["chains_with_a_kept_slot"] >= 0.9 * LR_PATH_CHAINS, updates

    pos = raw["position"]
    assert pos.shape == (LR_PATH_CHAINS, LR_TUNE + LR_DRAWS, LR_DIM), pos.shape
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
        "phase": "lowrank", "chains": LR_PATH_CHAINS, "tune": LR_TUNE, "draws": LR_DRAWS,
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


def _device_step_ms(model, cfg, sched, states, chunk: int, max_steps: int,
                    start: int = 0) -> dict:
    """K2's advance and the logp+grad call per machine step by device time
    under ``torch.profiler``, over the first ``max_steps`` steps of the same
    chunk (a host that falls behind the card stretches an event pair, not a
    kernel's device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st, _, steps = _prepared(cfg, sched, states, start, chunk, True)
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


def _plain_step_ms(model, cfg, sched, states, chunk: int, max_steps: int,
                   start: int = 0) -> dict:
    """The plain advance per machine step by CUDA events after a
    synchronize, over the first ``max_steps`` steps of the same chunk."""
    import torch

    st, _, plain = _prepared(cfg, sched, states, start, chunk, True, plain=True)
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


def _bmm_metric_ms(basis, reps: int = 50) -> tuple:
    """The library yardstick of the branch's metric part: one application of
    the basis products for every chain, w^T U and then U c, as two
    ``torch.bmm`` calls ([C, 1, dim] x [C, dim, R] and [C, 1, R] x [C, R,
    dim]); (ms by CUDA events, ms of device time under ``torch.profiler``,
    every device kernel of the calls), each the mean of ``reps``
    applications.  The port never calls it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n_chains, dim, _ = basis.shape
    w = torch.randn((n_chains, 1, dim), dtype=basis.dtype, device=basis.device)
    ut = basis.transpose(1, 2)

    def apply():
        torch.bmm(torch.bmm(w, basis), ut)

    apply()
    torch.cuda.synchronize()
    events = _event_ms(apply, reps)[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            apply()
        torch.cuda.synchronize()
    device = 1e3 * sum(r[0] for r in _device_rows(prof)) / reps
    return events, device


def lowrank_step_timing(ctx):
    """K2 at the low-rank path's shapes (1024 chains, dim 1000, float32,
    one frozen ``LR_F32_CHUNK``-draw chunk from the float32 parity fleet) with R = 32 and
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
    bmm_ms, bmm_device_ms = _bmm_metric_ms(states.lr_basis)
    out = {"plan": dataclasses.asdict(plan), "bmm_ms_per_application": bmm_ms,
           "bmm_device_ms_per_application": bmm_device_ms}
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
            library_device = bmm_device_ms * apps / n_steps
            out[tag].update(metric_applications_per_step=apps / n_steps,
                            library_metric_ms_per_step=library,
                            library_metric_device_ms_per_step=library_device)
            ctx.update(lr_step_ms=k2_ms, lr_step_device_ms=device["advance"],
                       lr_step_plain_ms=plain["advance"],
                       lr_step_bound_ms=max(t_bytes, t_ops), lr_library_ms=library,
                       lr_library_device_ms=library_device,
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
# 8 + 8 draws until the MCLMC and microcanonical phases joined the script;
# cut to 4 + 4, 2 + 2 and, when the Stan functionals' phases joined, 1 + 1
# for its time limit (every option's branch still runs in both windows)
OPTIONS_CHAINS, OPTIONS_DRAWS = 16, 1
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
# float32 arrays), then to 32 (one chunk) for the script's time limit
GLM_DIV_DRAWS = 32


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
    16 chains, maxdepth 6, an OPTIONS_DRAWS-draw warmup window then a frozen
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
    raw = nt.sample(compiled, progress_bar=False, chains=CHAINS, tune=TUNE, draws=DRAWS, seed=42,
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
    raw = nt.sample(compiled, progress_bar=False, chains=GLM_CHAINS, tune=GLM_TUNE, draws=GLM_DIV_DRAWS,
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


# ------------------------------------------------------------- control path


def _raw_diff(got: dict, want: dict, lo: int = 0) -> list:
    """Names of the arrays of the raw trace ``got`` that are not bitwise
    draws ``lo:lo + n`` of ``want`` (n: ``got``'s draws)."""
    import numpy as np

    n = got["position"].shape[1]

    def same(a, b):
        b = b[:, lo:lo + n]
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype.kind == "f":
            bits = f"u{a.itemsize}"
            return bool(np.array_equal(a.view(bits), b.view(bits)))
        return bool(np.array_equal(a, b))

    bad = [] if same(got["position"], want["position"]) else ["position"]
    for group in ("stats", "expanded"):
        if got[group].keys() != want[group].keys():
            bad.append(f"{group} keys")
            continue
        bad += [f"{group}/{k}" for k, v in got[group].items() if not same(v, want[group][k])]
    return bad


def _radon_background(progress_callback, **kwargs):
    """``sample(blocking=False)`` on radon at the main phase's configuration."""
    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def

    return nt.sample(compile_model_def(nt.models.radon()), progress_bar=False,
                     chains=CHAINS, tune=TUNE, seed=42, pool_mass_matrix=True,
                     pool_step_size=True, device=DEVICE, return_raw_trace=True,
                     blocking=False, progress_callback=progress_callback,
                     progress_rate=0, **kwargs)


def _control_handle(ctx) -> dict:
    """Pause, resume, inspect, wait and abort on radon through K1."""
    import threading

    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    main = ctx["main_raw"]
    first, last = threading.Event(), {}

    def on_progress(progress):
        last["finished"] = [p.finished_draws for p in progress]
        first.set()

    _zero_counts(step_kernel, chunk_kernel)
    handle = _radon_background(on_progress, draws=DRAWS)
    assert first.wait(timeout=300), "no progress callback"
    handle.pause()
    time.sleep(0.2)  # the chunk the loop had begun may still launch
    paused = chunk_kernel.launches
    time.sleep(1.0)
    assert chunk_kernel.launches == paused, \
        f"K1 launched {chunk_kernel.launches - paused} times while paused"
    handle.resume()
    inspected = handle.inspect()
    raw = handle.wait(timeout=600)
    launches = chunk_kernel.launches
    bad = _raw_diff(raw, main)
    assert not bad, f"the background run differs from the main phase in {bad}"
    bad = _raw_diff(inspected, main)
    assert not bad, f"the inspected trace is not the main phase's prefix: {bad}"
    assert last["finished"] == [TUNE + DRAWS] * CHAINS, "the last callback is not 600 draws"
    assert launches == math.ceil((TUNE + DRAWS) / CHUNK), launches

    enough = threading.Event()
    handle = _radon_background(
        lambda progress: progress[0].finished_draws >= 2 * CHUNK and enough.set(),
        draws=DRAWS)
    assert enough.wait(timeout=300), "the abort run made no progress"
    t0 = time.perf_counter()
    partial = handle.abort()
    abort_s = time.perf_counter() - t0
    assert partial is not None, "abort returned no trace"
    bad = _raw_diff(partial, main)
    assert not bad, f"the aborted trace is not the main phase's prefix: {bad}"
    return {"paused_at_launches": paused, "k1_launches": launches,
            "inspected_draws": inspected["position"].shape[1],
            "aborted_draws": partial["position"].shape[1], "abort_latency_s": abort_s,
            "pinned_bytes": handle.transfer.pinned_bytes,
            "pinned_alloc_s": handle.transfer.alloc_s, "copy_wait_s": handle.transfer.wait_s}


def _control_resume(ctx, tmp: str) -> dict:
    """Checkpoint at draw 384 and resume to 600, on both routes."""
    import importlib
    import json

    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.settings import NutsSettings

    sample_module = importlib.import_module("nutpie_tpu_torch.sample")
    save_state = sample_module.save_state
    saves = []

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save_state(*args, **kwargs)
        saves.append(time.perf_counter() - t0)

    cut = TUNE + RESUME_DRAWS
    runs = {
        "radon": (compile_model_def(nt.models.radon()), ctx["main_raw"], CHUNK,
                  dict(chains=CHAINS, seed=42, pool_mass_matrix=True, pool_step_size=True)),
        "glm": (compile_model_def(_glm_model()), ctx["glm_tail"], GLM_CHUNK,
                dict(chains=GLM_CHAINS, seed=42, chunk_size=GLM_CHUNK, precision="float32")),
    }
    out = {}
    for name, (compiled, ref, chunk, kwargs) in runs.items():
        assert cut % chunk == 0, (cut, chunk)
        path = os.path.join(tmp, f"{name}.npz")
        saves.clear()
        sample_module.save_state = timed_save
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nt.sample(compiled, progress_bar=False, tune=TUNE, draws=RESUME_DRAWS,
                      device=DEVICE, return_raw_trace=True, checkpoint=path, **kwargs)
            first_s = time.perf_counter() - t0
        finally:
            sample_module.save_state = save_state
        with np.load(path) as data:
            manifest = json.loads(str(data["__manifest__"]))
        t0 = time.perf_counter()
        raw = nt.sample(compiled, progress_bar=False, tune=TUNE, draws=DRAWS, device=DEVICE,
                        return_raw_trace=True, resume_from=path, **kwargs)
        resumed_s = time.perf_counter() - t0
        lo = cut if ref is ctx["main_raw"] else 0
        bad = _raw_diff(raw, ref, lo)
        assert not bad, f"{name}: the resumed draws differ from the uninterrupted run in {bad}"
        cap, maxdepth = manifest["depth_cap"], NutsSettings.Diag(0).maxdepth
        out[name] = {"resume_at": manifest["draws_done"], "checkpoint_bytes": os.path.getsize(path),
                     "saves": len(saves), "save_s_mean": float(np.mean(saves)),
                     "first_run_s": first_s, "resumed_run_s": resumed_s,
                     "depth_cap_restored": cap,
                     "resumed_draws_at_cap_below_maxdepth":
                         int((raw["stats"]["depth"] == cap).sum()) if cap < maxdepth else 0,
                     "resumed_draws": raw["position"].shape[1]}
        assert out[name]["resume_at"] == cut, out[name]
    return out


def _control_zarr(ctx, tmp: str) -> dict:
    """Radon streamed to a local store: every array read back is the raw trace."""
    import shutil
    import tempfile

    # a store in memory where the host has one: a disk-backed temporary
    # directory creates chunk files several times slower than tmpfs
    shm = "/dev/shm"
    root = tempfile.mkdtemp(prefix="chip_smoke_zarr_", dir=shm if os.path.isdir(shm) else tmp)
    try:
        return _zarr_checks(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _zarr_checks(ctx, root: str) -> dict:
    """The Zarr run into ``root`` and its read-back (``_control_zarr``)."""
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.storage.zarr_writer import read_zarr_array
    from nutpie_tpu_torch.trace import open_zarr_trace
    from nutpie_tpu_torch.zarr_store import LocalStore

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = nt.sample(compile_model_def(nt.models.radon()), progress_bar=False,
                       chains=CHAINS, tune=TUNE, draws=ZARR_DRAWS, save_warmup=False,
                       seed=42, pool_mass_matrix=True, pool_step_size=True, device=DEVICE,
                       return_raw_trace=True, zarr_store=LocalStore(root), blocking=False)
    raw = handle.wait(timeout=900)
    wall = time.perf_counter() - t0
    bad = _raw_diff(raw, ctx["main_raw"])
    assert not bad, f"the zarr run's raw trace is not the main phase's prefix: {bad}"
    trace = open_zarr_trace(LocalStore(root))
    groups = {"posterior": ("expanded", TUNE, TUNE + ZARR_DRAWS),
              "sample_stats": ("stats", TUNE, TUNE + ZARR_DRAWS)}
    jobs = [(g, name) for g, (src, _, _) in groups.items() for name in raw[src]
            if name != "divergence_message"]

    def check(job):
        import numpy as np


        group, name = job
        src, lo, hi = groups[group]
        want = raw[src][name][:, lo:hi]
        if want.dtype.kind in "OU":
            want = want.astype("<U128")
        ok = []
        for got in (read_zarr_array(root, f"{group}/{name}"), trace[group][name].values):
            bits = f"u{want.itemsize}" if want.dtype.kind == "f" else None
            ok.append(got.shape == want.shape and got.dtype == want.dtype and bool(
                np.array_equal(got.view(bits), want.view(bits)) if bits
                else np.array_equal(got, want)))
        return job, ok

    # one thread: the reader is Python around small reads and inflates, and
    # threads contending for the interpreter lock read slower than one
    t0 = time.perf_counter()
    results = [check(job) for job in jobs]
    read_s = time.perf_counter() - t0
    bad = [f"{g}/{n} ({'read_zarr_array' if not ok[0] else 'open_zarr_trace'})"
           for (g, n), ok in results if not all(ok)]
    assert not bad, f"arrays read back differ from the raw trace: {bad}"
    nbytes = files = 0
    for dirpath, _, names in os.walk(root):
        files += len(names)
        nbytes += sum(os.path.getsize(os.path.join(dirpath, n)) for n in names)
    return {"draws": TUNE + ZARR_DRAWS, "wall_s": wall,
            "main_wall_s": ctx["main_readings"]["wall_s"], "main_draws": TUNE + DRAWS,
            "store": os.path.dirname(root), "writer": handle.zarr_writer,
            "bytes_written": nbytes, "files": files, "arrays_checked": len(jobs),
            "read_back_s": read_s}


def _control_busy_caller(ctx) -> dict:
    """The GLM (cut as the profile phase cuts it) with ``blocking=False``
    while the calling thread runs matrix products on the card."""
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    compiled = compile_model_def(_glm_model())
    kwargs = dict(progress_bar=False, chains=GLM_CHAINS, tune=GLM_PROFILE_TUNE,
                  draws=GLM_PROFILE_DRAWS, seed=42, chunk_size=GLM_CHUNK,
                  precision="float32", device=DEVICE, return_raw_trace=True)
    ref = nt.sample(compiled, **kwargs)
    a = torch.randn(1024, 1024, device=DEVICE)
    torch.cuda.synchronize()
    _zero_counts(step_kernel, chunk_kernel)
    handle = nt.sample(compiled, blocking=False, **kwargs)
    products = 0
    t0 = time.perf_counter()
    while not handle.is_finished:
        a = torch.tanh(a @ a)
        products += 1
        if products % 32 == 0:
            torch.cuda.current_stream().synchronize()
    raw = handle.wait(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert step_kernel.replays > 0 and step_kernel.launches > 0, "no graph replays"
    assert chunk_kernel.launches == 0
    bad = _raw_diff(raw, ref)
    assert not bad, f"the run beside a busy caller differs from the blocking run in {bad}"
    return {"products": products, "wall_s": wall, "graph_replays": step_kernel.replays,
            "k2_launches": step_kernel.launches, "capture_s": step_kernel.capture_s,
            "pinned_bytes": handle.transfer.pinned_bytes}


def _sync_readings() -> dict:
    """Host syncs on the K1 route: a radon run (the main configuration, 128
    draws) under ``torch.cuda.set_sync_debug_mode("warn")``; each
    synchronizing call's file:line and count, the sampling thread's
    included (the warnings module is process-wide)."""
    import collections
    import warnings

    import torch

    import traceback as tb

    counts = collections.Counter()
    pkg = os.path.join(ROOT, "nutpie_tpu_torch")

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        # the innermost frame of the package that led to the synchronizing call
        frames = [f for f in tb.extract_stack() if f.filename.startswith(pkg)]
        where = frames[-1] if frames else None
        counts[f"{os.path.relpath(where.filename, ROOT)}:{where.lineno} ({where.name})"
               if where else f"{os.path.basename(filename)}:{lineno} (outside the package)"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _radon_background(None, draws=DRAWS).wait(timeout=600)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(counts.most_common())


def phase_control(ctx):
    """Background control, checkpoints and Zarr storage on the card."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_control_")
    failed: list = []
    readings = {}
    try:
        for name, fn in (("handle", lambda: _control_handle(ctx)),
                         ("resume", lambda: _control_resume(ctx, tmp)),
                         ("busy_caller", lambda: _control_busy_caller(ctx)),
                         ("syncs", _sync_readings),
                         ("zarr", lambda: _control_zarr(ctx, tmp))):
            t0 = time.perf_counter()
            readings[name] = _held(failed, fn)
            emit({"control": name, "s": round(time.perf_counter() - t0, 1),
                  "readings": readings[name]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "control", **readings, "card": ctx["card"]})
    assert not failed, failed


# ---------------------------------------------------------------- MCLMC (K3)

# the MCLMC parity cases (MclmcConfig fields) on the GLM in float64: the
# three trajectory kinds, three steps a draw, a forced divergence
MCLMC_CASES = {
    "microcanonical": {},
    "euclidean": {"trajectory": "euclidean"},
    "euclidean_then_microcanonical": {"trajectory": "euclidean_then_microcanonical"},
    "steps3": {"steps_per_draw": 3},
    "divergence": {"max_energy_error": 0.05},
}
# the parity schedule: 16 tuning draws with early switches every 4 draws
# (the early phase ends at draw 4), so the 8-draw warmup window from draw 0
# crosses the switch at draw 3, and the frozen chunk starts at draw 16
MCLMC_PARITY_TUNE, MCLMC_EARLY_SWITCH = 16, 4
MCLMC_WARM_DRAWS, MCLMC_FROZEN_DRAWS, MCLMC_F32_DRAWS = 8, 16, 32
MCLMC_LR_CHAINS = 16
# K3's strided form (the diagonal metric past dim 64): the 100-d Gaussian
MCLMC_STRIDED_DIM = 100
# K3's low-rank forms in float64 (tag, dim, rank, MclmcConfig fields):
# streamed, staged by TMA, staged by loads (a 33 x 5 basis of 8-byte values,
# 1320 bytes, is not 16-byte aligned), a chain's coordinates past four a
# thread of the block (staged by TMA), and the loads case with a forced
# divergence (a divergent draw's end reads the normals kept in the work row)
MCLMC_LR_CASES = (("dim1000_rank32", LR_DIM, LR_RANK, {}),
                  ("dim500_rank32", 500, LR_RANK, {}),
                  ("dim33_rank5", 33, 5, {}), ("dim1100_rank8", 1100, 8, {}),
                  ("dim33_rank5_divergence", 33, 5, MCLMC_CASES["divergence"]))
# the float32 low-rank chunk at the path's shapes (staged)
MCLMC_LR_F32_DRAWS = 8


def _mclmc_cfg(tune: int, low_rank=None, **fields):
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.mclmc import MclmcConfig

    cfg = MclmcConfig(adapt=AdaptConfig(num_tune=tune, early_switch_freq=MCLMC_EARLY_SWITCH),
                      low_rank=low_rank, **fields)
    return cfg, make_schedule(cfg.adapt, tune)


def _mclmc_init(model, cfg, n_chains, dtype, seed):
    import numpy as np

    from nutpie_tpu_torch.sampler.mclmc import init_mclmc_chains

    states, ok = init_mclmc_chains(model, cfg, seed, n_chains, np.zeros(model.ndim), dtype,
                                   device=DEVICE)
    assert bool(ok.all()), "chain initialization failed"
    return states


def _k3_eager(model, cfg, sched, states, start: int, chunk: int):
    """One chunk through K3 with its launches made one by one, no graph,
    then the runner's low-rank update: (state, buffers)."""
    from nutpie_tpu_torch.sampler.mclmc import update_low_rank

    st, bufs, steps = _k3_chunk(cfg, sched, states, start, chunk)
    z = steps.begin(st)
    for _ in range(chunk * cfg.steps_per_draw):
        _, g = model.logp_and_grad(z)
        z = steps.kick(st, z, g)
        logp, g = model.logp_and_grad(z)
        z = steps.settle(st, z, logp, g)
    return update_low_rank(cfg, st, bufs, start, chunk, sched), bufs


def _mclmc_both(model, cfg, sched, states, start: int, chunk: int, graph: bool = False):
    """K3 (launched one by one, or from the runner's graph) and its plain
    version on one chunk from one state: ((state, buffers) of each)."""
    from nutpie_tpu_torch.sampler.mclmc import MclmcChunkRunner

    dtype = states.vecs.dtype
    if graph:
        k = MclmcChunkRunner(model, cfg, chunk, dtype)(states, start, chunk, sched)
    else:
        k = _k3_eager(model, cfg, sched, states, start, chunk)
    p = MclmcChunkRunner(model, cfg, chunk, dtype, plain=True)(states, start, chunk, sched)
    return k, p


def _check_mclmc(tag, sk, bk, sp, bp, rtol, atol) -> float:
    """K3 against its plain version: ints, the Welford counts and the
    divergence flags exact, floats to the given tolerance."""
    import torch

    assert torch.equal(sk.ints, sp.ints), f"{tag}: ints differ"
    assert torch.equal(bk.diverging, bp.diverging), f"{tag}: diverging differs"
    for name, a, b in (("position", bk.position, bp.position),
                       ("scalars", bk.scalars, bp.scalars),
                       ("vecs", sk.vecs, sp.vecs), ("flts", sk.flts, sp.flts),
                       ("adapt_vecs", sk.adapt_vecs, sp.adapt_vecs),
                       ("adapt_flts", sk.adapt_flts, sp.adapt_flts)):
        assert_close(f"{tag} {name}", a, b, rtol, atol)
    for name in ("gradient", "mass_matrix_inv"):
        if getattr(bk, name) is not None:
            assert_close(f"{tag} {name}", getattr(bk, name), getattr(bp, name), rtol, atol)
    return max_abs(bk.position, bp.position)


def _mclmc_glm_case(tag: str, fields: dict, model=None, n_chains: int = STEP_PARITY_CHAINS) -> dict:
    """One float64 case (the GLM unless ``model``): the warmup window from
    draw 0 (rtol 1e-3), the kernel's own run to the end of tuning, then a
    frozen chunk (rtol 1e-6, atol 1e-8)."""
    import torch

    from nutpie_tpu_torch.sampler.mclmc import MclmcChunkRunner

    model = _glm_model() if model is None else model
    cfg, sched = _mclmc_cfg(MCLMC_PARITY_TUNE, **fields)
    states = _mclmc_init(model, cfg, n_chains, torch.float64, 5)
    (sk, bk), (sp, bp) = _mclmc_both(model, cfg, sched, states, 0, MCLMC_WARM_DRAWS)
    warm = _check_mclmc(f"{tag} warmup", sk, bk, sp, bp, 1e-3, 1e-3)
    run = MclmcChunkRunner(model, cfg, MCLMC_PARITY_TUNE - MCLMC_WARM_DRAWS, torch.float64)
    sk, _ = run(sk, MCLMC_WARM_DRAWS, MCLMC_PARITY_TUNE - MCLMC_WARM_DRAWS, sched)
    (fk, fbk), (fp, fbp) = _mclmc_both(model, cfg, sched, sk, MCLMC_PARITY_TUNE,
                                       MCLMC_FROZEN_DRAWS)
    frozen = _check_mclmc(f"{tag} frozen", fk, fbk, fp, fbp, 1e-6, 1e-8)
    return {"warmup_max_abs": warm, "frozen_max_abs": frozen,
            "divergences": int(bk.diverging.sum()) + int(fbk.diverging.sum())}


def _mclmc_lr_fleet(n_chains: int, dtype, seed: int, cutoff: float, tune: int,
                    dim: int = LR_DIM, rank: int = LR_RANK, **fields):
    """An MCLMC fleet of the 1000-d Gaussian at exact posterior draws with
    the diagonal and low-rank estimates of ``_lr_fleet``, past tuning
    (``fields``: more of the ``MclmcConfig``)."""
    import torch

    from nutpie_tpu_torch.models import ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler.low_rank import estimate_low_rank
    from nutpie_tpu_torch.sampler.mclmc import M_INT, M_VEC
    from nutpie_tpu_torch.sampler.nuts import LowRankConfig
    from nutpie_tpu_torch.sampler.state import ADAPT_VEC_SLOTS

    model = ill_conditioned_gaussian(dim=dim)
    cfg, sched = _mclmc_cfg(tune, low_rank=LowRankConfig(eigval_cutoff=cutoff,
                                                         max_rank=rank), **fields)
    states = _mclmc_init(model, cfg, n_chains, dtype, seed)
    x, g = _lr_posterior(n_chains, LR_WINDOW + 1, seed, dim)
    win_x, win_g = x[:, :LR_WINDOW], g[:, :LR_WINDOW]
    inv_mass = torch.sqrt(win_x.var(dim=1) / win_g.var(dim=1))
    valid = torch.ones((n_chains, LR_WINDOW), dtype=torch.bool, device=DEVICE)
    lr = cfg.low_rank
    metric = estimate_low_rank(win_x, win_g, valid, inv_mass, lr.max_rank, lr.eigval_cutoff,
                               lr.gamma)
    pos = x[:, -1].to(dtype)
    logp, grad = model.logp_and_grad(pos)
    vecs = states.vecs.clone()
    vecs[:, M_VEC["position"]] = pos
    vecs[:, M_VEC["gradient"]] = grad.to(dtype)
    flts = states.flts.clone()
    flts[:, 0] = logp.to(dtype)
    ints = states.ints.clone()
    ints[:, M_INT["draw_idx"]] = tune
    adapt_vecs = states.adapt_vecs.clone()
    adapt_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]] = inv_mass.to(dtype)
    states = states.replace(vecs=vecs, flts=flts, ints=ints, adapt_vecs=adapt_vecs,
                            lr_basis=metric.basis.to(dtype).contiguous(),
                            lr_log_eigs=metric.log_eigs.to(dtype).contiguous())
    return model, cfg, sched, states


def _mclmc_f32_shares(bk, bp) -> dict:
    """Float32 kernel against plain: the shares of equal divergence flags and
    of close draws."""
    pk, pp = bk.position, bp.position
    return {
        "share_equal_diverging": float((bk.diverging == bp.diverging).double().mean()),
        "share_draws_within_tol": float(((pk - pp).abs() <= F32_TOL * (1.0 + pp.abs()))
                                        .all(-1).double().mean()),
        "max_rel_diff_position": max_rel(pk, pp),
        "divergences": int(bk.diverging.sum()),
    }


def phase_mclmc_parity(ctx):
    """K3 against its plain version on the card (see the docstring)."""
    import torch

    from nutpie_tpu_torch.models import ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel

    failed, out = [], {"glm_f64": {}, "lowrank_f64": {}, "plans": {}}
    for tag, fields in MCLMC_CASES.items():
        out["glm_f64"][tag] = _held(failed, _mclmc_glm_case, tag, fields)
    out["plans"]["glm_f64"] = mclmc_kernel.plan(STEP_PARITY_CHAINS, GLM_DIM, 0, torch.float64,
                                                DEVICE).form
    # the strided form: the diagonal metric past dim 64
    smodel = ill_conditioned_gaussian(dim=MCLMC_STRIDED_DIM)
    out["strided_f64"] = _held(failed, _mclmc_glm_case, "strided", {}, smodel,
                               MCLMC_LR_CHAINS)
    # and with a forced divergence: the draw's end reads the kept normals
    out["strided_f64_divergence"] = _held(failed, _mclmc_glm_case, "strided divergence",
                                          MCLMC_CASES["divergence"], smodel, MCLMC_LR_CHAINS)
    out["plans"]["strided_f64"] = mclmc_kernel.plan(MCLMC_LR_CHAINS, MCLMC_STRIDED_DIM, 0,
                                                    torch.float64, DEVICE).form
    # the low-rank forms, a frozen chunk each
    for tag, dim, rank, fields in MCLMC_LR_CASES:
        model, cfg, sched, states = _mclmc_lr_fleet(MCLMC_LR_CHAINS, torch.float64, 9,
                                                    LR_CUTOFF_ALL, MCLMC_PARITY_TUNE, dim, rank,
                                                    **fields)
        plan = mclmc_kernel.plan(MCLMC_LR_CHAINS, dim, rank, torch.float64, DEVICE,
                                 aligned=states.lr_basis.data_ptr() % 16 == 0)
        out["plans"][f"lowrank_f64_{tag}"] = f"{plan.form} by {plan.copy}"
        (sk, bk), (sp, bp) = _mclmc_both(model, cfg, sched, states, MCLMC_PARITY_TUNE,
                                         MCLMC_FROZEN_DRAWS)
        out["lowrank_f64"][tag] = _held(failed, lambda: {"max_abs": _check_mclmc(
            f"lowrank {tag} frozen", sk, bk, sp, bp, 1e-6, 1e-8),
            "divergences": int(bk.diverging.sum())})
        del model, states, sk, bk, sp, bp
    # float32 at the GLM's main shapes: a fresh fleet past tuning, one
    # frozen chunk; then the graph's replays against the launches made one
    # by one, bitwise, and a second run from the same state, bitwise
    model = _glm_model()
    cfg, sched = _mclmc_cfg(MCLMC_PARITY_TUNE)
    states = _mclmc_init(model, cfg, GLM_CHAINS, torch.float32, 42)
    states = states.replace(ints=states.ints.clone().index_fill_(
        1, torch.tensor([0], device=DEVICE), MCLMC_PARITY_TUNE))
    (sk, bk), (sp, bp) = _mclmc_both(model, cfg, sched, states, MCLMC_PARITY_TUNE,
                                     MCLMC_F32_DRAWS)
    f32 = _mclmc_f32_shares(bk, bp)
    out["glm_f32"] = f32
    out["plans"]["glm_f32"] = mclmc_kernel.plan(GLM_CHAINS, GLM_DIM, 0, torch.float32,
                                                DEVICE).form
    (gk, gbk), _ = _mclmc_both(model, cfg, sched, states, MCLMC_PARITY_TUNE, MCLMC_F32_DRAWS,
                               graph=True)
    same = lambda s1, b1, s2, b2: all(bitwise_equal(x, y) for x, y in (
        (b1.position, b2.position), (b1.scalars, b2.scalars), (s1.vecs, s2.vecs),
        (s1.flts, s2.flts), (s1.ints, s2.ints)))
    replay_bitwise = same(gk, gbk, sk, bk)
    rk, rbk = _k3_eager(model, cfg, sched, states, MCLMC_PARITY_TUNE, MCLMC_F32_DRAWS)
    rerun_bitwise = same(rk, rbk, sk, bk)
    out["graph_replay_bitwise"] = replay_bitwise
    out["rerun_bitwise"] = rerun_bitwise
    del sk, bk, sp, bp, gk, gbk, rk, rbk
    # float32 under the low-rank metric at the path's shapes (staged)
    lmodel, lcfg, lsched, lstates = _mclmc_lr_fleet(LR_CHAINS, torch.float32, 12, LR_CUTOFF,
                                                    MCLMC_PARITY_TUNE)
    (sk, bk), (sp, bp) = _mclmc_both(lmodel, lcfg, lsched, lstates, MCLMC_PARITY_TUNE,
                                     MCLMC_LR_F32_DRAWS)
    lr32 = _mclmc_f32_shares(bk, bp)
    out["lowrank_f32"] = lr32
    out["plans"]["lowrank_f32"] = mclmc_kernel.plan(LR_CHAINS, LR_DIM, LR_RANK, torch.float32,
                                                    DEVICE).form
    ctx["mclmc_max_abs_err"] = max(
        [v["frozen_max_abs"] for v in out["glm_f64"].values() if isinstance(v, dict)
         and "frozen_max_abs" in v] + [0.0])
    ctx["mclmc_lr_max_abs_err"] = max(
        [v["max_abs"] for v in out["lowrank_f64"].values() if isinstance(v, dict)
         and "max_abs" in v] + [0.0])
    emit({"phase": "mclmc_parity", **out})
    for tag, shares in (("GLM", f32), ("low-rank", lr32)):
        if shares["share_equal_diverging"] < F32_MIN_SHARE_STEPS:
            failed.append(f"float32 {tag} diverging share {shares['share_equal_diverging']}")
        if shares["share_draws_within_tol"] < F32_MIN_SHARE_DRAWS:
            failed.append(f"float32 {tag} draws share {shares['share_draws_within_tol']}")
    if not replay_bitwise:
        failed.append("graph replay not bitwise the launches one by one")
    if not rerun_bitwise:
        failed.append("two runs from one state not bitwise equal")
    assert not failed, failed


# ------------------------------------------- K2's microcanonical kinetic

# the float64 low-rank cases of K2's microcanonical instantiations (as
# LR_F64_CASES): dim 33 at rank 5 (staged by loads) and the path's dim
# 1000 at rank 32 (streamed), trees to depth 6
# (the frozen chunks 8 and 4 draws until the flow phases joined the script)
MICRO_LR_CASES = (
    ("dim33_rank5", 33, 5, LR_CUTOFF_ALL, 2, 6, (2, 2)),
    ("dim1000_rank32", LR_DIM, LR_RANK, LR_CUTOFF_ALL, 0, 6, (2, 2)),
)
# the float32 micro share chunk: 16 draws until the flow phases joined the
# script, 8 until a slower host took it past its time limit; the float64
# frozen chunks of the GLM and radon (8 draws until then)
MICRO_RADON_CHAINS, MICRO_F32_DRAWS, MICRO_FROZEN = 16, 4, 4
# the GLM's warmup window from a fresh fleet: the isokinetic trees of the
# first draws run to the depth cap (255 leapfrogs), over which rounding
# grows fast: two plain versions that round differently (the card's and
# the CPU's, read beside the window) part by about 2e-3 in a position over
# the first 4 draws, and over 8 K2 and the card's plain version parted past
# the 1e-3 bar in one chain's gradient Welford rows with every tree
# decision equal, so the window takes 4 draws, as K1's fresh-fleet windows
# do (WINDOWS)
MICRO_GLM_WARM = 4
# a second GLM warmup window later in tuning, where the trees have left the
# depth cap (3 to 63 leapfrogs a draw from draw 5 on, by the plain version
# on four chains of the same fleet): K2 carries the fleet to draw
# MICRO_GLM_LATE, then K2 and the plain halves run MICRO_GLM_LATE_WARM
# draws from its state, each through the Welford adds and the inverse-mass
# estimate.  Its integers (tree decisions, step counts, Welford counts) are
# held exact; its floats are read, not held: from one state nudged by one
# ulp, the plain version parts from itself past the 1e-3 bar in the
# gradient Welford rows by the window's 6th draw, with every integer equal
# (scripts/micro_warmup_sensitivity.py, from draws 24 and 120).  Radon's
# 8-draw window (below) holds K2's micro Welford and estimate path at the
# float bars
MICRO_GLM_LATE, MICRO_GLM_LATE_WARM = 24, 8
# chains of the warmup window the CPU's plain version also runs (the
# yardstick: how far two plain versions that round differently part)
MICRO_YARD_CHAINS = 4
# the micro phase's sample() run: the GLM with its posterior cut to 32
# draws (100 at first, cut for the script's time limit), and
# its posterior divergence bar (tests/test_sample.py:234-235)
MICRO_GLM_DRAWS, MICRO_MAX_DIV_SHARE = 32, 0.01


def _micro_cfg(tune: int, **fields):
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import NutsConfig

    cfg = NutsConfig(kinetic="microcanonical", adapt=AdaptConfig(num_tune=tune), **fields)
    return cfg, make_schedule(cfg.adapt, tune, cfg.initial_depth_cap)


def _micro_pair(failed, tag, model, cfg, sched, states, n_warm, n_frozen, lowrank=False,
                yardstick=False):
    """K2's micro instantiations against the plain halves: a warmup window
    from draw 0, then a frozen chunk from the kernel's state; with
    ``yardstick``, the plain version on the CPU against the card's over the
    warmup window too."""
    import torch

    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, states, 0, n_warm, n_warm, False)
    warm = _held(failed, _check_warmup_f64, f"micro {tag} warmup", n_warm, s_k, b_k, s_p, b_p)
    yard = None
    if yardstick:
        # the CPU's plain version on the first MICRO_YARD_CHAINS chains
        # (each chain runs on its own: the same draws as in the fleet)
        from nutpie_tpu_torch.sampler.state import NutsMachineState

        few = NutsMachineState(**{k: v[:MICRO_YARD_CHAINS] for k, v in
                                  states.tensors().items()})
        s_few = NutsMachineState(**{k: v[:MICRO_YARD_CHAINS] for k, v in
                                    s_p.tensors().items()})
        b_few = b_p._replace(**{k: v[:MICRO_YARD_CHAINS] for k, v in b_p._asdict().items()
                                if v is not None})
        yard = _yardstick(n_warm, (s_few, b_few),
                          _plain_on_cpu(model, cfg, sched, few, 0, n_warm, n_warm, False))
    (f_k, fb_k), (f_p, fb_p) = _steps_both(model, cfg, sched, s_k, n_warm, n_frozen, n_frozen,
                                           True)
    check = _check_lowrank_frozen_f64 if lowrank else _check_frozen_f64
    frozen = _held(failed, check, f"micro {tag} frozen", f_k, fb_k, f_p, fb_p)
    return {"warmup": {"draws": n_warm, "max_abs_err_position": warm,
                       "ints_equal": bool(torch.equal(s_k.ints, s_p.ints)),
                       **({"plain_card_vs_cpu": yard} if yard else {})},
            "frozen": {"draws": n_frozen, "max_abs_err_position": frozen,
                       "ints_equal": bool(torch.equal(f_k.ints, f_p.ints))}}


def micro_parity(ctx) -> list:
    """K2's microcanonical instantiations against the plain halves on the
    card: float64 on the GLM, the low-rank cases and radon through the step
    route; float32 shares at the GLM's main shapes."""
    import dataclasses as dc

    import torch

    from nutpie_tpu_torch.models import radon
    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS
    from nutpie_tpu_torch.sampler.run import make_chunk_runner

    failed, out = [], {}
    model = _glm_model()
    cfg, sched = _micro_cfg(GLM_TUNE)
    states = _init(model, cfg, STEP_PARITY_CHAINS, torch.float64, 21)
    out["glm_f64"] = _micro_pair(failed, "GLM", model, cfg, sched, states, MICRO_GLM_WARM,
                                 MICRO_FROZEN, yardstick=True)
    carry = make_chunk_runner(model, cfg, MICRO_GLM_LATE, torch.float64, adapt_frozen=False)
    late, _ = carry(states, 0, MICRO_GLM_LATE, sched)
    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, late, MICRO_GLM_LATE,
                                         MICRO_GLM_LATE_WARM, MICRO_GLM_LATE_WARM, False)
    ints_held = _held(failed, _check_warmup_ints, "micro GLM late warmup",
                      MICRO_GLM_LATE_WARM, s_k, b_k, s_p, b_p)
    leapfrogs = b_k.scalars[:, :MICRO_GLM_LATE_WARM, SCALAR_SLOTS["n_steps"]]
    out["glm_f64"]["late_warmup"] = {
        "from_draw": MICRO_GLM_LATE, "draws": MICRO_GLM_LATE_WARM,
        "ints_held": bool(ints_held),
        "max_abs_err_position": max_abs(b_k.position[:, :MICRO_GLM_LATE_WARM],
                                        b_p.position[:, :MICRO_GLM_LATE_WARM]),
        "max_abs_err_adapt_vecs": max_abs(s_k.adapt_vecs, s_p.adapt_vecs),
        "leapfrogs_mean": float(leapfrogs.mean()), "leapfrogs_max": int(leapfrogs.max())}
    del late, s_k, b_k, s_p, b_p
    ctx["micro_max_abs_err"] = out["glm_f64"]["frozen"]["max_abs_err_position"]
    for tag, dim, rank, cutoff, padded, maxdepth, (n_warm, n_frozen) in MICRO_LR_CASES:
        lmodel, lcfg, lsched, lstates, _ = _lr_fleet(LR_PARITY_CHAINS, torch.float64, 31,
                                                     cutoff, dim, rank, padded, maxdepth)
        lcfg = dc.replace(lcfg, kinetic="microcanonical")
        out[f"lowrank_{tag}"] = _micro_pair(failed, f"low-rank {tag}", lmodel, lcfg, lsched,
                                            lstates, n_warm, n_frozen, lowrank=True)
    rmodel = radon()
    rcfg, rsched = _micro_cfg(TUNE, maxdepth=6)
    rstates = _init(rmodel, rcfg, MICRO_RADON_CHAINS, torch.float64, 23)
    out["radon_f64"] = _micro_pair(failed, "radon", rmodel, rcfg, rsched, rstates, 8,
                                   MICRO_FROZEN)
    # float32 at the GLM's main shapes: the step_parity phase's fleet
    # warmed through tuning (by the exact-normal kinetic) and one frozen
    # chunk under the microcanonical one
    wmodel, wcfg, wsched, warm32 = ctx["glm_warm"]
    wcfg = dc.replace(wcfg, kinetic="microcanonical")
    (s_k, b_k), (_, b_p) = _steps_both(wmodel, wcfg, wsched, warm32, GLM_TUNE,
                                       MICRO_F32_DRAWS, MICRO_F32_DRAWS, True)
    f32 = _f32_shares(MICRO_F32_DRAWS, s_k, b_k, b_p)
    out["glm_f32"] = f32
    # the step timing's fleet: the same, its draw counter at 0 (the timing
    # helpers run a chunk from draw 0; the adaptation stays frozen)
    ctx["micro_fleet"] = (wmodel, wcfg, wsched, warm32.replace(
        ints=warm32.ints.clone().index_fill_(1, torch.tensor([0], device=DEVICE), 0)))
    emit({"phase": "micro_parity", **out, "failed": failed})
    if f32["share_equal_n_steps"] < F32_MIN_SHARE_STEPS:
        failed.append(f"micro float32 n_steps share {f32['share_equal_n_steps']}")
    if f32["share_draws_within_tol"] < F32_MIN_SHARE_DRAWS:
        failed.append(f"micro float32 draws share {f32['share_draws_within_tol']}")
    return failed


def _glm_posterior_bars(post) -> dict:
    """The glm phase's posterior bars on ``post [C, N, dim]`` (float32
    draws): R-hat over the monitored columns, means against the Laplace
    mode and the importance-sampled mean.  Returns the readings; the first
    bar missed raises."""
    import numpy as np

    from nutpie_tpu_torch.models.analytic import glm_data

    assert np.isfinite(post).all(), "non-finite draws"
    ess, rhat = column_diagnostics(post, GLM_MONITORED)
    X, y = glm_data(GLM_N_DATA, GLM_DIM)
    mode, cov = laplace(X, y)
    sd = np.sqrt(np.diag(cov))
    mean = post.reshape(-1, GLM_DIM).mean(axis=0, dtype=np.float64)
    dev = np.abs(mean - mode) / sd
    is_mean, _ = importance_mean(X, y, mode, cov)
    is_dev = np.abs(mean - is_mean) / sd
    out = {"min_bulk_ess": float(np.min(ess)), "max_rhat": float(max(rhat)),
           "laplace_max_dev_sd": float(dev.max()), "laplace_tol_sd": LAPLACE_SD_TOL,
           "importance_mean_max_dev_sd": float(is_dev.max()),
           "importance_tol_sd": IMPORTANCE_SD_TOL}
    return out


def _assert_glm_bars(r: dict) -> None:
    assert math.isfinite(r["min_bulk_ess"]) and r["min_bulk_ess"] > 0, r
    assert r["max_rhat"] < 1.05, f"split R-hat {r['max_rhat']} on a monitored column"
    assert r["importance_mean_max_dev_sd"] <= IMPORTANCE_SD_TOL, \
        f"posterior mean {r['importance_mean_max_dev_sd']} sd from the importance-sampled mean"
    assert r["laplace_max_dev_sd"] <= LAPLACE_SD_TOL, \
        f"posterior mean {r['laplace_max_dev_sd']} sd from the Laplace mode"


# the MCLMC path: the GLM at bench_glm.py's width (as the glm phase); the
# correlated Gaussian of tests/test_mclmc.py (dim 8, factor 40) under
# low-rank MCLMC at 1024 chains with tests/test_mclmc.py's tuning and its
# variance-ratio bar; low-rank MCLMC on the 1000-d Gaussian (1024 chains x
# (300 + 100), cutoff LR_CUTOFF), whose slots are held and whose variance
# ratios and R-hat are readings (the reference holds MCLMC on it nowhere)
MCLMC_CORR_CHAINS, MCLMC_CORR_TUNE, MCLMC_CORR_DRAWS = 1024, 1200, 300
# the GLM under MCLMC tunes for 1200 draws: one step a draw does not reach
# this posterior in 300, in the JAX package as in the port
# (scripts/mclmc_glm_reference.py, CPU, 64 chains, seed 42: max R-hat 8.24
# and posterior means 8.2 sd from the Laplace mode after 300 tuning draws,
# both packages; after 1200, R-hat 1.041 and 0.219 sd; the JAX package at
# 1024 chains after 1200: R-hat 1.030, 0.229 sd from the mode and 0.034 sd
# from the importance-sampled mean, within the glm phase's bars)
MCLMC_GLM_TUNE = 1200
MCLMC_CORR_BAND = (0.5, 1.5)
MCLMC_LR_TUNE, MCLMC_LR_DRAWS = 300, 100


def _k3_launches(chunks: int, draws: int, steps_per_draw: int) -> int:
    """K3's launches for a run: one begin a chunk, a kick and a settle a step."""
    return chunks + 2 * steps_per_draw * draws


def _zero_all(*kernels) -> None:
    for k in kernels:
        k.launches = 0
        if hasattr(k, "replays"):
            k.replays = 0
            k.capture_s = 0.0


def _correlated_gaussian(dim: int = 8, factor: float = 40.0, seed: int = 0):
    """tests/test_mclmc.py:_correlated_gaussian, batched in torch."""
    import numpy as np
    import torch

    from nutpie_tpu_torch.model import make_model

    rng = np.random.default_rng(seed)
    u = rng.standard_normal((dim, 1))
    u /= np.linalg.norm(u)
    cov = np.eye(dim) + factor * (u @ u.T)
    prec = np.linalg.inv(cov)
    cache = {}

    def logp(x):
        key = (x.device, x.dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(prec, dtype=x.dtype, device=x.device)
        return -0.5 * torch.sum((x @ cache[key]) * x, dim=1)

    return make_model(dim, logp, param_vars=[("x", np.float64, (dim,),
                                              ("unconstrained_parameter",))]), cov


def phase_mclmc(ctx):
    """``sample(sampler="mclmc")`` on the card (see the docstring)."""
    import nutpie_tpu_torch.sampler.mclmc as mclmc_module

    # the card's route makes no normals tensor: every call of draw_normals
    # during this phase is counted (K3 draws the refresh normals itself)
    draw_normals = mclmc_module.draw_normals
    normals_calls = []

    def counted_draw_normals(*args, **kwargs):
        normals_calls.append(args[1:])
        return draw_normals(*args, **kwargs)

    mclmc_module.draw_normals = counted_draw_normals
    try:
        return _mclmc_runs(ctx, normals_calls)
    finally:
        mclmc_module.draw_normals = draw_normals


def _mclmc_runs(ctx, normals_calls: list):
    """The mclmc phase's three runs (``phase_mclmc``)."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.models import ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    # the GLM: every chunk through K3, no K1 or K2
    compiled = compile_model_def(_glm_model())
    torch.cuda.synchronize()
    _zero_all(mclmc_kernel, step_kernel, chunk_kernel)
    t0 = time.perf_counter()
    raw = nt.sample(compiled, sampler="mclmc", progress_bar=False, chains=GLM_CHAINS,
                    tune=MCLMC_GLM_TUNE, draws=GLM_DRAWS, seed=42, chunk_size=GLM_CHUNK,
                    precision="float32", device=DEVICE, return_raw_trace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k2, k1 = mclmc_kernel.launches, step_kernel.launches, chunk_kernel.launches
    assert not normals_calls, f"draw_normals called on the card's route: {normals_calls}"
    total = MCLMC_GLM_TUNE + GLM_DRAWS
    chunks = math.ceil(total / GLM_CHUNK)
    want = _k3_launches(chunks, total, 1)
    assert k1 == 0 and k2 == 0, f"K1 launched {k1}, K2 {k2} times on the MCLMC path"
    assert k3 == want, f"K3 launched {k3} times, the design gives {want}"
    assert mclmc_kernel.replays == total, (mclmc_kernel.replays, total)
    pos = raw["position"]
    assert pos.shape == (GLM_CHAINS, total, GLM_DIM) and pos.dtype == np.float32, pos.shape
    n_steps = raw["stats"]["n_steps"]
    grads = 2 * int(n_steps.astype(np.int64).sum())
    post = pos[:, MCLMC_GLM_TUNE:]
    bars = _glm_posterior_bars(post)
    ctx["mclmc_launches"] = k3
    ctx["mclmc_graphs"] = {"graph_replays": mclmc_kernel.replays,
                           "capture_s": mclmc_kernel.capture_s}
    glm = {"chains": GLM_CHAINS, "tune": MCLMC_GLM_TUNE, "draws": GLM_DRAWS,
           "chunk_len": GLM_CHUNK,
           "mclmc_kernel_launches": k3, "step_kernel_launches": k2,
           "chunk_kernel_launches": k1, "chunks": chunks, **ctx["mclmc_graphs"],
           "wall_s": wall, "gradients": grads, "grads_per_s": grads / wall,
           "host_wall_ms_per_step": 1e3 * wall / total,
           "min_ess_per_s": bars["min_bulk_ess"] / wall,
           "min_ess_per_grad": bars["min_bulk_ess"] / grads,
           "posterior_divergences": int(raw["stats"]["diverging"][:, MCLMC_GLM_TUNE:].sum()),
           "final_step_size_median": float(np.median(raw["stats"]["step_size"][:, -1])),
           **bars}
    failed = []
    _held(failed, _assert_glm_bars, bars)

    # low-rank MCLMC on the correlated Gaussian: tests/test_mclmc.py's bar
    model_def, cov = _correlated_gaussian()
    torch.cuda.synchronize()
    _zero_all(mclmc_kernel)
    t0 = time.perf_counter()
    tr = nt.sample(compile_model_def(model_def), sampler="mclmc", adaptation="low_rank",
                   chains=MCLMC_CORR_CHAINS, tune=MCLMC_CORR_TUNE, draws=MCLMC_CORR_DRAWS,
                   seed=11, progress_bar=False, device=DEVICE, return_raw_trace=True)
    torch.cuda.synchronize()
    x = tr["position"][:, MCLMC_CORR_TUNE:].reshape(-1, 8)
    ratio = np.var(x.astype(np.float64), axis=0) / np.diag(cov)
    corr = {"chains": MCLMC_CORR_CHAINS, "tune": MCLMC_CORR_TUNE, "draws": MCLMC_CORR_DRAWS,
            "wall_s": time.perf_counter() - t0, "launches": mclmc_kernel.launches,
            "variance_ratio_min": float(ratio.min()), "variance_ratio_max": float(ratio.max()),
            "band": MCLMC_CORR_BAND}
    if not (MCLMC_CORR_BAND[0] < ratio.min() and ratio.max() < MCLMC_CORR_BAND[1]):
        failed.append(f"correlated Gaussian variance ratios {ratio}")

    # low-rank MCLMC on the 1000-d Gaussian: the slots kept after each
    # boundary update are read
    import nutpie_tpu_torch.sampler.mclmc as mclmc_module

    updates = []
    update_low_rank = mclmc_module.update_low_rank

    def read_update(cfg, states, bufs, chunk_start, limit, sched):
        out = update_low_rank(cfg, states, bufs, chunk_start, limit, sched)
        if out is not states:
            kept = (out.lr_log_eigs != 0).sum(dim=1)
            updates.append({"end": chunk_start + limit,
                            "chains_with_a_kept_slot": int((kept > 0).sum()),
                            "mean_kept_slots": float(kept.double().mean())})
        return out

    model = compile_model_def(ill_conditioned_gaussian(dim=LR_DIM))
    mclmc_module.update_low_rank = read_update
    try:
        torch.cuda.synchronize()
        _zero_all(mclmc_kernel)
        t0 = time.perf_counter()
        raw_lr = nt.sample(model, sampler="mclmc", adaptation="low_rank", chains=LR_PATH_CHAINS,
                           tune=MCLMC_LR_TUNE, draws=MCLMC_LR_DRAWS, seed=42,
                           progress_bar=False, device=DEVICE, precision="float32",
                           mass_matrix_eigval_cutoff=LR_CUTOFF, return_raw_trace=True)
        torch.cuda.synchronize()
        lr_wall = time.perf_counter() - t0
    finally:
        mclmc_module.update_low_rank = update_low_rank
    x = raw_lr["position"][:, MCLMC_LR_TUNE:]
    q, eigs = _lr_truth(LR_DIM)
    var = x.astype(np.float64).reshape(-1, LR_DIM).var(axis=0)
    ratio = var / np.diag((q * eigs) @ q.T)
    ess, rhat = column_diagnostics(x, LR_MONITORED)
    lr = {"chains": LR_PATH_CHAINS, "tune": MCLMC_LR_TUNE, "draws": MCLMC_LR_DRAWS,
          "wall_s": lr_wall, "launches": mclmc_kernel.launches, "eigval_cutoff": LR_CUTOFF,
          "updates": updates, "max_rhat": float(max(rhat)),
          "min_bulk_ess": float(np.min(ess)), "variance_ratio_min": float(ratio.min()),
          "variance_ratio_max": float(ratio.max()),
          "posterior_divergences": int(raw_lr["stats"]["diverging"][:, MCLMC_LR_TUNE:].sum())}
    if not updates or updates[-1]["chains_with_a_kept_slot"] < 0.9 * LR_PATH_CHAINS:
        failed.append(f"low-rank MCLMC on the 1000-d Gaussian: slots kept {updates}")
    if normals_calls:
        failed.append(f"draw_normals called on the card's route: {normals_calls}")
    emit({"phase": "mclmc", "glm": glm, "correlated_gaussian_low_rank": corr,
          "gaussian_1000_low_rank": lr, "draw_normals_calls": len(normals_calls),
          "failed": failed, "card": ctx["card"]})
    assert not failed, failed


def phase_micro(ctx):
    """K2's microcanonical instantiations: parity, then ``sample(
    microcanonical_trajectory=True)`` on the GLM (see the docstring)."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.run import CUDA_UNROLL
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    failed = micro_parity(ctx)
    compiled = compile_model_def(_glm_model())
    torch.cuda.synchronize()
    _zero_all(mclmc_kernel, step_kernel, chunk_kernel)
    t0 = time.perf_counter()
    raw = nt.sample(compiled, progress_bar=False, chains=GLM_CHAINS, tune=GLM_TUNE,
                    draws=MICRO_GLM_DRAWS, seed=42, chunk_size=GLM_CHUNK,
                    precision="float32", device=DEVICE, return_raw_trace=True,
                    microcanonical_trajectory=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k1, k3 = step_kernel.launches, chunk_kernel.launches, mclmc_kernel.launches
    n_steps = raw["stats"]["n_steps"]
    steps = machine_steps(n_steps, GLM_CHUNK, CUDA_UNROLL)
    chunks = math.ceil((GLM_TUNE + MICRO_GLM_DRAWS) / GLM_CHUNK)
    assert k1 == 0 and k3 == 0, f"K1 launched {k1}, K3 {k3} times on the micro NUTS path"
    _assert_step_launches(step_kernel, chunks, steps, CUDA_UNROLL)
    pos = raw["position"]
    assert pos.shape == (GLM_CHAINS, GLM_TUNE + MICRO_GLM_DRAWS, GLM_DIM), pos.shape
    grads = int(n_steps.astype(np.int64).sum())
    bars = _glm_posterior_bars(pos[:, GLM_TUNE:])
    div = float(raw["stats"]["diverging"][:, GLM_TUNE:].mean())
    ctx["micro_launches"] = k2
    ctx["micro_graphs"] = {"launches_per_machine_step": k2 / steps,
                           "graph_replays": step_kernel.replays,
                           "capture_s": step_kernel.capture_s}
    emit({"phase": "micro", "chains": GLM_CHAINS, "tune": GLM_TUNE,
          "draws": MICRO_GLM_DRAWS, "chunk_len": GLM_CHUNK, "step_kernel_launches": k2,
          "chunk_kernel_launches": k1, "mclmc_kernel_launches": k3, "machine_steps": steps,
          "chunks": chunks, **ctx["micro_graphs"], "wall_s": wall,
          "host_wall_ms_per_machine_step": 1e3 * wall / steps, "gradients": grads,
          "grads_per_s": grads / wall, "min_ess_per_s": bars["min_bulk_ess"] / wall,
          "min_ess_per_grad": bars["min_bulk_ess"] / grads,
          "posterior_divergence_share": div, "max_divergence_share": MICRO_MAX_DIV_SHARE,
          **bars, "failed": failed, "card": ctx["card"]})
    _held(failed, _assert_glm_bars, bars)
    if div >= MICRO_MAX_DIV_SHARE:
        failed.append(f"posterior divergence share {div}")
    assert not failed, failed


# ---------------------------------------------------------------- flow adaptation
# The reference gate's configuration (tests/test_flow.py:242-288): the
# 100-d funnel at scale 1 (101 x coordinates beside v), the flow and the
# run; ESS and Fisher thresholds.  The float32 fleet runs the same model
# and flow config at FLOW_FLEET_CHAINS chains under the float32 recipe
# (sample._apply_f32_flow_recipe), which adds its learning-rate decay (the
# config's rate and steps win; 3e-4 and 1600 steps, the recipe's, took
# 105.6 s of training in a 127.4 s run of this script on an H100 80GB
# HBM3 at 700 W).  MCLMC with flow: tests/test_mclmc.py:98-108's model,
# seed and bars at 64 chains, its flows trained every FLOW_MCLMC_FREQ draws (the
# default 64 would be 13 trainings of 1600 steps in this script's time)
FLOW_DIM = 101
FLOW_GATE = dict(num_layers=5, hidden=32, train_steps=800, window=600, learning_rate=1e-3,
                 num_diag_updates=2, extension_share=0.4)
FLOW_GATE_RUN = dict(chains=2, tune=1200, draws=1000, seed=1, transform_update_freq=150)
FLOW_GATE_ESS, FLOW_GATE_FISHER = 1000.0, 0.1
# the float32 fleet's chains: 64 until the Stan phases brought the script
# near its time limit (its trainings are bound by the card, about linear
# in the chains)
FLOW_FLEET_CHAINS = 32
# (posterior draws 2000 until the Stan functionals' phases joined the script)
FLOW_MCLMC_CHAINS, FLOW_MCLMC_TUNE, FLOW_MCLMC_DRAWS, FLOW_MCLMC_FREQ = 64, 800, 1000, 200
# the parity fleets: 64 chains of the funnel under seeded flows whose
# couplings act (FLOW_PERTURB: the scale of each field's normals); K3's
# funnel fleet tunes FLOW_K3_TUNE draws (its first chunk held against the
# plain version, the rest the kernel's own) before its frozen chunk;
# chunk_flow_update on the card against the CPU with FLOW_TRAIN_STEPS
FLOW_PARITY_CHAINS, FLOW_PARITY_TUNE, FLOW_K3_TUNE = 64, 300, 16
# K2 with the orbit reservoir beside the divergence rows: a max_energy_error
# low enough that the fresh fleet's first draws diverge (the parity fails
# if none does), on 16 chains as the options' divergence-row cases run
# (a 64-chain pair took about 20 s of the phase)
FLOW_DIV = {"store_divergences": True, "max_energy_error": 0.5}
FLOW_DIV_CHAINS = 16
# the parity fleets' trees stop at depth 6, as the low-rank parity's small
# cases do: a fresh fleet's first draws run to the depth limit, and every
# code path of the step still runs (checks, merges, draws ended by a U-turn
# and by the limit)
FLOW_PARITY_MAXDEPTH = 6
FLOW_PERTURB = {"flow_mu": 0.3, "flow_log_sigma": 0.2, "flow_w2": 0.15, "flow_b2": 0.05}
FLOW_TRAIN_STEPS, FLOW_TRAIN_WINDOW = 20, 64
# the frozen chunks of the parity fleets, and the draws the fixed-metric
# steps are timed over (each machine step of the timing runs the flow's
# logp eagerly: 16 draws were 1,008 steps, 9 s of the phase); the frozen
# chunks took 8 draws until a slower host took the script past its time
# limit
FLOW_WARM_DRAWS, FLOW_FROZEN_DRAWS, FLOW_TIMED_DRAWS = 4, 4, 4


class _FlowLogp:
    """The pulled-back log density under fixed flows, as a model's
    ``logp_and_grad`` (the step runner builds the same from the state)."""

    def __init__(self, model, fcfg, params):
        self.model, self.fcfg, self.params = model, fcfg, params
        self.ndim = model.ndim

    def logp_and_grad(self, z):
        from nutpie_tpu_torch.transforms.flow import flow_logp_and_grad

        return flow_logp_and_grad(self.fcfg, self.model.logp_and_grad, self.params, z)


def _perturbed_flows(states, seed: int = 3, scales=None):
    """The state with each chain's flow moved to seeded parameters that act
    (``scales``: ``FLOW_PERTURB`` by default)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, scale in (scales or FLOW_PERTURB).items():
        t = getattr(states, name)
        noise = torch.randn(t.shape, generator=gen, dtype=torch.float64)
        out[name] = (scale * noise).to(device=t.device, dtype=t.dtype)
    return states.replace(**out)


def _flow_nuts_fleet(dtype, use_orbit: bool, seed: int, n_chains: int = FLOW_PARITY_CHAINS,
                     **nuts):
    from nutpie_tpu_torch.models import funnel
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import NutsConfig
    from nutpie_tpu_torch.transforms.flow import FlowConfig

    model = funnel(dim=FLOW_DIM, scale=1.0)
    cfg = NutsConfig(maxdepth=FLOW_PARITY_MAXDEPTH,
                     flow=FlowConfig(use_orbit=use_orbit, **FLOW_GATE),
                     adapt=AdaptConfig(num_tune=FLOW_PARITY_TUNE, update_mass_matrix=False),
                     **nuts)
    sched = make_schedule(cfg.adapt, FLOW_PARITY_TUNE)
    return model, cfg, sched, _perturbed_flows(_init(model, cfg, n_chains, dtype, seed))


def _flow_k2_pair(failed, tag, model, cfg, sched, states) -> dict:
    """K2 under the fixed metric against its plain version, float64: a
    fresh warmup window of ``FLOW_WARM_DRAWS``, then a frozen chunk of
    ``FLOW_FROZEN_DRAWS``
    from the kernel's state; the gradients (and orbit rows, and the
    divergence buffers) held beside the draws."""
    import torch

    w = FLOW_WARM_DRAWS
    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, states, 0, w, w, False)
    warm = _held(failed, _check_warmup_f64, f"{tag} warmup window", w, s_k, b_k, s_p, b_p)
    ok_metric = bool((s_k.inv_mass == 1.0).all())
    if not ok_metric:
        failed.append(f"{tag}: the fixed inverse mass moved")
    n = FLOW_FROZEN_DRAWS
    (f_k, fb_k), (f_p, fb_p) = _steps_both(model, cfg, sched, s_k, w, n, n, True)
    frozen = _held(failed, _check_frozen_f64, f"{tag} frozen chunk", f_k, fb_k, f_p, fb_p)
    rows = ["gradient"] + (["orbit_position", "orbit_gradient"] if cfg.use_orbit else [])
    for name in rows:
        _held(failed, assert_close, f"{tag} frozen {name}", getattr(fb_k, name),
              getattr(fb_p, name), 1e-6, 1e-8)
    if cfg.use_orbit:
        _held(failed, assert_close, f"{tag} orbit rows", f_k.orbit, f_p.orbit, 1e-6, 1e-8)
        _held(failed, assert_close, f"{tag} warmup orbit_position", b_k.orbit_position,
              b_p.orbit_position, 1e-3, 1e-3)
    div = {}
    if cfg.store_divergences:
        before = len(failed)
        _held(failed, _check_div_rows, f"{tag} warmup window", b_k, b_p, 1e-3, 1e-3)
        _held(failed, _check_div_rows, f"{tag} frozen chunk", fb_k, fb_p, 1e-6, 1e-8)
        divergent = int(b_k.diverging.sum() + fb_k.diverging.sum())
        if divergent == 0:
            failed.append(f"{tag}: no draw diverged")
        div = {"div_rows_held": len(failed) == before, "divergent_draws": divergent,
               "draws": int(b_k.diverging.numel() + fb_k.diverging.numel())}
    return {"warmup_held": warm is not None, "frozen_held": frozen is not None, **div,
            "inv_mass_fixed": ok_metric,
            "warmup_ints_equal": bool(torch.equal(s_k.ints, s_p.ints)),
            "frozen_ints_equal": bool(torch.equal(f_k.ints, f_p.ints)),
            "warmup_max_abs_err_position": max_abs(b_k.position, b_p.position),
            "frozen_max_abs_err_position": max_abs(fb_k.position, fb_p.position),
            "frozen_max_abs_err_orbit": (max_abs(fb_k.orbit_position, fb_p.orbit_position)
                                         if cfg.use_orbit else None)}


def _flow_update_parity(failed) -> dict:
    """chunk_flow_update on the card against the same function on the CPU,
    float64, FLOW_TRAIN_STEPS Adam steps on a seeded window of
    FLOW_TRAIN_WINDOW rows a chain, every chain past its diagonal phase:
    every output to rtol 1e-6, flow_updates exact."""
    import dataclasses as dc

    import numpy as np
    import torch

    from nutpie_tpu_torch.sampler.state import flow_window
    from nutpie_tpu_torch.transforms.flow import FlowWindow, chunk_flow_update

    model, cfg, _, states = _flow_nuts_fleet(torch.float64, False, 37)
    fcfg = dc.replace(cfg.flow, train_steps=FLOW_TRAIN_STEPS, window=FLOW_TRAIN_WINDOW)
    C, _, dim = states.vecs.shape
    rng = np.random.default_rng(5)
    z = rng.standard_normal((C, FLOW_TRAIN_WINDOW + 16, dim))
    g = -z * np.exp(0.3 * rng.standard_normal((C, 1, dim))) + 0.1 * rng.standard_normal(z.shape)
    W = FLOW_TRAIN_WINDOW
    win = flow_window(states)
    win = FlowWindow(win.flow, torch.full((C,), fcfg.num_diag_updates, dtype=torch.int32,
                                          device=DEVICE),
                     torch.as_tensor(z[:, :W], device=DEVICE),
                     torch.as_tensor(g[:, :W], device=DEVICE),
                     torch.ones((C, W), dtype=torch.bool, device=DEVICE))
    args = (states.position, states.gradient, states.logp,
            torch.as_tensor(z[:, W:], device=DEVICE), torch.as_tensor(g[:, W:], device=DEVICE),
            torch.ones((C, 16), dtype=torch.bool, device=DEVICE))
    cpu = lambda t: t.cpu()  # noqa: E731
    t0 = time.perf_counter()
    out_k = chunk_flow_update(fcfg, model.logp_and_grad, win, *args, in_warmup=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    win_c = FlowWindow(type(win.flow)(*map(cpu, win.flow)), *map(cpu, win[1:]))
    out_c = chunk_flow_update(fcfg, model.logp_and_grad, win_c, *map(cpu, args), in_warmup=True)
    (wk, *rest_k), (wc, *rest_c) = out_k, out_c
    worst = 0.0
    if not torch.equal(wk.flow_updates.cpu(), wc.flow_updates):
        failed.append("chunk_flow_update: flow_updates differ")
    pairs = list(zip(wk.flow._fields, wk.flow, wc.flow)) + [
        ("win_draws", wk.win_draws, wc.win_draws), ("position", rest_k[0], rest_c[0]),
        ("gradient", rest_k[1], rest_c[1]), ("logp", rest_k[2], rest_c[2])]
    for name, a, b in pairs:
        _held(failed, assert_close, f"chunk_flow_update {name}", a.cpu(), b, 1e-6, 1e-12)
        worst = max(worst, max_rel(a.cpu(), b))
    return {"chains": C, "dim": dim, "train_steps": FLOW_TRAIN_STEPS, "window": W,
            "flow_updates": int(wk.flow_updates.sum()), "max_rel_diff": worst,
            "card_s": card_s, "rtol": 1e-6}


def _flow_mclmc_fleet(model, dtype, n_chains, seed, tune):
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.mclmc import MclmcConfig
    from nutpie_tpu_torch.transforms.flow import FlowConfig

    cfg = MclmcConfig(flow=FlowConfig(**FLOW_GATE),
                      adapt=AdaptConfig(num_tune=tune, update_mass_matrix=False))
    sched = make_schedule(cfg.adapt, tune)
    return cfg, sched, _perturbed_flows(_mclmc_init(model, cfg, n_chains, dtype, seed))


def _check_windows_idle(tag, before, s_k, s_p) -> None:
    """The fixed metric's tuning chunk left K3's and the plain version's
    mass-matrix windows as they were."""
    import torch

    for name in ("adapt_vecs", "adapt_flts"):
        for who, s in (("kernel", s_k), ("plain", s_p)):
            assert torch.equal(getattr(s, name), getattr(before, name)), \
                f"{tag}: the {who}'s windows ran ({name})"


def phase_flow_parity(ctx):
    """K2 and K3 under the fixed metric against their plain versions, and
    chunk_flow_update on the card against the CPU (see the docstring)."""
    import torch

    from nutpie_tpu_torch.models import funnel, std_normal
    from nutpie_tpu_torch.sampler.mclmc import MclmcChunkRunner

    failed = []
    readings = {}
    for tag, use_orbit, n_chains, nuts in (
            ("k2_f64", False, FLOW_PARITY_CHAINS, {}),
            ("k2_orbit_f64", True, FLOW_PARITY_CHAINS, {}),
            ("k2_orbit_div_f64", True, FLOW_DIV_CHAINS, FLOW_DIV)):
        model, cfg, sched, states = _flow_nuts_fleet(torch.float64, use_orbit, 31, n_chains,
                                                     **nuts)
        readings[tag] = _flow_k2_pair(failed, tag, model, cfg, sched, states)

    # float32 at those shapes: the fresh warmup window under the warmup
    # phase's early bars, then a frozen chunk from the kernel's state
    # under the frozen chunks' share bars
    model, cfg, sched, states = _flow_nuts_fleet(torch.float32, False, 33)
    w, n = FLOW_WARM_DRAWS, FLOW_FROZEN_DRAWS
    (warm, wb_k), (_, wb_p) = _steps_both(model, cfg, sched, states, 0, w, w, False)
    f32_warm = {"start": 0, **_f32_shares(w, warm, wb_k, wb_p)}
    _held(failed, _assert_f32_warm, f32_warm)
    (g_k, gb_k), (_, gb_p) = _steps_both(model, cfg, sched, warm, w, n, n, True)
    f32 = _f32_shares(n, g_k, gb_k, gb_p)
    ctx["flow_f32_fleet"] = (model, cfg, sched, warm)

    # K3 at the MCLMC flow run's shapes: a tuning chunk from draw 0, where
    # the fixed metric acts, float64 and float32
    k3 = {}
    for dtype in (torch.float64, torch.float32):
        smodel = std_normal(4, mu=1.0, sigma=3.0)
        mcfg, msched, mstates = _flow_mclmc_fleet(smodel, dtype, FLOW_MCLMC_CHAINS, 43,
                                                  FLOW_PARITY_TUNE)
        (sk, bk), (sp, bp) = _mclmc_both(smodel, mcfg, msched, mstates, 0, FLOW_WARM_DRAWS,
                                         graph=True)
        _held(failed, _check_windows_idle, f"K3 std_normal {dtype}", mstates, sk, sp)
        if dtype == torch.float64:
            err = _held(failed, _check_mclmc, "K3 flow std_normal tuning", sk, bk, sp, bp,
                        1e-3, 1e-3)
            k3["std_normal_f64"] = {"tuning_held": err is not None,
                                    "max_abs_err_position": max_abs(bk.position, bp.position)}
        else:
            k3["std_normal_f32"] = _mclmc_f32_shares(bk, bp)
    # K3 on the funnel (the strided form in float64): a tuning chunk, the
    # kernel's own run to the end of tuning, then a frozen chunk
    mmodel = funnel(dim=FLOW_DIM, scale=1.0)
    mcfg, msched, mstates = _flow_mclmc_fleet(mmodel, torch.float64, FLOW_PARITY_CHAINS, 35,
                                              FLOW_K3_TUNE)
    w = FLOW_WARM_DRAWS
    (sk, bk), (sp, bp) = _mclmc_both(mmodel, mcfg, msched, mstates, 0, w, graph=True)
    _held(failed, _check_windows_idle, "K3 funnel", mstates, sk, sp)
    tuning = _held(failed, _check_mclmc, "K3 flow funnel tuning", sk, bk, sp, bp, 1e-3, 1e-3)
    tuned, _ = MclmcChunkRunner(mmodel, mcfg, FLOW_K3_TUNE - w, torch.float64)(
        sk, w, FLOW_K3_TUNE - w, msched)
    (sk, bk), (sp, bp) = _mclmc_both(mmodel, mcfg, msched, tuned, FLOW_K3_TUNE,
                                     FLOW_FROZEN_DRAWS, graph=True)
    frozen = _held(failed, _check_mclmc, "K3 flow funnel frozen", sk, bk, sp, bp, 1e-6, 1e-8)
    k3["funnel_f64"] = {"tuning_held": tuning is not None, "tuning_max_abs_err_position": tuning,
                        "frozen_held": frozen is not None,
                        "frozen_max_abs_err_position": max_abs(bk.position, bp.position)}
    readings.update(k3)
    readings["chunk_flow_update_f64"] = _flow_update_parity(failed)

    k3_32 = k3["std_normal_f32"]
    if k3_32["share_equal_diverging"] < F32_MIN_SHARE_STEPS:
        failed.append(f"K3 float32 diverging share {k3_32['share_equal_diverging']}")
    if k3_32["share_draws_within_tol"] < F32_MIN_SHARE_DRAWS:
        failed.append(f"K3 float32 draws share {k3_32['share_draws_within_tol']}")
    if f32["share_equal_n_steps"] < F32_MIN_SHARE_STEPS:
        failed.append(f"K2 float32 frozen n_steps share {f32['share_equal_n_steps']}")
    if f32["share_draws_within_tol"] < F32_MIN_SHARE_DRAWS:
        failed.append(f"K2 float32 frozen draws share {f32['share_draws_within_tol']}")
    k2_at = f"{FLOW_PARITY_CHAINS} chains, dim {FLOW_DIM + 1}"
    ctx["flow_k2_parity"] = {
        "max_abs_err": readings["k2_f64"]["frozen_max_abs_err_position"],
        "max_abs_err_at": f"{k2_at}, float64, a {FLOW_FROZEN_DRAWS}-draw frozen chunk",
        "warmup_max_abs_err": readings["k2_f64"]["warmup_max_abs_err_position"],
        "warmup_max_abs_err_at": f"{k2_at}, float64, a {FLOW_WARM_DRAWS}-draw tuning window",
        "f32_shares_at": f"{k2_at}, float32 (the float32 fleet's shapes)",
        "f32_tuning_shares": {k: f32_warm[k] for k in ("share_equal_n_steps",
                                                       "share_draws_within_tol")},
        "f32_frozen_shares": {k: f32[k] for k in ("share_equal_n_steps",
                                                  "share_draws_within_tol")}}
    k3_at = f"{FLOW_MCLMC_CHAINS} chains, dim 4"
    ctx["flow_k3_parity"] = {
        "max_abs_err": k3["std_normal_f64"]["max_abs_err_position"],
        "max_abs_err_at": f"{k3_at}, float64, a {FLOW_WARM_DRAWS}-draw tuning chunk",
        "f32_shares_at": f"{k3_at}, float32 (the MCLMC flow run's shapes), the same chunk",
        "f32_tuning_shares": {k: k3_32[k] for k in ("share_equal_diverging",
                                                    "share_draws_within_tol")},
        "strided_max_abs_err": k3["funnel_f64"]["frozen_max_abs_err_position"],
        "strided_max_abs_err_at": f"{k2_at}, float64, a {FLOW_FROZEN_DRAWS}-draw frozen chunk"}
    emit({"phase": "flow_parity", "model": f"funnel(dim={FLOW_DIM}, scale=1.0) under seeded "
          "flows whose couplings act; K3 also std_normal(4, 1, 3)", "flow": FLOW_GATE,
          "chains": FLOW_PARITY_CHAINS, **readings,
          "k2_f32": {"chains": FLOW_PARITY_CHAINS, "tol": F32_TOL, "tuning": f32_warm,
                     "frozen": {"draws": FLOW_FROZEN_DRAWS, **f32}},
          "failed": failed, "card": ctx["card"]})
    assert not failed, failed


class _TrainingClock:
    """Seconds of each flow training (``transforms.flow.train_flow``, a
    synchronize on each side) while the context is open."""

    def __enter__(self):
        import torch

        import nutpie_tpu_torch.transforms.flow as flow_module

        self.module, self.original, self.seconds = flow_module, flow_module.train_flow, []

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.original(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        flow_module.train_flow = timed
        return self

    def __exit__(self, *exc):
        self.module.train_flow = self.original


def _flow_readings(trace, wall: float, train_s: list) -> dict:
    """Divergences, the Fisher tail, ESS of v and the monitored x columns,
    ESS/s and gradients/s of a NUTS flow run."""
    import numpy as np

    from nutpie_tpu_torch.diagnostics import ess

    v = np.asarray(trace.posterior["v"].values)
    x = np.asarray(trace.posterior["x"].values)
    ess_v = float(ess(v))
    ess_x = min(float(ess(x[..., i])) for i in range(0, FLOW_DIM - 1, 10))
    fd = np.asarray(trace.sample_stats["fisher_distance"].values)
    grads = int(trace.sample_stats["n_steps"].values.astype(np.int64).sum()
                + trace.warmup_sample_stats["n_steps"].values.astype(np.int64).sum())
    return {"divergences": int(np.asarray(trace.sample_stats["diverging"].values).sum()),
            "ess_v": ess_v, "min_ess_x": ess_x,
            "fisher_distance_mean_tail": float(np.nanmean(fd[:, -200:])),
            "v_mean": float(v.mean()), "v_sd": float(v.std()),
            "all_finite": bool(np.isfinite(v).all() and np.isfinite(x).all()),
            "wall_s": wall, "min_ess_per_s": min(ess_v, ess_x) / wall,
            "gradients": grads, "grads_per_s": grads / wall,
            "flow_trainings": len(train_s), "train_s": float(sum(train_s)),
            "train_s_per_update": float(np.mean(train_s)) if train_s else 0.0,
            "train_share_of_wall": float(sum(train_s)) / wall}


def _jax_gate_margins() -> dict:
    """The JAX package's CPU margins of the gate (only read)."""
    path = os.path.join(ROOT, "tests", "reference", "flow_gate_margins.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _flow_nuts_run(dtype, chains: int, flow: dict):
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.models import funnel
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.run import CUDA_UNROLL
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    model = compile_model_def(funnel(dim=FLOW_DIM, scale=1.0)).with_transform_adapt(**flow)
    run = dict(FLOW_GATE_RUN, chains=chains)
    torch.cuda.synchronize()
    _zero_counts(step_kernel, chunk_kernel)
    with _TrainingClock() as clock:
        t0 = time.perf_counter()
        trace = nt.sample(model, adaptation="flow", progress_bar=False, device=DEVICE,
                          precision="float64" if dtype == torch.float64 else "float32", **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    import numpy as np

    n_steps = np.concatenate([trace.warmup_sample_stats["n_steps"].values,
                              trace.sample_stats["n_steps"].values], axis=1)
    freq = FLOW_GATE_RUN["transform_update_freq"]
    steps = machine_steps(n_steps, freq, CUDA_UNROLL)
    chunks = math.ceil((run["tune"] + run["draws"]) / freq)
    launches = step_kernel.launches
    launch_error = None
    try:
        assert chunk_kernel.launches == 0, "the chunk kernel launched on the flow path"
        _assert_step_launches(step_kernel, chunks, steps, CUDA_UNROLL)
    except AssertionError as err:
        launch_error = str(err)
    out = _flow_readings(trace, wall, clock.seconds)
    out.update({"chains": chains, "dtype": str(dtype).split(".")[-1], "machine_steps": steps,
                "chunks": chunks, "step_kernel_launches": launches,
                "graph_replays": step_kernel.replays, "capture_s": step_kernel.capture_s,
                "launch_error": launch_error})
    return out


def phase_flow(ctx):
    """``sample(adaptation="flow")`` on the card (see the docstring)."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.models import std_normal
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
    from nutpie_tpu_torch.sampler.state import flow_params

    gate = _flow_nuts_run(torch.float64, FLOW_GATE_RUN["chains"], FLOW_GATE)
    # the float32 fleet: the gate's flow config, under which the float32
    # recipe adds only its learning-rate decay (the config sets the rate and
    # the steps, and what a user sets wins); MCLMC's run below takes the
    # whole recipe
    fleet = _flow_nuts_run(torch.float32, FLOW_FLEET_CHAINS, FLOW_GATE)
    ctx["flow_k2_launches"] = fleet["step_kernel_launches"]

    # MCLMC with flow
    model = compile_model_def(std_normal(4, mu=1.0, sigma=3.0))
    _zero_all(mclmc_kernel)
    torch.cuda.synchronize()
    with _TrainingClock() as clock:
        t0 = time.perf_counter()
        mtrace = nt.sample(model, sampler="mclmc", adaptation="flow", progress_bar=False,
                           device=DEVICE, chains=FLOW_MCLMC_CHAINS, tune=FLOW_MCLMC_TUNE,
                           draws=FLOW_MCLMC_DRAWS, seed=17,
                           transform_update_freq=FLOW_MCLMC_FREQ)
        torch.cuda.synchronize()
        mwall = time.perf_counter() - t0
    xs = np.asarray(mtrace.posterior["x"].values)
    chunks = math.ceil((FLOW_MCLMC_TUNE + FLOW_MCLMC_DRAWS) / FLOW_MCLMC_FREQ)
    k3_expected = _k3_launches(chunks, FLOW_MCLMC_TUNE + FLOW_MCLMC_DRAWS, 1)
    mc = {"chains": FLOW_MCLMC_CHAINS, "tune": FLOW_MCLMC_TUNE, "draws": FLOW_MCLMC_DRAWS,
          "transform_update_freq": FLOW_MCLMC_FREQ, "x_mean": float(xs.mean()),
          "x_sd": float(xs.std()), "all_finite": bool(np.isfinite(xs).all()),
          "k3_launches": mclmc_kernel.launches, "k3_expected": k3_expected,
          "wall_s": mwall, "flow_trainings": len(clock.seconds),
          "train_s": float(sum(clock.seconds)), "capture_s": mclmc_kernel.capture_s}
    ctx["flow_k3_launches"] = mclmc_kernel.launches

    # K2's and K3's fixed-metric timing at the flow paths' float32 shapes
    f_model, f_cfg, f_sched, f_warm = ctx["flow_f32_fleet"]
    flogp = _FlowLogp(f_model, f_cfg.flow, flow_params(f_warm))
    ms, n_steps, bufs = _timed_steps(flogp, f_cfg, f_sched, f_warm, FLOW_TIMED_DRAWS,
                                     start=FLOW_WARM_DRAWS)
    dev = _device_step_ms(flogp, f_cfg, f_sched, f_warm, FLOW_TIMED_DRAWS, min(n_steps, 32))
    plain = _plain_step_ms(flogp, f_cfg, f_sched, f_warm, FLOW_TIMED_DRAWS, 8)
    C, _, dim = f_warm.vecs.shape
    work = step_bytes(bufs.scalars, FLOW_TIMED_DRAWS, C, n_steps, dim,
                      f_warm.ckpt_p.shape[1], 4)
    bound = 1e3 * work["bytes"] / PEAK_BYTES / n_steps
    ctx["flow_k2_timing"] = {"ms": ms["advance"], "device_ms": dev["advance"],
                             "plain_ms": plain["advance"], "bound_ms": bound,
                             "share_of_bound": bound / ms["advance"],
                             "device_share_of_bound": (bound / dev["advance"]
                                                       if dev["advance"] else None),
                             "logp_grad_ms": ms["logp_grad"], "machine_steps": n_steps}
    mmodel = std_normal(4, mu=1.0, sigma=3.0)
    mcfg, msched, mstates = _flow_mclmc_fleet(mmodel, torch.float32, FLOW_MCLMC_CHAINS, 41,
                                              FLOW_K3_TUNE)
    k3 = _k3_timed(_FlowLogp(mmodel, mcfg.flow, flow_params(mstates)), mcfg, msched, mstates,
                   FLOW_K3_TUNE, FLOW_TIMED_DRAWS, 8)
    mb = mclmc_bytes(FLOW_MCLMC_CHAINS, FLOW_TIMED_DRAWS, 1, 4, 4)
    k3_bound = 1e3 * mb["bytes"] / PEAK_BYTES / FLOW_TIMED_DRAWS
    ctx["flow_k3_timing"] = {"ms": k3["k3_ms_per_step"], "device_ms": k3["k3_device_ms_per_step"],
                             "plain_ms": k3["plain_ms_per_step"], "bound_ms": k3_bound,
                             "share_of_bound": k3_bound / k3["k3_ms_per_step"],
                             "device_share_of_bound": (
                                 k3_bound / k3["k3_device_ms_per_step"]
                                 if k3["k3_device_ms_per_step"] else None)}

    margins = _jax_gate_margins()
    emit({"phase": "flow",
          "gate_f64": {"config": FLOW_GATE, "run": FLOW_GATE_RUN, **gate,
                       "thresholds": {"ess": FLOW_GATE_ESS, "fisher": FLOW_GATE_FISHER},
                       "jax_cpu_margins": margins},
          "fleet_f32": {"flow": FLOW_GATE, "recipe": "lr_decay (sample._apply_f32_flow_recipe; "
                        "the config's learning_rate and train_steps win)", **fleet},
          "mclmc_recipe": "learning_rate 3e-4, train_steps 1600, lr_decay",
          "mclmc_f32": mc, "k2_fixed_metric": ctx["flow_k2_timing"],
          "k3_fixed_metric": ctx["flow_k3_timing"], "card": ctx["card"]})
    assert gate["launch_error"] is None, gate["launch_error"]
    assert fleet["launch_error"] is None, fleet["launch_error"]
    assert gate["divergences"] == 0, gate
    assert gate["ess_v"] > FLOW_GATE_ESS and gate["min_ess_x"] > FLOW_GATE_ESS, gate
    assert gate["fisher_distance_mean_tail"] < FLOW_GATE_FISHER, gate
    assert fleet["all_finite"], fleet
    assert abs(fleet["v_mean"]) < 0.1 and abs(fleet["v_sd"] - 1.0) < 0.1, fleet
    assert mc["all_finite"] and mc["k3_launches"] == k3_expected, mc
    assert abs(mc["x_mean"] - 1.0) < 0.3 and abs(mc["x_sd"] - 3.0) < 0.5, mc


# ---------------------------------------------------------------------------
# The Stan frontend on the card: a Stan program compiled by
# compile_stan_model, its per-chain interpreter batched over chains by
# torch.func.vmap and captured in the step runner's CUDA graphs around K2

# radon as a Stan program: the unconstrained layout of models/radon.py
# (intercept | county_raw_z | log county_sd | floor_effect | cf_raw_z |
# log cf_sd | log sigma), so its log density equals radon's up to a
# constant.  GQ adds a draw that puts the expansion's keys to work
STAN_RADON = """
data {
  int<lower=1> N; int<lower=2> J;
  array[N] int<lower=1, upper=J> county;
  vector[N] floor_x; vector[N] y;
  matrix[J, J - 1] basis;
}
parameters {
  real intercept;
  vector[J - 1] county_raw_z;
  real<lower=0> county_sd;
  real floor_effect;
  vector[J - 1] cf_raw_z;
  real<lower=0> cf_sd;
  real<lower=0> sigma;
}
transformed parameters {
  vector[J] county_effect = (basis * county_raw_z) * county_sd;
  vector[J] cf_effect = (basis * cf_raw_z) * cf_sd;
}
model {
  intercept ~ normal(0, 10);
  county_raw_z ~ std_normal();
  cf_raw_z ~ std_normal();
  county_sd ~ normal(0, 1);
  cf_sd ~ normal(0, 1);
  floor_effect ~ normal(0, 2);
  sigma ~ normal(0, 1.5);
  y ~ normal(intercept + county_effect[county] + floor_effect * floor_x
             + cf_effect[county] .* floor_x, sigma);
}
"""
STAN_RADON_GQ = "generated quantities { real y_new = normal_rng(intercept, sigma); }"
# a data `if` inside a loop of STAN_CENSORED_N observations: the loop
# cannot be batched over n (its condition reads cens[n]), so it unrolls,
# each branch decided on the host
STAN_CENSORED = """
data { int<lower=1> N; vector[N] y; array[N] int<lower=0, upper=1> cens; real c; }
parameters { real mu; real<lower=0> sigma; }
model {
  mu ~ normal(0, 5);
  sigma ~ normal(0, 2);
  for (n in 1:N) {
    if (cens[n] == 1) target += normal_lccdf(c | mu, sigma);
    else y[n] ~ normal(mu, sigma);
  }
}
"""
STAN_CENSORED_N = 64
STAN_PARITY_CHAINS = 64
# frozen chunk of the float64 K2 parity on each Stan model: a fresh fleet's
# trees run to the depth cap, and the plain version calls the log density
# eagerly (on an H100, 4 draws of both models took 35.4 s and 2 and 1
# draws 30.8 s), so the trees stop at depth STAN_PARITY_MAXDEPTH; the
# censored pair 2 -> 1 draw when the script neared its time limit
STAN_PARITY_DRAWS = {"radon": 2, "censored": 1}
STAN_PARITY_MAXDEPTH = 5
# the stan phase: the main path's configuration (2048 chains, 300 tune,
# pooled, NutsSettings.Diag(42)) with posterior draws STAN_DRAWS (300
# until the script neared its time limit)
STAN_DRAWS = 100
# logp+grad timing: calls a captured graph holds, and its replays
STAN_TIMING_CALLS, STAN_TIMING_REPLAYS = 8, 10
# K2 at the stan phase's shapes: a frozen chunk of the tuned fleet (its
# fleet depth cap bounds the trees, and is printed), held to the plain
# version and timed; device time over its first STAN_DEVICE_STEPS steps,
# the plain advance over STAN_PLAIN_STEPS
STAN_F32_DRAWS = 2
STAN_DEVICE_STEPS, STAN_PLAIN_STEPS = 32, 8
# rows of y_new recomputed on the CPU from the card's positions and keys
STAN_YNEW_ROWS = 64


def _stan_radon(gq: bool):
    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.models.radon import _zero_sum_basis, simulate_radon_data

    y, cidx, floor_x, _ = simulate_radon_data(42)
    code = STAN_RADON + (STAN_RADON_GQ if gq else "")
    return nt.compile_stan_model(code).with_data(
        N=len(y), J=85, county=cidx + 1, floor_x=floor_x, y=y, basis=_zero_sum_basis(85))


def _stan_censored():
    import numpy as np

    import nutpie_tpu_torch as nt

    rng = np.random.default_rng(3)
    y = 1.0 + 2.0 * rng.standard_normal(STAN_CENSORED_N)
    c = 2.5
    cens = (y > c).astype(np.int64)
    return nt.compile_stan_model(STAN_CENSORED).with_data(
        N=STAN_CENSORED_N, y=np.minimum(y, c), cens=cens, c=c)


def _stan_k2_frozen(failed, tag, model, seed, n: int, step_search: bool = True) -> dict:
    """K2 with a Stan log density against its plain version over one
    frozen chunk of ``n`` draws from a fresh float64 fleet, trees to depth
    ``STAN_PARITY_MAXDEPTH``: ints exact, floats to rtol 1e-6 / atol 1e-8
    (the runner captures the log density in its graphs).  Without
    ``step_search`` the fleet starts at the configuration's initial step
    size: the search calls the log density eagerly some hundred times, which
    for the censored model's unrolled loop took most of its pair's 13.5 s
    on an H100."""
    import numpy as np
    import torch

    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS, NutsConfig
    from nutpie_tpu_torch.sampler.run import init_chains
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    cfg = NutsConfig(adapt=AdaptConfig(num_tune=TUNE), maxdepth=STAN_PARITY_MAXDEPTH)
    sched = make_schedule(cfg.adapt, TUNE, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, seed, STAN_PARITY_CHAINS, np.zeros(model.ndim),
                             torch.float64, device=DEVICE, step_search=step_search)
    assert bool(ok.all()), f"{tag}: chain initialization failed"
    replays = step_kernel.replays
    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, states, 0, n, n, True)
    err = _held(failed, _check_frozen_f64, tag, s_k, b_k, s_p, b_p)
    if step_kernel.replays == replays:
        failed.append(f"{tag}: no graph replay (the log density was not captured)")
    leapfrogs = b_k.scalars[..., SCALAR_SLOTS["n_steps"]]
    return {"draws": n, "held": err is not None, "step_search": step_search,
            "ints_equal": bool(torch.equal(s_k.ints, s_p.ints)),
            "max_abs_err_position": max_abs(b_k.position, b_p.position),
            "leapfrogs_mean": float(leapfrogs.mean()), "leapfrogs_max": int(leapfrogs.max()),
            "graph_replays": step_kernel.replays - replays, "rtol": 1e-6, "atol": 1e-8}


def phase_stan_parity(ctx):
    """The Stan frontend against the port's own references on the card,
    float64, ``STAN_PARITY_CHAINS`` chains: the Stan radon's logp and
    gradient against ``nt.models.radon()`` (to rounding, up to the
    constant) and against the same program on the CPU; K2 with the Stan
    logp against its plain version over one frozen chunk; the censored
    model (a data ``if`` in a loop of 64 observations) on the card against
    the CPU, captured and stepped the same way."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt

    failed: list = []
    seconds = {}
    t0 = time.perf_counter()
    stan = _stan_radon(gq=False)._make_model(0)
    ref = nt.models.radon()
    assert stan.ndim == ref.ndim == 173, (stan.ndim, ref.ndim)
    x_host = np.random.default_rng(5).normal(size=(STAN_PARITY_CHAINS, stan.ndim)) * 0.3
    x = torch.as_tensor(x_host, device=DEVICE)
    ls, gs = stan.logp_and_grad(x)
    lr, gr = ref.logp_and_grad(x)
    lc, gc_ = stan.logp_and_grad(torch.as_tensor(x_host))
    offset = (ls - lr).cpu().numpy()
    radon = {"logp_offset": float(offset.mean()),
             "offset_spread": float(offset.max() - offset.min()),
             "grad_max_rel_err": max_rel(gs, gr),
             "card_vs_cpu_logp_max_rel": max_rel(ls.cpu(), lc),
             "card_vs_cpu_grad_max_rel": max_rel(gs.cpu(), gc_)}
    # rounding of the two formulas' sums: logp is about 1e3 in magnitude
    if not (radon["offset_spread"] < 1e-9 and radon["grad_max_rel_err"] < 1e-10
            and radon["card_vs_cpu_logp_max_rel"] < 1e-12
            and radon["card_vs_cpu_grad_max_rel"] < 1e-10):
        failed.append(f"stan radon parity: {radon}")
    seconds["radon_logp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    radon["k2_frozen"] = _stan_k2_frozen(failed, "stan radon K2 frozen chunk", stan, 31,
                                         STAN_PARITY_DRAWS["radon"])
    seconds["radon_k2_frozen"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cens = _stan_censored()._make_model(0)
    xc_host = np.random.default_rng(6).normal(size=(STAN_PARITY_CHAINS, cens.ndim))
    lk, gk = cens.logp_and_grad(torch.as_tensor(xc_host, device=DEVICE))
    lh, gh = cens.logp_and_grad(torch.as_tensor(xc_host))
    censored = {"observations": STAN_CENSORED_N,
                "card_vs_cpu_logp_max_rel": max_rel(lk.cpu(), lh),
                "card_vs_cpu_grad_max_rel": max_rel(gk.cpu(), gh)}
    if not (censored["card_vs_cpu_logp_max_rel"] < 1e-12
            and censored["card_vs_cpu_grad_max_rel"] < 1e-10):
        failed.append(f"stan censored parity: {censored}")
    seconds["censored_logp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    censored["k2_frozen"] = _stan_k2_frozen(failed, "stan censored K2 frozen chunk", cens, 32,
                                            STAN_PARITY_DRAWS["censored"], step_search=False)
    seconds["censored_k2_frozen"] = time.perf_counter() - t0
    ctx["stan_parity"] = {name: (r["k2_frozen"]["max_abs_err_position"],
                                 r["k2_frozen"]["draws"])
                          for name, r in (("radon", radon), ("censored", censored))}
    emit({"phase": "stan_parity", "chains": STAN_PARITY_CHAINS, "dtype": "float64",
          "radon": radon, "censored": censored, "seconds": seconds, "failed": failed})
    assert not failed, failed


def _logp_graph_ms(model, x) -> float:
    """ms of one logp+grad call at ``x``'s shapes, from CUDA events around
    replays of a graph that holds ``STAN_TIMING_CALLS`` calls (the way the
    step runner replays them)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.logp_and_grad(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(STAN_TIMING_CALLS):
            model.logp_and_grad(x)
    graph.replay()
    torch.cuda.synchronize()
    ms, _ = _event_ms(graph.replay, STAN_TIMING_REPLAYS)
    return ms / STAN_TIMING_CALLS


def _stan_fleet(ctx, model):
    """The warmup phase's float32 radon fleet (K1 through the 300 tuning
    draws at ``CHAINS`` chains, pooled, under the fleet depth cap) as a
    fleet of the Stan radon: the same unconstrained layout, the logp and
    gradient slots recomputed by the Stan program's density (radon's plus
    a constant).  Returns (cfg, sched, states)."""
    from nutpie_tpu_torch.sampler.state import FLT_SLOTS, VEC_SLOTS

    _, cfg, sched, states = ctx["warm32"]
    logp, grad = model.logp_and_grad(states.vecs[:, VEC_SLOTS["position"]])
    vecs, flts = states.vecs.clone(), states.flts.clone()
    vecs[:, VEC_SLOTS["gradient"]] = grad
    flts[:, FLT_SLOTS["logp"]] = logp
    return cfg, sched, states.replace(vecs=vecs, flts=flts)


def _stan_k2_main_shapes(failed, model, cfg, sched, warm) -> dict:
    """K2 around the Stan radon's log density at the stan phase's shapes
    (``CHAINS`` chains, dim 173, float32, the main path's configuration),
    from the tuned fleet (``_stan_fleet``): one frozen
    ``STAN_F32_DRAWS``-draw chunk through the runner's graphs against the
    plain version, held by the float32 shares at the bars of the GLM's
    main shapes (``F32_MIN_SHARE_STEPS``, ``F32_MIN_SHARE_DRAWS``); then
    K2's ``advance`` a machine step over the same chunk by CUDA events
    around eager launches (``_timed_steps``), by device time under
    ``torch.profiler`` (its first ``STAN_DEVICE_STEPS`` steps), the plain
    advance's (``STAN_PLAIN_STEPS``), and its byte and operation bounds
    from this chunk's trees.  Failed bars go to ``failed``."""
    import torch

    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    n, dim = STAN_F32_DRAWS, model.ndim
    replays = step_kernel.replays
    (s_k, b_k), (_, b_p) = _steps_both(model, cfg, sched, warm, TUNE, n, n, True)
    f32 = _held(failed, _f32_shares, n, s_k, b_k, b_p) or {}
    f32["graph_replays"] = step_kernel.replays - replays
    if f32["graph_replays"] == 0:
        failed.append("stan float32 chunk: no graph replay (the log density was not captured)")
    if f32.get("share_equal_n_steps", 0.0) < F32_MIN_SHARE_STEPS:
        failed.append(f"stan float32 n_steps share {f32.get('share_equal_n_steps')}")
    if f32.get("share_draws_within_tol", 0.0) < F32_MIN_SHARE_DRAWS:
        failed.append(f"stan float32 draws share {f32.get('share_draws_within_tol')}")
    del s_k, b_k, b_p

    ms, n_steps, bufs = _timed_steps(model, cfg, sched, warm, n, start=TUNE)
    dev = _device_step_ms(model, cfg, sched, warm, n, min(n_steps, STAN_DEVICE_STEPS),
                          start=TUNE)
    plain = _plain_step_ms(model, cfg, sched, warm, n, STAN_PLAIN_STEPS, start=TUNE)
    work = step_bytes(bufs.scalars, n, CHAINS, n_steps, dim, warm.ckpt_p.shape[1], 4)
    t_bytes = 1e3 * work["advance_bytes"] / PEAK_BYTES / n_steps
    t_ops = 1e3 * step_ops(work, dim) / PEAK_F32_OPS / n_steps
    bound = max(t_bytes, t_ops)
    torch.cuda.synchronize()
    return {"float32": {"draws": n, "tol": F32_TOL, "bars": [F32_MIN_SHARE_STEPS,
                                                             F32_MIN_SHARE_DRAWS], **f32},
            "depth_cap": int(sched.depth_cap), "machine_steps": n_steps,
            "ms": ms["advance"], "device_ms": dev["advance"], "plain_ms": plain["advance"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "share_of_bound": bound / ms["advance"],
            "device_share_of_bound": bound / dev["advance"] if dev["advance"] else None,
            "logp_grad_ms_eager": ms["logp_grad"], "logp_grad_device_ms": dev["logp_grad"]}


def phase_stan(ctx):
    """``sample()`` on the Stan radon at the main path's width: 2048 chains
    x (300 tune + ``STAN_DRAWS``), pooled, seed 42, float32, through the
    step route with K1's and K2's launch counts set to 0 just before: K1
    never, K2 more than once.  Draws finite, max split R-hat below 1.05,
    each monitored column's posterior mean within 5 combined MCSE of the
    main phase's K1 trace.  Prints wall, gradients/s, min bulk-ESS/s,
    divergences, the logp+grad ms of the Stan radon and of
    ``nt.models.radon()`` (graph replays, ``_logp_graph_ms``) and their
    ratio, and ``y_new`` on ``STAN_YNEW_ROWS`` rows recomputed on the CPU
    from the card's positions and keys (to 1e-5 relative).  Then K2 at
    these shapes against its plain version and timed
    (``_stan_k2_main_shapes``), and the wall's split."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.sample import chunk_length, expand_keys
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel
    from nutpie_tpu_torch.settings import NutsSettings

    compiled = _stan_radon(gq=True)
    model = compiled._make_model(0)
    torch.cuda.synchronize()
    _zero_counts(step_kernel, chunk_kernel)
    t0 = time.perf_counter()
    raw = nt.sample(compiled, progress_bar=False, chains=CHAINS, tune=TUNE, draws=STAN_DRAWS,
                    seed=42, pool_mass_matrix=True, pool_step_size=True, device="cuda",
                    return_raw_trace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = chunk_kernel.launches, step_kernel.launches
    graphs = {"graph_replays": step_kernel.replays, "capture_s": step_kernel.capture_s}
    assert k1 == 0, f"K1 launched {k1} times on a Stan model"
    assert k2 > 0, "K2 never launched"

    pos = raw["position"]
    assert pos.shape == (CHAINS, TUNE + STAN_DRAWS, model.ndim), pos.shape
    assert np.isfinite(pos).all(), "non-finite draws"
    grads = int(raw["stats"]["n_steps"].astype(np.int64).sum())
    post = pos[:, TUNE:, :]
    ess, rhat = column_diagnostics(post, MONITORED)
    min_ess = float(np.min(ess))
    assert max(rhat) < 1.05, f"split R-hat {max(rhat)} on a monitored column"
    div_post = int(raw["stats"]["diverging"][:, TUNE:].sum())

    k1_post, k1_ess = ctx["main_raw"]["position"][:, TUNE:, :], ctx["main_ess"]
    worst = 0.0
    for c, e_s, e_k in zip(MONITORED, ess, k1_ess):
        se = math.hypot(post[:, :, c].std() / math.sqrt(e_s), k1_post[:, :, c].std() / math.sqrt(e_k))
        worst = max(worst, abs(float(post[:, :, c].mean() - k1_post[:, :, c].mean())) / se)
    assert worst < 5.0, f"a posterior mean {worst:.2f} combined MCSE from K1's"

    x = torch.as_tensor(post[:, -1, :], device=DEVICE)
    stan_ms = _logp_graph_ms(model, x)
    radon_ms = _logp_graph_ms(nt.models.radon(), x)
    failed: list = []
    shapes = _stan_k2_main_shapes(failed, model, *_stan_fleet(ctx, model))
    settings = NutsSettings.Diag(42)
    settings.update(num_chains=CHAINS, num_tune=TUNE, num_draws=STAN_DRAWS)
    chunk_len = chunk_length(settings, CHAINS, model.ndim, 4)
    steps = k2 - math.ceil((TUNE + STAN_DRAWS) / chunk_len)
    split = {"machine_steps": steps, "logp_grad_s": steps * stan_ms / 1e3,
             "k2_s": steps * shapes["device_ms"] / 1e3, "capture_s": graphs["capture_s"],
             "timed": "logp+grad by CUDA events over graph replays, K2 by device time"}
    split["rest_s"] = wall - split["logp_grad_s"] - split["k2_s"] - split["capture_s"]

    # y_new on the CPU from the card's positions and the same keys
    rng = np.random.default_rng(7)
    rows = [(int(c), int(d)) for c, d in zip(rng.integers(0, CHAINS, STAN_YNEW_ROWS),
                                             rng.integers(0, TUNE + STAN_DRAWS, STAN_YNEW_ROWS))]
    kr = torch.stack([expand_keys(42, c + 1, 1, d, "cpu")[c, 0] for c, d in rows])
    xr = torch.as_tensor(np.stack([pos[c, d] for c, d in rows]))
    cpu = model.expand_fn(xr, kr)["y_new"].numpy()
    card = np.array([raw["expanded"]["y_new"][c, d] for c, d in rows])
    y_new_rel = float(np.max(np.abs(cpu - card) / np.maximum(np.abs(cpu), 1e-6)))
    assert y_new_rel < 1e-5, f"y_new on the card parts from the CPU's by {y_new_rel}"

    readings = {"wall_s": wall, "gradients": grads, "grads_per_s": grads / wall,
                "min_bulk_ess": min_ess, "min_ess_per_s": min_ess / wall,
                "max_rhat": float(max(rhat)), "posterior_divergences": div_post,
                "max_mean_gap_mcse_vs_k1": worst}
    ctx["stan_k2"] = {"launches": k2, **graphs, **shapes, "logp_grad_ms": stan_ms,
                      "radon_logp_grad_ms": radon_ms, "ratio": stan_ms / radon_ms}
    emit({"phase": "stan", "chains": CHAINS, "tune": TUNE, "draws": STAN_DRAWS,
          "dtype": "float32", "k1_launches": k1, "k2_launches": k2, **graphs, **readings,
          "logp_grad_ms_per_step": {"stan_radon": stan_ms, "radon_model": radon_ms,
                                    "ratio": stan_ms / radon_ms,
                                    "chains": CHAINS, "timed": "CUDA events over graph replays"},
          "k2_main_shapes": shapes, "chunk_len": chunk_len, "split_of_wall": split,
          "y_new_rows": STAN_YNEW_ROWS, "y_new_max_rel_err": y_new_rel,
          "card": ctx["card"], "failed": failed})
    assert not failed, failed


# ---------------------------------------------------------------------------
# Stan's looping functionals on the card: integrate_1d, the ODE solvers with
# their adjoint, the DAE and algebraic solvers (frontends/stan/functionals.py),
# and the Lotka-Volterra case study sampled through K2 around its eager logp

# the programs of tests/torch_stan_programs.py: one per functional, and the
# case study (Carpenter's "Predator-Prey Population Dynamics", posteriordb
# hudson_lynx_hare-lotka_volterra: 8 parameters, 2 states, 20 output times,
# rtol 1e-5, atol 1e-3, 500 steps) on data simulated from seed 0
FUNCTIONAL_POINTS = 4
# exponential decay y' = -k y, y(0) = 10, read at DECAY_TIMES against
# 10 exp(-k t), at rtol = atol = 1e-10
STAN_DECAY = """
functions { vector decay(real t, vector y, real k) { return -k * y; } }
data { int N; array[N] real ts; }
parameters { real k; }
model {
  array[N] vector[1] ys = ode_rk45_tol(decay, [10.0]', 0.0, ts, 1e-10, 1e-10, 100000, k);
  for (n in 1:N) target += ys[n, 1];
}
"""
DECAY_TIMES = (0.5, 1.0, 2.0, 4.0)
DECAY_RATES = (0.5, 1.0, 2.0)
DECAY_TOL = 1e-7
# K2 around the case study's eager logp against its plain version: float64,
# a fresh fleet within LV_INIT_HALF_WIDTH of the posterior means, one frozen
# chunk of LV_PARITY_DRAWS, trees to depth LV_PARITY_MAXDEPTH
LV_PARITY_CHAINS = 64
LV_PARITY_DRAWS, LV_PARITY_MAXDEPTH = 1, 3
LV_INIT_HALF_WIDTH = 0.25
# the stan_ode run: sample() of the case study as written, LV_CHAINS chains
# x (LV_TUNE + LV_DRAWS), trees to depth LV_MAXDEPTH, float32, seed 42, the
# step search started at LV_INITIAL_STEP, init_mean the posterior means,
# the start narrowed (_lv_near): sample()'s own start (+-2) took this run
# 285.5 s on an H100 80GB HBM3 at 700 W, 153.0 s of it in the init, with
# 223 output intervals at the cap (PERF.md section 6)
LV_CHAINS = 256
LV_TUNE, LV_DRAWS, LV_MAXDEPTH, LV_INITIAL_STEP = 8, 8, 3, 0.01
# K2 at the run's shapes, from a fresh fleet: a frozen LV_TIMED_DRAWS-draw
# chunk (trees to depth LV_PARITY_MAXDEPTH) against its plain version by the
# float32 shares, then timed (_lv_k2_timing), and LV_PLAIN_STEPS of the
# plain advance
LV_TIMED_DRAWS, LV_PLAIN_STEPS = 1, 2


def _stan_programs():
    """``tests/torch_stan_programs.py`` of this checkout (no JAX there)."""
    path = os.path.join(ROOT, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import torch_stan_programs

    return torch_stan_programs


def _lv_near(model):
    """``model`` with its chains started within ``LV_INIT_HALF_WIDTH`` of
    ``init_mean`` in the unconstrained space, where ``sample()``'s start
    (+-2) puts chains whose solves run to their cap and hold the fleet
    there (ROADMAP queue 3)."""
    from nutpie_tpu_torch.ops import threefry

    def init_point(key_data, init_mean):
        return init_mean + threefry.uniform(key_data, (model.ndim,), init_mean.dtype,
                                            -LV_INIT_HALF_WIDTH, LV_INIT_HALF_WIDTH)

    return dataclasses.replace(model, init_point_fn=init_point)


def _lv_compiled():
    """The case study as written, compiled and bound to its data (the
    ``CompiledStanModel`` a user passes to ``sample()``), its model's start
    narrowed by ``_lv_near`` (``sample()`` takes no width for it), and the
    case study's posterior means in the unconstrained space."""
    import numpy as np

    import nutpie_tpu_torch as nt

    p = _stan_programs()
    compiled = nt.compile_stan_model(p.LOTKA_VOLTERRA).with_data(**p.lotka_volterra_data())
    # the model compile_stan_model memoizes for sample(), its start narrowed
    object.__setattr__(compiled, "_model_def_cache", _lv_near(compiled._make_model(0)))
    return compiled, np.log(np.array(p.LV_THETA + p.LV_Z_INIT + (0.25, 0.25)))


def _lv_fleet(model, center, n_chains, dtype, seed, maxdepth):
    """A fresh fleet of the case study on the card, no step search."""
    import torch

    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import NutsConfig
    from nutpie_tpu_torch.sampler.run import init_chains

    cfg = NutsConfig(adapt=AdaptConfig(num_tune=TUNE), maxdepth=maxdepth)
    sched = make_schedule(cfg.adapt, TUNE, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, seed, n_chains, center, dtype, device=DEVICE,
                             step_search=False)
    assert bool(ok.all()), "case-study chains failed to initialize"
    return cfg, sched, states


def phase_stan_functionals_parity(ctx):
    """Stan's looping functionals on the card, float64: each program of
    ``FUNCTIONAL_CASES`` (22 functionals) at ``FUNCTIONAL_POINTS`` seeded
    points against the CPU (logp and gradient to 1e-12 relative to the
    largest); the ODE on exponential decay against ``10 exp(-k t)`` and its
    gradient in k (``DECAY_TOL``); the case study's logp and gradient at
    ``LV_PARITY_CHAINS`` points against the CPU, and K2 around its eager
    log density bitwise its plain version over one frozen chunk (every
    K2 launch eager, no graph replay)."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    failed: list = []
    seconds = {}
    t0 = time.perf_counter()
    functionals = {}
    for name, (code, data) in sorted(_stan_programs().FUNCTIONAL_CASES.items()):
        t1 = time.perf_counter()
        model = nt.compile_stan_model(code).with_data(**data())._make_model(0)
        x = np.random.default_rng(3).normal(size=(FUNCTIONAL_POINTS, model.ndim)) * 0.3
        lk, gk = model.logp_and_grad(torch.as_tensor(x, device=DEVICE))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lc, gc_ = model.logp_and_grad(torch.as_tensor(x))
        r = {"logp": max_rel(lk.cpu(), lc), "grad": max_rel(gk.cpu(), gc_),
             "finite": bool(torch.isfinite(lk).all() and torch.isfinite(gk).all()),
             "eager_logp": model.eager_logp, "card_s": t2 - t1,
             "cpu_s": time.perf_counter() - t2}
        functionals[name] = r
        if not (r["finite"] and r["logp"] < 1e-12 and r["grad"] < 1e-12):
            failed.append(f"{name} on the card against the CPU: {r}")
    seconds["functionals"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ts = np.array(DECAY_TIMES)
    decay = nt.compile_stan_model(STAN_DECAY).with_data(N=len(ts), ts=ts)._make_model(0)
    k = np.array(DECAY_RATES)
    ld, gd = decay.logp_and_grad(torch.as_tensor(k[:, None], device=DEVICE))
    exact = (10 * np.exp(-k[:, None] * ts)).sum(1)
    dexact = (-10 * ts * np.exp(-k[:, None] * ts)).sum(1)
    decay_r = {"rates": list(DECAY_RATES), "times": list(DECAY_TIMES),
               "logp_max_rel": float(np.max(np.abs(ld.cpu().numpy() - exact) / exact)),
               "grad_max_rel": float(np.max(np.abs(gd.cpu().numpy()[:, 0] - dexact)
                                            / np.abs(dexact))), "tol": DECAY_TOL}
    if not (decay_r["logp_max_rel"] < DECAY_TOL and decay_r["grad_max_rel"] < DECAY_TOL):
        failed.append(f"exponential decay: {decay_r}")
    seconds["decay"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    compiled, center = _lv_compiled()
    model = compiled._make_model(0)
    cfg, sched, states = _lv_fleet(model, center, LV_PARITY_CHAINS, torch.float64, 31,
                                   LV_PARITY_MAXDEPTH)
    x = states.vecs[:, 0]
    lk, gk = model.logp_and_grad(x)
    lc, gc_ = model.logp_and_grad(x.cpu())
    lv = {"chains": LV_PARITY_CHAINS, "card_vs_cpu_logp_max_rel": max_rel(lk.cpu(), lc),
          "card_vs_cpu_grad_max_rel": max_rel(gk.cpu(), gc_)}
    if not (lv["card_vs_cpu_logp_max_rel"] < 1e-12 and lv["card_vs_cpu_grad_max_rel"] < 1e-12):
        failed.append(f"case study on the card against the CPU: {lv}")
    launches, replays = step_kernel.launches, step_kernel.replays
    n = LV_PARITY_DRAWS
    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, states, 0, n, n, True)
    leapfrogs = b_k.scalars[..., SCALAR_SLOTS["n_steps"]]
    lv["k2_frozen"] = {
        "draws": n, "maxdepth": LV_PARITY_MAXDEPTH,
        "bitwise": bool(bitwise_equal(b_k.position, b_p.position)
                        and bitwise_equal(b_k.scalars, b_p.scalars)
                        and torch.equal(s_k.ints, s_p.ints)
                        and bitwise_equal(s_k.vecs, s_p.vecs)),
        "max_abs_err_position": max_abs(b_k.position, b_p.position),
        "k2_launches": step_kernel.launches - launches,
        "graph_replays": step_kernel.replays - replays,
        "leapfrogs_mean": float(leapfrogs.float().mean()), "leapfrogs_max": int(leapfrogs.max())}
    if not lv["k2_frozen"]["bitwise"]:
        failed.append(f"K2 around the case study's logp is not bitwise its plain version: "
                      f"{lv['k2_frozen']}")
    if lv["k2_frozen"]["k2_launches"] == 0 or lv["k2_frozen"]["graph_replays"] != 0:
        failed.append(f"the case study did not take the eager K2 route: {lv['k2_frozen']}")
    seconds["lotka_volterra"] = time.perf_counter() - t0
    ctx["lv_parity"] = lv["k2_frozen"]
    emit({"phase": "stan_functionals_parity", "dtype": "float64", "points": FUNCTIONAL_POINTS,
          "functionals": functionals, "decay": decay_r, "lotka_volterra": lv,
          "seconds": seconds, "failed": failed})
    assert not failed, failed


def _lv_k2_timing(model, cfg, sched, states, chunk: int):
    """K2 around the case study's eager log density over one frozen chunk
    of ``states``: a first run launches it step by step with each
    logp+grad between (each call by CUDA events) and keeps the log
    densities and gradients; the same advances then run again from the same
    start on those inputs, no log density between them, each by CUDA
    events after a synchronize, and once more under one ``torch.profiler``
    session for device time (None where it returns no K2 row); each rerun's
    draws are bitwise the first's.  Returns (ms per step by part, steps,
    the chunk's buffers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    st, bufs, steps = _prepared(cfg, sched, states, 0, chunk, True)
    z_new, carry = steps.begin(st)
    inputs, call_ms = [], 0.0
    while not bool(st.done.all()):
        ev[0].record()
        logp, grad = model.logp_and_grad(z_new)
        ev[1].record()
        inputs.append((logp, grad))
        st, z_new, carry = steps.advance(st, z_new, carry, logp, grad)
        torch.cuda.synchronize()
        call_ms += ev[0].elapsed_time(ev[1])

    def rerun(timed: bool) -> float:
        st, rbufs, steps = _prepared(cfg, sched, states, 0, chunk, True)
        z_new, carry = steps.begin(st)
        total = 0.0
        for logp, grad in inputs:
            if timed:
                torch.cuda.synchronize()
                ev[0].record()
            st, z_new, carry = steps.advance(st, z_new, carry, logp, grad)
            if timed:
                ev[1].record()
                torch.cuda.synchronize()
                total += ev[0].elapsed_time(ev[1])
        torch.cuda.synchronize()
        assert bitwise_equal(rbufs.position, bufs.position), "K2's rerun parts from its run"
        return total

    n = len(inputs)
    advance_ms = rerun(True) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rerun(False)
    rows = [r[0] for r in _device_rows(prof) if _is_k2(r[1])]
    return ({"logp_grad": call_ms / n, "advance": advance_ms,
             "device_advance": 1e3 * sum(rows) / n if rows else None}, n, bufs)


def _lv_k2_run_shapes(failed, model, center) -> dict:
    """K2 around the case study's eager log density at the stan_ode run's
    shapes (``LV_CHAINS`` chains, dim 8, float32, the held form), from a
    fresh fleet: one frozen ``LV_TIMED_DRAWS``-draw chunk through the
    runner's eager route against the plain version, held by the float32
    shares at the bars of the GLM's main shapes (``F32_MIN_SHARE_STEPS``,
    ``F32_MIN_SHARE_DRAWS``), and whether it is bitwise; then timed
    (``_lv_k2_timing``), the plain advance, and the byte and operation
    bounds from that chunk's trees.  Failed bars go to ``failed``."""
    import torch

    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    n = LV_TIMED_DRAWS
    cfg, sched, fleet = _lv_fleet(model, center, LV_CHAINS, torch.float32, 43,
                                  LV_PARITY_MAXDEPTH)
    replays = step_kernel.replays
    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, fleet, 0, n, n, True)
    f32 = _held(failed, _f32_shares, n, s_k, b_k, b_p) or {}
    f32["bitwise"] = bool(bitwise_equal(b_k.position, b_p.position)
                          and bitwise_equal(b_k.scalars, b_p.scalars)
                          and torch.equal(s_k.ints, s_p.ints))
    f32["max_abs_err_position"] = max_abs(b_k.position, b_p.position)
    f32["graph_replays"] = step_kernel.replays - replays
    if f32["graph_replays"]:
        failed.append("the case study's K2 chunk replayed a graph (not the eager route)")
    if f32.get("share_equal_n_steps", 0.0) < F32_MIN_SHARE_STEPS:
        failed.append(f"case study float32 n_steps share {f32.get('share_equal_n_steps')}")
    if f32.get("share_draws_within_tol", 0.0) < F32_MIN_SHARE_DRAWS:
        failed.append(f"case study float32 draws share {f32.get('share_draws_within_tol')}")
    del s_k, b_k, s_p, b_p

    ms, n_steps, bufs = _lv_k2_timing(model, cfg, sched, fleet, n)
    plain = _plain_step_ms(model, cfg, sched, fleet, n, LV_PLAIN_STEPS)
    work = step_bytes(bufs.scalars, n, LV_CHAINS, n_steps, model.ndim, fleet.ckpt_p.shape[1], 4)
    t_bytes = 1e3 * work["advance_bytes"] / PEAK_BYTES / n_steps
    t_ops = 1e3 * step_ops(work, model.ndim) / PEAK_F32_OPS / n_steps
    bound = max(t_bytes, t_ops)
    return {"float32": {"draws": n, "tol": F32_TOL,
                        "bars": [F32_MIN_SHARE_STEPS, F32_MIN_SHARE_DRAWS], **f32},
            "machine_steps": n_steps, "ms": ms["advance"], "device_ms": ms["device_advance"],
            "plain_ms": plain["advance"], "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "logp_grad_ms_eager": ms["logp_grad"],
            "plan": dataclasses.asdict(step_kernel.diag_plan(LV_CHAINS, model.ndim,
                                                             torch.float32, DEVICE))}


def _lv_attempts() -> dict:
    """Dormand-Prince attempts per output interval of the last solve, its
    forward and its adjoint: mean and max over the fleet and intervals."""
    from nutpie_tpu_torch.frontends.stan.functionals import ATTEMPTS

    out = {}
    for part in ("forward", "backward"):
        a = ATTEMPTS[part].double()
        out[part] = {"mean": float(a.mean()), "max": int(a.max()),
                     "fleet_max_per_interval_sum": int(a.max(0).values.sum())}
    return out


def phase_stan_ode(ctx):
    """``sample()`` on the case study as written (the old ODE interface,
    which the port differentiates): the ``CompiledStanModel`` of
    ``_lv_compiled`` at ``LV_CHAINS`` chains x (``LV_TUNE`` + ``LV_DRAWS``),
    trees to depth ``LV_MAXDEPTH``, seed 42, float32 (the card's default),
    the chains started within ``LV_INIT_HALF_WIDTH`` of the posterior
    means (``_lv_near``),
    K1's and K2's launch counts set to 0 just before: K1 never, K2 more than
    once, no graph replay (the eager route).  Draws finite, of the expected
    shape.  A short run: it samples, it does not converge.  Prints wall,
    the init's seconds (``init_s``) and log density calls, gradients/s,
    R-hat over theta, the solver's counts (``functionals.SOLVES``: attempt
    loops, intervals at the cap), the logp+grad ms a call by CUDA events at
    the last draws and the Dormand-Prince attempts per output interval
    there, forward and adjoint; then K2 at these shapes
    (``_lv_k2_run_shapes``) and the wall's split."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.stan.functionals import SOLVES
    from nutpie_tpu_torch.sample import chunk_length
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel
    from nutpie_tpu_torch.settings import NutsSettings

    compiled, center = _lv_compiled()
    model = compiled._make_model(0)
    failed: list = []
    torch.cuda.synchronize()
    _zero_counts(step_kernel, chunk_kernel)
    SOLVES.update(dict.fromkeys(SOLVES, 0))
    t0 = time.perf_counter()
    handle = nt.sample(compiled, progress_bar=False, chains=LV_CHAINS, tune=LV_TUNE,
                       draws=LV_DRAWS, seed=42, init_mean=center, maxdepth=LV_MAXDEPTH,
                       initial_step=LV_INITIAL_STEP, device="cuda", return_raw_trace=True,
                       blocking=False)
    raw = handle.wait()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, replays = chunk_kernel.launches, step_kernel.launches, step_kernel.replays
    solves = dict(SOLVES)
    assert k1 == 0, f"K1 launched {k1} times on a Stan model"
    assert k2 > 0, "K2 never launched"
    assert replays == 0, f"{replays} graph replays on the eager route"
    pos = raw["position"]
    assert pos.shape == (LV_CHAINS, LV_TUNE + LV_DRAWS, model.ndim), pos.shape
    assert np.isfinite(pos).all(), "non-finite draws"
    grads = int(raw["stats"]["n_steps"].astype(np.int64).sum())
    post = pos[:, LV_TUNE:, :]
    _, rhat = column_diagnostics(post, [0, 1, 2, 3])
    div = int(raw["stats"]["diverging"].sum())
    settings = NutsSettings.Diag(42)
    settings.update(num_chains=LV_CHAINS, num_tune=LV_TUNE, num_draws=LV_DRAWS,
                    maxdepth=LV_MAXDEPTH)
    chunk_len = chunk_length(settings, LV_CHAINS, model.ndim, 4)
    machine_steps = k2 - math.ceil((LV_TUNE + LV_DRAWS) / chunk_len)

    x = torch.as_tensor(post[:, -1, :], device=DEVICE, dtype=torch.float32)
    call_ms, _ = _event_ms(lambda: model.logp_and_grad(x), 2)
    attempts = _lv_attempts()

    t1 = time.perf_counter()
    ctx["lv_k2"] = {"launches": k2, **_lv_k2_run_shapes(failed, model, center)}
    k2_s = time.perf_counter() - t1

    dev = ctx["lv_k2"]["device_ms"]
    split = {"machine_steps": machine_steps, "init_s": handle.init_s,
             "logp_grad_s": machine_steps * call_ms / 1e3,
             "k2_s": machine_steps * dev / 1e3 if dev is not None else None,
             "chunk_len": chunk_len,
             "timed": "the init by the host's clock (sample()'s init_s), logp+grad by CUDA "
                      "events around eager calls at the last draws, K2 by device time at "
                      "these shapes"}
    split["rest_s"] = wall - split["init_s"] - split["logp_grad_s"] - (split["k2_s"] or 0.0)
    split["shares"] = {k: None if split[k] is None else split[k] / wall
                       for k in ("init_s", "logp_grad_s", "k2_s", "rest_s")}
    emit({"phase": "stan_ode", "chains": LV_CHAINS, "tune": LV_TUNE, "draws": LV_DRAWS,
          "maxdepth": LV_MAXDEPTH, "dtype": "float32", "init_half_width": LV_INIT_HALF_WIDTH,
          "k1_launches": k1, "k2_launches": k2, "graph_replays": replays, "wall_s": wall,
          "init_s": handle.init_s, "init_logp_calls": solves["backward"] - machine_steps,
          "solves": solves, "gradients": grads, "grads_per_s": grads / wall,
          "rhat_theta": [float(r) for r in rhat], "max_rhat_theta": float(max(rhat)),
          "divergences": div, "logp_grad_ms_per_call": call_ms,
          "logp_grad_at": "the run's last draws, events",
          "dopri_attempts_per_interval": attempts,
          "k2": {**ctx["lv_k2"], "timed_at": f"{LV_CHAINS} chains, dim 8, float32, a "
                                             f"{LV_TIMED_DRAWS}-draw frozen chunk of a fresh "
                                             f"fleet, trees to depth {LV_PARITY_MAXDEPTH}",
                 "seconds": k2_s},
          "split_of_wall": split, "card": ctx["card"], "failed": failed})
    assert not failed, failed


# ---------------------------------------------------------------------------
# The case study under MCLMC and under flow adaptation: the runners call its
# eager log density between their kernels' launches (K3's kick and settle,
# K2 under its fixed metric), no graph replay

# the stan_ode_mclmc run: sample(sampler="mclmc") of the case study as
# written, LV_MCLMC_CHAINS chains x (LV_MCLMC_TUNE + LV_MCLMC_DRAWS), float32,
# seed 42, the start narrowed (_lv_near); each draw is one step, two eager
# log densities (a logp+grad call took 120-164 ms at 256 chains on an H100
# 80GB HBM3 at 700 W, host-bound: PERF.md section 6)
LV_MCLMC_CHAINS = 64
LV_MCLMC_TUNE, LV_MCLMC_DRAWS = 4, 4
# K3 at the run's shapes, from a fresh fleet (no step search) with its draw
# counters at the end of tuning: one frozen LV_K3_DRAWS-draw chunk against the
# plain version, then timed over as many draws
LV_K3_DRAWS = 1
# K3's kick and settle replayed from a graph over a chunk of as many draws
LV_K3_GRAPH_DRAWS = 32
# the stan_ode_flow run: sample(adaptation="flow") under NUTS, LV_FLOW_CHAINS x
# (LV_FLOW_TUNE + LV_FLOW_DRAWS), trees to depth LV_FLOW_MAXDEPTH, float32,
# the flows LV_FLOW (a window of LV_FLOW_FREQ rows that the first chunk
# fills, so the flows train by Adam at its end, no diagonal phase) updated
# every LV_FLOW_FREQ draws
LV_FLOW_CHAINS = 64
LV_FLOW_TUNE, LV_FLOW_DRAWS, LV_FLOW_MAXDEPTH, LV_FLOW_FREQ = 4, 2, 2, 4
LV_FLOW = dict(num_layers=2, hidden=8, window=4, train_steps=200, num_diag_updates=0)
# the seeded flows of the K2 chunk at the run's shapes: FLOW_PERTURB's moved
# the case study's chains into stiff regions, where a logp+grad call took
# 2.75 s on an H100 80GB HBM3 at 700 W (the solves at their cap), so these
# act less
LV_FLOW_PERTURB = {"flow_mu": 0.02, "flow_log_sigma": 0.02, "flow_w2": 0.02, "flow_b2": 0.01}
# the pymc phase: radon written as a PyMC model (tests/torch_fake_pymc.py)
# at the main path's configuration, posterior draws PYMC_DRAWS (as the stan
# phase's); float64 parity at PYMC_PARITY_CHAINS points; its posterior means
# held within PYMC_MCSE combined MCSE of the main phase's K1 trace
PYMC_DRAWS, PYMC_PARITY_CHAINS, PYMC_MCSE = 100, 64, 4.0
PYMC_PARITY_DRAWS = 2


def _lv_k3_timing(model, cfg, sched, states, start: int, draws: int) -> dict:
    """K3's kick and settle around the case study's eager log density over
    ``draws`` frozen draws (one step a draw) of ``states``: a first run
    calls the log density between the launches (each call and launch by
    CUDA events) and keeps its outputs; the launches then run again from
    the same start on those outputs, no log density between them, under one
    ``torch.profiler`` session for device time (the solver's host loop is
    not profiled), their draws bitwise the first's; the plain pieces on the
    same outputs by CUDA events after a synchronize; and the launches back
    to back, replayed from a graph, by CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
    from nutpie_tpu_torch.sampler.step_kernel import StepGraph

    st, bufs, steps = _k3_chunk(cfg, sched, states, start, draws)
    z = steps.begin(st)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(draws)]
    inputs = []
    torch.cuda.synchronize()
    for ev in marks:
        ev[0].record()
        _, g_mid = model.logp_and_grad(z)
        ev[1].record()
        z = steps.kick(st, z, g_mid)
        ev[2].record()
        logp, g = model.logp_and_grad(z)
        ev[3].record()
        z = steps.settle(st, z, logp, g)
        ev[4].record()
        inputs.append((g_mid, logp, g))
    torch.cuda.synchronize()
    parts = ("logp_grad_mid", "kick", "logp_grad_end", "settle")
    ms = {p: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / draws
          for i, p in enumerate(parts)}
    dst, dbufs, dsteps = _k3_chunk(cfg, sched, states, start, draws)
    z = dsteps.begin(dst)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for g_mid, logp, g in inputs:
            z = dsteps.kick(dst, z, g_mid)
            z = dsteps.settle(dst, z, logp, g)
        torch.cuda.synchronize()
    assert bitwise_equal(dbufs.position, bufs.position), "K3's rerun parts from its run"
    k3_s = sum(r[0] for r in _device_rows(prof) if "mclmc_piece" in r[1])
    # the launches back to back: one draw's kick and settle on the first
    # draw's outputs captured in a graph (as the runner captures a draw)
    # and replayed over a chunk of LV_K3_GRAPH_DRAWS draws, by CUDA events
    # around all but the first replay
    gst, _, gsteps = _k3_chunk(cfg, sched, states, start, LV_K3_GRAPH_DRAWS)
    gz = gsteps.begin(gst)
    g_mid, logp, g = inputs[0]
    graph = StepGraph(mclmc_kernel, DEVICE)
    graph.capture(lambda: gsteps.settle(gst, gsteps.kick(gst, gz, g_mid), logp, g))
    graph.replay()
    torch.cuda.synchronize()
    graph_ms, _ = _event_ms(graph.replay, LV_K3_GRAPH_DRAWS - 1)
    pst, _, plain = _k3_chunk(cfg, sched, states, start, draws, plain=True)
    z = plain.begin(pst)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    plain_ms = 0.0
    for g_mid, logp, g in inputs:
        torch.cuda.synchronize()
        ev[0].record()
        z = plain.kick(pst, z, g_mid)
        z = plain.settle(pst, z, logp, g)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms += ev[0].elapsed_time(ev[1]) / draws
    return {"k3_ms_per_step": ms["kick"] + ms["settle"], "kick_ms": ms["kick"],
            "settle_ms": ms["settle"], "k3_device_ms_per_step": 1e3 * k3_s / draws or None,
            "k3_graph_ms_per_step": graph_ms,
            "plain_ms_per_step": plain_ms,
            "logp_grad_ms": 0.5 * (ms["logp_grad_mid"] + ms["logp_grad_end"])}


def _k3_lv_run_shapes(failed, model, center) -> dict:
    """K3 around the case study's eager log density at the stan_ode_mclmc
    run's shapes (``LV_MCLMC_CHAINS`` chains, dim 8, float32), from a fresh
    fleet (no step search) with its draw counters at the end of tuning: one
    frozen ``LV_K3_DRAWS``-draw chunk through the runner's eager route
    against the plain version (``_mclmc_f32_shares`` at the GLM's bars:
    ``F32_MIN_SHARE_STEPS`` of ``diverging`` equal, ``F32_MIN_SHARE_DRAWS``
    of the draws within ``F32_TOL``), whether it is bitwise, and that no
    graph replayed; then K3's kick and settle a step by events and by
    device time, the plain pieces' and the byte bound (``_k3_timed``,
    ``mclmc_bytes``).  Failed bars go to ``failed``."""
    import torch

    from nutpie_tpu_torch.sampler.mclmc import MclmcChunkRunner, init_mclmc_chains
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel

    cfg, sched = _mclmc_cfg(LV_MCLMC_TUNE)
    states, ok = init_mclmc_chains(model, cfg, 43, LV_MCLMC_CHAINS, center, torch.float32,
                                   device=DEVICE, step_search=False)
    assert bool(ok.all()), "case-study chains failed to initialize"
    states = states.replace(ints=states.ints.clone().index_fill_(
        1, torch.tensor([0], device=DEVICE), LV_MCLMC_TUNE))
    n = LV_K3_DRAWS
    replays, launches = mclmc_kernel.replays, mclmc_kernel.launches
    s_k, b_k = MclmcChunkRunner(model, cfg, n, torch.float32)(states, LV_MCLMC_TUNE, n, sched)
    torch.cuda.synchronize()
    eager = {"k3_launches": mclmc_kernel.launches - launches,
             "graph_replays": mclmc_kernel.replays - replays}
    s_p, b_p = MclmcChunkRunner(model, cfg, n, torch.float32, plain=True)(
        states, LV_MCLMC_TUNE, n, sched)
    torch.cuda.synchronize()
    f32 = _mclmc_f32_shares(b_k, b_p)
    f32["bitwise"] = bool(bitwise_equal(b_k.position, b_p.position)
                          and torch.equal(s_k.ints, s_p.ints)
                          and bitwise_equal(s_k.vecs, s_p.vecs))
    if eager["graph_replays"] or eager["k3_launches"] != 1 + 2 * n:
        failed.append(f"K3 around the case study did not take the eager route: {eager}")
    if f32["share_equal_diverging"] < F32_MIN_SHARE_STEPS:
        failed.append(f"case study K3 float32 diverging share {f32['share_equal_diverging']}")
    if f32["share_draws_within_tol"] < F32_MIN_SHARE_DRAWS:
        failed.append(f"case study K3 float32 draws share {f32['share_draws_within_tol']}")
    k3 = _lv_k3_timing(model, cfg, sched, states, LV_MCLMC_TUNE, n)
    work = mclmc_bytes(LV_MCLMC_CHAINS, n, 1, model.ndim, 4)
    bound = 1e3 * work["bytes"] / PEAK_BYTES / work["steps"]
    return {"float32": {"draws": n, "tol": F32_TOL,
                        "bars": [F32_MIN_SHARE_STEPS, F32_MIN_SHARE_DRAWS], **eager, **f32},
            "max_abs_err": max_abs(b_k.position, b_p.position),
            "ms": k3["k3_ms_per_step"], "device_ms": k3["k3_device_ms_per_step"],
            "graph_ms": k3["k3_graph_ms_per_step"],
            "plain_ms": k3["plain_ms_per_step"], "bound_ms": bound, "bound_by": "bytes",
            "share_of_bound": bound / k3["k3_ms_per_step"],
            "logp_grad_ms_eager": k3["logp_grad_ms"],
            "plan": dataclasses.asdict(mclmc_kernel.plan(LV_MCLMC_CHAINS, model.ndim, 0,
                                                         torch.float32, DEVICE))}


def phase_stan_ode_mclmc(ctx):
    """``sample(sampler="mclmc")`` on the case study as written (its
    ``CompiledStanModel`` from ``_lv_compiled``, the start narrowed) at
    ``LV_MCLMC_CHAINS`` chains x (``LV_MCLMC_TUNE`` + ``LV_MCLMC_DRAWS``),
    seed 42, float32, with K1's, K2's and K3's counts set to 0 just before:
    K3 launched once a chunk and twice a draw, no graph replay (the eager
    route), K1 and K2 never.  Draws finite, of the expected shape.  A short
    run: it samples, it does not converge.  Prints wall, the init's seconds,
    the solver's counts, the logp+grad ms a call by events at the last
    draws, K3 at these shapes against its plain version and timed
    (``_k3_lv_run_shapes``, run first) and the wall's split."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.stan.functionals import SOLVES
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    t_phase = time.perf_counter()
    compiled, center = _lv_compiled()
    model = compiled._make_model(0)
    failed: list = []
    t1 = time.perf_counter()
    shapes = _k3_lv_run_shapes(failed, model, center)
    k3_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    _zero_all(step_kernel, chunk_kernel, mclmc_kernel)
    SOLVES.update(dict.fromkeys(SOLVES, 0))
    t0 = time.perf_counter()
    handle = nt.sample(compiled, sampler="mclmc", progress_bar=False, chains=LV_MCLMC_CHAINS,
                       tune=LV_MCLMC_TUNE, draws=LV_MCLMC_DRAWS, seed=42, init_mean=center,
                       initial_step=LV_INITIAL_STEP,
                       chunk_size=LV_MCLMC_TUNE + LV_MCLMC_DRAWS, device="cuda",
                       return_raw_trace=True, blocking=False)
    raw = handle.wait()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k3, replays = (chunk_kernel.launches, step_kernel.launches, mclmc_kernel.launches,
                           mclmc_kernel.replays)
    solves = dict(SOLVES)
    total = LV_MCLMC_TUNE + LV_MCLMC_DRAWS
    expected = _k3_launches(1, total, 1)  # one chunk
    assert k1 == 0 and k2 == 0, f"K1 launched {k1}, K2 {k2} times on the MCLMC route"
    assert k3 == expected, f"K3 launched {k3} times, expected {expected}"
    assert replays == 0, f"{replays} graph replays on the eager route"
    pos = raw["position"]
    assert pos.shape == (LV_MCLMC_CHAINS, total, model.ndim), pos.shape
    assert np.isfinite(pos).all(), "non-finite draws"
    x = torch.as_tensor(pos[:, -1, :], device=DEVICE, dtype=torch.float32)
    call_ms, _ = _event_ms(lambda: model.logp_and_grad(x), 2)

    ctx["lv_k3"] = {"launches": k3, **shapes}
    dev = ctx["lv_k3"]["device_ms"]  # a step's kick and settle; a draw is one step
    split = {"draws": total, "init_s": handle.init_s,
             "logp_grad_s": 2 * total * call_ms / 1e3,
             "k3_s": total * dev / 1e3 if dev is not None else None,
             "timed": "the init by the host's clock (sample()'s init_s), logp+grad by CUDA "
                      "events around eager calls at the last draws (two a draw), K3 by "
                      "device time at these shapes"}
    split["rest_s"] = wall - split["init_s"] - split["logp_grad_s"] - (split["k3_s"] or 0.0)
    emit({"phase": "stan_ode_mclmc", "chains": LV_MCLMC_CHAINS, "tune": LV_MCLMC_TUNE,
          "draws": LV_MCLMC_DRAWS, "dtype": "float32", "k1_launches": k1, "k2_launches": k2,
          "k3_launches": k3, "k3_expected": expected, "graph_replays": replays,
          "wall_s": wall, "init_s": handle.init_s, "solves": solves,
          "logp_grad_ms_per_call": call_ms, "logp_grad_at": "the run's last draws, events",
          "k3": {**ctx["lv_k3"], "timed_at": f"{LV_MCLMC_CHAINS} chains, dim 8, float32, a "
                                             f"{LV_K3_DRAWS}-draw frozen chunk of a fresh "
                                             "fleet", "seconds": k3_s},
          "split_of_wall": split, "seconds": time.perf_counter() - t_phase,
          "card": ctx["card"], "failed": failed})
    assert not failed, failed


def _lv_flow_fleet(model, center, cfg_flow, n_chains, dtype, seed):
    """A fresh fleet of the case study under the fixed metric (no step
    search), each chain's flow moved to seeded parameters that act."""
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import NutsConfig
    from nutpie_tpu_torch.sampler.run import init_chains

    cfg = NutsConfig(maxdepth=LV_FLOW_MAXDEPTH, flow=cfg_flow,
                     adapt=AdaptConfig(num_tune=TUNE, update_mass_matrix=False,
                                       initial_step=LV_INITIAL_STEP))
    sched = make_schedule(cfg.adapt, TUNE, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, seed, n_chains, center, dtype, device=DEVICE,
                             step_search=False)
    assert bool(ok.all()), "case-study chains failed to initialize"
    return cfg, sched, _perturbed_flows(states, scales=LV_FLOW_PERTURB)


def _k2_lv_flow_run_shapes(failed, model, center) -> dict:
    """K2 under the fixed metric around the case study's pulled-back eager
    log density at the stan_ode_flow run's shapes (``LV_FLOW_CHAINS``
    chains, dim 8, float32), from a fresh fleet under seeded flows: one
    frozen 1-draw chunk through the runner's eager route against the plain
    version (the float32 shares at ``F32_MIN_SHARE_STEPS`` /
    ``F32_MIN_SHARE_DRAWS``, whether it is bitwise, no graph replay), then
    K2's advance a machine step by events and device time, the plain
    advance's and the byte and operation bounds (``_lv_k2_timing``,
    ``step_bytes``)."""
    import torch

    from nutpie_tpu_torch.sampler.state import flow_params
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel
    from nutpie_tpu_torch.transforms.flow import FlowConfig

    cfg, sched, fleet = _lv_flow_fleet(model, center, FlowConfig(**LV_FLOW), LV_FLOW_CHAINS,
                                       torch.float32, 47)
    replays, launches = step_kernel.replays, step_kernel.launches
    (s_k, b_k), (s_p, b_p) = _steps_both(model, cfg, sched, fleet, 0, 1, 1, True)
    f32 = _held(failed, _f32_shares, 1, s_k, b_k, b_p) or {}
    f32["bitwise"] = bool(bitwise_equal(b_k.position, b_p.position)
                          and bitwise_equal(b_k.scalars, b_p.scalars)
                          and torch.equal(s_k.ints, s_p.ints))
    f32["graph_replays"] = step_kernel.replays - replays
    f32["k2_launches"] = step_kernel.launches - launches
    if f32["graph_replays"] or not f32["k2_launches"]:
        failed.append(f"K2 under flow around the case study did not take the eager route: "
                      f"{f32}")
    if f32.get("share_equal_n_steps", 0.0) < F32_MIN_SHARE_STEPS:
        failed.append(f"case study flow float32 n_steps share {f32.get('share_equal_n_steps')}")
    if f32.get("share_draws_within_tol", 0.0) < F32_MIN_SHARE_DRAWS:
        failed.append(f"case study flow float32 draws share "
                      f"{f32.get('share_draws_within_tol')}")
    err = max_abs(b_k.position, b_p.position)
    del s_k, b_k, s_p, b_p
    flogp = _FlowLogp(model, cfg.flow, flow_params(fleet))
    ms, n_steps, bufs = _lv_k2_timing(flogp, cfg, sched, fleet, 1)
    plain = _plain_step_ms(flogp, cfg, sched, fleet, 1, LV_PLAIN_STEPS)
    work = step_bytes(bufs.scalars, 1, LV_FLOW_CHAINS, n_steps, model.ndim,
                      fleet.ckpt_p.shape[1], 4)
    t_bytes = 1e3 * work["advance_bytes"] / PEAK_BYTES / n_steps
    t_ops = 1e3 * step_ops(work, model.ndim) / PEAK_F32_OPS / n_steps
    bound = max(t_bytes, t_ops)
    return {"float32": {"draws": 1, "tol": F32_TOL,
                        "bars": [F32_MIN_SHARE_STEPS, F32_MIN_SHARE_DRAWS], **f32},
            "max_abs_err": err, "machine_steps": n_steps, "ms": ms["advance"],
            "device_ms": ms["device_advance"], "plain_ms": plain["advance"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "logp_grad_ms_eager": ms["logp_grad"]}


def phase_stan_ode_flow(ctx):
    """``sample(adaptation="flow")`` under NUTS on the case study as written
    (``_lv_compiled``'s model with the flows ``LV_FLOW``, the start
    narrowed) at ``LV_FLOW_CHAINS`` chains x (``LV_FLOW_TUNE`` +
    ``LV_FLOW_DRAWS``), trees to depth ``LV_FLOW_MAXDEPTH``, flows updated
    every ``LV_FLOW_FREQ`` draws, seed 42, float32, with the kernels' counts
    set to 0 just before: K2 launched, no graph replay (the eager route),
    K1 and K3 never, at least one flow trained by Adam (its seconds by
    ``_TrainingClock``).  Draws finite, of the expected shape.  Then K2
    under the fixed metric at these shapes against its plain version and
    timed (``_k2_lv_flow_run_shapes``)."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    t_phase = time.perf_counter()
    compiled, center = _lv_compiled()
    compiled = compiled.with_transform_adapt(**LV_FLOW)
    # the copy's model, its start narrowed, memoized for sample()
    object.__setattr__(compiled, "_model_def_cache", _lv_near(compiled._make_model(0)))
    model = compiled._make_model(0)
    failed: list = []
    torch.cuda.synchronize()
    _zero_all(step_kernel, chunk_kernel, mclmc_kernel)
    with _TrainingClock() as clock:
        t0 = time.perf_counter()
        handle = nt.sample(compiled, adaptation="flow", progress_bar=False,
                           chains=LV_FLOW_CHAINS, tune=LV_FLOW_TUNE, draws=LV_FLOW_DRAWS,
                           maxdepth=LV_FLOW_MAXDEPTH, transform_update_freq=LV_FLOW_FREQ,
                           seed=42, init_mean=center, initial_step=LV_INITIAL_STEP,
                           device="cuda", return_raw_trace=True, blocking=False)
        raw = handle.wait()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k1, k2, k3, replays = (chunk_kernel.launches, step_kernel.launches, mclmc_kernel.launches,
                           step_kernel.replays)
    assert k1 == 0 and k3 == 0, f"K1 launched {k1}, K3 {k3} times on the flow NUTS route"
    assert k2 > 0, "K2 never launched"
    assert replays == 0, f"{replays} graph replays on the eager route"
    assert len(clock.seconds) >= 1, "no flow trained"
    total = LV_FLOW_TUNE + LV_FLOW_DRAWS
    pos = raw["position"]
    assert pos.shape == (LV_FLOW_CHAINS, total, model.ndim), pos.shape
    assert np.isfinite(pos).all(), "non-finite draws"
    grads = int(raw["stats"]["n_steps"].astype(np.int64).sum())

    t1 = time.perf_counter()
    ctx["lv_k2_flow"] = {"launches": k2, **_k2_lv_flow_run_shapes(failed, model, center)}
    k2_s = time.perf_counter() - t1
    emit({"phase": "stan_ode_flow", "chains": LV_FLOW_CHAINS, "tune": LV_FLOW_TUNE,
          "draws": LV_FLOW_DRAWS, "maxdepth": LV_FLOW_MAXDEPTH, "flow": LV_FLOW,
          "transform_update_freq": LV_FLOW_FREQ, "dtype": "float32", "k1_launches": k1,
          "k2_launches": k2, "k3_launches": k3, "graph_replays": replays, "wall_s": wall,
          "init_s": handle.init_s, "gradients": grads, "flow_trainings": len(clock.seconds),
          "train_s": float(sum(clock.seconds)),
          "divergences": int(raw["stats"]["diverging"].sum()),
          "k2_fixed_metric": {**ctx["lv_k2_flow"],
                              "timed_at": f"{LV_FLOW_CHAINS} chains, dim 8, float32, a 1-draw "
                                          "frozen chunk of a fresh fleet under seeded flows, "
                                          f"trees to depth {LV_FLOW_MAXDEPTH}",
                              "seconds": k2_s},
          "seconds": time.perf_counter() - t_phase, "card": ctx["card"], "failed": failed})
    assert not failed, failed


def _torch_fake_pymc():
    """``tests/torch_fake_pymc.py`` of this checkout (no JAX there),
    installed in place of pymc and pytensor."""
    path = os.path.join(ROOT, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import torch_fake_pymc

    assert torch_fake_pymc.install(), "a real pymc is installed: run the phase against it"
    return torch_fake_pymc


def phase_pymc(ctx):
    """Radon written as a PyMC model (``tests/torch_fake_pymc.py:radon_model``:
    PyMC's value variables, the zero-sum effects and the ``*_log__``
    scales), compiled by ``compile_pymc_model`` through the PyTorch
    linker's stand-in.  Float64, ``PYMC_PARITY_CHAINS`` points: its logp
    equals ``nt.models.radon()``'s up to one constant (spread under 1e-10
    of the largest |logp|) and its gradient to 1e-10, the card's equal to
    the CPU's (1e-12); K2 around it against its plain version over one
    frozen ``PYMC_PARITY_DRAWS``-draw chunk, the log density captured
    (``_stan_k2_frozen``).  Then ``sample()`` at the main path's
    configuration (2048 chains x (300 + ``PYMC_DRAWS``), pooled, seed 42,
    float32), K1's and K2's counts set to 0 just before: K1 never, K2 with
    graph replays.  Draws finite, max split R-hat below 1.05, each
    monitored column's mean within ``PYMC_MCSE`` combined MCSE of the main
    phase's K1 trace.  Prints logp+grad ms a call by graph replays beside
    ``nt.models.radon()``'s, and the wall's split (K2 by the device time
    the stan phase measured at the same shapes)."""
    import numpy as np
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.sample import chunk_length
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel
    from nutpie_tpu_torch.settings import NutsSettings

    t_phase = time.perf_counter()
    fake = _torch_fake_pymc()
    compiled = nt.compile_pymc_model(fake.radon_model()[0])
    model = compiled._make_model(0)
    ref = nt.models.radon()
    assert model.ndim == ref.ndim == 173, (model.ndim, ref.ndim)
    failed: list = []
    x_host = np.random.default_rng(9).normal(size=(PYMC_PARITY_CHAINS, model.ndim)) * 0.3
    x = torch.as_tensor(x_host, device=DEVICE)
    lp, gp = model.logp_and_grad(x)
    lr, gr = ref.logp_and_grad(x)
    lc, gc_ = model.logp_and_grad(torch.as_tensor(x_host))
    offset = (lp - lr).cpu().numpy()
    parity = {"logp_offset": float(offset.mean()),
              "offset_spread": float(offset.max() - offset.min()),
              "offset_spread_rel": float((offset.max() - offset.min())
                                         / lr.abs().max().item()),
              "grad_max_rel_err": max_rel(gp, gr),
              "card_vs_cpu_logp_max_rel": max_rel(lp.cpu(), lc),
              "card_vs_cpu_grad_max_rel": max_rel(gp.cpu(), gc_)}
    if not (parity["offset_spread_rel"] < 1e-10 and parity["grad_max_rel_err"] < 1e-10
            and parity["card_vs_cpu_logp_max_rel"] < 1e-12
            and parity["card_vs_cpu_grad_max_rel"] < 1e-12):
        failed.append(f"pymc radon parity: {parity}")
    parity["k2_frozen"] = _stan_k2_frozen(failed, "pymc radon K2 frozen chunk", model, 31,
                                          PYMC_PARITY_DRAWS)
    parity_s = time.perf_counter() - t_phase

    torch.cuda.synchronize()
    _zero_counts(step_kernel, chunk_kernel)
    t0 = time.perf_counter()
    raw = nt.sample(compiled, progress_bar=False, chains=CHAINS, tune=TUNE, draws=PYMC_DRAWS,
                    seed=42, pool_mass_matrix=True, pool_step_size=True, device="cuda",
                    return_raw_trace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = chunk_kernel.launches, step_kernel.launches
    graphs = {"graph_replays": step_kernel.replays, "capture_s": step_kernel.capture_s}
    assert k1 == 0, f"K1 launched {k1} times on a PyMC model"
    assert k2 > 0 and graphs["graph_replays"] > 0, f"K2 {k2} launches, {graphs}"
    pos = raw["position"]
    assert pos.shape == (CHAINS, TUNE + PYMC_DRAWS, model.ndim), pos.shape
    assert np.isfinite(pos).all(), "non-finite draws"
    grads = int(raw["stats"]["n_steps"].astype(np.int64).sum())
    post = pos[:, TUNE:, :]
    ess, rhat = column_diagnostics(post, MONITORED)
    min_ess = float(np.min(ess))
    if max(rhat) >= 1.05:
        failed.append(f"split R-hat {max(rhat)} on a monitored column")
    k1_post, k1_ess = ctx["main_raw"]["position"][:, TUNE:, :], ctx["main_ess"]
    worst = 0.0
    for c, e_p, e_k in zip(MONITORED, ess, k1_ess):
        se = math.hypot(post[:, :, c].std() / math.sqrt(e_p),
                        k1_post[:, :, c].std() / math.sqrt(e_k))
        worst = max(worst, abs(float(post[:, :, c].mean() - k1_post[:, :, c].mean())) / se)
    if worst >= PYMC_MCSE:
        failed.append(f"a posterior mean {worst:.2f} combined MCSE from K1's")
    expanded = {name: list(v.shape[2:]) for name, v in raw["expanded"].items()}

    xt = torch.as_tensor(post[:, -1, :], device=DEVICE)
    pymc_ms = _logp_graph_ms(model, xt)
    radon_ms = _logp_graph_ms(ref, xt)
    settings = NutsSettings.Diag(42)
    settings.update(num_chains=CHAINS, num_tune=TUNE, num_draws=PYMC_DRAWS)
    chunk_len = chunk_length(settings, CHAINS, model.ndim, 4)
    steps = k2 - math.ceil((TUNE + PYMC_DRAWS) / chunk_len)
    k2_dev = ctx["stan_k2"]["device_ms"]
    split = {"machine_steps": steps, "logp_grad_s": steps * pymc_ms / 1e3,
             "k2_s": steps * k2_dev / 1e3 if k2_dev is not None else None,
             "capture_s": graphs["capture_s"],
             "timed": "logp+grad by CUDA events over graph replays, K2 by the device time "
                      "the stan phase measured at the same shapes (2048 chains, dim 173, "
                      "float32)"}
    split["rest_s"] = wall - split["logp_grad_s"] - (split["k2_s"] or 0.0) - split["capture_s"]
    split["shares"] = {k: None if split[k] is None else split[k] / wall
                       for k in ("logp_grad_s", "k2_s", "capture_s", "rest_s")}
    ctx["pymc_k2"] = {"launches": k2, **graphs, "logp_grad_ms": pymc_ms,
                      "radon_logp_grad_ms": radon_ms,
                      "max_abs_err": parity["k2_frozen"]["max_abs_err_position"]}
    emit({"phase": "pymc", "chains": CHAINS, "tune": TUNE, "draws": PYMC_DRAWS,
          "dtype": "float32", "parity_f64": parity, "parity_s": parity_s,
          "k1_launches": k1, "k2_launches": k2, **graphs, "wall_s": wall, "gradients": grads,
          "grads_per_s": grads / wall, "min_bulk_ess": min_ess, "min_ess_per_s": min_ess / wall,
          "max_rhat": float(max(rhat)),
          "posterior_divergences": int(raw["stats"]["diverging"][:, TUNE:].sum()),
          "max_mean_gap_mcse_vs_k1": worst, "mcse_bar": PYMC_MCSE,
          "expanded_shapes": expanded,
          "logp_grad_ms_per_call": {"pymc_radon": pymc_ms, "radon_model": radon_ms,
                                    "ratio": pymc_ms / radon_ms, "chains": CHAINS,
                                    "timed": "CUDA events over graph replays"},
          "chunk_len": chunk_len, "split_of_wall": split,
          "seconds": time.perf_counter() - t_phase, "card": ctx["card"], "failed": failed})
    assert not failed, failed


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _collectives_reading(collectives, n_chunks: int) -> dict:
    """The mesh's collectives over a run of ``n_chunks`` chunks: calls,
    bytes and seconds (CUDA events) a chunk boundary."""
    return {"calls_per_boundary": collectives.calls / n_chunks,
            "bytes_gathered_per_boundary": collectives.bytes / n_chunks,
            "collective_s_per_boundary": collectives.seconds() / n_chunks}


def phase_distributed(ctx):
    """The main paths through a one-rank NCCL group (``nutpie_tpu_torch.
    parallel``): radon through K1 at the main phase's settings, cut to
    ``DIST_DRAWS`` posterior draws, bitwise the main phase's first draws;
    the GLM through K2, pooled, bitwise the same run without the group."""
    import torch
    import torch.distributed as dist

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.parallel import collectives, initialize_distributed
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
    from nutpie_tpu_torch.sampler.step_kernel import step_kernel

    t_phase = time.perf_counter()
    glm = compile_model_def(_glm_model())
    glm_kw = dict(chains=GLM_CHAINS, tune=DIST_GLM_TUNE, draws=DIST_GLM_DRAWS, seed=42,
                  chunk_size=DIST_GLM_CHUNK, precision="float32", pool_mass_matrix=True,
                  pool_step_size=True, device="cuda", progress_bar=False,
                  return_raw_trace=True)
    # without the group first: inside it, sample() takes the group up
    assert not dist.is_initialized()
    glm_alone = nt.sample(glm, **glm_kw)
    t0 = time.perf_counter()
    mesh = initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, timeout=300.0)
    init_s = time.perf_counter() - t0
    try:
        assert mesh.size == 1 and mesh.group is not None and mesh.device.type == "cuda"
        backend = dist.get_backend()
        assert backend == "nccl", backend

        n_draws = TUNE + DIST_DRAWS
        n_chunks = math.ceil(n_draws / CHUNK)
        collectives.reset(timing=True)
        _zero_counts(step_kernel, chunk_kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = nt.sample(compile_model_def(nt.models.radon()), progress_bar=False,
                           chains=CHAINS, tune=TUNE, draws=DIST_DRAWS, seed=42,
                           pool_mass_matrix=True, pool_step_size=True, device="cuda",
                           return_raw_trace=True, blocking=False)
        raw = handle.wait()
        torch.cuda.synchronize()
        radon = {"wall_s": time.perf_counter() - t0, "chunks": n_chunks,
                 "k1_launches": chunk_kernel.launches, "k2_launches": step_kernel.launches,
                 "depth_cap": handle.depth_cap, **_collectives_reading(collectives, n_chunks)}
        assert radon["k1_launches"] == n_chunks and radon["k2_launches"] == 0, radon
        bad = _raw_diff(raw, ctx["main_raw"])
        assert not bad, f"radon in the group differs from the main phase in {bad}"
        assert handle.depth_cap == ctx["main_depth_cap"], \
            f"depth cap {handle.depth_cap} against the main phase's {ctx['main_depth_cap']}"

        n_chunks = math.ceil((DIST_GLM_TUNE + DIST_GLM_DRAWS) / DIST_GLM_CHUNK)
        collectives.reset(timing=True)
        _zero_counts(step_kernel, chunk_kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        glm_group = nt.sample(glm, **glm_kw)
        torch.cuda.synchronize()
        glm_reading = {"wall_s": time.perf_counter() - t0, "chunks": n_chunks,
                       "k1_launches": chunk_kernel.launches,
                       "k2_launches": step_kernel.launches,
                       **_collectives_reading(collectives, n_chunks)}
        assert glm_reading["k1_launches"] == 0 and glm_reading["k2_launches"] > 0, glm_reading
        bad = _raw_diff(glm_group, glm_alone)
        assert not bad, f"the GLM in the group differs from its run alone in {bad}"
    finally:
        collectives.reset()
        if dist.is_initialized():
            dist.destroy_process_group()
    emit({"distributed": {
        "backend": backend, "world_size": mesh.size, "nccl_version": torch.cuda.nccl.version(),
        "group_init_s": init_s,
        "radon": {"shapes": f"{CHAINS} chains x ({TUNE} + {DIST_DRAWS}), chunk {CHUNK}, "
                            "pooled, float32, through K1", "bitwise_vs_main": True, **radon},
        "glm": {"shapes": f"{GLM_CHAINS} chains x ({DIST_GLM_TUNE} + {DIST_GLM_DRAWS}), "
                          f"chunk {DIST_GLM_CHUNK}, pooled, float32, through K2",
                "bitwise_vs_no_group": True, **glm_reading},
        "seconds": time.perf_counter() - t_phase, "card": ctx["card"],
    }})


# K1's phases first, while K2's and K3's libraries compile
PHASES = {
    "build": phase_build,
    "parity": phase_parity,
    "main": phase_main,
    "warmup": phase_warmup,
    "timing": phase_timing,
    "build_steps": phase_build_steps,
    "distributed": phase_distributed,
    "step_parity": phase_step_parity,
    "lowrank_parity": phase_lowrank_parity,
    "glm": phase_glm,
    "lowrank": phase_lowrank,
    "mclmc_parity": phase_mclmc_parity,
    "mclmc": phase_mclmc,
    "micro": phase_micro,
    "flow_parity": phase_flow_parity,
    "flow": phase_flow,
    "step_timing": phase_step_timing,
    "options_parity": phase_options_parity,
    "options": phase_options,
    "control": phase_control,
    "stan_parity": phase_stan_parity,
    "stan": phase_stan,
    "stan_functionals_parity": phase_stan_functionals_parity,
    "stan_ode": phase_stan_ode,
    "stan_ode_mclmc": phase_stan_ode_mclmc,
    "stan_ode_flow": phase_stan_ode_flow,
    "pymc": phase_pymc,
    "profile": phase_profile,
}
# the phases of the case study under MCLMC and flow and of the PyMC
# frontend, and the budgets of their seconds and of the script's, printed
# beside them (readings: the run's limit is 1200 s, and a slower host takes
# about 1.16 times as long)
NEW_PHASES = ("stan_ode_mclmc", "stan_ode_flow", "pymc")
NEW_PHASES_BUDGET_S, TOTAL_BUDGET_S = 50, 1000
# phases whose results a later phase reads
NEEDS = {"timing": ("warmup",), "micro": ("step_parity",),
         "step_timing": ("step_parity", "lowrank_parity", "micro"),
         "options_parity": ("warmup", "step_parity"), "options": ("main", "options_parity", "warmup", "step_parity"),
         "control": ("main", "glm"), "flow": ("flow_parity",), "stan": ("main", "warmup"),
         "distributed": ("main",), "pymc": ("main", "warmup", "stan")}


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

    # vmap's per-example fallback (an operation without a batching rule)
    # would hide a loop over chains inside the Stan log density: an error
    warnings.filterwarnings("error", message="There is a performance drop")
    start = time.perf_counter()
    ctx: dict = {}
    asked = {p for p in args.phases.split(",") if p}
    asked |= {"build", "build_steps"} | {n for p in asked for n in NEEDS.get(p, ())}
    phases = [p for p in PHASES if p in asked]
    # every phase runs, so one call reads them all; any failure fails the run
    failed, seconds, memory = [], {}, {}
    try:
        for name in phases:
            t0 = time.perf_counter()
            try:
                PHASES[name](ctx)
            except Exception:
                traceback.print_exc()
                print(f"chip_smoke: phase {name} failed", file=sys.stderr, flush=True)
                failed.append(name)
            seconds[name] = round(time.perf_counter() - t0, 1)
            # what a phase leaves on the card, before and after the garbage
            # collector and the allocator's cache release (a finished run's
            # background sampler and its graphs are freed by the collector)
            memory[name] = [round(torch.cuda.memory_reserved() / 2**30, 2)]
            gc.collect()
            torch.cuda.empty_cache()
            memory[name].append(round(torch.cuda.memory_reserved() / 2**30, 2))
    finally:
        _stop_step_builds()
    new = [p for p in NEW_PHASES if p in seconds]
    emit({"phase_seconds": seconds, "total_s": round(time.perf_counter() - start, 1),
          "total_budget_s": TOTAL_BUDGET_S, "new_phases": new,
          "new_phases_s": round(sum(seconds[p] for p in new), 1),
          "new_phases_budget_s": NEW_PHASES_BUDGET_S,
          "reserved_gib_after_phase": memory})
    if failed:
        print(f"chip_smoke: failed phases {failed}; no result line", file=sys.stderr)
        return 1

    full = len(phases) == len(PHASES)
    if full:
        from nutpie_tpu_torch.sampler.mclmc_kernel import mclmc_kernel
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
                "library_device_ms": ctx["lr_library_device_ms"],
                "library": "two torch.bmm per metric application, times the applications "
                           "a step (the metric part only)",
                "parity": "ok",
            },
            "fixed_metric": {
                "timed_at": f"{FLOW_PARITY_CHAINS} chains, dim {FLOW_DIM + 1}, float32 (the "
                            "flow fleet's funnel in its flows' base space)",
                "launches": ctx["flow_k2_launches"],
                **ctx["flow_k2_parity"],
                "ms": ctx["flow_k2_timing"]["ms"],
                "device_ms": ctx["flow_k2_timing"]["device_ms"],
                "plain_ms": ctx["flow_k2_timing"]["plain_ms"],
                "bound_ms": ctx["flow_k2_timing"]["bound_ms"],
                "bound_by": "bytes",
                "share_of_bound": ctx["flow_k2_timing"]["share_of_bound"],
                "library_ms": None,
                "parity": "ok",
            },
            "stan_radon": {
                "shapes": f"{CHAINS} chains, dim 173, float32 (the Stan radon program's "
                          "interpreted log density in the runner's graphs)",
                **{k: v for k, v in ctx["stan_k2"].items() if k != "float32"},
                "timed_at": f"{CHAINS} chains, dim 173, float32, a {STAN_F32_DRAWS}-draw "
                            "frozen chunk of the tuned fleet",
                "max_abs_err": ctx["stan_parity"]["radon"][0],
                "max_abs_err_at": f"{STAN_PARITY_CHAINS} chains, dim 173, float64, a "
                                  f"{ctx['stan_parity']['radon'][1]}-draw frozen chunk "
                                  f"of a fresh fleet, trees to depth {STAN_PARITY_MAXDEPTH}",
                "censored_max_abs_err": ctx["stan_parity"]["censored"][0],
                "censored_max_abs_err_at": f"{STAN_PARITY_CHAINS} chains, dim 2, float64, a "
                                           f"{ctx['stan_parity']['censored'][1]}-draw frozen "
                                           "chunk of a fresh fleet, trees to depth "
                                           f"{STAN_PARITY_MAXDEPTH}",
                "float32_shares": ctx["stan_k2"]["float32"],
                "float32_shares_at": f"{CHAINS} chains, dim 173, float32, a "
                                     f"{STAN_F32_DRAWS}-draw frozen chunk of the tuned fleet",
                "library_ms": None,
                "parity": "ok",
            },
            "stan_lotka_volterra": {
                "shapes": f"{LV_CHAINS} chains, dim 8, float32 (the Lotka-Volterra case "
                          "study's log density called eagerly between launches: its ODE "
                          "solve reads the device to stop)",
                **{k: v for k, v in ctx["lv_k2"].items() if k != "float32"},
                "timed_at": f"{LV_CHAINS} chains, dim 8, float32, a {LV_TIMED_DRAWS}-draw "
                            f"frozen chunk of a fresh fleet, trees to depth {LV_PARITY_MAXDEPTH}",
                "float32_shares": ctx["lv_k2"]["float32"],
                "float32_shares_at": f"{LV_CHAINS} chains, dim 8, float32, the same chunk "
                                     "as timed_at, through the runner's eager route",
                "max_abs_err": ctx["lv_parity"]["max_abs_err_position"],
                "max_abs_err_at": f"{LV_PARITY_CHAINS} chains, dim 8, float64, a "
                                  f"{LV_PARITY_DRAWS}-draw frozen chunk of a fresh fleet, "
                                  f"trees to depth {LV_PARITY_MAXDEPTH}",
                "bitwise": ctx["lv_parity"]["bitwise"],
                "library_ms": None,
                "parity": "ok",
            },
            "stan_lotka_volterra_flow": {
                "shapes": f"{LV_FLOW_CHAINS} chains, dim 8, float32 (K2 under its fixed "
                          "metric around the case study's pulled-back log density, called "
                          "eagerly between launches)",
                **{k: v for k, v in ctx["lv_k2_flow"].items() if k != "float32"},
                "timed_at": f"{LV_FLOW_CHAINS} chains, dim 8, float32, a 1-draw frozen chunk "
                            "of a fresh fleet under seeded flows, trees to depth "
                            f"{LV_FLOW_MAXDEPTH}",
                "float32_shares": ctx["lv_k2_flow"]["float32"],
                "float32_shares_at": "the same chunk as timed_at, through the runner's eager "
                                     "route",
                "max_abs_err_at": "the same chunk, float32",
                "library_ms": None,
                "parity": "ok",
            },
            "pymc_radon": {
                "shapes": f"{CHAINS} chains, dim 173, float32 (radon as a PyMC model, lowered "
                          "by the PyTorch linker's stand-in, in the runner's graphs)",
                **ctx["pymc_k2"],
                "max_abs_err_at": f"{STAN_PARITY_CHAINS} chains, dim 173, float64, a "
                                  f"{PYMC_PARITY_DRAWS}-draw frozen chunk of a fresh fleet, "
                                  f"trees to depth {STAN_PARITY_MAXDEPTH}",
                "ms": ctx["stan_k2"]["ms"],
                "device_ms": ctx["stan_k2"]["device_ms"],
                "plain_ms": ctx["stan_k2"]["plain_ms"],
                "bound_ms": ctx["stan_k2"]["bound_ms"],
                "bound_by": ctx["stan_k2"]["bound_by"],
                "timed_at": "the stan phase's chunk at the same shapes and form (K2's "
                            "advance reads the log density's outputs, not its code)",
                "library_ms": None,
                "parity": "ok",
            },
            "microcanonical": {
                "shapes": f"{GLM_CHAINS} chains, dim {GLM_DIM}, float32 (the GLM)",
                "launches": ctx["micro_launches"],
                **ctx["micro_graphs"],
                "max_abs_err": ctx["micro_max_abs_err"],
                "ms": ctx["micro_ms"],
                "device_ms": ctx["micro_device_ms"],
                "plain_ms": ctx["micro_plain_ms"],
                "bound_ms": ctx["micro_bound_ms"],
                "bound_by": "bytes",
                "library_ms": None,
                "parity": "ok",
            },
        }, {
            "name": mclmc_kernel.name,
            "route": "cuda",
            "source": mclmc_kernel.source,
            "replaces": mclmc_kernel.replaces,
            "launches": ctx["mclmc_launches"],
            "max_abs_err": ctx["mclmc_max_abs_err"],
            "ms": ctx["mclmc_ms"],
            "plain_ms": ctx["mclmc_plain_ms"],
            "bound_ms": ctx["mclmc_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "ms_per_step": ctx["mclmc_ms"],
            "device_ms": ctx["mclmc_device_ms"],
            **ctx["mclmc_graphs"],
            "geometry": ctx["k3_geometry"]["float32"],
            "plan": ctx["k3_plans"]["float32"]["glm"],
            "low_rank": {
                "shapes": f"{LR_CHAINS} chains, dim {LR_DIM}, rank {LR_RANK}, float32",
                "plan": ctx["mclmc_lr"]["plan"],
                "max_abs_err": ctx["mclmc_lr_max_abs_err"],
                "ms": ctx["mclmc_lr"]["k3_ms_per_step"],
                "device_ms": ctx["mclmc_lr"]["k3_device_ms_per_step"],
                "plain_ms": ctx["mclmc_lr"]["plain_ms_per_step"],
                "bound_ms": ctx["mclmc_lr"]["bytes_bound_ms_per_step"],
                "bound_by": "bytes",
                "share_of_bound": ctx["mclmc_lr"]["share_of_bound"],
                "library_ms": ctx["mclmc_lr"]["library_ms_per_step"],
                "library_device_ms": ctx["mclmc_lr"]["library_device_ms_per_step"],
                "library": "two torch.bmm per metric application, three applications a "
                           "step (the metric part only)",
                "parity": "ok",
            },
            "stan_lotka_volterra": {
                "shapes": f"{LV_MCLMC_CHAINS} chains, dim 8, float32 (the case study's log "
                          "density called eagerly between the kick and the settle)",
                **{k: v for k, v in ctx["lv_k3"].items() if k != "float32"},
                "timed_at": f"{LV_MCLMC_CHAINS} chains, dim 8, float32, a {LV_K3_DRAWS}-draw "
                            "frozen chunk of a fresh fleet",
                "float32_shares": ctx["lv_k3"]["float32"],
                "float32_shares_at": "the same chunk as timed_at, through the runner's eager "
                                     "route",
                "max_abs_err_at": "the same chunk, float32",
                "library_ms": None,
                "parity": "ok",
            },
            "fixed_metric": {
                "timed_at": f"{FLOW_MCLMC_CHAINS} chains, dim 4, float32 (the MCLMC flow "
                            "run's Gaussian in its flows' base space)",
                "launches": ctx["flow_k3_launches"],
                **ctx["flow_k3_parity"],
                "ms": ctx["flow_k3_timing"]["ms"],
                "device_ms": ctx["flow_k3_timing"]["device_ms"],
                "plain_ms": ctx["flow_k3_timing"]["plain_ms"],
                "bound_ms": ctx["flow_k3_timing"]["bound_ms"],
                "bound_by": "bytes",
                "share_of_bound": ctx["flow_k3_timing"]["share_of_bound"],
                "library_ms": None,
                "parity": "ok",
            },
            "parity": "ok",
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
