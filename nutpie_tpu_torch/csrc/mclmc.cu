// MCLMC step kernel (K3) for Hopper (sm_90a): the integrator of
// microcanonical Langevin Monte Carlo between batched log densities, and
// each draw's end.
//
// Replaces the body of the JAX package's XLA scan (nutpie_tpu/sampler/
// mclmc.py:173-319, one_step and the draw's end; it is not a port of a
// Pallas kernel).  MCLMC is lockstep: every chain takes steps_per_draw
// integrator steps a draw, each a position half-step, the log density at
// the midpoint, the velocity update, a second half-step and the log density
// at the end, with no tree and no accept/reject.  The caller evaluates each
// log density for all chains in one torch call; this kernel runs
// everything between them, as three pieces (the plain version is
// nutpie_tpu_torch/sampler/mclmc.py:PlainMclmcSteps, same arithmetic in
// the same order):
//   - begin (a chunk's first launch): the draw's entry velocity, normalized
//     where the draw is isokinetic, and the first position half-step
//     z = x + eps/2 A u, handed to the log density;
//   - kick (after the midpoint's gradient): g_z = -A^T g, the velocity
//     update of the draw's trajectory kind (the exact isokinetic update, or
//     the euclidean full kick u - eps g_z) with its kinetic-energy change,
//     and the second half-step z += eps/2 A u;
//   - settle (after the end's log density): the energy error into the
//     draw's sums, the partial refresh (projective for isokinetic, OU for
//     euclidean) from the step's normals, and at the draw's last step its
//     end: the divergence rejection (position, gradient and log density
//     kept, a fresh velocity from the last step's normals), the EEVPD
//     step-size rule, the Welford windows with their switches and the
//     inverse-mass estimate (adapt.cuh's device functions), the commit into
//     the chunk buffers and the next draw's start; else the next step's
//     first half-step.
// The step within the draw and the draw counter live on the device, so a
// draw's launches can be captured in a CUDA graph and replayed.
//
// The refresh normals are drawn here, for the coordinates each thread
// owns: step j of the draw with absolute index d draws
// normal(fold_in(fold_in(fold_in(chain_key, 4), d), j), (dim,)), the JAX
// package's split(fold_in(fold_in(key, 4), d), S)[j] under the
// partitionable layout (threefry.cuh: normal_element).  The wrapper folds
// in the 4 once a chunk: `keys` holds the words of fold_in(chain_key, 4).
// A divergent draw's fresh velocity is its last step's normals again,
// held in registers, or kept in the work row where the form holds no
// rows, so that each normal is drawn once.
//
// What bounds it: bytes, in principle.  A step reads and writes a few rows a chain (the
// position, the velocity, the gradient, z, the inverse mass; under the
// low-rank metric the chain's [dim, R] basis, 128 KB at dim 1000, R 32 in
// float32, against 4 KB rows) with a handful of operations per coordinate.
// Each piece is written once against a thread group (group.cuh) and a row
// abstraction (Row: a row's chunks held in registers for the launch, read
// once and written once, or read and written in device memory at each
// access), and instantiated in three forms, chosen before anything runs
// (sampler/mclmc_kernel.py:mclmc_plan, K2's plans with K3's needs):
//   - held (the diagonal metric, dim <= 64 a multiple of the 16-byte
//     chunk): K2's held form, 8 lanes a chain in float32 (16 in float64),
//     each thread owning at most two float4 (double2) chunks, the rows a
//     piece needs in registers, so the refresh, the draw's end and the
//     next draw's start run on registers, the step's normals included;
//   - strided (the diagonal metric, any other dim): 32 lanes a chain, one
//     coordinate at a time, rows in device memory (L1);
//   - low-rank (R > 0): a persistent block of kLrWarps warps a chain, its
//     basis staged into shared memory once a launch by TMA bulk copies (or
//     streamed through a ring of tiles where it does not fit, or copied by
//     loads where a chain's basis is not 16-byte aligned), each tile of the
//     next chain's basis sent on its way as soon as the chain's last pass
//     is done with it (lowrank.cuh, shared with K2), the rows in device
//     memory (held in registers they made the kernel about twice as long,
//     and it ran slower).  Every application of the launch (the kick's
//     A^T g and A u, the settle's A u or the next draw's first half-step)
//     reads the staged tiles with K2's products
//     (project, set_coefficients, expand), so a launch reads a chain's
//     basis from device memory once when staged (twice an application
//     streamed); the chunk's last settle applies no metric and reads none.
//     With one block (8 warps) an SM and a chain at a time, the block's
//     latency, and not the basis bytes, bounds this form.
// Every sum keeps the order of a 32-lane warp over the coordinates
// (LaneGroup::sum; the block form adds its warps' sums in warp order),
// every order is fixed, so reruns are bitwise repeatable.  Built without
// FMA contraction (ops/build.py), so it rounds each product and sum as its
// plain version.
#include <cuda_runtime.h>

#include "adapt.cuh"
#include "group.cuh"
#include "lowrank.cuh"
#include "threefry.cuh"
#include "warp.cuh"

namespace nutpie {

// the rows of the MCLMC state and its scalar slots (sampler/mclmc.py)
enum McVec { MV_POSITION = 0, MV_GRADIENT, MV_VELOCITY, N_MV };
enum McFlt { MF_LOGP = 0, MF_LOG_EPS, N_MF };
enum McInt { MI_DRAW_IDX = 0, MI_TOTAL_STEPS, MI_DIVERGENCE_COUNT, N_MI };
// the chunk's scratch scalars: running logp, the step's dke, the sums of
// the energy errors and of their squares
enum McRun { MR_LOGP = 0, MR_DKE, MR_DE_SUM, MR_DE2_SUM, N_MR };
// the chunk buffers' packed scalars
enum McScalar { MS_LOGP = 0, MS_ENERGY_ERROR, MS_DIVERGING, MS_STEP_SIZE, N_MS };
// trajectory kinds, in sampler/mclmc.py:TRAJECTORIES' order
enum McTrajectory { T_MICRO = 0, T_EUCLID, T_EUCLID_THEN_MICRO };
enum McPiece { P_BEGIN = 0, P_KICK, P_SETTLE };

// coordinates a chunk of the held form (16 bytes), and the chunks a thread
// of it holds (sampler/step_kernel.py:diag_forms, K2's held form)
template <typename T>
constexpr int kMcVec = 16 / int(sizeof(T));
constexpr int kMcHeld = 2;
constexpr int kMcLrThreads = BlockGroup<kLrWarps>::kBlockThreads;

// Static configuration (mclmc_kernel.py:McConfig).  `mk` carries the
// adaptation's fields that adapt.cuh reads (the variance clips, the
// estimate's kind, the switch cadences), the sizes, and the launch plan:
// the low-rank metric's rank and form (lr_rank, lr_streamed, lr_tma,
// lr_grid), or the diagonal form (step_lanes, step_vec, step_held,
// step_grid).
struct McConfig {
  MkConfig mk;
  double max_energy_error;
  double euclid_max_energy_error;  // min(max_energy_error, 5)
  double log_target_eevpd;
  double log_min_step;
  double decoherence_length;       // L = momentum_decoherence_length sqrt(dim)
  int32_t steps_per_draw;
  int32_t trajectory;              // McTrajectory
  int32_t dynamic_step_size;
};

// Device pointers of one launch (mclmc_kernel.py:McPtrs).
struct McPtrs {
  const int32_t* scal;  // chunk_start, limit, num_tune, early_end, freeze_start, depth_cap
  void* vecs;           // [C, 3, dim] position, gradient, velocity
  void* flts;           // [C, 2] logp, log_eps
  int32_t* ints;        // [C, 3] draw_idx, total_steps, divergence_count
  void* adapt_vecs;     // [C, N_ADAPT_VEC, dim]
  void* adapt_flts;     // [C, N_ADAPT_FLT] (the Welford counts)
  const void* lr_basis;     // [C, dim, R] (R > 0)
  const void* lr_log_eigs;  // [C, R]
  const int32_t* keys;  // [C, 2] the words of fold_in(chain key, 4) (settle)
  void* z;              // [C, dim] the point handed to the log density
  void* velocity;       // [C, dim] the running velocity
  void* run_flts;       // [C, N_MR]
  int32_t* step;        // [C] the step within the draw
  const void* logp;     // [C] (settle)
  const void* grad;     // [C, dim] (kick, settle)
  void* pos_out;        // [C, L, dim]
  void* scal_out;       // [C, L, N_MS]
  void* grad_out;       // [C, L, dim] or null
  void* minv_out;       // [C, L, dim] or null
  void* work;           // [C, dim] a row of each chain's own (strided and low-rank
                        // forms; null in the held form)
};

// the low-rank block's dynamic shared memory (LrLayout)
extern __shared__ __align__(128) unsigned char mc_smem[];

template <typename T>
__host__ __device__ inline LrLayout mc_layout(const MkConfig& c) {
  return LrLayout(c.dim, c.lr_rank, int(sizeof(T)), c.lr_streamed != 0);
}

template <typename T>
struct McArgs {
  McConfig cfg;
  const int32_t* scal;
  T* vecs;
  T* flts;
  int32_t* ints;
  T* adapt_vecs;
  T* adapt_flts;
  const T* lr_basis;
  const T* lr_log_eigs;
  const uint32_t* keys;
  T* z;
  T* velocity;
  T* run_flts;
  int32_t* step;
  const T* logp;
  const T* grad;
  T* pos_out;
  T* scal_out;
  T* grad_out;
  T* minv_out;
  T* work;

  McArgs(const McConfig& c, const McPtrs& p)
      : cfg(c), scal(p.scal), vecs(static_cast<T*>(p.vecs)), flts(static_cast<T*>(p.flts)),
        ints(p.ints), adapt_vecs(static_cast<T*>(p.adapt_vecs)),
        adapt_flts(static_cast<T*>(p.adapt_flts)),
        lr_basis(static_cast<const T*>(p.lr_basis)),
        lr_log_eigs(static_cast<const T*>(p.lr_log_eigs)),
        keys(reinterpret_cast<const uint32_t*>(p.keys)), z(static_cast<T*>(p.z)),
        velocity(static_cast<T*>(p.velocity)), run_flts(static_cast<T*>(p.run_flts)),
        step(p.step), logp(static_cast<const T*>(p.logp)),
        grad(static_cast<const T*>(p.grad)), pos_out(static_cast<T*>(p.pos_out)),
        scal_out(static_cast<T*>(p.scal_out)), grad_out(static_cast<T*>(p.grad_out)),
        minv_out(static_cast<T*>(p.minv_out)), work(static_cast<T*>(p.work)) {}

  __device__ __forceinline__ Sched sched() const {
    return Sched{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5]};
  }

  // The block's view of the low-rank metric (its barriers initialized).
  template <typename G>
  __device__ __forceinline__ LowRank<T> metric(const G& g) const {
    return LowRank<T>(cfg.mk, lr_basis, lr_log_eigs, mc_smem, mc_layout<T>(cfg.mk), g.warp(),
                      g.lane());
  }
};

// A chain's scalars in registers: its state's (flts, ints) and the
// chunk's running ones (run_flts), loaded once a launch by every thread
// and stored by the group's leader.
template <typename T>
struct Scalars {
  T logp, log_eps;                      // MF_LOGP, MF_LOG_EPS
  int draw_idx, total_steps, divergences;
  T run_logp, dke, de_sum, de2_sum;     // MR_*

  __device__ __forceinline__ void load(const McArgs<T>& a, int chain) {
    const T* fl = a.flts + size_t(chain) * N_MF;
    const int* in = a.ints + size_t(chain) * N_MI;
    const T* run = a.run_flts + size_t(chain) * N_MR;
    logp = fl[MF_LOGP];
    log_eps = fl[MF_LOG_EPS];
    draw_idx = in[MI_DRAW_IDX];
    total_steps = in[MI_TOTAL_STEPS];
    divergences = in[MI_DIVERGENCE_COUNT];
    run_logp = run[MR_LOGP];
    dke = run[MR_DKE];
    de_sum = run[MR_DE_SUM];
    de2_sum = run[MR_DE2_SUM];
  }
  __device__ __forceinline__ void store(const McArgs<T>& a, int chain) const {
    T* fl = a.flts + size_t(chain) * N_MF;
    int* in = a.ints + size_t(chain) * N_MI;
    T* run = a.run_flts + size_t(chain) * N_MR;
    fl[MF_LOGP] = logp;
    fl[MF_LOG_EPS] = log_eps;
    in[MI_DRAW_IDX] = draw_idx;
    in[MI_TOTAL_STEPS] = total_steps;
    in[MI_DIVERGENCE_COUNT] = divergences;
    run[MR_LOGP] = run_logp;
    run[MR_DKE] = dke;
    run[MR_DE_SUM] = de_sum;
    run[MR_DE2_SUM] = de2_sum;
  }
};

// One of a chain's rows as the calling thread sees it, at the chunks it
// owns (each_chunk): held in registers for the launch (KC > 0: read once by
// load(), written once by store()), or read and written in device memory
// at every access (KC = 0: load() and store() do nothing).
template <typename T, int N, int KC>
struct Row {
  using V = Vec<T, N>;
  static constexpr int S = KC > 0 ? KC : 1;
  T* p;
  V r[S];

  __device__ __forceinline__ explicit Row(T* row) : p(row) {}

  template <typename G>
  __device__ __forceinline__ void load(const G& g, int n_chunks) {
    if constexpr (KC > 0) each_chunk<KC>(g, n_chunks, [&](int j, int c) { r[j] = ld<N>(p, c); });
  }
  template <typename G>
  __device__ __forceinline__ void store(const G& g, int n_chunks) const {
    if constexpr (KC > 0) each_chunk<KC>(g, n_chunks, [&](int j, int c) { st<N>(p, c, r[j]); });
  }
  __device__ __forceinline__ V get(int j, int c) const {
    if constexpr (KC > 0) {
      return r[j];
    } else {
      return ld<N>(p, c);
    }
  }
  __device__ __forceinline__ void set(int j, int c, const V& v) {
    if constexpr (KC > 0) {
      r[j] = v;
    } else {
      st<N>(p, c, v);
    }
  }
};

// f(t, i) for each tile t of the calling warp's share of the basis (t =
// warp, warp + kLrWarps, ...; the low-rank block) and the coordinate i =
// 32 t + lane the thread owns in it, the coordinates each_chunk gives the
// thread in the same order.  i may pass dim: every lane of a tile takes
// part in its products.
template <typename G, typename F>
__device__ __forceinline__ void each_tile(const G& g, int dim, F&& f) {
  for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
    f(base / kLanes, base + g.lane());
  }
}

// The refresh normals of one step of one chain: element i of
// normal(fold_in(fold_in(keys[chain], d), j), (dim,)) for the absolute draw
// d and the step j within it.
template <typename T>
struct StepNormals {
  uint32_t k1, k2;

  __device__ __forceinline__ StepNormals(const uint32_t* keys, int chain, int draw, int step)
      : k1(keys[2 * size_t(chain)]), k2(keys[2 * size_t(chain) + 1]) {
    fold_in(k1, k2, uint32_t(draw));
    fold_in(k1, k2, uint32_t(step));
  }
  // chunk c's N normals (coordinates c N .. c N + N - 1)
  template <int N>
  __device__ __forceinline__ Vec<T, N> at(int c) const {
    Vec<T, N> v;
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = normal_element<T>(k1, k2, uint32_t(c * N + k));
    return v;
  }
};

template <typename T>
__device__ __forceinline__ bool is_micro(const McConfig& cfg, const Sched& s, int draw_idx) {
  if (cfg.trajectory == T_EUCLID) return false;
  if (cfg.trajectory == T_EUCLID_THEN_MICRO) return draw_idx >= s.num_tune / 2;
  return true;
}

// Everything a piece of one chain works on: its group, the metric, the
// sizes and the chain's rows.
template <typename T, bool LR, int N, int KC, typename G>
struct ChainCtx {
  const McArgs<T>& a;
  const G& g;
  LowRank<T>& m;
  int chain, dim, n;  // n: chunks of a row
  T* v;               // the state's rows
  T* av;              // the adaptation's rows

  __device__ __forceinline__ ChainCtx(const McArgs<T>& a_, const G& g_, LowRank<T>& m_,
                                      int chain_)
      : a(a_), g(g_), m(m_), chain(chain_), dim(a_.cfg.mk.dim), n(a_.cfg.mk.dim / N),
        v(a_.vecs + size_t(chain_) * N_MV * a_.cfg.mk.dim),
        av(a_.adapt_vecs + size_t(chain_) * N_ADAPT_VEC * a_.cfg.mk.dim) {}

  __device__ __forceinline__ T* row(T* base) const { return base + size_t(chain) * dim; }

  // Sum one value per element over the chain's group.
  __device__ __forceinline__ T total(T (&part)[1][N]) const {
    T out[1];
    g.sum(part, out);
    return out[0];
  }
};

// z = x + half A u at the thread's coordinates (z may be x): s u under the
// diagonal metric, s (u + U c) with c = (sqrt(l) - 1) (U^T u) under the
// low-rank one, one application (a pass to project, one to expand).  It
// is the last application of every piece, so as soon as its expansion is
// done with a tile, the tile of the block's next chain sets out into it
// (LowRank::prefetch_tile; staged by TMA).
template <typename T, bool LR, int N, int KC, typename G>
__device__ __forceinline__ void half_step(const ChainCtx<T, LR, N, KC, G>& cx,
                                          const Row<T, N, KC>& im, const Row<T, N, KC>& x,
                                          const Row<T, N, KC>& u, Row<T, N, KC>& z, T half) {
  if constexpr (LR) {
    LowRank<T>& m = cx.m;
    const int dim = cx.dim;
    T acc[kHalf] = {};
    m.pass();
    each_tile(cx.g, dim, [&](int t, int i) {
      m.project(m.tile(t), t, i < dim ? u.p[i] : T(0), acc);
      m.release(t);
    });
    m.pass();
    m.set_coefficients(cx.g, acc, m.root_factor());
    each_tile(cx.g, dim, [&](int t, int i) {
      const T uc = m.expand(m.tile(t), t, i);
      m.release(t);
      m.prefetch_tile(t);
      if (i < dim) z.p[i] = x.p[i] + half * (sqrt(im.p[i]) * (u.p[i] + uc));
    });
    m.prefetched();
  } else {
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      const Vec<T, N> mi = im.get(j, c), xx = x.get(j, c), uu = u.get(j, c);
      Vec<T, N> out;
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = xx[k] + half * (sqrt(mi[k]) * uu[k]);
      z.set(j, c, out);
    });
  }
}

// A draw's start: the entry velocity u_in (normalized where isokinetic)
// into u, the running scalars reset, z the first half-step from x.
template <typename T, bool LR, int N, int KC, typename G>
__device__ __forceinline__ void start_draw(const ChainCtx<T, LR, N, KC, G>& cx, const Sched& s,
                                           const Row<T, N, KC>& x, const Row<T, N, KC>& u_in,
                                           const Row<T, N, KC>& im, Row<T, N, KC>& u,
                                           Row<T, N, KC>& z, Scalars<T>& sc) {
  const bool micro = is_micro<T>(cx.a.cfg, s, sc.draw_idx);
  T norm = T(1);
  if (micro) {
    T part[1][N] = {};
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      const Vec<T, N> ui = u_in.get(j, c);
#pragma unroll
      for (int k = 0; k < N; ++k) part[0][k] += ui[k] * ui[k];
    });
    norm = sqrt(jmax(cx.total(part), T(1e-30)));
  }
  each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
    Vec<T, N> ui = u_in.get(j, c);
    if (micro) {
#pragma unroll
      for (int k = 0; k < N; ++k) ui[k] = ui[k] / norm;
    }
    u.set(j, c, ui);
  });
  sc.run_logp = sc.logp;
  sc.dke = T(0);
  sc.de_sum = T(0);
  sc.de2_sum = T(0);
  half_step(cx, im, x, u, z, T(0.5) * exp(sc.log_eps));
}

// The isokinetic velocity update of u (in place) under the pulled-back
// gradient gz_of(j, c) for time `step` (isokinetic.py:update_velocity);
// returns the kinetic-energy change.  Three sums: the gradient's norm,
// <u, e>, the new velocity's norm.
template <typename T, bool LR, int N, int KC, typename G, typename GZ>
__device__ __forceinline__ T update_velocity(const ChainCtx<T, LR, N, KC, G>& cx,
                                             Row<T, N, KC>& u, GZ&& gz_of, T step) {
  using V = Vec<T, N>;
  T gg[1][N] = {}, ge[1][N] = {}, nn[1][N] = {};  // a group sum consumes its partials
  each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
    const V gz = gz_of(j, c);
#pragma unroll
    for (int k = 0; k < N; ++k) gg[0][k] += gz[k] * gz[k];
  });
  const T g_norm = jmax(sqrt(cx.total(gg)), T(1e-30));
  each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
    const V gz = gz_of(j, c), uu = u.get(j, c);
#pragma unroll
    for (int k = 0; k < N; ++k) ge[0][k] += uu[k] * (-gz[k] / g_norm);
  });
  const T ue = cx.total(ge);
  const T delta = step * g_norm / T(cx.dim - 1);
  const T ch = cosh(delta);
  const T sh = sinh(delta);
  const T denom = ch + ue * sh;
  const T kk = sh + (ch - T(1)) * ue;
  each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
    const V gz = gz_of(j, c), uu = u.get(j, c);
    V un;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      un[k] = (uu[k] + (-gz[k] / g_norm) * kk) / denom;
      nn[0][k] += un[k] * un[k];
    }
    u.set(j, c, un);
  });
  const T norm = sqrt(cx.total(nn));
  each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
    V un = u.get(j, c);
#pragma unroll
    for (int k = 0; k < N; ++k) un[k] = un[k] / norm;
    u.set(j, c, un);
  });
  return T(cx.dim - 1) * log(denom);
}

// The low-rank metric's pulled-back gradient g_z = -A^T g = -(w + U c), w =
// s g, c = (sqrt(l) - 1) (U^T w), into the row gz: one application (K2's
// lr_pull_back).
template <typename T, typename G>
__device__ __forceinline__ void pull_back(const ChainCtx<T, true, 1, 0, G>& cx,
                                          const Row<T, 1, 0>& im, const Row<T, 1, 0>& gr,
                                          Row<T, 1, 0>& gz) {
  LowRank<T>& m = cx.m;
  const int dim = cx.dim;
  T acc[kHalf] = {};
  m.pass();
  each_tile(cx.g, dim, [&](int t, int i) {
    m.project(m.tile(t), t, i < dim ? sqrt(im.p[i]) * gr.p[i] : T(0), acc);
    m.release(t);
  });
  m.pass();
  m.set_coefficients(cx.g, acc, m.root_factor());
  each_tile(cx.g, dim, [&](int t, int i) {
    const T uc = m.expand(m.tile(t), t, i);
    m.release(t);
    if (i < dim) gz.p[i] = -(sqrt(im.p[i]) * gr.p[i] + uc);
  });
}

template <typename T, bool LR, int N, int KC, typename G>
__device__ __forceinline__ void begin_chain(const ChainCtx<T, LR, N, KC, G>& cx,
                                            const Sched& s) {
  const McArgs<T>& a = cx.a;
  const int dim = cx.dim;
  Scalars<T> sc;
  sc.load(a, cx.chain);
  Row<T, N, KC> x(cx.v + MV_POSITION * dim), u_state(cx.v + MV_VELOCITY * dim);
  Row<T, N, KC> im(cx.av + A_INV_MASS * dim), u(cx.row(a.velocity)), z(cx.row(a.z));
  x.load(cx.g, cx.n);
  u_state.load(cx.g, cx.n);
  im.load(cx.g, cx.n);
  start_draw(cx, s, x, u_state, im, u, z, sc);
  u.store(cx.g, cx.n);
  z.store(cx.g, cx.n);
  if (cx.g.leader()) {
    sc.store(a, cx.chain);
    a.step[cx.chain] = 0;
  }
}

template <typename T, bool LR, int N, int KC, typename G>
__device__ __forceinline__ void kick_chain(const ChainCtx<T, LR, N, KC, G>& cx,
                                           const Sched& s) {
  using V = Vec<T, N>;
  const McArgs<T>& a = cx.a;
  const int dim = cx.dim;
  const int draw_idx = a.ints[size_t(cx.chain) * N_MI + MI_DRAW_IDX];
  const T eps = exp(a.flts[size_t(cx.chain) * N_MF + MF_LOG_EPS]);
  Row<T, N, KC> gr(cx.row(const_cast<T*>(a.grad))), im(cx.av + A_INV_MASS * dim);
  Row<T, N, KC> u(cx.row(a.velocity)), z(cx.row(a.z));
  gr.load(cx.g, cx.n);
  im.load(cx.g, cx.n);
  u.load(cx.g, cx.n);
  z.load(cx.g, cx.n);
  // g_z = -A^T g: -(s g) on the fly (diagonal), or by the low-rank
  // metric into the work row
  Row<T, N, KC> gz(cx.row(a.work));
  if constexpr (LR) pull_back(cx, im, gr, gz);
  auto gz_of = [&](int j, int c) {
    V out;
    if constexpr (LR) {
      out = gz.get(j, c);
    } else {
      const V gi = gr.get(j, c), mi = im.get(j, c);
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = -(sqrt(mi[k]) * gi[k]);
    }
    return out;
  };
  T dke;
  if (is_micro<T>(a.cfg, s, draw_idx)) {
    dke = update_velocity(cx, u, gz_of, eps);
  } else {
    T part[2][N] = {};
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      const V gz = gz_of(j, c), ui = u.get(j, c);
      V ue;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        ue[k] = ui[k] - eps * gz[k];
        part[0][k] += ue[k] * ue[k];
        part[1][k] += ui[k] * ui[k];
      }
      u.set(j, c, ue);
    });
    T sums[2];
    cx.g.sum(part, sums);
    dke = T(0.5) * (sums[0] - sums[1]);
  }
  half_step(cx, im, z, u, z, T(0.5) * eps);
  u.store(cx.g, cx.n);
  z.store(cx.g, cx.n);
  if (cx.g.leader()) a.run_flts[size_t(cx.chain) * N_MR + MR_DKE] = dke;
}

// The step's normals at the thread's chunks: held in registers (KC > 0).
// Else (KC = 0) drawn at each access, or, where the caller passes a row
// (the step ends a divergent draw, whose end reads them twice more), drawn
// once into that row and read back from it.
template <typename T, int N, int KC>
struct HeldNormals {
  static constexpr int S = KC > 0 ? KC : 1;
  const StepNormals<T>& xi;
  T* kept;
  Vec<T, N> r[S];

  template <typename G>
  __device__ __forceinline__ HeldNormals(const StepNormals<T>& xi_, const G& g, int n_chunks,
                                         T* keep)
      : xi(xi_), kept(keep) {
    if constexpr (KC > 0) {
      each_chunk<KC>(g, n_chunks, [&](int j, int c) { r[j] = xi.template at<N>(c); });
    } else if (kept) {
      each_chunk<KC>(g, n_chunks, [&](int j, int c) { st<N>(kept, c, xi.template at<N>(c)); });
    }
  }
  __device__ __forceinline__ Vec<T, N> get(int j, int c) const {
    if constexpr (KC > 0) {
      return r[j];
    } else {
      return kept ? ld<N>(kept, c) : xi.template at<N>(c);
    }
  }
};

// A draw diverges where its summed energy error is not finite or passes
// the threshold of its trajectory kind.
template <typename T>
__device__ __forceinline__ bool draw_diverges(const McConfig& cfg, bool micro, T de_total) {
  const T thr = T(micro ? cfg.max_energy_error : cfg.euclid_max_energy_error);
  return !isfinite(de_total) || fabs(de_total) > thr;
}

// The draw's end (mclmc.py:PlainMclmcSteps._end_draw) for a chain at its
// last step (the scratch's z its end point, u its refreshed velocity),
// then the next draw's start into the scratch's u and z.  Each held row is
// read where it is first needed and written as soon as it is final, which
// keeps the held form's registers within its cap.
template <typename T, bool LR, int N, int KC, typename G>
__device__ __forceinline__ void end_draw(const ChainCtx<T, LR, N, KC, G>& cx, const Sched& s,
                                         bool micro, const HeldNormals<T, N, KC>& xi,
                                         T logp2, Row<T, N, KC>& u, Scalars<T>& sc) {
  using V = Vec<T, N>;
  const McArgs<T>& a = cx.a;
  const McConfig& cfg = a.cfg;
  const int dim = cx.dim;
  const int S = cfg.steps_per_draw;
  const int L = cfg.mk.chunk_len;
  T* af = a.adapt_flts + size_t(cx.chain) * N_ADAPT_FLT;
  const int draw_idx = sc.draw_idx;
  // a next draw starts in this chunk; else the scratch keeps the refreshed
  // velocity and the step's end point
  const bool next = draw_idx + 1 - s.chunk_start < s.limit;
  if (!next) u.store(cx.g, cx.n);

  const T de_total = sc.de_sum;
  const T var_e = sc.de2_sum / T(S);
  const bool diverging = draw_diverges(cfg, micro, de_total);
  // the rejection: a divergent draw keeps the state's position, gradient
  // and logp, with a fresh velocity (the last step's normals, normalized
  // where isokinetic); the committed rows into the state
  Row<T, N, KC> x(cx.v + MV_POSITION * dim), gr(cx.v + MV_GRADIENT * dim);
  Row<T, N, KC> u_state(cx.v + MV_VELOCITY * dim);
  T fresh_norm = T(1);
  if (diverging) {
    x.load(cx.g, cx.n);
    gr.load(cx.g, cx.n);
    if (micro) {
      T part[1][N] = {};
      each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
        const V e = xi.get(j, c);
#pragma unroll
        for (int k = 0; k < N; ++k) part[0][k] += e[k] * e[k];
      });
      fresh_norm = sqrt(cx.total(part));
    }
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      V e = xi.get(j, c);
      if (micro) {
#pragma unroll
        for (int k = 0; k < N; ++k) e[k] = e[k] / fresh_norm;
      }
      u_state.set(j, c, e);
    });
  } else {
    const T* z = cx.row(a.z);
    const T* g2 = cx.row(const_cast<T*>(a.grad));
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      x.set(j, c, ld<N>(z, c));
      gr.set(j, c, ld<N>(g2, c));
      u_state.set(j, c, u.get(j, c));
    });
  }
  const T logp = diverging ? sc.logp : logp2;

  const bool tuning = draw_idx < s.num_tune;
  const T log_eps = sc.log_eps;
  T new_log_eps = log_eps;
  if (cfg.dynamic_step_size) {
    const T eevpd = jmax(var_e / T(dim), T(1e-20));
    T adj = T(0.2) * (T(cfg.log_target_eevpd) - log(eevpd));
    adj = jmin(jmax(adj, T(-0.3)), micro ? T(0.3) : T(0.1));
    if (diverging) adj = T(-0.5);
    new_log_eps = tuning ? log_eps + adj : log_eps;
    new_log_eps = jmax(new_log_eps, T(cfg.log_min_step));
  }

  // the metric (mclmc.py:mclmc_adapt_update): Welford adds where tuning and
  // not diverging, the estimate from the current window before the switch,
  // kept where tuning and not frozen, then the switch; none of it under a
  // fixed metric (flow adaptation), whose windows do not run
  Row<T, N, KC> im(cx.av + A_INV_MASS * dim);
  bool im_known = false;  // held: im's registers hold the row
  if (tuning && !cfg.mk.fixed_metric) {
    const bool ok = !diverging;
    const AdaptWindow<T> w(cfg.mk, s, af, draw_idx, ok);
    AdaptWindow<T> pre = w;  // the estimate reads the window before the switch
    pre.dcur = w.dc;
    pre.gcur = w.gc;
    bool est_fin = true;
    // the estimate, held (KC > 0) or in the work row
    Row<T, N, KC> est(cx.row(a.work));
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      const V xx = x.get(j, c), gg = gr.get(j, c);
      V e;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        T* row = cx.av + c * N + k;
        T dm = row[A_DRAWS_CUR_MEAN * dim], dv = row[A_DRAWS_CUR_M2 * dim];
        T gm = row[A_GRADS_CUR_MEAN * dim], gv = row[A_GRADS_CUR_M2 * dim];
        T dbm = row[A_DRAWS_BG_MEAN * dim], dbv = row[A_DRAWS_BG_M2 * dim];
        T gbm = row[A_GRADS_BG_MEAN * dim], gbv = row[A_GRADS_BG_M2 * dim];
        if (ok) {
          welford_add(dm, dv, w.dc, xx[k]);
          welford_add(gm, gv, w.gc, gg[k]);
          welford_add(dbm, dbv, w.dbc, xx[k]);
          welford_add(gbm, gbv, w.gbc, gg[k]);
        }
        e[k] = mass_estimate(cfg.mk, pre, dv, gv);
        est_fin = est_fin && isfinite(e[k]);
        if (w.sw) {
          dm = dbm; dv = dbv; gm = gbm; gv = gbv;
          dbm = T(0); dbv = T(0); gbm = T(0); gbv = T(0);
        }
        row[A_DRAWS_CUR_MEAN * dim] = dm;
        row[A_DRAWS_CUR_M2 * dim] = dv;
        row[A_GRADS_CUR_MEAN * dim] = gm;
        row[A_GRADS_CUR_M2 * dim] = gv;
        row[A_DRAWS_BG_MEAN * dim] = dbm;
        row[A_DRAWS_BG_M2 * dim] = dbv;
        row[A_GRADS_BG_MEAN * dim] = gbm;
        row[A_GRADS_BG_M2 * dim] = gbv;
      }
      est.set(j, c, e);
    });
    const bool use_est = cx.g.all(est_fin) && w.dc > T(2) && !w.frozen;
    if (use_est) {
      each_chunk<KC>(cx.g, cx.n, [&](int j, int c) { im.set(j, c, est.get(j, c)); });
      im.store(cx.g, cx.n);
      im_known = true;
    }
    if (cx.g.leader()) {
      af[AF_DRAWS_CUR_COUNT] = w.dcur;
      af[AF_GRADS_CUR_COUNT] = w.gcur;
      af[AF_DRAWS_BG_COUNT] = w.sw ? T(0) : w.dbc;
      af[AF_GRADS_BG_COUNT] = w.sw ? T(0) : w.gbc;
    }
  }

  // the commit at the draw's row of the chunk
  const int idx = draw_idx - s.chunk_start;
  const int idx_c = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
  const size_t out_row = size_t(cx.chain) * L + idx_c;
  T* pos_row = a.pos_out + out_row * dim;
  T* grad_row = a.grad_out ? a.grad_out + out_row * dim : nullptr;
  T* minv_row = a.minv_out ? a.minv_out + out_row * dim : nullptr;
  if (!im_known && (next || minv_row)) im.load(cx.g, cx.n);
  each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
    st<N>(pos_row, c, x.get(j, c));
    if (grad_row) st<N>(grad_row, c, gr.get(j, c));
    if (minv_row) st<N>(minv_row, c, im.get(j, c));
  });
  gr.store(cx.g, cx.n);
  x.store(cx.g, cx.n);
  u_state.store(cx.g, cx.n);
  if (cx.g.leader()) {
    T* row = a.scal_out + out_row * N_MS;
    row[MS_LOGP] = logp;
    row[MS_ENERGY_ERROR] = de_total;
    row[MS_DIVERGING] = T(diverging);
    row[MS_STEP_SIZE] = exp(log_eps);
  }
  sc.logp = logp;
  sc.log_eps = new_log_eps;
  sc.draw_idx = draw_idx + 1;
  sc.total_steps += S;
  if (diverging) sc.divergences += 1;
  // the next draw of the chunk
  if (next) {
    Row<T, N, KC> z(cx.row(a.z));
    start_draw(cx, s, x, u_state, im, u, z, sc);
    u.store(cx.g, cx.n);
    z.store(cx.g, cx.n);
  }
}

// The settle applies the metric unless it ends the chunk's last draw (no
// next draw starts): uniform over a launch, since MCLMC is lockstep.
template <typename T>
__device__ __forceinline__ bool settle_applies_metric(const McArgs<T>& a, const Sched& s,
                                                      int chain) {
  const int next_step = a.step[chain] + 1;
  const int draw_idx = a.ints[size_t(chain) * N_MI + MI_DRAW_IDX];
  return next_step < a.cfg.steps_per_draw || draw_idx + 1 - s.chunk_start < s.limit;
}

template <typename T, bool LR, int N, int KC, typename G>
__device__ __forceinline__ void settle_chain(const ChainCtx<T, LR, N, KC, G>& cx,
                                             const Sched& s) {
  using V = Vec<T, N>;
  const McArgs<T>& a = cx.a;
  const McConfig& cfg = a.cfg;
  const int dim = cx.dim;
  const int S = cfg.steps_per_draw;
  Scalars<T> sc;
  sc.load(a, cx.chain);
  const int j_step = a.step[cx.chain];
  const T logp2 = a.logp[cx.chain];
  const T eps = exp(sc.log_eps);
  const bool micro = is_micro<T>(cfg, s, sc.draw_idx);
  Row<T, N, KC> u(cx.row(a.velocity));
  u.load(cx.g, cx.n);

  // the energy error of the step into the draw's sums
  const T de = sc.dke + (sc.run_logp - logp2);
  sc.de_sum = sc.de_sum + de;
  sc.de2_sum = sc.de2_sum + de * de;
  sc.run_logp = logp2;

  // the partial refresh from the step's normals (kept in the work row
  // where they are not held and the step ends a divergent draw)
  const StepNormals<T> normals(a.keys, cx.chain, sc.draw_idx, j_step);
  T* keep = nullptr;
  if constexpr (KC == 0) {
    if (j_step + 1 >= S && draw_diverges(cfg, micro, sc.de_sum)) keep = cx.row(a.work);
  }
  const HeldNormals<T, N, KC> xi(normals, cx.g, cx.n, keep);
  const T Ld = T(cfg.decoherence_length);
  if (micro) {
    const T nu = sqrt(expm1(T(2) * eps / Ld));
    T part[1][N] = {};
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      const V e = xi.get(j, c), ui = u.get(j, c);
      V un;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        un[k] = ui[k] + nu * e[k];
        part[0][k] += un[k] * un[k];
      }
      u.set(j, c, un);
    });
    const T norm = sqrt(cx.total(part));
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      V un = u.get(j, c);
#pragma unroll
      for (int k = 0; k < N; ++k) un[k] = un[k] / norm;
      u.set(j, c, un);
    });
  } else {
    const T c_ou = exp(-eps / Ld);
    const T sq = sqrt(jmax(T(1) - c_ou * c_ou, T(0)));
    each_chunk<KC>(cx.g, cx.n, [&](int j, int c) {
      const V e = xi.get(j, c), ui = u.get(j, c);
      V un;
#pragma unroll
      for (int k = 0; k < N; ++k) un[k] = c_ou * ui[k] + sq * e[k];
      u.set(j, c, un);
    });
  }
  int step = j_step + 1;
  if (step >= S) {
    step = 0;
    end_draw(cx, s, micro, xi, logp2, u, sc);
  } else {
    Row<T, N, KC> im(cx.av + A_INV_MASS * dim), z(cx.row(a.z));
    im.load(cx.g, cx.n);
    z.load(cx.g, cx.n);
    half_step(cx, im, z, u, z, T(0.5) * eps);
    u.store(cx.g, cx.n);
    z.store(cx.g, cx.n);
  }
  if (cx.g.leader()) {
    sc.store(a, cx.chain);
    a.step[cx.chain] = step;
  }
}

template <int Piece, typename T, bool LR, int N, int KC, typename G>
__device__ __forceinline__ void run_piece(const McArgs<T>& a, const G& g, LowRank<T>& m,
                                          int chain, const Sched& s) {
  const ChainCtx<T, LR, N, KC, G> cx(a, g, m, chain);
  if constexpr (Piece == P_BEGIN) {
    begin_chain(cx, s);
  } else if constexpr (Piece == P_KICK) {
    kick_chain(cx, s);
  } else {
    settle_chain(cx, s);
  }
}

// Whether a piece of chain `chain` applies the low-rank metric (reads its
// basis).
template <int Piece, typename T>
__device__ __forceinline__ bool piece_applies_metric(const McArgs<T>& a, const Sched& s,
                                                     int chain) {
  return Piece != P_SETTLE || settle_applies_metric(a, s, chain);
}

// Resident 128-thread blocks an SM must hold for the diagonal forms, which
// caps the registers: three in float32 (170 registers) and two in float64
// (255), the most under which the held settle, holding a draw's end on
// registers, does not spill (at four, 128 registers, it spilled in both
// dtypes; with no cap at all, the compiler kept a kick at 32 registers and
// spilled around the division's slow-path calls); the low-rank block fills
// an SM's shared memory alone.
template <typename T, bool LR>
constexpr int mc_min_blocks() {
  return LR ? 1 : (sizeof(T) == 4 ? 3 : 2);
}

template <bool LR, int W>
struct McGroup {
  using type = LaneGroup<W>;
};
template <int W>
struct McGroup<true, W> {
  using type = BlockGroup<kLrWarps>;
};

// One piece, a kernel each.  The diagonal forms run one chain per group of
// W lanes; the low-rank one runs persistent blocks, block b the chains b,
// b + gridDim.x, ... in turn, each chain's basis set out for shared memory
// before anything else of it is read and the next chain's sent on its way
// once the chain's last pass is done.
template <int Piece, typename T, bool LR, int W, int N, int KC>
__global__ void __launch_bounds__(McGroup<LR, W>::type::kBlockThreads, mc_min_blocks<T, LR>())
    mclmc_piece(McArgs<T> a) {
  using G = typename McGroup<LR, W>::type;
  const Sched s = a.sched();
  if constexpr (LR) {
    const G g(mc_smem + mc_layout<T>(a.cfg.mk).red);
    LowRank<T> m = a.metric(g);
    const int C = a.cfg.mk.n_chains;
    for (int chain = blockIdx.x; chain < C; chain += gridDim.x) {
      const bool applies = piece_applies_metric<Piece>(a, s, chain);
      if (applies) {
        const int cand = chain + int(gridDim.x);
        const int next = cand < C && piece_applies_metric<Piece>(a, s, cand) ? cand : -1;
        m.begin_chain(chain, next);
      }
      run_piece<Piece, T, true, 1, 0>(a, g, m, chain, s);
      if (applies) m.prefetch();
    }
  } else {
    const G g;
    const int chain = G::chain();
    if (chain >= a.cfg.mk.n_chains) return;  // the whole group
    LowRank<T> m;
    run_piece<Piece, T, false, N, KC>(a, g, m, chain, s);
  }
}

// The diagonal forms (lanes a chain, coordinates a chunk, chunks held), in
// the order of sampler/step_kernel.py:diag_forms: held and strided.
template <typename T>
struct McForms {
  static constexpr int kCount = 2;
  static constexpr int lanes[kCount] = {kLanes / kMcVec<T>, kLanes};
  static constexpr int vec[kCount] = {kMcVec<T>, 1};
  static constexpr int held[kCount] = {kMcHeld, 0};
};

// The diagonal plan of `cfg` against the forms and what a launch needs: a
// known form, whole chunks (held: at most kMcHeld a thread), the grid, and
// every row a vector access touches on its boundary.  Returns the form's
// index, or -1.
template <typename T>
int diag_form(const MkConfig& cfg, const McPtrs& p) {
  using F = McForms<T>;
  int form = -1;
  for (int k = 0; k < F::kCount; ++k) {
    if (cfg.step_lanes == F::lanes[k] && cfg.step_vec == F::vec[k] &&
        cfg.step_held == F::held[k]) {
      form = k;
    }
  }
  if (form < 0 || cfg.dim % cfg.step_vec != 0) return -1;
  const int chunks = cfg.dim / cfg.step_vec;
  if (cfg.step_held > 0 && chunks > cfg.step_held * cfg.step_lanes) return -1;
  const int per_block = kLaneBlockThreads / cfg.step_lanes;
  if (cfg.step_grid != (cfg.n_chains + per_block - 1) / per_block) return -1;
  const uintptr_t align = uintptr_t(cfg.step_vec) * sizeof(T);
  const void* rows[] = {p.vecs, p.adapt_vecs, p.z, p.velocity, p.grad, p.pos_out,
                        p.grad_out, p.minv_out, p.work};
  for (const void* r : rows) {
    if (reinterpret_cast<uintptr_t>(r) % align != 0) return -1;
  }
  return form;
}

// The low-rank plan of `cfg` against what a launch and a bulk copy need
// (16-byte aligned source and size).
template <typename T>
int check_lr_plan(const MkConfig& cfg, const void* basis) {
  const bool aligned = reinterpret_cast<uintptr_t>(basis) % 16 == 0 &&
                       (size_t(cfg.dim) * cfg.lr_rank * sizeof(T)) % 16 == 0;
  if (cfg.lr_grid < 1 || cfg.lr_grid > cfg.n_chains || (cfg.lr_tma && !aligned)) {
    return int(cudaErrorInvalidValue);
  }
  return 0;
}

// Raise a low-rank piece's dynamic shared-memory cap to `bytes` before the
// first launch that needs them (once per piece, dtype and device).
template <int Piece, typename T>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static size_t cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= cap[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mclmc_piece<Piece, T, true, 0, 1, 0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) cap[dev] = bytes;
  return err;
}

template <int Piece, typename T>
cudaError_t launch_form(const McArgs<T>& a, int form, cudaStream_t s) {
  const MkConfig& mk = a.cfg.mk;
  if (mk.lr_rank > 0) {
    const size_t smem = mc_layout<T>(mk).bytes;
    const cudaError_t err = allow_smem<Piece, T>(smem);
    if (err != cudaSuccess) return err;
    mclmc_piece<Piece, T, true, 0, 1, 0><<<mk.lr_grid, kMcLrThreads, smem, s>>>(a);
  } else if (form == 0) {
    mclmc_piece<Piece, T, false, kLanes / kMcVec<T>, kMcVec<T>, kMcHeld>
        <<<mk.step_grid, kLaneBlockThreads, 0, s>>>(a);
  } else {
    mclmc_piece<Piece, T, false, kLanes, 1, 0><<<mk.step_grid, kLaneBlockThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(int piece, const McConfig* cfg, const McPtrs* p, void* stream) {
  const MkConfig& mk = cfg->mk;
  const int R = mk.lr_rank;
  if (mk.n_chains < 1 || mk.dim < 2 || cfg->steps_per_draw < 1 || R < 0 || R > kMaxRank ||
      piece < P_BEGIN || piece > P_SETTLE || (piece != P_BEGIN && !p->grad) ||
      (piece == P_SETTLE && (!p->logp || !p->keys)) ||
      (R > 0 && (!p->lr_basis || !p->lr_log_eigs))) {
    return int(cudaErrorInvalidValue);
  }
  int form = -1;
  if (R > 0) {
    const int code = check_lr_plan<T>(mk, p->lr_basis);
    if (code != 0) return code;
  } else {
    form = diag_form<T>(mk, *p);
    if (form < 0) return int(cudaErrorInvalidValue);
  }
  // the strided and low-rank forms keep rows in the work row; the held
  // form holds them in registers
  if (form != 0 && !p->work) return int(cudaErrorInvalidValue);
  const McArgs<T> a(*cfg, *p);
  const auto s = static_cast<cudaStream_t>(stream);
  if (piece == P_BEGIN) return int(launch_form<P_BEGIN, T>(a, form, s));
  if (piece == P_KICK) return int(launch_form<P_KICK, T>(a, form, s));
  return int(launch_form<P_SETTLE, T>(a, form, s));
}

// the most registers and local (spill) bytes a thread of a form's three
// pieces takes
template <typename T, bool LR, int W, int N, int KC>
cudaError_t form_geometry(int32_t* regs, int32_t* local) {
  cudaFuncAttributes f[3];
  cudaError_t err = cudaFuncGetAttributes(&f[0], mclmc_piece<P_BEGIN, T, LR, W, N, KC>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&f[1], mclmc_piece<P_KICK, T, LR, W, N, KC>);
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&f[2], mclmc_piece<P_SETTLE, T, LR, W, N, KC>);
  }
  *regs = *local = 0;
  for (int k = 0; k < 3 && err == cudaSuccess; ++k) {
    *regs = f[k].numRegs > *regs ? f[k].numRegs : *regs;
    *local = int32_t(f[k].localSizeBytes) > *local ? int32_t(f[k].localSizeBytes) : *local;
  }
  return err;
}

// What was compiled (mclmc_kernel.py:GEOMETRY_FIELDS): the registers and
// local (spill) bytes a thread of the held, the strided and the low-rank
// form (the most over the three pieces), the threads of a diagonal block
// and of a low-rank block, and for the low-rank plan in `cfg` (lr_rank >
// 0; zeros otherwise) the dynamic shared-memory bytes of a block and the
// blocks an SM holds (the settle's; the three pieces lay out the same).
template <typename T>
int geometry(const MkConfig* cfg, int32_t* out) {
  cudaError_t err =
      form_geometry<T, false, kLanes / kMcVec<T>, kMcVec<T>, kMcHeld>(&out[0], &out[1]);
  if (err == cudaSuccess) err = form_geometry<T, false, kLanes, 1, 0>(&out[2], &out[3]);
  if (err == cudaSuccess) err = form_geometry<T, true, 0, 1, 0>(&out[4], &out[5]);
  out[6] = kLaneBlockThreads;
  out[7] = kMcLrThreads;
  out[8] = out[9] = 0;
  if (err != cudaSuccess) return int(err);
  if (cfg == nullptr || cfg->lr_rank < 1) return 0;
  // the plan as a launch checks it, without a basis to align
  MkConfig c = *cfg;
  c.lr_tma = 0;
  const int code = check_lr_plan<T>(c, nullptr);
  if (code != 0) return code;
  const size_t smem = mc_layout<T>(c).bytes;
  int blocks = 0;
  err = allow_smem<P_SETTLE, T>(smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, mclmc_piece<P_SETTLE, T, true, 0, 1, 0>, kMcLrThreads, smem);
  }
  if (err != cudaSuccess) return int(err);
  out[8] = int32_t(smem);
  out[9] = blocks;
  return 0;
}

}  // namespace nutpie

extern "C" {

// Launch one piece (0 begin, 1 kick, 2 settle) for every chain on
// `stream`; returns the CUDA error code of the launch (0 = queued).
int nutpie_mclmc_launch_f32(int piece, const nutpie::McConfig* cfg, const nutpie::McPtrs* p,
                            void* stream) {
  return nutpie::launch<float>(piece, cfg, p, stream);
}

int nutpie_mclmc_launch_f64(int piece, const nutpie::McConfig* cfg, const nutpie::McPtrs* p,
                            void* stream) {
  return nutpie::launch<double>(piece, cfg, p, stream);
}

int nutpie_mclmc_geometry_f32(const nutpie::MkConfig* cfg, int32_t* out) {
  return nutpie::geometry<float>(cfg, out);
}

int nutpie_mclmc_geometry_f64(const nutpie::MkConfig* cfg, int32_t* out) {
  return nutpie::geometry<double>(cfg, out);
}

const char* nutpie_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
