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
// A kernel a piece.  Lanes: a warp per chain (LaneGroup<32>), each lane
// striding over the coordinates, every per-chain sum a warp butterfly in a
// fixed order (group.cuh), four chains a 128-thread block; a chain's
// scalars in registers (Scalars).  Rows stay in device memory;
// the midpoint's pulled-back gradient and the adaptation's estimates pass
// through a work row of the chain's own.
//
// The low-rank metric (lr_rank R > 0): A = D^{1/2}(I + U(sqrt(L) - 1)U^T),
// so A u and A^T g are s (u + U c) and w + U c with c_r = (sqrt(l_r) - 1)
// (U^T v)_r.  Each application reads the chain's [dim, R] basis from
// global memory in two passes: lane r sums v . U[:, r] over the rows in
// order (the lanes read a row's R values together), then each lane
// expands (U c)_i for its coordinates with c_r shuffled from lane r.
//
// What bounds it: bytes.  A step reads and writes a few rows a chain (the
// position, the velocity, the gradient, the work row, the normals; the
// basis twice per application under the low-rank metric) with a handful
// of operations per coordinate.  Built without FMA contraction
// (ops/build.py), so it rounds each product and sum as its plain version.
#include <cuda_runtime.h>

#include "adapt.cuh"
#include "group.cuh"
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

// Static configuration (mclmc_kernel.py:McConfig).  `mk` carries the
// adaptation's fields that adapt.cuh reads (the variance clips, the
// estimate's kind, the switch cadences).
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
  int32_t lr_rank;
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
  const void* normals;  // [C, L, steps_per_draw, dim] the refresh normals
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
  void* work;           // [C, dim] a row of each chain's own
};

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
  const T* normals;
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
        normals(static_cast<const T*>(p.normals)), z(static_cast<T*>(p.z)),
        velocity(static_cast<T*>(p.velocity)), run_flts(static_cast<T*>(p.run_flts)),
        step(p.step), logp(static_cast<const T*>(p.logp)),
        grad(static_cast<const T*>(p.grad)), pos_out(static_cast<T*>(p.pos_out)),
        scal_out(static_cast<T*>(p.scal_out)), grad_out(static_cast<T*>(p.grad_out)),
        minv_out(static_cast<T*>(p.minv_out)), work(static_cast<T*>(p.work)) {}
};

using Warp = LaneGroup<kLanes>;

// A chain's scalars in registers: its state's (flts, ints) and the
// chunk's running ones (run_flts), loaded once a launch and stored by the
// warp's leader.
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

// one value summed over the chain's warp (lane l's coordinates in order,
// then the butterfly)
template <typename T>
__device__ __forceinline__ T warp_total(const Warp& g, T part) {
  T acc[1][1] = {{part}};
  T out[1];
  g.sum(acc, out);
  return out[0];
}

// The chain's low-rank metric: its basis and lane r's factor sqrt(l_r) - 1.
template <typename T, bool LR>
struct Metric {
  const T* U = nullptr;
  int R = 0;
  T factor = T(0);

  __device__ __forceinline__ Metric(const McArgs<T>& a, int chain, int lane) {
    if constexpr (LR) {
      R = a.cfg.lr_rank;
      const int dim = a.cfg.mk.dim;
      U = a.lr_basis + size_t(chain) * dim * R;
      factor = lane < R ? exp(T(0.5) * a.lr_log_eigs[size_t(chain) * R + lane]) - T(1) : T(0);
    }
  }

  // c_r = factor_r (v^T U)_r in lane r, v a row in device memory that the
  // warp has written (every lane sums its rank over the rows in order)
  __device__ __forceinline__ T coefficient(const Warp& g, const T* v, int dim) const {
    __syncwarp();
    const int lane = g.lane();
    T acc = T(0);
    if (lane < R) {
      for (int i = 0; i < dim; ++i) acc += v[i] * U[size_t(i) * R + lane];
    }
    return factor * acc;
  }

  // (U c)_i from lane r's coefficient c (called by every lane)
  __device__ __forceinline__ T expand(T c, int i, int dim) const {
    T out = T(0);
    const T* row = U + size_t(i < dim ? i : 0) * R;
    for (int r = 0; r < R; ++r) {
      const T cr = __shfl_sync(kFullMask, c, r);
      out += row[r] * cr;
    }
    return out;
  }
};

// The end of a chain's coordinate loop: dim, or under the low-rank metric
// dim rounded up to the warp, so that every lane runs the same trip count
// (the expansion shuffles across the warp), with i >= dim for the tail.
template <bool LR>
__device__ __forceinline__ int coord_end(int dim) {
  return LR ? (dim + kLanes - 1) / kLanes * kLanes : dim;
}

template <typename T>
__device__ __forceinline__ bool is_micro(const McConfig& cfg, const Sched& s, int draw_idx) {
  if (cfg.trajectory == T_EUCLID) return false;
  if (cfg.trajectory == T_EUCLID_THEN_MICRO) return draw_idx >= s.num_tune / 2;
  return true;
}

// z = x + (eps / 2) A u at the lane's coordinates (u a row the warp wrote).
template <typename T, bool LR>
__device__ __forceinline__ void half_step(const Warp& g, Metric<T, LR> m, int dim,
                                          const T* im, const T* x, const T* u, T* z, T eps) {
  const T half = T(0.5) * eps;
  T c = T(0);
  if constexpr (LR) c = m.coefficient(g, u, dim);
  for (int i = g.lane(); i < coord_end<LR>(dim); i += kLanes) {
    T uc = T(0);
    if constexpr (LR) uc = m.expand(c, i, dim);
    if (i < dim) z[i] = x[i] + half * (sqrt(im[i]) * (u[i] + uc));
  }
}

// A draw's start: the entry velocity (normalized where isokinetic) into
// the running velocity, the running scalars reset, z the first half-step.
template <typename T, bool LR>
__device__ __forceinline__ void start_draw(const McArgs<T>& a, const Warp& g,
                                           Metric<T, LR> m, const Sched& s, int chain,
                                           int draw_idx, T logp, T log_eps, Scalars<T>& sc) {
  const int dim = a.cfg.mk.dim;
  const T* x = a.vecs + size_t(chain) * N_MV * dim;
  const T* u_state = x + MV_VELOCITY * dim;
  const T* im = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim + A_INV_MASS * dim;
  T* u = a.velocity + size_t(chain) * dim;
  T* z = a.z + size_t(chain) * dim;
  const bool micro = is_micro<T>(a.cfg, s, draw_idx);
  T norm = T(1);
  if (micro) {
    T part = T(0);
    for (int i = g.lane(); i < dim; i += kLanes) part += u_state[i] * u_state[i];
    norm = sqrt(jmax(warp_total(g, part), T(1e-30)));
  }
  for (int i = g.lane(); i < dim; i += kLanes) u[i] = micro ? u_state[i] / norm : u_state[i];
  sc.run_logp = logp;
  sc.dke = T(0);
  sc.de_sum = T(0);
  sc.de2_sum = T(0);
  half_step<T, LR>(g, m, dim, im, x + MV_POSITION * dim, u, z, exp(log_eps));
}

// The isokinetic velocity update of the row u under the pulled-back
// gradient gz for time `step` (isokinetic.py:update_velocity): u in place,
// returns the kinetic-energy change.
template <typename T>
__device__ __forceinline__ T update_velocity(const Warp& g, int dim, T* u, const T* gz,
                                             T step) {
  T part = T(0);
  for (int i = g.lane(); i < dim; i += kLanes) part += gz[i] * gz[i];
  const T g_norm = jmax(sqrt(warp_total(g, part)), T(1e-30));
  part = T(0);
  for (int i = g.lane(); i < dim; i += kLanes) part += u[i] * (-gz[i] / g_norm);
  const T ue = warp_total(g, part);
  const T delta = step * g_norm / T(dim - 1);
  const T ch = cosh(delta);
  const T sh = sinh(delta);
  const T denom = ch + ue * sh;
  const T k = sh + (ch - T(1)) * ue;
  part = T(0);
  for (int i = g.lane(); i < dim; i += kLanes) {
    const T e = -gz[i] / g_norm;
    const T un = (u[i] + e * k) / denom;
    u[i] = un;
    part += un * un;
  }
  const T norm = sqrt(warp_total(g, part));
  for (int i = g.lane(); i < dim; i += kLanes) u[i] = u[i] / norm;
  return T(dim - 1) * log(denom);
}

template <typename T, bool LR>
__device__ __forceinline__ void begin_chain(const McArgs<T>& a, const Warp& g, int chain,
                                            const Sched& s) {
  const Metric<T, LR> m(a, chain, g.lane());
  Scalars<T> sc;
  sc.load(a, chain);
  start_draw<T, LR>(a, g, m, s, chain, sc.draw_idx, sc.logp, sc.log_eps, sc);
  __syncwarp();
  if (g.leader()) {
    sc.store(a, chain);
    a.step[chain] = 0;
  }
}

template <typename T, bool LR>
__device__ __forceinline__ void kick_chain(const McArgs<T>& a, const Warp& g, int chain,
                                           const Sched& s) {
  const int dim = a.cfg.mk.dim;
  const Metric<T, LR> m(a, chain, g.lane());
  const int draw_idx = a.ints[size_t(chain) * N_MI + MI_DRAW_IDX];
  const T eps = exp(a.flts[size_t(chain) * N_MF + MF_LOG_EPS]);
  const T* im = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim + A_INV_MASS * dim;
  const T* gr = a.grad + size_t(chain) * dim;
  T* gz = a.work + size_t(chain) * dim;
  T* u = a.velocity + size_t(chain) * dim;
  T* z = a.z + size_t(chain) * dim;
  // g_z = -A^T g = -(w + U c), w = s g
  T c = T(0);
  if constexpr (LR) {
    for (int i = g.lane(); i < dim; i += kLanes) gz[i] = sqrt(im[i]) * gr[i];
    c = m.coefficient(g, gz, dim);
    __syncwarp();  // every lane has read w
  }
  for (int i = g.lane(); i < coord_end<LR>(dim); i += kLanes) {
    T uc = T(0);
    if constexpr (LR) uc = m.expand(c, i, dim);
    if (i < dim) {
      const T w = sqrt(im[i]) * gr[i];
      gz[i] = -(w + uc);
    }
  }
  __syncwarp();
  T dke;
  if (is_micro<T>(a.cfg, s, draw_idx)) {
    dke = update_velocity<T>(g, dim, u, gz, eps);
  } else {
    T part[2][1] = {{T(0)}, {T(0)}};
    for (int i = g.lane(); i < dim; i += kLanes) {
      const T ui = u[i];
      const T ue = ui - eps * gz[i];
      part[0][0] += ue * ue;
      part[1][0] += ui * ui;
      u[i] = ue;
    }
    T sums[2];
    g.sum(part, sums);
    dke = T(0.5) * (sums[0] - sums[1]);
  }
  half_step<T, LR>(g, m, dim, im, z, u, z, eps);
  if (g.leader()) a.run_flts[size_t(chain) * N_MR + MR_DKE] = dke;
}

// The draw's end (mclmc.py:PlainMclmcSteps._end_draw) for a chain at its
// last step, then the next draw's start.
template <typename T, bool LR>
__device__ __forceinline__ void end_draw(const McArgs<T>& a, const Warp& g,
                                         Metric<T, LR> m, int chain, const Sched& s,
                                         bool micro, const T* xi, T logp2, Scalars<T>& sc) {
  const McConfig& cfg = a.cfg;
  const int dim = cfg.mk.dim;
  const int S = cfg.steps_per_draw;
  const int L = cfg.mk.chunk_len;
  T* v = a.vecs + size_t(chain) * N_MV * dim;
  T* av = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim;
  T* af = a.adapt_flts + size_t(chain) * N_ADAPT_FLT;
  T* u = a.velocity + size_t(chain) * dim;
  T* z = a.z + size_t(chain) * dim;
  T* work = a.work + size_t(chain) * dim;
  const T* g2 = a.grad + size_t(chain) * dim;

  const T de_total = sc.de_sum;
  const T var_e = sc.de2_sum / T(S);
  const T thr = T(micro ? cfg.max_energy_error : cfg.euclid_max_energy_error);
  const bool diverging = !isfinite(de_total) || fabs(de_total) > thr;
  T fresh_norm = T(1);
  if (micro) {
    T part = T(0);
    for (int i = g.lane(); i < dim; i += kLanes) part += xi[i] * xi[i];
    fresh_norm = sqrt(warp_total(g, part));
  }
  // the rejection: a divergent draw keeps the state's position, gradient
  // and logp, with a fresh velocity; the committed rows into the state
  const T logp = diverging ? sc.logp : logp2;
  for (int i = g.lane(); i < dim; i += kLanes) {
    if (!diverging) {
      v[MV_POSITION * dim + i] = z[i];
      v[MV_GRADIENT * dim + i] = g2[i];
      v[MV_VELOCITY * dim + i] = u[i];
    } else {
      v[MV_VELOCITY * dim + i] = micro ? xi[i] / fresh_norm : xi[i];
    }
  }
  const T* x = v + MV_POSITION * dim;
  const T* gr = v + MV_GRADIENT * dim;

  const int draw_idx = sc.draw_idx;
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
  // kept where tuning and not frozen, then the switch
  __syncwarp();
  if (tuning) {
    const bool ok = !diverging;
    const AdaptWindow<T> w(cfg.mk, s, af, draw_idx, ok);
    AdaptWindow<T> pre = w;  // the estimate reads the window before the switch
    pre.dcur = w.dc;
    pre.gcur = w.gc;
    bool est_fin = true;
    for (int i = g.lane(); i < dim; i += kLanes) {
      T* row = av + i;
      T dm = row[A_DRAWS_CUR_MEAN * dim], dv = row[A_DRAWS_CUR_M2 * dim];
      T gm = row[A_GRADS_CUR_MEAN * dim], gv = row[A_GRADS_CUR_M2 * dim];
      T dbm = row[A_DRAWS_BG_MEAN * dim], dbv = row[A_DRAWS_BG_M2 * dim];
      T gbm = row[A_GRADS_BG_MEAN * dim], gbv = row[A_GRADS_BG_M2 * dim];
      if (ok) {
        welford_add(dm, dv, w.dc, x[i]);
        welford_add(gm, gv, w.gc, gr[i]);
        welford_add(dbm, dbv, w.dbc, x[i]);
        welford_add(gbm, gbv, w.gbc, gr[i]);
      }
      const T est = mass_estimate(cfg.mk, pre, dv, gv);
      est_fin = est_fin && isfinite(est);
      work[i] = est;
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
    const bool use_est = g.all(est_fin) && w.dc > T(2) && !w.frozen;
    if (use_est) {
      for (int i = g.lane(); i < dim; i += kLanes) av[A_INV_MASS * dim + i] = work[i];
    }
    __syncwarp();
    if (g.leader()) {
      af[AF_DRAWS_CUR_COUNT] = w.dcur;
      af[AF_GRADS_CUR_COUNT] = w.gcur;
      af[AF_DRAWS_BG_COUNT] = w.sw ? T(0) : w.dbc;
      af[AF_GRADS_BG_COUNT] = w.sw ? T(0) : w.gbc;
    }
  }

  // the commit at the draw's row of the chunk
  const int idx = draw_idx - s.chunk_start;
  const int idx_c = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
  const size_t out_row = size_t(chain) * L + idx_c;
  T* pos_row = a.pos_out + out_row * dim;
  T* grad_row = a.grad_out ? a.grad_out + out_row * dim : nullptr;
  T* minv_row = a.minv_out ? a.minv_out + out_row * dim : nullptr;
  for (int i = g.lane(); i < dim; i += kLanes) {
    pos_row[i] = x[i];
    if (grad_row) grad_row[i] = gr[i];
    if (minv_row) minv_row[i] = av[A_INV_MASS * dim + i];
  }
  if (g.leader()) {
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
  __syncwarp();
  // the next draw of the chunk
  if (draw_idx + 1 - s.chunk_start < s.limit) {
    start_draw<T, LR>(a, g, m, s, chain, draw_idx + 1, logp, new_log_eps, sc);
  }
}

template <typename T, bool LR>
__device__ __forceinline__ void settle_chain(const McArgs<T>& a, const Warp& g, int chain,
                                             const Sched& s) {
  const McConfig& cfg = a.cfg;
  const int dim = cfg.mk.dim;
  const int S = cfg.steps_per_draw;
  const int L = cfg.mk.chunk_len;
  const Metric<T, LR> m(a, chain, g.lane());
  Scalars<T> sc;
  sc.load(a, chain);
  const int j = a.step[chain];
  const T logp2 = a.logp[chain];
  const T eps = exp(sc.log_eps);
  const bool micro = is_micro<T>(cfg, s, sc.draw_idx);
  const T* im = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim + A_INV_MASS * dim;
  T* u = a.velocity + size_t(chain) * dim;
  T* z = a.z + size_t(chain) * dim;

  // the energy error of the step into the draw's sums
  const T de = sc.dke + (sc.run_logp - logp2);
  sc.de_sum = sc.de_sum + de;
  sc.de2_sum = sc.de2_sum + de * de;
  sc.run_logp = logp2;

  // the partial refresh from the step's normals
  int d = sc.draw_idx - s.chunk_start;
  d = d < 0 ? 0 : (d > L - 1 ? L - 1 : d);
  const T* xi = a.normals + ((size_t(chain) * L + d) * S + j) * dim;
  const T Ld = T(cfg.decoherence_length);
  if (micro) {
    const T nu = sqrt(expm1(T(2) * eps / Ld));
    T part = T(0);
    for (int i = g.lane(); i < dim; i += kLanes) {
      const T un = u[i] + nu * xi[i];
      u[i] = un;
      part += un * un;
    }
    const T norm = sqrt(warp_total(g, part));
    for (int i = g.lane(); i < dim; i += kLanes) u[i] = u[i] / norm;
  } else {
    const T c = exp(-eps / Ld);
    const T sq = sqrt(jmax(T(1) - c * c, T(0)));
    for (int i = g.lane(); i < dim; i += kLanes) u[i] = c * u[i] + sq * xi[i];
  }
  __syncwarp();
  int step = j + 1;
  if (step >= S) {
    step = 0;
    end_draw<T, LR>(a, g, m, chain, s, micro, xi, logp2, sc);
  } else {
    half_step<T, LR>(g, m, dim, im, z, u, z, eps);
  }
  __syncwarp();
  if (g.leader()) {
    sc.store(a, chain);
    a.step[chain] = step;
  }
}

// Resident blocks an SM must hold, which caps the registers at 128 a
// thread: without the cap the compiler kept the low-rank float32 kick at 32
// registers and spilled around its slow-path calls (the division's).
constexpr int kMinBlocks = 4;

// The three pieces, a kernel each (every chain of a launch runs the same
// piece; a warp a chain).
template <typename T, bool LR>
__global__ void __launch_bounds__(kLaneBlockThreads, kMinBlocks) mclmc_begin(McArgs<T> a) {
  const Warp g;
  const int chain = Warp::chain();
  if (chain >= a.cfg.mk.n_chains) return;  // the whole warp
  const Sched s{a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4], a.scal[5]};
  begin_chain<T, LR>(a, g, chain, s);
}

template <typename T, bool LR>
__global__ void __launch_bounds__(kLaneBlockThreads, kMinBlocks) mclmc_kick(McArgs<T> a) {
  const Warp g;
  const int chain = Warp::chain();
  if (chain >= a.cfg.mk.n_chains) return;
  const Sched s{a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4], a.scal[5]};
  kick_chain<T, LR>(a, g, chain, s);
}

template <typename T, bool LR>
__global__ void __launch_bounds__(kLaneBlockThreads, kMinBlocks) mclmc_settle(McArgs<T> a) {
  const Warp g;
  const int chain = Warp::chain();
  if (chain >= a.cfg.mk.n_chains) return;
  const Sched s{a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4], a.scal[5]};
  settle_chain<T, LR>(a, g, chain, s);
}

template <typename T, bool LR>
void launch_piece(const McArgs<T>& a, int piece, int grid, cudaStream_t s) {
  if (piece == P_BEGIN) {
    mclmc_begin<T, LR><<<grid, kLaneBlockThreads, 0, s>>>(a);
  } else if (piece == P_KICK) {
    mclmc_kick<T, LR><<<grid, kLaneBlockThreads, 0, s>>>(a);
  } else {
    mclmc_settle<T, LR><<<grid, kLaneBlockThreads, 0, s>>>(a);
  }
}

template <typename T>
int launch(int piece, const McConfig* cfg, const McPtrs* p, void* stream) {
  const int C = cfg->mk.n_chains;
  const int R = cfg->lr_rank;
  if (C < 1 || cfg->mk.dim < 2 || cfg->steps_per_draw < 1 || R < 0 || R > kLanes ||
      piece < P_BEGIN || piece > P_SETTLE || (piece != P_BEGIN && !p->grad) ||
      (piece == P_SETTLE && !p->logp) || (R > 0 && (!p->lr_basis || !p->lr_log_eigs)) ||
      !p->work) {
    return int(cudaErrorInvalidValue);
  }
  const McArgs<T> a(*cfg, *p);
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = (C + Warp::kChainsPerBlock - 1) / Warp::kChainsPerBlock;
  if (R > 0) {
    launch_piece<T, true>(a, piece, grid, s);
  } else {
    launch_piece<T, false>(a, piece, grid, s);
  }
  return int(cudaGetLastError());
}

// the most registers and local (spill) bytes a thread of a piece takes
template <typename T, bool LR>
cudaError_t pieces_geometry(int32_t* regs, int32_t* local) {
  cudaFuncAttributes f[3];
  cudaError_t err = cudaFuncGetAttributes(&f[0], mclmc_begin<T, LR>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&f[1], mclmc_kick<T, LR>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&f[2], mclmc_settle<T, LR>);
  *regs = *local = 0;
  for (int k = 0; k < 3 && err == cudaSuccess; ++k) {
    *regs = f[k].numRegs > *regs ? f[k].numRegs : *regs;
    *local = int32_t(f[k].localSizeBytes) > *local ? int32_t(f[k].localSizeBytes) : *local;
  }
  return err;
}

// registers and local (spill) bytes a thread of the diagonal and the
// low-rank instantiations (the most over the three pieces), and the
// threads of a block
template <typename T>
int geometry(int32_t* out) {
  cudaError_t err = pieces_geometry<T, false>(&out[0], &out[1]);
  if (err == cudaSuccess) err = pieces_geometry<T, true>(&out[2], &out[3]);
  out[4] = kLaneBlockThreads;
  return int(err);
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

int nutpie_mclmc_geometry_f32(int32_t* out) { return nutpie::geometry<float>(out); }

int nutpie_mclmc_geometry_f64(int32_t* out) { return nutpie::geometry<double>(out); }

const char* nutpie_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
