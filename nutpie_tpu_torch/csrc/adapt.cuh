// Per-draw warmup adaptation inside the chunk kernel: the step size (dual
// averaging, Adam or a fixed step, MkConfig.step_method) and nutpie's
// gradient-based diagonal mass matrix from Welford accumulators, with the
// window switch, the factor-2 rate limit and the matched step-size shift.  Same arithmetic as diag_adapt_update in
// nutpie_tpu_torch/sampler/adapt.py (and nutpie_tpu/sampler/adapt.py).
//
// Run by the chain's warp: the scalars (af) are lane-uniform registers,
// the inverse mass a row of the warp's shared slice, and the eight Welford
// rows stay in global memory (the chain's adapt_vecs rows, in L2), read and
// written once per tuning draw by the lanes that own each coordinate.  The
// step kernel (step_kernel.cu) runs the same arithmetic in a strided form
// over rows that all stay in global memory (diag_adapt_update_strided).
#pragma once

#include "group.cuh"
#include "warp.cuh"

namespace nutpie {

// Dual averaging of the step size (lane-uniform).
template <typename T>
__device__ __forceinline__ void dual_avg_update(const MkConfig& cfg, T* af,
                                                T accept) {
  const T count = af[AF_DA_COUNT] + T(1);
  const T w = T(1) / (count + T(cfg.t0));
  const T hbar = (T(1) - w) * af[AF_HBAR] + w * (T(cfg.target_accept) - accept);
  T log_step = af[AF_MU] - sqrt(count) / T(cfg.gamma) * hbar;
  // trust region with an escape hatch for a step that crashed far below
  // its running average
  const bool crashed = af[AF_LOG_STEP] < af[AF_LOG_STEP_BAR] - T(log(8.0));
  const T cap = crashed ? T(INFINITY) : af[AF_LOG_STEP] + T(log(2.0));
  log_step = jmin(log_step, cap);
  log_step = jmin(log_step, T(log(cfg.max_step_size)));
  const T eta = pow(count, T(-cfg.kappa));
  const T log_step_bar = eta * log_step + (T(1) - eta) * af[AF_LOG_STEP_BAR];
  af[AF_LOG_STEP] = log_step;
  af[AF_LOG_STEP_BAR] = log_step_bar;
  af[AF_HBAR] = hbar;
  af[AF_DA_COUNT] = count;
}

// Adam on the log step size with gradient (target - accept) (lane-uniform;
// adam_update in sampler/adapt.py, each value by the same operations in
// the same order).  Unlike dual averaging, the per-draw increase is capped
// at x2 with no escape hatch, and the average's weight follows the Adam
// count.  The three powers come first and each value is stored as soon as
// it is known: in the float32 forms that keeps the update within the
// registers the rest of the step leaves.
template <typename T>
__device__ __forceinline__ void adam_update(const MkConfig& cfg, T* af, T accept) {
  const T count = af[AF_ADAM_COUNT] + T(1);
  af[AF_ADAM_COUNT] = count;
  const T c1 = T(1) - pow(T(cfg.adam_beta1), count);
  const T c2 = T(1) - pow(T(cfg.adam_beta2), count);
  const T eta = pow(count, T(-cfg.kappa));
  const T g = T(cfg.target_accept) - accept;
  const T m = T(cfg.adam_beta1) * af[AF_ADAM_M] + T(1.0 - cfg.adam_beta1) * g;
  af[AF_ADAM_M] = m;
  const T v = T(cfg.adam_beta2) * af[AF_ADAM_V] + T(1.0 - cfg.adam_beta2) * g * g;
  af[AF_ADAM_V] = v;
  const T old = af[AF_LOG_STEP];
  T log_step = old - T(cfg.adam_lr) * (m / c1) / (sqrt(v / c2) + T(1e-8));
  log_step = jmin(log_step, old + T(log(2.0)));
  log_step = jmin(log_step, T(log(cfg.max_step_size)));
  af[AF_LOG_STEP_BAR] = eta * log_step + (T(1) - eta) * af[AF_LOG_STEP_BAR];
  af[AF_LOG_STEP] = log_step;
  af[AF_DA_COUNT] = af[AF_DA_COUNT] + T(1);
}

// The step-size update of one tuning draw by the configured method: Adam
// in the kernels' instantiations for it (ADAM; its arithmetic beside dual
// averaging's in one function spilled registers of the float32 forms),
// else dual averaging or a fixed step.  A fixed step sets the step and its
// average to it; the matched shift after the metric update still moves the
// step (and mu), as in the plain version.
template <typename T, bool ADAM>
__device__ __forceinline__ void step_size_update(const MkConfig& cfg, T* af, T accept) {
  if constexpr (ADAM) {
    adam_update(cfg, af, accept);
  } else if (cfg.step_method == STEP_FIXED) {
    af[AF_LOG_STEP] = T(cfg.log_fixed_step);
    af[AF_LOG_STEP_BAR] = T(cfg.log_fixed_step);
  } else {
    dual_avg_update(cfg, af, accept);
  }
}

template <typename T>
__device__ __forceinline__ void welford_add(T& mean, T& m2, T count_new, T x) {
  const T delta = x - mean;
  mean = mean + delta / count_new;
  m2 = m2 + delta * (x - mean);
}

// The window schedule and the Welford counts of one tuning draw
// (lane-uniform): counts after the add (`ok`: the draw is finite and not
// divergent) and after the switch.
template <typename T>
struct AdaptWindow {
  bool frozen, sw;
  T dc, gc, dbc, gbc, dcur, gcur;

  __device__ __forceinline__ AdaptWindow(const MkConfig& cfg, const Sched& s,
                                         const T* af, int draw_idx, bool ok) {
    frozen = draw_idx >= s.freeze_start;
    const int freq = draw_idx < s.early_end ? cfg.early_switch_freq
                                            : cfg.switch_freq;
    sw = !frozen && draw_idx > 0 && ((draw_idx + 1) % freq == 0);
    const T add = ok ? T(1) : T(0);
    dc = af[AF_DRAWS_CUR_COUNT] + add;
    gc = af[AF_GRADS_CUR_COUNT] + add;
    dbc = af[AF_DRAWS_BG_COUNT] + add;
    gbc = af[AF_GRADS_BG_COUNT] + add;
    dcur = sw ? dbc : dc;
    gcur = sw ? gbc : gc;
  }
};

// Welford adds of coordinate x/g into the four accumulators of one
// coordinate (`row` = the chain's adapt_vecs + the coordinate, stride
// dim), then the switch; returns the current window's m2 of the draws and
// of the gradients.
template <typename T>
__device__ __forceinline__ void welford_coord(const AdaptWindow<T>& w, bool ok,
                                              T* row, int dim, T x, T g,
                                              T& dv_out, T& gv_out) {
  T dm = row[A_DRAWS_CUR_MEAN * dim], dv = row[A_DRAWS_CUR_M2 * dim];
  T gm = row[A_GRADS_CUR_MEAN * dim], gv = row[A_GRADS_CUR_M2 * dim];
  T dbm = row[A_DRAWS_BG_MEAN * dim], dbv = row[A_DRAWS_BG_M2 * dim];
  T gbm = row[A_GRADS_BG_MEAN * dim], gbv = row[A_GRADS_BG_M2 * dim];
  if (ok) {
    welford_add(dm, dv, w.dc, x);
    welford_add(gm, gv, w.gc, g);
    welford_add(dbm, dbv, w.dbc, x);
    welford_add(gbm, gbv, w.gbc, g);
  }
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
  dv_out = dv;
  gv_out = gv;
}

// The clipped inverse-mass estimate of one coordinate from the current
// window's m2 of the draws (dv) and of the gradients (gv).
template <typename T>
__device__ __forceinline__ T mass_estimate(const MkConfig& cfg,
                                           const AdaptWindow<T>& w, T dv, T gv) {
  const T one = T(1);
  const T min_var = T(cfg.min_variance);
  const T draw_var = dv / jmax(w.dcur - one, one);
  T e;
  if (cfg.use_grad_based_estimate) {
    const T grad_var = gv / jmax(w.gcur - one, one);
    e = sqrt(jmax(draw_var, min_var) / jmax(grad_var, min_var));
  } else {
    // Stan-style shrinkage toward unit scale
    e = (w.dcur / (w.dcur + T(5))) * draw_var + T(1e-3) * (T(5) / (w.dcur + T(5)));
  }
  return jclip(e, min_var, T(cfg.max_variance));
}

// The rate-limited new inverse mass of one coordinate (old value `old`)
// and its contribution to the ratio of the step shift.
template <typename T>
__device__ __forceinline__ T mass_update(const MkConfig& cfg,
                                         const AdaptWindow<T>& w, bool use_est,
                                         T est, T old, T& ratio) {
  T m = use_est ? est : old;
  m = jclip(m, old * T(0.5), old * T(2.0));
  if (w.frozen) m = old;
  ratio = jmax(ratio, m / jmax(old, T(cfg.min_variance)));
  return m;
}

// The step-size scalars after the metric update and the step-size
// method's update (step_size_update, which reads and writes none of the
// metric's values, so its callers place it where their registers allow):
// the matched shift for the largest metric ratio, the restart at a switch
// (under every method) and the Welford counts.
template <typename T>
__device__ __forceinline__ void adapt_scalars(const AdaptWindow<T>& w, T* af, T ratio) {
  const T shift = T(-0.5) * log(jclip(ratio, T(1), T(2)));
  af[AF_LOG_STEP] = af[AF_LOG_STEP] + shift;
  af[AF_MU] = af[AF_MU] + shift;
  if (w.sw) {
    af[AF_HBAR] = T(0);
    af[AF_MU] = T(log(2.0)) + af[AF_LOG_STEP];
    af[AF_DA_COUNT] = T(0);
  }
  af[AF_DRAWS_CUR_COUNT] = w.dcur;
  af[AF_GRADS_CUR_COUNT] = w.gcur;
  af[AF_DRAWS_BG_COUNT] = w.sw ? T(0) : w.dbc;
  af[AF_GRADS_BG_COUNT] = w.sw ? T(0) : w.gbc;
}

// One tuning draw's update.  The draw is the rows (x, gr) (prop_z/prop_g);
// `diverging` and `accept` are lane-uniform.  `av` is the chain's
// [N_ADAPT_VEC, dim] rows in global memory; `im` the inverse mass row in
// shared memory, kept in step with its A_INV_MASS row.  Each lane touches
// the coordinates it owns.
template <typename T, int NPL, bool ADAM>
__device__ __forceinline__ void diag_adapt_update(
    const MkConfig& cfg, const Sched& s, int lane, T* av, T* im, T* af,
    const T* x, const T* gr, int draw_idx, bool diverging, T accept) {
  const int dim = cfg.dim;
  // the step size first: at the end the float32 Adam forms spilled
  step_size_update<T, ADAM>(cfg, af, accept);

  bool fin = true;
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    if (i < dim) fin = fin && isfinite(x[i]) && isfinite(gr[i]);
  }
  const bool ok = __all_sync(kFullMask, fin) && !diverging;
  const AdaptWindow<T> w(cfg, s, af, draw_idx, ok);

  // Welford adds, switch, and the estimate from the current window
  T est[NPL];
  bool est_fin = true;
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    est[r] = T(0);
    if (i >= dim) continue;
    T dv, gv;
    welford_coord(w, ok, av + i, dim, x[i], gr[i], dv, gv);
    est[r] = mass_estimate(cfg, w, dv, gv);
    est_fin = est_fin && isfinite(est[r]);
  }
  const bool use_est = __all_sync(kFullMask, est_fin) && w.dcur > T(2);

  // rate-limited update of the metric and the ratio for the step shift
  T ratio = -T(INFINITY);
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    if (i >= dim) continue;
    const T m = mass_update(cfg, w, use_est, est[r], im[i], ratio);
    im[i] = m;
    av[A_INV_MASS * dim + i] = m;
  }
  ratio = warp_max(ratio);
  adapt_scalars(w, af, ratio);
}

// The same update for a chain whose rows all stay in global memory and
// whose threads (a group of group.cuh) own chunks of N coordinates
// (each_chunk; at most KC a thread, or any number at KC = 0), as in every
// other loop of the step kernel: the inverse mass is the A_INV_MASS row of
// `av`, and the estimate is recomputed from the written m2 rows instead of
// held in registers.
template <typename T, int N, int KC, bool ADAM, typename G>
__device__ __forceinline__ void diag_adapt_update_strided(
    const G& g, const MkConfig& cfg, const Sched& s, T* av, T* af,
    const T* x, const T* gr, int draw_idx, bool diverging, T accept) {
  const int dim = cfg.dim;
  const int n_chunks = dim / N;
  bool fin = true;
  each_chunk<KC>(g, n_chunks, [&](int, int c) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = c * N + k;
      fin = fin && isfinite(x[i]) && isfinite(gr[i]);
    }
  });
  const bool ok = g.all(fin) && !diverging;
  const AdaptWindow<T> w(cfg, s, af, draw_idx, ok);

  bool est_fin = true;
  each_chunk<KC>(g, n_chunks, [&](int, int c) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = c * N + k;
      T dv, gv;
      welford_coord(w, ok, av + i, dim, x[i], gr[i], dv, gv);
      est_fin = est_fin && isfinite(mass_estimate(cfg, w, dv, gv));
    }
  });
  const bool use_est = g.all(est_fin) && w.dcur > T(2);

  T ratio = -T(INFINITY);
  each_chunk<KC>(g, n_chunks, [&](int, int c) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = c * N + k;
      const T est = mass_estimate(cfg, w, av[A_DRAWS_CUR_M2 * dim + i],
                                  av[A_GRADS_CUR_M2 * dim + i]);
      T* im = av + A_INV_MASS * dim + i;
      *im = mass_update(cfg, w, use_est, est, *im, ratio);
    }
  });
  ratio = g.max(ratio);
  step_size_update<T, ADAM>(cfg, af, accept);
  adapt_scalars(w, af, ratio);
}

}  // namespace nutpie
