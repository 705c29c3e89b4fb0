// Per-draw warmup adaptation inside the chunk kernel: dual averaging of the
// step size and nutpie's gradient-based diagonal mass matrix from Welford
// accumulators, with the window switch, the factor-2 rate limit and the
// matched step-size shift.  Same arithmetic as diag_adapt_update in
// nutpie_tpu_torch/sampler/adapt.py (and nutpie_tpu/sampler/adapt.py).
#pragma once

#include "block.cuh"

namespace nutpie {

// Dual averaging of the step size (thread 0; reads and writes b.af).
template <typename T>
__device__ inline void dual_avg_update(const MkConfig& cfg, T* af, T accept) {
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

template <typename T>
__device__ inline void welford_add(T& mean, T& m2, T count_new, T x) {
  const T delta = x - mean;
  mean = mean + delta / count_new;
  m2 = m2 + delta * (x - mean);
}

// One tuning draw's update, run by the whole block.  The draw is
// (prop_z, prop_g) of b.vecs; `diverging` and `accept` are block-uniform.
// Ends with a barrier.
template <typename T>
__device__ void diag_adapt_update(const Block<T>& b, const MkConfig& cfg,
                                  const Sched& s, int draw_idx,
                                  bool diverging, T accept) {
  const int dim = b.dim;
  const T* x = b.row(V_PROP_Z);
  const T* gr = b.row(V_PROP_G);
  T* af = b.af;
  const T min_var = T(cfg.min_variance);
  const T max_var = T(cfg.max_variance);

  bool fin = true;
  MK_FOR_COORDS(i, dim) fin = fin && isfinite(x[i]) && isfinite(gr[i]);
  const bool ok = __syncthreads_and(fin) && !diverging;

  // window schedule
  const bool frozen = draw_idx >= s.freeze_start;
  const int freq = draw_idx < s.early_end ? cfg.early_switch_freq
                                          : cfg.switch_freq;
  const bool sw = !frozen && draw_idx > 0 && ((draw_idx + 1) % freq == 0);

  // counts after the add and the switch (every thread reads them here;
  // thread 0 writes them back after the barriers below)
  const T one = T(1);
  const T dc = af[AF_DRAWS_CUR_COUNT] + (ok ? one : T(0));
  const T gc = af[AF_GRADS_CUR_COUNT] + (ok ? one : T(0));
  const T dbc = af[AF_DRAWS_BG_COUNT] + (ok ? one : T(0));
  const T gbc = af[AF_GRADS_BG_COUNT] + (ok ? one : T(0));
  const T dcur = sw ? dbc : dc;
  const T gcur = sw ? gbc : gc;

  // Welford adds, switch, and the estimate from the current window
  T* est = b.v_new;  // scratch row
  bool est_fin = true;
  MK_FOR_COORDS(i, dim) {
    T dm = b.arow(A_DRAWS_CUR_MEAN)[i], dv = b.arow(A_DRAWS_CUR_M2)[i];
    T gm = b.arow(A_GRADS_CUR_MEAN)[i], gv = b.arow(A_GRADS_CUR_M2)[i];
    T dbm = b.arow(A_DRAWS_BG_MEAN)[i], dbv = b.arow(A_DRAWS_BG_M2)[i];
    T gbm = b.arow(A_GRADS_BG_MEAN)[i], gbv = b.arow(A_GRADS_BG_M2)[i];
    if (ok) {
      welford_add(dm, dv, dc, x[i]);
      welford_add(gm, gv, gc, gr[i]);
      welford_add(dbm, dbv, dbc, x[i]);
      welford_add(gbm, gbv, gbc, gr[i]);
    }
    if (sw) {
      dm = dbm; dv = dbv; gm = gbm; gv = gbv;
      dbm = T(0); dbv = T(0); gbm = T(0); gbv = T(0);
    }
    b.arow(A_DRAWS_CUR_MEAN)[i] = dm;
    b.arow(A_DRAWS_CUR_M2)[i] = dv;
    b.arow(A_GRADS_CUR_MEAN)[i] = gm;
    b.arow(A_GRADS_CUR_M2)[i] = gv;
    b.arow(A_DRAWS_BG_MEAN)[i] = dbm;
    b.arow(A_DRAWS_BG_M2)[i] = dbv;
    b.arow(A_GRADS_BG_MEAN)[i] = gbm;
    b.arow(A_GRADS_BG_M2)[i] = gbv;

    const T draw_var = dv / jmax(dcur - one, one);
    T e;
    if (cfg.use_grad_based_estimate) {
      const T grad_var = gv / jmax(gcur - one, one);
      e = sqrt(jmax(draw_var, min_var) / jmax(grad_var, min_var));
    } else {
      // Stan-style shrinkage toward unit scale
      e = (dcur / (dcur + T(5))) * draw_var + T(1e-3) * (T(5) / (dcur + T(5)));
    }
    e = jclip(e, min_var, max_var);
    est[i] = e;
    est_fin = est_fin && isfinite(e);
  }
  const bool use_est = __syncthreads_and(est_fin) && dcur > T(2);

  // rate-limited update of the metric and the ratio for the step shift
  T ratio = -T(INFINITY);
  MK_FOR_COORDS(i, dim) {
    const T old = b.arow(A_INV_MASS)[i];
    T im = use_est ? est[i] : old;
    im = jclip(im, old * T(0.5), old * T(2.0));
    if (frozen) im = old;
    ratio = jmax(ratio, im / jmax(old, min_var));
    b.arow(A_INV_MASS)[i] = im;
  }
  ratio = block_max(ratio, b.red);

  if (threadIdx.x == 0) {
    dual_avg_update(cfg, af, accept);
    const T shift = T(-0.5) * log(jclip(ratio, T(1), T(2)));
    af[AF_LOG_STEP] = af[AF_LOG_STEP] + shift;
    af[AF_MU] = af[AF_MU] + shift;
    if (sw) {
      af[AF_HBAR] = T(0);
      af[AF_MU] = T(log(2.0)) + af[AF_LOG_STEP];
      af[AF_DA_COUNT] = T(0);
    }
    af[AF_DRAWS_CUR_COUNT] = dcur;
    af[AF_GRADS_CUR_COUNT] = gcur;
    af[AF_DRAWS_BG_COUNT] = sw ? T(0) : dbc;
    af[AF_GRADS_BG_COUNT] = sw ? T(0) : gbc;
  }
  __syncthreads();
}

}  // namespace nutpie
