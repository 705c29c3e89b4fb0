// The NUTS machine for one chain per thread block: start_draw, machine_step
// and the chunk loop.  Same semantics as start_draw/machine_step in
// nutpie_tpu_torch/sampler/nuts.py (and nutpie_tpu/sampler/nuts.py): one
// leapfrog per step, the checkpoint stack for subtree U-turns, multinomial
// and biased progressive proposal selection, divergence on a large or
// nonfinite energy error or a stagnant position, commits of finished draws,
// and the per-draw adaptation while tuning.
//
// Conventions: vector work runs over the coordinates each thread owns (no
// barrier needed between two such loops); scalar bookkeeping runs in thread
// 0 on the shared copies of flts/ints/adapt_flts and is published with a
// barrier; block-wide decisions travel through b.ci / b.cf.  Every branch
// that contains a barrier depends on block-uniform values only.
#pragma once

#include "adapt.cuh"
#include "block.cuh"
#include "radon.cuh"
#include "threefry.cuh"

namespace nutpie {

// Refresh momentum and reset the trajectory for a new draw.
template <typename T>
__device__ void start_draw(const Block<T>& b, const MkConfig& cfg,
                           const Sched& s, const T* gauss, T jitter_u) {
  const int dim = b.dim;
  const T* im = b.arow(A_INV_MASS);
  T ke[1] = {T(0)};
  MK_FOR_COORDS(i, dim) {
    const T p0 = gauss[i] / sqrt(im[i]);
    ke[0] += p0 * (im[i] * p0);
    const T z = b.row(V_POSITION)[i];
    const T g = b.row(V_GRADIENT)[i];
    b.row(V_Z_MINUS)[i] = z;
    b.row(V_P_MINUS)[i] = p0;
    b.row(V_G_MINUS)[i] = g;
    b.row(V_Z_PLUS)[i] = z;
    b.row(V_P_PLUS)[i] = p0;
    b.row(V_G_PLUS)[i] = g;
    b.row(V_RHO)[i] = p0;
    b.row(V_RHO_SUB)[i] = T(0);
    b.row(V_PROP_Z)[i] = z;
    b.row(V_PROP_G)[i] = g;
    b.row(V_SPROP_Z)[i] = z;
    b.row(V_SPROP_G)[i] = g;
  }
  block_sum(ke, b.red);
  if (threadIdx.x == 0) {
    T* fl = b.fl;
    int* in = b.in;
    const bool tuning = in[I_DRAW_IDX] < s.num_tune;
    T eps = exp(tuning ? b.af[AF_LOG_STEP] : b.af[AF_LOG_STEP_BAR]);
    if (cfg.has_jitter) {
      eps = eps * (T(1) + T(cfg.step_size_jitter) * (T(2) * jitter_u - T(1)));
    }
    const T logp = fl[F_LOGP];
    const T h0 = -logp + T(0.5) * ke[0];
    fl[F_EPS] = eps;
    fl[F_H0] = h0;
    fl[F_LOGW_TRAJ] = T(0);
    fl[F_PROP_LOGP] = logp;
    fl[F_PROP_ENERGY] = h0;
    fl[F_LOGW_SUB] = -T(INFINITY);
    fl[F_SPROP_LOGP] = logp;
    fl[F_SPROP_ENERGY] = h0;
    fl[F_SUM_ACC] = T(0);
    fl[F_KE_MINUS] = T(0);
    fl[F_KE_PLUS] = T(0);
    in[I_PROP_IDX] = 0;
    in[I_DEPTH] = 0;
    in[I_DIRECTION] = 1;
    in[I_LEFT_IDX] = 0;
    in[I_RIGHT_IDX] = 0;
    in[I_N_LEAVES] = 0;
    in[I_N_LEAF] = 0;
    in[I_SPROP_IDX] = 0;
    in[I_CKPT_TOP] = 0;
    in[I_DIVERGING] = 0;
    in[I_TURNING_SUB] = 0;
  }
  __syncthreads();
}

// Advance the chain by one leapfrog step.  Ends with a barrier.
template <typename T>
__device__ void machine_step(const Block<T>& b, const MkArgs<T>& a,
                             const Sched& s, uint32_t key1, uint32_t key2) {
  const MkConfig& cfg = a.cfg;
  const int dim = b.dim;
  const int D = b.D;
  const int L = cfg.chunk_len;
  const int chain = blockIdx.x;
  T* fl = b.fl;
  int* in = b.in;
  int* ci = b.ci;
  T* cf = b.cf;
  const T* im = b.arow(A_INV_MASS);

  // ---------------------------------------------- randomness, direction
  if (threadIdx.x == 0) {
    const bool active = in[I_DONE] == 0;
    uint32_t k1 = key1, k2 = key2;
    fold_in(k1, k2, 3u);
    fold_in(k1, k2, uint32_t(in[I_TOTAL_STEPS]));
    float u3[3];
    uniform3(k1, k2, u3);
    const bool at_start = in[I_N_LEAF] == 0;
    const int new_dir = T(u3[0]) < T(0.5) ? -1 : 1;
    const int direction = at_start ? new_dir : in[I_DIRECTION];
    ci[C_ACTIVE] = active;
    ci[C_AT_START] = at_start;
    ci[C_FWD] = direction > 0;
    if (active) in[I_DIRECTION] = direction;
    cf[X_EPS_S] = T(direction) * fl[F_EPS];
    cf[X_U1] = T(u3[1]);
    cf[X_U2] = T(u3[2]);
  }
  __syncthreads();
  const bool active = ci[C_ACTIVE];
  const bool fwd = ci[C_FWD];
  const T eps_s = cf[X_EPS_S];
  const T half_eps = T(0.5) * eps_s;

  // ---------------------------------------------- leapfrog, first half
  bool moved = false;
  MK_FOR_COORDS(i, dim) {
    const T p_minus = b.row(V_P_MINUS)[i];
    const T p_plus = b.row(V_P_PLUS)[i];
    // slot D-1 stashes the old edge momentum for the cross U-turn checks
    if (ci[C_AT_START] && active) b.ckpt_p[(D - 1) * dim + i] = fwd ? p_plus : p_minus;
    const T z_e = fwd ? b.row(V_Z_PLUS)[i] : b.row(V_Z_MINUS)[i];
    const T p_e = fwd ? p_plus : p_minus;
    const T g_e = fwd ? b.row(V_G_PLUS)[i] : b.row(V_G_MINUS)[i];
    const T p_half = p_e + half_eps * g_e;
    const T z_new = z_e + eps_s * (im[i] * p_half);
    b.z_new[i] = z_new;
    b.p_new[i] = p_half;
    moved = moved || (z_new != z_e);
  }
  // an unintegrable step (eps below the position's resolution) is a
  // divergence
  const bool stagnant = !__syncthreads_or(moved);

  radon_logp_grad(b, a);

  // ---------------------------------------------- leapfrog, second half
  T ke[1] = {T(0)};
  MK_FOR_COORDS(i, dim) {
    const T p_new = b.p_new[i] + half_eps * b.g_new[i];
    const T v_new = im[i] * p_new;
    b.p_new[i] = p_new;
    b.v_new[i] = v_new;
    ke[0] += p_new * v_new;
  }
  block_sum(ke, b.red);

  // ---------------------------------------------- leaf processing
  if (threadIdx.x == 0) {
    const T logp_new = cf[X_LOGP_NEW];
    const T h = -logp_new + T(0.5) * ke[0];
    const int n = in[I_N_LEAF] + 1;
    const T e_err = h - fl[F_H0];
    const bool finite = isfinite(e_err);
    const bool div_leaf = !finite || e_err > T(cfg.max_energy_error) || stagnant;
    const T lw = div_leaf ? -T(INFINITY) : -e_err;
    const T acc = finite ? exp(jmin(T(0), -e_err)) : T(0);
    if (active) {
      fl[F_SUM_ACC] = fl[F_SUM_ACC] + acc;
      in[I_N_LEAVES] += 1;
      in[I_TOTAL_STEPS] += 1;
    }
    const int abs_idx = fwd ? in[I_RIGHT_IDX] + 1 : in[I_LEFT_IDX] - 1;
    if (active && fwd) in[I_RIGHT_IDX] += 1;
    if (active && !fwd) in[I_LEFT_IDX] -= 1;

    // progressive multinomial within the subtree
    const T logw_sub_new = logaddexp(fl[F_LOGW_SUB], lw);
    const T d = lw - logw_sub_new;
    const bool take = log(cf[X_U1]) < d && !(d != d);
    const bool m_take = active && take;
    if (m_take) {
      fl[F_SPROP_LOGP] = logp_new;
      fl[F_SPROP_ENERGY] = h;
      in[I_SPROP_IDX] = abs_idx;
    }
    // checkpoint stack: push at odd leaves, check+pop at even leaves
    const bool odd = (n % 2) == 1;
    const int top = in[I_CKPT_TOP];
    const bool push = active && odd;
    ci[C_M_TAKE] = m_take;
    ci[C_PUSH] = push;
    ci[C_TOP] = top;
    ci[C_TOP_AFTER] = push ? top + 1 : top;
    ci[C_TZ] = __ffs(n) - 1;
    ci[C_EVEN] = active && !odd;
    ci[C_DIV_LEAF] = div_leaf;
    cf[X_H] = h;
    cf[X_LOGW_SUB_NEW] = logw_sub_new;
  }
  __syncthreads();

  const bool m_take = ci[C_M_TAKE];
  const bool push = ci[C_PUSH];
  const int top = ci[C_TOP];
  const int top_after = ci[C_TOP_AFTER];
  const int tz = ci[C_TZ];
  const bool even = ci[C_EVEN];
  MK_FOR_COORDS(i, dim) {
    if (m_take) {
      b.row(V_SPROP_Z)[i] = b.z_new[i];
      b.row(V_SPROP_G)[i] = b.g_new[i];
    }
    const T rho_sub = b.row(V_RHO_SUB)[i];
    b.rsn[i] = rho_sub + b.p_new[i];
    if (push) {
      b.ckpt_p[top * dim + i] = b.p_new[i];
      b.ckpt_s[top * dim + i] = rho_sub;
    }
  }
  // subtree U-turn checks against the top tz checkpoints
  bool turning_here = false;
  if (cfg.check_turning && even) {
    const int lo = top_after - tz > 0 ? top_after - tz : 0;
    for (int slot = lo; slot < top_after && slot < D; ++slot) {
      T dots[2] = {T(0), T(0)};
      const T* cp = b.ckpt_p + slot * dim;
      const T* cs = b.ckpt_s + slot * dim;
      MK_FOR_COORDS(i, dim) {
        const T rho_ab = b.rsn[i] - cs[i];
        dots[0] += rho_ab * (cp[i] * im[i]);
        dots[1] += rho_ab * b.v_new[i];
      }
      block_sum(dots, b.red);
      turning_here = turning_here || dots[0] <= T(0) || dots[1] <= T(0);
    }
  }

  // ---------------------------------------------- subtree completion
  if (threadIdx.x == 0) {
    const int n = in[I_N_LEAF] + 1;
    const bool turning_sub_mid = (in[I_TURNING_SUB] > 0) || (even && turning_here);
    const int top_new = even ? top_after - (tz - 1 > 0 ? tz - 1 : 0) : top_after;
    const bool full = n >= (1 << in[I_DEPTH]);
    const bool sub_invalid = ci[C_DIV_LEAF] || turning_sub_mid;
    const bool sub_done = active && (full || sub_invalid);
    const bool merge_ok = sub_done && !sub_invalid;
    // biased progressive sampling at the merge
    const T logw_sub_new = cf[X_LOGW_SUB_NEW];
    const T log_ratio = logw_sub_new - fl[F_LOGW_TRAJ];
    const bool take2 = log(cf[X_U2]) < log_ratio && !(log_ratio != log_ratio);
    const bool m_take2 = merge_ok && take2;
    if (m_take2) {
      fl[F_PROP_LOGP] = fl[F_SPROP_LOGP];
      fl[F_PROP_ENERGY] = fl[F_SPROP_ENERGY];
      in[I_PROP_IDX] = in[I_SPROP_IDX];
    }
    if (merge_ok) fl[F_LOGW_TRAJ] = logaddexp(fl[F_LOGW_TRAJ], logw_sub_new);
    ci[C_TURN_SUB_MID] = turning_sub_mid;
    ci[C_TOP_NEW] = top_new;
    ci[C_SUB_DONE] = sub_done;
    ci[C_SUB_INVALID] = sub_invalid;
    ci[C_MERGE_OK] = merge_ok;
    ci[C_M_TAKE2] = m_take2;
  }
  __syncthreads();

  // ---------------------------------------------- merged-trajectory checks
  const bool merge_ok = ci[C_MERGE_OK];
  const bool m_take2 = ci[C_M_TAKE2];
  const bool check_traj = cfg.check_turning && merge_ok;
  T dots[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  MK_FOR_COORDS(i, dim) {
    if (m_take2) {
      b.row(V_PROP_Z)[i] = b.row(V_SPROP_Z)[i];
      b.row(V_PROP_G)[i] = b.row(V_SPROP_G)[i];
    }
    const T rho = b.row(V_RHO)[i];
    const T rho_full = rho + b.rsn[i];
    if (check_traj) {
      const T far_p = fwd ? b.row(V_P_MINUS)[i] : b.row(V_P_PLUS)[i];
      const T first_new_p = b.ckpt_p[i];
      const T edge_old_p = b.ckpt_p[(D - 1) * dim + i];
      const T v_far = im[i] * far_p;
      const T v_first_new = im[i] * first_new_p;
      const T v_edge_old = im[i] * edge_old_p;
      const T r2 = rho + first_new_p;
      const T r3 = b.rsn[i] + edge_old_p;
      dots[0] += rho_full * v_far;
      dots[1] += rho_full * b.v_new[i];
      dots[2] += r2 * v_far;
      dots[3] += r2 * v_first_new;
      dots[4] += r3 * v_edge_old;
      dots[5] += r3 * b.v_new[i];
    }
    if (merge_ok) b.row(V_RHO)[i] = rho_full;
  }
  bool turning_traj = false;
  if (check_traj) {
    block_sum(dots, b.red);
    bool t = false;
    for (int k = 0; k < 6; ++k) t = t || dots[k] <= T(0);
    turning_traj = t;
  }

  // ---------------------------------------------- draw completion
  if (threadIdx.x == 0) {
    const int in_depth = in[I_DEPTH];
    turning_traj = turning_traj && (in_depth + 1) >= cfg.mindepth;
    int depth_limit = cfg.maxdepth < s.depth_cap ? cfg.maxdepth : s.depth_cap;
    const int floor_depth = cfg.mindepth > 1 ? cfg.mindepth : 1;
    depth_limit = depth_limit > floor_depth ? depth_limit : floor_depth;
    const bool ended_by_depth = merge_ok && (in_depth + 1) >= depth_limit;
    const bool draw_done = ci[C_SUB_DONE]
        && (ci[C_SUB_INVALID] || turning_traj || ended_by_depth);
    const bool next_doubling = merge_ok && !draw_done;
    const int n = in[I_N_LEAF] + 1;
    if (next_doubling) in[I_DEPTH] = in_depth + 1;
    if (active) {
      in[I_N_LEAF] = next_doubling ? 0 : n;
      fl[F_LOGW_SUB] = next_doubling ? -T(INFINITY) : cf[X_LOGW_SUB_NEW];
      in[I_TURNING_SUB] = ci[C_TURN_SUB_MID] && !next_doubling;
      in[I_CKPT_TOP] = next_doubling ? 0 : ci[C_TOP_NEW];
    }
    const bool diverging = active ? ((in[I_DIVERGING] > 0) || ci[C_DIV_LEAF])
                                  : (in[I_DIVERGING] > 0);
    in[I_DIVERGING] = diverging;

    const int idx = in[I_DRAW_IDX] - s.chunk_start;
    const int idx_c = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
    const int n_leaves = in[I_N_LEAVES];
    const T accept_mean = fl[F_SUM_ACC] / T(n_leaves > 1 ? n_leaves : 1);
    const bool tuning = in[I_DRAW_IDX] < s.num_tune;
    if (draw_done) {
      T* row = a.scal_out + (size_t(chain) * L + idx_c) * N_SCALAR;
      row[S_LOGP] = fl[F_PROP_LOGP];
      row[S_ENERGY] = fl[F_PROP_ENERGY];
      row[S_DEPTH] = T(in_depth + 1);
      row[S_MAXDEPTH_REACHED] = T(ended_by_depth && !turning_traj);
      row[S_DIVERGING] = T(diverging);
      row[S_STEP_SIZE] = fl[F_EPS];
      row[S_STEP_SIZE_BAR] = exp(b.af[AF_LOG_STEP_BAR]);
      row[S_N_STEPS] = T(n_leaves);
      row[S_MEAN_TREE_ACCEPT] = accept_mean;
      row[S_INDEX_IN_TRAJECTORY] = T(in[I_PROP_IDX]);
      row[S_FISHER_DISTANCE] = T(0);
      row[N_SCALAR - 1] = T(0);
    }
    ci[C_DRAW_DONE] = draw_done;
    ci[C_NEXT_DOUBLING] = next_doubling;
    ci[C_IDX_C] = idx_c;
    ci[C_UPD] = draw_done && tuning && !cfg.adapt_frozen;
    ci[C_DIVERGING] = diverging;
    cf[X_ACCEPT] = accept_mean;
  }
  __syncthreads();

  const bool draw_done = ci[C_DRAW_DONE];
  const bool next_doubling = ci[C_NEXT_DOUBLING];
  const int idx_c = ci[C_IDX_C];
  T* pos_row = a.pos_out + (size_t(chain) * L + idx_c) * dim;
  MK_FOR_COORDS(i, dim) {
    if (active) b.row(V_RHO_SUB)[i] = next_doubling ? T(0) : b.rsn[i];
    if (active && fwd) {
      b.row(V_Z_PLUS)[i] = b.z_new[i];
      b.row(V_P_PLUS)[i] = b.p_new[i];
      b.row(V_G_PLUS)[i] = b.g_new[i];
    }
    if (active && !fwd) {
      b.row(V_Z_MINUS)[i] = b.z_new[i];
      b.row(V_P_MINUS)[i] = b.p_new[i];
      b.row(V_G_MINUS)[i] = b.g_new[i];
    }
    if (draw_done) {
      const T pz = b.row(V_PROP_Z)[i];
      pos_row[i] = pz;
      b.row(V_POSITION)[i] = pz;
      b.row(V_GRADIENT)[i] = b.row(V_PROP_G)[i];
    }
  }

  // adaptation (tuning draws only; compiled in but skipped when frozen)
  const bool upd = ci[C_UPD];
  if (upd) {
    // reads prop_z/prop_g of this thread's coordinates and the block's
    // diverging flag; the loop above touched neither
    diag_adapt_update(b, cfg, s, in[I_DRAW_IDX], ci[C_DIVERGING] != 0,
                      cf[X_ACCEPT]);
  }

  if (threadIdx.x == 0) {
    const int in_draw_idx = in[I_DRAW_IDX];
    if (upd && in_draw_idx == s.num_tune - 1) {
      // at the end of tuning, freeze the step size at its averaged value
      b.af[AF_LOG_STEP] = b.af[AF_LOG_STEP_BAR];
    }
    if (draw_done && ci[C_DIVERGING]) in[I_DIVERGENCE_COUNT] += 1;
    if (draw_done) {
      fl[F_LOGP] = fl[F_PROP_LOGP];
      in[I_DRAW_IDX] = in_draw_idx + 1;
    }
    const int idx = in_draw_idx - s.chunk_start;
    const bool done = (in[I_DONE] > 0) || (draw_done && idx + 1 >= s.limit);
    in[I_DONE] = done;
    ci[C_RESTART] = draw_done && !done;
    const int nidx = idx + 1;
    ci[C_NEXT_IDX_C] = nidx < 0 ? 0 : (nidx > L - 1 ? L - 1 : nidx);
  }
  __syncthreads();

  // start the next draw when this one finished and the chunk is not done
  if (ci[C_RESTART]) {
    const size_t r = size_t(chain) * L + ci[C_NEXT_IDX_C];
    start_draw(b, cfg, s, a.mom + r * dim, a.jit[r]);
  }
}

// One chunk of draws for the chain of this block.  `smem` is the block's
// dynamic shared memory of block_smem_bytes<T>(dim, D, n_counties) bytes.
template <typename T>
__device__ void megakernel_chunk_body(const MkArgs<T>& a, unsigned char* smem) {
  const MkConfig& cfg = a.cfg;
  const int chain = blockIdx.x;
  const int dim = cfg.dim;
  const int D = cfg.depth_slots;
  const int L = cfg.chunk_len;
  const Block<T> b = carve_block<T>(smem, dim, D, cfg.n_counties);
  const Sched s = {a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4],
                   a.scal[5]};
  const uint32_t key1 = uint32_t(a.key[2 * chain]);
  const uint32_t key2 = uint32_t(a.key[2 * chain + 1]);

  // load the chain's state into shared memory
  const size_t vbase = size_t(chain) * N_VEC * dim;
  const size_t cbase = size_t(chain) * D * dim;
  const size_t abase = size_t(chain) * N_ADAPT_VEC * dim;
  for (int i = threadIdx.x; i < N_VEC * dim; i += kThreads) b.vecs[i] = a.vecs[vbase + i];
  for (int i = threadIdx.x; i < D * dim; i += kThreads) {
    b.ckpt_p[i] = a.ckpt_p[cbase + i];
    b.ckpt_s[i] = a.ckpt_s[cbase + i];
  }
  for (int i = threadIdx.x; i < N_ADAPT_VEC * dim; i += kThreads) b.av[i] = a.adapt_vecs[abase + i];
  if (threadIdx.x < N_FLT) b.fl[threadIdx.x] = a.flts[chain * N_FLT + threadIdx.x];
  if (threadIdx.x < N_ADAPT_FLT) b.af[threadIdx.x] = a.adapt_flts[chain * N_ADAPT_FLT + threadIdx.x];
  if (threadIdx.x < N_INT) b.in[threadIdx.x] = a.ints[chain * N_INT + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) b.in[I_DONE] = 0;
  __syncthreads();

  // every chain begins the chunk at a draw boundary
  const size_t r0 = size_t(chain) * L;
  start_draw(b, cfg, s, a.mom + r0 * dim, a.jit[r0]);
  while (true) {
    machine_step(b, a, s, key1, key2);
    if (b.in[I_DONE]) break;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N_VEC * dim; i += kThreads) a.vecs[vbase + i] = b.vecs[i];
  for (int i = threadIdx.x; i < D * dim; i += kThreads) {
    a.ckpt_p[cbase + i] = b.ckpt_p[i];
    a.ckpt_s[cbase + i] = b.ckpt_s[i];
  }
  for (int i = threadIdx.x; i < N_ADAPT_VEC * dim; i += kThreads) a.adapt_vecs[abase + i] = b.av[i];
  if (threadIdx.x < N_FLT) a.flts[chain * N_FLT + threadIdx.x] = b.fl[threadIdx.x];
  if (threadIdx.x < N_ADAPT_FLT) a.adapt_flts[chain * N_ADAPT_FLT + threadIdx.x] = b.af[threadIdx.x];
  if (threadIdx.x < N_INT) a.ints[chain * N_INT + threadIdx.x] = b.in[threadIdx.x];
}

}  // namespace nutpie
