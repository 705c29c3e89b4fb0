// The NUTS machine for one chain per warp: start_draw, machine_step and the
// chunk loop of one chain.  Same semantics as start_draw/machine_step in
// nutpie_tpu_torch/sampler/nuts.py (and nutpie_tpu/sampler/nuts.py): one
// leapfrog per step, the checkpoint stack for subtree U-turns, multinomial
// and biased progressive proposal selection, divergence on a large or
// nonfinite energy error or a stagnant position, commits of finished draws,
// and the per-draw adaptation while tuning.
//
// Conventions.  Lane l owns coordinates l, l + 32, ... (NPL of them) of
// every [dim] row and is the only lane that touches them, so no row needs
// a barrier.  The leapfrog's new point is registers (zn/pn/gn); the
// chain's state rows and inverse mass live in the warp's slice of shared
// memory (WarpMem::row, one load or store per row and leapfrog where the
// step touches them), and its checkpoint stack in its global rows (L2),
// read only by the subtree and merge U-turn checks.  That keeps a thread
// within the 128 registers that 16 resident chains per SM allow.  All scalar
// bookkeeping (direction, energy error, the multinomial and merge choices,
// the checkpoint indices, draw completion, dual averaging) is
// lane-uniform: every lane computes it from the same values, so no lane
// waits for another and nothing is broadcast.  Dot products are warp
// butterflies (warp.cuh).  Every branch is lane-uniform except the radon
// residual loop, whose lanes run equal shares of the observations.
#pragma once

#include "adapt.cuh"
#include "radon.cuh"
#include "threefry.cuh"
#include "warp.cuh"

namespace nutpie {

// The scalars of one chain, the same in every lane (registers).
template <typename T>
struct Chain {
  T fl[N_FLT];
  int in[N_INT];
};

// Everything one chain's warp reads besides its registers.
template <typename T>
struct WarpCtx {
  const MkArgs<T>* a;
  ModelData<T> d;
  WarpMem<T> w;
  Sched s;
  int lane;
};

// Refresh momentum and reset the trajectory for a new draw.
template <typename T, int NPL>
__device__ __forceinline__ void start_draw(Chain<T>& c,
                                           const MkConfig& cfg,
                                           const Sched& s, int lane,
                                           const WarpMem<T>& w,
                                           const T* gauss, T jitter_u) {
  const int dim = cfg.dim;
  T ke[1] = {T(0)};
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    if (i >= dim) continue;
    const T im = w.row(kRowInvMass, dim)[i];
    const T p0 = gauss[i] / sqrt(im);
    ke[0] += p0 * (im * p0);
    // the committed position and gradient (the proposal's rows)
    const T z = w.row(V_PROP_Z, dim)[i];
    const T g = w.row(V_PROP_G, dim)[i];
    w.row(V_Z_MINUS, dim)[i] = z;
    w.row(V_P_MINUS, dim)[i] = p0;
    w.row(V_G_MINUS, dim)[i] = g;
    w.row(V_Z_PLUS, dim)[i] = z;
    w.row(V_P_PLUS, dim)[i] = p0;
    w.row(V_G_PLUS, dim)[i] = g;
    w.row(V_RHO, dim)[i] = p0;
    w.row(V_RHO_SUB, dim)[i] = T(0);
    w.row(V_SPROP_Z, dim)[i] = z;
    w.row(V_SPROP_G, dim)[i] = g;
  }
  warp_sum(ke);
  T* fl = c.fl;
  int* in = c.in;
  const bool tuning = in[I_DRAW_IDX] < s.num_tune;
  T eps = exp(tuning ? w.af[AF_LOG_STEP] : w.af[AF_LOG_STEP_BAR]);
  if (cfg.has_jitter) {
    eps = eps * (T(1) + T(cfg.step_size_jitter) * (T(2) * jitter_u - T(1)));
  }
  // the committed log density (the proposal's at a draw boundary)
  const T logp = fl[F_PROP_LOGP];
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

// Advance the chain by one leapfrog step.  The chain is active (the loop
// in run_chain stops at its last draw).  `cp`/`cs` are the chain's
// checkpoint rows in global memory, `av` its adaptation rows.
template <typename T, int NPL, bool ADAM>
__device__ __forceinline__ void machine_step(Chain<T>& c,
                                             StepUniforms& rng,
                                             const WarpCtx<T>& x, int chain,
                                             T* cp, T* cs, T* av) {
  const MkArgs<T>& a = *x.a;
  const MkConfig& cfg = a.cfg;
  const Sched& s = x.s;
  const WarpMem<T>& w = x.w;
  const int lane = x.lane;
  const int dim = cfg.dim;
  const int D = cfg.depth_slots;
  const int L = cfg.chunk_len;
  T* fl = c.fl;
  int* in = c.in;

  // ---------------------------------------------- randomness, direction
  float u3[3];
  rng.get(uint32_t(in[I_TOTAL_STEPS]), lane, u3);
  const bool at_start = in[I_N_LEAF] == 0;
  const int new_dir = T(u3[0]) < T(0.5) ? -1 : 1;
  const int direction = at_start ? new_dir : in[I_DIRECTION];
  in[I_DIRECTION] = direction;
  const bool fwd = direction > 0;
  const T eps_s = T(direction) * fl[F_EPS];
  const T half_eps = T(0.5) * eps_s;
  // the edge this step extends and the far edge
  T* ze = w.row(fwd ? V_Z_PLUS : V_Z_MINUS, dim);
  T* pe = w.row(fwd ? V_P_PLUS : V_P_MINUS, dim);
  T* ge = w.row(fwd ? V_G_PLUS : V_G_MINUS, dim);
  const T* p_far = w.row(fwd ? V_P_MINUS : V_P_PLUS, dim);
  const T* imr = w.row(kRowInvMass, dim);
  T* rho_sub = w.row(V_RHO_SUB, dim);

  // ---------------------------------------------- leapfrog, first half
  T zn[NPL], pn[NPL], gn[NPL];
  bool moved = false;
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    zn[r] = T(0);
    pn[r] = T(0);
    if (i >= dim) continue;
    const T p_e = pe[i];
    // slot D-1 stashes the old edge momentum for the cross U-turn checks
    if (at_start) cp[(D - 1) * dim + i] = p_e;
    const T z_e = ze[i];
    const T p_half = p_e + half_eps * ge[i];
    zn[r] = z_e + eps_s * (imr[i] * p_half);
    pn[r] = p_half;
    moved = moved || (zn[r] != z_e);
  }
  // an unintegrable step (eps below the position's resolution) is a
  // divergence
  const bool stagnant = !__any_sync(kFullMask, moved);

  const T logp_new = radon_logp_grad<T, NPL>(x.d, w, cfg, lane, zn, gn);

  // ---------------------------------------------- leapfrog, second half
  T ke[1] = {T(0)};
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    if (lane + kLanes * r >= dim) continue;
    pn[r] = pn[r] + half_eps * gn[r];
    ke[0] += pn[r] * (imr[lane + kLanes * r] * pn[r]);
  }
  warp_sum(ke);

  // ---------------------------------------------- leaf processing
  const T h = -logp_new + T(0.5) * ke[0];
  const int n = in[I_N_LEAF] + 1;
  const T e_err = h - fl[F_H0];
  const bool finite = isfinite(e_err);
  const bool div_leaf = !finite || e_err > T(cfg.max_energy_error) || stagnant;
  const T lw = div_leaf ? -T(INFINITY) : -e_err;
  const T acc = finite ? exp(jmin(T(0), -e_err)) : T(0);
  fl[F_SUM_ACC] = fl[F_SUM_ACC] + acc;
  in[I_N_LEAVES] += 1;
  in[I_TOTAL_STEPS] += 1;
  const int abs_idx = fwd ? in[I_RIGHT_IDX] + 1 : in[I_LEFT_IDX] - 1;
  if (fwd) in[I_RIGHT_IDX] += 1;
  else in[I_LEFT_IDX] -= 1;

  // progressive multinomial within the subtree
  const T logw_sub_new = logaddexp(fl[F_LOGW_SUB], lw);
  const T dl = lw - logw_sub_new;
  const bool m_take = log(T(u3[1])) < dl && !(dl != dl);
  if (m_take) {
    fl[F_SPROP_LOGP] = logp_new;
    fl[F_SPROP_ENERGY] = h;
    in[I_SPROP_IDX] = abs_idx;
  }
  // checkpoint stack: push at odd leaves, check+pop at even leaves
  const bool odd = (n % 2) == 1;
  const int top = in[I_CKPT_TOP];
  const int top_after = odd ? top + 1 : top;
  const int tz = __ffs(n) - 1;

  T rsn[NPL];  // rho_sub + p_new
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    rsn[r] = T(0);
    if (i >= dim) continue;
    if (m_take) {
      w.row(V_SPROP_Z, dim)[i] = zn[r];
      w.row(V_SPROP_G, dim)[i] = gn[r];
    }
    const T rs = rho_sub[i];
    rsn[r] = rs + pn[r];
    if (odd) {
      cp[top * dim + i] = pn[r];
      cs[top * dim + i] = rs;
    }
  }
  // subtree U-turn checks against the top tz checkpoints
  bool turning_here = false;
  if (cfg.check_turning && !odd) {
    const int lo = top_after - tz > 0 ? top_after - tz : 0;
    for (int slot = lo; slot < top_after && slot < D; ++slot) {
      T dots[2] = {T(0), T(0)};
#pragma unroll
      for (int r = 0; r < NPL; ++r) {
        const int i = lane + kLanes * r;
        if (i >= dim) continue;
        const T im = imr[i];
        const T rho_ab = rsn[r] - cs[slot * dim + i];
        dots[0] += rho_ab * (cp[slot * dim + i] * im);
        dots[1] += rho_ab * (im * pn[r]);
      }
      warp_sum(dots);
      turning_here = turning_here || dots[0] <= T(0) || dots[1] <= T(0);
    }
  }

  // ---------------------------------------------- subtree completion
  const bool turning_sub_mid = (in[I_TURNING_SUB] > 0) || (!odd && turning_here);
  const int top_new = !odd ? top_after - (tz - 1 > 0 ? tz - 1 : 0) : top_after;
  const bool full = n >= (1 << in[I_DEPTH]);
  const bool sub_invalid = div_leaf || turning_sub_mid;
  const bool sub_done = full || sub_invalid;
  const bool merge_ok = sub_done && !sub_invalid;
  // biased progressive sampling at the merge
  const T log_ratio = logw_sub_new - fl[F_LOGW_TRAJ];
  const bool take2 = log(T(u3[2])) < log_ratio && !(log_ratio != log_ratio);
  const bool m_take2 = merge_ok && take2;
  if (m_take2) {
    fl[F_PROP_LOGP] = fl[F_SPROP_LOGP];
    fl[F_PROP_ENERGY] = fl[F_SPROP_ENERGY];
    in[I_PROP_IDX] = in[I_SPROP_IDX];
  }
  if (merge_ok) fl[F_LOGW_TRAJ] = logaddexp(fl[F_LOGW_TRAJ], logw_sub_new);

  // ---------------------------------------------- merged-trajectory checks
  const bool check_traj = cfg.check_turning && merge_ok;
  T dots[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  if (merge_ok) {
#pragma unroll
    for (int r = 0; r < NPL; ++r) {
      const int i = lane + kLanes * r;
      if (i >= dim) continue;
      if (m_take2) {
        w.row(V_PROP_Z, dim)[i] = w.row(V_SPROP_Z, dim)[i];
        w.row(V_PROP_G, dim)[i] = w.row(V_SPROP_G, dim)[i];
      }
      const T rho = w.row(V_RHO, dim)[i];
      const T rho_full = rho + rsn[r];
      if (check_traj) {
        const T im = imr[i];
        const T first_new_p = cp[i];
        const T edge_old_p = cp[(D - 1) * dim + i];
        const T v_far = im * p_far[i];
        const T v_first_new = im * first_new_p;
        const T v_edge_old = im * edge_old_p;
        const T v_new = im * pn[r];
        const T r2 = rho + first_new_p;
        const T r3 = rsn[r] + edge_old_p;
        dots[0] += rho_full * v_far;
        dots[1] += rho_full * v_new;
        dots[2] += r2 * v_far;
        dots[3] += r2 * v_first_new;
        dots[4] += r3 * v_edge_old;
        dots[5] += r3 * v_new;
      }
      w.row(V_RHO, dim)[i] = rho_full;
    }
  }
  bool turning_traj = false;
  if (check_traj) {
    warp_sum(dots);
    for (int k = 0; k < 6; ++k) turning_traj = turning_traj || dots[k] <= T(0);
  }

  // ---------------------------------------------- draw completion
  const int in_depth = in[I_DEPTH];
  turning_traj = turning_traj && (in_depth + 1) >= cfg.mindepth;
  const bool ended_by_depth =
      merge_ok && (in_depth + 1) >= depth_limit(cfg, s, fl[F_EPS]);
  const bool draw_done = sub_done && (sub_invalid || turning_traj || ended_by_depth);
  const bool next_doubling = merge_ok && !draw_done;
  if (next_doubling) in[I_DEPTH] = in_depth + 1;
  in[I_N_LEAF] = next_doubling ? 0 : n;
  fl[F_LOGW_SUB] = next_doubling ? -T(INFINITY) : logw_sub_new;
  in[I_TURNING_SUB] = turning_sub_mid && !next_doubling;
  in[I_CKPT_TOP] = next_doubling ? 0 : top_new;
  const bool diverging = (in[I_DIVERGING] > 0) || div_leaf;
  in[I_DIVERGING] = diverging;

#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    if (i >= dim) continue;
    rho_sub[i] = next_doubling ? T(0) : rsn[r];
    ze[i] = zn[r];
    pe[i] = pn[r];
    ge[i] = gn[r];
  }
  if (!draw_done) return;

  const int in_draw_idx = in[I_DRAW_IDX];
  const int idx = in_draw_idx - s.chunk_start;
  const int idx_c = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
  const int n_leaves = in[I_N_LEAVES];
  const T accept_mean = fl[F_SUM_ACC] / T(n_leaves > 1 ? n_leaves : 1);
  const size_t out_row = size_t(chain) * L + idx_c;
  if (lane == 0) {
    T* row = a.scal_out + out_row * N_SCALAR;
    row[S_LOGP] = fl[F_PROP_LOGP];
    row[S_ENERGY] = fl[F_PROP_ENERGY];
    row[S_DEPTH] = T(in_depth + 1);
    row[S_MAXDEPTH_REACHED] = T(ended_by_depth && !turning_traj);
    row[S_DIVERGING] = T(diverging);
    row[S_STEP_SIZE] = fl[F_EPS];
    row[S_STEP_SIZE_BAR] = exp(w.af[AF_LOG_STEP_BAR]);
    row[S_N_STEPS] = T(n_leaves);
    row[S_MEAN_TREE_ACCEPT] = accept_mean;
    row[S_INDEX_IN_TRAJECTORY] = T(in[I_PROP_IDX]);
    row[S_FISHER_DISTANCE] = T(0);
    row[N_SCALAR - 1] = T(0);
  }
  // commit the proposal (its rows become the committed position)
  T* pos_row = a.pos_out + out_row * dim;
  const T* pz = w.row(V_PROP_Z, dim);
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    if (i < dim) pos_row[i] = pz[i];
  }

  // adaptation (tuning draws only; compiled in but skipped when frozen)
  if (in_draw_idx < s.num_tune && !cfg.adapt_frozen) {
    T af[N_ADAPT_FLT];
#pragma unroll
    for (int q = 0; q < N_ADAPT_FLT; ++q) af[q] = w.af[q];
    diag_adapt_update<T, NPL, ADAM>(cfg, s, lane, av, w.row(kRowInvMass, dim), af,
                              pz, w.row(V_PROP_G, dim), in_draw_idx,
                              diverging, accept_mean);
    // at the end of tuning, freeze the step size at its averaged value
    if (in_draw_idx == s.num_tune - 1) af[AF_LOG_STEP] = af[AF_LOG_STEP_BAR];
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < N_ADAPT_FLT; ++q) w.af[q] = af[q];
    }
    __syncwarp();
  }
  if (diverging) in[I_DIVERGENCE_COUNT] += 1;
  in[I_DRAW_IDX] = in_draw_idx + 1;
  const bool done = idx + 1 >= s.limit;
  in[I_DONE] = done;

  // start the next draw when the chunk is not done
  if (!done) {
    const int nidx = idx + 1;
    const size_t r = size_t(chain) * L + (nidx < 0 ? 0 : (nidx > L - 1 ? L - 1 : nidx));
    start_draw<T, NPL>(c, cfg, s, lane, w, a.mom + r * dim, a.jit[r]);
  }
}

// One chunk of draws for one chain, run by its warp: load the chain's
// state, step until its last draw of the chunk, write the state back.  The
// checkpoint rows stay in global memory and are used in place.
template <typename T, int NPL, bool ADAM>
__device__ __forceinline__ void run_chain(const WarpCtx<T>& x, int chain) {
  const MkArgs<T>& a = *x.a;
  const MkConfig& cfg = a.cfg;
  const WarpMem<T>& w = x.w;
  const int lane = x.lane;
  const int dim = cfg.dim;
  const int D = cfg.depth_slots;
  const int L = cfg.chunk_len;
  T* vrow = a.vecs + size_t(chain) * N_VEC * dim;
  T* av = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim;
  T* cp = a.ckpt_p + size_t(chain) * D * dim;
  T* cs = a.ckpt_s + size_t(chain) * D * dim;

  Chain<T> c;
#pragma unroll
  for (int k = 0; k < N_FLT; ++k) c.fl[k] = a.flts[chain * N_FLT + k];
  // F_PROP_LOGP stands for the committed F_LOGP between draws
  c.fl[F_PROP_LOGP] = c.fl[F_LOGP];
#pragma unroll
  for (int k = 0; k < N_INT; ++k) c.in[k] = a.ints[chain * N_INT + k];
  c.in[I_DONE] = 0;
  if (lane < N_ADAPT_FLT) w.af[lane] = a.adapt_flts[chain * N_ADAPT_FLT + lane];
  // each lane copies the coordinates it owns: start_draw sets every state
  // row from the committed position and gradient and the inverse mass
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    if (i >= dim) continue;
    w.row(V_PROP_Z, dim)[i] = vrow[V_POSITION * dim + i];
    w.row(V_PROP_G, dim)[i] = vrow[V_GRADIENT * dim + i];
    w.row(kRowInvMass, dim)[i] = av[A_INV_MASS * dim + i];
  }
  __syncwarp();

  StepUniforms rng(uint32_t(a.key[2 * chain]), uint32_t(a.key[2 * chain + 1]),
                   uint32_t(c.in[I_TOTAL_STEPS]));
  // every chain begins the chunk at a draw boundary
  const size_t r0 = size_t(chain) * L;
  start_draw<T, NPL>(c, cfg, x.s, lane, w, a.mom + r0 * dim, a.jit[r0]);
  do {
    machine_step<T, NPL, ADAM>(c, rng, x, chain, cp, cs, av);
  } while (!c.in[I_DONE]);

  for (int k = 0; k < N_VEC; ++k) {
    const int src = k == V_POSITION ? V_PROP_Z : (k == V_GRADIENT ? V_PROP_G : k);
#pragma unroll
    for (int r = 0; r < NPL; ++r) {
      const int i = lane + kLanes * r;
      if (i < dim) vrow[k * dim + i] = w.row(src, dim)[i];
    }
  }
  if (lane < N_ADAPT_FLT) a.adapt_flts[chain * N_ADAPT_FLT + lane] = w.af[lane];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N_FLT; ++k) {
      a.flts[chain * N_FLT + k] = c.fl[k == F_LOGP ? F_PROP_LOGP : k];
    }
#pragma unroll
    for (int k = 0; k < N_INT; ++k) a.ints[chain * N_INT + k] = c.in[k];
  }
  // the next chain's load reuses this warp's slice
  __syncwarp();
}

// The body of one block: load the model data into the block's shared
// memory `smem` (SmemPlan<T>::block_bytes bytes), then let each warp run
// chains until none is left.  Warp w of block b first takes chain
// b + gridDim.x * w, which spreads the first chains evenly over the SMs;
// after that each warp takes the next chain from the queue.
template <typename T, int NPL, bool ADAM>
__device__ __forceinline__ void megakernel_chunk_body(const MkArgs<T>& a,
                                                      unsigned char* smem) {
  const MkConfig& cfg = a.cfg;
  const SmemPlan<T> plan(cfg);
  const PartTables pt(cfg.n_counties, cfg.obs_rows);
  const int n_c = cfg.n_counties;
  const int k = n_c - 1;
  const int kp = plan.kpad;

  // the block's copy of the model data
  T* basis = reinterpret_cast<T*>(smem + plan.basis);
  T* obs = reinterpret_cast<T*>(smem + plan.obs);
  int* part = reinterpret_cast<int*>(smem + plan.part);
  for (int t = threadIdx.x; t < n_c * kp; t += blockDim.x) {
    const int row = t / kp, col = t - row * kp;
    basis[t] = col < k ? a.basis[row * k + col] : T(0);
  }
  for (int t = threadIdx.x; t < cfg.obs_rows * kLanes * 2; t += blockDim.x) obs[t] = a.obs[t];
  for (int t = threadIdx.x; t < pt.total; t += blockDim.x) part[t] = a.part[t];
  __syncthreads();  // the kernel's only block barrier

  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  unsigned char* ws = smem + plan.data_bytes + size_t(warp) * plan.warp_bytes;
  WarpCtx<T> x;
  x.a = &a;
  x.d = ModelData<T>{basis, obs, part, pt, kp};
  T* zs = reinterpret_cast<T*>(ws + plan.zs);
  T* cg = reinterpret_cast<T*>(ws + plan.cg);
  x.w = WarpMem<T>{reinterpret_cast<T*>(ws + plan.vecs),
                   reinterpret_cast<T*>(ws + plan.crf), zs, zs, cg, cg, cg,
                   reinterpret_cast<T*>(ws + plan.sc),
                   reinterpret_cast<T*>(ws + plan.af)};
  x.s = Sched{a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4], a.scal[5]};
  x.lane = lane;

  int chain = blockIdx.x + gridDim.x * warp;
  while (chain < cfg.n_chains) {
    run_chain<T, NPL, ADAM>(x, chain);
    int next = 0;
    if (lane == 0) next = atomicAdd(a.queue, 1);
    chain = gridDim.x * warps + __shfl_sync(kFullMask, next, 0);
  }
}

}  // namespace nutpie
