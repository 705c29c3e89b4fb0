// Slot maps, the C ABI structs and the per-block shared-memory layout of
// the NUTS chunk kernel.
//
// The slot enums must equal the maps in nutpie_tpu_torch/sampler/state.py
// and nutpie_tpu_torch/sampler/nuts.py (SCALAR_SLOTS); MkConfig must equal
// the ctypes structure in nutpie_tpu_torch/sampler/megakernel.py.
#pragma once

#include <cstddef>
#include <cstdint>

namespace nutpie {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0, "block size must be a multiple of a warp");

enum VecSlot {
  V_Z_MINUS = 0, V_P_MINUS, V_G_MINUS, V_Z_PLUS, V_P_PLUS, V_G_PLUS,
  V_RHO, V_RHO_SUB, V_PROP_Z, V_PROP_G, V_SPROP_Z, V_SPROP_G,
  V_POSITION, V_GRADIENT, N_VEC
};

enum FltSlot {
  F_LOGP = 0, F_EPS, F_H0, F_LOGW_TRAJ, F_PROP_LOGP, F_PROP_ENERGY,
  F_LOGW_SUB, F_SPROP_LOGP, F_SPROP_ENERGY, F_SUM_ACC, F_KE_MINUS,
  F_KE_PLUS, N_FLT
};

enum IntSlot {
  I_DRAW_IDX = 0, I_PROP_IDX, I_DEPTH, I_DIRECTION, I_LEFT_IDX, I_RIGHT_IDX,
  I_N_LEAVES, I_N_LEAF, I_SPROP_IDX, I_CKPT_TOP, I_TOTAL_STEPS,
  I_DIVERGENCE_COUNT, I_DIVERGING, I_TURNING_SUB, I_DONE, N_INT
};

enum AdaptVecSlot {
  A_INV_MASS = 0, A_DRAWS_CUR_MEAN, A_DRAWS_CUR_M2, A_GRADS_CUR_MEAN,
  A_GRADS_CUR_M2, A_DRAWS_BG_MEAN, A_DRAWS_BG_M2, A_GRADS_BG_MEAN,
  A_GRADS_BG_M2, N_ADAPT_VEC
};

enum AdaptFltSlot {
  AF_LOG_STEP = 0, AF_LOG_STEP_BAR, AF_HBAR, AF_MU, AF_DA_COUNT, AF_ADAM_M,
  AF_ADAM_V, AF_ADAM_COUNT, AF_DRAWS_CUR_COUNT, AF_GRADS_CUR_COUNT,
  AF_DRAWS_BG_COUNT, AF_GRADS_BG_COUNT, N_ADAPT_FLT
};

enum ScalarSlot {
  S_LOGP = 0, S_ENERGY, S_DEPTH, S_MAXDEPTH_REACHED, S_DIVERGING,
  S_STEP_SIZE, S_STEP_SIZE_BAR, S_N_STEPS, S_MEAN_TREE_ACCEPT,
  S_INDEX_IN_TRAJECTORY, S_FISHER_DISTANCE, N_SCALAR = 12
};

// Static configuration: NutsConfig, AdaptConfig and the radon data sizes.
struct MkConfig {
  double max_energy_error;
  double step_size_jitter;
  double target_accept;
  double gamma;
  double t0;
  double kappa;
  double max_step_size;
  double min_variance;
  double max_variance;
  int32_t n_chains;
  int32_t dim;
  int32_t depth_slots;  // D = max(maxdepth, 2)
  int32_t chunk_len;
  int32_t maxdepth;
  int32_t mindepth;
  int32_t check_turning;
  int32_t adapt_frozen;
  int32_t use_grad_based_estimate;
  int32_t has_jitter;
  int32_t switch_freq;
  int32_t early_switch_freq;
  int32_t n_counties;
  int32_t n_obs;
};

// Device pointers of one launch.  State tensors are updated in place.
template <typename T>
struct MkArgs {
  MkConfig cfg;
  // chunk_start, limit, num_tune, early_end, freeze_start, depth_cap
  const int32_t* scal;
  const int64_t* key;      // [C, 2] raw Threefry key data
  T* vecs;                 // [C, N_VEC, dim]
  T* ckpt_p;               // [C, D, dim]
  T* ckpt_s;               // [C, D, dim]
  T* flts;                 // [C, N_FLT]
  int32_t* ints;           // [C, N_INT]
  T* adapt_vecs;           // [C, N_ADAPT_VEC, dim]
  T* adapt_flts;           // [C, N_ADAPT_FLT]
  const T* mom;            // [C, L, dim] momentum normals per draw
  const T* jit;            // [C, L] jitter uniforms per draw
  T* pos_out;              // [C, L, dim]
  T* scal_out;             // [C, L, N_SCALAR]
  const T* y;              // [n_obs] sorted by county
  const T* floor;          // [n_obs] sorted by county
  const T* basis;          // [n_counties, n_counties - 1]
  const int32_t* offsets;  // [n_counties + 1] CSR offsets
};

struct Sched {
  int chunk_start, limit, num_tune, early_end, freeze_start, depth_cap;
};

// Block-wide scalars broadcast through shared memory.
enum CtlInt {
  C_ACTIVE = 0, C_FWD, C_AT_START, C_M_TAKE, C_PUSH, C_TOP, C_TOP_AFTER,
  C_TZ, C_EVEN, C_MERGE_OK, C_M_TAKE2, C_DRAW_DONE, C_NEXT_DOUBLING,
  C_RESTART, C_IDX_C, C_NEXT_IDX_C, C_UPD, C_DIVERGING, C_DIV_LEAF,
  C_TURN_SUB_MID, C_SUB_DONE, C_SUB_INVALID, C_TOP_NEW, N_CTL_INT = 32
};

enum CtlFlt {
  X_EPS_S = 0, X_LOGP_NEW, X_H, X_LOGW_SUB_NEW, X_U1, X_U2, X_ACCEPT,
  X_RATIO, N_CTL_FLT = 16
};

constexpr int kRed = 8;  // values per block reduction

// Shared memory of one block (one chain).  All [dim] rows of the chain's
// state stay here for the whole chunk; each thread owns coordinates
// threadIdx.x, threadIdx.x + kThreads, ... of every row.
template <typename T>
struct Block {
  T* vecs;     // [N_VEC, dim]
  T* ckpt_p;   // [D, dim]
  T* ckpt_s;   // [D, dim]
  T* av;       // [N_ADAPT_VEC, dim]
  T* z_new;    // [dim] leapfrog scratch rows
  T* p_new;
  T* g_new;
  T* v_new;
  T* rsn;      // rho_sub + p_new
  T* county;   // [4, n_counties] model scratch
  T* red;      // [kWarps, kRed]
  T* fl;       // [N_FLT]
  T* af;       // [N_ADAPT_FLT]
  T* cf;       // [N_CTL_FLT]
  int* in;     // [N_INT]
  int* ci;     // [N_CTL_INT]
  int dim;
  int D;

  __device__ T* row(int slot) const { return vecs + slot * dim; }
  __device__ T* arow(int slot) const { return av + slot * dim; }
};

template <typename T>
inline size_t block_smem_bytes(int dim, int D, int n_counties) {
  const size_t n_t = size_t(N_VEC + 2 * D + N_ADAPT_VEC + 5) * dim
      + 4 * size_t(n_counties) + kWarps * kRed + N_FLT + N_ADAPT_FLT
      + N_CTL_FLT;
  return n_t * sizeof(T) + (size_t(N_INT) + size_t(N_CTL_INT)) * sizeof(int);
}

template <typename T>
__device__ inline Block<T> carve_block(unsigned char* smem, int dim, int D,
                                       int n_counties) {
  Block<T> b;
  T* p = reinterpret_cast<T*>(smem);
  b.dim = dim;
  b.D = D;
  b.vecs = p;   p += N_VEC * dim;
  b.ckpt_p = p; p += D * dim;
  b.ckpt_s = p; p += D * dim;
  b.av = p;     p += N_ADAPT_VEC * dim;
  b.z_new = p;  p += dim;
  b.p_new = p;  p += dim;
  b.g_new = p;  p += dim;
  b.v_new = p;  p += dim;
  b.rsn = p;    p += dim;
  b.county = p; p += 4 * n_counties;
  b.red = p;    p += kWarps * kRed;
  b.fl = p;     p += N_FLT;
  b.af = p;     p += N_ADAPT_FLT;
  b.cf = p;     p += N_CTL_FLT;
  int* q = reinterpret_cast<int*>(p);
  b.in = q;     q += N_INT;
  b.ci = q;
  return b;
}

}  // namespace nutpie
