// Slot maps, the C ABI structs and the shared-memory plan of the NUTS chunk
// kernel.
//
// The slot enums must equal the maps in nutpie_tpu_torch/sampler/state.py
// and nutpie_tpu_torch/sampler/nuts.py (SCALAR_SLOTS); MkConfig must equal
// the ctypes structure in nutpie_tpu_torch/sampler/abi.py, and the
// radon tables the packing in nutpie_tpu_torch/models/radon.py
// (RadonKernelData.tensors).
#pragma once

#include <cstddef>
#include <cstdint>

namespace nutpie {

constexpr int kLanes = 32;

// Most chains (warps) a block holds.  The block's shared memory is the
// model data plus one slice per chain, within the card's 227 KB at radon's
// sizes.  An SM spreads a block's warps over its four sub-partitions of
// 16K registers: 16 warps get 128 registers a thread, 8 get 255.
template <typename T> struct MaxWarps;
template <> struct MaxWarps<float> { static constexpr int value = 16; };
template <> struct MaxWarps<double> { static constexpr int value = 8; };

enum VecSlot {
  V_Z_MINUS = 0, V_P_MINUS, V_G_MINUS, V_Z_PLUS, V_P_PLUS, V_G_PLUS,
  V_RHO, V_RHO_SUB, V_PROP_Z, V_PROP_G, V_SPROP_Z, V_SPROP_G,
  V_POSITION, V_GRADIENT, N_VEC
};

// The divergence-location rows after them, with store_divergences
// (StepConfig: the step kernel's instantiation that carries them).
enum DivSlot {
  V_DIV_START = N_VEC, V_DIV_START_GRAD, V_DIV_END, V_DIV_MOM, N_VEC_DIV
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

// The step-size method of AdaptConfig.method.
enum StepMethod { STEP_DUAL_AVERAGE = 0, STEP_ADAM = 1, STEP_FIXED = 2 };

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
  double adam_lr;
  double adam_beta1;
  double adam_beta2;
  double log_fixed_step;  // log of the fixed step size (STEP_FIXED)
  double target_time;     // target_integration_time (if has_target_time)
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
  int32_t step_method;        // StepMethod
  int32_t has_target_time;
  int32_t extra_doublings;    // with target_time
  int32_t store_divergences;  // 1: vecs has N_VEC_DIV rows (step kernel only)
  int32_t n_counties;
  int32_t n_obs;
  int32_t n_seg;     // segments of the lane partition
  int32_t obs_rows;  // rows of the lane-major observation table
  int32_t lr_rank;   // R of the low-rank metric, 0 for the diagonal one (step kernel)
  // the step kernel's low-rank plan (sampler/step_kernel.py:low_rank_plan):
  int32_t lr_streamed;  // 1: the basis streams through a ring; 0: staged whole
  int32_t lr_tma;       // 1: tiles arrive by bulk copy; 0: by the warps' loads
  int32_t lr_grid;      // persistent blocks of a launch
  // the step kernel's diagonal plan (sampler/step_kernel.py:diag_plan):
  int32_t step_lanes;  // lanes a chain: 8, 16 or 32
  int32_t step_vec;    // coordinates a chunk, moved by one load or store
  int32_t step_held;   // chunks a thread holds in registers (0: any number)
  int32_t step_grid;   // blocks of a launch
  int32_t micro;       // 1: the microcanonical kinetic (the step kernel's MICRO instantiations)
  int32_t fixed_metric;  // 1: the inverse mass is never re-estimated (flow adaptation)
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
  const T* obs;            // [obs_rows, 32, 2] (y, floor), lane-major
  const T* basis;          // [n_counties, n_counties - 1]
  const int32_t* part;     // lane partition tables (PartTables)
  int32_t* queue;          // chain counter, zero at launch
};

struct Sched {
  int chunk_start, limit, num_tune, early_end, freeze_start, depth_cap;
};

// Rows of a chain's slice of shared memory: the state rows V_Z_MINUS ..
// V_SPROP_G, then the inverse mass.  The committed position and gradient
// equal the proposal's at every draw boundary, so the proposal rows stand
// for them and the two state rows are written from them at the end.
constexpr int kRowInvMass = V_POSITION;
constexpr int kWarpRows = kRowInvMass + 1;

// Offsets (in int32) of the lane partition tables inside `part`:
//   lane_obs[33]  first sorted observation of each lane (and the end)
//   lane_seg[32]  first segment of each lane
//   county_seg[n_counties + 1]  CSR of each county's segments
//   obs_info[obs_rows, 32]  lane-major, each observation's county, plus
//                           kSegStart if it opens a segment
struct PartTables {
  int lane_obs, lane_seg, county_seg, obs_info, total;
  PartTables() = default;
  __host__ __device__ PartTables(int n_counties, int obs_rows) {
    lane_obs = 0;
    lane_seg = lane_obs + kLanes + 1;
    county_seg = lane_seg + kLanes;
    obs_info = county_seg + n_counties + 1;
    total = obs_info + obs_rows * kLanes;
  }
};

constexpr int kSegStart = 1 << 16;

// Row stride of the basis in shared memory: a multiple of 4 values whose
// quarter is odd, so that 8 lanes reading 4 values each of 8 consecutive
// rows hit 32 distinct banks (float32).
__host__ __device__ inline int basis_stride(int k) {
  int s = (k + 3) / 4 * 4;
  if ((s / 4) % 2 == 0) s += 4;
  return s;
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Shared memory of a block: the model data, loaded once per block and read
// by all its warps, then one slice per warp (chain).  Offsets in bytes.
// Two scratch areas of the slice each serve several rows in turn (radon.cuh
// orders their uses): `zs` holds the zero-sum coordinates, then the
// segment sums; `cg` the county effects, then the gradient weights, then
// the zero-sum gradient sums.
template <typename T>
struct SmemPlan {
  int kpad;
  size_t basis, obs, part, data_bytes;
  // within a warp's slice
  size_t vecs, crf, zs, cg, sc, af, warp_bytes;

  __host__ __device__ explicit SmemPlan(const MkConfig& c) {
    const int n_c = c.n_counties;
    kpad = basis_stride(n_c - 1);
    const size_t zs_n = 2 * size_t(kpad > c.n_seg ? kpad : c.n_seg);
    const size_t cg_n = 2 * size_t(kpad > n_c ? kpad : n_c);
    size_t o = 0;
    basis = o; o = align16(o + sizeof(T) * size_t(n_c) * kpad);
    obs = o;   o = align16(o + sizeof(T) * size_t(c.obs_rows) * kLanes * 2);
    part = o;  o = align16(o + sizeof(int32_t) * PartTables(n_c, c.obs_rows).total);
    data_bytes = o;
    o = 0;
    vecs = o;   o = align16(o + sizeof(T) * size_t(kWarpRows) * c.dim);
    crf = o;    o = align16(o + sizeof(T) * 2 * size_t(n_c));
    zs = o;     o = align16(o + sizeof(T) * zs_n);
    cg = o;     o = align16(o + sizeof(T) * cg_n);
    sc = o;     o = align16(o + sizeof(T) * 8);
    af = o;     o = align16(o + sizeof(T) * N_ADAPT_FLT);
    warp_bytes = o;
  }

  __host__ __device__ size_t block_bytes(int warps) const {
    return data_bytes + size_t(warps) * warp_bytes;
  }
};

}  // namespace nutpie
