// NUTS step kernel (K2) for Hopper (sm_90a): the machine step around a
// batched log density, as two launches per step.
//
// Replaces the body of the JAX package's XLA chunk loop
// (nutpie_tpu/sampler/run.py:make_chunk_runner, :432-440: the vmapped
// machine_step with the model's logp inside).  It is not a port of a
// Pallas kernel.  Any model with a batched torch log density runs through
// it: step_begin computes, for every chain, the step's uniforms, the
// direction, the slot-(D-1) momentum stash, the first half-kick and the
// drift, and writes z_new; the caller evaluates logp and gradient at
// z_new for all chains in one torch call; step_finish takes the second
// half-kick and does the rest of the step (leaf, multinomial choice,
// checkpoint stack and U-turn checks, merge, draw completion with its
// commit, per-draw adaptation and next start_draw).  Same semantics as
// leapfrog_begin / leapfrog_finish in nutpie_tpu_torch/sampler/nuts.py.
//
// What bounds it on this card: bytes.  A step reads and writes a few of a
// chain's [dim] rows (the edge, rho_sub, the inverse mass, z_new and the
// gradient; the checkpoint slots a U-turn check reads; the proposal and
// adaptation rows at a draw's end) and does a handful of operations per
// coordinate on them, far below the card's 67 operations per byte in
// float32.  chip_smoke.py counts the bytes from this code for each run's
// trees (step_bytes).
//
// The step body is written once against a thread group (group.cuh) and
// instantiated twice:
//   - the diagonal metric (LR = false): one warp per chain (WarpGroup),
//     four chains per block, lanes striding over the coordinates (any
//     dim), neighbouring lanes on neighbouring addresses;
//   - the low-rank metric (LR = true, taken when the wrapper passes a
//     metric of rank R > 0): a block of kLrWarps warps per chain
//     (BlockGroup), the blocks persistent, each running every gridDim.x-th
//     chain in turn.  It replaces every product inv_mass * p by the
//     low-rank metric's velocity and the momentum of a new draw by its
//     M^{1/2} z (lowrank.cuh).  Its bytes are the chain's [dim, R] basis:
//     128 KB in float32 at dim 1000, R 32, against about 40 KB of rows a
//     step.  So the block stages the basis in shared memory by TMA bulk
//     copies once per launch where it fits (or streams it through a ring
//     of tiles twice per application where it does not:
//     sampler/step_kernel.py:low_rank_plan decides), and sends the next
//     chain's basis on its way as soon as a chain's last pass is done; the
//     block's 256 threads share every coordinate loop.  With one block
//     (8 warps) an SM little latency hides behind other warps, so the
//     products are laid out for independent instructions (lowrank.cuh).
//     The branch applies the metric only where a momentum is new: the
//     drift in step_begin, the new point's velocity in step_finish, and
//     the momentum and kinetic energy of the next draw.
//     The metric is fixed within a draw, so every other velocity the
//     U-turn checks need is one of those, kept where its momentum is kept:
//     the two trajectory edges' in `edge_v` (the new point's is written
//     there), each checkpoint's in `ckpt_v` beside `ckpt_p` (pushed from the
//     new point's, the slot-(D-1) stash from its edge's).  A kept velocity
//     is bitwise the one the same arithmetic would compute again.
//
// Every row stays in device memory and is updated in place; each launch
// loads only the rows its half touches, and a thread owns the same
// coordinates in every loop.  The scalars of a chain are loaded into
// registers in every thread, every decision is computed in every thread
// from the same values and the same reductions (group.cuh), so no thread
// waits for another to decide, and one thread writes the scalars back.  A
// done chain hands the log density its committed position and is
// otherwise left alone (its block stages nothing).  The step's uniforms
// come from the in-kernel Threefry (threefry.cuh), bit-equal to
// leapfrog_uniforms; the adaptation is adapt.cuh's arithmetic in its
// strided form.  It is built without FMA contraction (ops/build.py), so it
// rounds as the plain version does.
#include <cuda_runtime.h>

#include "adapt.cuh"
#include "group.cuh"
#include "lowrank.cuh"
#include "threefry.cuh"
#include "warp.cuh"

namespace nutpie {

// chains (warps) per block of the diagonal instantiations
constexpr int kStepWarps = WarpGroup::kChainsPerBlock;
constexpr int kStepThreads = WarpGroup::kBlockThreads;
constexpr int kLrThreads = BlockGroup<kLrWarps>::kBlockThreads;
// One block per SM at least: with the thread count alone the compiler
// capped a finish's registers low enough to spill.
constexpr int kStepMinBlocks = 1;

template <bool LR>
struct StepGroup {
  using type = WarpGroup;
};
template <>
struct StepGroup<true> {
  using type = BlockGroup<kLrWarps>;
};

// the low-rank block's dynamic shared memory (LrLayout)
extern __shared__ __align__(128) unsigned char step_smem[];

// Device pointers of one launch, as the wrapper passes them (step_kernel.py
// StepPtrs).  The state tensors are updated in place.
struct StepPtrs {
  const int32_t* scal;   // chunk_start, limit, num_tune, early_end, freeze_start, depth_cap
  const int64_t* key;    // [C, 2] raw Threefry key data
  void* vecs;            // [C, N_VEC, dim]
  void* ckpt_p;          // [C, D, dim]
  void* ckpt_s;          // [C, D, dim]
  void* flts;            // [C, N_FLT]
  int32_t* ints;         // [C, N_INT]
  void* adapt_vecs;      // [C, N_ADAPT_VEC, dim]
  void* adapt_flts;      // [C, N_ADAPT_FLT]
  const void* mom;       // [C, L, dim] momentum normals per draw
  const void* jit;       // [C, L] jitter uniforms per draw
  void* pos_out;         // [C, L, dim]
  void* scal_out;        // [C, L, N_SCALAR]
  void* z_new;           // [C, dim] the point handed to the log density
  float* u3;             // [C, 3] the step's uniforms (begin -> finish)
  int32_t* stagnant;     // [C] the step left the position unchanged
  const void* logp;      // [C] log density at z_new
  const void* grad;      // [C, dim] its gradient
  const void* lr_basis;     // [C, dim, R] the low-rank metric's basis (R > 0)
  const void* lr_log_eigs;  // [C, R] its log eigenvalues
  void* edge_v;             // [C, 2, dim] velocities of p_minus, p_plus (R > 0)
  void* ckpt_v;             // [C, D, dim] velocities of the ckpt_p rows (R > 0)
  void* grad_out;           // [C, L, dim] the draws' gradients, or null
  void* minv_out;           // [C, L, dim] the draws' inverse mass, or null
  void* eig_out;            // [C, L, R] the draws' metric eigenvalues, or null
};

template <typename T>
__host__ __device__ inline LrLayout lr_layout(const MkConfig& c) {
  return LrLayout(c.dim, c.lr_rank, int(sizeof(T)), c.lr_streamed != 0);
}

template <typename T>
struct StepArgs {
  MkConfig cfg;
  const int32_t* scal;
  const int64_t* key;
  T* vecs;
  T* ckpt_p;
  T* ckpt_s;
  T* flts;
  int32_t* ints;
  T* adapt_vecs;
  T* adapt_flts;
  const T* mom;
  const T* jit;
  T* pos_out;
  T* scal_out;
  T* z_new;
  float* u3;
  int32_t* stagnant;
  const T* logp;
  const T* grad;
  const T* lr_basis;
  const T* lr_log_eigs;
  T* edge_v;
  T* ckpt_v;
  T* grad_out;
  T* minv_out;
  T* eig_out;

  StepArgs(const MkConfig& c, const StepPtrs& p)
      : cfg(c), scal(p.scal), key(p.key), vecs(static_cast<T*>(p.vecs)),
        ckpt_p(static_cast<T*>(p.ckpt_p)), ckpt_s(static_cast<T*>(p.ckpt_s)),
        flts(static_cast<T*>(p.flts)), ints(p.ints),
        adapt_vecs(static_cast<T*>(p.adapt_vecs)),
        adapt_flts(static_cast<T*>(p.adapt_flts)),
        mom(static_cast<const T*>(p.mom)), jit(static_cast<const T*>(p.jit)),
        pos_out(static_cast<T*>(p.pos_out)), scal_out(static_cast<T*>(p.scal_out)),
        z_new(static_cast<T*>(p.z_new)), u3(p.u3), stagnant(p.stagnant),
        logp(static_cast<const T*>(p.logp)), grad(static_cast<const T*>(p.grad)),
        lr_basis(static_cast<const T*>(p.lr_basis)),
        lr_log_eigs(static_cast<const T*>(p.lr_log_eigs)),
        edge_v(static_cast<T*>(p.edge_v)), ckpt_v(static_cast<T*>(p.ckpt_v)),
        grad_out(static_cast<T*>(p.grad_out)), minv_out(static_cast<T*>(p.minv_out)),
        eig_out(static_cast<T*>(p.eig_out)) {}

  // The block's view of the low-rank metric (its barriers initialized).
  template <typename G>
  __device__ __forceinline__ LowRank<T> metric(const G& g) const {
    return LowRank<T>(cfg, lr_basis, lr_log_eigs, step_smem, lr_layout<T>(cfg), g.warp(),
                      g.lane());
  }
};

// The first chain after `chain` in the block's order (every gridDim.x-th)
// that is not done, among the next 32; -1 if none.  Every warp reads the
// same flags, so every thread gets the same chain.
__device__ __forceinline__ int next_active(const int32_t* ints, int chain, int n_chains,
                                           int lane) {
  const int stride = int(gridDim.x);
  const int cand = chain + (lane + 1) * stride;
  const bool active = cand < n_chains && ints[size_t(cand) * N_INT + I_DONE] == 0;
  const unsigned ahead = __ballot_sync(kFullMask, active);
  return ahead ? chain + __ffs(ahead) * stride : -1;
}

template <typename T, bool LR>
__device__ __forceinline__ typename StepGroup<LR>::type make_group(const MkConfig& cfg) {
  if constexpr (LR) {
    return BlockGroup<kLrWarps>(step_smem + lr_layout<T>(cfg).red);
  } else {
    return WarpGroup();
  }
}

// A new draw's trajectory rows at coordinate i: every edge, the proposals
// and rho from the committed position, gradient and momentum p0.
template <typename T>
__device__ __forceinline__ void reset_rows(T* v, int dim, int i, T p0) {
  const T z = v[V_POSITION * dim + i];
  const T g = v[V_GRADIENT * dim + i];
  v[V_Z_MINUS * dim + i] = z;
  v[V_P_MINUS * dim + i] = p0;
  v[V_G_MINUS * dim + i] = g;
  v[V_Z_PLUS * dim + i] = z;
  v[V_P_PLUS * dim + i] = p0;
  v[V_G_PLUS * dim + i] = g;
  v[V_RHO * dim + i] = p0;
  v[V_RHO_SUB * dim + i] = T(0);
  v[V_PROP_Z * dim + i] = z;
  v[V_PROP_G * dim + i] = g;
  v[V_SPROP_Z * dim + i] = z;
  v[V_SPROP_G * dim + i] = g;
}

// Refresh momentum and reset the trajectory for a new draw (start_draw in
// nuts.py): every state row from the committed position and gradient.
// Low-rank: p0 = (z + U c) / s (its coefficients in a first pass over the
// basis), whose velocity coefficients the second pass gathers while it
// writes the rows, and in a third the velocity v(p0), kept for both edges
// (ev), and the kinetic energy p0 . v(p0).
template <typename T, bool LR, typename G>
__device__ __forceinline__ void start_draw_strided(const G& g, T* fl, int* in,
                                                   const MkConfig& cfg,
                                                   const Sched& s, T* v, const T* im,
                                                   const T* af, const T* gauss,
                                                   T jitter_u, LowRank<T>& m, T* ev) {
  const int dim = cfg.dim;
  T ke[1] = {T(0)};
  if constexpr (LR) {
    // staged, the tiles may be receiving the next chain's basis: this
    // chain's is staged again, and the next one's set out again after
    const int lane = g.lane();
    T acc[kHalf] = {};
    m.use(m.chain);
    m.rewind();
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      m.project(m.tile(t), t, i < dim ? gauss[i] : T(0), acc);
      m.release(t);
    }
    m.rewind();
    m.set_coefficients(g, acc, m.momentum_factor());
#pragma unroll
    for (int k = 0; k < kHalf; ++k) acc[k] = T(0);
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      const T* u = m.tile(t);
      const T uc = m.expand(u, t, i);
      T wi = T(0);
      if (i < dim) {
        const T si = sqrt(im[i]);
        const T p0 = (gauss[i] + uc) / si;
        reset_rows(v, dim, i, p0);
        wi = si * p0;
      }
      m.project(u, t, wi, acc);
      m.release(t);
    }
    m.rewind();
    m.set_coefficients(g, acc, m.velocity_factor());
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      const T uc = m.expand(m.tile(t), t, i);
      m.release(t);
      if (i < dim) {
        const T si = sqrt(im[i]);
        const T p0 = v[V_P_MINUS * dim + i];
        const T vi = si * (si * p0 + uc);
        ev[i] = vi;
        ev[dim + i] = vi;
        ke[0] += p0 * vi;
      }
    }
    m.prefetch();
  } else {
    for (int i = g.rank; i < dim; i += G::kThreads) {
      const T mi = im[i];
      const T p0 = gauss[i] / sqrt(mi);
      ke[0] += p0 * (mi * p0);
      reset_rows(v, dim, i, p0);
    }
  }
  g.sum(ke);
  const bool tuning = in[I_DRAW_IDX] < s.num_tune;
  T eps = exp(tuning ? af[AF_LOG_STEP] : af[AF_LOG_STEP_BAR]);
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

// The step up to the log density (leapfrog_begin in nuts.py) of one chain.
template <typename T, bool LR, typename G>
__device__ __forceinline__ void begin_chain(const StepArgs<T>& a, int chain, const G& g,
                                            LowRank<T>& m) {
  const MkConfig& cfg = a.cfg;
  const int lane = g.lane();
  const int dim = cfg.dim;
  const int D = cfg.depth_slots;
  const int32_t* in = a.ints + size_t(chain) * N_INT;
  const T* v = a.vecs + size_t(chain) * N_VEC * dim;
  T* zn = a.z_new + size_t(chain) * dim;
  const bool done = in[I_DONE];
  int next = -1;
  if constexpr (LR) next = next_active(a.ints, chain, cfg.n_chains, lane);
  if (done) {
    // a done chain hands the log density its committed position (finite)
    for (int i = g.rank; i < dim; i += G::kThreads) zn[i] = v[V_POSITION * dim + i];
    return;
  }
  // the basis sets out for shared memory (unless it is on its way) before
  // anything else is read
  if constexpr (LR) m.begin_chain(chain, next);
  const int total_steps = in[I_TOTAL_STEPS];
  const bool at_start = in[I_N_LEAF] == 0;
  const int old_direction = in[I_DIRECTION];

  // uniform(fold_in(fold_in(key, 3), total_steps), (3,)): lane l < 3 of
  // each warp hashes element l
  float u = 0.0f;
  if (lane < 3) {
    uint32_t k1 = uint32_t(a.key[2 * chain]), k2 = uint32_t(a.key[2 * chain + 1]);
    fold_in(k1, k2, 3u);
    fold_in(k1, k2, uint32_t(total_steps));
    u = uniform3_element(k1, k2, uint32_t(lane));
    if (g.rank < 3) a.u3[3 * size_t(chain) + lane] = u;
  }
  const float u0 = __shfl_sync(kFullMask, u, 0);
  const int direction = at_start ? (T(u0) < T(0.5) ? -1 : 1) : old_direction;
  const bool fwd = direction > 0;
  const T eps_s = T(direction) * a.flts[size_t(chain) * N_FLT + F_EPS];
  const T half_eps = T(0.5) * eps_s;
  const T* ze = v + (fwd ? V_Z_PLUS : V_Z_MINUS) * dim;
  const T* pe = v + (fwd ? V_P_PLUS : V_P_MINUS) * dim;
  const T* ge = v + (fwd ? V_G_PLUS : V_G_MINUS) * dim;
  const T* im = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim + A_INV_MASS * dim;
  // slot D-1 stashes the old edge momentum for the cross U-turn checks
  T* stash = a.ckpt_p + (size_t(chain) * D + (D - 1)) * dim;
  bool moved = false;
  if constexpr (LR) {
    // the drift's velocity: its coefficients from w = s * p_half, then
    // z_new = z_e + eps * s (w + U c); the stash keeps its edge's velocity
    const T* ev = a.edge_v + (size_t(chain) * 2 + (fwd ? 1 : 0)) * dim;
    T* stash_v = a.ckpt_v + (size_t(chain) * D + (D - 1)) * dim;
    T acc[kHalf] = {};
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      T wi = T(0);
      if (i < dim) {
        const T p_e = pe[i];
        if (at_start) {
          stash[i] = p_e;
          stash_v[i] = ev[i];
        }
        wi = sqrt(im[i]) * (p_e + half_eps * ge[i]);
      }
      m.project(m.tile(t), t, wi, acc);
      m.release(t);
    }
    m.rewind();
    m.set_coefficients(g, acc, m.velocity_factor());
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      const T uc = m.expand(m.tile(t), t, i);
      m.release(t);
      if (i < dim) {
        const T si = sqrt(im[i]);
        const T p_half = pe[i] + half_eps * ge[i];
        const T z_e = ze[i];
        const T z = z_e + eps_s * (si * (si * p_half + uc));
        zn[i] = z;
        moved = moved || (z != z_e);
      }
    }
    m.prefetch();
  } else {
    for (int i = g.rank; i < dim; i += G::kThreads) {
      const T p_e = pe[i];
      if (at_start) stash[i] = p_e;
      const T z_e = ze[i];
      const T p_half = p_e + half_eps * ge[i];
      const T z = z_e + eps_s * (im[i] * p_half);
      zn[i] = z;
      moved = moved || (z != z_e);
    }
  }
  // an unintegrable step (eps below the position's resolution) is a
  // divergence; finish reads the flag
  const bool stagnant = !g.any(moved);
  if (g.leader()) {
    a.stagnant[chain] = stagnant;
    a.ints[size_t(chain) * N_INT + I_DIRECTION] = direction;
  }
}

// The diagonal instantiation runs one chain per warp; the low-rank one runs
// persistent blocks, block b the chains b, b + gridDim.x, ... in turn.
template <typename T, bool LR>
__global__ void __launch_bounds__(StepGroup<LR>::type::kBlockThreads, kStepMinBlocks)
    step_begin(StepArgs<T> a) {
  using G = typename StepGroup<LR>::type;
  const G g = make_group<T, LR>(a.cfg);
  if constexpr (LR) {
    LowRank<T> m = a.metric(g);
    for (int chain = blockIdx.x; chain < a.cfg.n_chains; chain += gridDim.x) {
      begin_chain<T, true>(a, chain, g, m);
    }
  } else {
    const int chain = G::chain();
    if (chain >= a.cfg.n_chains) return;  // the whole warp
    LowRank<T> m;
    begin_chain<T, false>(a, chain, g, m);
  }
}

// The step after the log density (leapfrog_finish in nuts.py) of one
// chain.
template <typename T, bool LR, typename G>
__device__ __forceinline__ void finish_chain(const StepArgs<T>& a, int chain, const G& g,
                                             LowRank<T>& m) {
  const MkConfig& cfg = a.cfg;
  const int dim = cfg.dim;
  const int D = cfg.depth_slots;
  const int L = cfg.chunk_len;
  T fl[N_FLT];
  int in[N_INT];
#pragma unroll
  for (int k = 0; k < N_INT; ++k) in[k] = a.ints[size_t(chain) * N_INT + k];
  int next = -1;
  if constexpr (LR) next = next_active(a.ints, chain, cfg.n_chains, g.lane());
  if (in[I_DONE]) return;
  // the low-rank branch's basis sets out for shared memory (unless it is on
  // its way)
  if constexpr (LR) m.begin_chain(chain, next);
#pragma unroll
  for (int k = 0; k < N_FLT; ++k) fl[k] = a.flts[size_t(chain) * N_FLT + k];
  T af[N_ADAPT_FLT];
#pragma unroll
  for (int k = 0; k < N_ADAPT_FLT; ++k) af[k] = a.adapt_flts[size_t(chain) * N_ADAPT_FLT + k];
  const Sched s{a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4], a.scal[5]};

  T* v = a.vecs + size_t(chain) * N_VEC * dim;
  T* av = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim;
  const T* im = av + A_INV_MASS * dim;
  T* cp = a.ckpt_p + size_t(chain) * D * dim;
  T* cs = a.ckpt_s + size_t(chain) * D * dim;
  const T* zn = a.z_new + size_t(chain) * dim;
  const T* gn = a.grad + size_t(chain) * dim;
  const T logp_new = a.logp[chain];
  const T u1 = T(a.u3[3 * size_t(chain) + 1]);
  const T u2 = T(a.u3[3 * size_t(chain) + 2]);
  const bool stagnant = a.stagnant[chain] != 0;
  // the low-rank branch's kept velocities
  T* ev = a.edge_v + size_t(chain) * 2 * dim;  // p_minus's, then p_plus's
  T* cv = a.ckpt_v + size_t(chain) * D * dim;  // each ckpt_p row's

  const int direction = in[I_DIRECTION];  // begin's choice
  const bool fwd = direction > 0;
  const T eps_s = T(direction) * fl[F_EPS];
  const T half_eps = T(0.5) * eps_s;
  T* ze = v + (fwd ? V_Z_PLUS : V_Z_MINUS) * dim;
  T* pe = v + (fwd ? V_P_PLUS : V_P_MINUS) * dim;
  T* ge = v + (fwd ? V_G_PLUS : V_G_MINUS) * dim;
  const T* p_far = v + (fwd ? V_P_MINUS : V_P_PLUS) * dim;
  T* rho_sub = v + V_RHO_SUB * dim;
  T* sz = v + V_SPROP_Z * dim;
  T* sg = v + V_SPROP_G * dim;
  T* ve = ev + (fwd ? 1 : 0) * dim;        // LR: the new point's velocity
  const T* v_far = ev + (fwd ? 0 : 1) * dim;

  // ---------------------------------------------- second half-kick; the
  // extended edge becomes the new point
  T ke[1] = {T(0)};
  if constexpr (LR) {
    // v_new = s (w + U c), w = s p_new, kept as the edge's velocity
    const int lane = g.lane();
    T acc[kHalf] = {};
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      T wi = T(0);
      if (i < dim) {
        const T p_half = pe[i] + half_eps * ge[i];
        const T gi = gn[i];
        const T p = p_half + half_eps * gi;
        ze[i] = zn[i];
        pe[i] = p;
        ge[i] = gi;
        wi = sqrt(im[i]) * p;
      }
      m.project(m.tile(t), t, wi, acc);
      m.release(t);
    }
    m.rewind();
    m.set_coefficients(g, acc, m.velocity_factor());
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      const T uc = m.expand(m.tile(t), t, i);
      m.release(t);
      if (i < dim) {
        const T si = sqrt(im[i]);
        const T p = pe[i];
        const T vn = si * (si * p + uc);
        ve[i] = vn;
        ke[0] += p * vn;
      }
    }
    m.prefetch();
  } else {
    for (int i = g.rank; i < dim; i += G::kThreads) {
      const T p_half = pe[i] + half_eps * ge[i];
      const T gi = gn[i];
      const T p = p_half + half_eps * gi;
      ke[0] += p * (im[i] * p);
      ze[i] = zn[i];
      pe[i] = p;
      ge[i] = gi;
    }
  }
  g.sum(ke);

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
  const bool m_take = log(u1) < dl && !(dl != dl);
  if (m_take) {
    fl[F_SPROP_LOGP] = logp_new;
    fl[F_SPROP_ENERGY] = h;
    in[I_SPROP_IDX] = abs_idx;
  }
  // checkpoint stack: push at odd leaves, check+pop at even leaves
  const bool odd = (n % 2) == 1;
  const int top = in[I_CKPT_TOP];
  const int top_c = top < 0 ? 0 : (top > D - 1 ? D - 1 : top);
  const int top_after = odd ? top + 1 : top;
  const int tz = __ffs(n) - 1;
  for (int i = g.rank; i < dim; i += G::kThreads) {
    const T p = pe[i];
    const T rs = rho_sub[i];
    if (m_take) {
      sz[i] = zn[i];
      sg[i] = gn[i];
    }
    if (odd) {
      cp[top_c * dim + i] = p;
      cs[top_c * dim + i] = rs;
      if constexpr (LR) cv[top_c * dim + i] = ve[i];
    }
    rho_sub[i] = rs + p;  // rho_sub + p_new, reset below at a doubling
  }
  // subtree U-turn checks against the top tz checkpoints
  bool turning_here = false;
  if (cfg.check_turning && !odd) {
    const int lo = top_after - tz > 0 ? top_after - tz : 0;
    for (int slot = lo; slot < top_after && slot < D; ++slot) {
      T dots[2] = {T(0), T(0)};
      if constexpr (LR) {
        const T* cvs = cv + slot * dim;
        for (int i = g.rank; i < dim; i += G::kThreads) {
          const T rho_ab = rho_sub[i] - cs[slot * dim + i];
          dots[0] += rho_ab * cvs[i];
          dots[1] += rho_ab * ve[i];
        }
      } else {
        const T* cps = cp + slot * dim;
        for (int i = g.rank; i < dim; i += G::kThreads) {
          const T mi = im[i];
          const T rho_ab = rho_sub[i] - cs[slot * dim + i];
          dots[0] += rho_ab * (cps[i] * mi);
          dots[1] += rho_ab * (mi * pe[i]);
        }
      }
      g.sum(dots);
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
  const bool take2 = log(u2) < log_ratio && !(log_ratio != log_ratio);
  const bool m_take2 = merge_ok && take2;
  if (m_take2) {
    fl[F_PROP_LOGP] = fl[F_SPROP_LOGP];
    fl[F_PROP_ENERGY] = fl[F_SPROP_ENERGY];
    in[I_PROP_IDX] = in[I_SPROP_IDX];
  }
  if (merge_ok) fl[F_LOGW_TRAJ] = logaddexp(fl[F_LOGW_TRAJ], logw_sub_new);

  // ---------------------------------------------- merged-trajectory checks
  const bool check_traj = cfg.check_turning && merge_ok;
  T* pz = v + V_PROP_Z * dim;
  T* pg = v + V_PROP_G * dim;
  T dots[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  if (merge_ok) {
    T* rho = v + V_RHO * dim;
    const T* edge_old = cp + (D - 1) * dim;
    for (int i = g.rank; i < dim; i += G::kThreads) {
      if (m_take2) {
        pz[i] = sz[i];
        pg[i] = sg[i];
      }
      const T r = rho[i];
      const T rsn = rho_sub[i];
      const T rho_full = r + rsn;
      if (check_traj) {
        const T first_new_p = cp[i];
        const T edge_old_p = edge_old[i];
        T vf, v_first_new, v_edge_old, v_new;
        if constexpr (LR) {
          vf = v_far[i];
          v_first_new = cv[i];
          v_edge_old = cv[(D - 1) * dim + i];
          v_new = ve[i];
        } else {
          const T mi = im[i];
          vf = mi * p_far[i];
          v_first_new = mi * first_new_p;
          v_edge_old = mi * edge_old_p;
          v_new = mi * pe[i];
        }
        const T r2 = r + first_new_p;
        const T r3 = rsn + edge_old_p;
        dots[0] += rho_full * vf;
        dots[1] += rho_full * v_new;
        dots[2] += r2 * vf;
        dots[3] += r2 * v_first_new;
        dots[4] += r3 * v_edge_old;
        dots[5] += r3 * v_new;
      }
      rho[i] = rho_full;
    }
  }
  bool turning_traj = false;
  if (check_traj) {
    g.sum(dots);
    for (int k = 0; k < 6; ++k) turning_traj = turning_traj || dots[k] <= T(0);
  }

  // ---------------------------------------------- draw completion
  const int in_depth = in[I_DEPTH];
  turning_traj = turning_traj && (in_depth + 1) >= cfg.mindepth;
  int depth_limit = cfg.maxdepth < s.depth_cap ? cfg.maxdepth : s.depth_cap;
  const int floor_depth = cfg.mindepth > 1 ? cfg.mindepth : 1;
  depth_limit = depth_limit > floor_depth ? depth_limit : floor_depth;
  const bool ended_by_depth = merge_ok && (in_depth + 1) >= depth_limit;
  const bool draw_done = sub_done && (sub_invalid || turning_traj || ended_by_depth);
  const bool next_doubling = merge_ok && !draw_done;
  if (next_doubling) {
    in[I_DEPTH] = in_depth + 1;
    for (int i = g.rank; i < dim; i += G::kThreads) rho_sub[i] = T(0);
  }
  in[I_N_LEAF] = next_doubling ? 0 : n;
  fl[F_LOGW_SUB] = next_doubling ? -T(INFINITY) : logw_sub_new;
  in[I_TURNING_SUB] = turning_sub_mid && !next_doubling;
  in[I_CKPT_TOP] = next_doubling ? 0 : top_new;
  const bool diverging = (in[I_DIVERGING] > 0) || div_leaf;
  in[I_DIVERGING] = diverging;

  if (draw_done) {
    const int in_draw_idx = in[I_DRAW_IDX];
    const int idx = in_draw_idx - s.chunk_start;
    const int idx_c = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
    const int n_leaves = in[I_N_LEAVES];
    const T accept_mean = fl[F_SUM_ACC] / T(n_leaves > 1 ? n_leaves : 1);
    const size_t out_row = size_t(chain) * L + idx_c;
    if (g.leader()) {
      T* row = a.scal_out + out_row * N_SCALAR;
      row[S_LOGP] = fl[F_PROP_LOGP];
      row[S_ENERGY] = fl[F_PROP_ENERGY];
      row[S_DEPTH] = T(in_depth + 1);
      row[S_MAXDEPTH_REACHED] = T(ended_by_depth && !turning_traj);
      row[S_DIVERGING] = T(diverging);
      row[S_STEP_SIZE] = fl[F_EPS];
      row[S_STEP_SIZE_BAR] = exp(af[AF_LOG_STEP_BAR]);
      row[S_N_STEPS] = T(n_leaves);
      row[S_MEAN_TREE_ACCEPT] = accept_mean;
      row[S_INDEX_IN_TRAJECTORY] = T(in[I_PROP_IDX]);
      row[S_FISHER_DISTANCE] = T(0);
      row[N_SCALAR - 1] = T(0);
    }
    // commit the proposal: the draw, the committed position and gradient,
    // and the stored gradient and inverse mass where asked (the inverse
    // mass of the step's state, before this draw's adaptation)
    T* pos_row = a.pos_out + out_row * dim;
    T* grad_row = a.grad_out ? a.grad_out + out_row * dim : nullptr;
    T* minv_row = a.minv_out ? a.minv_out + out_row * dim : nullptr;
    for (int i = g.rank; i < dim; i += G::kThreads) {
      const T z = pz[i];
      const T gi = pg[i];
      pos_row[i] = z;
      v[V_POSITION * dim + i] = z;
      v[V_GRADIENT * dim + i] = gi;
      if (grad_row) grad_row[i] = gi;
      if (minv_row) minv_row[i] = im[i];
    }
    if constexpr (LR) {
      // thread r < R is lane r of the first warp
      if (a.eig_out && g.rank < m.R) a.eig_out[out_row * m.R + g.rank] = exp(m.log_eig);
    }
    fl[F_LOGP] = fl[F_PROP_LOGP];
    // adaptation (tuning draws only; skipped when frozen)
    if (in_draw_idx < s.num_tune && !cfg.adapt_frozen) {
      diag_adapt_update_strided<T>(g, cfg, s, av, af, pz, pg, in_draw_idx, diverging,
                                   accept_mean);
      // at the end of tuning, freeze the step size at its averaged value
      if (in_draw_idx == s.num_tune - 1) af[AF_LOG_STEP] = af[AF_LOG_STEP_BAR];
      g.sync();
      if (g.leader()) {
#pragma unroll
        for (int k = 0; k < N_ADAPT_FLT; ++k) {
          a.adapt_flts[size_t(chain) * N_ADAPT_FLT + k] = af[k];
        }
      }
    }
    if (diverging) in[I_DIVERGENCE_COUNT] += 1;
    in[I_DRAW_IDX] = in_draw_idx + 1;
    const bool done = idx + 1 >= s.limit;
    in[I_DONE] = done;
    if (!done) {
      const int nidx = idx + 1 > L - 1 ? L - 1 : (idx + 1 < 0 ? 0 : idx + 1);
      const size_t r = size_t(chain) * L + nidx;
      start_draw_strided<T, LR>(g, fl, in, cfg, s, v, im, af, a.mom + r * dim, a.jit[r], m,
                                ev);
    }
  }

  // every thread has read the chain's scalars; one writes them back
  g.sync();
  if (g.leader()) {
#pragma unroll
    for (int k = 0; k < N_FLT; ++k) a.flts[size_t(chain) * N_FLT + k] = fl[k];
#pragma unroll
    for (int k = 0; k < N_INT; ++k) a.ints[size_t(chain) * N_INT + k] = in[k];
  }
}

template <typename T, bool LR>
__global__ void __launch_bounds__(StepGroup<LR>::type::kBlockThreads, kStepMinBlocks)
    step_finish(StepArgs<T> a) {
  using G = typename StepGroup<LR>::type;
  const G g = make_group<T, LR>(a.cfg);
  if constexpr (LR) {
    LowRank<T> m = a.metric(g);
    for (int chain = blockIdx.x; chain < a.cfg.n_chains; chain += gridDim.x) {
      finish_chain<T, true>(a, chain, g, m);
    }
  } else {
    const int chain = G::chain();
    if (chain >= a.cfg.n_chains) return;  // the whole warp
    LowRank<T> m;
    finish_chain<T, false>(a, chain, g, m);
  }
}

// Raise a low-rank kernel's dynamic shared-memory cap to `bytes` before the
// first launch that needs them (every launch of a run asks for the same
// bytes, so once per instantiation and device).
template <typename T, bool Begin>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static size_t cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= cap[dev]) return cudaSuccess;
  if (Begin) {
    err = cudaFuncSetAttribute(step_begin<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
  } else {
    err = cudaFuncSetAttribute(step_finish<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
  }
  if (err == cudaSuccess && dev < kMaxDevices) cap[dev] = bytes;
  return err;
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

template <typename T>
int launch(bool begin, const MkConfig* cfg, const StepPtrs* p, void* stream) {
  const int R = cfg->lr_rank;
  if (cfg->n_chains < 1 || cfg->dim < 1 || cfg->depth_slots < 2 || R < 0 ||
      R > kMaxRank ||
      (R > 0 && (!p->lr_basis || !p->lr_log_eigs || !p->edge_v || !p->ckpt_v))) {
    return int(cudaErrorInvalidValue);
  }
  const StepArgs<T> a(*cfg, *p);
  const auto s = static_cast<cudaStream_t>(stream);
  if (R == 0) {
    const dim3 grid((cfg->n_chains + kStepWarps - 1) / kStepWarps);
    if (begin) step_begin<T, false><<<grid, kStepThreads, 0, s>>>(a);
    else step_finish<T, false><<<grid, kStepThreads, 0, s>>>(a);
    return int(cudaGetLastError());
  }
  // low-rank: persistent blocks, each running its share of the chains
  const int code = check_lr_plan<T>(*cfg, p->lr_basis);
  if (code != 0) return code;
  const size_t smem = lr_layout<T>(*cfg).bytes;
  const cudaError_t err = begin ? allow_smem<T, true>(smem) : allow_smem<T, false>(smem);
  if (err != cudaSuccess) return int(err);
  if (begin) step_begin<T, true><<<cfg->lr_grid, kLrThreads, smem, s>>>(a);
  else step_finish<T, true><<<cfg->lr_grid, kLrThreads, smem, s>>>(a);
  return int(cudaGetLastError());
}

// What was compiled: registers and local (spill) bytes per thread of
// step_begin and step_finish, the threads per block, then the same five of
// the low-rank instantiations, and for the low-rank plan in `cfg` (lr_rank
// > 0; zeros otherwise) the dynamic shared-memory bytes of a block and the
// blocks of each half resident on an SM.
template <typename T>
int geometry(const MkConfig* cfg, int32_t* out) {
  cudaFuncAttributes f[4];
  cudaError_t err = cudaFuncGetAttributes(&f[0], step_begin<T, false>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&f[1], step_finish<T, false>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&f[2], step_begin<T, true>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&f[3], step_finish<T, true>);
  if (err != cudaSuccess) return int(err);
  out[0] = f[0].numRegs;
  out[1] = int32_t(f[0].localSizeBytes);
  out[2] = f[1].numRegs;
  out[3] = int32_t(f[1].localSizeBytes);
  out[4] = kStepThreads;
  out[5] = f[2].numRegs;
  out[6] = int32_t(f[2].localSizeBytes);
  out[7] = f[3].numRegs;
  out[8] = int32_t(f[3].localSizeBytes);
  out[9] = kLrThreads;
  out[10] = out[11] = out[12] = 0;
  if (cfg == nullptr || cfg->lr_rank < 1) return 0;
  // the plan as a launch checks it, without a basis to align
  MkConfig c = *cfg;
  c.lr_tma = 0;
  const int code = check_lr_plan<T>(c, nullptr);
  if (code != 0) return code;
  const size_t smem = lr_layout<T>(c).bytes;
  int blocks[2] = {0, 0};
  err = allow_smem<T, true>(smem);
  if (err == cudaSuccess) err = allow_smem<T, false>(smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[0], step_begin<T, true>,
                                                        kLrThreads, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[1], step_finish<T, true>,
                                                        kLrThreads, smem);
  }
  if (err != cudaSuccess) return int(err);
  out[10] = int32_t(smem);
  out[11] = blocks[0];
  out[12] = blocks[1];
  return 0;
}

}  // namespace nutpie

extern "C" {

// Launch one half of the step for every chain on `stream`; returns the CUDA
// error code of the launch (0 = queued).
int nutpie_step_begin_f32(const nutpie::MkConfig* cfg, const nutpie::StepPtrs* p,
                          void* stream) {
  return nutpie::launch<float>(true, cfg, p, stream);
}

int nutpie_step_begin_f64(const nutpie::MkConfig* cfg, const nutpie::StepPtrs* p,
                          void* stream) {
  return nutpie::launch<double>(true, cfg, p, stream);
}

int nutpie_step_finish_f32(const nutpie::MkConfig* cfg, const nutpie::StepPtrs* p,
                           void* stream) {
  return nutpie::launch<float>(false, cfg, p, stream);
}

int nutpie_step_finish_f64(const nutpie::MkConfig* cfg, const nutpie::StepPtrs* p,
                           void* stream) {
  return nutpie::launch<double>(false, cfg, p, stream);
}

int nutpie_step_geometry_f32(const nutpie::MkConfig* cfg, int32_t* out) {
  return nutpie::geometry<float>(cfg, out);
}

int nutpie_step_geometry_f64(const nutpie::MkConfig* cfg, int32_t* out) {
  return nutpie::geometry<double>(cfg, out);
}

// The current device's shared memory a block may opt in to, shared memory
// per SM, the SMs, and the shared memory the system keeps per block, in
// that order.
int nutpie_step_device(int32_t* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMultiProcessorCount, cudaDevAttrReservedSharedMemoryPerBlock};
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    int value = 0;
    err = cudaDeviceGetAttribute(&value, attrs[k], dev);
    out[k] = value;
  }
  return int(err);
}

const char* nutpie_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
