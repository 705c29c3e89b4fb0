// NUTS step kernel (K2) for Hopper (sm_90a): the machine step around a
// batched log density, as one launch per machine step.
//
// Replaces the body of the JAX package's XLA chunk loop
// (nutpie_tpu/sampler/run.py:make_chunk_runner, :432-440: the vmapped
// machine_step with the model's logp inside).  It is not a port of a
// Pallas kernel.  Any model with a batched torch log density runs through
// it.  A machine step splits at the log density: its first half (the
// step's uniforms, the direction, the slot-(D-1) momentum stash, the first
// half-kick and the drift, which writes z_new) and, once the caller has
// evaluated logp and gradient at z_new for all chains in one torch call,
// its second half (the second half-kick, leaf, multinomial choice,
// checkpoint stack and U-turn checks, merge, draw completion with its
// commit, per-draw adaptation and next start_draw).  One launch,
// step_advance, runs the second half of step k and then the first half of
// step k + 1 for every chain; a chunk's first launch runs a first half
// alone ("begin").  Same semantics as leapfrog_finish then leapfrog_begin
// in nutpie_tpu_torch/sampler/nuts.py.  The step runner
// (sampler/run.py) captures its machine steps, the log density and the
// advance launch, in a CUDA graph and replays it.
//
// What bounds it on this card: bytes.  A step reads and writes a few of a
// chain's [dim] rows (the edge, rho_sub, the inverse mass, z_new and the
// gradient; the checkpoint slots a U-turn check reads; the proposal and
// adaptation rows at a draw's end) and does a handful of operations per
// coordinate on them, far below the card's 67 operations per byte in
// float32.  chip_smoke.py counts the bytes from this code for each run's
// trees (step_bytes).  The fused launch loads a chain's scalars once for
// both halves and keeps them in registers; the held diagonal form (below)
// takes the next step's drift from the new edge's z, p and gradient and
// the inverse mass while its second half-kick has them in registers, and
// hands it to the first half where the next step extends the same edge
// (every step of a doubling but its first); rows a half wrote and the
// other reads again are otherwise read back from the caches.
//
// The step body is written once against a thread group (group.cuh) and
// instantiated for
//   - the diagonal metric, in two forms (sampler/step_kernel.py:diag_plan
//     picks one from dim): held, 8 lanes of a warp per chain in float32
//     (16 in float64), each thread owning at most two chunks of 16 bytes
//     (float4, double2), so dim <= 64, moved by vector loads, every load
//     of a row issued at once, several chains to a warp and more of them
//     resident on an SM; or strided, 32 lanes per chain striding over any
//     dim one coordinate at a time.  128 threads a block.  Both sum in the
//     order of a 32-lane warp (group.cuh), so every form's sums have the
//     bits of the one-warp-per-chain kernel this one replaced;
//   - the divergence-location rows of store_divergences (DIV): each form
//     and the low-rank branch below over 18 state rows instead of 14.  A
//     divergent leaf writes its edge's position, gradient and momentum and
//     the new point into them, so the second half-kick defers its edge
//     stores until the leaf is judged; a new draw resets them to NaN and a
//     finished draw commits them.  Instantiations of their own, so the
//     forms without the rows keep their code and registers;
//   - each of the above once more for the Adam step-size method (ADAM;
//     adapt.cuh: step_size_update), whose update beside dual averaging's
//     spilled the float32 held form;
//   - the low-rank metric (taken when the wrapper passes a metric of rank R
//     > 0): a block of kLrWarps warps per chain (BlockGroup), the blocks
//     persistent, each running every gridDim.x-th chain in turn.  It
//     replaces every product inv_mass * p by the low-rank metric's velocity
//     and the momentum of a new draw by its M^{1/2} z (lowrank.cuh).  Its
//     bytes are the chain's [dim, R] basis: 128 KB in float32 at dim 1000,
//     R 32, against about 40 KB of rows a step.  So the block stages the
//     basis in shared memory by TMA bulk copies once per launch where it
//     fits, which is once per machine step, for every application of both
//     halves (or streams it through a ring of tiles twice per application
//     where it does not: sampler/step_kernel.py:low_rank_plan decides), and
//     sends the next chain's basis on its way as soon as a chain's last
//     pass is done; the block's 256 threads share every coordinate loop.
//     With one block (8 warps) an SM little latency hides behind other
//     warps, so the products are laid out for independent instructions
//     (lowrank.cuh).  The branch applies the metric only where a momentum
//     is new: the new point's velocity, the momentum and kinetic energy of
//     the next draw, and the next step's drift.  The metric is fixed
//     within a draw, so every other velocity the U-turn checks need is one
//     of those, kept where its momentum is kept: the two trajectory edges'
//     in `edge_v` (the new point's is written there), each checkpoint's in
//     `ckpt_v` beside `ckpt_p` (pushed from the new point's, the slot-(D-1)
//     stash from its edge's).  A kept velocity is bitwise the one the same
//     arithmetic would compute again.
//
// Every row stays in device memory and is updated in place; a thread owns
// the same coordinates in every loop.  The scalars of a chain are loaded
// into registers in every thread, every decision is computed in every
// thread from the same values and the same reductions (group.cuh), so no
// thread waits for another to decide, and one thread writes the scalars
// back.  Values one half writes for the other's next launch (the uniforms,
// the stagnant flag) are written after the group's barrier that follows
// every thread's read of the old ones.  A done chain hands the log density
// its committed position and is otherwise left alone (its block stages
// nothing).  The step's uniforms come from the in-kernel Threefry
// (threefry.cuh), bit-equal to leapfrog_uniforms; the adaptation is
// adapt.cuh's arithmetic in its strided form.  It is built without FMA
// contraction (ops/build.py), so it rounds as the plain version does, and
// every sum has a fixed order.
#include <cuda_runtime.h>

#include "adapt.cuh"
#include "group.cuh"
#include "lowrank.cuh"
#include "threefry.cuh"
#include "warp.cuh"

namespace nutpie {

// coordinates a chunk of the vector forms: 16 bytes
template <typename T>
constexpr int kVec = 16 / int(sizeof(T));
// chunks a thread of a held form owns, in registers between loops
constexpr int kHeld = 2;
constexpr int kLrThreads = BlockGroup<kLrWarps>::kBlockThreads;

// The group of an instantiation: W lanes a chain (diagonal), or the
// low-rank block.
template <bool LR, int W>
struct GroupOf {
  using type = LaneGroup<W>;
};
template <int W>
struct GroupOf<true, W> {
  using type = BlockGroup<kLrWarps>;
};

// Resident blocks an SM must be able to hold, which caps the registers:
// four 128-thread blocks (128 registers) in float32, two (255) in float64;
// the low-rank block fills an SM's shared memory alone.
template <typename T, bool LR>
constexpr int min_blocks() {
  return LR ? 1 : (sizeof(T) == 4 ? 4 : 2);
}

// the low-rank block's dynamic shared memory (LrLayout)
extern __shared__ __align__(128) unsigned char step_smem[];

// Device pointers of one launch, as the wrapper passes them (step_kernel.py
// StepPtrs).  The state tensors are updated in place.
struct StepPtrs {
  const int32_t* scal;   // chunk_start, limit, num_tune, early_end, freeze_start, depth_cap
  const int64_t* key;    // [C, 2] raw Threefry key data
  void* vecs;            // [C, N_VEC, dim] ([C, N_VEC_DIV, dim] with store_divergences)
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
  float* u3;             // [C, 3] the step's uniforms (first half -> second)
  int32_t* stagnant;     // [C] the step left the position unchanged
  const void* logp;      // [C] log density at z_new (advance)
  const void* grad;      // [C, dim] its gradient (advance)
  const void* lr_basis;     // [C, dim, R] the low-rank metric's basis (R > 0)
  const void* lr_log_eigs;  // [C, R] its log eigenvalues
  void* edge_v;             // [C, 2, dim] velocities of p_minus, p_plus (R > 0)
  void* ckpt_v;             // [C, D, dim] velocities of the ckpt_p rows (R > 0)
  void* grad_out;           // [C, L, dim] the draws' gradients, or null
  void* minv_out;           // [C, L, dim] the draws' inverse mass, or null
  void* eig_out;            // [C, L, R] the draws' metric eigenvalues, or null
  // [C, L, dim] each, with store_divergences: the draws' divergence rows
  void* div_start_out;
  void* div_end_out;
  void* div_mom_out;
  void* div_grad_out;
  // the microcanonical kinetic (micro): the chain's velocity after the
  // first half-update, then the new point's, and the pulled-back gradient
  // (low-rank), [C, 2, dim]; the first half-update's kinetic change, [C]
  void* mc_rows;
  void* mc_dke;
  // flow adaptation's use_orbit: the uniform-leaf reservoir's rows (a leaf
  // and its gradient, [C, 2, dim]), each step's reservoir uniform (first
  // half -> second, [C]) and the draws' orbit leaves ([C, L, dim] each);
  // all null without it
  void* orbit;
  float* orbit_u;
  void* orbit_pos_out;
  void* orbit_grad_out;
};

template <typename T>
__host__ __device__ inline LrLayout lr_layout(const MkConfig& c) {
  return LrLayout(c.dim, c.lr_rank, int(sizeof(T)), c.lr_streamed != 0);
}

template <typename T>
struct StepArgs {
  MkConfig cfg;
  int advance;  // 1: the second half of a step, then the next one's first; 0: a first half
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
  T* div_start_out;
  T* div_end_out;
  T* div_mom_out;
  T* div_grad_out;
  T* mc_rows;
  T* mc_dke;
  T* orbit;
  float* orbit_u;
  T* orbit_pos_out;
  T* orbit_grad_out;

  StepArgs(const MkConfig& c, const StepPtrs& p, bool adv)
      : cfg(c), advance(adv ? 1 : 0), scal(p.scal), key(p.key),
        vecs(static_cast<T*>(p.vecs)), ckpt_p(static_cast<T*>(p.ckpt_p)),
        ckpt_s(static_cast<T*>(p.ckpt_s)), flts(static_cast<T*>(p.flts)), ints(p.ints),
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
        eig_out(static_cast<T*>(p.eig_out)),
        div_start_out(static_cast<T*>(p.div_start_out)),
        div_end_out(static_cast<T*>(p.div_end_out)),
        div_mom_out(static_cast<T*>(p.div_mom_out)),
        div_grad_out(static_cast<T*>(p.div_grad_out)),
        mc_rows(static_cast<T*>(p.mc_rows)), mc_dke(static_cast<T*>(p.mc_dke)),
        orbit(static_cast<T*>(p.orbit)), orbit_u(p.orbit_u),
        orbit_pos_out(static_cast<T*>(p.orbit_pos_out)),
        orbit_grad_out(static_cast<T*>(p.orbit_grad_out)) {}

  // The block's view of the low-rank metric (its barriers initialized).
  template <typename G>
  __device__ __forceinline__ LowRank<T> metric(const G& g) const {
    return LowRank<T>(cfg, lr_basis, lr_log_eigs, step_smem, lr_layout<T>(cfg), g.warp(),
                      g.lane());
  }
};

// State rows a chain: with the divergence rows or without.
template <bool DIV>
constexpr int kNVec = DIV ? int(N_VEC_DIV) : int(N_VEC);

// The first chain after `chain` in the block's order (every gridDim.x-th)
// that is not done, among the next 32; -1 if none.  Every warp reads the
// same flags, so every thread gets the same chain.  (A chain that finishes
// during the launch may still be taken for active: its basis is fetched
// for nothing.)
__device__ __forceinline__ int next_active(const int32_t* ints, int chain, int n_chains,
                                           int lane) {
  const int stride = int(gridDim.x);
  const int cand = chain + (lane + 1) * stride;
  const bool active = cand < n_chains && ints[size_t(cand) * N_INT + I_DONE] == 0;
  const unsigned ahead = __ballot_sync(kFullMask, active);
  return ahead ? chain + __ffs(ahead) * stride : -1;
}

// A new draw's trajectory rows at chunk c: every edge, the proposals and
// rho from the committed position z and gradient g, and momentum p0.
template <int N, typename T>
__device__ __forceinline__ void reset_rows(T* v, int dim, int c, const Vec<T, N>& z,
                                           const Vec<T, N>& p0, const Vec<T, N>& g) {
  st<N>(v + V_Z_MINUS * dim, c, z);
  st<N>(v + V_P_MINUS * dim, c, p0);
  st<N>(v + V_G_MINUS * dim, c, g);
  st<N>(v + V_Z_PLUS * dim, c, z);
  st<N>(v + V_P_PLUS * dim, c, p0);
  st<N>(v + V_G_PLUS * dim, c, g);
  st<N>(v + V_RHO * dim, c, p0);
  st<N>(v + V_RHO_SUB * dim, c, splat<N>(T(0)));
  st<N>(v + V_PROP_Z * dim, c, z);
  st<N>(v + V_PROP_G * dim, c, g);
  st<N>(v + V_SPROP_Z * dim, c, z);
  st<N>(v + V_SPROP_G * dim, c, g);
}

// The next step's drift where it extends the edge this step extended, in
// a held form (KC > 0): z_new at the thread's chunks, and whether the
// drift moved any of them; taken by the second half-kick from the rows it
// holds (the new edge's z, p and gradient, and the inverse mass).
template <typename T, int N, int KC>
struct NextDrift {
  static constexpr int S = KC > 0 ? KC : 1;
  Vec<T, N> z[S];
  bool moved = false, valid = false;
};

// The microcanonical kinetic (MICRO instantiations): the isokinetic
// velocity update of one chain (isokinetic.py:update_velocity) for time
// `step`, from the velocity row `u` under the pulled-back gradient gt_of(c)
// (chunk c), written normalized into the row `out` (which may be `u`);
// returns the kinetic-energy change.  Three sums in the group's order: the
// gradient's norm, <u, e>, the new velocity's norm.
template <typename T, int N, int KC, typename G, typename GT>
__device__ __forceinline__ T iso_update(const G& g, int dim, const T* u, GT&& gt_of, T* out,
                                        T step) {
  using V = Vec<T, N>;
  const int n_chunks = dim / N;
  T part[1][N] = {};
  each_chunk<KC>(g, n_chunks, [&](int, int c) {
    const V gt = gt_of(c);
#pragma unroll
    for (int k = 0; k < N; ++k) part[0][k] += gt[k] * gt[k];
  });
  T sum[1];
  g.sum(part, sum);
  const T g_norm = jmax(sqrt(sum[0]), T(1e-30));
#pragma unroll
  for (int k = 0; k < N; ++k) part[0][k] = T(0);
  each_chunk<KC>(g, n_chunks, [&](int, int c) {
    const V gt = gt_of(c), uu = ld<N>(u, c);
#pragma unroll
    for (int k = 0; k < N; ++k) part[0][k] += uu[k] * (-gt[k] / g_norm);
  });
  g.sum(part, sum);
  const T ue = sum[0];
  const T delta = step * g_norm / T(dim - 1);
  const T ch = cosh(delta);
  const T sh = sinh(delta);
  const T denom = ch + ue * sh;
  const T kk = sh + (ch - T(1)) * ue;
#pragma unroll
  for (int k = 0; k < N; ++k) part[0][k] = T(0);
  each_chunk<KC>(g, n_chunks, [&](int, int c) {
    const V gt = gt_of(c), uu = ld<N>(u, c);
    V un;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      un[k] = (uu[k] + (-gt[k] / g_norm) * kk) / denom;
      part[0][k] += un[k] * un[k];
    }
    st<N>(out, c, un);
  });
  g.sum(part, sum);
  const T norm = sqrt(sum[0]);
  each_chunk<KC>(g, n_chunks, [&](int, int c) {
    V un = ld<N>(out, c);
#pragma unroll
    for (int k = 0; k < N; ++k) un[k] = un[k] / norm;
    st<N>(out, c, un);
  });
  return T(dim - 1) * log(denom);
}

// The low-rank metric's pulled-back gradient -A^T g = -(w + U c), w = s g,
// c = (sqrt(L) - 1) (U^T w), of the gradient row `gr` into the row `gt`:
// two passes over the basis.
template <typename T, typename G>
__device__ __forceinline__ void lr_pull_back(const G& g, LowRank<T>& m, int dim, const T* im,
                                             const T* gr, T* gt) {
  const int lane = g.lane();
  T acc[kHalf] = {};
  m.pass();
  for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
    const int t = base / kLanes;
    const int i = base + lane;
    m.project(m.tile(t), t, i < dim ? sqrt(im[i]) * gr[i] : T(0), acc);
    m.release(t);
  }
  m.pass();
  m.set_coefficients(g, acc, m.root_factor());
  for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
    const int t = base / kLanes;
    const int i = base + lane;
    const T uc = m.expand(m.tile(t), t, i);
    m.release(t);
    if (i < dim) gt[i] = -(sqrt(im[i]) * gr[i] + uc);
  }
}

// The velocity the U-turn checks dot with: M^{-1} p under the
// exact-normal kinetic (the diagonal forms' mi p), p itself under the
// microcanonical one.
template <bool MICRO, typename T>
__device__ __forceinline__ T turn_v(T mi, T p) {
  if constexpr (MICRO) {
    return p;
  } else {
    return mi * p;
  }
}

// Refresh momentum and reset the trajectory for a new draw (start_draw in
// nuts.py): every state row from the committed position and gradient.
// Low-rank: p0 = (z + U c) / s (its coefficients in a first pass over the
// basis), whose velocity coefficients the second pass gathers while it
// writes the rows, and in a third the velocity v(p0), kept for both edges
// (ev), and the kinetic energy p0 . v(p0).
//
// The microcanonical kinetic (MICRO): p0 = gauss / |gauss|, a unit velocity
// whose kinetic weight starts at 0, so h0 = -logp; no metric is applied,
// and under the low-rank metric the kept velocities are p0 itself.
template <typename T, bool LR, int N, int KC, bool DIV, bool MICRO, typename G>
__device__ __forceinline__ void start_draw_strided(const G& g, T* fl, int* in,
                                                   const MkConfig& cfg, const Sched& s, T* v,
                                                   const T* im, const T* af, const T* gauss,
                                                   T jitter_u, LowRank<T>& m, T* ev) {
  using V = Vec<T, N>;
  const int dim = cfg.dim;
  T ke_part[1][N] = {};
  if constexpr (MICRO) {
    each_chunk<KC>(g, dim / N, [&](int, int c) {
      const V gs = ld<N>(gauss, c);
#pragma unroll
      for (int k = 0; k < N; ++k) ke_part[0][k] += gs[k] * gs[k];
    });
    T nn[1];
    g.sum(ke_part, nn);
    const T norm = jmax(sqrt(nn[0]), T(1e-30));
    each_chunk<KC>(g, dim / N, [&](int, int c) {
      const V gs = ld<N>(gauss, c);
      const V z = ld<N>(v + V_POSITION * dim, c), gr = ld<N>(v + V_GRADIENT * dim, c);
      V p0;
#pragma unroll
      for (int k = 0; k < N; ++k) p0[k] = gs[k] / norm;
      reset_rows<N>(v, dim, c, z, p0, gr);
      if constexpr (DIV) {
        for (int row = V_DIV_START; row < N_VEC_DIV; ++row) {
          st<N>(v + row * dim, c, splat<N>(T(NAN)));
        }
      }
      if constexpr (LR) {
        st<N>(ev, c, p0);
        st<N>(ev + dim, c, p0);
      }
    });
#pragma unroll
    for (int k = 0; k < N; ++k) ke_part[0][k] = T(0);
  } else if constexpr (LR) {
    const int lane = g.lane();
    T acc[kHalf] = {};
    m.use(m.chain);
    m.pass();
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      m.project(m.tile(t), t, i < dim ? gauss[i] : T(0), acc);
      m.release(t);
    }
    m.pass();
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
        reset_rows<1>(v, dim, i, splat<1>(v[V_POSITION * dim + i]), splat<1>(p0),
                      splat<1>(v[V_GRADIENT * dim + i]));
        if constexpr (DIV) {
          for (int row = V_DIV_START; row < N_VEC_DIV; ++row) v[row * dim + i] = T(NAN);
        }
        wi = si * p0;
      }
      m.project(u, t, wi, acc);
      m.release(t);
    }
    m.pass();
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
        ke_part[0][0] += p0 * vi;
      }
    }
  } else {
    each_chunk<KC>(g, dim / N, [&](int, int c) {
      const V mi = ld<N>(im, c), gs = ld<N>(gauss, c);
      const V z = ld<N>(v + V_POSITION * dim, c), gr = ld<N>(v + V_GRADIENT * dim, c);
      V p0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        p0[k] = gs[k] / sqrt(mi[k]);
        ke_part[0][k] += p0[k] * (mi[k] * p0[k]);
      }
      reset_rows<N>(v, dim, c, z, p0, gr);
      if constexpr (DIV) {
        for (int row = V_DIV_START; row < N_VEC_DIV; ++row) st<N>(v + row * dim, c, splat<N>(T(NAN)));
      }
    });
  }
  T ke[1];
  g.sum(ke_part, ke);
  const bool tuning = in[I_DRAW_IDX] < s.num_tune;
  T eps = exp(tuning ? af[AF_LOG_STEP] : af[AF_LOG_STEP_BAR]);
  if (cfg.has_jitter) {
    eps = eps * (T(1) + T(cfg.step_size_jitter) * (T(2) * jitter_u - T(1)));
  }
  const T logp = fl[F_LOGP];
  const T h0 = MICRO ? -logp : -logp + T(0.5) * ke[0];
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

// The second half of a step (leapfrog_finish in nuts.py) of one chain,
// whose scalars are in `fl` and `in`; a held form leaves in `drift` the
// next step's drift along the edge it extended.
//
// The microcanonical kinetic (MICRO): the second velocity half-update of
// the first half's velocity (the chain's first mc row) under the new
// point's pulled-back gradient gives the new momentum, written over it;
// the leaf's energy is -logp plus the edge's accumulated kinetic weight
// (flts ke_plus / ke_minus), and the U-turn checks dot with the momenta.
template <typename T, bool LR, int N, int KC, bool DIV, bool ADAM, bool MICRO, typename G>
__device__ __forceinline__ void finish_half(const StepArgs<T>& a, int chain, const G& g,
                                            LowRank<T>& m, T* fl, int* in,
                                            NextDrift<T, N, KC>& drift) {
  using V = Vec<T, N>;
  constexpr int S = NextDrift<T, N, KC>::S;
  const MkConfig& cfg = a.cfg;
  const int dim = cfg.dim;
  const int n_chunks = dim / N;
  const int D = cfg.depth_slots;
  const int L = cfg.chunk_len;
  const Sched s{a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4], a.scal[5]};

  T* v = a.vecs + size_t(chain) * kNVec<DIV> * dim;
  T* av = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim;
  const T* im = av + A_INV_MASS * dim;
  T* cp = a.ckpt_p + size_t(chain) * D * dim;
  T* cs = a.ckpt_s + size_t(chain) * D * dim;
  T* zn = a.z_new + size_t(chain) * dim;
  const T* gn = a.grad + size_t(chain) * dim;
  const T logp_new = a.logp[chain];
  const T u1 = T(a.u3[3 * size_t(chain) + 1]);
  const T u2 = T(a.u3[3 * size_t(chain) + 2]);
  const bool stagnant = a.stagnant[chain] != 0;
  // the low-rank branch's kept velocities
  T* ev = a.edge_v + size_t(chain) * 2 * dim;  // p_minus's, then p_plus's
  T* cv = a.ckpt_v + size_t(chain) * D * dim;  // each ckpt_p row's

  const int direction = in[I_DIRECTION];  // the first half's choice
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
  // MICRO: the velocity (first half's, then the new point's) and the
  // pulled-back gradient
  T* uh = a.mc_rows + size_t(chain) * 2 * dim;
  T* gtr = uh + dim;
  T dke2 = T(0);
  if constexpr (MICRO) {
    if constexpr (LR) {
      lr_pull_back(g, m, dim, im, gn, gtr);
      dke2 = iso_update<T, 1, 0>(g, dim, uh, [&](int c) { return ld<1>(gtr, c); }, uh,
                                 half_eps);
    } else {
      dke2 = iso_update<T, N, KC>(g, dim, uh, [&](int c) {
        const V gi = ld<N>(gn, c), mi = ld<N>(im, c);
        V r;
#pragma unroll
        for (int k = 0; k < N; ++k) r[k] = -(sqrt(mi[k]) * gi[k]);
        return r;
      }, uh, half_eps);
    }
  }

  // ---------------------------------------------- second half-kick; the
  // extended edge becomes the new point
  T ke_part[1][N] = {};
  // held forms: the new point's z, p, gradient and rho_sub for the pushes
  V z_held[S], p_held[S], g_held[S], rs_held[S];
  if constexpr (LR && MICRO) {
    // the new momentum is its own kept velocity
    for (int i = g.rank; i < dim; i += G::kThreads) {
      const T p = uh[i];
      if constexpr (!DIV) {
        ze[i] = zn[i];
        pe[i] = p;
        ge[i] = gn[i];
      }
      ve[i] = p;
    }
  } else if constexpr (LR) {
    // v_new = s (w + U c), w = s p_new, kept as the edge's velocity
    const int lane = g.lane();
    T acc[kHalf] = {};
    m.pass();
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      T wi = T(0);
      if (i < dim) {
        const T p_half = pe[i] + half_eps * ge[i];
        const T gi = gn[i];
        const T p = p_half + half_eps * gi;
        if constexpr (!DIV) {
          ze[i] = zn[i];
          pe[i] = p;
          ge[i] = gi;
        }
        wi = sqrt(im[i]) * p;
      }
      m.project(m.tile(t), t, wi, acc);
      m.release(t);
    }
    m.pass();
    m.set_coefficients(g, acc, m.velocity_factor());
    for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
      const int t = base / kLanes;
      const int i = base + lane;
      const T uc = m.expand(m.tile(t), t, i);
      m.release(t);
      if (i < dim) {
        const T si = sqrt(im[i]);
        // the new momentum (its edge still holds the old one with the rows)
        const T p = DIV ? (pe[i] + half_eps * ge[i]) + half_eps * gn[i] : pe[i];
        const T vn = si * (si * p + uc);
        ve[i] = vn;
        ke_part[0][0] += p * vn;
      }
    }
  } else {
    bool moved = false;
    each_chunk<KC>(g, n_chunks, [&](int j, int c) {
      // every row of the chunk is asked for at once
      const V p_e = ld<N>(pe, c), g_e = ld<N>(ge, c), gi = ld<N>(gn, c);
      const V mi = ld<N>(im, c), z = ld<N>(zn, c);
      if constexpr (KC > 0) rs_held[j] = ld<N>(rho_sub, c);
      V p;
      if constexpr (MICRO) {
        p = ld<N>(uh, c);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const T p_half = p_e[k] + half_eps * g_e[k];
          p[k] = p_half + half_eps * gi[k];
          ke_part[0][k] += p[k] * (mi[k] * p[k]);
        }
      }
      // with the divergence rows the edge keeps its old values until the
      // leaf is judged (below)
      if constexpr (!DIV) {
        st<N>(ze, c, z);
        st<N>(pe, c, p);
        st<N>(ge, c, gi);
      }
      if constexpr (KC > 0) {
        z_held[j] = z;
        p_held[j] = p;
        g_held[j] = gi;
        // the next step's drift along this edge (the first half's
        // arithmetic on the same values: eps and the inverse mass change
        // only at a draw's start); MICRO's needs the group's sums
        if constexpr (!MICRO) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const T p_half = p[k] + half_eps * gi[k];
            drift.z[j][k] = z[k] + eps_s * (mi[k] * p_half);
            moved = moved || (drift.z[j][k] != z[k]);
          }
        }
      }
    });
    drift.moved = moved;
    drift.valid = KC > 0 && !MICRO;
  }
  T ke[1];
  g.sum(ke_part, ke);

  // ---------------------------------------------- leaf processing
  T h;
  if constexpr (MICRO) {
    // the slots by constant index, so the scalars stay in registers
    const T ke_edge = ((fwd ? fl[F_KE_PLUS] : fl[F_KE_MINUS]) + a.mc_dke[chain]) + dke2;
    if (fwd) {
      fl[F_KE_PLUS] = ke_edge;
    } else {
      fl[F_KE_MINUS] = ke_edge;
    }
    h = -logp_new + ke_edge;
  } else {
    h = -logp_new + T(0.5) * ke[0];
  }
  const int n = in[I_N_LEAF] + 1;
  const T e_err = h - fl[F_H0];
  const bool finite = isfinite(e_err);
  const bool div_leaf = !finite || e_err > T(cfg.max_energy_error) || stagnant;
  const T lw = div_leaf ? -T(INFINITY) : -e_err;
  const T acc = finite ? exp(jmin(T(0), -e_err)) : T(0);
  // use_orbit: the new point replaces the reservoir's leaf with probability
  // 1 / (the draw's leaves so far, this one included)
  const bool take_orbit =
      a.orbit != nullptr && T(a.orbit_u[chain]) * T(in[I_N_LEAVES] + 1) <= T(1);
  if constexpr (DIV) {
    // a divergent leaf keeps the edge it left (position, gradient,
    // momentum) and the point it reached; then the edge becomes the new
    // point (a strided thread recomputes its momentum, bit for bit)
    each_chunk<KC>(g, n_chunks, [&](int j, int c) {
      V z, p, gi;
      if constexpr (KC > 0) {
        z = z_held[j];
        p = p_held[j];
        gi = g_held[j];
      } else {
        z = ld<N>(zn, c);
        gi = ld<N>(gn, c);
        if constexpr (MICRO) {
          p = ld<N>(uh, c);
        } else {
          const V p_e = ld<N>(pe, c), g_e = ld<N>(ge, c);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const T p_half = p_e[k] + half_eps * g_e[k];
            p[k] = p_half + half_eps * gi[k];
          }
        }
      }
      if (div_leaf) {
        st<N>(v + V_DIV_START * dim, c, ld<N>(ze, c));
        st<N>(v + V_DIV_START_GRAD * dim, c, ld<N>(ge, c));
        st<N>(v + V_DIV_MOM * dim, c, ld<N>(pe, c));
        st<N>(v + V_DIV_END * dim, c, z);
      }
      st<N>(ze, c, z);
      st<N>(pe, c, p);
      st<N>(ge, c, gi);
      if (take_orbit) {
        T* orow = a.orbit + size_t(chain) * 2 * dim;
        st<N>(orow, c, z);
        st<N>(orow + dim, c, gi);
      }
    });
  } else {
    if (take_orbit) {
      T* orow = a.orbit + size_t(chain) * 2 * dim;
      each_chunk<KC>(g, n_chunks, [&](int j, int c) {
        if constexpr (KC > 0) {
          st<N>(orow, c, z_held[j]);
          st<N>(orow + dim, c, g_held[j]);
        } else {
          st<N>(orow, c, ld<N>(zn, c));
          st<N>(orow + dim, c, ld<N>(gn, c));
        }
      });
    }
  }
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
  each_chunk<KC>(g, n_chunks, [&](int j, int c) {
    V p, rs;
    if constexpr (KC > 0) {
      p = p_held[j];
      rs = rs_held[j];
    } else {
      p = ld<N>(pe, c);
      rs = ld<N>(rho_sub, c);
    }
    if (m_take) {
      if constexpr (KC > 0) {
        st<N>(sz, c, z_held[j]);
        st<N>(sg, c, g_held[j]);
      } else {
        st<N>(sz, c, ld<N>(zn, c));
        st<N>(sg, c, ld<N>(gn, c));
      }
    }
    if (odd) {
      st<N>(cp + top_c * dim, c, p);
      st<N>(cs + top_c * dim, c, rs);
      if constexpr (LR) cv[top_c * dim + c] = ve[c];
    }
    V r;  // rho_sub + p_new, reset below at a doubling
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = rs[k] + p[k];
    st<N>(rho_sub, c, r);
  });
  // subtree U-turn checks against the top tz checkpoints
  bool turning_here = false;
  if (cfg.check_turning && !odd) {
    const int lo = top_after - tz > 0 ? top_after - tz : 0;
    for (int slot = lo; slot < top_after && slot < D; ++slot) {
      T part[2][N] = {};
      const T* cps = cp + slot * dim;
      const T* css = cs + slot * dim;
      if constexpr (LR) {
        const T* cvs = cv + slot * dim;
        for (int i = g.rank; i < dim; i += G::kThreads) {
          const T rho_ab = rho_sub[i] - css[i];
          part[0][0] += rho_ab * cvs[i];
          part[1][0] += rho_ab * ve[i];
        }
      } else {
        each_chunk<KC>(g, n_chunks, [&](int, int c) {
          const V rsn = ld<N>(rho_sub, c), p = ld<N>(pe, c), mi = ld<N>(im, c);
          const V cs_c = ld<N>(css, c), cp_c = ld<N>(cps, c);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const T rho_ab = rsn[k] - cs_c[k];
            part[0][k] += rho_ab * (MICRO ? cp_c[k] : cp_c[k] * mi[k]);
            part[1][k] += rho_ab * turn_v<MICRO>(mi[k], p[k]);
          }
        });
      }
      T dots[2];
      g.sum(part, dots);
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
  T part[6][N] = {};
  if (merge_ok) {
    T* rho = v + V_RHO * dim;
    const T* edge_old = cp + (D - 1) * dim;
    each_chunk<KC>(g, n_chunks, [&](int, int c) {
      if (m_take2) {
        st<N>(pz, c, ld<N>(sz, c));
        st<N>(pg, c, ld<N>(sg, c));
      }
      const V r = ld<N>(rho, c), rsn = ld<N>(rho_sub, c);
      V rho_full;
#pragma unroll
      for (int k = 0; k < N; ++k) rho_full[k] = r[k] + rsn[k];
      if (check_traj) {
        const V first_new_p = ld<N>(cp, c), edge_old_p = ld<N>(edge_old, c);
        V p, mi, p_f;
        if constexpr (!LR) {
          p = ld<N>(pe, c);
          mi = ld<N>(im, c);
          p_f = ld<N>(p_far, c);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          T vf, v_first_new, v_edge_old, v_new;
          if constexpr (LR) {
            const int i = c * N + k;
            vf = v_far[i];
            v_first_new = cv[i];
            v_edge_old = cv[(D - 1) * dim + i];
            v_new = ve[i];
          } else {
            vf = turn_v<MICRO>(mi[k], p_f[k]);
            v_first_new = turn_v<MICRO>(mi[k], first_new_p[k]);
            v_edge_old = turn_v<MICRO>(mi[k], edge_old_p[k]);
            v_new = turn_v<MICRO>(mi[k], p[k]);
          }
          const T r2 = r[k] + first_new_p[k];
          const T r3 = rsn[k] + edge_old_p[k];
          part[0][k] += rho_full[k] * vf;
          part[1][k] += rho_full[k] * v_new;
          part[2][k] += r2 * vf;
          part[3][k] += r2 * v_first_new;
          part[4][k] += r3 * v_edge_old;
          part[5][k] += r3 * v_new;
        }
      }
      st<N>(rho, c, rho_full);
    });
  }
  bool turning_traj = false;
  if (check_traj) {
    T dots[6];
    g.sum(part, dots);
    for (int k = 0; k < 6; ++k) turning_traj = turning_traj || dots[k] <= T(0);
  }

  // ---------------------------------------------- draw completion
  const int in_depth = in[I_DEPTH];
  turning_traj = turning_traj && (in_depth + 1) >= cfg.mindepth;
  const bool ended_by_depth =
      merge_ok && (in_depth + 1) >= depth_limit(cfg, s, fl[F_EPS]);
  const bool draw_done = sub_done && (sub_invalid || turning_traj || ended_by_depth);
  const bool next_doubling = merge_ok && !draw_done;
  if (next_doubling) {
    in[I_DEPTH] = in_depth + 1;
    each_chunk<KC>(g, n_chunks, [&](int, int c) { st<N>(rho_sub, c, splat<N>(T(0))); });
  }
  in[I_N_LEAF] = next_doubling ? 0 : n;
  fl[F_LOGW_SUB] = next_doubling ? -T(INFINITY) : logw_sub_new;
  in[I_TURNING_SUB] = turning_sub_mid && !next_doubling;
  in[I_CKPT_TOP] = next_doubling ? 0 : top_new;
  const bool diverging = (in[I_DIVERGING] > 0) || div_leaf;
  in[I_DIVERGING] = diverging;

  if (draw_done) {
    T af[N_ADAPT_FLT];
#pragma unroll
    for (int k = 0; k < N_ADAPT_FLT; ++k) af[k] = a.adapt_flts[size_t(chain) * N_ADAPT_FLT + k];
    const int in_draw_idx = in[I_DRAW_IDX];
    const int idx = in_draw_idx - s.chunk_start;
    const int idx_c = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
    const int n_leaves = in[I_N_LEAVES];
    const T accept_mean = fl[F_SUM_ACC] / T(n_leaves > 1 ? n_leaves : 1);
    const size_t out_row = size_t(chain) * L + idx_c;
    const bool done = idx + 1 >= s.limit;
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
    // mass of the step's state, before this draw's adaptation); a chain
    // done with its chunk hands the log density its committed position
    T* pos_row = a.pos_out + out_row * dim;
    T* grad_row = a.grad_out ? a.grad_out + out_row * dim : nullptr;
    T* minv_row = a.minv_out ? a.minv_out + out_row * dim : nullptr;
    each_chunk<KC>(g, n_chunks, [&](int, int c) {
      const V z = ld<N>(pz, c), gi = ld<N>(pg, c);
      st<N>(pos_row, c, z);
      st<N>(v + V_POSITION * dim, c, z);
      st<N>(v + V_GRADIENT * dim, c, gi);
      if (grad_row) st<N>(grad_row, c, gi);
      if (minv_row) st<N>(minv_row, c, ld<N>(im, c));
      if (done) st<N>(zn, c, z);
      if constexpr (DIV) {
        st<N>(a.div_start_out + out_row * dim, c, ld<N>(v + V_DIV_START * dim, c));
        st<N>(a.div_end_out + out_row * dim, c, ld<N>(v + V_DIV_END * dim, c));
        st<N>(a.div_mom_out + out_row * dim, c, ld<N>(v + V_DIV_MOM * dim, c));
        st<N>(a.div_grad_out + out_row * dim, c, ld<N>(v + V_DIV_START_GRAD * dim, c));
      }
    });
    if (a.orbit_pos_out) {
      // use_orbit: the draw's orbit leaf
      const T* orow = a.orbit + size_t(chain) * 2 * dim;
      each_chunk<KC>(g, n_chunks, [&](int, int c) {
        st<N>(a.orbit_pos_out + out_row * dim, c, ld<N>(orow, c));
        st<N>(a.orbit_grad_out + out_row * dim, c, ld<N>(orow + dim, c));
      });
    }
    if constexpr (LR) {
      // thread r < R is lane r of the first warp
      if (a.eig_out && g.rank < m.R) a.eig_out[out_row * m.R + g.rank] = exp(m.log_eig);
    }
    fl[F_LOGP] = fl[F_PROP_LOGP];
    // adaptation (tuning draws only; skipped when frozen)
    if (in_draw_idx < s.num_tune && !cfg.adapt_frozen) {
      diag_adapt_update_strided<T, N, KC, ADAM>(g, cfg, s, av, af, pz, pg, in_draw_idx, diverging,
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
    in[I_DONE] = done;
    if (!done) {
      const int nidx = idx + 1 > L - 1 ? L - 1 : (idx + 1 < 0 ? 0 : idx + 1);
      const size_t r = size_t(chain) * L + nidx;
      start_draw_strided<T, LR, N, KC, DIV, MICRO>(g, fl, in, cfg, s, v, im, af, a.mom + r * dim,
                                                   a.jit[r], m, ev);
    }
  }
}

// The first half of a step (leapfrog_begin in nuts.py) of one chain,
// whose scalars are in `fl` and `in`: its uniforms, direction, stash,
// first half-kick and drift into z_new; where the step extends the edge
// the last one did, the drift `drift` holds (held forms).
//
// The microcanonical kinetic (MICRO): the first velocity half-update of the
// edge's momentum under its pulled-back gradient, into the chain's first mc
// row (its kinetic change into mc_dke), and the drift along A of it.
template <typename T, bool LR, int N, int KC, bool DIV, bool MICRO, typename G>
__device__ __forceinline__ void begin_half(const StepArgs<T>& a, int chain, const G& g,
                                           LowRank<T>& m, const T* fl, int* in,
                                           const NextDrift<T, N, KC>& drift) {
  using V = Vec<T, N>;
  const MkConfig& cfg = a.cfg;
  const int dim = cfg.dim;
  const int D = cfg.depth_slots;
  const T* v = a.vecs + size_t(chain) * kNVec<DIV> * dim;
  T* zn = a.z_new + size_t(chain) * dim;
  const int total_steps = in[I_TOTAL_STEPS];
  const bool at_start = in[I_N_LEAF] == 0;

  // uniform(fold_in(fold_in(key, 3), total_steps), (3,)): lane l < 3 of
  // the group (of each warp of a block) hashes element l; with use_orbit
  // lane 3 the reservoir's uniform(fold_in(that key, 1), ())
  const int lane = g.lane();
  float u = 0.0f;
  if (lane < 3 || (lane == 3 && a.orbit_u != nullptr)) {
    uint32_t k1 = uint32_t(a.key[2 * chain]), k2 = uint32_t(a.key[2 * chain + 1]);
    fold_in(k1, k2, 3u);
    fold_in(k1, k2, uint32_t(total_steps));
    if (lane == 3) fold_in(k1, k2, 1u);
    u = uniform3_element(k1, k2, uint32_t(lane == 3 ? 0 : lane));
    if (g.rank < 3) a.u3[3 * size_t(chain) + lane] = u;
    if (g.rank == 3) a.orbit_u[chain] = u;
  }
  const float u0 = g.first(u);
  const int direction = at_start ? (T(u0) < T(0.5) ? -1 : 1) : in[I_DIRECTION];
  const bool fwd = direction > 0;
  const T eps_s = T(direction) * fl[F_EPS];
  const T half_eps = T(0.5) * eps_s;
  const T* ze = v + (fwd ? V_Z_PLUS : V_Z_MINUS) * dim;
  const T* pe = v + (fwd ? V_P_PLUS : V_P_MINUS) * dim;
  const T* ge = v + (fwd ? V_G_PLUS : V_G_MINUS) * dim;
  const T* im = a.adapt_vecs + size_t(chain) * N_ADAPT_VEC * dim + A_INV_MASS * dim;
  // slot D-1 stashes the old edge momentum for the cross U-turn checks
  T* stash = a.ckpt_p + (size_t(chain) * D + (D - 1)) * dim;
  bool moved = false;
  if constexpr (MICRO) {
    T* uh = a.mc_rows + size_t(chain) * 2 * dim;
    T* gtr = uh + dim;
    T dke1;
    if constexpr (LR) {
      if (at_start) {
        const T* ev = a.edge_v + (size_t(chain) * 2 + (fwd ? 1 : 0)) * dim;
        T* stash_v = a.ckpt_v + (size_t(chain) * D + (D - 1)) * dim;
        for (int i = g.rank; i < dim; i += G::kThreads) {
          stash[i] = pe[i];
          stash_v[i] = ev[i];
        }
      }
      lr_pull_back(g, m, dim, im, ge, gtr);
      dke1 = iso_update<T, 1, 0>(g, dim, pe, [&](int c) { return ld<1>(gtr, c); }, uh,
                                 half_eps);
      // the drift along A u = s (u + U c), c = (sqrt(L) - 1) (U^T u)
      T acc[kHalf] = {};
      m.pass();
      for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
        const int t = base / kLanes;
        const int i = base + lane;
        m.project(m.tile(t), t, i < dim ? uh[i] : T(0), acc);
        m.release(t);
      }
      m.pass();
      m.set_coefficients(g, acc, m.root_factor());
      for (int base = g.warp() * kLanes; base < dim; base += G::kThreads) {
        const int t = base / kLanes;
        const int i = base + lane;
        const T uc = m.expand(m.tile(t), t, i);
        m.release(t);
        if (i < dim) {
          const T z_e = ze[i];
          const T z = z_e + eps_s * (sqrt(im[i]) * (uh[i] + uc));
          zn[i] = z;
          moved = moved || (z != z_e);
        }
      }
    } else {
      if (at_start) each_chunk<KC>(g, dim / N, [&](int, int c) { st<N>(stash, c, ld<N>(pe, c)); });
      dke1 = iso_update<T, N, KC>(g, dim, pe, [&](int c) {
        const V gi = ld<N>(ge, c), mi = ld<N>(im, c);
        V r;
#pragma unroll
        for (int k = 0; k < N; ++k) r[k] = -(sqrt(mi[k]) * gi[k]);
        return r;
      }, uh, half_eps);
      each_chunk<KC>(g, dim / N, [&](int, int c) {
        const V z_e = ld<N>(ze, c), u = ld<N>(uh, c), mi = ld<N>(im, c);
        V z;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          z[k] = z_e[k] + eps_s * (sqrt(mi[k]) * u[k]);
          moved = moved || (z[k] != z_e[k]);
        }
        st<N>(zn, c, z);
      });
    }
    if (g.leader()) a.mc_dke[chain] = dke1;
  } else if constexpr (LR) {
    // the drift's velocity: its coefficients from w = s * p_half, then
    // z_new = z_e + eps * s (w + U c); the stash keeps its edge's velocity
    const T* ev = a.edge_v + (size_t(chain) * 2 + (fwd ? 1 : 0)) * dim;
    T* stash_v = a.ckpt_v + (size_t(chain) * D + (D - 1)) * dim;
    T acc[kHalf] = {};
    m.pass();
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
    m.pass();
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
  } else if (drift.valid && !at_start) {
    // the edge the last step extended, with the same step size and metric
    each_chunk<KC>(g, dim / N, [&](int j, int c) {
      if constexpr (KC > 0) st<N>(zn, c, drift.z[j]);
    });
    moved = drift.moved;
  } else {
    each_chunk<KC>(g, dim / N, [&](int, int c) {
      const V z_e = ld<N>(ze, c), p_e = ld<N>(pe, c), g_e = ld<N>(ge, c), mi = ld<N>(im, c);
      if (at_start) st<N>(stash, c, p_e);
      V z;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const T p_half = p_e[k] + half_eps * g_e[k];
        z[k] = z_e[k] + eps_s * (mi[k] * p_half);
        moved = moved || (z[k] != z_e[k]);
      }
      st<N>(zn, c, z);
    });
  }
  // an unintegrable step (eps below the position's resolution) is a
  // divergence; the next advance reads the flag
  const bool stagnant = !g.any(moved);
  if (g.leader()) a.stagnant[chain] = stagnant;
  in[I_DIRECTION] = direction;
}

// One launch of one chain: the second half of its step and the first half
// of its next (advance), or a first half alone.  A chain done before the
// launch is left alone (a first half hands its committed position).
template <typename T, bool LR, int N, int KC, bool DIV, bool ADAM, bool MICRO, typename G>
__device__ __forceinline__ void step_chain(const StepArgs<T>& a, int chain, const G& g,
                                           LowRank<T>& m) {
  const MkConfig& cfg = a.cfg;
  const int dim = cfg.dim;
  int in[N_INT];
#pragma unroll
  for (int k = 0; k < N_INT; ++k) in[k] = a.ints[size_t(chain) * N_INT + k];
  int next = -1;
  if constexpr (LR) next = next_active(a.ints, chain, cfg.n_chains, g.lane());
  if (in[I_DONE]) {
    if (!a.advance) {
      const T* pos = a.vecs + size_t(chain) * kNVec<DIV> * dim + V_POSITION * dim;
      T* zn = a.z_new + size_t(chain) * dim;
      each_chunk<KC>(g, dim / N, [&](int, int c) { st<N>(zn, c, ld<N>(pos, c)); });
    }
    return;
  }
  // the low-rank branch's basis sets out for shared memory (unless it is on
  // its way) before anything else is read
  if constexpr (LR) m.begin_chain(chain, next);
  T fl[N_FLT];
#pragma unroll
  for (int k = 0; k < N_FLT; ++k) fl[k] = a.flts[size_t(chain) * N_FLT + k];
  NextDrift<T, N, KC> drift;
  if (a.advance) finish_half<T, LR, N, KC, DIV, ADAM, MICRO>(a, chain, g, m, fl, in, drift);
  // every thread has read this step's uniforms and stagnant flag, which
  // the first half overwrites
  g.sync();
  if (!in[I_DONE]) begin_half<T, LR, N, KC, DIV, MICRO>(a, chain, g, m, fl, in, drift);
  // every thread has read the chain's scalars; one writes them back
  g.sync();
  if (g.leader()) {
    if (a.advance) {
#pragma unroll
      for (int k = 0; k < N_FLT; ++k) a.flts[size_t(chain) * N_FLT + k] = fl[k];
    }
#pragma unroll
    for (int k = 0; k < N_INT; ++k) a.ints[size_t(chain) * N_INT + k] = in[k];
  }
  // the chain's last pass over its basis is done: the next one's sets out
  if constexpr (LR) m.prefetch();
}

// The diagonal forms run one chain per group of W lanes; the low-rank one
// runs persistent blocks, block b the chains b, b + gridDim.x, ... in turn.
template <typename T, bool LR, int W, int N, int KC, bool DIV, bool ADAM, bool MICRO>
__global__ void __launch_bounds__(GroupOf<LR, W>::type::kBlockThreads, min_blocks<T, LR>())
    step_advance(StepArgs<T> a) {
  using G = typename GroupOf<LR, W>::type;
  if constexpr (LR) {
    const G g(step_smem + lr_layout<T>(a.cfg).red);
    LowRank<T> m = a.metric(g);
    for (int chain = blockIdx.x; chain < a.cfg.n_chains; chain += gridDim.x) {
      step_chain<T, true, 1, 0, DIV, ADAM, MICRO>(a, chain, g, m);
    }
  } else {
    const G g;
    const int chain = G::chain();
    if (chain >= a.cfg.n_chains) return;  // the whole group
    LowRank<T> m;
    step_chain<T, false, N, KC, DIV, ADAM, MICRO>(a, chain, g, m);
  }
}

// Raise the low-rank kernel's dynamic shared-memory cap to `bytes` before
// the first launch that needs them (every launch of a run asks for the same
// bytes, so once per instantiation and device).
template <typename T, bool DIV, bool ADAM, bool MICRO>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static size_t cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= cap[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(step_advance<T, true, 0, 1, 0, DIV, ADAM, MICRO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
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

// The diagonal forms (lanes a chain, coordinates a chunk, chunks held),
// in the order of sampler/step_kernel.py:diag_forms and of geometry(): held
// (16-byte chunks tiling a warp's 32 lanes, at most kHeld a thread) and
// strided (single coordinates, any number a thread).
template <typename T>
struct DiagForms {
  static constexpr int kCount = 2;
  static constexpr int lanes[kCount] = {kLanes / kVec<T>, kLanes};
  static constexpr int vec[kCount] = {kVec<T>, 1};
  static constexpr int held[kCount] = {kHeld, 0};
};

// The diagonal plan of `cfg` against the instantiations and what a launch
// needs: a known form, whole chunks (held forms: at most kHeld a thread),
// the grid, and every row a vector access touches on its boundary.  Returns
// the form's index, or -1.
template <typename T>
int diag_form(const MkConfig& cfg, const StepPtrs& p) {
  using F = DiagForms<T>;
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
  const void* rows[] = {p.vecs, p.ckpt_p, p.ckpt_s, p.adapt_vecs, p.mom, p.pos_out,
                        p.z_new, p.grad, p.grad_out, p.minv_out, p.div_start_out,
                        p.div_end_out, p.div_mom_out, p.div_grad_out, p.orbit,
                        p.orbit_pos_out, p.orbit_grad_out};
  for (const void* r : rows) {
    if (reinterpret_cast<uintptr_t>(r) % align != 0) return -1;
  }
  return form;
}

template <typename T, int W, int N, int KC, bool ADAM, bool MICRO>
void launch_diag_rows(const StepArgs<T>& a, cudaStream_t s) {
  if (a.cfg.store_divergences) {
    step_advance<T, false, W, N, KC, true, ADAM, MICRO>
        <<<a.cfg.step_grid, kLaneBlockThreads, 0, s>>>(a);
  } else {
    step_advance<T, false, W, N, KC, false, ADAM, MICRO>
        <<<a.cfg.step_grid, kLaneBlockThreads, 0, s>>>(a);
  }
}

template <typename T, int W, int N, int KC, bool MICRO>
void launch_diag_method(const StepArgs<T>& a, cudaStream_t s) {
  if (a.cfg.step_method == STEP_ADAM) {
    launch_diag_rows<T, W, N, KC, true, MICRO>(a, s);
  } else {
    launch_diag_rows<T, W, N, KC, false, MICRO>(a, s);
  }
}

// The diagonal form's instantiation with the divergence rows or without,
// for Adam or the other step-size methods, for the kinetic.
template <typename T, int W, int N, int KC>
cudaError_t launch_diag(const StepArgs<T>& a, cudaStream_t s) {
  if (a.cfg.micro) {
    launch_diag_method<T, W, N, KC, true>(a, s);
  } else {
    launch_diag_method<T, W, N, KC, false>(a, s);
  }
  return cudaGetLastError();
}

// The low-rank instantiation with the divergence rows or without, for Adam
// or the other step-size methods, for the kinetic: persistent blocks, each
// running its share of the chains.
template <typename T, bool DIV, bool ADAM, bool MICRO>
cudaError_t launch_lr(const StepArgs<T>& a, size_t smem, cudaStream_t s) {
  const cudaError_t err = allow_smem<T, DIV, ADAM, MICRO>(smem);
  if (err != cudaSuccess) return err;
  step_advance<T, true, 0, 1, 0, DIV, ADAM, MICRO><<<a.cfg.lr_grid, kLrThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool MICRO>
cudaError_t launch_lr_kinetic(const StepArgs<T>& a, size_t smem, cudaStream_t s) {
  const bool adam = a.cfg.step_method == STEP_ADAM;
  return a.cfg.store_divergences
             ? (adam ? launch_lr<T, true, true, MICRO>(a, smem, s)
                     : launch_lr<T, true, false, MICRO>(a, smem, s))
             : (adam ? launch_lr<T, false, true, MICRO>(a, smem, s)
                     : launch_lr<T, false, false, MICRO>(a, smem, s));
}

template <typename T>
int launch(bool advance, const MkConfig* cfg, const StepPtrs* p, void* stream) {
  const int R = cfg->lr_rank;
  if (cfg->n_chains < 1 || cfg->dim < 1 || cfg->depth_slots < 2 || R < 0 ||
      R > kMaxRank || (advance && (!p->logp || !p->grad)) ||
      (R > 0 && (!p->lr_basis || !p->lr_log_eigs || !p->edge_v || !p->ckpt_v)) ||
      (cfg->store_divergences &&
       (!p->div_start_out || !p->div_end_out || !p->div_mom_out || !p->div_grad_out)) ||
      (cfg->micro && (!p->mc_rows || !p->mc_dke || cfg->dim < 2))) {
    return int(cudaErrorInvalidValue);
  }
  const StepArgs<T> a(*cfg, *p, advance);
  const auto s = static_cast<cudaStream_t>(stream);
  if (R == 0) {
    switch (diag_form<T>(*cfg, *p)) {
      case 0: return int(launch_diag<T, kLanes / kVec<T>, kVec<T>, kHeld>(a, s));
      case 1: return int(launch_diag<T, kLanes, 1, 0>(a, s));
      default: return int(cudaErrorInvalidValue);
    }
  }
  // low-rank: persistent blocks, each running its share of the chains
  const int code = check_lr_plan<T>(*cfg, p->lr_basis);
  if (code != 0) return code;
  const size_t smem = lr_layout<T>(*cfg).bytes;
  return int(cfg->micro ? launch_lr_kinetic<T, true>(a, smem, s)
                        : launch_lr_kinetic<T, false>(a, smem, s));
}

template <typename K>
cudaError_t diag_geometry(K kernel, int32_t* out) {
  cudaFuncAttributes f;
  cudaError_t err = cudaFuncGetAttributes(&f, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kLaneBlockThreads, 0);
  }
  out[0] = f.numRegs;
  out[1] = int32_t(f.localSizeBytes);
  out[2] = blocks;
  return err;
}

// The held and strided forms, without and with the divergence rows.
template <typename T, bool ADAM, bool MICRO>
cudaError_t diag_forms_geometry(int32_t (*d)[3]) {
  cudaError_t err = diag_geometry(
      step_advance<T, false, kLanes / kVec<T>, kVec<T>, kHeld, false, ADAM, MICRO>, d[0]);
  if (err == cudaSuccess) {
    err = diag_geometry(step_advance<T, false, kLanes, 1, 0, false, ADAM, MICRO>, d[1]);
  }
  if (err == cudaSuccess) {
    err = diag_geometry(
        step_advance<T, false, kLanes / kVec<T>, kVec<T>, kHeld, true, ADAM, MICRO>, d[2]);
  }
  if (err == cudaSuccess) {
    err = diag_geometry(step_advance<T, false, kLanes, 1, 0, true, ADAM, MICRO>, d[3]);
  }
  return err;
}

// The low-rank instantiations' registers and local bytes: plain, Adam,
// with the rows, Adam with the rows.
template <typename T, bool MICRO>
cudaError_t lr_geometry(int32_t* out) {
  cudaFuncAttributes f[4];
  cudaError_t err =
      cudaFuncGetAttributes(&f[0], step_advance<T, true, 0, 1, 0, false, false, MICRO>);
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&f[1], step_advance<T, true, 0, 1, 0, false, true, MICRO>);
  }
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&f[2], step_advance<T, true, 0, 1, 0, true, false, MICRO>);
  }
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&f[3], step_advance<T, true, 0, 1, 0, true, true, MICRO>);
  }
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = err == cudaSuccess ? f[k].numRegs : 0;
    out[2 * k + 1] = err == cudaSuccess ? int32_t(f[k].localSizeBytes) : 0;
  }
  return err;
}

// What was compiled: for each diagonal form (DiagForms' order), without and
// then with the divergence rows, then the same four for Adam, the
// registers and local (spill) bytes per thread and the blocks an SM holds;
// the threads of their block; then the low-rank instantiation's registers,
// local bytes and threads, the registers and local bytes of its Adam
// instantiation, of the one with the rows and of Adam's with the rows, and
// for the low-rank plan in `cfg` (lr_rank > 0; zeros otherwise) the dynamic
// shared-memory bytes of a block and the blocks an SM holds; then the
// microcanonical kinetic's instantiations: the eight diagonal ones in the
// same order, and the four low-rank ones' registers and local bytes.
template <typename T>
int geometry(const MkConfig* cfg, int32_t* out) {
  int32_t d[16][3];
  cudaError_t err = diag_forms_geometry<T, false, false>(d);
  if (err == cudaSuccess) err = diag_forms_geometry<T, true, false>(d + 4);
  if (err == cudaSuccess) err = diag_forms_geometry<T, false, true>(d + 8);
  if (err == cudaSuccess) err = diag_forms_geometry<T, true, true>(d + 12);
  int32_t lr[8], lr_micro[8];
  if (err == cudaSuccess) err = lr_geometry<T, false>(lr);
  if (err == cudaSuccess) err = lr_geometry<T, true>(lr_micro);
  if (err != cudaSuccess) return int(err);
  out[0] = d[0][0]; out[1] = d[0][1]; out[2] = d[0][2];
  out[3] = d[1][0]; out[4] = d[1][1]; out[5] = d[1][2];
  out[6] = d[2][0]; out[7] = d[2][1]; out[8] = d[2][2];
  out[9] = d[3][0]; out[10] = d[3][1]; out[11] = d[3][2];
  out[12] = d[4][0]; out[13] = d[4][1]; out[14] = d[4][2];
  out[15] = d[5][0]; out[16] = d[5][1]; out[17] = d[5][2];
  out[18] = d[6][0]; out[19] = d[6][1]; out[20] = d[6][2];
  out[21] = d[7][0]; out[22] = d[7][1]; out[23] = d[7][2];
  out[24] = kLaneBlockThreads;
  out[25] = lr[0];
  out[26] = lr[1];
  out[27] = kLrThreads;
  out[28] = lr[2];
  out[29] = lr[3];
  out[30] = lr[4];
  out[31] = lr[5];
  out[32] = lr[6];
  out[33] = lr[7];
  out[34] = out[35] = 0;
  out[36] = d[8][0]; out[37] = d[8][1]; out[38] = d[8][2];
  out[39] = d[9][0]; out[40] = d[9][1]; out[41] = d[9][2];
  out[42] = d[10][0]; out[43] = d[10][1]; out[44] = d[10][2];
  out[45] = d[11][0]; out[46] = d[11][1]; out[47] = d[11][2];
  out[48] = d[12][0]; out[49] = d[12][1]; out[50] = d[12][2];
  out[51] = d[13][0]; out[52] = d[13][1]; out[53] = d[13][2];
  out[54] = d[14][0]; out[55] = d[14][1]; out[56] = d[14][2];
  out[57] = d[15][0]; out[58] = d[15][1]; out[59] = d[15][2];
  out[60] = lr_micro[0]; out[61] = lr_micro[1];
  out[62] = lr_micro[2]; out[63] = lr_micro[3];
  out[64] = lr_micro[4]; out[65] = lr_micro[5];
  out[66] = lr_micro[6]; out[67] = lr_micro[7];
  if (cfg == nullptr || cfg->lr_rank < 1) return 0;
  // the plan as a launch checks it, without a basis to align
  MkConfig c = *cfg;
  c.lr_tma = 0;
  const int code = check_lr_plan<T>(c, nullptr);
  if (code != 0) return code;
  const size_t smem = lr_layout<T>(c).bytes;
  int blocks = 0;
  err = allow_smem<T, false, false, false>(smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, step_advance<T, true, 0, 1, 0, false, false, false>, kLrThreads, smem);
  }
  if (err != cudaSuccess) return int(err);
  out[34] = int32_t(smem);
  out[35] = blocks;
  return 0;
}

}  // namespace nutpie

extern "C" {

// Launch a first half (begin) or a second half with the next first half
// (advance) for every chain on `stream`; returns the CUDA error code of the
// launch (0 = queued).
// A library built with NUTPIE_STEP_F32 (NUTPIE_STEP_F64) holds the float32
// (float64) instantiations alone; built with both, it holds neither, only
// the device query below (ops/build.py:VARIANTS).
#ifndef NUTPIE_STEP_F64
int nutpie_step_begin_f32(const nutpie::MkConfig* cfg, const nutpie::StepPtrs* p,
                          void* stream) {
  return nutpie::launch<float>(false, cfg, p, stream);
}

int nutpie_step_advance_f32(const nutpie::MkConfig* cfg, const nutpie::StepPtrs* p,
                            void* stream) {
  return nutpie::launch<float>(true, cfg, p, stream);
}

int nutpie_step_geometry_f32(const nutpie::MkConfig* cfg, int32_t* out) {
  return nutpie::geometry<float>(cfg, out);
}
#endif

#ifndef NUTPIE_STEP_F32
int nutpie_step_begin_f64(const nutpie::MkConfig* cfg, const nutpie::StepPtrs* p,
                          void* stream) {
  return nutpie::launch<double>(false, cfg, p, stream);
}

int nutpie_step_advance_f64(const nutpie::MkConfig* cfg, const nutpie::StepPtrs* p,
                            void* stream) {
  return nutpie::launch<double>(true, cfg, p, stream);
}

int nutpie_step_geometry_f64(const nutpie::MkConfig* cfg, int32_t* out) {
  return nutpie::geometry<double>(cfg, out);
}
#endif

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
