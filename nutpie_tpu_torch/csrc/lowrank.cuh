// The low-rank metric's products for the step kernel (step_kernel.cu) and
// the MCLMC kernel (mclmc.cu), run by a block of kLrWarps warps per chain
// with the chain's basis in shared memory.
//
// The metric of nutpie_tpu_torch/sampler/low_rank.py (the JAX package's
// nutpie_tpu/sampler/low_rank.py:46-68):
//   M^{-1} = D^{1/2} (I + U (Lambda - I) U^T) D^{1/2},
// with D the diagonal inverse mass (s = sqrt(D)), U [dim, R] orthonormal
// columns stored row-major per chain, and Lambda = exp(log_eigs):
//   velocity  v = s (w + U c),   w = s p,  c_r = (lambda_r - 1) (w^T U)_r
//   momentum  p = (z + U c) / s,           c_r = (lambda_r^{-1/2} - 1) (z^T U)_r
//
// What bounds it on this card: bytes, and most of them the basis (128 KB a
// chain in float32 at dim 1000, R 32, against a few 4 KB rows).  So each
// launch reads the basis from device memory once where it fits in shared
// memory, and keeps a whole basis per SM in flight:
//   - tiles: the basis is cut into tiles of kTileRows rows, one warp's
//     block of 32 coordinates; warp w owns tiles w, w + kLrWarps, ..., the
//     same coordinates its threads own in every strided loop of the step;
//   - staged (the basis fits beside the block's other shared memory, one
//     block an SM): each warp's lane 0 issues a TMA bulk copy
//     (cp.async.bulk, completion on one mbarrier per tile) of every tile
//     its warp reads; every application of the launch (the new point's
//     velocity; a new draw's momentum and its velocity; the next step's
//     drift) reads the staged tiles, so a machine step reads a chain's
//     basis once.  The blocks are persistent (step_kernel.cu), and as soon
//     as a chain's last pass of the launch is done each warp sends its
//     tiles of the block's next active chain on their way (`prefetch`), so
//     the next basis arrives while the block finishes this chain and reads
//     the next one's scalars and rows;
//   - streamed (it does not fit, e.g. float64 at dim 1000, R 32): each warp
//     streams its tiles through a ring of kRingStages slots of its own, a
//     bulk copy kRingStages tiles ahead of the one it reads, once for the
//     projection and again for the expansion (two device reads per
//     application);
//   - where a bulk copy's 16-byte alignment does not hold (a chain's basis
//     of dim R itemsize bytes not a multiple of 16, e.g. dim 33, R 5,
//     float32), the warp copies its tiles with ordinary loads instead.
// sampler/step_kernel.py:low_rank_plan chooses the form and the copy before
// anything runs, and lays out the shared memory as LrLayout does.
//
// The products, each lane on the row of the coordinate it owns: with one
// block a chain and so 8 warps an SM, the products run out of warps to
// hide latency in, so every product of a row is independent of the last
// (a first version, each lane summing one rank over the rows through a
// shuffle per row, spent most of the launch waiting on that chain):
//   - the projection w^T U: two lanes to a row, each lane keeps 16
//     partials for half the ranks, XOR-rotated by its row so that the 32
//     lanes read 32 distinct banks, over the rows it takes; each half-warp
//     then reduce-scatters them (15 shuffles), and the warps' sums are
//     added in warp order (group.cuh, sum_lanes);
//   - the expansion (U c)_d: the lane that owns coordinate d reads U's row
//     d and the coefficients from shared memory, rank k ^ lane at step k,
//     into four partial sums added in a fixed order.
// Every sum order is fixed, so reruns are bitwise repeatable.  R <= 32.
#pragma once

#include <cstdint>

#include "warp.cuh"

namespace nutpie {

constexpr int kMaxRank = kLanes;
// warps per chain of the low-rank instantiations
constexpr int kLrWarps = 8;
// basis rows per tile: one warp's block of coordinates
constexpr int kTileRows = kLanes;
// ring slots per warp of the streamed form: a copy in flight while the
// warp reads a tile
constexpr int kRingStages = 2;
// ranks per lane in the projection (two lanes to a row, half the ranks each)
constexpr int kHalf = kLanes / 2;

__host__ __device__ inline size_t lr_align(size_t bytes, size_t to) {
  return (bytes + to - 1) / to * to;
}

// Dynamic shared memory of a low-rank block, in bytes from its start: the
// barriers (one per tile staged, one per ring slot streamed), the block
// reductions' scratch and each warp's copy of the coefficients (kLrWarps *
// 32 values each), then the tiles (the whole basis staged, kLrWarps *
// kRingStages slots of one tile streamed).  Mirrored by
// sampler/step_kernel.py:lr_smem_bytes, which the plan decides by; the
// build phase of chip_smoke.py holds the two equal on the card.
struct LrLayout {
  int n_tiles, tile_elems, n_bars;
  size_t red, coef, tiles, bytes;

  __host__ __device__ LrLayout(int dim, int rank, int itemsize, bool streamed) {
    n_tiles = (dim + kTileRows - 1) / kTileRows;
    tile_elems = kTileRows * rank;
    n_bars = streamed ? kLrWarps * kRingStages : n_tiles;
    red = lr_align(size_t(n_bars) * sizeof(uint64_t), 16);
    coef = red + size_t(kLrWarps) * kLanes * itemsize;
    tiles = lr_align(coef + size_t(kLrWarps) * kLanes * itemsize, 128);
    bytes = tiles + (streamed ? size_t(kLrWarps) * kRingStages * tile_elems * itemsize
                              : lr_align(size_t(dim) * rank * itemsize, 16));
  }
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_addr(bar)) : "memory");
}

// The barriers' initialization, visible to the copy engine.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: `bytes` expected on `bar`, and a bulk copy of them from
// device memory to shared memory that completes on it.  Both addresses
// 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = shared_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = shared_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread's view of the metric of the chain its block runs: the basis
// in device memory, its tiles in shared memory, and the lane's rank (lane
// r holds log_eig_r; lanes >= R hold 0).  A block runs chain after chain
// (step_kernel.cu); `begin_chain` takes up the next.  A pass over the basis
// is a loop over the warp's tiles, t = warp, warp + kLrWarps, ...:
// `pass()` before it, `tile(t)` before the tile's rows are read and
// `release(t)` after.  Staged by TMA,
// the block's next active chain's basis sets out into the tiles as soon as
// the chain is done with them (`prefetch`), so that it arrives while the
// block finishes this chain and reads the next one's scalars and rows.
template <typename T>
struct LowRank {
  const T* basis = nullptr;     // every chain's [dim, R] basis, row-major
  const T* log_eigs = nullptr;  // [C, R]
  const T* U = nullptr;         // the current chain's basis
  T* tiles = nullptr;           // shared: the staged basis, or the block's ring slots
  T* coef = nullptr;            // shared: this warp's copy of the coefficients c
  uint64_t* bars = nullptr;
  int R = 0, dim = 0, n_tiles = 0, tile_elems = 0, warp = 0, lane = 0;
  bool streamed = false, tma = false;
  int chain = -1;   // the chain the block runs
  int next = -1;    // the block's next active chain (-1: none in sight)
  int staged = -1;  // staged: the chain whose basis the tiles hold or are receiving
  bool fresh = false;  // the chain's first pass is still to come
  uint32_t stagings = 0;           // staged by TMA: the warp's stagings issued
  uint32_t fetched = 0, used = 0;  // streamed: the warp's tile copies issued, and read
  T log_eig = T(0);

  LowRank() = default;

  // Called by every thread of the block before its first chain: each
  // warp's lane 0 initializes the barriers of the warp's tiles or slots.
  __device__ __forceinline__ LowRank(const MkConfig& cfg, const T* basis_, const T* log_eigs_,
                                     unsigned char* smem, const LrLayout& lay, int warp_,
                                     int lane_)
      : basis(basis_), log_eigs(log_eigs_),
        tiles(reinterpret_cast<T*>(smem + lay.tiles)),
        coef(reinterpret_cast<T*>(smem + lay.coef) + warp_ * kLanes),
        bars(reinterpret_cast<uint64_t*>(smem)),
        R(cfg.lr_rank), dim(cfg.dim), n_tiles(lay.n_tiles), tile_elems(lay.tile_elems),
        warp(warp_), lane(lane_),
        streamed(cfg.lr_streamed != 0), tma(cfg.lr_tma != 0) {
    if (tma && lane == 0) {
      if (streamed) {
        for (int k = 0; k < kRingStages; ++k) mbar_init(bars + warp * kRingStages + k);
      } else {
        for (int t = warp; t < n_tiles; t += kLrWarps) mbar_init(bars + t);
      }
      mbar_init_fence();
    }
    __syncwarp();
  }

  // (lambda_r - 1), the velocity's coefficient factor, in lane r
  __device__ __forceinline__ T velocity_factor() const { return exp(log_eig) - T(1); }
  // (lambda_r^{-1/2} - 1), the momentum's
  __device__ __forceinline__ T momentum_factor() const {
    return exp(T(-0.5) * log_eig) - T(1);
  }
  // (lambda_r^{1/2} - 1), that of A and A^T (the microcanonical kinetic:
  // A = D^{1/2}(I + U (Lambda^{1/2} - I) U^T))
  __device__ __forceinline__ T root_factor() const { return exp(T(0.5) * log_eig) - T(1); }

  __device__ __forceinline__ int rows(int t) const {
    const int n = dim - t * kTileRows;
    return n < kTileRows ? n : kTileRows;
  }

  // Tile t of the basis at `src` into `dst`: one bulk copy from lane 0, or
  // the warp's own loads.
  __device__ __forceinline__ void copy(const T* src, int t, T* dst, uint64_t* bar) {
    src += size_t(t) * tile_elems;
    const int n = rows(t) * R;
    if (tma) {
      if (lane == 0) bulk_copy(dst, src, uint32_t(n * sizeof(T)), bar);
    } else {
      for (int k = lane; k < n; k += kLanes) dst[k] = src[k];
      __syncwarp();
    }
  }

  // Take up chain c (uniform over the block), whose successor in the
  // block's order is `next_chain`: its log eigenvalue, and its basis
  // staged (unless prefetched) or its first tiles streamed.
  __device__ __forceinline__ void begin_chain(int c, int next_chain) {
    chain = c;
    next = next_chain;
    U = basis + size_t(c) * dim * R;
    log_eig = lane < R ? log_eigs[size_t(c) * R + lane] : T(0);
    if (streamed) {
      rewind();
    } else {
      use(c);
    }
    fresh = true;
  }

  // Before each pass over the chain's basis: its first pass finds the
  // tiles begin_chain set out; every later one streams them anew.
  __device__ __forceinline__ void pass() {
    if (fresh) {
      fresh = false;
    } else {
      rewind();
    }
  }

  // Staged: the tiles hold (or receive) chain c's basis; a copy still on
  // its way into them lands first.
  __device__ __forceinline__ void use(int c) {
    if (streamed || staged == c) return;
    if (tma && staged >= 0) {
      for (int t = warp; t < n_tiles; t += kLrWarps) mbar_wait(bars + t, (stagings - 1u) & 1u);
    }
    __syncwarp();  // the warp's lanes are done with the tiles
    const T* src = basis + size_t(c) * dim * R;
    for (int t = warp; t < n_tiles; t += kLrWarps) {
      copy(src, t, tiles + size_t(t) * tile_elems, bars + t);
    }
    if (tma) ++stagings;
    staged = c;
  }

  // Staged by TMA, after the chain's last pass: the next chain's basis
  // sets out into the tiles.
  __device__ __forceinline__ void prefetch() {
    if (tma && !streamed && next >= 0) use(next);
  }

  // Staged by TMA, in the chain's last pass as soon as the warp is done
  // with tile t: the block's next chain's tile t sets out into it, so the
  // copies overlap the rest of the pass (the MCLMC kernel's half-step);
  // prefetched() closes the staging after the pass.  Elsewhere nothing.
  __device__ __forceinline__ void prefetch_tile(int t) {
    if (!tma || streamed || next < 0 || staged == next) return;
    __syncwarp();  // the warp's lanes are done with tile t
    copy(basis + size_t(next) * dim * R, t, tiles + size_t(t) * tile_elems, bars + t);
  }

  __device__ __forceinline__ void prefetched() {
    if (!tma || streamed || next < 0 || staged == next) return;
    ++stagings;
    staged = next;
  }

  __device__ __forceinline__ void fetch(int t) {
    const int slot = warp * kRingStages + int(fetched % uint32_t(kRingStages));
    copy(U, t, tiles + size_t(slot) * tile_elems, bars + slot);
    ++fetched;
  }

  // Streamed: the first tiles of the chain's next pass.
  __device__ __forceinline__ void rewind() {
    if (!streamed) return;
    for (int k = 0; k < kRingStages; ++k) {
      const int t = warp + k * kLrWarps;
      if (t < n_tiles) fetch(t);
    }
  }

  // The rows of tile t in shared memory, once they have arrived.
  __device__ __forceinline__ const T* tile(int t) {
    if (!streamed) {
      if (tma) mbar_wait(bars + t, (stagings - 1u) & 1u);
      return tiles + size_t(t) * tile_elems;
    }
    const int slot = warp * kRingStages + int(used % uint32_t(kRingStages));
    if (tma) mbar_wait(bars + slot, (used / uint32_t(kRingStages)) & 1u);
    return tiles + size_t(slot) * tile_elems;
  }

  // Done with tile t; streamed, its slot takes the pass's tile
  // kRingStages further on.
  __device__ __forceinline__ void release(int t) {
    if (!streamed) return;
    __syncwarp();
    ++used;
    const int next_tile = t + kRingStages * kLrWarps;
    if (next_tile < n_tiles) fetch(next_tile);
  }

  // Adds tile t's share of w^T U (`u`; wd is w at the calling lane's
  // coordinate of the tile, 0 past dim) to the lane's kHalf partials: lane
  // l = 16 h + j takes rows j and 16 + j of the tile, and acc[k] holds rank
  // 16 h + (k ^ j), so that the 32 lanes read 32 distinct banks and every
  // product is independent of the last.
  __device__ __forceinline__ void project(const T* u, int t, T wd, T (&acc)[kHalf]) const {
    const int j = lane & (kHalf - 1), h = lane / kHalf;
    const int n = rows(t);
    const T w0 = __shfl_sync(kFullMask, wd, j);
    const T w1 = __shfl_sync(kFullMask, wd, j + kHalf);
    // rows past the tile's end have w = 0; they read its first row
    const T* row0 = u + (j < n ? j : 0) * R;
    const T* row1 = u + (j + kHalf < n ? j + kHalf : 0) * R;
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const int r = kHalf * h + (k ^ j);
      if (r < R) {
        acc[k] += w0 * row0[r];
        acc[k] += w1 * row1[r];
      }
    }
  }

  // c_r = factor_r (w^T U)_r from every thread's partials (acc, consumed),
  // into this warp's copy of the coefficients for expand(): each half-warp
  // reduce-scatters its rotated partials (after the stage of distance m,
  // lane l = 16 h + j holds in each kept k < m the sum over its group of
  // lanes for rank 16 h + (k ^ j)), so lane r holds the warp's sum for rank
  // r; then the warps' sums are added in warp order (group.cuh).  Called by
  // every thread of the block.
  template <typename G>
  __device__ __forceinline__ void set_coefficients(const G& g, T (&acc)[kHalf], T factor) {
    scatter_stage<8>(acc);
    scatter_stage<4>(acc);
    scatter_stage<2>(acc);
    scatter_stage<1>(acc);
    coef[lane] = factor * g.sum_lanes(acc[0]);
    __syncwarp();
  }

  template <int M>
  static __device__ __forceinline__ void scatter_stage(T (&acc)[kHalf]) {
    static_assert(2 * M <= kHalf, "stages of a half-warp");
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] += __shfl_xor_sync(kFullMask, acc[k + M], M);
  }

  // (U c)_i for the calling lane's coordinate i of tile t (`u`; any row
  // past dim, whose result is unused), from this warp's coefficients: four
  // partial sums over the ranks k ^ lane, k = 0, 4, ... / 1, 5, ... / ...,
  // added in a fixed order.
  __device__ __forceinline__ T expand(const T* u, int t, int i) const {
    const T* row = u + (i < dim ? i - t * kTileRows : 0) * R;
    T part[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int r = k ^ lane;
      if (r < R) part[k & 3] += row[r] * coef[r];
    }
    return (part[0] + part[1]) + (part[2] + part[3]);
  }
};

}  // namespace nutpie
