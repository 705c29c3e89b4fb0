// The threads that run one chain in the step kernel (step_kernel.cu), as a
// policy its step body is written against once.
//
// A chain's coordinates are cut into chunks of N consecutive coordinates
// (N = 1, or the 16 bytes a vector load moves: 4 in float32, 2 in
// float64), and the thread of rank r in the group owns the chunks r, r +
// kThreads, r + 2 kThreads, ... (each_chunk).  So a thread owns the same
// coordinates in every loop of a launch and never reads a row element
// another thread wrote, and neighbouring threads touch neighbouring
// addresses.  Every reduction leaves the same bits in every thread of the
// group, so each decision is computed from the same values everywhere and
// no thread waits for another to decide.
//
//   - LaneGroup<W>: W lanes of a warp per chain, W N = 32 (W = 8 with
//     float4 chunks, 16 with double2 chunks, or 32 with single
//     coordinates), the diagonal instantiations; 32 / W chains share a
//     warp, 128 threads a block.  A sum adds in the order of one warp
//     whose lane v takes coordinates v, v + 32, ... in turn and then
//     reduces by an xor butterfly: lane r's element k is that warp's lane
//     N r + k, the butterfly's strides of N or more are shuffles within
//     the W lanes under the group's own mask, and the smaller ones adds
//     within the thread.  So every form sums in one order whatever its
//     width, and chains of one warp may take different branches (a draw's
//     end, a U-turn check) without waiting on each other.
//   - BlockGroup<W>: W warps per chain, one chain per block (the low-rank
//     instantiations); a butterfly in each warp, then the W partials
//     combined in warp order through shared memory, which every thread
//     reads back.  Its block-wide operations must be reached by every
//     thread of the block, so they sit outside any loop whose trip count
//     differs between warps.
#pragma once

#include "warp.cuh"

namespace nutpie {

// threads of a block of the diagonal instantiations
constexpr int kLaneBlockThreads = 128;

template <int W>
struct LaneGroup {
  static_assert(W == 8 || W == 16 || W == 32, "a lane group is 8, 16 or 32 lanes");
  // coordinates a chunk of this width: the group's chunks tile a warp's 32
  static constexpr int kVecWidth = kLanes / W;
  static constexpr int kThreads = W;
  static constexpr int kChainsPerBlock = kLaneBlockThreads / W;
  static constexpr int kBlockThreads = kLaneBlockThreads;

  int rank;       // the lane in the group
  unsigned mask;  // the group's lanes in the warp

  __device__ __forceinline__ LaneGroup()
      : rank(threadIdx.x & (W - 1)),
        mask(W == kLanes ? kFullMask
                         : ((1u << W) - 1u) << ((threadIdx.x & (kLanes - 1)) & ~(W - 1))) {}

  static __device__ __forceinline__ int chain() {
    return blockIdx.x * kChainsPerBlock + threadIdx.x / W;
  }
  __device__ __forceinline__ int lane() const { return rank; }
  __device__ __forceinline__ bool leader() const { return rank == 0; }

  // Sum K values over the group from each thread's partials per element
  // of its chunks (acc[q][k]: element k of the thread's chunks, added in
  // chunk order; consumed), into out[q] in every lane of the group: the
  // butterfly of a 32-lane warp whose lane N r + k holds acc[q][k] of lane
  // r (see above).
  template <typename T, int K, int N>
  __device__ __forceinline__ void sum(T (&acc)[K][N], T (&out)[K]) const {
    static_assert(N == kVecWidth, "a group's chunks tile a warp's 32 lanes");
#pragma unroll
    for (int off = kLanes / 2; off >= N; off >>= 1) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
#pragma unroll
        for (int k = 0; k < N; ++k) acc[q][k] += __shfl_xor_sync(mask, acc[q][k], off / N, W);
      }
    }
#pragma unroll
    for (int off = N / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          if ((k & off) == 0) {
            const T t = acc[q][k] + acc[q][k | off];
            acc[q][k] = t;
            acc[q][k | off] = t;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) out[q] = acc[q][0];
  }
  template <typename T>
  __device__ __forceinline__ T max(T v) const {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) v = jmax(v, __shfl_xor_sync(mask, v, off, W));
    return v;
  }
  // the value of the group's first lane
  template <typename T>
  __device__ __forceinline__ T first(T v) const { return __shfl_sync(mask, v, 0, W); }
  __device__ __forceinline__ bool any(bool p) const { return __any_sync(mask, p); }
  __device__ __forceinline__ bool all(bool p) const { return __all_sync(mask, p); }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

template <int W>
struct BlockGroup {
  static constexpr int kThreads = W * kLanes;
  static constexpr int kChainsPerBlock = 1;
  static constexpr int kBlockThreads = kThreads;

  int rank;       // the thread in the block
  void* scratch;  // shared, room for W * kLanes values of the kernel's type

  __device__ __forceinline__ explicit BlockGroup(void* shared)
      : rank(threadIdx.x), scratch(shared) {}

  static __device__ __forceinline__ int chain() { return blockIdx.x; }
  __device__ __forceinline__ int lane() const { return rank & (kLanes - 1); }
  __device__ __forceinline__ int warp() const { return rank / kLanes; }
  __device__ __forceinline__ bool leader() const { return rank == 0; }

  // Sum K values over the block from each thread's partials (acc[q][0];
  // the block's chunks are single coordinates) into out[q]: each warp's
  // butterfly, then the warps' sums added in warp order.
  template <typename T, int K>
  __device__ __forceinline__ void sum(T (&acc)[K][1], T (&out)[K]) const {
#pragma unroll
    for (int q = 0; q < K; ++q) out[q] = acc[q][0];
    sum(out);
  }
  template <typename T, int N>
  __device__ __forceinline__ void sum(T (&v)[N]) const {
    static_assert(N <= kLanes, "a block sum takes at most 32 values");
    warp_sum(v);
    T* red = static_cast<T*>(scratch);
    __syncthreads();  // the scratch's last readers are done
    if (lane() == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) red[warp() * N + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
      T s = red[k];
      for (int w = 1; w < W; ++w) s += red[w * N + k];
      v[k] = s;
    }
  }

  // NaN-propagating max over the block, combined in warp order.
  template <typename T>
  __device__ __forceinline__ T max(T v) const {
    v = warp_max(v);
    T* red = static_cast<T*>(scratch);
    __syncthreads();
    if (lane() == 0) red[warp()] = v;
    __syncthreads();
    T m = red[0];
    for (int w = 1; w < W; ++w) m = jmax(m, red[w]);
    return m;
  }

  // Lane l's value summed over the warps in warp order, into lane l of
  // every warp (the low-rank projection's partial for rank l).
  template <typename T>
  __device__ __forceinline__ T sum_lanes(T v) const {
    T* red = static_cast<T*>(scratch);
    __syncthreads();
    red[rank] = v;
    __syncthreads();
    T s = red[lane()];
    for (int w = 1; w < W; ++w) s += red[w * kLanes + lane()];
    return s;
  }

  // lane 0's value in each warp (every warp computes the values it shares)
  template <typename T>
  __device__ __forceinline__ T first(T v) const { return __shfl_sync(kFullMask, v, 0); }
  __device__ __forceinline__ bool any(bool p) const { return __syncthreads_or(p) != 0; }
  __device__ __forceinline__ bool all(bool p) const { return __syncthreads_and(p) != 0; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// N consecutive values of a row, moved by one load or store (16 bytes at
// N = 4 in float32 and N = 2 in float64).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
  __device__ __forceinline__ T& operator[](int k) { return v[k]; }
  __device__ __forceinline__ const T& operator[](int k) const { return v[k]; }
};

// chunk c of a row (its coordinates c N .. c N + N - 1)
template <int N, typename T>
__device__ __forceinline__ Vec<T, N> ld(const T* row, int c) {
  return reinterpret_cast<const Vec<T, N>*>(row)[c];
}
template <int N, typename T>
__device__ __forceinline__ void st(T* row, int c, const Vec<T, N>& x) {
  reinterpret_cast<Vec<T, N>*>(row)[c] = x;
}
template <int N, typename T>
__device__ __forceinline__ Vec<T, N> splat(T x) {
  Vec<T, N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = x;
  return r;
}

// f(j, c) for each chunk c < n_chunks the calling thread owns.  KC > 0:
// the thread owns at most KC chunks (the plan guarantees it), the loop is
// unrolled and j < KC numbers them, so values a loop keeps in arrays
// indexed by j stay in registers for a later loop; KC = 0: any number of
// chunks, j = 0.
template <int KC, typename G, typename F>
__device__ __forceinline__ void each_chunk(const G& g, int n_chunks, F&& f) {
  if constexpr (KC > 0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int c = g.rank + j * G::kThreads;
      if (c < n_chunks) f(j, c);
    }
  } else {
    for (int c = g.rank; c < n_chunks; c += G::kThreads) f(0, c);
  }
}

}  // namespace nutpie
