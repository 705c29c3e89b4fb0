// The threads that run one chain in the step kernel (step_kernel.cu), as a
// policy its step body is written against once.
//
// Every coordinate loop strides over the chain's coordinates by the
// group's size from the thread's rank in the group, so a thread owns the
// same coordinates in every loop of a launch and never reads a row
// element another thread wrote.  Every reduction leaves the same bits in
// every thread of the group, so each decision is computed from the same
// values everywhere and no thread waits for another to decide.
//
//   - WarpGroup: one warp per chain (the diagonal instantiations, four
//     chains per block); reductions are xor butterflies (warp.cuh).
//   - BlockGroup<W>: W warps per chain, one chain per block (the low-rank
//     instantiations); a butterfly in each warp, then the W partials
//     combined in warp order through shared memory, which every thread
//     reads back.  Its block-wide operations must be reached by every
//     thread of the block, so they sit outside any loop whose trip count
//     differs between warps.
#pragma once

#include "warp.cuh"

namespace nutpie {

struct WarpGroup {
  static constexpr int kThreads = kLanes;
  static constexpr int kChainsPerBlock = 4;
  static constexpr int kBlockThreads = kChainsPerBlock * kThreads;

  int rank;  // the lane

  __device__ __forceinline__ WarpGroup() : rank(threadIdx.x & (kLanes - 1)) {}

  static __device__ __forceinline__ int chain() {
    return blockIdx.x * kChainsPerBlock + threadIdx.x / kLanes;
  }
  __device__ __forceinline__ int lane() const { return rank; }
  __device__ __forceinline__ bool leader() const { return rank == 0; }

  template <typename T, int N>
  __device__ __forceinline__ void sum(T (&v)[N]) const { warp_sum(v); }
  template <typename T>
  __device__ __forceinline__ T max(T v) const { return warp_max(v); }
  __device__ __forceinline__ bool any(bool p) const { return __any_sync(kFullMask, p); }
  __device__ __forceinline__ bool all(bool p) const { return __all_sync(kFullMask, p); }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
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

  // Sum N values over the block: each warp's butterfly, then the warps'
  // sums added in warp order.
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

  __device__ __forceinline__ bool any(bool p) const { return __syncthreads_or(p) != 0; }
  __device__ __forceinline__ bool all(bool p) const { return __syncthreads_and(p) != 0; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

}  // namespace nutpie
