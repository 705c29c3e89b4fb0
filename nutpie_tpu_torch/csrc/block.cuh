// Block-wide reductions and the scalar helpers of the NUTS chunk kernel.
//
// Every reduction returns the same value in every thread: warps reduce with
// xor-shuffle butterflies (each pair adds a + b and b + a, which IEEE makes
// equal), then every thread adds the warp partials in the same order.  The
// order is fixed, so reruns are bitwise repeatable.
#pragma once

#include <cmath>

#include "layout.cuh"

#define MK_FOR_COORDS(i, n) \
  for (int i = threadIdx.x; i < (n); i += ::nutpie::kThreads)

namespace nutpie {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum N values over the block.  `red` holds kWarps * kRed values; N <= kRed.
template <typename T, int N>
__device__ inline void block_sum(T (&v)[N], T* red) {
  static_assert(N <= kRed, "too many values for one reduction");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_xor_sync(kFullMask, v[k], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * kRed + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T s = red[k];
    for (int w = 1; w < kWarps; ++w) s += red[w * kRed + k];
    v[k] = s;
  }
  __syncthreads();
}

// NaN-propagating max/min, as jnp.maximum/jnp.minimum and torch's.
template <typename T>
__device__ inline T jmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ inline T jmin(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// clip(x, lo, hi) = min(max(x, lo), hi) with NaN passing through.
template <typename T>
__device__ inline T jclip(T x, T lo, T hi) {
  return jmin(jmax(x, lo), hi);
}

// Max of one value over the block (NaN-propagating).
template <typename T>
__device__ inline T block_max(T v, T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = jmax(v, __shfl_xor_sync(kFullMask, v, off));
  }
  if (lane == 0) red[warp * kRed] = v;
  __syncthreads();
  T s = red[0];
  for (int w = 1; w < kWarps; ++w) s = jmax(s, red[w * kRed]);
  __syncthreads();
  return s;
}

// jnp.logaddexp: equal infinities (and NaNs) give a + b.
template <typename T>
__device__ inline T logaddexp(T a, T b) {
  const T delta = a - b;
  if (delta != delta) return a + b;
  const T amax = a > b ? a : b;
  return amax + log1p(exp(-fabs(delta)));
}

}  // namespace nutpie
