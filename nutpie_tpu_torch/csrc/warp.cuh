// Warp-wide reductions and the scalar helpers of the NUTS chunk kernel.
//
// One warp runs one chain, so every reduction is a xor-shuffle butterfly
// over the warp's 32 lanes.  At each stage lane l adds its partner's value
// to its own and the partner does the same the other way round; IEEE
// addition is commutative, so after five stages every lane holds the same
// bits, and the order is fixed, so reruns are bitwise repeatable.
#pragma once

#include <cmath>

#include "layout.cuh"

namespace nutpie {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum N values over the warp; every lane gets the same sums.
template <typename T, int N>
__device__ __forceinline__ void warp_sum(T (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(kFullMask, v[k], off);
  }
}

// NaN-propagating max/min, as jnp.maximum/jnp.minimum and torch's.
template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// clip(x, lo, hi) = min(max(x, lo), hi) with NaN passing through.
template <typename T>
__device__ __forceinline__ T jclip(T x, T lo, T hi) {
  return jmin(jmax(x, lo), hi);
}

// Max of one value over the warp (NaN-propagating); the same in every lane.
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = jmax(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

// jnp.logaddexp: equal infinities (and NaNs) give a + b.
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  const T delta = a - b;
  if (delta != delta) return a + b;
  const T amax = a > b ? a : b;
  return amax + log1p(exp(-fabs(delta)));
}

}  // namespace nutpie
