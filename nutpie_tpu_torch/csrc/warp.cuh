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

// The draw's tree-depth limit (nutpie_tpu/sampler/nuts.py:885-899): with a
// target integration time, ceil(log2(max(target / eps, 1))) plus the extra
// doublings, clipped to [max(mindepth, 1), maxdepth]; else maxdepth; then
// the fleet's depth cap and the floor max(mindepth, 1).  eps is the draw's
// own step, after jitter; the ratio and its log2 are taken in T, as the
// plain version takes them, so a power of two gives the exact integer.
template <typename T>
__device__ __forceinline__ int depth_limit(const MkConfig& cfg, const Sched& s, T eps) {
  const int floor_depth = cfg.mindepth > 1 ? cfg.mindepth : 1;
  int limit = cfg.maxdepth;
  if (cfg.has_target_time) {
    const T ratio = jmax(T(cfg.target_time) / eps, T(1));
    const int req = int(ceil(log2(ratio))) + cfg.extra_doublings;
    limit = req > floor_depth ? req : floor_depth;
    limit = limit < cfg.maxdepth ? limit : cfg.maxdepth;
  }
  limit = limit < s.depth_cap ? limit : s.depth_cap;
  return limit > floor_depth ? limit : floor_depth;
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
