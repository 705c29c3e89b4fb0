// The low-rank metric's products for the step kernel (step_kernel.cu), run
// by one warp per chain.
//
// The metric of nutpie_tpu_torch/sampler/low_rank.py (the JAX package's
// nutpie_tpu/sampler/low_rank.py:46-68):
//   M^{-1} = D^{1/2} (I + U (Lambda - I) U^T) D^{1/2},
// with D the diagonal inverse mass (s = sqrt(D)), U [dim, R] orthonormal
// columns stored row-major per chain, and Lambda = exp(log_eigs):
//   velocity  v = s (w + U c),   w = s p,  c_r = (lambda_r - 1) (w^T U)_r
//   momentum  p = (z + U c) / s,           c_r = (lambda_r^{-1/2} - 1) (z^T U)_r
// Each application is two passes over the chain's basis:
//   - the projection w^T U: lane r accumulates rank r over the coordinates
//     in order, reading w_d from the lane that owns coordinate d by a
//     shuffle and U[d, r] in one 128-byte row per d when R = 32; no
//     cross-lane reduction, so the sum order per rank is fixed;
//   - the expansion (U c)_d: the lane that owns coordinate d reads U's row
//     d and the coefficients c_r from lane r by shuffles.
// Lanes own the coordinates d = base + lane of each block of 32, the same
// lanes as the strided loops of step_kernel.cu, so every row a lane writes
// in one pass is read back by the same lane in the next.  R <= 32.
//
// What bounds it on this card: the latency of the basis's loads.  A warp
// walks its own chain's basis block after block, and at the main path's
// 1024 chains about 8 warps share an SM, so each pass waits on its loads
// rather than on the memory's rate.  Each lane keeps kLoadBatch loads in
// flight; more loads in flight per lane helped a little, asking the L2
// cache for the blocks ahead did not.  More warps per chain is the next
// step (ROADMAP.md).

#pragma once

#include "warp.cuh"

namespace nutpie {

constexpr int kMaxRank = kLanes;

// The chain's basis and log eigenvalues, and the lane's rank (lane r holds
// log_eig_r; lanes >= R hold 0).
template <typename T>
struct LowRank {
  const T* U;  // [dim, R] row-major
  int R;
  int dim;
  T log_eig;

  __device__ __forceinline__ LowRank(const T* basis, const T* log_eigs, size_t chain,
                                     int dim_, int rank, int lane)
      : U(basis + chain * size_t(dim_) * rank), R(rank), dim(dim_),
        log_eig(lane < rank ? log_eigs[chain * rank + lane] : T(0)) {}

  // (lambda_r - 1), the velocity's coefficient factor, in lane r
  __device__ __forceinline__ T velocity_factor() const { return exp(log_eig) - T(1); }
  // (lambda_r^{-1/2} - 1), the momentum's
  __device__ __forceinline__ T momentum_factor() const {
    return exp(T(-0.5) * log_eig) - T(1);
  }
};

// Basis values each lane loads before it uses the first.
constexpr int kLoadBatch = 16;

// Adds rank `lane`'s share of w^T U for the 32 coordinates of one block:
// wd is w at the calling lane's coordinate (0 past dim), n the block's
// coordinates in range.  Called by every lane of the warp.
template <typename T>
__device__ __forceinline__ void lr_project_block(const LowRank<T>& m, int base, int n,
                                                 T wd, int lane, T& acc) {
  const bool owns = lane < m.R;
  const T* col = m.U + size_t(base) * m.R + lane;
  for (int j0 = 0; j0 < n; j0 += kLoadBatch) {
    T u[kLoadBatch];
#pragma unroll
    for (int t = 0; t < kLoadBatch; ++t) {
      u[t] = owns && j0 + t < n ? __ldg(col + size_t(j0 + t) * m.R) : T(0);
    }
#pragma unroll
    for (int t = 0; t < kLoadBatch; ++t) {
      if (j0 + t < n) {
        const T wj = __shfl_sync(kFullMask, wd, j0 + t);
        acc += wj * u[t];
      }
    }
  }
}

// (U c)_d for the calling lane's coordinate d (any row when d >= dim, whose
// result is unused), the coefficients c_r in lane r.  Called by every lane
// of the warp.
template <typename T>
__device__ __forceinline__ T lr_expand(const LowRank<T>& m, int d, T c) {
  const T* urow = m.U + size_t(d < m.dim ? d : 0) * m.R;
  T out = T(0);
  for (int r0 = 0; r0 < m.R; r0 += kLoadBatch) {
    T u[kLoadBatch];
#pragma unroll
    for (int t = 0; t < kLoadBatch; ++t) u[t] = r0 + t < m.R ? __ldg(urow + r0 + t) : T(0);
#pragma unroll
    for (int t = 0; t < kLoadBatch; ++t) {
      if (r0 + t < m.R) out += u[t] * __shfl_sync(kFullMask, c, r0 + t);
    }
  }
  return out;
}

}  // namespace nutpie
