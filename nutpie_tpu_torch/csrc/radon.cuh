// Radon model: log density and its analytic gradient as a block-wide device
// function (nutpie_tpu_torch/models/radon.py holds the torch version).
//
// Flat layout of q (k = n_counties - 1):
//   intercept | county_raw_z [k] | log_county_sd | floor_effect |
//   county_floor_raw_z [k] | log_county_floor_sd | log_sigma
// county_raw = basis @ county_raw_z (zero-sum effects), likewise for the
// floor interaction; mu_j = intercept + county_effect[c_j]
//   + floor_effect * floor_j + county_floor_effect[c_j] * floor_j.
//
// Observations arrive sorted by county with CSR offsets: one thread walks
// each county's segment, so the per-county gradient sums need no atomics
// and their order is fixed.  The data (~76 KB in float64, most of it the
// 85 x 84 basis) stays in global memory, where every block of the launch
// reads the same lines from L2.
//
// Work per gradient at 85 counties and 919 observations: 2 x 85 x 84
// multiply-adds for the effects, 12 operations per observation (mu 5,
// residual 2, r^2 2, ac 1, bc 2), 10 per county, 2 x 84 x 85 multiply-adds
// and 3 x 168 more for the gradient of the zero-sum coordinates, 4 x 84 for
// the squared norms and ~55 in thread 0: 6.99e4 operations
// (radon_ops_per_grad in chip_smoke.py).
#pragma once

#include "block.cuh"

namespace nutpie {

// Reads q from b.z_new; writes the gradient to b.g_new and the log density
// to b.cf[X_LOGP_NEW].  Ends with a barrier.
template <typename T>
__device__ void radon_logp_grad(const Block<T>& b, const MkArgs<T>& a) {
  const int n_c = a.cfg.n_counties;
  const int k = n_c - 1;
  const int dim = b.dim;
  const int s0 = 1, s1 = s0 + k, s2 = s1 + 1, s3 = s2 + 1, s4 = s3 + k,
            s5 = s4 + 1;
  const T* z = b.z_new;
  T* g = b.g_new;
  T* county_raw = b.county;
  T* cf_raw = county_raw + n_c;
  T* A = cf_raw + n_c;  // d logp / d county_effect
  T* B = A + n_c;       // d logp / d county_floor_effect

  // zero-sum effects, one county per thread
  for (int c = threadIdx.x; c < n_c; c += kThreads) {
    const T* brow = a.basis + c * k;
    T cr = T(0), fr = T(0);
    for (int j = 0; j < k; ++j) {
      cr += brow[j] * z[s0 + j];
      fr += brow[j] * z[s3 + j];
    }
    county_raw[c] = cr;
    cf_raw[c] = fr;
  }
  __syncthreads();

  const T intercept = z[0];
  const T log_csd = z[s1];
  const T floor_eff = z[s2];
  const T log_cfsd = z[s4];
  const T log_sigma = z[s5];
  const T csd = exp(log_csd);
  const T cfsd = exp(log_cfsd);
  const T sigma = exp(log_sigma);

  // partial sums: resid^2, sum A, sum B, A . county_raw, B . cf_raw,
  // |county_raw_z|^2, |county_floor_raw_z|^2
  T part[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int c = threadIdx.x; c < n_c; c += kThreads) {
    const T ce = county_raw[c] * csd;
    const T cfe = cf_raw[c] * cfsd;
    T ac = T(0), bc = T(0);
    const int end = a.offsets[c + 1];
    for (int j = a.offsets[c]; j < end; ++j) {
      const T fl = a.floor[j];
      const T mu = intercept + ce + floor_eff * fl + cfe * fl;
      const T r = (a.y[j] - mu) / sigma;
      part[0] += r * r;
      ac += r;
      bc += r * fl;
    }
    ac = ac / sigma;
    bc = bc / sigma;
    A[c] = ac;
    B[c] = bc;
    part[1] += ac;
    part[2] += bc;
    part[3] += ac * county_raw[c];
    part[4] += bc * cf_raw[c];
  }
  MK_FOR_COORDS(i, dim) {
    if (i >= s0 && i < s1) part[5] += z[i] * z[i];
    if (i >= s3 && i < s4) part[6] += z[i] * z[i];
  }
  block_sum(part, b.red);  // its barriers also publish A and B

  // gradient of the zero-sum coordinates: basis^T (A * sd), one per thread
  for (int t = threadIdx.x; t < 2 * k; t += kThreads) {
    const bool is_cf = t >= k;
    const int j = is_cf ? t - k : t;
    const T* w = is_cf ? B : A;
    T acc = T(0);
    for (int c = 0; c < n_c; ++c) acc += a.basis[c * k + j] * w[c];
    const int zi = (is_cf ? s3 : s0) + j;
    g[zi] = -z[zi] + acc * (is_cf ? cfsd : csd);
  }
  if (threadIdx.x == 0) {
    const T ss = part[0];
    const T i10 = intercept / T(10);
    const T f2 = floor_eff / T(2);
    const T s15 = sigma / T(1.5);
    T lp = T(-0.5) * i10 * i10;
    lp += T(-0.5) * part[5];
    lp += T(-0.5) * part[6];
    lp += T(-0.5) * csd * csd + log_csd;
    lp += T(-0.5) * cfsd * cfsd + log_cfsd;
    lp += T(-0.5) * f2 * f2;
    lp += T(-0.5) * s15 * s15 + log_sigma;
    lp += T(-0.5) * ss - T(a.cfg.n_obs) * log_sigma;
    g[0] = -intercept / T(100) + part[1];
    g[s1] = -csd * csd + T(1) + csd * part[3];
    g[s2] = -floor_eff / T(4) + part[2];
    g[s4] = -cfsd * cfsd + T(1) + cfsd * part[4];
    g[s5] = -s15 * s15 + T(1) + ss - T(a.cfg.n_obs);
    b.cf[X_LOGP_NEW] = lp;
  }
  __syncthreads();
}

}  // namespace nutpie
