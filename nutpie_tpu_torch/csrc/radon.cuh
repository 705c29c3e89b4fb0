// Radon model: log density and its analytic gradient for one chain, run by
// the chain's warp (nutpie_tpu_torch/models/radon.py holds the torch
// version).
//
// Flat layout of q (k = n_counties - 1):
//   intercept | county_raw_z [k] | log_county_sd | floor_effect |
//   county_floor_raw_z [k] | log_county_floor_sd | log_sigma
// county_raw = basis @ county_raw_z (zero-sum effects), likewise for the
// floor interaction; mu_j = intercept + county_effect[c_j]
//   + floor_effect * floor_j + county_floor_effect[c_j] * floor_j.
//
// Conventions.  Lane l owns coordinates l, l + 32, ... of q and of the
// gradient, in registers.  The data (ModelData) sit in the block's shared
// memory, loaded once per block: the basis with a padded row stride, the
// observations sorted by county in a lane-major table, and the lane
// partition.  The partition gives each lane a contiguous run of about
// n_obs / 32 sorted observations and cuts every county's run at the lane
// boundaries into segments; a lane sums each of its segments, and each
// county then adds its segments' sums in segment order.  No float atomics,
// a fixed order everywhere, so reruns are bitwise repeatable.  The chain's
// scratch rows (WarpMem: the zero-sum coordinates, the county effects,
// the segment sums and the per-county gradient weights) live in the warp's
// slice of shared memory; six __syncwarp calls order their exchanges.
//
// Work per gradient at 85 counties and 919 observations: 2 x 85 x 84
// multiply-adds for the effects (each basis value read from shared memory
// feeds both), 12 operations per observation (mu 5, residual 2, r^2 2, ac 1,
// bc 2), 10 per county, 2 x 84 x 85 multiply-adds and 3 x 168 more for the
// gradient of the zero-sum coordinates, 4 x 84 for the squared norms and
// ~55 scalar: 6.99e4 operations (radon_ops_per_grad in chip_smoke.py).
// The critical path of the residual pass is a lane's ~29 observations
// (the longest county holds 61 of the simulated set's 919), and the two
// basis products take 3 x 84 and 6 x 85 multiply-adds per lane.
#pragma once

#include "warp.cuh"

namespace nutpie {

// The block's copy of the model data (read-only after the block's load).
template <typename T>
struct ModelData {
  const T* basis;   // [n_counties, kpad]
  const T* obs;     // [obs_rows, 32, 2]
  const int* part;  // PartTables
  PartTables pt;
  int kpad;
};

// The chain's rows and scratch in its warp's slice of shared memory.  zz
// and segp share one area, ce, ab and gz another: each row is dead before
// the next one of its area is written (radon_logp_grad's __syncwarp calls).
template <typename T>
struct WarpMem {
  T* vecs;    // [kWarpRows, dim] the chain's state rows, then the inverse mass
  T* crf;     // [n_counties, 2] (county_raw, county_floor_raw)
  T* zz;      // [kpad, 2] (county_raw_z, county_floor_raw_z), zero-padded
  T* segp;    // [n_seg, 2] per-segment sums of r and r * floor
  T* ce;      // [n_counties, 2] (intercept + county effect, county-floor effect)
  T* ab;      // [n_counties, 2] d logp / d (county, county-floor) effect
  T* gz;      // [kpad, 2] basis^T A, basis^T B
  T* sc;      // the five scalar coordinates
  T* af;      // [N_ADAPT_FLT] the chain's adaptation scalars

  __device__ __forceinline__ T* row(int slot, int dim) const {
    return vecs + slot * dim;
  }
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}

__device__ __forceinline__ void load2(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// Log density at q (coordinates lane + 32 r in z); writes the gradient of
// the same coordinates to g.  Every lane of the warp must call it; every
// lane returns the same log density.
template <typename T, int NPL>
__device__ __forceinline__ T radon_logp_grad(const ModelData<T>& d,
                                             const WarpMem<T>& w,
                                             const MkConfig& cfg, int lane,
                                             const T (&z)[NPL], T (&g)[NPL]) {
  // counties (and zero-sum columns) per lane: n_c <= 16 NPL
  constexpr int NCL = (NPL + 1) / 2;
  const int n_c = cfg.n_counties;
  const int k = n_c - 1;
  const int dim = cfg.dim;
  const int kp = d.kpad;
  const int s0 = 1, s1 = s0 + k, s2 = s1 + 1, s3 = s2 + 1, s4 = s3 + k,
            s5 = s4 + 1;

  // publish q: zero-sum coordinates interleaved, the five scalars apart
  T part[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    if (i >= dim) continue;
    const T zi = z[r];
    if (i >= s0 && i < s1) {
      w.zz[2 * (i - s0)] = zi;
      part[5] += zi * zi;
    } else if (i >= s3 && i < s4) {
      w.zz[2 * (i - s3) + 1] = zi;
      part[6] += zi * zi;
    } else {
      const int slot = i == 0 ? 0 : i == s1 ? 1 : i == s2 ? 2 : i == s4 ? 3 : 4;
      w.sc[slot] = zi;
    }
  }
  // the basis product's padding columns read zeros
  for (int j = k + lane; j < kp; j += kLanes) {
    w.zz[2 * j] = T(0);
    w.zz[2 * j + 1] = T(0);
  }
  __syncwarp();
  const T intercept = w.sc[0];
  const T log_csd = w.sc[1];
  const T floor_eff = w.sc[2];
  const T log_cfsd = w.sc[3];
  const T log_sigma = w.sc[4];
  const T csd = exp(log_csd);
  const T cfsd = exp(log_cfsd);
  const T sigma = exp(log_sigma);
  const T inv_sigma = T(1) / sigma;

  // zero-sum effects: lane l takes counties l, l + 32, ...; each basis
  // value loaded feeds both sums
  {
    T cr[NCL], cf[NCL];
    const T* brow[NCL];
#pragma unroll
    for (int m = 0; m < NCL; ++m) {
      cr[m] = T(0);
      cf[m] = T(0);
      const int c = lane + kLanes * m;
      brow[m] = d.basis + (c < n_c ? c : n_c - 1) * kp;
    }
#pragma unroll 1
    for (int j = 0; j < kp; j += 4) {
      T za[4], zb[4], b[NCL][4];
      load4(w.zz + 2 * j, za);
      load4(w.zz + 2 * j + 4, zb);
#pragma unroll
      for (int m = 0; m < NCL; ++m) load4(brow[m] + j, b[m]);
#pragma unroll
      for (int m = 0; m < NCL; ++m) {
        cr[m] += b[m][0] * za[0];
        cf[m] += b[m][0] * za[1];
        cr[m] += b[m][1] * za[2];
        cf[m] += b[m][1] * za[3];
        cr[m] += b[m][2] * zb[0];
        cf[m] += b[m][2] * zb[1];
        cr[m] += b[m][3] * zb[2];
        cf[m] += b[m][3] * zb[3];
      }
    }
#pragma unroll
    for (int m = 0; m < NCL; ++m) {
      const int c = lane + kLanes * m;
      if (c < n_c) {
        store2(w.ce + 2 * c, intercept + cr[m] * csd, cf[m] * cfsd);
        store2(w.crf + 2 * c, cr[m], cf[m]);
      }
    }
  }
  __syncwarp();

  // residuals over this lane's run of observations: the running sums of
  // the current segment are stored at every step, so the segment's last
  // store is its sum; no branch, no lane waits for another.  Step t + 1's
  // loads are issued before step t's store.
  // this lane's share: its run's length and first segment
  const int n_run = d.part[d.pt.lane_obs + lane + 1] - d.part[d.pt.lane_obs + lane];
  if (n_run > 0) {
    const int* info = d.part + d.pt.obs_info + lane;
    const T* ob = d.obs + 2 * lane;
    int s = d.part[d.pt.lane_seg + lane] - 1;
    T ac = T(0), bc = T(0);
    int f = info[0];
    T e[2], yf[2];
    load2(ob, yf);
    load2(w.ce + 2 * (f & (kSegStart - 1)), e);
    for (int t = 0; t < n_run; ++t) {
      const int tn = t + 1 < n_run ? t + 1 : t;
      const int fn = info[kLanes * tn];
      T yn[2];
      load2(ob + 2 * kLanes * tn, yn);
      const bool first = f >= kSegStart;
      s += first;
      ac = first ? T(0) : ac;
      bc = first ? T(0) : bc;
      const T mu = e[0] + floor_eff * yf[1] + e[1] * yf[1];
      const T rr = (yf[0] - mu) * inv_sigma;
      part[0] += rr * rr;
      ac += rr;
      bc += rr * yf[1];
      T en[2];
      load2(w.ce + 2 * (fn & (kSegStart - 1)), en);
      store2(w.segp + 2 * s, ac, bc);
      f = fn;
      e[0] = en[0];
      e[1] = en[1];
      yf[0] = yn[0];
      yf[1] = yn[1];
    }
  }
  __syncwarp();

  // each county adds its segments in order
  const int* county_seg = d.part + d.pt.county_seg;
#pragma unroll
  for (int m = 0; m < NCL; ++m) {
    const int c = lane + kLanes * m;
    if (c < n_c) {
      T ac = T(0), bc = T(0);
      const int e = county_seg[c + 1];
      for (int s = county_seg[c]; s < e; ++s) {
        T v[2];
        load2(w.segp + 2 * s, v);
        ac += v[0];
        bc += v[1];
      }
      ac = ac * inv_sigma;
      bc = bc * inv_sigma;
      store2(w.ab + 2 * c, ac, bc);
      T crv[2];
      load2(w.crf + 2 * c, crv);
      part[1] += ac;
      part[2] += bc;
      part[3] += ac * crv[0];
      part[4] += bc * crv[1];
    }
  }
  warp_sum(part);
  __syncwarp();

  // gradient of the zero-sum coordinates: basis^T (A, B); lane l takes
  // columns l, l + 32, ..., and each basis value loaded feeds both sums.
  // Four counties per step, their loads issued before their multiply-adds.
  // Columns past k read on into the next row (after the last row, into the
  // observation table) and are never stored.
  T ga[NCL], gb[NCL];
#pragma unroll
  for (int m = 0; m < NCL; ++m) {
    ga[m] = T(0);
    gb[m] = T(0);
  }
  const T* bl = d.basis + lane;
  int c = 0;
#pragma unroll 1
  for (; c + 4 <= n_c; c += 4, bl += 4 * kp) {
    T abv[2][4], b[4][NCL];  // abv[q / 2][2 (q % 2)]: (A, B) of county c + q
    load4(w.ab + 2 * c, abv[0]);
    load4(w.ab + 2 * c + 4, abv[1]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int m = 0; m < NCL; ++m) b[q][m] = bl[q * kp + kLanes * m];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int m = 0; m < NCL; ++m) {
        ga[m] += b[q][m] * abv[q / 2][2 * (q % 2)];
        gb[m] += b[q][m] * abv[q / 2][2 * (q % 2) + 1];
      }
    }
  }
  for (; c < n_c; ++c, bl += kp) {
    T abv[2];
    load2(w.ab + 2 * c, abv);
#pragma unroll
    for (int m = 0; m < NCL; ++m) {
      const T b = bl[kLanes * m];
      ga[m] += b * abv[0];
      gb[m] += b * abv[1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < NCL; ++m) {
    const int j = lane + kLanes * m;
    if (j < k) store2(w.gz + 2 * j, ga[m], gb[m]);
  }
  __syncwarp();

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
  lp += T(-0.5) * ss - T(cfg.n_obs) * log_sigma;
  const T g_int = -intercept / T(100) + part[1];
  const T g_csd = -csd * csd + T(1) + csd * part[3];
  const T g_floor = -floor_eff / T(4) + part[2];
  const T g_cfsd = -cfsd * cfsd + T(1) + cfsd * part[4];
  const T g_sigma = -s15 * s15 + T(1) + ss - T(cfg.n_obs);
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int i = lane + kLanes * r;
    T gi;
    if (i >= s0 && i < s1) gi = -z[r] + w.gz[2 * (i - s0)] * csd;
    else if (i >= s3 && i < s4) gi = -z[r] + w.gz[2 * (i - s3) + 1] * cfsd;
    else if (i == 0) gi = g_int;
    else if (i == s1) gi = g_csd;
    else if (i == s2) gi = g_floor;
    else if (i == s4) gi = g_cfsd;
    else if (i == s5) gi = g_sigma;
    else gi = T(0);
    g[r] = gi;
  }
  return lp;
}

}  // namespace nutpie
