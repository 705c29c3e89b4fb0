// Threefry-2x32 (20 rounds) on the device, bit-equal to jax.random's default
// generator and to nutpie_tpu_torch/ops/threefry.py.  K1 and K2 use it for
// the three uniforms of each leapfrog step:
//   uniform(fold_in(fold_in(chain_key, 3), total_steps), (3,), float32),
// computed for ten steps at once across the chain's warp (StepUniforms);
// K3 (mclmc.cu) for its refresh normals, element by element
// (normal_element: jax.random.normal's bits, uniform and XLA's erfinv).
#pragma once

#include <cmath>
#include <cstdint>

namespace nutpie {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Hash of the counts (x0, x1) under key (k1, k2), in place.
__device__ inline void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x0,
                                    uint32_t& x1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k1;
  x1 += k2;
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[block & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + uint32_t(block + 1);
  }
}

// jax.random.fold_in on raw key data: the hash of the counts (0, data).
__device__ inline void fold_in(uint32_t& k1, uint32_t& k2, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k1, k2, x0, x1);
  k1 = x0;
  k2 = x1;
}

// Mantissa randomization of 32 bits into float32 [0, 1).
__device__ inline float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// jax.random.uniform(key, (3,), float32): element i hashes the counts (0, i)
// and xor-folds the two words.
__device__ inline float uniform3_element(uint32_t k1, uint32_t k2, uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(k1, k2, x0, x1);
  return bits_to_uniform(x0 ^ x1);
}

// The leapfrog uniforms of one chain, ten steps at a time across the warp:
// lane l holds element l % 3 of step base + l / 3 (lanes 30 and 31 idle),
// so one refill costs each lane two hashes instead of ten steps' forty.
struct StepUniforms {
  uint32_t k1, k2;  // fold_in(chain_key, 3)
  uint32_t base;
  float u;

  // `first_step` is the chain's step count before its first step, so the
  // first get() refills.
  __device__ StepUniforms(uint32_t key1, uint32_t key2, uint32_t first_step)
      : k1(key1), k2(key2), base(first_step - 10u), u(0.0f) {
    fold_in(k1, k2, 3u);
  }

  // u[0..2] of step `step`; every lane of the warp must call it.
  __device__ __forceinline__ void get(uint32_t step, int lane, float out[3]) {
    if (step - base >= 10u) {
      base = step;
      uint32_t a = k1, b = k2;
      fold_in(a, b, step + uint32_t(lane / 3));
      u = uniform3_element(a, b, uint32_t(lane % 3));
    }
    const int src = 3 * int(step - base);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = __shfl_sync(0xffffffffu, u, src + i);
  }
};

// Horner's rule over the coefficients c0, c1, ...: p = c0, then p = c + p w
// for each next c (each product and sum rounded: the kernels that call it
// build without FMA contraction).
template <typename T>
__device__ __forceinline__ T horner(T, T p) {
  return p;
}
template <typename T, typename... R>
__device__ __forceinline__ T horner(T w, T p, T c, R... rest) {
  return horner<T>(w, T(c + p * w), T(rest)...);
}

// Giles' erfinv in the form XLA expands erf_inv into, as ops/threefry.py
// writes it: w = -log1p(-x^2), one polynomial per range of w, in the
// working type.  CUDA's erfinvf / erfinv round differently, so they are not
// used.
__device__ inline float erfinv_xla(float x) {
  const float w = -log1pf(x * -x);
  const float p =
      w < 5.0f
          ? horner<float>(w - 2.5f, 2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                          -4.39150654e-06f, 0.00021858087f, -0.00125372503f, -0.00417768164f,
                          0.246640727f, 1.50140941f)
          : horner<float>(sqrtf(w) - 3.0f, -0.000200214257f, 0.000100950558f, 0.00134934322f,
                          -0.00367342844f, 0.00573950773f, -0.0076224613f, 0.00943887047f,
                          1.00167406f, 2.83297682f);
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

__device__ inline double erfinv_xla(double x) {
  const double w = -log1p(x * -x);
  double p;
  if (w < 6.25) {
    p = horner<double>(
        w - 3.125, -3.6444120640178196996e-21, -1.685059138182016589e-19,
        1.2858480715256400167e-18, 1.115787767802518096e-17, -1.333171662854620906e-16,
        2.0972767875968561637e-17, 6.6376381343583238325e-15, -4.0545662729752068639e-14,
        -8.1519341976054721522e-14, 2.6335093153082322977e-12, -1.2975133253453532498e-11,
        -5.4154120542946279317e-11, 1.051212273321532285e-09, -4.1126339803469836976e-09,
        -2.9070369957882005086e-08, 4.2347877827932403518e-07, -1.3654692000834678645e-06,
        -1.3882523362786468719e-05, 0.0001867342080340571352, -0.00074070253416626697512,
        -0.0060336708714301490533, 0.24015818242558961693, 1.6536545626831027356);
  } else if (w < 16.0) {
    p = horner<double>(
        sqrt(w) - 3.25, 2.2137376921775787049e-09, 9.0756561938885390979e-08,
        -2.7517406297064545428e-07, 1.8239629214389227755e-08, 1.5027403968909827627e-06,
        -4.013867526981545969e-06, 2.9234449089955446044e-06, 1.2475304481671778723e-05,
        -4.7318229009055733981e-05, 6.8284851459573175448e-05, 2.4031110387097893999e-05,
        -0.0003550375203628474796, 0.00095328937973738049703, -0.0016882755560235047313,
        0.0024914420961078508066, -0.0037512085075692412107, 0.005370914553590063617,
        1.0052589676941592334, 3.0838856104922207635);
  } else {
    p = horner<double>(
        sqrt(w) - 5.0, -2.7109920616438573243e-11, -2.5556418169965252055e-10,
        1.5076572693500548083e-09, -3.7894654401267369937e-09, 7.6157012080783393804e-09,
        -1.4960026627149240478e-08, 2.9147953450901080826e-08, -6.7711997758452339498e-08,
        2.2900482228026654717e-07, -9.9298272942317002539e-07, 4.5260625972231537039e-06,
        -1.9681778105531670567e-05, 7.5995277030017761139e-05, -0.00021503011930044477347,
        -0.00013871931833623122026, 1.0103004648645343977, 4.8499064014085844221);
  }
  return fabs(x) == 1.0 ? x * INFINITY : p * x;
}

// Element i of jax.random.normal(key, (n,), T) under key (k1, k2): the hash
// of the counts (0, i); float32 xor-folds its two words into 32 bits and
// float64 takes the top 52 bits of the 64-bit word hi << 32 | lo; the
// mantissa's uniform on [0, 1) scaled to [nextafter(-1, 0), 1) with the
// max(lo, .) clamp of jax.random.uniform, then sqrt(2) erfinv(u).
template <typename T>
__device__ inline T normal_element(uint32_t k1, uint32_t k2, uint32_t i);

template <>
__device__ inline float normal_element<float>(uint32_t k1, uint32_t k2, uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(k1, k2, x0, x1);
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float span = 1.0f - lo;
  const float u = fmaxf(lo, bits_to_uniform(x0 ^ x1) * span + lo);
  return 1.41421356237309505f * erfinv_xla(u);
}

template <>
__device__ inline double normal_element<double>(uint32_t k1, uint32_t k2, uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(k1, k2, x0, x1);
  const uint64_t m = (uint64_t(x0) << 20) | uint64_t(x1 >> 12);
  const double f = __longlong_as_double(static_cast<long long>(m | 0x3FF0000000000000ull)) - 1.0;
  const double lo = -0.99999999999999989;  // nextafter(-1, 0)
  const double span = 1.0 - lo;
  const double u = fmax(lo, f * span + lo);
  return 1.4142135623730951 * erfinv_xla(u);
}

}  // namespace nutpie
