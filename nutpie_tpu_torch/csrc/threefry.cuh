// Threefry-2x32 (20 rounds) on the device, bit-equal to jax.random's default
// generator and to nutpie_tpu_torch/ops/threefry.py.  The kernel uses it for
// the three uniforms of each leapfrog step:
//   uniform(fold_in(fold_in(chain_key, 3), total_steps), (3,), float32),
// computed for ten steps at once across the chain's warp (StepUniforms).
#pragma once

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

}  // namespace nutpie
