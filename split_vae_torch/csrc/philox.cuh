// The render noise shared by the full-canvas and the row-windowed render
// kernels: Philox-4x32-10 keyed by (seed + image) with the element's position
// as the counter, so a backward kernel, or another kernel, regenerates exactly
// the same values with no stream state.

#pragma once

#include <stdint.h>

static __device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
    const uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += W0;
    k1 += W1;
  }
}

// One standard normal per (key, position): Box-Muller on the first two words.
static __device__ __forceinline__ float normal_at(uint32_t key, uint32_t pos) {
  uint32_t c[4] = {pos, 0u, 0u, 0u};
  philox4x32_10(c, key, 0u);
  const float scale = 2.3283064365386963e-10f;  // 2^-32
  const float u1 = (__uint2float_rn(c[0]) + 0.5f) * scale;
  const float u2 = (__uint2float_rn(c[1]) + 0.5f) * scale;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}
