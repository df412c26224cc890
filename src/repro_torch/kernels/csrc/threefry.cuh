// Threefry-2x32 (20 rounds) as a device function, bit-exact with
// repro_torch.random (and so with jax.random under
// jax_threefry_partitionable=True).
//
// A key is two uint32 words (k0, k1). Element i of the flat draw
// jax.random.bits(key, shape) is
//
//     (x0, x1) = threefry2x32(k0, k1, hi = i >> 32, lo = i & 0xffffffff)
//     bits[i]  = x0 ^ x1
//
// (random._bits_range), so a kernel that needs the bits of element i of a
// row computes them in registers from the row's key and i: no bits operand
// in HBM, and any piece of a long draw starts at its own counter offset.
// Each element costs 20 rounds of add/rotate/xor plus 5 key injections:
// about 85 32-bit integer operations.
#pragma once
#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds with rotations r0..r3, then the key injection of step s.
#define THREEFRY_ROUNDS(r0, r1, r2, r3)  \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;      \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;      \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;      \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;

// threefry2x32 of the counter words (x0, x1) under key (k0, k1); returns
// the two output words in place.
__device__ __forceinline__ void block(uint32_t k0, uint32_t k1, uint32_t& x0,
                                      uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k1; x1 += k2 + 1u;
  THREEFRY_ROUNDS(17, 29, 16, 24)
  x0 += k2; x1 += k0 + 2u;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k0; x1 += k1 + 3u;
  THREEFRY_ROUNDS(17, 29, 16, 24)
  x0 += k1; x1 += k2 + 4u;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k2; x1 += k0 + 5u;
}

#undef THREEFRY_ROUNDS

// Element `counter` of the flat uint32 draw jax.random.bits((k0, k1), ...).
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint64_t counter) {
  uint32_t x0 = (uint32_t)(counter >> 32), x1 = (uint32_t)counter;
  block(k0, k1, x0, x1);
  return x0 ^ x1;
}

}  // namespace threefry
