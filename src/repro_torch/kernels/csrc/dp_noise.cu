// The Gaussian mechanism's clip-and-noise body for Hopper (sm_90a): for each
// row r of a stacked (rows, n) fp32 upload matrix, given the row's clip
// factor f_r = min(1, C / max(||x_r s_r||, 1e-12)) and scale s_r,
//
//     m    = (x · s_r) · f_r
//     n    = sqrt(2) · erfinv(u),  u uniform on (nextafter(-1, 0), 1) from
//            the threefry bits of key_r at counter offset + column
//     out  = (m + sigma · n) / s_r
//
// and each block's sum of (sigma · n)^2, written to its own slot (no
// atomics, so the row's noise norm sums in a fixed order).
//
// Stands for the per-row body of src/repro/core/privacy.py:260
// (clip_and_noise) after the norm: the reference computes it in XLA, not in
// a Pallas kernel, with jax.random.normal(key_r, (n,)). The bits are drawn
// in registers at the counters random.bits uses (threefry.cuh), so one long
// row can be privatized in 256-aligned pieces, each at its own offset, and
// no bits or noise operand sits in HBM. u and n follow jax's
// _uniform/_normal_real: 23 random mantissa bits under exponent 0 give
// [1, 2), minus 1, times (1 - lo), plus lo, clamped below at lo; then
// sqrt(2)·erfinv(u). erfinvf differs from XLA's erfinv by a few ulps.
// Every other product and sum is rounded once, in the reference's order
// (__fmul_rn etc. keep nvcc from contracting them).
//
// Bound: per element it reads x (4 B) and writes out (4 B), 2.4 ns a
// thousand elements at 3.35 TB/s; threefry's ~82 integer operations and
// erfinvf's ~40 floating-point ones take 1.8 ns a thousand at the H100's
// 67 T/s, so the bytes bound it, but not by much.
//
// Design: blocks of 256 threads, each thread kItems elements strided by the
// block's width (coalesced), its noise squares summed in a register, then a
// warp-shuffle and shared-memory reduction to the block's slot. Past 65,535
// rows (the grid's y limit) each block walks the rows by the grid's stride.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;    // kThreads * kItems = dp_noise.py's BLOCK_ELEMS

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
dp_noise_kernel(const float* __restrict__ x, const int64_t* __restrict__ keys,
                const float* __restrict__ factor, const float* __restrict__ scale,
                float* __restrict__ out, float* __restrict__ partial, int64_t rows,
                int64_t n, int64_t offset, float sigma, float lo, float sqrt2) {
  __shared__ float warp_part[kThreads / 32];
  const float span = __fsub_rn(1.0f, lo);
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t k0 = (uint32_t)keys[2 * row], k1 = (uint32_t)keys[2 * row + 1];
    const float f = factor[row], s = scale[row];
    const int64_t base = (int64_t)blockIdx.x * kThreads * kItems + threadIdx.x;
    const float* xr = x + row * n;
    float* outr = out + row * n;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t col = base + (int64_t)i * kThreads;
      if (col < n) {
        const uint32_t b = threefry::bits(k0, k1, (uint64_t)(offset + col));
        const float floats = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
        const float u = fmaxf(lo, __fadd_rn(__fmul_rn(floats, span), lo));
        const float noise = __fmul_rn(sigma, __fmul_rn(sqrt2, erfinvf(u)));
        const float m = __fmul_rn(__fmul_rn(xr[col], s), f);
        outr[col] = __fdiv_rn(__fadd_rn(m, noise), s);
        acc = __fadd_rn(acc, __fmul_rn(noise, noise));
      }
    }
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x < 32) {
      acc = threadIdx.x < kThreads / 32 ? warp_part[threadIdx.x] : 0.0f;
      acc = warp_sum(acc);
      if (threadIdx.x == 0) partial[row * gridDim.x + blockIdx.x] = acc;
    }
    if (row + gridDim.y < rows) __syncthreads();   // warp_part is read before it is rewritten
  }
}

}  // namespace

// x, out: (rows, n) fp32 (out may be x); keys: (rows, 2) int64 holding
// uint32 words; factor, scale: (rows,) fp32 on the device; partial: (rows,
// ceil(n / (kThreads * kItems))) fp32, one slot a piece. Any row count.
extern "C" int dp_noise(const void* x, const void* keys, const void* factor,
                        const void* scale, void* out, void* partial,
                        long long rows, long long n, long long offset,
                        float sigma, float lo, float sqrt2, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long per = (long long)kThreads * kItems;
  const dim3 grid((unsigned)((n + per - 1) / per), (unsigned)(rows < 65535 ? rows : 65535));
  dp_noise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int64_t*)keys, (const float*)factor,
      (const float*)scale, (float*)out, (float*)partial, (int64_t)rows, (int64_t)n,
      (int64_t)offset, sigma, lo, sqrt2);
  return (int)cudaGetLastError();
}
