// RMSNorm for Hopper (sm_90a): the Gemma-style norm of every transformer
// layer, over the last dimension of a (rows, d) matrix,
//
//     y = x · rsqrt(mean(x²) + eps) · (1 + scale)
//
// with the statistics in fp32 and y stored in x's type (fp32 or bf16; the
// scale has x's type, as a model's parameters do).
//
// Replaces: src/repro/kernels/rmsnorm.py:rmsnorm_pallas (_rmsnorm_kernel).
//
// Bound: memory. Each element is read once and written once, plus one read
// of the scale, at 4 flops per element. At the serve path's prefill shape
// (B·S = 4096 rows of 2048 bf16) that is 33,558,528 B: 10.0 us at 3.35 TB/s;
// at decode (8 rows) 69,632 B, far below one launch.
//
// Design: one warp per row and one pass over it. A lane loads its share of
// the row as 16-byte vectors, all in flight at once, and keeps them in
// registers (NV vectors a lane: 8 at d = 2048 bf16); Σx² is a warp shuffle
// reduction, and the row is written once from those registers. No shared
// memory, no block barrier. Each warp loads its share of the scale once and
// walks rows with a stride of the grid's warps. Blocks hold 4 warps (4 rows)
// when there are many rows and 1 warp when there are few (decode's 8 rows
// then spread over 8 SMs). Widths that are not a multiple of 16 bytes, or
// too wide for the registers, or unaligned operands take the general kernel:
// one warp per row, scalar loads, two passes (the second from cache).
// Numerics are the plain version's: fp32 sums, a true division for the mean,
// CUDA's rsqrtf (2 ulp; no --use_fast_math), one rounding at the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BLOCKS = 2048;     // warps beyond these walk more rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes of T as VEC floats, and back
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) f[i] = to_f32(e[i]);
}
template <typename T>
__device__ __forceinline__ uint4 narrow(const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) store_f32(e + i, f[i]);
  return raw;
}

// d a multiple of VEC, at most 32·NV·VEC; operands 16-byte aligned
template <typename T, int NV>
__global__ void __launch_bounds__(128)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps;
  const uint4* sv = reinterpret_cast<const uint4*>(scale);

  uint4 sraw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) sraw[i] = sv[lane + 32 * i];

  for (long long row = (long long)blockIdx.x * warps + (threadIdx.x >> 5); row < rows;
       row += stride) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
    uint4* ov = reinterpret_cast<uint4*>(out + row * d);
    uint4 raw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec) raw[i] = xv[lane + 32 * i];
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        float f[VEC];
        widen<T>(raw[i], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
      }
    }
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        float f[VEC], s[VEC];
        widen<T>(raw[i], f);
        widen<T>(sraw[i], s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * (1.0f + s[e]);
        ov[lane + 32 * i] = narrow<T>(f);
      }
    }
  }
}

// any width and alignment: one warp per row, two passes
template <typename T>
__global__ void __launch_bounds__(128)
rmsnorm_any_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + (threadIdx.x >> 5); row < rows;
       row += stride) {
    const T* xr = x + row * d;
    T* outr = out + row * d;
    float ss = 0.0f;
#pragma unroll 4
    for (int i = lane; i < d; i += 32) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll 4
    for (int i = lane; i < d; i += 32)
      store_f32(outr + i, to_f32(xr[i]) * r * (1.0f + to_f32(scale[i])));
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int warps = rows >= 1024 ? 4 : 1;
  const long long blocks = (rows + warps - 1) / warps;
  const dim3 grid((unsigned)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS));
  const int per_lane = (d / VEC + 31) / 32;
  const bool aligned = ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)out) % 16 == 0;
  const T* xt = (const T*)x;
  const T* st = (const T*)scale;
  T* ot = (T*)out;
  if (!aligned || d % VEC != 0 || per_lane > 16)
    rmsnorm_any_kernel<T><<<grid, 32 * warps, 0, stream>>>(xt, st, ot, rows, d, eps);
  else if (per_lane <= 1)
    rmsnorm_vec_kernel<T, 1><<<grid, 32 * warps, 0, stream>>>(xt, st, ot, rows, d, eps);
  else if (per_lane <= 2)
    rmsnorm_vec_kernel<T, 2><<<grid, 32 * warps, 0, stream>>>(xt, st, ot, rows, d, eps);
  else if (per_lane <= 4)
    rmsnorm_vec_kernel<T, 4><<<grid, 32 * warps, 0, stream>>>(xt, st, ot, rows, d, eps);
  else if (per_lane <= 8)
    rmsnorm_vec_kernel<T, 8><<<grid, 32 * warps, 0, stream>>>(xt, st, ot, rows, d, eps);
  else
    rmsnorm_vec_kernel<T, 16><<<grid, 32 * warps, 0, stream>>>(xt, st, ot, rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous and scale: (d,), all fp32 (is_bf16 = 0) or
// all bf16 (is_bf16 = 1). One warp per row, one launch.
extern "C" int rmsnorm(const void* x, const void* scale, void* out, long long rows,
                       int d, float eps, int is_bf16, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s)
                 : launch<float>(x, scale, out, rows, d, eps, s);
}
