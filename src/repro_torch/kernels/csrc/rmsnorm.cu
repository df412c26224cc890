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
//
// Backward (rmsnorm_bwd), replacing the reference's XLA-level custom VJP
// src/repro/models/layers.py:_rms_fused_bwd (the Pallas kernel has no
// backward): with g1 = 1 + scale and r = rsqrt(mean(x²) + eps),
//
//     dx     = g1·dy·r - x·r³·Σ(x·g1·dy)/d
//     dscale = Σ_rows x·dy·r
//
// Bound: memory. x and dy are read and dx written once (at the train path's
// 4096 rows of 2048 bf16: 50.3 MB, 15.0 us at 3.35 TB/s). Two kernels in one
// call. rmsnorm_bwd_kernel: each warp takes one row at a time (a grid
// stride), one pass with the row of x and of dy in registers as 16-byte
// vectors, writes dx and adds x·dy·r into its lanes' fp32 column sums in
// registers; the block's 4 warps then add theirs in order in shared memory,
// and each block writes its column sums as one row of `partials` (the
// general path, for other widths and alignments: scalar loads, two passes,
// the column sums added in shared memory after each group of 4 rows).
// rmsnorm_dscale_kernel sums the partials' rows in a fixed order, one
// thread a column. No atomics anywhere: two runs give the same bits.
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int BWD_WARPS = 4;          // rows a block takes at a time
constexpr int BWD_MAX_D = 56 * 1024;  // its column sums fill shared memory

// One row's dx, with the row of x and dy held in registers as 16-byte
// vectors (d a multiple of VEC, at most 32·NV·VEC, operands aligned); adds
// x·dy·r into the lane's column sums `acc` (its columns: vector lane + 32·i).
template <typename T, int NV>
__device__ __forceinline__ void bwd_row_vec(const T* __restrict__ xr, const T* __restrict__ sr,
                                            const T* __restrict__ dyr, T* __restrict__ dxr,
                                            int d, float eps, float (&acc)[NV][16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC, lane = threadIdx.x & 31;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  const uint4* dv = reinterpret_cast<const uint4*>(dyr);
  const uint4* sv = reinterpret_cast<const uint4*>(sr);
  uint4 xraw[NV], draw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) {
      xraw[i] = xv[lane + 32 * i];
      draw[i] = dv[lane + 32 * i];
    }
  float ss = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
      float xf[VEC], df[VEC], sf[VEC];
      widen<T>(xraw[i], xf);
      widen<T>(draw[i], df);
      widen<T>(sv[lane + 32 * i], sf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += xf[e] * xf[e];
        s1 += xf[e] * (1.0f + sf[e]) * df[e];
      }
    }
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
  const float c = r * r * r * (warp_sum(s1) / (float)d);
  uint4* ov = reinterpret_cast<uint4*>(dxr);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
      float xf[VEC], df[VEC], sf[VEC];
      widen<T>(xraw[i], xf);
      widen<T>(draw[i], df);
      widen<T>(sv[lane + 32 * i], sf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[i][e] += xf[e] * df[e] * r;
        xf[e] = (1.0f + sf[e]) * df[e] * r - xf[e] * c;
      }
      ov[lane + 32 * i] = narrow<T>(xf);
    }
  }
}

// Any width and alignment: scalar loads, two passes.
template <typename T>
__device__ __forceinline__ float bwd_row_any(const T* __restrict__ xr, const T* __restrict__ sr,
                                             const T* __restrict__ dyr, T* __restrict__ dxr,
                                             int d, float eps) {
  const int lane = threadIdx.x & 31;
  float ss = 0.0f, s1 = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float xf = to_f32(xr[i]);
    ss += xf * xf;
    s1 += xf * (1.0f + to_f32(sr[i])) * to_f32(dyr[i]);
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
  const float c = r * r * r * (warp_sum(s1) / (float)d);
  for (int i = lane; i < d; i += 32)
    store_f32(dxr + i, (1.0f + to_f32(sr[i])) * to_f32(dyr[i]) * r - to_f32(xr[i]) * c);
  return r;
}

// NV > 0: the vector path with NV vectors a lane, each warp walking its
// rows on its own and summing its columns in registers, the block's 4 warps
// then added in order in shared memory; NV = 0: the general path, groups of
// 4 rows, whose x·dy·r the block adds column by column (re-read from the
// cache) after each group. Dynamic shared memory: d floats, the block's
// column sums.
template <typename T, int NV>
__global__ void __launch_bounds__(32 * BWD_WARPS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partials, long long rows, int d, float eps) {
  extern __shared__ float col_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (NV > 0) {
    constexpr int VEC = 16 / sizeof(T);
    float acc[NV][VEC];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = 0.0f;
    for (long long row = (long long)blockIdx.x * BWD_WARPS + warp; row < rows;
         row += (long long)gridDim.x * BWD_WARPS)
      bwd_row_vec<T, NV>(x + row * d, scale, dy + row * d, dx + row * d, d, eps, acc);
    const int nvec = d / VEC;
    for (int w = 0; w < BWD_WARPS; ++w) {
      if (warp == w) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          if (lane + 32 * i < nvec)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const int c = (lane + 32 * i) * VEC + e;
              col_s[c] = (w ? col_s[c] : 0.0f) + acc[i][e];
            }
      }
      __syncthreads();
    }
  } else {
    __shared__ float r_s[BWD_WARPS];
    for (int c = threadIdx.x; c < d; c += blockDim.x) col_s[c] = 0.0f;
    for (long long row0 = (long long)blockIdx.x * BWD_WARPS; row0 < rows;
         row0 += (long long)gridDim.x * BWD_WARPS) {
      const long long row = row0 + warp;
      if (row < rows) {
        const float r = bwd_row_any<T>(x + row * d, scale, dy + row * d, dx + row * d, d, eps);
        if (lane == 0) r_s[warp] = r;
      }
      __syncthreads();
      const int n = rows - row0 < BWD_WARPS ? (int)(rows - row0) : BWD_WARPS;
      for (int c = threadIdx.x; c < d; c += blockDim.x) {
        float acc = col_s[c];
        for (int w = 0; w < n; ++w)
          acc += to_f32(x[(row0 + w) * d + c]) * to_f32(dy[(row0 + w) * d + c]) * r_s[w];
        col_s[c] = acc;
      }
      __syncthreads();                // r_s is rewritten by the next group
    }
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    partials[(long long)blockIdx.x * d + c] = col_s[c];
}

// dscale[c] = Σ_b partials[b, c], b in order
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_kernel(const float* __restrict__ partials, T* __restrict__ dscale, int blocks,
                      int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc += partials[(long long)b * d + c];
  store_f32(dscale + c, acc);
}

template <typename T, int NV>
int launch_bwd_nv(const void* x, const void* scale, const void* dy, void* dx, float* partials,
                  long long rows, int d, float eps, int blocks, cudaStream_t stream) {
  const int smem = d * (int)sizeof(float);
  static bool opted = false;         // above 48 KB, once per kernel: the most d takes
  if (smem > 48 * 1024 && !opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(rmsnorm_bwd_kernel<T, NV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_MAX_D * 4);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  rmsnorm_bwd_kernel<T, NV><<<blocks, 32 * BWD_WARPS, smem, stream>>>(
      (const T*)x, (const T*)scale, (const T*)dy, (T*)dx, partials, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               float* partials, long long rows, int d, float eps, int blocks,
               cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_lane = (d / VEC + 31) / 32;
  const bool aligned =
      ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0;
  int e;
  if (!aligned || d % VEC != 0 || per_lane > 8)
    e = launch_bwd_nv<T, 0>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
  else if (per_lane <= 2)
    e = launch_bwd_nv<T, 2>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
  else if (per_lane <= 4)
    e = launch_bwd_nv<T, 4>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
  else
    e = launch_bwd_nv<T, 8>(x, scale, dy, dx, partials, rows, d, eps, blocks, stream);
  if (e) return e;
  rmsnorm_dscale_kernel<T><<<(d + 255) / 256, 256, 0, stream>>>(partials, (T*)dscale, blocks, d);
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

// The gradient of rmsnorm: x, dy, dx (rows, d) contiguous, scale and dscale
// (d,), all fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); partials: (blocks,
// d) fp32 scratch, one row per block of the first kernel. Two launches:
// dx with the blocks' column sums, then dscale from those sums.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* dscale, void* partials, long long rows, int d, float eps,
                           int is_bf16, int blocks, void* stream) {
  if (d <= 0) return 0;
  if (rows < 0 || blocks <= 0 || d > BWD_MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partials;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, p, rows, d, eps, blocks, s)
                 : launch_bwd<float>(x, scale, dy, dx, dscale, p, rows, d, eps, blocks, s);
}
