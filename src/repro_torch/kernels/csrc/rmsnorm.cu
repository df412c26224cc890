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
// Design: one block per row, so the grid needs no padding to a row block
// (the TPU kernel pads the rows up to 256) and the ragged edge does not
// exist. Pass 1 sums x² in fp32: each thread a strided share, then a
// warp-shuffle reduction and one across the block's warps in shared memory.
// Pass 2 reads the row again (it is still in L1/L2) and writes y. No
// --use_fast_math: rsqrtf is CUDA's (2 ulp), the mean a true division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  __shared__ float partial[32];
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* outr = out + (int64_t)blockIdx.x * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.0f;
    ss = warp_sum(ss);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / (float)d + eps);

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float y = to_f32(xr[i]) * r;
    store_f32(outr + i, y * (1.0f + to_f32(scale[i])));
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           float eps, cudaStream_t stream) {
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  rmsnorm_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
      (const T*)x, (const T*)scale, (T*)out, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous and scale: (d,), all fp32 (is_bf16 = 0) or
// all bf16 (is_bf16 = 1). One block per row.
extern "C" int rmsnorm(const void* x, const void* scale, void* out, long long rows,
                       int d, float eps, int is_bf16, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s)
                 : launch<float>(x, scale, out, rows, d, eps, s);
}
