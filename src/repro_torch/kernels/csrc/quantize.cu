// Fused stochastic quantize-dequantize for Hopper (sm_90a): the encode step
// of every compressed upload. For each `chunk`-wide slice of each row of a
// stacked (rows, P) fp32 matrix (all clients' uploads at once):
//
//     scale = absmax(x_c) · fp32(1/qmax)
//     u     = (bits >> 8) · 2^-24                      uniform on [0, 1)
//     q     = clip(floor(x / safe + u), -qmax, qmax)   safe = scale or 1
//     values (int8) = q,  xhat = q · scale
//
// Replaces: src/repro/kernels/quantize.py:stochastic_quantize_pallas
// (_qdq_kernel), on its portable path where the random bits are an operand.
//
// Bound: memory. Per element it reads x (4 B) and bits (4 B) and writes the
// int8 value (1 B) and xhat (4 B), plus one fp32 scale per chunk, and does a
// handful of operations. At the main path's shape (10 clients × 101,632 =
// 397 chunks of 256 each) that is 13,228,040 B: 3.95 us at 3.35 TB/s.
//
// Design: one block per (chunk, row), one thread per element, so x and bits
// are read once, coalesced, and the chunk's absmax is a warp-shuffle
// reduction followed by one across the block's warps in shared memory. The
// ragged end of a row (P not a multiple of chunk) reads as zeros; those
// lanes still get their int8 value (always 0) as the reference pads them.
//
// Bit-exact with repro.comm.codecs.stochastic_round_chunks on the same bits:
// - x / safe is a correctly rounded fp32 division (__fdiv_rn; nvcc's default
//   -prec-div=true, never --use_fast_math);
// - the scale constant fp32(1/qmax) is computed in double on the host and
//   rounded once, as the reference does, not recomputed here;
// - (bits >> 8) < 2^24 converts to float exactly and the product with 2^-24
//   is exact, so the sum rounds once whether or not it is contracted; the
//   explicit __fmul_rn/__fadd_rn keep nvcc from fusing anything else;
// - floor of a negative value rounds toward -inf, and the clip happens on
//   the float before the int8 store, whose value -0.0 stores as 0;
// - xhat is the int8 level times the scale, as the reference's decode does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void stochastic_quantize_kernel(const float* __restrict__ x,
                                           const uint32_t* __restrict__ bits,
                                           int8_t* __restrict__ values,
                                           float* __restrict__ scales,
                                           float* __restrict__ xhat, int64_t p,
                                           int chunks, float inv_qmax, float qmax) {
  __shared__ float partial[32];
  const int64_t row = blockIdx.y;
  const int c = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t padded = (int64_t)chunks * blockDim.x;
  const int64_t col = (int64_t)c * blockDim.x + j;

  const float xv = col < p ? x[row * p + col] : 0.0f;
  float m = warp_max(fabsf(xv));
  if ((j & 31) == 0) partial[j >> 5] = m;
  __syncthreads();
  if (j < 32) {
    m = j < (int)(blockDim.x >> 5) ? partial[j] : 0.0f;
    m = warp_max(m);
    if (j == 0) partial[0] = m;
  }
  __syncthreads();
  const float absmax = partial[0];

  const float scale = __fmul_rn(absmax, inv_qmax);
  const float safe = scale > 0.0f ? scale : 1.0f;
  const uint32_t b = bits[row * padded + col];
  const float u = __fmul_rn((float)(b >> 8), 5.9604644775390625e-08f);  // 2^-24
  float q = floorf(__fadd_rn(__fdiv_rn(xv, safe), u));
  q = fminf(fmaxf(q, -qmax), qmax);
  const int qi = (int)q;
  values[row * padded + col] = (int8_t)qi;
  if (j == 0) scales[row * chunks + c] = scale;
  if (col < p) xhat[row * p + col] = __fmul_rn((float)qi, scale);
}

}  // namespace

// x: (rows, p) fp32; bits: (rows, chunks*chunk) uint32; values: (rows,
// chunks*chunk) int8; scales: (rows, chunks) fp32; xhat: (rows, p) fp32.
// chunk is the block size: a multiple of 32, at most 1024.
extern "C" int stochastic_quantize(const void* x, const void* bits, void* values,
                                   void* scales, void* xhat, long long rows,
                                   long long p, int chunks, int chunk,
                                   float inv_qmax, int qmax, void* stream) {
  if (rows <= 0 || chunks <= 0) return 0;
  dim3 grid((unsigned)chunks, (unsigned)rows);
  stochastic_quantize_kernel<<<grid, chunk, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)bits, (int8_t*)values, (float*)scales,
      (float*)xhat, (int64_t)p, chunks, inv_qmax, (float)qmax);
  return (int)cudaGetLastError();
}
