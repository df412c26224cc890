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
// (_qdq_kernel): `stochastic_quantize` on its portable path, where the random
// bits are an operand, and `stochastic_quantize_keyed` as the counterpart of
// its device_prng branch (quantize.py:40-44), where no bits operand sits in
// HBM: each lane computes its bits in registers with threefry
// (threefry.cuh) from its row's key at counter offset + column, the
// counters random.bits(key, (C, chunk)) uses. So the keyed entry gives,
// bit for bit, what the bits-operand entry gives on random.bits of the same
// keys, and a long vector can be quantized in 256-aligned pieces, each at
// its own offset.
//
// Bound: memory. Per element it reads x (4 B) and bits (4 B) and writes the
// int8 value (1 B) and xhat (4 B), plus one fp32 scale per chunk, and does a
// handful of operations. At the main path's shape (10 clients × 101,632 =
// 397 chunks of 256 each) that is 13,228,040 B: 3.95 us at 3.35 TB/s. The
// keyed entry reads no bits (9 B an element) and adds threefry's ~85
// integer operations an element.
//
// Design: one block per (chunk, row), so x and bits are read coalesced, and
// the chunk's absmax is a warp-shuffle reduction followed by one across the
// block's warps in shared memory. The block has one thread per element of
// the chunk rounded up to whole warps, at most 1,024: a longer chunk is
// walked by the block's stride (a second build of the kernel), each
// thread's first element held in a register and the others read again
// after the absmax (from L2); a chunk that is not a multiple of 32 leaves
// the last warp's tail lanes idle (at chunk 1, 31 of 32: such chunks are
// correct, not fast). Past 65,535 rows (the grid's y limit) each block walks
// the rows by the grid's stride. The ragged end of a row (P not a multiple
// of chunk) reads as zeros; those lanes still get their int8 value (always
// 0) as the reference pads them. The absmax is a max, exact in any order,
// so the results do not depend on the block shape.
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

#include "threefry.cuh"

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Chunk c of row `row`. KEYED: bits from threefry of keys[row] (two uint32
// words held in int64) at counter offset + column; otherwise read from the
// bits operand. STRIDED: the chunk is longer than the block, whose threads
// walk it by the block's stride; otherwise each thread takes at most one
// element (a thread past the chunk's end only joins the absmax with 0).
template <bool KEYED, bool STRIDED>
__device__ __forceinline__ void quantize_chunk(float* partial, const float* __restrict__ x,
                                               const uint32_t* __restrict__ bits,
                                               const int64_t* __restrict__ keys,
                                               int64_t offset, int8_t* __restrict__ values,
                                               float* __restrict__ scales,
                                               float* __restrict__ xhat, int64_t row,
                                               int64_t p, int chunks, int chunk, float inv_qmax,
                                               float qmax) {
  const int c = blockIdx.x;
  const int j0 = threadIdx.x;
  const int64_t padded = (int64_t)chunks * chunk;
  const int64_t c0 = (int64_t)c * chunk;
  auto load = [&](int j) { return j < chunk && c0 + j < p ? x[row * p + c0 + j] : 0.0f; };
  const float x0 = load(j0);
  float m = fabsf(x0);
  if (STRIDED)
    for (int j = j0 + blockDim.x; j < chunk; j += blockDim.x) m = fmaxf(m, fabsf(load(j)));
  m = warp_max(m);
  if ((j0 & 31) == 0) partial[j0 >> 5] = m;
  __syncthreads();
  if (j0 < 32) {
    m = j0 < (int)(blockDim.x >> 5) ? partial[j0] : 0.0f;
    m = warp_max(m);
    if (j0 == 0) partial[0] = m;
  }
  __syncthreads();
  const float absmax = partial[0];

  const float scale = __fmul_rn(absmax, inv_qmax);
  const float safe = scale > 0.0f ? scale : 1.0f;
  auto quantize_one = [&](int j, float xv) {
    const int64_t col = c0 + j;
    uint32_t b;
    if (KEYED) {
      b = threefry::bits((uint32_t)keys[2 * row], (uint32_t)keys[2 * row + 1],
                         (uint64_t)(offset + col));
    } else {
      b = bits[row * padded + col];
    }
    const float u = __fmul_rn((float)(b >> 8), 5.9604644775390625e-08f);  // 2^-24
    float q = floorf(__fadd_rn(__fdiv_rn(xv, safe), u));
    q = fminf(fmaxf(q, -qmax), qmax);
    const int qi = (int)q;
    values[row * padded + col] = (int8_t)qi;
    if (col < p) xhat[row * p + col] = __fmul_rn((float)qi, scale);
  };
  if (j0 < chunk) quantize_one(j0, x0);
  if (STRIDED)
    for (int j = j0 + blockDim.x; j < chunk; j += blockDim.x) quantize_one(j, load(j));
  if (j0 == 0) scales[row * chunks + c] = scale;
}

// One block per (chunk, row); WALK (more than 65,535 rows, the grid's y
// limit): each block walks the rows by the grid's stride.
template <bool KEYED, bool STRIDED, bool WALK>
__global__ void stochastic_quantize_kernel(const float* __restrict__ x,
                                           const uint32_t* __restrict__ bits,
                                           const int64_t* __restrict__ keys,
                                           int64_t offset,
                                           int8_t* __restrict__ values,
                                           float* __restrict__ scales,
                                           float* __restrict__ xhat, int64_t rows,
                                           int64_t p, int chunks, int chunk,
                                           float inv_qmax, float qmax) {
  __shared__ float partial[32];
  if (!WALK) {
    quantize_chunk<KEYED, STRIDED>(partial, x, bits, keys, offset, values, scales, xhat,
                                   blockIdx.y, p, chunks, chunk, inv_qmax, qmax);
    return;
  }
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    quantize_chunk<KEYED, STRIDED>(partial, x, bits, keys, offset, values, scales, xhat, row,
                                   p, chunks, chunk, inv_qmax, qmax);
    __syncthreads();                 // partial[0] is read before it is rewritten
  }
}

constexpr int kMaxThreads = 1024;

// The kernel for `chunk` and `rows`: whole warps a block, at most
// kMaxThreads threads.
template <bool KEYED>
int launch(const float* x, const uint32_t* bits, const int64_t* keys, int64_t offset,
           int8_t* values, float* scales, float* xhat, long long rows, long long p,
           long long chunks, int chunk, float inv_qmax, int qmax, cudaStream_t stream) {
  if (rows <= 0 || chunks <= 0) return 0;
  if (chunk < 1 || chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)(rows < 65535 ? rows : 65535));
  const int threads = chunk >= kMaxThreads ? kMaxThreads : (chunk + 31) / 32 * 32;
  auto go = [&](auto kernel) {
    kernel<<<grid, threads, 0, stream>>>(x, bits, keys, offset, values, scales, xhat, rows, p,
                                         (int)chunks, chunk, inv_qmax, (float)qmax);
  };
  const bool strided = chunk > kMaxThreads, walk = rows > 65535;
  if (strided && walk) go(stochastic_quantize_kernel<KEYED, true, true>);
  else if (strided) go(stochastic_quantize_kernel<KEYED, true, false>);
  else if (walk) go(stochastic_quantize_kernel<KEYED, false, true>);
  else go(stochastic_quantize_kernel<KEYED, false, false>);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, p) fp32; bits: (rows, chunks*chunk) uint32; values: (rows,
// chunks*chunk) int8; scales: (rows, chunks) fp32; xhat: (rows, p) fp32.
// Any chunk >= 1 and any row count.
extern "C" int stochastic_quantize(const void* x, const void* bits, void* values,
                                   void* scales, void* xhat, long long rows,
                                   long long p, long long chunks, int chunk,
                                   float inv_qmax, int qmax, void* stream) {
  return launch<false>((const float*)x, (const uint32_t*)bits, nullptr, 0, (int8_t*)values,
                       (float*)scales, (float*)xhat, rows, p, chunks, chunk, inv_qmax, qmax,
                       (cudaStream_t)stream);
}

// As stochastic_quantize, with keys: (rows, 2) int64 holding uint32 words
// (one threefry key a row) in place of the bits; element `col` of a row
// (padded lanes included) takes the bits at counter offset + col.
extern "C" int stochastic_quantize_keyed(const void* x, const void* keys,
                                         long long offset, void* values,
                                         void* scales, void* xhat,
                                         long long rows, long long p,
                                         long long chunks, int chunk, float inv_qmax,
                                         int qmax, void* stream) {
  return launch<true>((const float*)x, nullptr, (const int64_t*)keys, (int64_t)offset,
                      (int8_t*)values, (float*)scales, (float*)xhat, rows, p, chunks, chunk,
                      inv_qmax, qmax, (cudaStream_t)stream);
}
