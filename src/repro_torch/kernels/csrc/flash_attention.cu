// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with GQA, a causal mask that is right-aligned when Sq < Sk (query row i
// sits at position i + Sk - Sq), an optional sliding window, and fully
// masked rows giving 0 (never NaN). q: (B, H, Sq, D); k, v: (B, KV, Sk, D);
// o: (B, H, Sq, D); query head h reads KV head h / (H / KV). Every operand is
// addressed through its own (b, h, s) element strides with a contiguous last
// dimension, so decode reads the first pos+1 rows of a (B, S, KV, D) cache
// as a permuted view, without a copy.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel).
//
// Bound: at the serve path's prefill (B=8, H=16, KV=2, S=512, D=128, bf16)
// the bytes, 37,748,736 (q, k, v read once, o written once): 11.3 us at
// 3.35 TB/s, against 8.6 GFLOP of causal work, 8.7 us at the bf16 tensor
// rate. Decode (Sq=1 against pos+1 keys) is bytes: the cache rows.
//
// Design (simple first; no tensor cores, no async copies): one block per
// (q tile, head, batch). A block of W warps owns BQ = W·R query rows, R per
// warp, staged in shared memory as fp32. It walks the K/V tiles of 32 keys
// that its rows can see, skipping whole tiles before the window and after
// the causal edge (as the TPU kernel's pl.when does), and stages each tile
// in shared memory as fp32, K padded to D+1 floats a row so that lane j
// reading key j's row hits a bank of its own. Each thread first loads its
// share of a tile as 16-byte vectors into registers, all loads in flight at
// once, then converts and stores them (one scalar load at a time would wait
// out the memory latency once per element). Per tile, lane j scores key j
// against each of the warp's rows, the running max and sum update with two
// warp reductions per row, and the fp32 accumulator (D/32 per lane per row,
// in registers) adds p·V with p broadcast by shuffles. Lengths need not
// divide the tiles: keys past Sk and rows past Sq are masked here (the TPU
// kernel asserts divisibility). The scale is an argument, 1/sqrt(D) by
// default. All arithmetic is fp32; expf is the accurate one (no
// --use_fast_math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;               // keys per tile: one per lane
constexpr float NEG_INF = -1e30f;    // the TPU kernel's mask value

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {
  long long b, h, s;                 // in elements; the D axis has stride 1
};

template <int D, int R, int W>
constexpr int smem_bytes() {
  return (W * R * D + BK * (D + 1) + BK * D) * (int)sizeof(float);
}

// 16 bytes of T (8 bf16 or 4 fp32) widened to fp32
__device__ __forceinline__ void widen(const uint4& raw, float* dst, const float*) {
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = e[i];
}
__device__ __forceinline__ void widen(const uint4& raw, float* dst, const __nv_bfloat16*) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(e[i]);
}

// Stage NROWS rows of D elements (row i at src + i·stride, 16-byte
// aligned) into dst (row i at dst + i·dst_stride) as fp32; rows at or past
// `valid` read as zeros. Every thread loads its vectors before storing any.
template <typename T, int D, int THREADS, int NROWS>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long stride,
                                      int valid, float* dst, int dst_stride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int TOTAL = NROWS * PER_ROW;
  constexpr int PER_THREAD = (TOTAL + THREADS - 1) / THREADS;
  uint4 raw[PER_THREAD];
#pragma unroll
  for (int n = 0; n < PER_THREAD; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int row = i / PER_ROW, col = (i % PER_ROW) * VEC;
    raw[n] = make_uint4(0, 0, 0, 0);
    if (i < TOTAL && row < valid)
      raw[n] = *reinterpret_cast<const uint4*>(src + (int64_t)row * stride + col);
  }
#pragma unroll
  for (int n = 0; n < PER_THREAD; ++n) {
    const int i = threadIdx.x + n * THREADS;
    if (i < TOTAL) {
      const int row = i / PER_ROW, col = (i % PER_ROW) * VEC;
      float f[VEC];
      widen(raw[n], f, src);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[row * dst_stride + col + e] = f[e];
    }
  }
}

template <typename T, int D, int R, int W>
__global__ void __launch_bounds__(W * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int rep, int sq, int sk,
                 int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int bq = W * R;
  float* q_s = smem;                     // (bq, D)
  float* k_s = q_s + bq * D;             // (BK, D + 1)
  float* v_s = k_s + BK * (D + 1);       // (BK, D)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int q0 = blockIdx.x * bq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / rep) * ks.h;
  const T* vb = v + b * vs.b + (h / rep) * vs.h;
  T* ob = o + b * os.b + h * os.h;

  stage<T, D, W * 32, bq>(qb + (int64_t)q0 * qs.s, qs.s, sq - q0, q_s, D);

  // the keys any row of this block can see
  const int off = sk - sq;
  const int last = min(q0 + bq, sq) - 1;
  const int k_end = causal ? min(sk, last + off + 1) : sk;
  const int k_beg = window ? max(0, q0 + off - window + 1) : 0;

  float m[R], l[R], acc[R][D / 32];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[r][i] = 0.0f;
  }
  const float* qw = q_s + warp * R * D;
  const bool active = q0 + warp * R < sq;

  for (int t0 = (k_beg / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();                     // the previous tile is consumed
    stage<T, D, W * 32, BK>(kb + (int64_t)t0 * ks.s, ks.s, sk - t0, k_s, D + 1);
    stage<T, D, W * 32, BK>(vb + (int64_t)t0 * vs.s, vs.s, sk - t0, v_s, D);
    __syncthreads();
    if (!active) continue;               // warp-uniform: all of its rows lie past Sq

    // lane j: the scores of key t0 + j against the warp's R rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    const float* krow = k_s + lane * (D + 1);
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float k0 = krow[c], k1 = krow[c + 1], k2 = krow[c + 2], k3 = krow[c + 3];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + c);
        s[r] += qv.x * k0;
        s[r] += qv.y * k1;
        s[r] += qv.z * k2;
        s[r] += qv.w * k3;
      }
    }

    // online softmax, one row at a time (every lane takes part)
    const int kp = t0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qp = q0 + warp * R + r + off;
      bool ok = kp < sk;
      if (causal) ok = ok && kp <= qp;
      if (window) ok = ok && qp - kp < window;
      const float sc = ok ? s[r] * scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.0f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[r][i] *= alpha;
    }

    // acc[r][i] += sum_j p_j · v[j][lane + 32 i]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[D / 32];
#pragma unroll
      for (int i = 0; i < D / 32; ++i) vj[i] = v_s[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < D / 32; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + warp * R + r;
    if (row < sq) {
      const float denom = l[r] == 0.0f ? 1.0f : l[r];   // fully masked row -> 0
#pragma unroll
      for (int i = 0; i < D / 32; ++i)
        store_f32(ob + (int64_t)row * os.s + lane + 32 * i, acc[r][i] / denom);
    }
  }
}

template <typename T, int D, int R, int W>
int launch_cfg(const void* q, const void* k, const void* v, void* o,
               const Strides* st, long long b, int h, int rep, int sq, int sk,
               int causal, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, R, W>();
  // above 48 KB a block's shared memory must be opted into, once per kernel
  static bool opted = false;
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D, R, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  constexpr int bq = W * R;
  dim3 grid((unsigned)((sq + bq - 1) / bq), (unsigned)h, (unsigned)b);
  flash_fwd_kernel<T, D, R, W><<<grid, W * 32, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, st[0], st[1], st[2], st[3], rep,
      sq, sk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, const Strides* st,
             long long b, int h, int rep, int sq, int sk, int causal, int window,
             float scale, cudaStream_t stream) {
  // prefill: 8 warps of 8 rows (64-row tiles); decode and other short
  // queries: 4 warps of one row each, so that the K/V loads have 128 threads
  if (sq >= 8)
    return launch_cfg<T, D, 8, 8>(q, k, v, o, st, b, h, rep, sq, sk, causal, window,
                                  scale, stream);
  return launch_cfg<T, D, 1, 4>(q, k, v, o, st, b, h, rep, sq, sk, causal, window,
                                scale, stream);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, const Strides* st,
             long long b, int h, int rep, int sq, int sk, int d, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_d<T, 32>(q, k, v, o, st, b, h, rep, sq, sk, causal, window, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, st, b, h, rep, sq, sk, causal, window, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, st, b, h, rep, sq, sk, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (b, h, s) for q, k, v and o in that order;
// q, k, v 16-byte aligned with their (b, h, s) strides multiples of 16
// bytes. d in {32, 64, 128}; h a multiple of kvh; b, h at most 65535.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               const long long* strides, long long b, int h, int kvh,
                               int sq, int sk, int d, int causal, int window,
                               float scale, int is_bf16, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || b > 65535 || h > 65535 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  const int rep = h / kvh;
  if (is_bf16)
    return launch_t<__nv_bfloat16>(q, k, v, o, st, b, h, rep, sq, sk, d, causal, window, scale, s);
  return launch_t<float>(q, k, v, o, st, b, h, rep, sq, sk, d, causal, window, scale, s);
}
