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
// 4096 rows of 2048 bf16: 50.3 MB, 15.0 us at 3.35 TB/s). So the bytes must
// stay in flight on every SM, and the column sums of x·dy·r must meet
// without a slow tail. Two kernels, as before, but the second is wide: a
// warp-a-row kernel that kept 8 warps an SM, each alone on its row, and a
// dscale pass on 8 SMs, each thread adding 264 partial rows, are replaced.
// rmsnorm_bwd_rows_kernel: a block of 256 threads takes a row at a time, 16
// bytes of it a thread (2 vectors at d = 2048 fp32), a grid stride over the
// rows, as many blocks as the card holds at once (the occupancy
// calculator's count, rmsnorm_bwd_capacity: a single wave). Each thread
// copies its vectors of the next 3 rows of x and dy into a ring in shared
// memory by cp.async, so the loads fly under this row's two sums, which
// cross the block by shuffles and one barrier a row. A thread's columns
// are its own for every row: it keeps their sums of x·dy·r in registers,
// with no reduction inside the block. At the end the blocks of each
// cluster of 8 add their sums through distributed shared memory, each
// block an eighth of the columns, in rank order, into one row of partials
// a cluster (45 rows at the train shape on an H100, not 264).
// rmsnorm_bwd_cols_kernel, launched as a programmatic dependent of the row
// kernel (its launch overlaps the row kernel's end; it waits for that grid
// before it reads), adds those rows for each group of 4 columns, 4 groups of
// rows in flight at once, in a fixed order. A single launch with an integer
// counter and the last cluster adding the rows was tried: its barriers,
// fence and atomic cost 4 us after the last row (PERF.md). Other widths and
// alignments take the general path: rmsnorm_bwd_any_kernel (scalar loads,
// two passes, a warp a row, the column sums added in shared memory after
// each group of 4 rows, a row of partials a block) and then
// rmsnorm_dscale_kernel (the partials' rows in a fixed order, one thread a
// column). No atomics anywhere: two runs give the same bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

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

constexpr int RB_THREADS = 256;       // the row kernel: a block per row at a time
constexpr int RB_CLUSTER = 8;         // blocks whose column sums meet in shared memory
constexpr int RB_MAX_VECS = 4 * RB_THREADS;   // 16-byte vectors a row on the row kernel
constexpr int RB_COLS = 64;           // the dscale kernel: 4-column groups a block
constexpr int RB_SPLIT = 4;           // its thread groups a column
constexpr int RB_BATCH = 16;          // their loads in flight at once
constexpr int RB_STAGES = 4;          // rows a block has in shared memory: 3 ahead
constexpr int BWD_WARPS = 4;          // the general kernel: rows a block takes at a time
constexpr int BWD_MAX_D = 56 * 1024;  // its column sums fill shared memory

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The row kernel: d a multiple of VEC, at most RB_THREADS·NV·VEC; operands
// 16-byte aligned; gridDim.x a multiple of RB_CLUSTER, launched as clusters
// of RB_CLUSTER blocks. Thread t holds vectors t + RB_THREADS·i of every row
// it meets and their columns' sums of x·dy·r in registers; it copies its
// vectors of the next RB_STAGES - 1 rows of x and dy into a ring in shared
// memory (cp.async: each thread reads back only what it copied, so the ring
// needs no barrier). Dynamic shared memory: the ring (at least d floats).
// `partials`: (gridDim.x / RB_CLUSTER, d) fp32, a row per cluster.
template <typename T, int NV>
__global__ void __launch_bounds__(RB_THREADS, NV <= 2 ? 2 : 1)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partials, long long rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char rb_smem[];
  uint4* ring = reinterpret_cast<uint4*>(rb_smem);   // [RB_STAGES][x, dy][nvec]
  float* col_s = reinterpret_cast<float*>(rb_smem);  // after the rows: the column sums
  __shared__ float2 red_s[2][RB_THREADS / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nvec = d / VEC;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* dv = reinterpret_cast<const uint4*>(dy);
  const uint4* sv = reinterpret_cast<const uint4*>(scale);
  uint4* ov = reinterpret_cast<uint4*>(dx);

  // the dscale kernel may be launched now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  uint4 sraw[NV];
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (tid + RB_THREADS * i < nvec) sraw[i] = sv[tid + RB_THREADS * i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.0f;
  }
  auto issue = [&](long long row, int stage) {    // one copy group, empty past the rows
    if (row < rows)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = tid + RB_THREADS * i;
        if (v < nvec) {
          cp_async16(ring + (2 * stage) * nvec + v, xv + row * nvec + v);
          cp_async16(ring + (2 * stage + 1) * nvec + v, dv + row * nvec + v);
        }
      }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < RB_STAGES - 1; ++s) issue(blockIdx.x + (long long)s * gridDim.x, s);
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    const int stage = it % RB_STAGES;
    issue(row + (long long)(RB_STAGES - 1) * gridDim.x, (it + RB_STAGES - 1) % RB_STAGES);
    cp_async_wait<RB_STAGES - 1>();    // this row's copies have landed
    uint4 xr[NV], dr[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (tid + RB_THREADS * i < nvec) {
        xr[i] = ring[(2 * stage) * nvec + tid + RB_THREADS * i];
        dr[i] = ring[(2 * stage + 1) * nvec + tid + RB_THREADS * i];
      }
    float ss = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (tid + RB_THREADS * i < nvec) {
        float xf[VEC], df[VEC], sf[VEC];
        widen<T>(xr[i], xf);
        widen<T>(dr[i], df);
        widen<T>(sraw[i], sf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss += xf[e] * xf[e];
          s1 += xf[e] * (1.0f + sf[e]) * df[e];
        }
      }
    }
    ss = warp_sum(ss);
    s1 = warp_sum(s1);
    if (lane == 0) red_s[it & 1][warp] = make_float2(ss, s1);
    __syncthreads();                 // (two buffers: one barrier a row)
    ss = 0.0f;
    s1 = 0.0f;
#pragma unroll
    for (int w = 0; w < RB_THREADS / 32; ++w) {
      ss += red_s[it & 1][w].x;
      s1 += red_s[it & 1][w].y;
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float c = r * r * r * (s1 / (float)d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (tid + RB_THREADS * i < nvec) {
        float xf[VEC], df[VEC], sf[VEC];
        widen<T>(xr[i], xf);
        widen<T>(dr[i], df);
        widen<T>(sraw[i], sf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[i][e] += xf[e] * df[e] * r;
          xf[e] = (1.0f + sf[e]) * df[e] * r - xf[e] * c;
        }
        ov[row * nvec + tid + RB_THREADS * i] = narrow<T>(xf);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the column sums

  // the block's column sums into its shared memory; then block r of each
  // cluster adds the r-th eighth of the columns over the cluster's blocks,
  // in rank order, into the cluster's row of partials
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (tid + RB_THREADS * i < nvec)
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(col_s + (tid + RB_THREADS * i) * VEC + e) =
            make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int c4 = d / 4, lo = rank * c4 / RB_CLUSTER, hi = (rank + 1) * c4 / RB_CLUSTER;
  float* mine = partials + (long long)(blockIdx.x / RB_CLUSTER) * d;
  for (int i = lo + tid; i < hi; i += RB_THREADS) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int src = 0; src < RB_CLUSTER; ++src) {
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(col_s, src) + 4 * i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(mine + 4 * i) = s;
  }
  cluster.sync();                    // no block of the cluster reads this col_s any more
}

// dscale from the row kernel's partials, (clusters, d) fp32: a thread per
// (4 columns, group of the rows); each group adds its run of the rows in
// order, all of the run's loads in flight at once (RB_BATCH at a time), and
// the groups' sums are added in order. Launched as a programmatic dependent
// of the row kernel: its launch overlaps the row kernel's end, and it waits
// for the row kernel to finish before it reads.
template <typename T>
__global__ void __launch_bounds__(RB_COLS * RB_SPLIT)
rmsnorm_bwd_cols_kernel(const float* __restrict__ partials, T* __restrict__ dscale,
                        int clusters, int d) {
  __shared__ float4 part_s[RB_SPLIT][RB_COLS];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int col = blockIdx.x * RB_COLS + threadIdx.x % RB_COLS, grp = threadIdx.x / RB_COLS;
  const int k_lo = grp * clusters / RB_SPLIT, k_hi = (grp + 1) * clusters / RB_SPLIT;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (col < d / 4)
    for (int k0 = k_lo; k0 < k_hi; k0 += RB_BATCH) {
      float4 v[RB_BATCH];
#pragma unroll
      for (int b = 0; b < RB_BATCH; ++b)
        if (k0 + b < k_hi)
          v[b] = reinterpret_cast<const float4*>(partials + (long long)(k0 + b) * d)[col];
#pragma unroll
      for (int b = 0; b < RB_BATCH; ++b)
        if (k0 + b < k_hi) {
          s.x += v[b].x;
          s.y += v[b].y;
          s.z += v[b].z;
          s.w += v[b].w;
        }
    }
  part_s[grp][threadIdx.x % RB_COLS] = s;
  __syncthreads();
  if (grp == 0 && col < d / 4) {
#pragma unroll
    for (int g = 1; g < RB_SPLIT; ++g) {
      const float4 v = part_s[g][threadIdx.x];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    T* out = dscale + 4 * col;
    store_f32(out, s.x);
    store_f32(out + 1, s.y);
    store_f32(out + 2, s.z);
    store_f32(out + 3, s.w);
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

// The general kernel: groups of BWD_WARPS rows, a warp a row, whose x·dy·r
// the block adds column by column (re-read from the cache) after each
// group; each block writes its column sums as one row of `partials`.
// Dynamic shared memory: d floats, the block's column sums.
template <typename T>
__global__ void __launch_bounds__(32 * BWD_WARPS)
rmsnorm_bwd_any_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partials, long long rows, int d, float eps) {
  extern __shared__ float col_s[];
  __shared__ float r_s[BWD_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
    __syncthreads();                  // r_s is rewritten by the next group
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

// the ring's bytes, at least d floats
template <typename T>
int rows_smem(int d) {
  const int ring = RB_STAGES * 2 * (d / (16 / (int)sizeof(T))) * 16;
  return ring > 4 * d ? ring : 4 * d;
}

// the row kernel's launch configuration: clusters of RB_CLUSTER blocks,
// above 48 KB of shared memory opted into once, at the most NV takes
template <typename T, int NV>
int rows_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* cluster, int blocks, int d,
                cudaStream_t stream) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_rows_kernel<T, NV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               RB_STAGES * 2 * NV * RB_THREADS * 16);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(RB_THREADS);
  cfg.dynamicSmemBytes = (size_t)rows_smem<T>(d);
  cfg.stream = stream;
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = RB_CLUSTER;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return 0;
}

// the row kernel, then the dscale kernel as its programmatic dependent
template <typename T, int NV>
int launch_bwd_rows(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                    float* partials, long long rows, int d, float eps, int blocks,
                    cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (int e = rows_config<T, NV>(cfg, attr, blocks, d, stream)) return e;
  cudaError_t e = cudaLaunchKernelEx(&cfg, rmsnorm_bwd_rows_kernel<T, NV>, (const T*)x,
                                     (const T*)scale, (const T*)dy, (T*)dx, partials, rows, d,
                                     eps);
  if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cols = {};
  cols.gridDim = dim3((unsigned)((d / 4 + RB_COLS - 1) / RB_COLS));
  cols.blockDim = dim3(RB_COLS * RB_SPLIT);
  cols.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cols.attrs = pdl;
  cols.numAttrs = 1;
  e = cudaLaunchKernelEx(&cols, rmsnorm_bwd_cols_kernel<T>, (const float*)partials, (T*)dscale,
                         blocks / RB_CLUSTER, d);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_any(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                   float* partials, long long rows, int d, float eps, int blocks,
                   cudaStream_t stream) {
  const int smem = d * (int)sizeof(float);
  static bool opted = false;         // above 48 KB, once per kernel: the most d takes
  if (smem > 48 * 1024 && !opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_MAX_D * 4);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  rmsnorm_bwd_any_kernel<T><<<blocks, 32 * BWD_WARPS, smem, stream>>>(
      (const T*)x, (const T*)scale, (const T*)dy, (T*)dx, partials, rows, d, eps);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  rmsnorm_dscale_kernel<T><<<(d + 255) / 256, 256, 0, stream>>>(partials, (T*)dscale, blocks, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               float* partials, long long rows, int d, float eps, int blocks,
               cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const bool aligned =
      ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0;
  if (!aligned || d % VEC != 0 || nvec > RB_MAX_VECS)
    return launch_bwd_any<T>(x, scale, dy, dx, dscale, partials, rows, d, eps, blocks, stream);
  if (blocks % RB_CLUSTER != 0) return (int)cudaErrorInvalidValue;
  if (nvec <= RB_THREADS)
    return launch_bwd_rows<T, 1>(x, scale, dy, dx, dscale, partials, rows, d, eps, blocks,
                                 stream);
  if (nvec <= 2 * RB_THREADS)
    return launch_bwd_rows<T, 2>(x, scale, dy, dx, dscale, partials, rows, d, eps, blocks,
                                 stream);
  return launch_bwd_rows<T, 4>(x, scale, dy, dx, dscale, partials, rows, d, eps, blocks,
                               stream);
}

template <typename T, int NV>
int rows_capacity(int d) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (rows_config<T, NV>(cfg, attr, RB_CLUSTER, d, 0)) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, rmsnorm_bwd_rows_kernel<T, NV>, &cfg) != cudaSuccess)
    return 0;
  return n;
}

template <typename T>
int capacity(int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  if (d <= 0 || d % VEC != 0 || nvec > RB_MAX_VECS) return 0;
  if (nvec <= RB_THREADS) return rows_capacity<T, 1>(d);
  if (nvec <= 2 * RB_THREADS) return rows_capacity<T, 2>(d);
  return rows_capacity<T, 4>(d);
}

}  // namespace

// The clusters of 8 row-kernel blocks the card holds at once for rows of d
// elements (fp32 or bf16), from the occupancy calculator, into *count (host
// memory; 0 where the row kernel does not take d). The stream is taken as
// every entry here takes it; the count is the current device's.
extern "C" int rmsnorm_bwd_capacity(int d, int is_bf16, void* count, void* stream) {
  (void)stream;
  *(int*)count = is_bf16 ? capacity<__nv_bfloat16>(d) : capacity<float>(d);
  return (int)cudaGetLastError();
}

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
// (d,), all fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1). The row kernel
// (operands 16-byte aligned, d a multiple of 16 bytes and at most 1,024 such
// vectors) takes `blocks` a multiple of 8 and partials (blocks / 8, d) fp32:
// dx with each cluster's column sums, then dscale from those sums. The
// general kernel takes partials (blocks, d): dx with each block's column
// sums, then dscale. Two launches either way.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* dscale, void* partials, long long rows, int d, float eps,
                           int is_bf16, int blocks, void* stream) {
  if (d <= 0) return 0;
  if (rows < 0 || blocks <= 0 || d > BWD_MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partials;
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, p, rows, d, eps, blocks, s)
             : launch_bwd<float>(x, scale, dy, dx, dscale, p, rows, d, eps, blocks, s);
}
