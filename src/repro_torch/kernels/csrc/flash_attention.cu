// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with GQA, a causal mask that is right-aligned when Sq < Sk (query row i
// sits at position i + Sk - Sq), an optional sliding window, an optional
// prefix-LM block (every row sees the keys at positions below prefix_len,
// inside or outside its window: the reference's (causal ∧ window) ∨ k_pos <
// prefix_len), and fully masked rows giving 0 (never NaN). Head dims 32, 64,
// 128 and 256. q: (B, H, Sq, D); k, v: (B, KV, Sk, D);
// o: (B, H, Sq, D); query head h reads KV head h / (H / KV). Every operand is
// addressed through its own (b, h, s) element strides with a contiguous last
// dimension, so decode reads the first pos+1 rows of a (B, S, KV, D) cache
// as a permuted view, without a copy. Lengths need not divide any tile: keys
// past Sk and rows past Sq are masked here (the TPU kernel asserts
// divisibility). The scale is an argument, 1/sqrt(D) by default.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel).
//
// Three kernels, chosen by type and shape (one launch per call):
//
// bf16 prefill, flash_tc_kernel. Bound: at the serve path's prefill (B=8,
// H=16, KV=2, S=512, D=128) the bytes, 37,748,736 (q, k, v read once, o
// written once): 11.3 us at 3.35 TB/s, against 8.6 GFLOP of causal work,
// 8.7 us at the bf16 tensor rate. So the products must run on the tensor
// cores at Hopper's warpgroup rate and the tiles must arrive while they
// run. One warpgroup (4 warps) per (64-row q tile, head, batch), the longest
// rows first. The q tile and a two-stage ring of 64-key K and V tiles sit in
// shared memory as bf16 in the swizzled layout wgmma reads (128-byte rows
// of 64 columns, 16-byte chunks XORed with the row), filled by cp.async
// 16-byte copies, the next tile's copies in flight while the current one
// is used. S = Q·Kᵀ is wgmma m64n64k16 with both operands from shared
// memory; the online softmax runs on S's fp32 accumulator fragment with
// exp2f (log2 e folded into the scale); P, rounded to bf16, stays in
// registers as the A operand of O += P·V, wgmma m64nDk16 with V from shared
// memory read transposed, accumulating in fp32. The loop is software
// pipelined: the softmax of tile t runs on the CUDA cores while the tensor
// cores add tile t-1's P·V. Whole tiles before the window or past the causal
// edge are skipped, and only the tiles at an edge are masked element by
// element. The output goes out through the q tile in shared memory as
// 16-byte stores. What still bounds it: a block's tiles run one after the
// other (2 blocks an SM, at 208 registers a thread at D = 128), with the
// copies, the softmax and both products each a part of the time. At D = 256
// the O accumulator is 128 registers a thread, P·V two m64n128k16 products
// on the two halves of V (their fragments are O's two halves), and the
// 164,864 bytes of tiles leave one block an SM.
//
// bf16 decode (rep·Sq <= 16 query rows per KV head), flash_split_kernel.
// Bound: the cache bytes (at the serve path's decode, 543 rows of 2 KV heads
// for 8 sequences: 4.5 MB, 1.35 us), but at that size latency rules: a
// launch, one HBM round trip and a merge across blocks. One block (8 warps)
// per (key split, KV head, batch) takes all rep·Sq query rows of its group,
// so each K and V row is read once, and the key splits (9 of 61 keys at
// Sk = 543) fill the SMs. q's loads go out first, then K's and V's cp.async
// groups, so the scores start when K is in. The group's rows, padded to 16,
// are one mma.sync.m16n8k16 M tile: S = Q·Kᵀ (q in registers, a warp per 8
// keys) and O += P·V (P rounded to bf16, a warp per 8-column tile) run on the
// tensor cores in fp32; the online softmax runs a warp per row. The splits of
// a group form one thread-block cluster. Each split scatters its partial
// (O, m, l) through distributed shared memory, 16-byte chunks to the block
// that merges them, so no block receives more than its share; one cluster
// barrier later every block merges its chunks from its own shared memory
// with weights exp2(m_s - M), an empty split (m = -inf) weighing 0. No
// scratch in global memory, no second launch. Its tiles and the merge buffer
// are dynamic shared memory, and the splits are capped (split_cap) so that
// both fit a block's 227 KB: 16 up to D = 128, 9 at D = 256.
//
// fp32, flash_f32_kernel: exact fp32 on the CUDA cores (TF32 would break the
// fp32 tolerances the serve parity gates hold). One block per (64-row q
// tile, head, batch) walks 32-key tiles staged in shared memory as fp32;
// lane j scores key j, the accumulator adds p·V with p broadcast by
// shuffles; expf is the accurate one.
//
// The bf16 prefill and the fp32 kernel also write, when asked (lse not
// null), each row's logsumexp of its scaled scores in natural-log units,
// fp32, (B, H, Sq) contiguous: m·ln 2 + ln l from the prefill kernel's log2
// units, m + ln l from the fp32 one, -inf for a row that sees no key. The
// backward reads it. The decode kernel refuses lse: training never decodes.
//
// Backward (flash_attention_bwd), replacing the reference's XLA-level
// recompute backward src/repro/models/layers.py:_cattn_bwd (the Pallas kernel
// has no backward): with scale = 1/sqrt(D), p = exp(s·scale - lse)
// recomputed from q, k and lse, delta = Σ_d dO∘O,
//
//     dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP - delta)·scale,
//     dQ = dS·K,   dK = dSᵀ·Q,
//
// with dK and dV summed over the H/KV query heads of each KV head. Bound at
// the train path's shape (B 8, H 16, KV 2, S 512, D 128, bf16, causal): q, o,
// dO and dq (16.8 MB each), k, v, dk, dv (2.1 MB each), lse and delta: 76.0
// MB, 22.7 us at 3.35 TB/s, against 2.5 × 8.59 GFLOP of products, 21.7 us
// at the bf16 tensor rate. So the products must run at Hopper's warpgroup
// rate and the work must cover all 132 SMs. Two kernels a call, in this
// order: a dq kernel, then a dk/dv kernel. Both skip tiles a mask hides
// entirely; a row that sees no key (lse = -inf) has p = 0 and so zero
// gradients. No float atomics: two runs give the same bits.
//   bf16, flash_bwd_dq_wg_kernel / flash_bwd_dkdv_wg_kernel (replacing an
//     mma.sync design whose dk/dv kernel had one block per 64-key tile, 128
//     blocks at the train shape with the first key tile's block walking
//     every q tile of the group, and recomputed S and dP on both of its warp
//     groups at D = 256). Every product is wgmma (bf16 in, fp32
//     accumulators) on the swizzled Tiles of the forward: S = Q·Kᵀ, dP =
//     dO·Vᵀ, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with both operands from shared memory
//     (as the forward's S); dQ += dS·K, dV += Pᵀ·dO and dK += dSᵀ·Q with the
//     bf16-rounded dS, Pᵀ or dSᵀ in registers, straight from the previous
//     product's fragment, and the other operand read transposed from shared
//     memory (as the forward's P·V). Tiles move by cp.async, 16 bytes a
//     thread, into two-stage rings, one tile in flight under the current
//     one (cp.async and not TMA: the copies write the swizzled layout
//     themselves, with no tensor map to build on the host for each call).
//     The elementwise work between the products is the part that bounds a
//     step (PERF.md): a tile or step whose rows all see all of its keys
//     takes the bare exp2; at an edge, each row (dq) or key (dk/dv) tests
//     its visible range, found once per block.
//     The dq kernel: one warpgroup per (64-row q tile, head, batch), the
//     longest rows first, two blocks an SM (one at D = 256); K/V tiles of
//     64 keys (32 at D = 256, where dQ alone is 128 registers a thread);
//     delta = Σ dO∘O in its prologue, written for the dk/dv kernel.
//     The dk/dv kernel: a block of two warpgroups per (pair of 64-key tiles,
//     KV head, batch, chunk of the group's query heads). Tile kt is paired
//     with tile n-1-kt, so that under a causal mask every block carries the
//     same work. Group 0 forms Sᵀ, Pᵀ and dV, group 1 dPᵀ, dSᵀ and dK, Pᵀ
//     handed over in fp32 through shared memory: no product is computed
//     twice, and a thread holds one 64 × D accumulator (one warpgroup with
//     both took 255 registers and spilled at D = 128). The chunks of a pair
//     form one cluster, as many as the card holds at once
//     (flash_attention.py's bwd_chunks, from flash_bwd_capacity); each
//     block pushes its fp32 partial dK and dV rows into the shared memory of
//     the block that owns them, which adds the copies in rank order.
//     Each is built with and without the prefix rule.
//   fp32, flash_bwd_dq_kernel / flash_bwd_dkdv_kernel: exact fp32 on the
//     CUDA cores (32-row and 32-key tiles staged in shared memory, each
//     thread a 2×2 block of S and dP and two rows of its accumulators), for
//     the card-against-CPU gates. The dq kernel computes and writes delta;
//     the dk/dv kernel has one block per (32-key tile, KV head, batch),
//     looping over the group's query heads.
//
// No --use_fast_math anywhere.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, s;                 // in elements; the D axis has stride 1
};

// whether the query at position qp sees the key at position kp (< Sk): the
// causal and window rule, or (PFX) kp inside the prefix. The bf16 kernels
// are built twice, with PFX for calls with a prefix and without it, so
// that a call with none runs no prefix test; the flags are tested in
// branches on kernel arguments and the prefix joins by a bitwise or (a
// short-circuit form made the D = 128 backward 20% slower, PERF.md).
template <bool PFX = true>
__device__ __forceinline__ bool sees(int qp, int kp, int causal, int window, int prefix) {
  bool ok = true;
  if (causal) ok = kp <= qp;
  if (window) ok = ok && qp - kp < window;
  if constexpr (PFX) ok = ok | (kp < prefix);
  return ok;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// 8 bf16 -> 8 floats
__device__ __forceinline__ void widen8(const uint4& raw, float* f) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(e[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ---------------------------------------------------------------------------
// async copies, shared-memory tiles and warpgroup products
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread (cp.async's included) made visible to
// the tensor cores' reads, which go through the async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A bf16 tile of R rows by D columns in shared memory, in the layout the
// warpgroup products read with a swizzle: columns in blocks of W (64 at
// D >= 64, 128-byte rows; 32 at D = 32, 64-byte rows), each block R rows of W,
// and the 16-byte chunk c of row r stored at c ^ (r % 8) (128-byte swizzle)
// or c ^ ((r / 2) % 4) (64-byte swizzle). Element offset of chunk c (8
// columns) of row r:
template <int D>
struct Tile {
  static constexpr int W = D >= 64 ? 64 : 32;
  static constexpr int SWIZZLE = D >= 64 ? 1 : 2;   // the descriptor's mode: 128 B, 64 B
  static constexpr int SBO = 8 * W * 2;             // bytes from 8 rows to the next 8
  template <int R>
  __device__ static __forceinline__ int off(int r, int c) {
    const int blk = c / (W / 8), cc = c % (W / 8);
    const int sw = D >= 64 ? cc ^ (r & 7) : cc ^ ((r >> 1) & 3);
    return blk * R * W + r * W + sw * 8;
  }
};

// the warpgroup products' shared-memory matrix descriptor
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo, int swizzle) {
  const uint64_t a = (unsigned)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>                     // until at most N committed groups run
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an asynchronous product reads or writes, pinned at this point:
// the compiler may neither move their uses above a wait nor reuse them for
// other values while the product runs.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// The products' operand lists are written out: PTX takes no register
// arrays.
// d (64 x 64 fp32, the accumulator fragment) (+)= A·B, A (64 x 16) and B
// (16 x 64, K-major) from shared-memory descriptors; d's old value is
// ignored unless `accumulate`.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 32 fp32) += A·B, A (64 x 16 bf16) from registers in the
// accumulator's row layout, B (16 x 32, N-major) from a shared-memory
// descriptor, read transposed.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 64 fp32) += A·B, A (64 x 16 bf16) from registers in the
// accumulator's row layout, B (16 x 64, N-major) from a shared-memory
// descriptor, read transposed.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 128 fp32) += A·B, A (64 x 16 bf16) from registers in the
// accumulator's row layout, B (16 x 128, N-major) from a shared-memory
// descriptor, read transposed.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x D fp32) += A·B for D <= 128, B from the descriptor db; at D = 256
// two m64n128k16 products, the second on B's columns 128.. (db_hi): the
// accumulator fragment of columns 128 + c is entry 64 + i where that of
// column c is entry i, so the halves of d are the two products' fragments.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db, uint64_t db_hi) {
  if constexpr (D == 256) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, db);
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a, db_hi);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n32(d, a, db);
  }
}

// ROWS rows of a D-wide bf16 operand (row i at src + i·stride) into a Tile
// by cp.async; rows at or past `valid` become zeros.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int valid) {
  constexpr int CPR = D / 8;
  static_assert(ROWS * CPR % THREADS == 0, "tile chunks must split evenly");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < valid;
    cp_async16(dst + Tile<D>::template off<ROWS>(r, c),
               src + (ok ? (int64_t)r * stride + c * 8 : 0), ok);
  }
}

// ---------------------------------------------------------------------------
// bf16 prefill: warpgroup products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;            // query rows per block: one warpgroup
constexpr int TC_BK = 64;            // keys per K/V tile
constexpr int TC_THREADS = 128;

template <int D>
constexpr int tc_smem_bytes() {      // q tile, 2 K and 2 V tiles, 1 KB to align
  return (TC_BQ + 4 * TC_BK) * D * (int)sizeof(bf16) + 1024;
}

template <int D, bool PFX>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, Strides qs, Strides ks,
                Strides vs, Strides os, int rep, int sq, int sk, int causal, int window,
                int prefix, float scale_log2, float* __restrict__ lse) {
  using T = Tile<D>;
  constexpr int W = T::W, CPR = D / 8;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on such a boundary
  bf16* q_s = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023));
  bf16* k_s = q_s + TC_BQ * D;       // 2 stages of (TC_BK, D)
  bf16* v_s = k_s + 2 * TC_BK * D;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;   // the longest rows first
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + (h / rep) * ks.h;
  const bf16* vb = v + b * vs.b + (h / rep) * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  // the key tiles any row of this block can see (with a prefix, from the
  // first: the tiles between the prefix and a window are masked in full)
  const int off = sk - sq;
  const int last = min(q0 + TC_BQ, sq) - 1;
  int k_end = causal ? min(sk, last + off + 1) : sk;
  int k_beg = window ? max(0, q0 + off - window + 1) : 0;
  if constexpr (PFX) {
    k_end = max(k_end, min(prefix, sk));
    k_beg = 0;
  }
  const int t_beg = k_beg / TC_BK;
  const int t_end = k_end > 0 ? (k_end + TC_BK - 1) / TC_BK : 0;

  auto load_k = [&](int t) {         // K tile t into stage t % 2, by cp.async
    const int t0 = t * TC_BK;
    load_tile<D, TC_BK, TC_THREADS>(k_s + (t & 1) * TC_BK * D, kb + (int64_t)t0 * ks.s, ks.s,
                                    sk - t0);
  };
  auto load_v = [&](int t) {
    const int t0 = t * TC_BK;
    load_tile<D, TC_BK, TC_THREADS>(v_s + (t & 1) * TC_BK * D, vb + (int64_t)t0 * vs.s, vs.s,
                                    sk - t0);
  };
  // copy groups, in order: {q, K, V of the first tile}, {K of the second},
  // {V of the second}, then per tile t a group {K of t+1} and a group {V of
  // t+1} (empty past the last tile), so a fixed wait count finds each
  load_tile<D, TC_BQ, TC_THREADS>(q_s, qb + (int64_t)q0 * qs.s, qs.s, sq - q0);
  if (t_beg < t_end) {
    load_k(t_beg);
    load_v(t_beg);
  }
  cp_async_commit();
  if (t_beg + 1 < t_end) load_k(t_beg + 1);
  cp_async_commit();
  if (t_beg + 1 < t_end) load_v(t_beg + 1);
  cp_async_commit();

  float acc[D / 2];                  // O: the 64 x D accumulator fragment
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float s[TC_BK / 2];                // S: s[4n + e] holds key 8n + 2·tig + (e & 1)
                                     // of row g + 8·(e >> 1) of the warp's 16
  uint32_t pa[TC_BK / 16][4];        // P in bf16: S's fragment is the A operand's
                                     // register layout, 16 keys a product
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
  const int qp0 = q0 + warp * 16 + g + off;        // row g's position; row g+8 is 8 on

  auto qk_async = [&](int t) {        // S = Q·K_tᵀ (64 x 64), asynchronous
#pragma unroll
    for (int i = 0; i < TC_BK / 2; ++i) s[i] = 0.0f;
    const bf16* kt = k_s + (t & 1) * TC_BK * D;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const int col = (16 * kd / W) * W, within = (16 * kd) % W;
      wgmma_ss_n64(s, smem_desc(q_s + col * TC_BQ + within, 16, T::SBO, T::SWIZZLE),
                      smem_desc(kt + col * TC_BK + within, 16, T::SBO, T::SWIZZLE), kd > 0);
    }
    wgmma_commit();
  };
  auto pv_async = [&](int t) {       // O += P·V_t, asynchronous
    const bf16* vt = v_s + (t & 1) * TC_BK * D;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk], smem_desc(vt + 16 * kk * W, TC_BK * W * 2, T::SBO, T::SWIZZLE),
                  smem_desc(vt + 16 * kk * W + 2 * TC_BK * W, TC_BK * W * 2, T::SBO, T::SWIZZLE));
    wgmma_commit();
  };
  // S of tile t -> p = exp2(s·scale - m) in s, the new m and l, and alpha,
  // the factor the accumulator must take before this tile's P·V is added
  auto softmax = [&](int t) {
    const int t0 = t * TC_BK;
    const bool edge = t0 + TC_BK > sk ||
                      (!(PFX && t0 + TC_BK <= prefix) &&
                       ((causal && t0 + TC_BK - 1 > q0 + off) ||
                        (window && q0 + TC_BQ - 1 + off - t0 >= window)));
    if (edge) {
#pragma unroll
      for (int i = 0; i < TC_BK / 2; ++i) {
        const int kp = t0 + (i >> 2) * 8 + 2 * tig + (i & 1);
        const int qp = qp0 + ((i >> 1) & 1) * 8;
        if (!(kp < sk && sees<PFX>(qp, kp, causal, window, prefix))) s[i] = -INFINITY;
      }
    }
    // rows g (r = 0) and g+8 (r = 1); a row's 64 scores lie in its quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < TC_BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;   // no -inf - -inf
      alpha[r] = exp2f(m[r] - m_use);
      m[r] = m_new;
      l[r] *= alpha[r];
#pragma unroll
      for (int n = 0; n < TC_BK / 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2f(fmaf(s[4 * n + e], scale_log2, -m_use));
          s[4 * n + e] = p;
          l[r] += p;
        }
    }
  };
  auto rescale_pack = [&]() {        // acc *= alpha; P = bf16(p)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };

  // Software pipeline: while the softmax of tile t runs on the CUDA cores,
  // the tensor cores add tile t-1's P·V. K of tile t+1 is copied under tile
  // t, V of tile t+1 once tile t-1's P·V has left its stage.
  if (t_beg < t_end) {
    cp_async_wait<2>();              // q and the first tile
    fence_async_shared();
    __syncthreads();
    wgmma_fence();
    qk_async(t_beg);
    wgmma_wait<0>();
    reg_fence(s);
    softmax(t_beg);
    rescale_pack();
  }
  for (int t = t_beg + 1; t < t_end; ++t) {
    cp_async_wait<1>();              // K of t and V of t-1 (V of t may still fly)
    fence_async_shared();
    __syncthreads();                 // ... for every thread; K of t-1 is consumed
    if (t + 1 < t_end) load_k(t + 1);
    cp_async_commit();
    wgmma_fence();
    qk_async(t);
    pv_async(t - 1);
    wgmma_wait<1>();                 // S of t is in; P·V of t-1 may still run
    reg_fence(s);
    softmax(t);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    rescale_pack();
    __syncthreads();                 // every warp's P·V of t-1 has left V's stage
    if (t + 1 < t_end) load_v(t + 1);
    cp_async_commit();
  }
  if (t_beg < t_end) {               // the last tile's P·V
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    wgmma_fence();
    pv_async(t_end - 1);
    wgmma_wait<0>();
    reg_fence(acc);
  }

  cp_async_wait<0>();                // the q tile's copies, when no key tile ran
  __syncthreads();

  // O / l through the q tile in shared memory (no longer read), then out as
  // 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(FULL, lr, 1);
    lr += __shfl_xor_sync(FULL, lr, 2);
    inv[r] = lr > 0.0f ? 1.0f / lr : 0.0f;         // fully masked row -> 0
    const int row = q0 + warp * 16 + g + 8 * r;
    if (lse != nullptr && tig == 0 && row < sq)
      lse[(b * gridDim.y + h) * sq + row] = lr > 0.0f ? m[r] * LN2 + logf(lr) : -INFINITY;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          q_s + T::template off<TC_BQ>(warp * 16 + g + 8 * r, n) + 2 * tig) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv[r], acc[4 * n + 2 * r + 1] * inv[r]);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < CPR / 2; ++n) {    // the warp's 16 rows of CPR chunks
    const int i = lane + 32 * n, r = warp * 16 + i / CPR, c = i % CPR;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(ob + (int64_t)(q0 + r) * os.s + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + T::template off<TC_BQ>(r, c));
  }
}

// ---------------------------------------------------------------------------
// bf16 decode: GQA-packed, split over keys, merged within a cluster
// ---------------------------------------------------------------------------

constexpr int SPLIT_BK = 64;         // keys per tile of a split
constexpr int SPLIT_THREADS = 256;   // 8 warps
constexpr int SPLIT_ROWS = 16;       // at most rep·Sq query rows per group: one mma M
constexpr int SPLIT_MAX = 16;        // key splits at most: the largest cluster

// d (16 x 8 fp32) += a (16 x 16 bf16, row-major fragment) · b (16 x 8 bf16,
// column-major fragment): lane (g = lane / 4, t = lane % 4) holds a's rows g
// and g + 8 at columns 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2],
// a[3]); b's rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) at column g; d's
// rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t, 2t + 1
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {   // two adjacent bf16
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ld_two(const bf16* lo, const bf16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

// cluster barrier halves: arrive (release: this thread's writes, shared
// memory of other blocks included, are visible to whoever waits after it;
// relaxed: no ordering) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A split block's dynamic shared memory, in bytes: the q rows, the K and V
// tiles (row pitch D + 8), the scaled scores, P in bf16, then the merge
// buffer: every split's unnormalised O for the group's rows (of which the
// block receives only the 4-column chunks it merges), then every split's
// (m, l) per row. Every part starts on a 16-byte boundary.
template <int D>
struct SplitSmem {
  static constexpr int P = D + 8, PP = SPLIT_BK + 8;
  static constexpr int K = SPLIT_ROWS * P * (int)sizeof(bf16);
  static constexpr int V = K + SPLIT_BK * P * (int)sizeof(bf16);
  static constexpr int S = V + SPLIT_BK * P * (int)sizeof(bf16);
  static constexpr int PS = S + SPLIT_ROWS * (SPLIT_BK + 1) * (int)sizeof(float);
  static constexpr int MERGE = PS + SPLIT_ROWS * PP * (int)sizeof(bf16);
  static_assert(S % 16 == 0 && PS % 16 == 0 && MERGE % 16 == 0, "16-byte parts");
  static constexpr int bytes(int splits, int rows) {
    return MERGE + splits * rows * (D + 2) * (int)sizeof(float);
  }
};
constexpr int SMEM_OPT_IN_MAX = 232448;   // a block's shared memory on an H100: 227 KB

// The most key splits whose tiles and merge buffer (for SPLIT_ROWS rows) fit
// a block's shared memory beside the kernel's static arrays and 1 KB to
// spare: 16 up to D = 128, 9 at D = 256.
template <int D>
constexpr int split_cap() {
  int n = SPLIT_MAX;
  while (n > 1 && SplitSmem<D>::bytes(n, SPLIT_ROWS) > SMEM_OPT_IN_MAX - 1024) --n;
  return n;
}
static_assert(split_cap<128>() == SPLIT_MAX && split_cap<256>() == 9,
              "the caps flash_attention.py's decode_splits assumes");

// One block per (key split, KV head, batch); the splits of a (batch, KV head)
// form one cluster of `splits` blocks along x.
template <int D, bool PFX>
__global__ void __launch_bounds__(SPLIT_THREADS)
flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, Strides qs, Strides ks,
                   Strides vs, Strides os, int rep, int sq, int sk, int causal, int window,
                   int prefix, float scale_log2, int chunk) {
  constexpr int THREADS = SPLIT_THREADS, R = SPLIT_ROWS, BK = SPLIT_BK;
  constexpr int CPR = D / 8, P = D + 8;        // 16-byte chunks a row; q, K, V row pitch
  constexpr int PP = BK + 8;                   // P's row pitch
  constexpr int NT = (D / 8 + 7) / 8;          // P·V's 8-column tiles a warp
  constexpr int C4 = D / 4;                    // 4-column chunks of an output row
  static_assert(BK == 8 * (THREADS / 32), "a warp scores 8 keys of a tile");
  static_assert(BK * CPR % THREADS == 0, "whole K/V tiles a thread");
  static_assert(R * D * sizeof(float) <= BK * P * sizeof(bf16), "the partial fits in k_s");
  using SM = SplitSmem<D>;
  extern __shared__ __align__(16) unsigned char split_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(split_smem);
  bf16* k_s = reinterpret_cast<bf16*>(split_smem + SM::K);   // after the walk: the partial
  bf16* v_s = reinterpret_cast<bf16*>(split_smem + SM::V);
  auto s_s = reinterpret_cast<float(*)[BK + 1]>(split_smem + SM::S);   // scaled scores
  bf16* p_s = reinterpret_cast<bf16*>(split_smem + SM::PS);  // P in bf16, the A operand of P·V
  float* merge_s = reinterpret_cast<float*>(split_smem + SM::MERGE);
  __shared__ float m_s[R], l_s[R], a_s[R];

  // every block of the cluster is running before any writes to another
  // block's shared memory: arrive here, wait just before those writes
  cluster_arrive_relaxed();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, splits = gridDim.x;
  const int grp = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int rows = rep * sq, off = sk - sq;
  const bf16* kb = k + b * ks.b + grp * ks.h;
  const bf16* vb = v + b * vs.b + grp * vs.h;
  // query row r of the group: head grp·rep + r / sq, position r % sq
  auto q_row = [&](int r) { return q + b * qs.b + (grp * rep + r / sq) * qs.h + (r % sq) * qs.s; };
  auto o_row = [&](int r) { return o + b * os.b + (grp * rep + r / sq) * os.h + (r % sq) * os.s; };

  // this split's keys, cut to those some row can see (possibly none)
  const int k_lo = window && !PFX ? max(0, off - window + 1) : 0;
  const int k_first = max(split * chunk, k_lo), k_stop = min((split + 1) * chunk, sk);
  // keys t0.. of the split by cp.async, zeros past it: K, then V, one group each
  auto load = [&](bf16* dst, const bf16* src, long long stride, int t0) {
    const int n = min(BK, k_stop - t0);
#pragma unroll
    for (int it = 0; it < BK * CPR / THREADS; ++it) {
      const int i = tid + it * THREADS, r = i / CPR, c = i % CPR;
      const bool ok = r < n;
      cp_async16(dst + r * P + c * 8, src + (ok ? (int64_t)(t0 + r) * stride + c * 8 : 0), ok);
    }
    cp_async_commit();
  };
  // the group's q rows (zeros past them) first, then K and V behind them
  constexpr int QN = (R * CPR + THREADS - 1) / THREADS;
  uint4 qraw[QN];
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int i = tid + n * THREADS, r = i / CPR;
    qraw[n] = i < R * CPR && r < rows ? *reinterpret_cast<const uint4*>(q_row(r) + (i % CPR) * 8)
                                      : make_uint4(0, 0, 0, 0);
  }
  if (k_first < k_stop) {
    load(k_s, kb, ks.s, k_first);
    load(v_s, vb, vs.s, k_first);
  }
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int i = tid + n * THREADS;
    if (i < R * CPR) *reinterpret_cast<uint4*>(q_s + (i / CPR) * P + (i % CPR) * 8) = qraw[n];
  }
  if (tid < R) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];            // q as the A operand of S = Q·Kᵀ, for every tile
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld_pair(q_s + g * P + kk * 16 + 2 * t);
    qa[kk][1] = ld_pair(q_s + (g + 8) * P + kk * 16 + 2 * t);
    qa[kk][2] = ld_pair(q_s + g * P + kk * 16 + 2 * t + 8);
    qa[kk][3] = ld_pair(q_s + (g + 8) * P + kk * 16 + 2 * t + 8);
  }

  // positions of this thread's score rows g and g + 8 (-1: past the group's rows)
  const int qp0 = g < rows ? g % sq + off : -1, qp1 = g + 8 < rows ? (g + 8) % sq + off : -1;
  float acc[NT][4];                  // O, rows g and g + 8 of the warp's column tiles
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  for (int t0 = k_first; t0 < k_stop; t0 += BK) {
    const int n = min(BK, k_stop - t0);
    cp_async_wait<1>();
    __syncthreads();                 // K is in (V may still be arriving)

    {  // S = Q·Kᵀ: warp w takes keys 8w .. 8w + 7 of the tile
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const bf16* kr = k_s + (warp * 8 + g) * P + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_16816(s, qa[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), j = warp * 8 + 2 * t + (e & 1);
        const int kp = t0 + j, qp = e < 2 ? qp0 : qp1;
        const bool ok = j < n && qp >= 0 && sees<PFX>(qp, kp, causal, window, prefix);
        s_s[r][j] = ok ? s[e] * scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    // per row (warp w takes rows w and w + 8): the running max, P, the sum
#pragma unroll
    for (int r = warp; r < R; r += THREADS / 32) {
      const float x0 = s_s[r][lane], x1 = s_s[r][lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float p0 = exp2f(x0 - m_use), p1 = exp2f(x1 - m_use);
      p_s[r * PP + lane] = __float2bfloat16_rn(p0);
      p_s[r * PP + lane + 32] = __float2bfloat16_rn(p1);
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    cp_async_wait<0>();
    __syncthreads();                 // V and P are in

    // O = alpha·O + P·V: warp w takes the 8-column tiles w, w + 8, ...
    {
      const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] *= al0;
        acc[nt][1] *= al0;
        acc[nt][2] *= al1;
        acc[nt][3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (kk * 16 >= n) break;     // keys past the tile's: P and V are 0
        uint32_t pa[4];
        pa[0] = ld_pair(p_s + g * PP + kk * 16 + 2 * t);
        pa[1] = ld_pair(p_s + (g + 8) * PP + kk * 16 + 2 * t);
        pa[2] = ld_pair(p_s + g * PP + kk * 16 + 2 * t + 8);
        pa[3] = ld_pair(p_s + (g + 8) * PP + kk * 16 + 2 * t + 8);
        const bf16* vr = v_s + (kk * 16 + 2 * t) * P + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = (warp + 8 * nt) * 8;
          if (col < D)
            mma_16816(acc[nt], pa, ld_two(vr + col, vr + P + col),
                      ld_two(vr + 8 * P + col, vr + 9 * P + col));
        }
      }
    }
    __syncthreads();                 // k_s, v_s, s_s and p_s are consumed
    if (t0 + BK < k_stop) {
      load(k_s, kb, ks.s, t0 + BK);
      load(v_s, vb, vs.s, t0 + BK);
    }
  }

  // This split's partial, O unnormalised, into k_s (free now); then
  // scattered: 4-column chunk c of every row to block c % splits, which
  // merges that chunk, and (m, l) of every row to every block. Then each
  // block merges its chunks from its own shared memory.
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(k_s);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = (warp + 8 * nt) * 8 + 2 * t;
    if (col < D) {
      *reinterpret_cast<float2*>(o_s + g * D + col) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o_s + (g + 8) * D + col) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  float2* ml_s = reinterpret_cast<float2*>(merge_s + splits * rows * D);
  cluster_wait();
  for (int i = tid; i < rows * C4; i += THREADS) {
    const int r = i / C4, c = i % C4;
    float* to = cluster.map_shared_rank(merge_s, c % splits);
    *reinterpret_cast<float4*>(to + (split * rows + r) * D + c * 4) =
        *reinterpret_cast<const float4*>(o_s + r * D + c * 4);
  }
  if (tid < rows * splits)
    cluster.map_shared_rank(ml_s, tid / rows)[split * rows + tid % rows] =
        make_float2(m_s[tid % rows], l_s[tid % rows]);
  cluster_arrive_release();
  cluster_wait();                    // every partial this block merges is in

  // each (row, chunk) of this block: weights exp2(m_s - M) over the splits'
  // maxima M, an empty split (m = -inf) weighing 0, normalised by Σ
  // exp2(m_s - M)·l_s; a row no split sees (every l = 0) gives 0
  const int mine = (C4 - split + splits - 1) / splits;   // chunks split, split + splits, ...
  for (int i = tid; i < rows * mine; i += THREADS) {
    const int r = i / mine, c = split + (i % mine) * splits;
    float2 ml[SPLIT_MAX];
    float4 a[SPLIT_MAX];
#pragma unroll
    for (int sp = 0; sp < SPLIT_MAX; ++sp) {
      const bool in = sp < splits;
      ml[sp] = in ? ml_s[sp * rows + r] : make_float2(-INFINITY, 0.0f);
      a[sp] = in ? *reinterpret_cast<const float4*>(merge_s + (sp * rows + r) * D + c * 4)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int sp = 0; sp < SPLIT_MAX; ++sp) mx = fmaxf(mx, ml[sp].x);
    float lsum = 0.0f, f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int sp = 0; sp < SPLIT_MAX; ++sp) {
      const float w = ml[sp].x == -INFINITY ? 0.0f : exp2f(ml[sp].x - mx);
      lsum += w * ml[sp].y;
      f[0] += w * a[sp].x;
      f[1] += w * a[sp].y;
      f[2] += w * a[sp].z;
      f[3] += w * a[sp].w;
    }
    const float inv = lsum > 0.0f ? 1.0f / lsum : 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] *= inv;
    uint2 out;
    *reinterpret_cast<__nv_bfloat162*>(&out.x) = __floats2bfloat162_rn(f[0], f[1]);
    *reinterpret_cast<__nv_bfloat162*>(&out.y) = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(o_row(r) + c * 4) = out;
  }
}

// ---------------------------------------------------------------------------
// fp32: exact, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_BK = 32;           // keys per tile: one per lane
constexpr float F32_NEG_INF = -1e30f;   // the TPU kernel's mask value

template <int D, int R, int W>
constexpr int f32_smem_bytes() {
  return (W * R * D + F32_BK * (D + 1) + F32_BK * D) * (int)sizeof(float);
}

// Stage NROWS rows of D floats (row i at src + i·stride, 16-byte aligned)
// into dst (row i at dst + i·dst_stride); rows at or past `valid` read as
// zeros. Every thread loads its vectors before storing any.
template <int D, int THREADS, int NROWS>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, long long stride,
                                          int valid, float* dst, int dst_stride) {
  constexpr int PER_ROW = D / 4;
  constexpr int TOTAL = NROWS * PER_ROW;
  constexpr int PER_THREAD = (TOTAL + THREADS - 1) / THREADS;
  float4 raw[PER_THREAD];
#pragma unroll
  for (int n = 0; n < PER_THREAD; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int row = i / PER_ROW, col = (i % PER_ROW) * 4;
    raw[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < TOTAL && row < valid)
      raw[n] = *reinterpret_cast<const float4*>(src + (int64_t)row * stride + col);
  }
#pragma unroll
  for (int n = 0; n < PER_THREAD; ++n) {
    const int i = threadIdx.x + n * THREADS;
    if (i < TOTAL) {
      float* d = dst + (i / PER_ROW) * dst_stride + (i % PER_ROW) * 4;
      d[0] = raw[n].x;
      d[1] = raw[n].y;
      d[2] = raw[n].z;
      d[3] = raw[n].w;
    }
  }
}

template <int D, int R, int W>
__global__ void __launch_bounds__(W * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int rep, int sq, int sk,
                 int causal, int window, int prefix, float scale, float* __restrict__ lse) {
  extern __shared__ __align__(16) float smem[];
  constexpr int bq = W * R;
  float* q_s = smem;                     // (bq, D)
  float* k_s = q_s + bq * D;             // (F32_BK, D + 1)
  float* v_s = k_s + F32_BK * (D + 1);   // (F32_BK, D)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int q0 = blockIdx.x * bq;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / rep) * ks.h;
  const float* vb = v + b * vs.b + (h / rep) * vs.h;
  float* ob = o + b * os.b + h * os.h;

  stage_f32<D, W * 32, bq>(qb + (int64_t)q0 * qs.s, qs.s, sq - q0, q_s, D);

  // the keys any row of this block can see
  const int off = sk - sq;
  const int last = min(q0 + bq, sq) - 1;
  const int k_end = max(causal ? min(sk, last + off + 1) : sk, min(prefix, sk));
  const int k_beg = window && prefix <= 0 ? max(0, q0 + off - window + 1) : 0;

  float m[R], l[R], acc[R][D / 32];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = F32_NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[r][i] = 0.0f;
  }
  const float* qw = q_s + warp * R * D;
  const bool active = q0 + warp * R < sq;

  for (int t0 = (k_beg / F32_BK) * F32_BK; t0 < k_end; t0 += F32_BK) {
    __syncthreads();                     // the previous tile is consumed
    stage_f32<D, W * 32, F32_BK>(kb + (int64_t)t0 * ks.s, ks.s, sk - t0, k_s, D + 1);
    stage_f32<D, W * 32, F32_BK>(vb + (int64_t)t0 * vs.s, vs.s, sk - t0, v_s, D);
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
      const bool ok = kp < sk && sees(qp, kp, causal, window, prefix);
      const float sc = ok ? s[r] * scale : F32_NEG_INF;
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
    for (int j = 0; j < F32_BK; ++j) {
      float vj[D / 32];
#pragma unroll
      for (int i = 0; i < D / 32; ++i) vj[i] = v_s[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(FULL, s[r], j);
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
      for (int i = 0; i < D / 32; ++i) ob[(int64_t)row * os.s + lane + 32 * i] = acc[r][i] / denom;
      if (lse != nullptr && lane == 0)
        lse[(b * gridDim.y + h) * sq + row] = l[r] > 0.0f ? m[r] + logf(l[r]) : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, fp32: exact, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BWD_BQ = 32;           // query rows per tile
constexpr int BWD_BK = 32;           // keys per tile
constexpr int BWD_THREADS = 256;

// ROWS rows of D floats (row i at src + i·stride, 16-byte aligned) into
// shared memory of row pitch D + 1; rows at or past `valid` are 0
template <int D, int ROWS>
__device__ __forceinline__ void stage_bwd(float* dst, const float* __restrict__ src,
                                          long long stride, int valid) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += BWD_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float* d = dst + r * (D + 1) + c;
    const float4 v = r < valid ? *reinterpret_cast<const float4*>(src + (int64_t)r * stride + c)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

template <int D>
constexpr int bwd_smem_bytes() {     // four (32, D + 1) tiles, two (32, 33) ones
  return (4 * 32 * (D + 1) + 2 * 32 * (BWD_BK + 1)) * (int)sizeof(float);
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  Strides q_st, k_st, v_st, o_st, do_st, dq_st, dk_st, dv_st;
  long long b;
  int h, kvh, rep, sq, sk, causal, window, prefix;
  int chunks;                        // bf16: the dk/dv kernel's head chunks (its cluster)
  float scale;
  cudaStream_t stream;
};

// whether query row i (position i + off) sees key kp
template <bool PFX = true>
__device__ __forceinline__ bool visible(int i, int kp, int sq, int sk, int off, int causal,
                                        int window, int prefix) {
  const bool in = i < sq && kp < sk;
  return in & sees<PFX>(i + off, kp, causal, window, prefix);
}

// The S and dP of rows a_s (q or its rows) against b_s (k), thread t's 2×2
// block: rows 2·(t / 16) + {0, 1}, columns 2·(t % 16) + {0, 1}; then p and
// ds into p_s (optional) and ds_s, pitch BWD_BK + 1, from the rows' lse and
// delta. i0: the q tile's first row; k0: the key tile's first key.
template <int D>
__device__ __forceinline__ void bwd_scores(const float* q_s, const float* do_s, const float* k_s,
                                           const float* v_s, const float* lse_s,
                                           const float* delta_s, float* p_s, float* ds_s,
                                           int i0, int k0, int sq, int sk, int off, int causal,
                                           int window, int prefix, float scale) {
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, dp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  const float* q0 = q_s + (2 * ti) * (D + 1);
  const float* o0 = do_s + (2 * ti) * (D + 1);
  const float* k0r = k_s + (2 * tj) * (D + 1);
  const float* v0r = v_s + (2 * tj) * (D + 1);
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float qa = q0[d], qb = q0[D + 1 + d], ka = k0r[d], kb = k0r[D + 1 + d];
    const float oa = o0[d], ob = o0[D + 1 + d], va = v0r[d], vb = v0r[D + 1 + d];
    s[0][0] += qa * ka;
    s[0][1] += qa * kb;
    s[1][0] += qb * ka;
    s[1][1] += qb * kb;
    dp[0][0] += oa * va;
    dp[0][1] += oa * vb;
    dp[1][0] += ob * va;
    dp[1][1] += ob * vb;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = 2 * ti + a;
    const float l = lse_s[r];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 2 * tj + c;
      const bool ok =
          l != -INFINITY && visible(i0 + r, k0 + j, sq, sk, off, causal, window, prefix);
      const float p = ok ? expf(s[a][c] * scale - l) : 0.0f;
      if (p_s != nullptr) p_s[r * (BWD_BK + 1) + j] = p;
      ds_s[r * (BWD_BK + 1) + j] = p * (dp[a][c] - delta_s[r]) * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float bwd_smem[];
  constexpr int P = D + 1, PS = BWD_BK + 1, NC = D / 16;
  float* q_s = bwd_smem;
  float* do_s = q_s + BWD_BQ * P;
  float* k_s = do_s + BWD_BQ * P;
  float* v_s = k_s + BWD_BK * P;
  float* ds_s = v_s + BWD_BK * P;
  __shared__ float lse_s[BWD_BQ], delta_s[BWD_BQ];

  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int q0 = blockIdx.x * BWD_BQ, off = a.sk - a.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = (const float*)a.q + b * a.q_st.b + h * a.q_st.h;
  const float* ob = (const float*)a.o + b * a.o_st.b + h * a.o_st.h;
  const float* dob = (const float*)a.dout + b * a.do_st.b + h * a.do_st.h;
  const float* kb = (const float*)a.k + b * a.k_st.b + (h / a.rep) * a.k_st.h;
  const float* vb = (const float*)a.v + b * a.v_st.b + (h / a.rep) * a.v_st.h;
  float* dqb = (float*)a.dq + b * a.dq_st.b + h * a.dq_st.h;
  const int64_t row_base = (b * a.h + h) * a.sq;

  stage_bwd<D, BWD_BQ>(q_s, qb + (int64_t)q0 * a.q_st.s, a.q_st.s, a.sq - q0);
  stage_bwd<D, BWD_BQ>(do_s, dob + (int64_t)q0 * a.do_st.s, a.do_st.s, a.sq - q0);
  // delta = Σ_d dO∘O of each row, a warp a row
  for (int r = warp; r < BWD_BQ; r += BWD_THREADS / 32) {
    const int i = q0 + r;
    float acc = 0.0f;
    if (i < a.sq)
      for (int d = lane; d < D; d += 32)
        acc += dob[(int64_t)i * a.do_st.s + d] * ob[(int64_t)i * a.o_st.s + d];
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = i < a.sq ? a.lse[row_base + i] : -INFINITY;
      if (i < a.sq) a.delta[row_base + i] = acc;
    }
  }

  // the key tiles any row of this block can see
  const int last = min(q0 + BWD_BQ, a.sq) - 1;
  const int k_end = max(a.causal ? min(a.sk, last + off + 1) : a.sk, min(a.prefix, a.sk));
  const int k_beg = a.window && a.prefix <= 0 ? max(0, q0 + off - a.window + 1) : 0;

  const int rg = threadIdx.x / 16, cl = threadIdx.x % 16;   // rows rg, rg + 16
  float acc[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;

  for (int k0 = (k_beg / BWD_BK) * BWD_BK; k0 < k_end; k0 += BWD_BK) {
    __syncthreads();                 // the previous tile is consumed
    stage_bwd<D, BWD_BK>(k_s, kb + (int64_t)k0 * a.k_st.s, a.k_st.s, a.sk - k0);
    stage_bwd<D, BWD_BK>(v_s, vb + (int64_t)k0 * a.v_st.s, a.v_st.s, a.sk - k0);
    __syncthreads();
    bwd_scores<D>(q_s, do_s, k_s, v_s, lse_s, delta_s, nullptr, ds_s, q0, k0, a.sq, a.sk, off,
                  a.causal, a.window, a.prefix, a.scale);
    __syncthreads();
    // dQ += dS·K
#pragma unroll 4
    for (int j = 0; j < BWD_BK; ++j) {
      const float d0 = ds_s[rg * PS + j], d1 = ds_s[(rg + 16) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = k_s[j * P + cl + 16 * c];
        acc[0][c] += d0 * kv;
        acc[1][c] += d1 * kv;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + rg + 16 * r;
    if (i < a.sq)
#pragma unroll
      for (int c = 0; c < NC; ++c) dqb[(int64_t)i * a.dq_st.s + cl + 16 * c] = acc[r][c];
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float bwd_smem[];
  constexpr int P = D + 1, PS = BWD_BK + 1, NC = D / 16;
  float* k_s = bwd_smem;
  float* v_s = k_s + BWD_BK * P;
  float* q_s = v_s + BWD_BK * P;
  float* do_s = q_s + BWD_BQ * P;
  float* p_s = do_s + BWD_BQ * P;
  float* ds_s = p_s + BWD_BQ * PS;
  __shared__ float lse_s[BWD_BQ], delta_s[BWD_BQ];

  const int grp = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int k0 = blockIdx.x * BWD_BK, off = a.sk - a.sq;
  const float* kb = (const float*)a.k + b * a.k_st.b + grp * a.k_st.h;
  const float* vb = (const float*)a.v + b * a.v_st.b + grp * a.v_st.h;
  float* dkb = (float*)a.dk + b * a.dk_st.b + grp * a.dk_st.h;
  float* dvb = (float*)a.dv + b * a.dv_st.b + grp * a.dv_st.h;

  stage_bwd<D, BWD_BK>(k_s, kb + (int64_t)k0 * a.k_st.s, a.k_st.s, a.sk - k0);
  stage_bwd<D, BWD_BK>(v_s, vb + (int64_t)k0 * a.v_st.s, a.v_st.s, a.sk - k0);

  // the query rows that see some key of this tile (all, when it holds a
  // prefix key)
  const int k_last = min(k0 + BWD_BK, a.sk) - 1;
  const bool pre = k0 < a.prefix;
  const int i_beg = a.causal && !pre ? max(0, k0 - off) : 0;
  const int i_end = a.window && !pre ? min(a.sq, k_last + a.window - off) : a.sq;

  const int rg = threadIdx.x / 16, cl = threadIdx.x % 16;   // keys rg, rg + 16
  float dk[2][NC], dv[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.0f;

  for (int hh = grp * a.rep; hh < (grp + 1) * a.rep; ++hh) {
    const float* qb = (const float*)a.q + b * a.q_st.b + hh * a.q_st.h;
    const float* dob = (const float*)a.dout + b * a.do_st.b + hh * a.do_st.h;
    const int64_t row_base = (b * a.h + hh) * a.sq;
    for (int q0 = (i_beg / BWD_BQ) * BWD_BQ; q0 < i_end; q0 += BWD_BQ) {
      __syncthreads();               // the previous q tile is consumed
      stage_bwd<D, BWD_BQ>(q_s, qb + (int64_t)q0 * a.q_st.s, a.q_st.s, a.sq - q0);
      stage_bwd<D, BWD_BQ>(do_s, dob + (int64_t)q0 * a.do_st.s, a.do_st.s, a.sq - q0);
      if (threadIdx.x < BWD_BQ) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < a.sq ? a.lse[row_base + i] : -INFINITY;
        delta_s[threadIdx.x] = i < a.sq ? a.delta[row_base + i] : 0.0f;
      }
      __syncthreads();
      bwd_scores<D>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, q0, k0, a.sq, a.sk, off,
                    a.causal, a.window, a.prefix, a.scale);
      __syncthreads();
      // dV += Pᵀ·dO, dK += dSᵀ·Q
#pragma unroll 4
      for (int i = 0; i < BWD_BQ; ++i) {
        const float p0 = p_s[i * PS + rg], p1 = p_s[i * PS + rg + 16];
        const float s0 = ds_s[i * PS + rg], s1 = ds_s[i * PS + rg + 16];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = do_s[i * P + cl + 16 * c], qv = q_s[i * P + cl + 16 * c];
          dv[0][c] += p0 * ov;
          dv[1][c] += p1 * ov;
          dk[0][c] += s0 * qv;
          dk[1][c] += s1 * qv;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + rg + 16 * r;
    if (j < a.sk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dkb[(int64_t)j * a.dk_st.s + cl + 16 * c] = dk[r][c];
        dvb[(int64_t)j * a.dv_st.s + cl + 16 * c] = dv[r][c];
      }
  }
}

// ---------------------------------------------------------------------------
// backward, bf16: warpgroup products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int WB_ROWS = 64;          // a warpgroup's rows: q rows (dq), keys (dk/dv)
constexpr int WB_THREADS = 128;      // one warpgroup
constexpr int WB_CHUNKS_MAX = 8;     // head chunks of a key tile at most: the portable cluster

// keys a K/V tile of the dq kernel: 32 at D = 256, where dQ alone is 128
// fp32 registers a thread
template <int D>
__host__ __device__ constexpr int wb_dq_keys() { return D > 128 ? 32 : 64; }
// q, dO, 2 stages of K and V, 1 KB to align
template <int D>
__host__ __device__ constexpr int wb_dq_smem() {
  return (2 * WB_ROWS + 4 * wb_dq_keys<D>()) * D * (int)sizeof(bf16) + 1024;
}
// K, V, 2 stages of q and dO, Pᵀ in fp32, 1 KB to align
template <int D>
__host__ __device__ constexpr int wb_dkdv_smem() {
  return 6 * WB_ROWS * D * (int)sizeof(bf16) + WB_ROWS * WB_ROWS * (int)sizeof(float) + 1024;
}
static_assert(wb_dkdv_smem<256>() + 2 * 2 * WB_ROWS * 4 <= SMEM_OPT_IN_MAX,
              "the dk/dv kernel's tiles and lse/delta stages fit a block at D = 256");
// the receive buffers of the dk/dv kernel's partials, chunks copies of
// ceil(2·64 / chunks) rows, fit its ring and Pᵀ buffer at every chunk count
static_assert((2 * WB_ROWS + WB_CHUNKS_MAX) * 32 * 4 <= 4 * WB_ROWS * 32 * 2 + WB_ROWS * WB_ROWS * 4,
              "the receive buffers fit at D = 32");
static_assert((2 * WB_ROWS + WB_CHUNKS_MAX) * 256 * 4 <= 4 * WB_ROWS * 256 * 2 + WB_ROWS * WB_ROWS * 4,
              "the receive buffers fit at D = 256");

// d (64 x 32 fp32) (+)= A·B, both from shared-memory descriptors (K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// c (64 x N fp32) = A·Bᵀ over the depth D: A a Tile of 64 rows, B a Tile of
// N rows, both in shared memory (S = Q·Kᵀ, dP = dO·Vᵀ, Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ)
template <int D, int N>
__device__ __forceinline__ void wg_scores(float (&c)[N / 2], const bf16* a, const bf16* b) {
  using T = Tile<D>;
  constexpr int W = T::W;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int col = (16 * kd / W) * W, within = (16 * kd) % W;
    const uint64_t da = smem_desc(a + col * WB_ROWS + within, 16, T::SBO, T::SWIZZLE);
    const uint64_t db = smem_desc(b + col * N + within, 16, T::SBO, T::SWIZZLE);
    if constexpr (N == 64)
      wgmma_ss_n64(c, da, db, kd > 0);
    else
      wgmma_ss_n32(c, da, db, kd > 0);
  }
}

// acc (64 x D fp32) += A·B: A (64 x K bf16) in registers, K / 16 fragments;
// B a Tile of K rows by D columns in shared memory, the product's depth
// along its rows, read transposed (dQ += dS·K, dV += Pᵀ·dO, dK += dSᵀ·Q)
template <int D, int K>
__device__ __forceinline__ void wg_rows(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                        const bf16* b) {
  using T = Tile<D>;
  constexpr int W = T::W;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D>(acc, a[kk], smem_desc(b + 16 * kk * W, K * W * 2, T::SBO, T::SWIZZLE),
                smem_desc(b + 16 * kk * W + 2 * K * W, K * W * 2, T::SBO, T::SWIZZLE));
}

// a 64 x N accumulator fragment, rounded to bf16, as the A operand of a
// product over its N columns (the fragment is the operand's register layout)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(c[8 * kk + 2 * e], c[8 * kk + 2 * e + 1]);
}

// 4 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// the named barrier 1 of `threads` threads: arrive without waiting, or wait
__device__ __forceinline__ void named_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;\n" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void named_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The dq kernel: one warpgroup per (64-row q tile, head, batch), the longest
// rows first. q and dO sit in shared memory for the block's life; K and V
// tiles of BK keys pass through a two-stage cp.async ring, tile i + 1 in
// flight while tile i is used. Per tile: S = Q·Kᵀ and dP = dO·Vᵀ (wgmma,
// both operands from shared memory), dS = P∘(dP - delta)·scale in the
// accumulator fragments, rounded to bf16 as the A operand of dQ += dS·K
// (wgmma, K read transposed). The prologue computes delta = Σ_d dO∘O of its
// rows and writes it for the dk/dv kernel. dQ goes out through the q tile.
template <int D, bool PFX>
__global__ void __launch_bounds__(WB_THREADS, D > 128 ? 1 : 2)
flash_bwd_dq_wg_kernel(BwdArgs a) {
  using T = Tile<D>;
  constexpr int CPR = D / 8, BK = wb_dq_keys<D>();
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023));
  bf16* do_s = q_s + WB_ROWS * D;
  bf16* k_s = do_s + WB_ROWS * D;    // 2 stages of (BK, D)
  bf16* v_s = k_s + 2 * BK * D;      // 2 stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WB_ROWS, off = a.sk - a.sq;
  const bf16* qb = (const bf16*)a.q + b * a.q_st.b + h * a.q_st.h;
  const bf16* ob = (const bf16*)a.o + b * a.o_st.b + h * a.o_st.h;
  const bf16* dob = (const bf16*)a.dout + b * a.do_st.b + h * a.do_st.h;
  const bf16* kb = (const bf16*)a.k + b * a.k_st.b + (h / a.rep) * a.k_st.h;
  const bf16* vb = (const bf16*)a.v + b * a.v_st.b + (h / a.rep) * a.v_st.h;
  bf16* dqb = (bf16*)a.dq + b * a.dq_st.b + h * a.dq_st.h;
  const int64_t row_base = (b * a.h + h) * a.sq;

  // the key tiles any row of this block can see
  const int last = min(q0 + WB_ROWS, a.sq) - 1;
  int k_end = a.causal ? min(a.sk, last + off + 1) : a.sk;
  if constexpr (PFX) k_end = max(k_end, min(a.prefix, a.sk));
  const int k_first = a.window && !PFX ? (max(0, q0 + off - a.window + 1) / BK) * BK : 0;
  const int tiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;
  auto load_kv = [&](int i) {        // key tile i into stage i % 2
    const int k0 = k_first + i * BK;
    load_tile<D, BK, WB_THREADS>(k_s + (i & 1) * BK * D, kb + (int64_t)k0 * a.k_st.s,
                                 a.k_st.s, a.sk - k0);
    load_tile<D, BK, WB_THREADS>(v_s + (i & 1) * BK * D, vb + (int64_t)k0 * a.v_st.s,
                                 a.v_st.s, a.sk - k0);
  };

  load_tile<D, WB_ROWS, WB_THREADS>(q_s, qb + (int64_t)q0 * a.q_st.s, a.q_st.s, a.sq - q0);
  load_tile<D, WB_ROWS, WB_THREADS>(do_s, dob + (int64_t)q0 * a.do_st.s, a.do_st.s, a.sq - q0);
  if (tiles > 0) load_kv(0);
  cp_async_commit();
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;          // this thread's rows
  const float l0 = r0 < a.sq ? a.lse[row_base + r0] * LOG2E : -INFINITY;
  const float l1 = r1 < a.sq ? a.lse[row_base + r1] * LOG2E : -INFINITY;
  // the keys each of this thread's rows sees: [lo, hi) and those below pf
  // (the prefix); none for a row past Sq
  int lo[2], hi[2], pf[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r, qp = row + off;
    const bool in = row < a.sq;
    lo[r] = a.window ? qp - a.window + 1 : 0;
    hi[r] = !in ? 0 : a.causal ? min(a.sk, qp + 1) : a.sk;
    pf[r] = PFX && in ? min(a.prefix, a.sk) : 0;
  }

  // delta = Σ_d dO∘O of the warp's 16 rows, written for the dk/dv kernel:
  // lanes 2r and 2r + 1 take half of row r each, up to 8 16-byte loads of
  // each in flight at once
  float dl0, dl1;
  {
    constexpr int NV = D / 16, CH = NV < 8 ? NV : 8;
    const int i = q0 + warp * 16 + lane / 2, c0 = (lane & 1) * (D / 2);
    float acc = 0.0f;
    if (i < a.sq) {
      const bf16* orow = ob + (int64_t)i * a.o_st.s + c0;
      const bf16* drow = dob + (int64_t)i * a.do_st.s + c0;
#pragma unroll
      for (int n0 = 0; n0 < NV; n0 += CH) {
        uint4 ov[CH], dv[CH];
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          ov[n] = *reinterpret_cast<const uint4*>(orow + 8 * (n0 + n));
          dv[n] = *reinterpret_cast<const uint4*>(drow + 8 * (n0 + n));
        }
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          float of[8], df[8];
          widen8(ov[n], of);
          widen8(dv[n], df);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc += of[e] * df[e];
        }
      }
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    if ((lane & 1) == 0 && i < a.sq) a.delta[row_base + i] = acc;
    dl0 = __shfl_sync(FULL, acc, 2 * g);
    dl1 = __shfl_sync(FULL, acc, 2 * (g + 8));
  }
  const float scale_log2 = a.scale * LOG2E;

  float dq[D / 2];                   // dQ: the 64 x D accumulator fragment
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  float s[BK / 2], dp[BK / 2];       // S, dP: s[4n + e] holds key 8n + 2·tig + (e & 1)
                                     // of row g + 8·(e >> 1) of the warp's 16
  uint32_t pa[BK / 16][4];           // dS in bf16, the A operand of dS·K

  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) load_kv(i + 1);        // in flight under this tile
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();                 // tile i (and q, dO) are in for every thread
    const int k0 = k_first + i * BK;
    const bf16* kt = k_s + (i & 1) * BK * D;
    const bf16* vt = v_s + (i & 1) * BK * D;
    wgmma_fence();
    wg_scores<D, BK>(s, q_s, kt);
    wg_scores<D, BK>(dp, do_s, vt);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // dS = P∘(dP - delta)·scale, P = exp(S·scale - lse), into s; a tile
    // that every row of the block sees whole takes no element mask
    const bool whole = k0 + BK <= a.sk && q0 + WB_ROWS <= a.sq &&
                       ((PFX && k0 + BK <= a.prefix) ||
                        ((!a.causal || k0 + BK - 1 <= q0 + off) &&
                         (!a.window || q0 + WB_ROWS - 1 + off - k0 < a.window)));
    if (whole) {                     // every row sees every key: lse is finite
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e >> 1) & 1;
        const float p = exp2f(s[e] * scale_log2 - (r ? l1 : l0));
        s[e] = p * (dp[e] - (r ? dl1 : dl0)) * a.scale;
      }
    } else {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e >> 1) & 1, key = k0 + (e >> 2) * 8 + 2 * tig + (e & 1);
        const bool ok = (key >= lo[r] && key < hi[r]) || key < pf[r];
        const float p = ok ? exp2f(s[e] * scale_log2 - (r ? l1 : l0)) : 0.0f;
        s[e] = p * (dp[e] - (r ? dl1 : dl0)) * a.scale;
      }
    }
    pack_a<BK>(pa, s);
    wgmma_fence();
    wg_rows<D, BK>(dq, pa, kt);      // dQ += dS·K
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    reg_fence(pa);
    __syncthreads();                 // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();                // the q tile's copies, when no key tile ran
  __syncthreads();

  // dQ through the q tile in shared memory, then out as 16-byte stores
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          q_s + T::template off<WB_ROWS>(warp * 16 + g + 8 * r, n) + 2 * tig) =
          __floats2bfloat162_rn(dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < CPR / 2; ++n) {    // the warp's 16 rows of CPR chunks
    const int i = lane + 32 * n, r = warp * 16 + i / CPR, c = i % CPR;
    if (q0 + r < a.sq)
      *reinterpret_cast<uint4*>(dqb + (int64_t)(q0 + r) * a.dq_st.s + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + T::template off<WB_ROWS>(r, c));
  }
}

// The dk/dv kernel. A block takes a pair of 64-key tiles, kt and n - 1 - kt
// (under a causal mask the first sees the most q tiles and the last the
// fewest: a pair carries the same work wherever it lies), for one KV head,
// one batch, and one chunk of the KV head's query heads: heads
// rep·chunk/chunks .. rep·(chunk+1)/chunks - 1 of the group. The chunks of a
// pair form one thread-block cluster. For each key tile, K and V sit in
// shared memory and the chunk's (head, 64-row q tile) steps pass through a
// two-stage cp.async ring of q, dO and their rows' lse and delta. Two
// warpgroups share each step: group 0 forms Sᵀ = K·Qᵀ, Pᵀ = exp(Sᵀ·scale -
// lse) and dV += Pᵀ·dO; group 1 forms dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ -
// delta)·scale, with Pᵀ handed over in fp32 through shared memory, and dK
// += dSᵀ·Q. The scores are wgmma from shared memory; Pᵀ and dSᵀ, rounded to
// bf16, are the A operands of the accumulating products (wgmma, dO and q
// read transposed). So no product is computed twice, and a thread holds one
// 64 x D accumulator: dK and dV of 64 keys in one warpgroup took 255
// registers and spilled at D = 128, and would need 256 fp32 registers at
// D = 256. With one chunk dK and dV go out from the fragments; with more,
// each block leaves its fp32 partial in its shared memory and, one cluster
// barrier later, adds a slice of the rows over the cluster's blocks in rank
// order and writes it: no atomics, no scratch in global memory.
template <int D, bool PFX>
__global__ void __launch_bounds__(2 * WB_THREADS, 1)
flash_bwd_dkdv_wg_kernel(BwdArgs a) {
  constexpr int R = WB_ROWS, THREADS = 2 * WB_THREADS;
  extern __shared__ unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023));
  bf16* v_s = k_s + R * D;
  bf16* q_s = v_s + R * D;           // 2 stages of (R, D)
  bf16* do_s = q_s + 2 * R * D;      // 2 stages
  float* p_x = reinterpret_cast<float*>(do_s + 2 * R * D);   // Pᵀ, group 0 to group 1
  float* red = reinterpret_cast<float*>(q_s);   // a key tile's dK then dV rows, fp32
  __shared__ __align__(16) float lse_s[2][R], delta_s[2][R];

  const int grp_w = threadIdx.x / WB_THREADS, gtid = threadIdx.x % WB_THREADS;
  const int lane = gtid & 31, warp = gtid >> 5, g = lane >> 2, tig = lane & 3;
  const int chunks = a.chunks, chunk = blockIdx.x % chunks, pair = blockIdx.x / chunks;
  const int grp = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int off = a.sk - a.sq, n_kt = (a.sk + R - 1) / R;
  const int h_beg = grp * a.rep + chunk * a.rep / chunks;
  const int nh = grp * a.rep + (chunk + 1) * a.rep / chunks - h_beg;
  const bf16* kb = (const bf16*)a.k + b * a.k_st.b + grp * a.k_st.h;
  const bf16* vb = (const bf16*)a.v + b * a.v_st.b + grp * a.v_st.h;
  bf16* dkb = (bf16*)a.dk + b * a.dk_st.b + grp * a.dk_st.h;
  bf16* dvb = (bf16*)a.dv + b * a.dv_st.b + grp * a.dv_st.h;
  const float scale_log2 = a.scale * LOG2E;

  for (int pass = 0; pass < 2; ++pass) {      // the same for every block of a cluster
    const int kt = pass == 0 ? pair : n_kt - 1 - pair;
    if (pass == 1 && kt <= pair) break;
    const int k0 = kt * R;
    // the query rows that see some key of this tile (all, when it holds a
    // prefix key), in tiles of R, for each of the chunk's heads: step `it`
    // is head h_beg + it / n_qt
    const int k_last = min(k0 + R, a.sk) - 1;
    const bool pre = PFX && k0 < a.prefix;
    const int i_beg = a.causal && !pre ? max(0, k0 - off) : 0;
    const int i_end = a.window && !pre ? min(a.sq, k_last + a.window - off) : a.sq;
    const int qt_beg = (i_beg / R) * R;
    const int n_qt = i_end > qt_beg ? (i_end - qt_beg + R - 1) / R : 0;
    const int total = nh * n_qt;

    // step `it` into stage j, with its rows' lse and delta; rows past Sq
    // read as zeros, and no key is visible to them
    auto load_q = [&](int it, int j) {
      const int hh = h_beg + it / n_qt, q0 = qt_beg + (it % n_qt) * R;
      const bf16* qb = (const bf16*)a.q + b * a.q_st.b + hh * a.q_st.h;
      const bf16* dob = (const bf16*)a.dout + b * a.do_st.b + hh * a.do_st.h;
      load_tile<D, R, THREADS>(q_s + j * R * D, qb + (int64_t)q0 * a.q_st.s, a.q_st.s,
                               a.sq - q0);
      load_tile<D, R, THREADS>(do_s + j * R * D, dob + (int64_t)q0 * a.do_st.s, a.do_st.s,
                               a.sq - q0);
      if (threadIdx.x < 2 * R) {
        const int r = threadIdx.x % R, i = q0 + r;
        const int64_t row = (b * a.h + hh) * a.sq + (i < a.sq ? i : 0);
        if (threadIdx.x < R)
          cp_async4(&lse_s[j][r], a.lse + row, i < a.sq);
        else
          cp_async4(&delta_s[j][r], a.delta + row, i < a.sq);
      }
    };
    load_tile<D, R, THREADS>(k_s, kb + (int64_t)k0 * a.k_st.s, a.k_st.s, a.sk - k0);
    load_tile<D, R, THREADS>(v_s, vb + (int64_t)k0 * a.v_st.s, a.v_st.s, a.sk - k0);
    if (total > 0) load_q(0, 0);
    cp_async_commit();

    float acc[D / 2];                // dV (group 0) or dK (group 1) of the tile's 64 keys
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    const int kr0 = k0 + warp * 16 + g;        // this thread's keys kr0, kr0 + 8
    // the q rows each of them is seen by: [lo, hi)
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = kr0 + 8 * r;
      const bool all = PFX && kp < a.prefix;
      lo[r] = a.causal && !all ? kp - off : 0;
      hi[r] = kp >= a.sk ? 0 : a.window && !all ? min(a.sq, kp - off + a.window) : a.sq;
    }

    for (int it = 0, j = 0; it < total; ++it, j ^= 1) {
      if (it + 1 < total) load_q(it + 1, j ^ 1);   // in flight under this one
      cp_async_commit();
      cp_async_wait<1>();
      fence_async_shared();
      __syncthreads();               // step it (and K, V) are in for every thread
      const int q0 = qt_beg + (it % n_qt) * R;
      const bf16* qs = q_s + j * R * D;
      const bf16* dos = do_s + j * R * D;
      // fragment entry e: key kr0 + 8·((e >> 1) & 1), q row q0 + 8·(e >> 2)
      // + 2·tig + (e & 1); a thread's 16 q rows come in pairs
      float sc[R / 2];               // group 0: Sᵀ, then Pᵀ; group 1: dPᵀ, then dSᵀ
      wgmma_fence();
      wg_scores<D, R>(sc, grp_w == 0 ? k_s : v_s, grp_w == 0 ? qs : dos);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      if (grp_w == 0) {
        float2 l2[R / 8];            // the rows' lse in log2 units
#pragma unroll
        for (int n = 0; n < R / 8; ++n) {
          const float2 l = *reinterpret_cast<const float2*>(&lse_s[j][8 * n + 2 * tig]);
          l2[n] = make_float2(l.x * LOG2E, l.y * LOG2E);
        }
        const bool whole = k0 + R <= a.sk && q0 + R <= a.sq &&
                           ((PFX && k0 + R <= a.prefix) ||
                            ((!a.causal || k0 + R - 1 <= q0 + off) &&
                             (!a.window || q0 + R - 1 + off - k0 < a.window)));
        if (whole) {                 // every row sees every key: lse is finite
#pragma unroll
          for (int e = 0; e < R / 2; ++e)
            sc[e] = exp2f(sc[e] * scale_log2 - (e & 1 ? l2[e >> 2].y : l2[e >> 2].x));
        } else {
#pragma unroll
          for (int e = 0; e < R / 2; ++e) {
            const int r = (e >> 1) & 1, q = q0 + 8 * (e >> 2) + 2 * tig + (e & 1);
            sc[e] = q >= lo[r] && q < hi[r]
                        ? exp2f(sc[e] * scale_log2 - (e & 1 ? l2[e >> 2].y : l2[e >> 2].x))
                        : 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < R / 2; ++e) p_x[e * WB_THREADS + gtid] = sc[e];
        named_arrive(THREADS);       // Pᵀ is in for group 1
      } else {
        float2 dl[R / 8];            // the rows' delta
#pragma unroll
        for (int n = 0; n < R / 8; ++n)
          dl[n] = *reinterpret_cast<const float2*>(&delta_s[j][8 * n + 2 * tig]);
        named_sync(THREADS);
#pragma unroll
        for (int e = 0; e < R / 2; ++e)
          sc[e] = p_x[e * WB_THREADS + gtid] * (sc[e] - (e & 1 ? dl[e >> 2].y : dl[e >> 2].x)) *
                  a.scale;
      }
      uint32_t pa[R / 16][4];
      pack_a<R>(pa, sc);
      wgmma_fence();
      wg_rows<D, R>(acc, pa, grp_w == 0 ? dos : qs);   // dV += Pᵀ·dO; dK += dSᵀ·Q
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      __syncthreads();               // this stage (and p_x) is consumed before it is refilled
    }
    cp_async_wait<0>();
    __syncthreads();                 // every copy has landed: the ring is free

    if (chunks == 1) {               // this thread's rows kr0, kr0 + 8, as bf16
      bf16* base = grp_w == 0 ? dvb : dkb;
      const long long stride = grp_w == 0 ? a.dv_st.s : a.dk_st.s;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (kr0 + 8 * r < a.sk)
            *reinterpret_cast<__nv_bfloat162*>(base + (int64_t)(kr0 + 8 * r) * stride + 8 * n +
                                               2 * tig) =
                __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      continue;
    }
    // the fp32 partials meet in the blocks that own their rows: row ρ of
    // the 2R (dK's, then dV's) belongs to block first(r) <= ρ < first(r+1),
    // which receives each block's copy at recv[src][ρ - first(r)] (in its
    // ring and the Pᵀ buffer after it), 8-float chunks XORed with the row
    // against bank conflicts; it adds them in rank order and writes them
    cg::cluster_group cluster = cg::this_cluster();
    const int rows_max = (2 * R + chunks - 1) / chunks;
    auto first = [&](int r) { return r * 2 * R / chunks; };
    cluster.sync();                  // every block is past its steps: the buffers are free
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rho = (grp_w == 0 ? R : 0) + warp * 16 + g + 8 * r;
      const int owner = ((rho + 1) * chunks - 1) / (2 * R), local = rho - first(owner);
      float* dst = cluster.map_shared_rank(red, owner) + (chunk * rows_max + local) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(dst + ((8 * n + 2 * tig) ^ (8 * (local & 3)))) =
            make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
    cluster.sync();                  // every copy of this block's rows is in
    constexpr int C4 = D / 4;
    const int row_lo = first(chunk), nrows = first(chunk + 1) - row_lo;
    for (int i = threadIdx.x; i < nrows * C4; i += THREADS) {
      const int local = i / C4, c = ((i % C4) * 4) ^ (8 * (local & 3));
      const int row = row_lo + local, key = k0 + row % R;
      float4 v[WB_CHUNKS_MAX];       // the blocks' copies, in rank order
#pragma unroll
      for (int src = 0; src < WB_CHUNKS_MAX; ++src)
        if (src < chunks)
          v[src] = *reinterpret_cast<const float4*>(red + (src * rows_max + local) * D + c);
      float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int src = 0; src < WB_CHUNKS_MAX; ++src)
        if (src < chunks) {
          f[0] += v[src].x;
          f[1] += v[src].y;
          f[2] += v[src].z;
          f[3] += v[src].w;
        }
      if (key < a.sk) {
        uint2 out;
        *reinterpret_cast<__nv_bfloat162*>(&out.x) = __floats2bfloat162_rn(f[0], f[1]);
        *reinterpret_cast<__nv_bfloat162*>(&out.y) = __floats2bfloat162_rn(f[2], f[3]);
        bf16* dst = row < R ? dkb + (int64_t)key * a.dk_st.s : dvb + (int64_t)key * a.dv_st.s;
        *reinterpret_cast<uint2*>(dst + ((i % C4) * 4)) = out;
      }
    }
    __syncthreads();                 // the buffers are read before the next tile's copies
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;                        // (B, H, Sq) fp32, or null
  Strides st[4];
  long long b;
  int h, kvh, rep, sq, sk, causal, window, prefix;
  float scale;
  cudaStream_t stream;
};

// above 48 KB a block's shared memory must be opted into, once per kernel
template <typename Kernel>
int opt_in(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <int D, int R, int W>
int launch_f32(const Args& a) {
  constexpr int bytes = f32_smem_bytes<D, R, W>();
  static bool opted = false;
  if (int e = opt_in(flash_f32_kernel<D, R, W>, bytes, opted)) return e;
  constexpr int bq = W * R;
  const dim3 grid((unsigned)((a.sq + bq - 1) / bq), (unsigned)a.h, (unsigned)a.b);
  flash_f32_kernel<D, R, W><<<grid, W * 32, bytes, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o, a.st[0], a.st[1],
      a.st[2], a.st[3], a.rep, a.sq, a.sk, a.causal, a.window, a.prefix, a.scale, a.lse);
  return (int)cudaGetLastError();
}

template <int D, bool PFX>
int launch_tc(const Args& a) {
  constexpr int bytes = tc_smem_bytes<D>();
  static bool opted = false;
  if (int e = opt_in(flash_tc_kernel<D, PFX>, bytes, opted)) return e;
  const dim3 grid((unsigned)((a.sq + TC_BQ - 1) / TC_BQ), (unsigned)a.h, (unsigned)a.b);
  flash_tc_kernel<D, PFX><<<grid, TC_THREADS, bytes, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o, a.st[0], a.st[1],
      a.st[2], a.st[3], a.rep, a.sq, a.sk, a.causal, a.window, a.prefix, a.scale * LOG2E,
      a.lse);
  return (int)cudaGetLastError();
}

// a cluster of `splits` blocks along x; above 8 (the portable most) a
// cluster must be allowed, and above 48 KB of shared memory a block's must be
// opted into, once per kernel
template <int D, bool PFX>
int launch_split(const Args& a, int chunk, int splits) {
  if (splits > split_cap<D>()) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (!allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_split_kernel<D, PFX>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_split_kernel<D, PFX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SplitSmem<D>::bytes(split_cap<D>(), SPLIT_ROWS));
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)a.kvh, (unsigned)a.b);
  cfg.blockDim = dim3(SPLIT_THREADS);
  cfg.dynamicSmemBytes = (size_t)SplitSmem<D>::bytes(splits, a.rep * a.sq);
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_split_kernel<D, PFX>, (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (bf16*)a.o, a.st[0], a.st[1], a.st[2], a.st[3], a.rep, a.sq, a.sk, a.causal, a.window,
      a.prefix, a.scale * LOG2E, chunk);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int D>
int launch_d(const Args& a, int is_bf16, int splits) {
  if (!is_bf16) {
    // 8 warps of 8 rows (64-row tiles); short queries: 4 warps of one row
    // each, so that the K/V loads have 128 threads
    if (a.sq >= 8) return launch_f32<D, 8, 8>(a);
    return launch_f32<D, 1, 4>(a);
  }
  if (splits > 0) {
    const int chunk = (a.sk + splits - 1) / splits;
    return a.prefix > 0 ? launch_split<D, true>(a, chunk, splits)
                        : launch_split<D, false>(a, chunk, splits);
  }
  return a.prefix > 0 ? launch_tc<D, true>(a) : launch_tc<D, false>(a);
}


template <int D>
int launch_bwd_f32(const BwdArgs& a) {
  constexpr int bytes = bwd_smem_bytes<D>();
  static bool opted_dq = false, opted_dkdv = false;
  if (int e = opt_in(flash_bwd_dq_kernel<D>, bytes, opted_dq)) return e;
  if (int e = opt_in(flash_bwd_dkdv_kernel<D>, bytes, opted_dkdv)) return e;
  const dim3 grid_q((unsigned)((a.sq + BWD_BQ - 1) / BWD_BQ), (unsigned)a.h, (unsigned)a.b);
  flash_bwd_dq_kernel<D><<<grid_q, BWD_THREADS, bytes, a.stream>>>(a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const dim3 grid_k((unsigned)((a.sk + BWD_BK - 1) / BWD_BK), (unsigned)a.kvh, (unsigned)a.b);
  flash_bwd_dkdv_kernel<D><<<grid_k, BWD_THREADS, bytes, a.stream>>>(a);
  return (int)cudaGetLastError();
}

// the dq kernel, then the dk/dv kernel: a.chunks blocks (one cluster) per
// pair of key tiles, KV head and batch
template <int D, bool PFX>
int launch_bwd_wg(const BwdArgs& a) {
  static bool opted_dq = false, opted_dkdv = false;
  if (int e = opt_in(flash_bwd_dq_wg_kernel<D, PFX>, wb_dq_smem<D>(), opted_dq)) return e;
  if (int e = opt_in(flash_bwd_dkdv_wg_kernel<D, PFX>, wb_dkdv_smem<D>(), opted_dkdv)) return e;
  const dim3 grid_q((unsigned)((a.sq + WB_ROWS - 1) / WB_ROWS), (unsigned)a.h, (unsigned)a.b);
  flash_bwd_dq_wg_kernel<D, PFX><<<grid_q, WB_THREADS, wb_dq_smem<D>(), a.stream>>>(a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const int pairs = ((a.sk + WB_ROWS - 1) / WB_ROWS + 1) / 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pairs * a.chunks), (unsigned)a.kvh, (unsigned)a.b);
  cfg.blockDim = dim3(2 * WB_THREADS);
  cfg.dynamicSmemBytes = (size_t)wb_dkdv_smem<D>();
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)a.chunks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_wg_kernel<D, PFX>, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int D>
int dkdv_capacity(int chunks) {
  static bool opted = false;
  if (opt_in(flash_bwd_dkdv_wg_kernel<D, false>, wb_dkdv_smem<D>(), opted)) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)chunks, 1, 1);
  cfg.blockDim = dim3(2 * WB_THREADS);
  cfg.dynamicSmemBytes = (size_t)wb_dkdv_smem<D>();
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)chunks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, flash_bwd_dkdv_wg_kernel<D, false>, &cfg) != cudaSuccess)
    return 0;
  return n;
}

template <int D>
int launch_bwd_d(const BwdArgs& a, int is_bf16) {
  if (!is_bf16) return launch_bwd_f32<D>(a);
  return a.prefix > 0 ? launch_bwd_wg<D, true>(a) : launch_bwd_wg<D, false>(a);
}

}  // namespace

// The clusters of `chunks` dk/dv blocks (bf16, head dim d) the card holds at
// once, from the occupancy calculator, into *count (host memory; 0 for a d
// the kernels do not take). The stream is taken as every entry here takes
// it; the count is the current device's.
extern "C" int flash_bwd_capacity(int d, int chunks, void* count, void* stream) {
  (void)stream;
  int* n = (int*)count;
  switch (d) {
    case 32: *n = dkdv_capacity<32>(chunks); break;
    case 64: *n = dkdv_capacity<64>(chunks); break;
    case 128: *n = dkdv_capacity<128>(chunks); break;
    case 256: *n = dkdv_capacity<256>(chunks); break;
    default: *n = 0;
  }
  return (int)cudaGetLastError();
}

// strides: 12 element strides, (b, h, s) for q, k, v and o in that order;
// q, k, v 16-byte aligned with their (b, h, s) strides multiples of 16
// bytes. d in {32, 64, 128, 256}; h a multiple of kvh; b, h at most 65535.
// prefix: keys at positions below it are seen by every row (0: none).
// splits: 0 for the bf16 prefill kernel; for the bf16 decode kernel the
// number of key splits (at most split_cap: 16, 9 at d = 256; each
// ceil(sk / splits) keys; h / kvh ·
// sq <= 16 query rows per group). fp32 ignores splits. lse: null, or (b, h,
// sq) fp32 for each row's logsumexp (the bf16 prefill and fp32 kernels; a
// call with splits > 0 and an lse is refused).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               const long long* strides, void* lse, long long b, int h, int kvh,
                               int sq, int sk, int d, int causal, int window, int prefix,
                               float scale, int is_bf16, int splits, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || b > 65535 || h > 65535 || sk <= 0 || splits < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = (float*)lse;
  for (int i = 0; i < 4; ++i)
    a.st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.b = b;
  a.h = h;
  a.kvh = kvh;
  a.rep = h / kvh;
  a.sq = sq;
  a.sk = sk;
  a.causal = causal;
  a.window = window;
  a.prefix = prefix;
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  if (is_bf16 && splits > 0) {
    if (a.rep * sq > SPLIT_ROWS || splits > SPLIT_MAX || splits > sk || lse != nullptr)
      return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 32: return launch_d<32>(a, is_bf16, splits);
    case 64: return launch_d<64>(a, is_bf16, splits);
    case 128: return launch_d<128>(a, is_bf16, splits);
    case 256: return launch_d<256>(a, is_bf16, splits);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gradient of flash_attention: q, o, do, dq (b, h, sq, d); k, v, dk, dv
// (b, kvh, sk, d); lse and delta (b, h, sq) fp32 contiguous, lse from the
// forward, delta written here (scratch of the second kernel). strides: 24
// element strides, (b, h, s) for q, k, v, o, do, dq, dk and dv in that order,
// the last dim contiguous, every operand 16-byte aligned with (b, h, s)
// strides multiples of 16 bytes. d in {32, 64, 128, 256}; prefix as the
// forward's. chunks (bf16): the chunks the dk/dv kernel splits each KV
// head's query heads into, 1 .. min(8, h / kvh); fp32 ignores it. Two
// launches: dq (and delta), then dk and dv.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* delta, const long long* strides, long long b,
                                   int h, int kvh, int sq, int sk, int d, int causal, int window,
                                   int prefix, float scale, int is_bf16, int chunks,
                                   void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  if (is_bf16 && (chunks < 1 || chunks > WB_CHUNKS_MAX || chunks > h / kvh))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = (const float*)lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = (float*)delta;
  Strides* st[8] = {&a.q_st, &a.k_st, &a.v_st, &a.o_st, &a.do_st, &a.dq_st, &a.dk_st, &a.dv_st};
  for (int i = 0; i < 8; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.b = b;
  a.h = h;
  a.kvh = kvh;
  a.rep = h / kvh;
  a.sq = sq;
  a.sk = sk;
  a.causal = causal;
  a.window = window;
  a.prefix = prefix;
  a.chunks = chunks;
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  switch (d) {
    case 32: return launch_bwd_d<32>(a, is_bf16);
    case 64: return launch_bwd_d<64>(a, is_bf16);
    case 128: return launch_bwd_d<128>(a, is_bf16);
    case 256: return launch_bwd_d<256>(a, is_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}
