// Fused SSCA server update for Hopper (sm_90a): the paper's Algorithm-1
// update chain, eqs. (9) + (10) + (5) with the λ‖ω‖² regularizer folded,
//
//     buf' = (1-ρ)·buf + ρ·(grad + (2λ-2τ)·w)
//     w'   = (1-γ)·w + γ·(-buf'/(2τ))
//
// applied in place over one flat parameter buffer, so one launch updates
// every leaf of the model.
//
// Replaces: src/repro/kernels/ssca_update.py:ssca_update_pallas (_ssca_kernel).
//
// Bound: memory, then the launch. Each element is read three times (w, buf,
// grad) and written twice (w', buf') for 7 flops, far below the card's 295
// flops per byte. At the main path's shape (101,632 fp32 parameters) one
// update moves 2,032,640 B, 0.61 us at 3.35 TB/s: shorter than the fixed
// cost of a launch, which chip_smoke.py measures as `floor_ms` with an
// empty kernel of the same grid and arguments (ssca_update_empty below).
// So the design cuts what lies between the launch and the last store:
//
// - 16-byte accesses. fp32 moves a float4 of each of w, buf and grad; bf16
//   moves 8 bf16 of w and grad and two float4 of buf. That is five memory
//   instructions per 4 (fp32) or 8 (bf16) elements, where one element a
//   thread took five. The vector body runs when w, buf and grad are 16-byte
//   aligned; the last n mod V elements go through a scalar tail of the same
//   launch, and unaligned operands (a view at an odd offset) through the
//   same kernel instantiated with V = 1. Nothing goes back to PyTorch.
// - All loads before any arithmetic. Each thread owns one vector of a pass
//   and issues its three data loads, then those of ρ and γ (see
//   load_scalar), before it computes, so their latencies overlap. Blocks are kThreads = 256
//   threads; the vector width, the grid and the tail start come from the
//   Python wrapper (kernels/ssca_update.py::launch_layout). At the main
//   path's size that is 100 blocks, one float4 a thread: one wave on 132
//   SMs, the fastest of the layouts timed on the H100 (PERF.md: two or four
//   vectors a thread were slower at every block size). A grid-stride loop
//   takes any larger n.
// - No division per element. −γ/(2τ) is formed once per thread and pass,
//   after the pass's data loads are issued (see load_scalar), and each
//   element costs two FMAs and two multiplies in a fixed order (explicit
//   __fmaf_rn/__fmul_rn, so nvcc's contraction cannot reorder them):
//       t    = fma(c, w, grad)                  c = 2λ-2τ
//       buf' = fma(1-ρ, buf, ρ·t)
//       w'   = fma(1-γ, w, (−γ/(2τ))·buf')
//   Against the plain version, which rounds after every operation, buf'
//   differs by at most about 2 ulps of its largest term (|(1-ρ)·buf|,
//   |ρ·grad|, |ρ·c·w|) and w' by about 3 ulps of its largest term
//   (|(1-γ)·w|, |γ·buf'/(2τ)|), buf's difference included: some 1e-6 at
//   |w'| ~ 10, inside the 1e-5 fp32 tolerance. In bf16 the two fp32 values
//   may round to neighbouring bf16 values: one bf16 ulp, 2^-8 relative,
//   inside the 2e-2 tolerance (absolute plus relative).
// - ρ and γ change every round and are read through two device pointers,
//   the per-round entries of run_rounds' (K,) schedule arrays as they lie
//   (the TPU kernel's scalar prefetch): the host never waits on them, and
//   no launch assembles them. τ and λ are float arguments.
//
// Arithmetic is fp32; w' is stored in w's type (fp32, or bf16 rounded to
// nearest even); buf stays fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// V consecutive elements at p + i, as fp32. V = 1 is a scalar access; for
// V > 1, p + i is 16-byte aligned.
template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ p, int64_t i,
                                       float* x) {
  if constexpr (V == 1) {
    x[0] = p[i];
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i + j);
      x[j] = v.x;
      x[j + 1] = v.y;
      x[j + 2] = v.z;
      x[j + 3] = v.w;
    }
  }
}

__device__ __forceinline__ void unpack2(uint32_t u, float* x) {
  x[0] = __uint_as_float(u << 16);              // the low bf16 comes first
  x[1] = __uint_as_float(u & 0xffff0000u);
}

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* __restrict__ p,
                                       int64_t i, float* x) {
  if constexpr (V == 1) {
    x[0] = __bfloat162float(p[i]);
  } else {
    static_assert(V == 8, "bf16 vectors are 8 elements (16 B)");
    const uint4 v = *reinterpret_cast<const uint4*>(p + i);
    unpack2(v.x, x);
    unpack2(v.y, x + 2);
    unpack2(v.z, x + 4);
    unpack2(v.w, x + 6);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* __restrict__ p, int64_t i,
                                        const float* x) {
  if constexpr (V == 1) {
    p[i] = x[0];
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(p + i + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* __restrict__ p,
                                        int64_t i, const float* x) {
  if constexpr (V == 1) {
    p[i] = __float2bfloat16_rn(x[0]);
  } else {
    *reinterpret_cast<uint4*>(p + i) =
        make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
                   pack2(x[6], x[7]));
  }
}

struct Coef {
  float c, rho, keep_buf, keep_w, step;   // step = −γ/(2τ)
};

// ρ and γ are read at the point of use, after a pass's data loads: an asm
// volatile load is not hoisted out of the loop, so neither is the
// coefficients' arithmetic that waits for it, and all the loads of a pass
// are in flight together. Hoisted into a prologue (as a plain load would
// be), γ's division would stall each thread for one memory latency before
// its first data load.
__device__ __forceinline__ float load_scalar(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ Coef coef(const float* rho_p, const float* gamma_p,
                                     float c, float two_tau) {
  const float rho = load_scalar(rho_p);
  const float gamma = load_scalar(gamma_p);
  return Coef{c, rho, 1.0f - rho, 1.0f - gamma, __fdiv_rn(-gamma, two_tau)};
}

__device__ __forceinline__ void update(float& w, float& b, float g,
                                       const Coef& k) {
  b = __fmaf_rn(k.keep_buf, b, __fmul_rn(k.rho, __fmaf_rn(k.c, w, g)));
  w = __fmaf_rn(k.keep_w, w, __fmul_rn(k.step, b));
}

constexpr int kThreads = 256;   // a block; kernels/ssca_update.py's THREADS

// Vector v of the body covers elements [v·V, v·V + V) of [0, tail_start);
// thread t of block b takes vector b·kThreads + t of each pass of the grid.
template <typename T, int V>
__global__ void ssca_update_kernel(T* __restrict__ w, float* __restrict__ buf,
                                   const T* __restrict__ grad,
                                   const float* __restrict__ rho_p,
                                   const float* __restrict__ gamma_p, float c,
                                   float two_tau, int64_t n,
                                   int64_t tail_start) {
  const int64_t nvec = tail_start / V;
  for (int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * kThreads) {
    float wv[V], bv[V], gv[V];
    load_v<V>(w, v * V, wv);
    load_v<V>(buf, v * V, bv);
    load_v<V>(grad, v * V, gv);
    const Coef k = coef(rho_p, gamma_p, c, two_tau);
#pragma unroll
    for (int e = 0; e < V; ++e) update(wv[e], bv[e], gv[e], k);
    store_v<V>(w, v * V, wv);
    store_v<V>(buf, v * V, bv);
  }
  // the scalar tail: the last n - tail_start (< V) elements, in block 0
  if (blockIdx.x == 0 && threadIdx.x < n - tail_start) {
    const int64_t i = tail_start + threadIdx.x;
    float wi, bi, gi;
    load_v<1>(w, i, &wi);
    load_v<1>(buf, i, &bi);
    load_v<1>(grad, i, &gi);
    update(wi, bi, gi, coef(rho_p, gamma_p, c, two_tau));
    store_v<1>(w, i, &wi);
    store_v<1>(buf, i, &bi);
  }
}

// The launch floor: the same grid, block and arguments, no work.
__global__ void ssca_update_empty_kernel(float*, float*, const float*,
                                         const float*, const float*, float,
                                         float, int64_t, int64_t) {}

template <typename T, int V>
int launch_v(void* w, void* buf, const void* grad, const void* rho,
             const void* gamma, float c, float two_tau, long long n,
             long long tail_start, int blocks, void* stream) {
  ssca_update_kernel<T, V><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (T*)w, (float*)buf, (const T*)grad, (const float*)rho,
      (const float*)gamma, c, two_tau, (int64_t)n, (int64_t)tail_start);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Checks the wrapper's layout, then launches the instance it names; a
// layout the kernel cannot take is refused (cudaErrorInvalidValue), never
// run.
template <typename T>
int launch(void* w, void* buf, const void* grad, const void* rho,
           const void* gamma, float c, float two_tau, long long n, int vec,
           int blocks, long long tail_start, void* stream) {
  if (n <= 0) return 0;
  constexpr int kVec = 16 / sizeof(T);
  const bool ok = (vec == 1 || (vec == kVec && aligned16(w) &&
                                aligned16(buf) && aligned16(grad))) &&
                  tail_start == n - n % vec && blocks >= 1;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (vec == 1)
    return launch_v<T, 1>(w, buf, grad, rho, gamma, c, two_tau, n,
                          tail_start, blocks, stream);
  return launch_v<T, kVec>(w, buf, grad, rho, gamma, c, two_tau, n,
                           tail_start, blocks, stream);
}

}  // namespace

extern "C" int ssca_update_f32(void* w, void* buf, const void* grad,
                               const void* rho, const void* gamma, float c,
                               float two_tau, long long n, int vec, int blocks,
                               long long tail_start, void* stream) {
  return launch<float>(w, buf, grad, rho, gamma, c, two_tau, n, vec, blocks,
                       tail_start, stream);
}

extern "C" int ssca_update_bf16(void* w, void* buf, const void* grad,
                                const void* rho, const void* gamma, float c,
                                float two_tau, long long n, int vec,
                                int blocks, long long tail_start,
                                void* stream) {
  return launch<__nv_bfloat16>(w, buf, grad, rho, gamma, c, two_tau, n, vec,
                               blocks, tail_start, stream);
}

// Measurement only (chip_smoke.py's floor_ms): an empty kernel launched
// with the arguments, grid and block of an ssca_update_f32 call.
extern "C" int ssca_update_empty(void* w, void* buf, const void* grad,
                                 const void* rho, const void* gamma, float c,
                                 float two_tau, long long n, int vec,
                                 int blocks, long long tail_start,
                                 void* stream) {
  (void)vec;
  ssca_update_empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)w, (float*)buf, (const float*)grad, (const float*)rho,
      (const float*)gamma, c, two_tau, (int64_t)n, (int64_t)tail_start);
  return (int)cudaGetLastError();
}
