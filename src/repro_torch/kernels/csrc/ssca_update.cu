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
// Bound: memory. Each element is read three times (w, buf, grad) and written
// twice (w', buf') and costs 7 flops, far below the card's 295 flops per
// byte. At the main path's shape (101,632 fp32 parameters) one update moves
// 2,032,640 B: 0.61 us at 3.35 TB/s, far below the few microseconds of one
// launch, so at this size the launch itself is what costs.
//
// Design: one grid-stride elementwise pass, coalesced 4-byte loads, no shared
// memory. ρ and γ change every round; they are read from a two-float device
// array (the TPU kernel's scalar prefetch), so the host never has to
// synchronise to learn them and nothing is rebuilt per round. τ and λ are
// plain float arguments. Arithmetic is fp32; w' is cast back to w's type
// (fp32 or bf16, round to nearest even). nvcc contracts the products and sums
// into FMAs, so results differ from the unfused plain version by about an ulp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void ssca_update_kernel(T* __restrict__ w, float* __restrict__ buf,
                                   const T* __restrict__ grad,
                                   const float* __restrict__ sched, float c,
                                   float two_tau, int64_t n) {
  const float rho = sched[0];
  const float gamma = sched[1];
  const float keep_buf = 1.0f - rho;
  const float keep_w = 1.0f - gamma;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float wi = load_f32(w, i);
    const float nb = keep_buf * buf[i] + rho * (load_f32(grad, i) + c * wi);
    const float nw = keep_w * wi + gamma * (-nb / two_tau);
    buf[i] = nb;
    store_f32(w, i, nw);
  }
}

template <typename T>
int launch(void* w, void* buf, const void* grad, const void* sched, float c,
           float two_tau, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride beyond 62 blocks per SM
  ssca_update_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (T*)w, (float*)buf, (const T*)grad, (const float*)sched, c, two_tau, (int64_t)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssca_update_f32(void* w, void* buf, const void* grad, const void* sched,
                               float c, float two_tau, long long n, void* stream) {
  return launch<float>(w, buf, grad, sched, c, two_tau, n, stream);
}

extern "C" int ssca_update_bf16(void* w, void* buf, const void* grad, const void* sched,
                                float c, float two_tau, long long n, void* stream) {
  return launch<__nv_bfloat16>(w, buf, grad, sched, c, two_tau, n, stream);
}
