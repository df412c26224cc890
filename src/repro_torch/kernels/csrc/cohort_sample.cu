// The O(S) cohort draw for Hopper (sm_90a): slot i of an S-client cohort
// takes pi(i), pi a keyed alternating (unbalanced) Feistel permutation of the
// domain [0, 2^(hi_bits+lo_bits)), and cycle-walks pi until the value lies
// in [0, num_clients):
//
//     x = pi(i);  while (x >= num_clients) x = pi(x);  ids[i] = x
//
// pi runs R rounds (6 on the main path); round r adds mix(half ^ key_r) to
// the other half, modulo its width (the low half on even rounds, the high
// half on odd ones), mix being the murmur3 finalizer. Every value stays a
// uint32, as in the reference.
//
// Replaces: the XLA while_loop of src/repro/core/fed.py:254 (cohort_sample,
// with _feistel and _feistel_mix at :222-247).
//
// Bound: neither memory nor the ALUs. A slot reads the R keys (24 B, the same
// for every slot) and writes 4 B; a walk step is about 40 integer operations
// and takes 1.05 steps on average at I = 1e6 (the domain is 2^20), 26 at
// I = 10 (domain 256), and at most the domain's size. At S = 256 the whole
// draw is a few microseconds of one block: the launch is the cost.
//
// Design: one thread per slot, the walk as a while loop (threads whose walk
// ends early idle, which at these sizes costs nothing), the keys loaded once
// per thread from the device pointer the wrapper passes, so the draw needs
// no value from the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRounds = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t feistel(uint32_t x, const uint32_t* keys, int rounds,
                                            int lo_bits, uint32_t lo_mask, uint32_t hi_mask) {
  uint32_t hi = x >> lo_bits, lo = x & lo_mask;
  for (int r = 0; r < rounds; ++r) {
    if ((r & 1) == 0)
      lo = (lo + mix(hi ^ keys[r])) & lo_mask;
    else
      hi = (hi + mix(lo ^ keys[r])) & hi_mask;
  }
  return (hi << lo_bits) | lo;
}

__global__ void cohort_sample_kernel(const uint32_t* __restrict__ round_keys, int rounds,
                                     int32_t* __restrict__ ids, int cohort, uint32_t n,
                                     int hi_bits, int lo_bits) {
  __shared__ uint32_t keys[kMaxRounds];
  if (threadIdx.x < rounds) keys[threadIdx.x] = round_keys[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cohort) return;
  const uint32_t lo_mask = (1u << lo_bits) - 1u;
  const uint32_t hi_mask = (1u << hi_bits) - 1u;
  uint32_t x = feistel((uint32_t)i, keys, rounds, lo_bits, lo_mask, hi_mask);
  while (x >= n) x = feistel(x, keys, rounds, lo_bits, lo_mask, hi_mask);
  ids[i] = (int32_t)x;
}

// The launch floor: the same grid, block and arguments, no work.
__global__ void cohort_sample_empty_kernel(const uint32_t*, int, int32_t*, int, uint32_t,
                                           int, int) {}

}  // namespace

// round_keys: (rounds,) uint32; ids: (cohort,) int32. hi_bits + lo_bits is
// at most 32 and each is at least 1 and at most 31, so the masks fit.
extern "C" int cohort_sample(const void* round_keys, int rounds, void* ids, int cohort,
                             long long num_clients, int hi_bits, int lo_bits, void* stream) {
  if (rounds < 0 || rounds > kMaxRounds || hi_bits < 1 || lo_bits < 1 || hi_bits > 31 ||
      lo_bits > 31 || hi_bits + lo_bits > 32 || num_clients < 1 ||
      num_clients > 0xFFFFFFFFll || (long long)cohort > num_clients)
    return (int)cudaErrorInvalidValue;
  if (cohort <= 0) return 0;
  const int blocks = (cohort + kThreads - 1) / kThreads;
  cohort_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)round_keys, rounds, (int32_t*)ids, cohort, (uint32_t)num_clients,
      hi_bits, lo_bits);
  return (int)cudaGetLastError();
}

// Measurement only (chip_smoke.py's floor_ms): an empty kernel launched with
// the arguments, grid and block of a cohort_sample call.
extern "C" int cohort_sample_empty(const void* round_keys, int rounds, void* ids, int cohort,
                                   long long num_clients, int hi_bits, int lo_bits,
                                   void* stream) {
  if (cohort <= 0) return 0;
  const int blocks = (cohort + kThreads - 1) / kThreads;
  cohort_sample_empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)round_keys, rounds, (int32_t*)ids, cohort, (uint32_t)num_clients,
      hi_bits, lo_bits);
  return (int)cudaGetLastError();
}
