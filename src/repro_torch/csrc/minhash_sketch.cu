// Batched multiset min-hash sketches, one block per (text, tile of seeds)
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/minhash_sketch.py:_minhash_kernel
// (launched by minhash_sketch).  For B padded token streams and K seeds,
// out[b, k] = min over positions n with tokens[b, n] >= 0 of
// hash32(seeds[k], tokens[b, n], occ[b, n]), and 0xFFFFFFFF where a stream
// has no valid position.  hash32 is the 32-bit murmur3 family of
// repro/kernels/common.py, here in native uint32_t arithmetic (the
// wraparound the reference relies on is C++'s unsigned overflow).
//
// What bounds it: integer operations.  Each (b, k, n) costs ~23 32-bit
// integer operations (two murmur finalizers, the mixing multiplies, the
// min) against 8 bytes read per position, so past a few seeds the ALUs,
// not the memory, set the pace.  The design reads each position once per
// tile of KT seeds and keeps KT running minima in registers: a block of
// 256 threads strides over the positions of one text, then reduces each
// minimum over the warp with shuffles and over the block's 8 warps in
// shared memory.  The TPU's (8, 128) tiling and sequential N-axis
// accumulation are not carried over: blocks run in parallel and each
// block owns its outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;  // seeds per block

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

__global__ void __launch_bounds__(kThreads)
minhash_sketch_kernel(const int* __restrict__ tokens, const int* __restrict__ occ,
                      const long long* __restrict__ seeds, long long n, int k,
                      long long* __restrict__ out) {
  const long long b = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  uint32_t seed[kTile];
  uint32_t best[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    seed[j] = k0 + j < k ? static_cast<uint32_t>(seeds[k0 + j]) : 0u;
    best[j] = 0xFFFFFFFFu;
  }
  const int* tok = tokens + b * n;
  const int* oc = occ + b * n;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const int t = tok[i];
    if (t < 0) continue;  // padding
    const uint32_t tp = static_cast<uint32_t>(t) * 0xCC9E2D51u;
    const uint32_t xp = static_cast<uint32_t>(oc[i]) * 0x1B873593u;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const uint32_t h = mix32(mix32(seed[j] ^ tp ^ 0x9E3779B9u) ^ xp);
      best[j] = min(best[j], h);
    }
  }
  __shared__ uint32_t partial[kWarps][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    uint32_t v = best[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
    }
    if (lane == 0) partial[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTile && k0 + static_cast<int>(threadIdx.x) < k) {
    uint32_t v = 0xFFFFFFFFu;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = min(v, partial[w][threadIdx.x]);
    out[b * k + k0 + threadIdx.x] = static_cast<long long>(v);
  }
}

}  // namespace

// tokens/occ: int32 (B, N) row-major (token < 0 = padding); seeds: int64 (K,)
// holding uint32 values; out: int64 (B, K) holding uint32 values.
extern "C" cudaError_t minhash_sketch_launch(const void* tokens, const void* occ,
                                             const void* seeds, long long batch,
                                             long long n, int k, void* out,
                                             void* stream) {
  if (batch <= 0 || n < 0 || k <= 0) return cudaErrorInvalidValue;
  if (batch > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long tiles = (k + kTile - 1) / kTile;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(batch), static_cast<unsigned int>(tiles));
  minhash_sketch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), static_cast<const int*>(occ),
      static_cast<const long long*>(seeds), n, k, static_cast<long long*>(out));
  return cudaGetLastError();
}

extern "C" const char* minhash_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
