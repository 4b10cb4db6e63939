// ICWS (improved consistent weighted sampling) over (hash function k,
// token t) grids, f32 (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/icws_hash.py:
//   * _hash_grid_kernel (launched by icws_hash_grid): (k_int, a) for every
//     (k, t) of a (K, T) grid -- icws_hash_grid_launch;
//   * _sketch_batch_kernel (icws_sketch_batch) and _sketch_kernel
//     (icws_sketch, the B = 1 case): per (text b, hash function k) the
//     argmin over t of a, with its k_int -- icws_sketch_batch_launch.
// One element, as the reference computes it in f32 (icws_hash.py:37-42):
//   valid = w > 0;  lw = log(valid ? w : 1);  k_int = floor(lw / r + beta);
//   a = c * exp(-r * (k_int - beta) - r);  masked: (k_int, a) = (0, 3.0e38).
// logf/expf are the accurate library functions and the division is IEEE
// (no fast math); the a expression is evaluated with explicit
// round-to-nearest operations in the reference's order, so the compiler
// contracts nothing into an FMA and the kernel rounds as the plain PyTorch
// version does, op for op.
//
// The argmin keeps the reference's semantics: the running minimum starts at
// (3.0e38, t = -1, k_int = 0) and moves only to a strictly smaller a, so
// the first index wins a tie and a text whose tokens are all masked returns
// (3.0e38, -1, 0).
//
// What bounds it: bytes.  Each element reads 12 bytes of r/c/beta (plus w,
// shared by the K rows of a text) for one logf and one expf, far below the
// special-function units' rate, so both kernels are built to stream the
// grids once with coalesced loads.  The hash grid runs one thread per
// element.  The sketch runs one warp per (b, k) row: the lanes stride over
// t, each keeps its own running minimum, and five xor-shuffles reduce the
// warp by (a, t) order -- no shared memory, no atomics, no second pass.
// The TPU's (8, 128) tiles with the argmin carried across the sequential T
// axis of the grid are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 256;

__device__ __forceinline__ void icws_element(float r, float c, float beta,
                                             float w, int* kint, float* a) {
  const bool valid = w > 0.0f;
  const float lw = logf(valid ? w : 1.0f);
  const float kf = floorf(__fadd_rn(__fdiv_rn(lw, r), beta));
  const float e = __fsub_rn(__fmul_rn(-r, __fsub_rn(kf, beta)), r);
  const float av = __fmul_rn(c, expf(e));
  *kint = valid ? static_cast<int>(kf) : 0;
  *a = valid ? av : kBig;
}

__global__ void __launch_bounds__(kThreads)
icws_hash_grid_kernel(const float* __restrict__ r, const float* __restrict__ c,
                      const float* __restrict__ beta, const float* __restrict__ w,
                      long long k, long long t_len, int* __restrict__ kint,
                      float* __restrict__ a) {
  const long long total = k * t_len;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       i < total; i += stride) {
    int ki;
    float av;
    icws_element(r[i], c[i], beta[i], w[i % t_len], &ki, &av);
    kint[i] = ki;
    a[i] = av;
  }
}

__global__ void __launch_bounds__(kThreads)
icws_sketch_batch_kernel(const float* __restrict__ r, const float* __restrict__ c,
                         const float* __restrict__ beta, const float* __restrict__ w,
                         long long rows, long long k, long long t_len,
                         float* __restrict__ mina, int* __restrict__ argt,
                         int* __restrict__ kint) {
  // one warp per row (b, k); the exit is uniform across each warp
  const long long row = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) >> 5;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* rr = r + row * t_len;
  const float* cc = c + row * t_len;
  const float* bb = beta + row * t_len;
  const float* ww = w + (row / k) * t_len;
  float best = kBig;
  int best_t = -1;
  int best_k = 0;
  for (long long t = lane; t < t_len; t += 32) {
    int ki;
    float av;
    icws_element(rr[t], cc[t], bb[t], ww[t], &ki, &av);
    if (av < best) {  // lanes visit t in ascending order: the first wins
      best = av;
      best_t = static_cast<int>(t);
      best_k = ki;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    const int ot = __shfl_xor_sync(0xFFFFFFFFu, best_t, off);
    const int ok = __shfl_xor_sync(0xFFFFFFFFu, best_k, off);
    // (a, t) order; equal a at 3.0e38 only ever pairs t = -1 with t = -1
    if (ob < best || (ob == best && ot < best_t)) {
      best = ob;
      best_t = ot;
      best_k = ok;
    }
  }
  if (lane == 0) {
    mina[row] = best;
    argt[row] = best_t;
    kint[row] = best_k;
  }
}

unsigned int blocks_for(long long threads) {
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
}

}  // namespace

// r, c, beta: f32 (K, T) row-major; w: f32 (T,); kint: int32 (K, T);
// a: f32 (K, T).
extern "C" cudaError_t icws_hash_grid_launch(const void* r, const void* c,
                                             const void* beta, const void* w,
                                             long long k, long long t_len,
                                             void* kint, void* a, void* stream) {
  if (k <= 0 || t_len <= 0) return cudaErrorInvalidValue;
  // a grid-stride loop: cap the grid at 64 blocks of 256 threads per SM
  long long blocks = blocks_for(k * t_len);
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  icws_hash_grid_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(c),
      static_cast<const float*>(beta), static_cast<const float*>(w), k, t_len,
      static_cast<int*>(kint), static_cast<float*>(a));
  return cudaGetLastError();
}

// r, c, beta: f32 (B, K, T) row-major; w: f32 (B, T); mina: f32 (B, K);
// argt, kint: int32 (B, K).
extern "C" cudaError_t icws_sketch_batch_launch(const void* r, const void* c,
                                                const void* beta, const void* w,
                                                long long batch, long long k,
                                                long long t_len, void* mina,
                                                void* argt, void* kint,
                                                void* stream) {
  if (batch <= 0 || k <= 0 || t_len <= 0 || t_len > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const long long rows = batch * k;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  icws_sketch_batch_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(c),
      static_cast<const float*>(beta), static_cast<const float*>(w), rows, k,
      t_len, static_cast<float*>(mina), static_cast<int*>(argt),
      static_cast<int*>(kint));
  return cudaGetLastError();
}

extern "C" const char* icws_hash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
