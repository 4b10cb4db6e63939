// Grouped small-group plane sweep: row gather + coverage grid (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sweep_grid.py:_sweep_kernel
// (launched by sweep_grid) together with the row gather
// jnp.take(win_rect, idx) of repro/core/device_plan.py:fused_batch_query.
// One block per (query, text) group of at most 32 collided windows:
//
//   1. gather the group's (a, b, c, d) rows from the resident win_rect by
//      the (G, S) index grid; slots past sizes[g] become zero-width rects
//      at the group's max exclusive bound (the host padding normalization,
//      with -(1 << 30) as the max of an all-padded group);
//   2. rank each boundary among the group's 2S x (and y) boundaries
//      (searchsorted-left: the count of strictly smaller values) and sort
//      both boundary vectors;
//   3. scatter the four +-1 corner pulses of every real rect into a
//      (2S + 1)^2 difference array and prefix-sum it along both axes: the
//      coverage count of every compressed cell;
//   4. hot = count >= m, with zero-width x stripes forced cold; write
//      hot (2S - 1)^2 as bytes and the sorted xs / ys.
//
// The TPU built the coverage grid as an indicator matmul because it
// scatters poorly; on Hopper the rects, both boundary vectors and the
// <= 65 x 65 count grid live in shared memory and the pulses are shared
// atomics.  What bounds it: per-block latency, not bytes or operations —
// a group is a few KB and ~10^4 integer operations, so the kernel is
// sized to finish a group in a handful of short passes with no global
// traffic besides the gathered rows and the outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxS = 32;
constexpr int kMaxNX = 2 * kMaxS;
constexpr int kStride = kMaxNX + 1;
constexpr int kNeg = -(1 << 30);
constexpr int kThreads = 128;

__global__ void sweep_grid_kernel(const int* __restrict__ win_rect,
                                  const long long* __restrict__ idx,
                                  const int* __restrict__ sizes, int S, int m,
                                  unsigned char* __restrict__ hot,
                                  int* __restrict__ xs_out,
                                  int* __restrict__ ys_out) {
  __shared__ int a[kMaxS], b1[kMaxS], c[kMaxS], d1[kMaxS];
  __shared__ int xa[kMaxS], xb[kMaxS], yc[kMaxS], yd[kMaxS];
  __shared__ int bx[kMaxNX], by[kMaxNX], sx[kMaxNX], sy[kMaxNX];
  __shared__ int diff[kStride * kStride];
  __shared__ int bmax, dmax;

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int NX = 2 * S;
  const int STR = NX + 1;
  const int size = min(sizes[g], S);

  for (int s = tid; s < size; s += nt) {
    const int* w = win_rect + 4 * idx[g * S + s];
    a[s] = w[0];
    b1[s] = w[1] + 1;
    c[s] = w[2];
    d1[s] = w[3] + 1;
  }
  for (int i = tid; i < STR * STR; i += nt) diff[i] = 0;
  __syncthreads();
  if (tid == 0) {
    int bm = kNeg, dm = kNeg;
    for (int s = 0; s < size; ++s) {
      bm = max(bm, b1[s]);
      dm = max(dm, d1[s]);
    }
    bmax = bm;
    dmax = dm;
  }
  __syncthreads();
  for (int s = tid; s < S; s += nt) {
    if (s >= size) {
      a[s] = bmax;
      b1[s] = bmax;
      c[s] = dmax;
      d1[s] = dmax;
    }
    bx[s] = a[s];
    bx[S + s] = b1[s];
    by[s] = c[s];
    by[S + s] = d1[s];
  }
  __syncthreads();

  // ranks (count of strictly smaller boundaries) of the 4S rect bounds
  for (int t = tid; t < 4 * S; t += nt) {
    const int which = t / S;
    const int s = t - which * S;
    const int* bound = which < 2 ? bx : by;
    const int v = which == 0 ? a[s] : which == 1 ? b1[s] : which == 2 ? c[s] : d1[s];
    int r = 0;
    for (int j = 0; j < NX; ++j) r += bound[j] < v;
    int* out = which == 0 ? xa : which == 1 ? xb : which == 2 ? yc : yd;
    out[s] = r;
  }
  // stable sort of both boundary vectors by position counting
  for (int t = tid; t < 2 * NX; t += nt) {
    const int which = t / NX;
    const int i = t - which * NX;
    const int* v = which ? by : bx;
    const int vi = v[i];
    int pos = 0;
    for (int j = 0; j < NX; ++j) pos += (v[j] < vi) || (v[j] == vi && j < i);
    (which ? sy : sx)[pos] = vi;
  }
  __syncthreads();

  for (int s = tid; s < size; s += nt) {
    atomicAdd(&diff[xa[s] * STR + yc[s]], 1);
    atomicAdd(&diff[xb[s] * STR + yd[s]], 1);
    atomicAdd(&diff[xa[s] * STR + yd[s]], -1);
    atomicAdd(&diff[xb[s] * STR + yc[s]], -1);
  }
  __syncthreads();
  for (int j = tid; j < STR; j += nt) {
    int run = 0;
    for (int i = 0; i < STR; ++i) {
      run += diff[i * STR + j];
      diff[i * STR + j] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < STR; i += nt) {
    int run = 0;
    for (int j = 0; j < STR; ++j) {
      run += diff[i * STR + j];
      diff[i * STR + j] = run;
    }
  }
  __syncthreads();

  const int H = NX - 1;
  unsigned char* hot_g = hot + g * H * H;
  for (int cell = tid; cell < H * H; cell += nt) {
    const int i = cell / H;
    const int j = cell - i * H;
    hot_g[cell] = (diff[i * STR + j] >= m && sx[i + 1] > sx[i]) ? 1 : 0;
  }
  for (int i = tid; i < NX; i += nt) {
    xs_out[g * NX + i] = sx[i];
    ys_out[g * NX + i] = sy[i];
  }
}

}  // namespace

// win_rect: int32 (nwin, 4); idx: int64 (G, S) row ids into win_rect
// (slots past sizes[g] are not read); sizes: int32 (G,);
// hot: uint8 (G, 2S - 1, 2S - 1); xs, ys: int32 (G, 2S).
extern "C" cudaError_t sweep_grid_launch(const void* win_rect, const void* idx,
                                         const void* sizes, long long G, int S,
                                         int m, void* hot, void* xs, void* ys,
                                         void* stream) {
  if (G <= 0 || G > 0x7fffffffLL || S < 1 || S > kMaxS) return cudaErrorInvalidValue;
  sweep_grid_kernel<<<static_cast<unsigned int>(G), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(win_rect), static_cast<const long long*>(idx),
      static_cast<const int*>(sizes), S, m, static_cast<unsigned char*>(hot),
      static_cast<int*>(xs), static_cast<int*>(ys));
  return cudaGetLastError();
}

extern "C" const char* sweep_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
