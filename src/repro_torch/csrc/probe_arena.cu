// Probe of the fused CSR probe arena, one thread per probe (sm_90a).
//
// Replaces the TPU kernel repro/kernels/probe_arena.py:_search_kernel
// (launched by _arena_search) together with the jitted hit detect and CSR
// lookup of repro/core/device_plan.py:_probe_jit_factory.  For each probe it
// finds the leftmost arena slot whose (key, tag) >= (probe key, probe tag),
// keys compared as UNSIGNED 64-bit and the tag word as the tie break (the
// coordinate in "coord" mode, zero in "packed" mode), and returns the CSR
// extent (offsets[slot], offsets[slot + 1]) on an exact hit, (0, 0) on a
// miss or an invalid probe.  The TPU split keys into u32 halves only
// because its vector units have no 64-bit lanes; Hopper compares u64
// natively, so the keys stay whole.
//
// What bounds it: memory latency.  Each probe walks ceil(log2(n + 1))
// dependent reads of 12 bytes (key + tag) scattered over the arena, so a
// batch moves little data but waits on a chain of DRAM/L2 round trips.
// The design keeps one probe per thread so a warp keeps 32 independent
// chains in flight and the card overlaps thousands of them; the top levels
// of the search tree are shared by every probe and stay in L2.

#include <cuda_runtime.h>

namespace {

__global__ void probe_arena_kernel(const unsigned long long* __restrict__ keys,
                                   const int* __restrict__ tags,
                                   const long long* __restrict__ offsets,
                                   long long n,
                                   const unsigned long long* __restrict__ qkeys,
                                   const int* __restrict__ qtags,
                                   const unsigned char* __restrict__ valid,
                                   long long num_probes,
                                   long long* __restrict__ starts,
                                   long long* __restrict__ ends) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= num_probes) return;
  const unsigned long long q = qkeys[p];
  const unsigned int qt = static_cast<unsigned int>(qtags[p]);
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const unsigned long long k = keys[mid];
    const unsigned int t = static_cast<unsigned int>(tags[mid]);
    if (k < q || (k == q && t < qt)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool hit = valid[p] != 0 && lo < n && keys[lo] == q &&
                   static_cast<unsigned int>(tags[lo]) == qt;
  starts[p] = hit ? offsets[lo] : 0;
  ends[p] = hit ? offsets[lo + 1] : 0;
}

}  // namespace

// keys/qkeys: int64 tensors holding the raw u64 bits; tags/qtags: int32;
// offsets: int64 (n + 1); valid: bool (one byte each); starts/ends: int64.
extern "C" cudaError_t probe_arena_launch(const void* keys, const void* tags,
                                          const void* offsets, long long n,
                                          const void* qkeys, const void* qtags,
                                          const void* valid, long long num_probes,
                                          void* starts, void* ends, void* stream) {
  if (n <= 0 || num_probes <= 0) return cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (num_probes + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  probe_arena_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys), static_cast<const int*>(tags),
      static_cast<const long long*>(offsets), n,
      static_cast<const unsigned long long*>(qkeys), static_cast<const int*>(qtags),
      static_cast<const unsigned char*>(valid), num_probes,
      static_cast<long long*>(starts), static_cast<long long*>(ends));
  return cudaGetLastError();
}

extern "C" const char* probe_arena_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
