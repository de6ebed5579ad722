// Per-group pair histogram for Hopper (sm_90a): how many needed entries
// each group key holds.
//
// K7 group_counts_launch replaces the JAX package's per-group masked sums
// funky_tpu/passes/shadow_filter.py::cascaded_shadow_sparse (:714-716,
// `counts_c`), which XLA fuses into one reduction on the TPU. Its plain
// twin is funky_tpu_torch/passes/shadow_filter.py::_group_counts_plain:
// one scatter_add_ of an int32 one per entry (about 4.1 M atomics at
// 1080p, two cascades per pixel) into n_groups + 1 bins.
//
// Semantics: out[g] = the number of entries i with needs[i] and
// key[i] == g, for g in [0, n_groups). Integer sums do not depend on
// their order, so the counts equal the twin's exactly. A needed entry
// whose key lies outside [0, n_groups) is not counted (the twin's
// scatter_add_ would fail on it; the frame's keys never do).
//
// What bounds it on this card: the bytes. Every `needs` byte is read
// (4.1 MB at 1080p, two cascades per pixel), and the int32 key only of a
// needed entry, a few percent of the pairs: ~0.0013 ms at 3.35 TB/s
// (5 B per entry, ~0.006 ms, if every key were read). The atomics are as
// few as the needed entries.
//
// Design: a grid-stride loop reads `needs` four entries at a time (one
// 32-bit load where the pointer allows) and the key only of a needed
// entry; each block counts into a shared-memory histogram and then adds
// each nonzero bin to the output with one global atomicAdd. The wrapper's
// memset clears the output first on the same stream. No value is read on
// the host, so the launch records inside a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GROUPS = 64;

__device__ __forceinline__ void count(const int* __restrict__ key,
                                      long long i, int n_groups, int* hist) {
  const int k = __ldg(key + i);
  if (k >= 0 && k < n_groups) atomicAdd(hist + k, 1);
}

__global__ void __launch_bounds__(THREADS)
group_counts_kernel(const uint8_t* __restrict__ needs,
                    const int* __restrict__ key, long long n, int n_groups,
                    bool aligned, int* __restrict__ out) {
  __shared__ int hist[MAX_GROUPS];
  for (int g = threadIdx.x; g < n_groups; g += THREADS) hist[g] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (aligned) {
    const long long n4 = n / 4;
    const uint32_t* needs4 = reinterpret_cast<const uint32_t*>(needs);
    for (long long q = t; q < n4; q += stride) {
      const uint32_t w = __ldg(needs4 + q);
      if (w == 0) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((w >> (8 * b)) & 0xffu) count(key, 4 * q + b, n_groups, hist);
      }
    }
    for (long long i = 4 * n4 + t; i < n; i += stride) {
      if (__ldg(needs + i)) count(key, i, n_groups, hist);
    }
  } else {
    for (long long i = t; i < n; i += stride) {
      if (__ldg(needs + i)) count(key, i, n_groups, hist);
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n_groups; g += THREADS) {
    if (hist[g] != 0) atomicAdd(out + g, hist[g]);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). needs: n bools (one byte
// each, 0 or 1); key: n int32; out: n_groups int32, cleared here on
// `stream` and then counted into. n_groups in [1, 64]. Launches on
// `stream`, does not synchronise, allocates nothing, and returns a CUDA
// error code (0: launched).
extern "C" int group_counts_launch(const void* needs, const void* key,
                                   long long n, int n_groups, void* out,
                                   int sms, void* stream) {
  if (out == nullptr || n < 0 || n_groups < 1 || n_groups > MAX_GROUPS ||
      (n > 0 && (needs == nullptr || key == nullptr)) || sms < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * n_groups,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess || n == 0) return (int)err;
  const long long blocks_needed = (n + 4LL * THREADS - 1) / (4LL * THREADS);
  const int blocks = (int)(blocks_needed < 4LL * sms ? blocks_needed
                                                      : 4LL * sms);
  const bool aligned = reinterpret_cast<uintptr_t>(needs) % 4 == 0;
  group_counts_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(needs), static_cast<const int*>(key), n,
      n_groups, aligned, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
