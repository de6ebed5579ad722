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
// (2.76 MB at 1080p, two cascades per pixel), and the int32 key only of
// a needed entry, a few percent of the pairs: ~0.001 ms at 3.35 TB/s
// (5 B per entry, ~0.004 ms, if every key were read). The atomics are as
// few as the needed entries.
//
// Design: one launch and no memset. Each thread reads `needs` 16 entries
// at a time (one 16-byte load; a scalar head up to the first 16-byte
// boundary and a scalar tail), then the keys of the needed ones among
// them, all 16 loads issued before the first count (the needed pairs come
// in runs, so a thread often needs all 16, and loads interleaved with the
// counts would wait one after another); the grid is sized so that the
// 1080p pairs are one wave of such loads. Each block counts into a
// shared-memory histogram, adds each nonzero bin to a persistent
// accumulator with one global atomicAdd (one 128-byte line per bin, so
// the bins' atomics do not queue on one line), and takes a ticket after a
// __threadfence(). The block that takes the last ticket copies the
// accumulators to `out` and zeroes them and the ticket, so the next
// launch, eager or in a replayed CUDA graph, starts from zero. No value
// is read on the host, so the launch records inside a CUDA graph as one
// kernel node.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GROUPS = 64;
constexpr int VEC = 16;   // entries per 16-byte load of `needs`
constexpr int BIN_STRIDE = 32;   // ints between two accumulators: 128 B
constexpr int TICKET = MAX_GROUPS * BIN_STRIDE;

__device__ __forceinline__ void count(const int* __restrict__ key,
                                      long long i, int n_groups, int* hist) {
  const int k = __ldg(key + i);
  if (k >= 0 && k < n_groups) atomicAdd(hist + k, 1);
}

// acc: MAX_GROUPS accumulators BIN_STRIDE ints apart, then the ticket;
// all zero at launch, and left zero by the last block. `head` entries
// precede the first 16-byte boundary of needs.
__global__ void __launch_bounds__(THREADS)
group_counts_kernel(const uint8_t* __restrict__ needs,
                    const int* __restrict__ key, long long n, long long head,
                    int n_groups, int* __restrict__ acc,
                    int* __restrict__ out) {
  __shared__ int hist[MAX_GROUPS];
  __shared__ bool last;
  for (int g = threadIdx.x; g < n_groups; g += THREADS) hist[g] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n16 = (n - head) / VEC;
  const uint4* vec = reinterpret_cast<const uint4*>(needs + head);
  for (long long q = t; q < n16; q += stride) {
    const uint4 w = __ldg(vec + q);
    if ((w.x | w.y | w.z | w.w) == 0) continue;
    const long long i = head + VEC * q;
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    int k[VEC];
#pragma unroll
    for (int b = 0; b < VEC; ++b) {   // the needed entries' keys, in flight
      k[b] = ((words[b >> 2] >> (8 * (b & 3))) & 0xffu) ? __ldg(key + i + b)
                                                        : -1;
    }
#pragma unroll
    for (int b = 0; b < VEC; ++b) {
      if (k[b] >= 0 && k[b] < n_groups) atomicAdd(hist + k[b], 1);
    }
  }
  // the head and the tail, fewer than 2 * VEC entries, one a thread
  const long long tail = head + VEC * n16;
  if (t < head + (n - tail)) {
    const long long i = t < head ? t : tail + (t - head);
    if (__ldg(needs + i)) count(key, i, n_groups, hist);
  }
  __syncthreads();
  if (threadIdx.x < n_groups) {   // n_groups <= MAX_GROUPS < THREADS
    const int g = threadIdx.x;
    if (hist[g] != 0) atomicAdd(acc + g * BIN_STRIDE, hist[g]);
    __threadfence();   // this block's sums before its ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = reinterpret_cast<unsigned*>(acc + TICKET);
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every other block has added its bins: hand them out and reset
  if (threadIdx.x < n_groups) {
    out[threadIdx.x] = atomicExch(acc + threadIdx.x * BIN_STRIDE, 0);
  }
  if (threadIdx.x == 0) atomicExch(acc + TICKET, 0);
}

}  // namespace

// Plain C entry point (loaded with ctypes). needs: n bools (one byte
// each, 0 or 1); key: n int32; acc: MAX_GROUPS * BIN_STRIDE + 1 int32,
// zero at the call and left zero (the accumulators and the ticket, kept
// by the caller across calls; no two launches that share it may
// overlap); out: n_groups int32, every value written. n_groups in
// [1, 64]; at most max_blocks blocks. Launches one kernel on `stream`,
// does not synchronise, allocates nothing, and returns a CUDA error code
// (0: launched).
extern "C" int group_counts_launch(const void* needs, const void* key,
                                   long long n, int n_groups, void* acc,
                                   void* out, int max_blocks,
                                   void* stream) {
  if (out == nullptr || acc == nullptr || n < 0 || n_groups < 1 ||
      n_groups > MAX_GROUPS || (n > 0 && (needs == nullptr ||
                                          key == nullptr)) ||
      max_blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long misaligned = reinterpret_cast<uintptr_t>(needs) % VEC;
  const long long head = n < (VEC - misaligned) % VEC
                             ? n : (VEC - misaligned) % VEC;
  const long long vectors = (n - head) / VEC;
  const long long blocks_needed = (vectors + THREADS - 1) / THREADS;
  const int blocks = (int)(blocks_needed < 1 ? 1
                           : blocks_needed < max_blocks ? blocks_needed
                                                        : max_blocks);
  group_counts_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(needs), static_cast<const int*>(key), n,
      head, n_groups, static_cast<int*>(acc), static_cast<int*>(out));
  return (int)cudaGetLastError();
}
