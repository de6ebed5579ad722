// Row gather for Hopper (sm_90a): out[i, :] = table[clamp(idx[i]), :].
//
// Replaces the TPU row-gather probes of experiments/ (bench_gather.py
// vmem_gather/dma_gather, pallas_gather_bisect*.py gather_*,
// pallas_gather_retest.py): all of them compute out[i] = table[idx[i]] on
// an (N, w) f32 table with int32 indices. Index semantics are the port's
// take_rows (ops/sampling.py): a negative index counts from the end, then
// the index is clamped into [0, N).
//
// What bounds it on this card: bytes. Per row it reads a 4-byte index and
// one w*4-byte table row and writes w*4 bytes; a random 16-byte row costs a
// whole 32-byte sector from device memory once the table exceeds L2
// (50 MB). Design: one thread per row, and for w = 4 one 16-byte load and
// one 16-byte store per thread (neighbouring threads write neighbouring
// rows, so the stores coalesce); other widths copy element by element.
// Nothing is staged: there is no reuse to exploit inside a block.

#include <cuda_runtime.h>

namespace {

constexpr int GATHER_THREADS = 256;

__device__ __forceinline__ long long clamp_index(int i, long long n) {
  long long j = i < 0 ? (long long)i + n : (long long)i;
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

__global__ void __launch_bounds__(GATHER_THREADS)
row_gather_f4(const float4* __restrict__ table, long long n_rows,
              const int* __restrict__ idx, long long m,
              float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (i < m) out[i] = __ldg(table + clamp_index(__ldg(idx + i), n_rows));
}

__global__ void __launch_bounds__(GATHER_THREADS)
row_gather_any(const float* __restrict__ table, long long n_rows, int w,
               const int* __restrict__ idx, long long m,
               float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (e >= m * w) return;
  const long long i = e / w;
  const int c = (int)(e - i * w);
  out[e] = __ldg(table + clamp_index(__ldg(idx + i), n_rows) * w + c);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError(). The
// w = 4 path needs 16-byte aligned table and out.
extern "C" int row_gather_launch(const float* table, long long n_rows, int w,
                                 const int* idx, long long m, float* out,
                                 void* stream) {
  if (n_rows <= 0 || w <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  const long long work = w == 4 ? m : m * w;
  const long long blocks = (work + GATHER_THREADS - 1) / GATHER_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (w == 4) {
    row_gather_f4<<<(unsigned)blocks, GATHER_THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(table), n_rows, idx, m,
        reinterpret_cast<float4*>(out));
  } else {
    row_gather_any<<<(unsigned)blocks, GATHER_THREADS, 0, s>>>(
        table, n_rows, w, idx, m, out);
  }
  return (int)cudaGetLastError();
}
