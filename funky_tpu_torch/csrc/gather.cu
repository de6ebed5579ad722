// Row gather for Hopper (sm_90a): out[i] = table[normalise(idx[i])], for
// rows of any byte width. The frame's row gather: ops/sampling.py::
// take_rows launches it for every CUDA table (the samplers' quad rows, the
// compactions' masks and keys, the deferred pass's fused 184-byte rows).
//
// Replaces the TPU row-gather probes of experiments/ (bench_gather.py
// vmem_gather/dma_gather, pallas_gather_bisect*.py gather_*,
// pallas_gather_retest.py): all of them compute out[i] = table[idx[i]] with
// int32 indices. Index semantics are take_rows': a negative index counts
// from the end, then the index is clamped into [0, N).
//
// What bounds it on this card: bytes. Per row it reads a 4-byte index and
// one table row and writes the row; a random row costs at least a 32-byte
// sector from device memory unless L2 (50 MB) still holds it. The
// samplers' neighbouring pixels read neighbouring texels, so most rows are
// read many times and the bound counts each distinct row once.
//
// Design (each choice measured by chip_smoke.py on the tap set and on
// whole frames; PERF.md has the alternatives that lost):
// - The kernel moves copy units of U bytes: the largest of 16/8/4/2/1 that
//   divides the row size and both base addresses. A row is K = row/U
//   units, and consecutive threads copy consecutive units of the output
//   (coalesced) whatever K is; for K > 1 a run of K lanes copies one row.
// - The m rows are cut into S slices of equal length. A thread owns one
//   unit position and copies it in every slice, R = 4 slices at a time:
//   all R index loads, then all R table loads, then all R stores, so four
//   independent rows are in flight instead of one dependent pair. When
//   the index's leading axis holds a few taps ((16, H, W) PCF taps, (16,
//   N) pair taps) the slices are the taps: the 16 taps of a pixel, which
//   read overlapping texels, go through one thread and one SM's L1, and
//   fewer sector requests reach L2, whose request rate bounds a gather of
//   16-byte rows. Any other index is cut into R slices.
// - Cache hints: the table loads carry an L2 evict_last policy, the index
//   loads and the output stores stream (evict first), so the write stream
//   does not push out the table rows that neighbouring pixels read again.
// - One block per 256 unit positions of a slice. The index is normalised
//   in the kernel, on int32, so take_rows issues one launch and no index
//   arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int R = 4;   // rows in flight per thread

template <int U> struct UnitOf;
template <> struct UnitOf<16> { typedef uint4 T; };
template <> struct UnitOf<8> { typedef uint2 T; };
template <> struct UnitOf<4> { typedef unsigned int T; };
template <> struct UnitOf<2> { typedef unsigned short T; };
template <> struct UnitOf<1> { typedef unsigned char T; };

__device__ __forceinline__ long long normalise(int i, long long n) {
  const long long j = i < 0 ? (long long)i + n : (long long)i;
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// Table loads through the read-only path with an L2 cache policy.
__device__ __forceinline__ uint4 load_kept(const uint4* p, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint2 load_kept(const uint2* p, uint64_t pol) {
  uint2 v;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned int load_kept(const unsigned int* p,
                                                  uint64_t pol) {
  unsigned int v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned short load_kept(const unsigned short* p,
                                                    uint64_t pol) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
      : "=h"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned char load_kept(const unsigned char* p,
                                                   uint64_t pol) {
  unsigned short v;   // a u8 load into a 16-bit register, zero-extended
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;"
      : "=h"(v) : "l"(p), "l"(pol));
  return (unsigned char)v;
}

// table: n_rows rows of k units; idx and out: m rows, cut into `slices`
// slices of slice_rows rows (the last one may be short); a block copies
// THREADS unit positions of every slice.
template <int U>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const typename UnitOf<U>::T* __restrict__ table,
                  long long n_rows, unsigned k,
                  const int* __restrict__ idx, long long m, int slices,
                  long long slice_rows,
                  typename UnitOf<U>::T* __restrict__ out) {
  typedef typename UnitOf<U>::T T;
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= slice_rows * k) return;
  const uint64_t policy = evict_last_policy();
  const long long row_in = k == 1 ? q
      : (q <= 0xffffffffLL ? (long long)((unsigned)q / k) : q / k);
  const unsigned u = (unsigned)(q - row_in * k);   // the unit in its row
  for (int b0 = 0; b0 < slices; b0 += R) {
    long long row[R];
    bool ok[R];
    int id[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      row[r] = (long long)(b0 + r) * slice_rows + row_in;
      ok[r] = b0 + r < slices && row[r] < m;
      id[r] = ok[r] ? __ldcs(idx + row[r]) : 0;
    }
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (ok[r]) v[r] = load_kept(table + normalise(id[r], n_rows) * k + u,
                                  policy);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (ok[r]) __stcs(out + row[r] * k + u, v[r]);
    }
  }
}

template <int U>
cudaError_t launch(const void* table, long long n_rows, unsigned k,
                   const int* idx, long long m, int slices, void* out,
                   cudaStream_t stream) {
  typedef typename UnitOf<U>::T T;
  if (slices == 0) slices = R;   // no tap axis: R slices of the flat rows
  const long long slice_rows = (m + slices - 1) / slices;
  const long long blocks = (slice_rows * k + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_gather_kernel<U><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(table), n_rows, k, idx, m, slices, slice_rows,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). table: n_rows contiguous rows of
// row_bytes; idx: m contiguous int32; out: m rows of row_bytes. The copy
// unit is the largest of 16/8/4/2/1 bytes that divides row_bytes and the
// table's and out's addresses; idx must be 4-byte aligned. slices: the
// length of the index's leading tap axis (it divides m), or 0 for none.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns a CUDA error code (0: launched, or nothing to do).
extern "C" int row_gather_launch(const void* table, long long n_rows,
                                 long long row_bytes, const int* idx,
                                 long long m, int slices, void* out,
                                 void* stream) {
  if (n_rows <= 0 || row_bytes <= 0 || m < 0 || table == nullptr ||
      out == nullptr || reinterpret_cast<uintptr_t>(idx) % 4 != 0 ||
      slices < 0 || (slices > 0 && m % slices != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)row_bytes;
  int unit = 16;
  while (bits % unit) unit /= 2;
  const long long k = row_bytes / unit;
  if (k > 0x7fffffffLL || m > 0x7fffffffffffffffLL / k) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned ku = (unsigned)k;
  switch (unit) {
    case 16: return (int)launch<16>(table, n_rows, ku, idx, m, slices, out, s);
    case 8: return (int)launch<8>(table, n_rows, ku, idx, m, slices, out, s);
    case 4: return (int)launch<4>(table, n_rows, ku, idx, m, slices, out, s);
    case 2: return (int)launch<2>(table, n_rows, ku, idx, m, slices, out, s);
    default: return (int)launch<1>(table, n_rows, ku, idx, m, slices, out, s);
  }
}
