// Tile binning for Hopper (sm_90a): the per-tile triangle lists the raster
// kernels (csrc/raster.cu) walk.
//
// K12 bin_launch replaces the JAX package's funky_tpu/ops/binning.py::
// bin_triangles (:150-200), which XLA runs on the TPU as a dense
// (T, n_tiles) mask and a sort of T keys per tile. Its plain twin is
// funky_tpu_torch/ops/binning.py::bin_triangles, the same mask and sort in
// torch: at the 74,880-row main pass over 510 tiles that is 38.2 M keys,
// and 9.45 M per 2048^2 cascade, to produce lists whose real entries are a
// small fraction of them.
//
// Semantics (identical to the twin): triangle i lies in tile (tx, ty) of
// the slab iff setup.valid[i] and
//   floor(x0 / tile_w) <= tx <= floor((x1 - 1e-6) / tile_w),
//   floor(y0 / tile_h) <= ty + ty_off <= floor((y1 - 1e-6) / tile_h),
// with (x0, y0, x1, y1) the row's AABB (columns 12-15), every operation in
// f32 with round-to-nearest (__fdiv_rn, __fsub_rn: no reciprocal, no
// contraction), each floor converted as XLA converts f32 to s32 (NaN -> 0,
// saturating), and ty_off = y_offset // tile_h the slab's first tile row.
// bins[tile] holds the tile's ids in ascending order, the first `capacity`
// of them, then -1; counts[tile] = min(total, capacity); the entries past
// the capacity, summed over the tiles, are added to the int64 `drops`.
//
// What bounds it on this card: the bytes. The AABB columns are read (16 B
// a row) and the bins written with their -1 fill: at the rastered frame's
// five rasters (74,880 rows over 510 tiles of 2,048 slots, four times
// 73,856 rows over 128 tiles of 13,184) about 37 MB, 0.011 ms at
// 3.35 TB/s. No step may depend on the order of an atomic: the lists are
// ordered by id.
//
// Design: a warp owns a chunk of 128 consecutive ids (4 a lane, id
// chunk * 128 + k * 32 + lane), and works on the union of its triangles'
// tile rectangles, a tile at a time: one ballot per k says which of the
// chunk's triangles cover the tile, so popc gives the tile's count in the
// chunk and, below a lane, its rank among them in id order. Three kernels:
//   - count: each warp writes its chunk's row of a (chunks, n_tiles)
//     table, the counts in its union and 0 elsewhere (no memset);
//   - scan: a block per 32 tiles, its warps on consecutive row segments,
//     turns each column into exclusive offsets in place, and writes counts
//     and the drops (one integer atomicAdd a warp);
//   - scatter: each warp walks its union again and stores each id at its
//     offset plus rank where that is below the capacity; further blocks
//     fill each tile's slots from its count to the capacity with -1.
// The count-only mode (the tune's occupancy) runs the first two kernels
// and writes no offsets.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int PER_LANE = 4;                 // ids a lane holds
constexpr int CHUNK = 32 * PER_LANE;        // ids a warp owns
constexpr int WARPS = 4;                    // warps of a count or scatter block
constexpr int SCAN_WARPS = 32;              // row segments of a scan block
constexpr int SCAN_BATCH = 8;               // rows a lane loads at once
constexpr int FILL_THREADS = WARPS * 32;
constexpr int FILL_SPAN = 4096;             // slots a fill block writes at most
constexpr int SETUP_WIDTH = 16;

struct Grid {
  float tile_w, tile_h;
  int tiles_x, tiles_y, ty_off;
};

// An inclusive rectangle of slab tiles; empty where x0 > x1 or y0 > y1.
struct Rect {
  int x0, x1, y0, y1;
};

// XLA's f32 -> s32 conversion of an integral value: NaN -> 0, saturating.
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return (int)x;
}

__device__ __forceinline__ Rect tile_rect(const float* __restrict__ data,
                                          const unsigned char* __restrict__ valid,
                                          int i, int t, const Grid& g) {
  Rect r = {0, -1, 0, -1};
  if (i >= t || !valid[i]) return r;
  const float* a = data + (size_t)i * SETUP_WIDTH + 12;
  const float ax0 = __ldg(a), ay0 = __ldg(a + 1);
  const float ax1 = __ldg(a + 2), ay1 = __ldg(a + 3);
  const int tx0 = to_i32(floorf(__fdiv_rn(ax0, g.tile_w)));
  const int ty0 = to_i32(floorf(__fdiv_rn(ay0, g.tile_h)));
  const int tx1 = to_i32(floorf(__fdiv_rn(__fsub_rn(ax1, 1e-6f), g.tile_w)));
  const int ty1 = to_i32(floorf(__fdiv_rn(__fsub_rn(ay1, 1e-6f), g.tile_h)));
  r.x0 = max(tx0, 0);
  r.x1 = min(tx1, g.tiles_x - 1);
  // In slab rows, in 64 bits: ty0 and ty1 may be saturated.
  const long long y0 = (long long)ty0 - g.ty_off;
  const long long y1 = (long long)ty1 - g.ty_off;
  r.y0 = (int)min(max(y0, 0LL), (long long)g.tiles_y);
  r.y1 = (int)max(min(y1, (long long)g.tiles_y - 1), -1LL);
  return r;
}

__device__ __forceinline__ bool covers(const Rect& r, int tx, int ty) {
  return r.x0 <= tx && tx <= r.x1 && r.y0 <= ty && ty <= r.y1;
}

// The warp's chunk: each lane's PER_LANE rectangles and the union of all
// of them over the warp (warp-uniform; empty where no triangle is binned).
struct Chunk {
  Rect r[PER_LANE];
  Rect u;
};

__device__ __forceinline__ Chunk load_chunk(const float* __restrict__ data,
                                            const unsigned char* __restrict__ valid,
                                            int t, int chunk, int lane,
                                            const Grid& g) {
  Chunk c;
  int x0 = INT_MAX, x1 = INT_MIN, y0 = INT_MAX, y1 = INT_MIN;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    c.r[k] = tile_rect(data, valid, chunk * CHUNK + k * 32 + lane, t, g);
    if (c.r[k].x0 <= c.r[k].x1 && c.r[k].y0 <= c.r[k].y1) {
      x0 = min(x0, c.r[k].x0);
      x1 = max(x1, c.r[k].x1);
      y0 = min(y0, c.r[k].y0);
      y1 = max(y1, c.r[k].y1);
    }
  }
  c.u.x0 = __reduce_min_sync(0xffffffffu, x0);
  c.u.x1 = __reduce_max_sync(0xffffffffu, x1);
  c.u.y0 = __reduce_min_sync(0xffffffffu, y0);
  c.u.y1 = __reduce_max_sync(0xffffffffu, y1);
  return c;
}

__global__ void __launch_bounds__(WARPS * 32)
bin_count_kernel(const float* __restrict__ data,
                 const unsigned char* __restrict__ valid, int t, Grid g,
                 int n_tiles, int n_chunks, int* __restrict__ table) {
  const int chunk = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const Chunk c = load_chunk(data, valid, t, chunk, lane, g);
  int* row = table + (size_t)chunk * n_tiles;
  for (int ty = c.u.y0; ty <= c.u.y1; ++ty) {
    for (int tx = c.u.x0; tx <= c.u.x1; ++tx) {
      int n = 0;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k)
        n += __popc(__ballot_sync(0xffffffffu, covers(c.r[k], tx, ty)));
      if (lane == 0) row[ty * g.tiles_x + tx] = n;
    }
  }
  for (int x = lane; x < n_tiles; x += 32) {
    const int ty = x / g.tiles_x;
    if (!covers(c.u, x - ty * g.tiles_x, ty)) row[x] = 0;
  }
}

// A block per 32 tiles (a lane each); warp w sums, then offsets, the rows
// of segment w, the segments in chunk order. Each lane loads SCAN_BATCH
// rows before it uses any, so a pass waits on L2 once a batch.
__global__ void __launch_bounds__(SCAN_WARPS * 32)
bin_scan_kernel(int* __restrict__ table, int n_chunks, int n_tiles,
                int capacity, int write_offsets, int* __restrict__ counts,
                unsigned long long* __restrict__ drops) {
  __shared__ int s_sum[SCAN_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * 32 + lane;
  const bool live = x < n_tiles;
  const int seg = (n_chunks + SCAN_WARPS - 1) / SCAN_WARPS;
  const int c0 = min(warp * seg, n_chunks);
  const int c1 = min(c0 + seg, n_chunks);
  int* col = table + x;
  int sum = 0;
  for (int c = c0; live && c < c1; c += SCAN_BATCH) {
    int v[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      v[k] = c + k < c1 ? col[(size_t)(c + k) * n_tiles] : 0;
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k) sum += v[k];
  }
  s_sum[warp][lane] = sum;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < SCAN_WARPS; ++w) {
    const int v = s_sum[w][lane];
    base += w < warp ? v : 0;
    total += v;
  }
  int off = base;
  for (int c = c0; live && write_offsets && c < c1; c += SCAN_BATCH) {
    int v[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      v[k] = c + k < c1 ? col[(size_t)(c + k) * n_tiles] : 0;
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k) {
      if (c + k < c1) col[(size_t)(c + k) * n_tiles] = off;
      off += v[k];
    }
  }
  if (warp != 0) return;
  if (live) counts[x] = min(total, capacity);
  if (drops != nullptr) {
    unsigned long long d =
        live && total > capacity ? (unsigned long long)(total - capacity) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(0xffffffffu, d, o);
    if (lane == 0 && d != 0) atomicAdd(drops, d);
  }
}

// Blocks [0, scatter_blocks): a warp a chunk, ids to their slots. Then a
// block per (tile, span of FILL_SPAN slots): -1 from the tile's count on.
__global__ void __launch_bounds__(WARPS * 32)
bin_scatter_kernel(const float* __restrict__ data,
                   const unsigned char* __restrict__ valid, int t, Grid g,
                   int n_tiles, int n_chunks, int scatter_blocks,
                   int fill_spans, const int* __restrict__ table,
                   const int* __restrict__ counts, int capacity,
                   int* __restrict__ bins) {
  if ((int)blockIdx.x >= scatter_blocks) {
    const int f = blockIdx.x - scatter_blocks;
    const int x = f / fill_spans;
    const int s = f - x * fill_spans;
    const int lo = max(counts[x], s * FILL_SPAN);
    const int hi = min(capacity, (s + 1) * FILL_SPAN);
    int* row = bins + (size_t)x * capacity;
    for (int j = lo + threadIdx.x; j < hi; j += FILL_THREADS) row[j] = -1;
    return;
  }
  const int chunk = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const Chunk c = load_chunk(data, valid, t, chunk, lane, g);
  const int* offs = table + (size_t)chunk * n_tiles;
  for (int ty = c.u.y0; ty <= c.u.y1; ++ty) {
    for (int tx = c.u.x0; tx <= c.u.x1; ++tx) {
      unsigned b[PER_LANE];
      unsigned any = 0;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        b[k] = __ballot_sync(0xffffffffu, covers(c.r[k], tx, ty));
        any |= b[k];
      }
      if (any == 0) continue;
      const int tile = ty * g.tiles_x + tx;
      int rank = offs[tile];
      if (rank >= capacity) continue;
      int* row = bins + (size_t)tile * capacity;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        if ((b[k] >> lane) & 1u) {
          const int q = rank + __popc(b[k] & below);
          if (q < capacity) row[q] = chunk * CHUNK + k * 32 + lane;
        }
        rank += __popc(b[k]);
      }
    }
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

// The ids a warp owns: the wrapper sizes the table by it.
extern "C" int bin_chunk_ids(void) { return CHUNK; }

// Plain C entry point (loaded with ctypes). data: (t, 16) f32 setup rows,
// contiguous; valid: t bytes (0 / 1); the slab's grid of tiles_x x tiles_y
// tiles of tile_w x tile_h, its first tile row ty_off = y_offset // tile_h.
// table: ceil(t / 128) x tiles_x * tiles_y int32 scratch, left holding the
// offsets; counts: the tiles' int32 counts, clamped to `capacity`.
// lists: 1 to write bins, tiles x capacity int32; 0 for the counts alone
// (bins unused). drops: an int64 the dropped entries are added to, or
// null. Launches two or three kernels on
// `stream`, does not synchronise, allocates nothing, and returns a CUDA
// error code (0: launched).
extern "C" int bin_launch(const float* data, const unsigned char* valid,
                          int t, int tiles_x, int tiles_y, int ty_off,
                          int tile_h, int tile_w, int capacity, int lists,
                          int* table, int* counts, int* bins,
                          long long* drops, void* stream) {
  const long long n_tiles = (long long)tiles_x * tiles_y;
  if (t < 0 || tiles_x < 1 || tiles_y < 1 || tile_h < 1 || tile_w < 1 ||
      capacity < 0 || n_tiles > INT_MAX || counts == nullptr ||
      (t > 0 && (data == nullptr || valid == nullptr || table == nullptr)) ||
      (lists && capacity > 0 && bins == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const Grid g = {(float)tile_w, (float)tile_h, tiles_x, tiles_y, ty_off};
  const int n_chunks = ceil_div(t, CHUNK);
  const int chunk_blocks = ceil_div(n_chunks, WARPS);
  if (n_chunks > 0) {
    bin_count_kernel<<<chunk_blocks, WARPS * 32, 0, s>>>(
        data, valid, t, g, (int)n_tiles, n_chunks, table);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  bin_scan_kernel<<<ceil_div(n_tiles, 32), SCAN_WARPS * 32, 0, s>>>(
      table, n_chunks, (int)n_tiles, capacity, lists, counts,
      reinterpret_cast<unsigned long long*>(drops));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !lists || capacity == 0) return (int)e;
  const int fill_spans = ceil_div(capacity, FILL_SPAN);
  const long long blocks = (long long)chunk_blocks + n_tiles * fill_spans;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    bin_scatter_kernel<<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        data, valid, t, g, (int)n_tiles, n_chunks, chunk_blocks, fill_spans,
        table, counts, capacity, bins);
    e = cudaGetLastError();
  }
  return (int)e;
}
