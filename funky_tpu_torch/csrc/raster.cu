// Tile raster for Hopper (sm_90a): depth-tested visibility buffer. Two
// entry points, one per TPU kernel of funky_tpu/ops/raster_pallas.py:
//
// K1 raster_table_launch replaces _rasterize_pallas_table (body
//    _raster_table_kernel): for every framebuffer tile, walk the tile's bin
//    list in order, read each triangle's setup row from the (T, 16) table by
//    id, and keep the nearest covering triangle per pixel.
// K2 raster_padded_launch replaces _rasterize_pallas_padded (body
//    _raster_kernel): the same raster over the pre-gathered per-tile row
//    stream (n_tiles, C, 16) of binning.gather_bin_data, with the triangle
//    id bitcast into column 12. The JAX package (and ops/raster.py) takes
//    it when the setup table exceeds 4 MiB.
//
// Semantics (identical to the Pallas kernel and to the plain torch twin
// funky_tpu_torch/ops/raster.py::_rasterize_torch):
//   - pixel centres px = x + 0.5, py = y + 0.5 + y_offset (global rows);
//   - b_i = a_i*px + b_i*py + c_i for the three edge planes, z likewise;
//   - covered iff all b_i >= 0, 0 <= z < zbuf and i < min(count, C);
//   - depth test LESS against a clear of 1.0; ties keep the first-drawn id;
//   - outputs: id (-1 where empty) and depth (1.0 where empty).
//
// Arithmetic: every plane is evaluated as
//   __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c)
// i.e. JAX's association with no FMA contraction, which is exactly what
// eager torch computes op by op. The kernel is therefore bit-equal to its
// plain twin on the card.
//
// What bounds it on this card: per bin entry, one 48-byte row fetch that
// every thread of the tile needs (L2 traffic if each thread read it), and
// ~16 ALU ops per pixel. Design against that:
//   - threads own pixels and keep z and id in registers; the serial loop
//     over the bin list runs per thread, so no atomics are needed and the
//     first-drawn tie rule holds by construction;
//   - rows are staged through shared memory in chunks of RASTER_THREADS
//     entries: each thread loads one row, then all threads read it as a
//     broadcast, so each row leaves L2 once per block, not once per pixel;
//   - each tile is split over several blocks (one pixel per thread), so a
//     frame with few large tiles (the 128x256 shadow tiles of a 2048^2
//     cascade: 128 tiles) still launches thousands of blocks for 132 SMs.
// No TPU tuning is carried over (VMEM budget, 8-wide unroll).
// Measured on an H100 SXM (700 W limit), multimesh scene: 0.031 ms per
// 2048^2 cascade and 0.030 ms for the 1080p main pass. At that size the
// 8 bytes written per pixel dominate (32 MB in 31 us, about a third of
// HBM bandwidth); the row fetches and plane ALU only matter for scenes
// with long bins.

#include <cuda_runtime.h>

namespace {

constexpr int RASTER_THREADS = 256;
constexpr int ROW = 12;        // setup columns the raster reads: 9 bary + 3 z
constexpr int SETUP_WIDTH = 16;

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__global__ void __launch_bounds__(RASTER_THREADS)
raster_table_kernel(const float* __restrict__ table, int t_rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ counts, int capacity,
                    int y_offset, int tile_h, int tile_w, int tiles_x,
                    int blocks_per_tile, int height, int width,
                    int* __restrict__ id_out, float* __restrict__ z_out) {
  __shared__ float s_rows[RASTER_THREADS][ROW];
  __shared__ int s_ids[RASTER_THREADS];

  const int tile = blockIdx.x / blocks_per_tile;
  const int part = blockIdx.x - tile * blocks_per_tile;
  const int local = part * RASTER_THREADS + threadIdx.x;
  const int ly = local / tile_w;
  const int lx = local - ly * tile_w;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int gy = ty * tile_h + ly;   // row within this slice
  const int gx = tx * tile_w + lx;
  const bool live = local < tile_h * tile_w && gy < height && gx < width;

  // Pixel centres are small integers + 0.5: exact in f32 in any order.
  const float px = (float)gx + 0.5f;
  const float py = (float)(gy + y_offset) + 0.5f;

  float zbuf = 1.0f;
  int idbuf = -1;
  const int count = min(counts[tile], capacity);
  const int* tile_bins = bins + (size_t)tile * capacity;

  for (int base = 0; base < count; base += RASTER_THREADS) {
    const int n = min(RASTER_THREADS, count - base);
    __syncthreads();  // previous chunk fully consumed
    if (threadIdx.x < n) {
      const int tid = tile_bins[base + threadIdx.x];
      // Clamped read, as the Pallas kernel reads max(bins, 0).
      const int row = min(max(tid, 0), t_rows - 1);
      const float* src = table + (size_t)row * SETUP_WIDTH;
#pragma unroll
      for (int j = 0; j < ROW; ++j) s_rows[threadIdx.x][j] = __ldg(src + j);
      s_ids[threadIdx.x] = tid;
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) {
        const float* d = s_rows[k];
        const float b0 = plane(d[0], d[1], d[2], px, py);
        const float b1 = plane(d[3], d[4], d[5], px, py);
        const float b2 = plane(d[6], d[7], d[8], px, py);
        const float z = plane(d[9], d[10], d[11], px, py);
        if (b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f && z >= 0.0f &&
            z < zbuf) {
          zbuf = z;
          idbuf = s_ids[k];
        }
      }
    }
  }
  if (live) {
    const size_t o = (size_t)gy * width + gx;
    id_out[o] = idbuf;
    z_out[o] = zbuf;
  }
}

// K2: the same pixel loop, fed from the tile's contiguous pre-gathered
// rows. What bounds it: each tile's C x 64 B row block is read once per
// block of the tile (L2 serves the repeats) plus 8 B written per pixel, or
// ~16 FP32 operations per pixel and row when bins are long. Design: each
// chunk of RASTER_THREADS rows is staged in shared memory with 16-byte
// loads (thread k loads row k: four float4, so a warp reads 2 KB of
// contiguous rows), then every thread reads the staged rows as
// broadcasts. Arithmetic and tie rule as K1, so it is bit-equal to the
// plain twin.
__global__ void __launch_bounds__(RASTER_THREADS)
raster_padded_kernel(const float* __restrict__ rows,
                     const int* __restrict__ counts, int capacity,
                     int y_offset, int tile_h, int tile_w, int tiles_x,
                     int blocks_per_tile, int height, int width,
                     int* __restrict__ id_out, float* __restrict__ z_out) {
  __shared__ float s_rows[RASTER_THREADS][ROW];
  __shared__ int s_ids[RASTER_THREADS];

  const int tile = blockIdx.x / blocks_per_tile;
  const int part = blockIdx.x - tile * blocks_per_tile;
  const int local = part * RASTER_THREADS + threadIdx.x;
  const int ly = local / tile_w;
  const int lx = local - ly * tile_w;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int gy = ty * tile_h + ly;
  const int gx = tx * tile_w + lx;
  const bool live = local < tile_h * tile_w && gy < height && gx < width;

  const float px = (float)gx + 0.5f;
  const float py = (float)(gy + y_offset) + 0.5f;

  float zbuf = 1.0f;
  int idbuf = -1;
  const int count = min(counts[tile], capacity);
  const float4* tile_rows = reinterpret_cast<const float4*>(
      rows + (size_t)tile * capacity * SETUP_WIDTH);

  for (int base = 0; base < count; base += RASTER_THREADS) {
    const int n = min(RASTER_THREADS, count - base);
    __syncthreads();  // previous chunk fully consumed
    if (threadIdx.x < n) {
      const float4* src = tile_rows + (size_t)(base + threadIdx.x) * 4;
      const float4 a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + 2),
                   d = __ldg(src + 3);
      float* dst = s_rows[threadIdx.x];
      dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
      dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
      dst[8] = c.x; dst[9] = c.y; dst[10] = c.z; dst[11] = c.w;
      s_ids[threadIdx.x] = __float_as_int(d.x);   // id bitcast in column 12
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) {
        const float* e = s_rows[k];
        const float b0 = plane(e[0], e[1], e[2], px, py);
        const float b1 = plane(e[3], e[4], e[5], px, py);
        const float b2 = plane(e[6], e[7], e[8], px, py);
        const float z = plane(e[9], e[10], e[11], px, py);
        if (b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f && z >= 0.0f &&
            z < zbuf) {
          zbuf = z;
          idbuf = s_ids[k];
        }
      }
    }
  }
  if (live) {
    const size_t o = (size_t)gy * width + gx;
    id_out[o] = idbuf;
    z_out[o] = zbuf;
  }
}

int blocks_for(int n_tiles, int tile_h, int tile_w, int* blocks_per_tile,
               unsigned* grid) {
  *blocks_per_tile = (tile_h * tile_w + RASTER_THREADS - 1) / RASTER_THREADS;
  const long long blocks = (long long)n_tiles * *blocks_per_tile;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return 0;
  *grid = (unsigned)blocks;
  return 1;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int raster_table_launch(const float* table, int t_rows,
                                   const int* bins, const int* counts,
                                   int n_tiles, int capacity, int y_offset,
                                   int tile_h, int tile_w, int tiles_x,
                                   int height, int width, int* id_out,
                                   float* z_out, void* stream) {
  int blocks_per_tile;
  unsigned grid;
  if (!blocks_for(n_tiles, tile_h, tile_w, &blocks_per_tile, &grid))
    return (int)cudaErrorInvalidValue;
  raster_table_kernel<<<grid, RASTER_THREADS, 0, (cudaStream_t)stream>>>(
      table, t_rows, bins, counts, capacity, y_offset, tile_h, tile_w,
      tiles_x, blocks_per_tile, height, width, id_out, z_out);
  return (int)cudaGetLastError();
}

// K2's entry point: `rows` is the contiguous (n_tiles, capacity, 16) f32
// pre-gathered stream (16-byte aligned rows). Same contract as K1's.
extern "C" int raster_padded_launch(const float* rows, const int* counts,
                                    int n_tiles, int capacity, int y_offset,
                                    int tile_h, int tile_w, int tiles_x,
                                    int height, int width, int* id_out,
                                    float* z_out, void* stream) {
  int blocks_per_tile;
  unsigned grid;
  if (!blocks_for(n_tiles, tile_h, tile_w, &blocks_per_tile, &grid))
    return (int)cudaErrorInvalidValue;
  raster_padded_kernel<<<grid, RASTER_THREADS, 0, (cudaStream_t)stream>>>(
      rows, counts, capacity, y_offset, tile_h, tile_w, tiles_x,
      blocks_per_tile, height, width, id_out, z_out);
  return (int)cudaGetLastError();
}
