// Tile raster for Hopper (sm_90a): depth-tested visibility buffer.
//
// Replaces the TPU kernel funky_tpu/ops/raster_pallas.py::_rasterize_pallas_table
// (body _raster_table_kernel): for every framebuffer tile, walk the tile's
// bin list in order, read each triangle's setup row from the (T, 16) table
// by id, and keep the nearest covering triangle per pixel.
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

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int raster_table_launch(const float* table, int t_rows,
                                   const int* bins, const int* counts,
                                   int n_tiles, int capacity, int y_offset,
                                   int tile_h, int tile_w, int tiles_x,
                                   int height, int width, int* id_out,
                                   float* z_out, void* stream) {
  const int tile_pixels = tile_h * tile_w;
  const int blocks_per_tile = (tile_pixels + RASTER_THREADS - 1) /
                              RASTER_THREADS;
  const long long blocks = (long long)n_tiles * blocks_per_tile;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  raster_table_kernel<<<(unsigned)blocks, RASTER_THREADS, 0,
                        (cudaStream_t)stream>>>(
      table, t_rows, bins, counts, capacity, y_offset, tile_h, tile_w,
      tiles_x, blocks_per_tile, height, width, id_out, z_out);
  return (int)cudaGetLastError();
}
