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
//    id bitcast into column 12. The JAX package takes it past a 4 MiB
//    setup table, its TPU's VMEM budget; ops/raster.py past 32 MiB
//    (TABLE_LIMIT_BYTES), since K1 reads rows by id from a table that the
//    H100's 50 MB L2 holds. Both walk the bins of K12 (csrc/binning.cu).
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
// What bounds it on this card. Unculled, every pixel of a tile tests every
// entry of the tile's bin list: 16 FP32 operations per pixel and entry,
// which on long bins (8.7k entries in a 128x256 shadow tile of a 74k
// triangle scene) is far more than the bytes. Few binned triangles touch
// any one part of a tile, so what bounds it is the FP32 work the exact
// cull below leaves (long bins) or the 8 B written per pixel (short bins).
// Measured with chip_smoke.py on an H100 80GB HBM3 (700 W power limit):
// K2 0.296 ms per frame (5 rasters) of the 74k-triangle scene against a
// culled-FP32 bound of 0.129 ms; K1 0.076 ms per frame of the multimesh
// scene against a byte bound of 0.045 ms. The rest is the serial chunk
// loop of the blocks whose tile holds the longest bins.
//
// Design against that:
//   - a block owns one rectangle of one tile (rect_h x rect_w, at most
//     1024 pixels, picked by the wrapper); each of its 256 threads owns
//     1x4 pixels along x and keeps their z and id in registers. The loop
//     over the bin list runs per thread in bin order, so no atomics are
//     needed and the first-drawn tie rule holds by construction;
//   - the tile's rows are staged in chunks of 256, double-buffered: K2 with
//     one 1-D TMA bulk copy per chunk (cp.async.bulk + mbarrier), K1 with
//     three 16-byte cp.async copies per row (columns 0-11, by id). Chunk
//     k+1 is in flight while chunk k is culled and rastered;
//   - each staged entry is culled exactly against the block's rectangle:
//     one thread per entry evaluates the kernel's own plane() at the
//     pixel-centre corner where it is largest (and z where it is smallest).
//     Round-to-nearest is monotone, so that corner value is the plane's
//     maximum over the rectangle bit for bit: an entry is dropped only if
//     no pixel of the rectangle could pass its test. A NaN corner is kept.
//     The survivors are compacted in bin order (warp ballot + popc + warp
//     offsets); each warp then culls them again against the box of its own
//     pixels (an 8x16 footprint in the frame's rectangles), one survivor
//     per lane, and rasters its hits in ascending order;
//   - the 4 pixels of a thread are stored as one int4 and one float4 where
//     the quad lies inside a framebuffer whose width is a multiple of 4.
// ops/raster.py::subtile_corners is the cull's plain twin (the CPU tests
// hold its exactness); PERF.md has the measured times and bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // threads per block = entries per chunk
constexpr int WARPS = THREADS / 32;
constexpr int SETUP_WIDTH = 16;
constexpr int STAGES = 2;      // staging buffers of THREADS rows

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// True iff no pixel centre in [x0, x1] x [y0, y1] can pass the coverage
// test of the row (r0, r1, r2) = columns 0-11. Each plane's maximum over
// the rectangle's centres is its value at one corner (z: also the minimum).
__device__ __forceinline__ bool culled(const float4& r0, const float4& r1,
                                       const float4& r2, float x0, float x1,
                                       float y0, float y1) {
  const float b0 = plane(r0.x, r0.y, r0.z, r0.x >= 0.0f ? x1 : x0,
                         r0.y >= 0.0f ? y1 : y0);
  const float b1 = plane(r0.w, r1.x, r1.y, r0.w >= 0.0f ? x1 : x0,
                         r1.x >= 0.0f ? y1 : y0);
  const float b2 = plane(r1.z, r1.w, r2.x, r1.z >= 0.0f ? x1 : x0,
                         r1.w >= 0.0f ? y1 : y0);
  const float zmax = plane(r2.y, r2.z, r2.w, r2.y >= 0.0f ? x1 : x0,
                           r2.z >= 0.0f ? y1 : y0);
  const float zmin = plane(r2.y, r2.z, r2.w, r2.y >= 0.0f ? x0 : x1,
                           r2.z >= 0.0f ? y0 : y1);
  return b0 < 0.0f || b1 < 0.0f || b2 < 0.0f || zmax < 0.0f || zmin >= 1.0f;
}

// Row staging: STAGES buffers of THREADS rows, used in turn. K2 (PADDED):
// the tile's rows are contiguous 64-byte rows, so thread 0 copies a whole
// chunk with one TMA bulk copy that completes on the buffer's mbarrier.
// K1: thread t copies columns 0-11 of its entry's table row with cp.async
// (16-byte copies where the table is 16-byte aligned, else 4-byte ones)
// and stores its id; each thread only ever reads the row it copied itself,
// so its own cp.async.wait_group suffices.
template <bool PADDED>
struct Ring;
template <>
struct Ring<true> {               // K2: whole 64-byte rows, id in column 12
  float4 rows[STAGES][THREADS][4];
  unsigned long long bars[STAGES];
};
template <>
struct Ring<false> {              // K1: columns 0-11 of the table row
  float4 rows[STAGES][THREADS][3];
  int ids[STAGES][THREADS];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

template <bool PADDED>
__global__ void __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ src, int t_rows,
              const int* __restrict__ bins, const int* __restrict__ counts,
              int capacity, int y_offset, int tile_h, int tile_w,
              int tiles_x, int rect_h, int rect_w, int rects_x,
              int rects_per_tile, int height, int width,
              int* __restrict__ id_out, float* __restrict__ z_out) {
  __shared__ __align__(128) Ring<PADDED> ring;
  __shared__ __align__(16) float4 s_surv[THREADS][3];
  __shared__ int s_sid[THREADS];
  __shared__ int s_warp[WARPS];

  const int tile = blockIdx.x / rects_per_tile;
  const int r = blockIdx.x - tile * rects_per_tile;
  const int ry = r / rects_x;
  const int rx = r - ry * rects_x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  // The block's rectangle [x0, x1) x [y0, y1) (slab rows), clipped to its
  // tile and to the framebuffer.
  const int x0 = tx * tile_w + rx * rect_w;
  const int y0 = ty * tile_h + ry * rect_h;
  const int x1 = min(min(x0 + rect_w, (tx + 1) * tile_w), width);
  const int y1 = min(min(y0 + rect_h, (ty + 1) * tile_h), height);
  if (x0 >= x1 || y0 >= y1) return;   // the whole block: nothing to draw

  // Thread -> 1x4 pixel quad. Where the rectangle is made of whole 8x16
  // pixel footprints (8 rows x 4 quads) each warp takes one, else the quads
  // go row-major; threads past the rectangle own no pixel.
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int quads_w = (rect_w + 3) >> 2;
  int qy, qx;
  if ((rect_h & 7) == 0 && (quads_w & 3) == 0) {
    const int wy = warp / (quads_w >> 2);
    qy = wy * 8 + (lane >> 2);
    qx = (warp - wy * (quads_w >> 2)) * 4 + (lane & 3);
  } else {
    qy = t / quads_w;
    qx = t - qy * quads_w;
  }
  const int gy = y0 + qy;
  const int gx = x0 + 4 * qx;
  const int n_live = gy < y1 ? max(0, min(4, x1 - gx)) : 0;

  // The warp's bounding box of live pixels, for the second cull.
  const int big = 1 << 30;
  const int wx0 = __reduce_min_sync(~0u, n_live ? gx : big);
  const int wx1 = __reduce_max_sync(~0u, n_live ? gx + n_live - 1 : -big);
  const int wy0 = __reduce_min_sync(~0u, n_live ? gy : big);
  const int wy1 = __reduce_max_sync(~0u, n_live ? gy : -big);
  const bool warp_live = wx0 <= wx1;

  // Pixel centres are small integers + 0.5: exact in f32 in any order.
  float px[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) px[k] = (float)(gx + k) + 0.5f;
  const float py = (float)(gy + y_offset) + 0.5f;
  // The extreme pixel centres of the rectangle and of the warp's box.
  const float cx0 = (float)x0 + 0.5f, cx1 = (float)(x1 - 1) + 0.5f;
  const float cy0 = (float)(y0 + y_offset) + 0.5f;
  const float cy1 = (float)(y1 - 1 + y_offset) + 0.5f;
  const float wcx0 = (float)wx0 + 0.5f, wcx1 = (float)wx1 + 0.5f;
  const float wcy0 = (float)(wy0 + y_offset) + 0.5f;
  const float wcy1 = (float)(wy1 + y_offset) + 0.5f;

  float zbuf[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  int idbuf[4] = {-1, -1, -1, -1};
  const int count = min(counts[tile], capacity);
  const int n_chunks = (count + THREADS - 1) / THREADS;
  const int* tile_bins = bins + (size_t)tile * capacity;
  const float* tile_rows = src + (size_t)tile * capacity * SETUP_WIDTH;
  const bool aligned16 = (reinterpret_cast<uintptr_t>(src) & 15) == 0;

  // Issue the copies of chunk k into buffer k % STAGES. K1: `id` is this
  // thread's entry of that chunk (loaded a chunk ahead).
  auto issue = [&](int k, int id) {
    const int buf = k % STAGES;
    const int n = min(THREADS, count - k * THREADS);
    if constexpr (PADDED) {
      if (t == 0) {
        const uint32_t bar = smem_addr(&ring.bars[buf]);
        const uint32_t bytes = (uint32_t)n * SETUP_WIDTH * sizeof(float);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(
                smem_addr(ring.rows[buf])),
            "l"(tile_rows + (size_t)k * THREADS * SETUP_WIDTH), "r"(bytes),
            "r"(bar)
            : "memory");
      }
    } else {
      if (t < n) {
        // Clamped read, as the Pallas kernel reads max(bins, 0).
        const int row = min(max(id, 0), t_rows - 1);
        const float* g = src + (size_t)row * SETUP_WIDTH;
        float4* s = ring.rows[buf][t];
        if (aligned16) {
          cp_async16(s, g);
          cp_async16(s + 1, g + 4);
          cp_async16(s + 2, g + 8);
        } else {
          float* sf = reinterpret_cast<float*>(s);
#pragma unroll
          for (int j = 0; j < 12; ++j) cp_async4(sf + j, g + j);
        }
        ring.ids[buf][t] = id;
      }
    }
  };
  auto load_id = [&](int k) {
    const int e = k * THREADS + t;
    return (k < n_chunks && e < count) ? __ldg(tile_bins + e) : -1;
  };
  // K1: one cp.async group per chunk slot, empty past the last chunk, so
  // that "all but the newest AHEAD groups" is always chunk k and older.
  auto commit = [&]() {
    if constexpr (!PADDED)
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (n_chunks > 0) {
    // Chunks in flight ahead of the one being culled and rastered.
    constexpr int AHEAD = STAGES - 1;
    if constexpr (PADDED) {
      if (t == 0) {
        for (int b = 0; b < STAGES; ++b)
          asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                           smem_addr(&ring.bars[b]))
                       : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
    }
    int next_id = -1;   // K1: this thread's entry of chunk k + AHEAD
    for (int k = 0; k < AHEAD; ++k) {
      if (k < n_chunks) issue(k, load_id(k));
      commit();
    }
    if constexpr (!PADDED) next_id = load_id(AHEAD);

    for (int k = 0; k < n_chunks; ++k) {
      const int buf = k % STAGES;
      const int n = min(THREADS, count - k * THREADS);
      // Chunk k + AHEAD takes the buffer of chunk k - 1, whose last reader
      // passed barrier (C) of iteration k - 1.
      if (k + AHEAD < n_chunks) {
        issue(k + AHEAD, next_id);
        if constexpr (!PADDED) next_id = load_id(k + AHEAD + 1);
      }
      commit();
      // Chunk k has landed.
      if constexpr (PADDED) {
        const uint32_t bar = smem_addr(&ring.bars[buf]);
        while (!mbar_try_wait(bar, (uint32_t)(k / STAGES) & 1u)) {
        }
      } else {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD) : "memory");
      }

      // Cull: thread t tests entry t of the chunk against the rectangle.
      bool keep = false;
      float4 e0, e1, e2;
      int eid = 0;
      if (t < n) {
        const float4* e = ring.rows[buf][t];
        e0 = e[0];
        e1 = e[1];
        e2 = e[2];
        if constexpr (PADDED) {
          eid = __float_as_int(e[3].x);   // id in column 12
        } else {
          eid = ring.ids[buf][t];
        }
        keep = !culled(e0, e1, e2, cx0, cx1, cy0, cy1);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();   // (B): s_warp complete; pixel loop k-1 finished
      int offset = 0, total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int c = s_warp[w];
        offset += w < warp ? c : 0;
        total += c;
      }
      if (keep) {   // survivors in bin order
        const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
        s_surv[pos][0] = e0;
        s_surv[pos][1] = e1;
        s_surv[pos][2] = e2;
        s_sid[pos] = eid;
      }
      __syncthreads();   // (C): survivors complete

      // Second cull, per warp: lane l tests block survivor g + l against
      // the warp's box; the warp rasters the hits in ascending order.
      if (warp_live) {
        for (int g = 0; g < total; g += 32) {
          bool hit = false;
          if (g + lane < total)
            hit = !culled(s_surv[g + lane][0], s_surv[g + lane][1],
                          s_surv[g + lane][2], wcx0, wcx1, wcy0, wcy1);
          unsigned hits = __ballot_sync(0xffffffffu, hit);
          while (hits) {
            const int j = g + __ffs(hits) - 1;
            hits &= hits - 1;
            const float4 r0 = s_surv[j][0], r1 = s_surv[j][1],
                         r2 = s_surv[j][2];
            const float q0 = __fmul_rn(r0.y, py), q1 = __fmul_rn(r1.x, py),
                        q2 = __fmul_rn(r1.w, py), q3 = __fmul_rn(r2.z, py);
            const int sid = s_sid[j];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const float b0 = __fadd_rn(
                  __fadd_rn(__fmul_rn(r0.x, px[p]), q0), r0.z);
              const float b1 = __fadd_rn(
                  __fadd_rn(__fmul_rn(r0.w, px[p]), q1), r1.y);
              const float b2 = __fadd_rn(
                  __fadd_rn(__fmul_rn(r1.z, px[p]), q2), r2.x);
              const float z = __fadd_rn(
                  __fadd_rn(__fmul_rn(r2.y, px[p]), q3), r2.w);
              if (b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f && z >= 0.0f &&
                  z < zbuf[p]) {
                zbuf[p] = z;
                idbuf[p] = sid;
              }
            }
          }
        }
      }
    }
  }

  if (n_live == 0) return;
  const size_t o = (size_t)gy * width + gx;
  if (n_live == 4 && (width & 3) == 0 && (gx & 3) == 0) {
    *reinterpret_cast<int4*>(id_out + o) =
        make_int4(idbuf[0], idbuf[1], idbuf[2], idbuf[3]);
    *reinterpret_cast<float4*>(z_out + o) =
        make_float4(zbuf[0], zbuf[1], zbuf[2], zbuf[3]);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p < n_live) {
        id_out[o + p] = idbuf[p];
        z_out[o + p] = zbuf[p];
      }
    }
  }
}

// One block per rectangle of every tile. Returns cudaErrorInvalidValue
// for a rectangle the block cannot hold.
template <bool PADDED>
int launch(const float* src, int t_rows, const int* bins, const int* counts,
           int n_tiles, int capacity, int y_offset, int tile_h, int tile_w,
           int tiles_x, int rect_h, int rect_w, int height, int width,
           int* id_out, float* z_out, void* stream) {
  if (rect_h <= 0 || rect_w <= 0 || rect_h > tile_h || rect_w > tile_w ||
      rect_h * ((rect_w + 3) / 4) > THREADS)
    return (int)cudaErrorInvalidValue;
  const int rects_x = (tile_w + rect_w - 1) / rect_w;
  const int rects_per_tile = rects_x * ((tile_h + rect_h - 1) / rect_h);
  const long long blocks = (long long)n_tiles * rects_per_tile;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  raster_kernel<PADDED>
      <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
          src, t_rows, bins, counts, capacity, y_offset, tile_h, tile_w,
          tiles_x, rect_h, rect_w, rects_x, rects_per_tile, height, width,
          id_out, z_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int raster_table_launch(const float* table, int t_rows,
                                   const int* bins, const int* counts,
                                   int n_tiles, int capacity, int y_offset,
                                   int tile_h, int tile_w, int tiles_x,
                                   int rect_h, int rect_w, int height,
                                   int width, int* id_out, float* z_out,
                                   void* stream) {
  return launch<false>(table, t_rows, bins, counts, n_tiles, capacity,
                       y_offset, tile_h, tile_w, tiles_x, rect_h, rect_w,
                       height, width, id_out, z_out, stream);
}

// K2's entry point: `rows` is the contiguous (n_tiles, capacity, 16) f32
// pre-gathered stream (16-byte aligned rows). Same contract as K1's.
extern "C" int raster_padded_launch(const float* rows, const int* counts,
                                    int n_tiles, int capacity, int y_offset,
                                    int tile_h, int tile_w, int tiles_x,
                                    int rect_h, int rect_w, int height,
                                    int width, int* id_out, float* z_out,
                                    void* stream) {
  return launch<true>(rows, 0, nullptr, counts, n_tiles, capacity, y_offset,
                      tile_h, tile_w, tiles_x, rect_h, rect_w, height, width,
                      id_out, z_out, stream);
}
