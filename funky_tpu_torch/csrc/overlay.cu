// Debug-panel raster for Hopper (sm_90a): UI triangles blended ONE /
// ONE_MINUS_SRC_ALPHA, in draw order, into the premultiplied RGBA panel.
//
// K4 overlay_raster_launch replaces the JAX package's jnp pass
// funky_tpu/passes/overlay.py::rasterize_overlay (:26-82): a lax.scan over
// the 2048 triangle slots, each step one full-panel blend, in one XLA
// program. Its plain twin is funky_tpu_torch/passes/overlay.py::
// rasterize_overlay_plain, a host loop over the same triangle table with
// torch ops on each triangle's crop box.
//
// Semantics (identical to the plain twin, read from the same table that
// passes/overlay.py::overlay_table builds on the host in numpy f32; one
// 32-float row per real triangle in draw order, padded, degenerate and
// empty-crop triangles dropped):
//   - pixel centres px = x + 0.5, py = y + 0.5; a triangle touches the
//     pixels of its crop box [cx0, cx1) x [cy0, cy1) and no other;
//   - b0 = (dx21*(py - y1) - dy21*(px - x1)) * inv_area, b1 likewise with
//     (dx02, dy02, x2, y2), b2 = (1 - b0) - b1; covered iff all three >= 0;
//   - uv = (b0*uv0 + b1*uv1) + b2*uv2, col likewise (4 channels);
//   - tex = the atlas's LINEAR + CLAMP_TO_EDGE sample at uv
//     (ops/sampling.py::sample_bilinear_edge: x = u*w - 0.5, floor, XLA's
//     saturating f32 -> s32, indices clamped, top and bottom rows lerped,
//     then the two rows);
//   - src = ((col.rgb*tex.rgb)*tex.a, col.a*tex.a); a covered pixel becomes
//     src + out*(1 - src.a), any other keeps out.
// Every multiply, add and subtract is written with __fmul_rn / __fadd_rn /
// __fsub_rn, so no FMA contraction changes a rounding: the kernel's panel
// equals the plain twin's bit for bit on the card. A pixel that a triangle
// does not cover skips the atlas read; the twin reads it and discards it.
//
// What bounds it on this card: neither. The panel is 256 x 384 pixels
// (1.5 MB written), the table 45-57 KB for the 356-448 triangles of the
// debug window and the atlas 0.2 MB; each pixel tests the triangles whose crop
// box holds it and evaluates ~17 FP32 operations for each, ~100 more where
// one covers it. That is microseconds of work; the serial walk in draw
// order (the blend is order dependent) is the kernel's latency. The JAX
// pass and the port's former loop paid one full-panel step (XLA) or ~70
// launches (torch) per triangle instead.
//
// Design: one block per rectangular tile of the panel, one thread per
// pixel, each warp on a warp_w x (32 / warp_w) footprint of its tile (the
// wrapper's TILE: tile width, height and warp width, so a glyph's edge
// splits few warps); a tile at the panel's right or bottom edge is
// partial. The block walks the table in chunks of one row per thread:
//   1. each thread tests its row's crop box (columns 9-12) against the
//      tile's rectangle;
//   2. the rows that meet the tile are compacted in draw order, within a
//      warp by __ballot_sync / __popc, across warps by an exclusive
//      prefix of the warps' counts, and their 128-byte rows are staged in
//      shared memory (stored float4-column-major, so the stores of
//      neighbouring slots fall in different banks and every read is one
//      broadcast);
//   3. each pixel walks the chunk's list with the per-pixel crop test and
//      the arithmetic below, its colour carried in registers across
//      chunks until the single float4 store.
// A row that does not meet the tile holds none of its pixels, so every
// pixel still sees exactly the rows whose box holds it, in order: the
// panel is the one the full walk gave, and the serial chain per pixel is
// its tile's list (28-42 rows of the debug window at 16 x 16, the 26
// tiny full-panel triangles of its glyphs among them) instead of the
// table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int ROW_FLOAT4 = 8;   // 32 floats per triangle row

// XLA's saturating f32 -> s32 conversion (ops/sampling.py::to_i32): NaN ->
// 0, values at or above 2^31 -> INT_MAX, the rest clamped, then truncated.
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  x = fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
  return (int)x;
}

// int32 + 1 with two's-complement wrap, as torch adds int32 tensors.
__device__ __forceinline__ int add1(int v) {
  return (int)((unsigned)v + 1u);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// a*(1 - f) + b*f with the twin's rounding: the products, then the sum.
__device__ __forceinline__ float lerp_rn(float a, float b, float f,
                                         float one_minus_f) {
  return __fadd_rn(__fmul_rn(a, one_minus_f), __fmul_rn(b, f));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  const float g = __fsub_rn(1.0f, f);
  return make_float4(lerp_rn(a.x, b.x, f, g), lerp_rn(a.y, b.y, f, g),
                     lerp_rn(a.z, b.z, f, g), lerp_rn(a.w, b.w, f, g));
}

// sample_bilinear_edge of an (ah, aw, 4) atlas at (u, v).
__device__ __forceinline__ float4 sample_edge(const float4* __restrict__ atlas,
                                              int ah, int aw, float u,
                                              float v) {
  const float x = __fsub_rn(__fmul_rn(u, (float)aw), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, (float)ah), 0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
  const int x0 = to_i32(x0f), y0 = to_i32(y0f);
  const int cx0 = clampi(x0, 0, aw - 1), cx1 = clampi(add1(x0), 0, aw - 1);
  const int cy0 = clampi(y0, 0, ah - 1), cy1 = clampi(add1(y0), 0, ah - 1);
  const float4 t00 = __ldg(atlas + cy0 * aw + cx0);
  const float4 t10 = __ldg(atlas + cy0 * aw + cx1);
  const float4 t01 = __ldg(atlas + cy1 * aw + cx0);
  const float4 t11 = __ldg(atlas + cy1 * aw + cx1);
  return lerp4(lerp4(t00, t10, fx), lerp4(t01, t11, fx), fy);
}

// (b0*a0 + b1*a1) + b2*a2, the twin's order.
__device__ __forceinline__ float bary(float b0, float b1, float b2, float a0,
                                      float a1, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(b0, a0), __fmul_rn(b1, a1)),
                   __fmul_rn(b2, a2));
}

// Blends the staged row at column-major slot `slot` (float4 k of the row
// at rows[k * stride + slot]) into o where it covers the pixel.
__device__ __forceinline__ void blend_row(const float4* rows, int stride,
                                          int slot, float fx, float fy,
                                          float px, float py,
                                          const float4* __restrict__ atlas,
                                          int ah, int aw, float4& o) {
  const float4 r2 = rows[2 * stride + slot];   // y2, cx0, cx1, cy0
  const float4 r3 = rows[3 * stride + slot];   // cy1, uv0.x, uv0.y, uv1.x
  if (fx < r2.y || fx >= r2.z || fy < r2.w || fy >= r3.x) return;
  const float4 r0 = rows[slot];                // inv_area, dx21, dy21, dx02
  const float4 r1 = rows[stride + slot];       // dy02, x1, y1, x2
  const float b0 = __fmul_rn(
      __fsub_rn(__fmul_rn(r0.y, __fsub_rn(py, r1.z)),
                __fmul_rn(r0.z, __fsub_rn(px, r1.y))), r0.x);
  const float b1 = __fmul_rn(
      __fsub_rn(__fmul_rn(r0.w, __fsub_rn(py, r2.x)),
                __fmul_rn(r1.x, __fsub_rn(px, r1.w))), r0.x);
  const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
  if (!(b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f)) return;
  const float4 r4 = rows[4 * stride + slot];   // uv1.y, uv2.x, uv2.y, col0.r
  const float4 r5 = rows[5 * stride + slot];   // col0.gba, col1.r
  const float4 r6 = rows[6 * stride + slot];   // col1.gba, col2.r
  const float4 r7 = rows[7 * stride + slot];   // col2.gba, 0
  const float u = bary(b0, b1, b2, r3.y, r3.w, r4.y);
  const float v = bary(b0, b1, b2, r3.z, r4.x, r4.z);
  const float cr = bary(b0, b1, b2, r4.w, r5.w, r6.w);
  const float cg = bary(b0, b1, b2, r5.x, r6.x, r7.x);
  const float cb = bary(b0, b1, b2, r5.y, r6.y, r7.y);
  const float ca = bary(b0, b1, b2, r5.z, r6.z, r7.z);
  const float4 tex = sample_edge(atlas, ah, aw, u, v);
  const float sa = __fmul_rn(ca, tex.w);
  const float keep = __fsub_rn(1.0f, sa);
  o.x = __fadd_rn(__fmul_rn(__fmul_rn(cr, tex.x), tex.w),
                  __fmul_rn(o.x, keep));
  o.y = __fadd_rn(__fmul_rn(__fmul_rn(cg, tex.y), tex.w),
                  __fmul_rn(o.y, keep));
  o.z = __fadd_rn(__fmul_rn(__fmul_rn(cb, tex.z), tex.w),
                  __fmul_rn(o.z, keep));
  o.w = __fadd_rn(sa, __fmul_rn(o.w, keep));
}

// table: n_tris rows of 32 floats, columns (passes/overlay.py TABLE_*):
//   0 inv_area, 1 dx21, 2 dy21, 3 dx02, 4 dy02, 5 x1, 6 y1, 7 x2, 8 y2,
//   9 cx0, 10 cx1, 11 cy0, 12 cy1 (integers as floats),
//   13-18 uv0, uv1, uv2, 19-30 col0, col1, col2 (premultiplied RGBA), 31 0.
// One block of tile_w * tile_h threads per tile; dynamic shared memory of
// one staged row per thread.
__global__ void __launch_bounds__(MAX_THREADS)
overlay_kernel(const float4* __restrict__ table, int n_tris,
               const float4* __restrict__ atlas, int ah, int aw, int ph,
               int pw, int tile_w, int tile_h, int warp_w,
               float4* __restrict__ out) {
  extern __shared__ float4 rows[];             // ROW_FLOAT4 x threads
  __shared__ int warp_hits[MAX_THREADS / 32];
  const int threads = blockDim.x, warps = threads >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps_x = tile_w / warp_w;
  const int x0 = blockIdx.x * tile_w, y0 = blockIdx.y * tile_h;
  const int ix = x0 + (warp % warps_x) * warp_w + lane % warp_w;
  const int iy = y0 + (warp / warps_x) * (32 / warp_w) + lane / warp_w;
  const bool inside = ix < pw && iy < ph;
  // the tile's rectangle [tx0, tx1) x [ty0, ty1) within the panel, exact
  // integers as floats like the crop columns
  const float tx0 = (float)x0, tx1 = (float)min(x0 + tile_w, pw);
  const float ty0 = (float)y0, ty1 = (float)min(y0 + tile_h, ph);
  const float fx = (float)ix, fy = (float)iy;
  const float px = __fadd_rn(fx, 0.5f), py = __fadd_rn(fy, 0.5f);
  const unsigned below = (1u << lane) - 1u;
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = 0; base < n_tris; base += threads) {
    // 1. this thread's row against the tile, by its crop box alone
    const int t = base + tid;
    const float4* row = table + (long long)t * ROW_FLOAT4;
    float4 r2 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r3 = r2;
    bool hit = false;
    if (t < n_tris) {
      r2 = __ldg(row + 2);
      r3 = __ldg(row + 3);
      hit = r2.y < tx1 && r2.z > tx0 && r2.w < ty1 && r3.x > ty0;
    }
    // 2. the hits compacted in draw order, their rows staged
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & below), count = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = warp_hits[w];
      slot += w < warp ? c : 0;
      count += c;
    }
    if (hit) {
      rows[slot] = __ldg(row);
      rows[threads + slot] = __ldg(row + 1);
      rows[2 * threads + slot] = r2;
      rows[3 * threads + slot] = r3;
#pragma unroll
      for (int k = 4; k < ROW_FLOAT4; ++k) {
        rows[k * threads + slot] = __ldg(row + k);
      }
    }
    __syncthreads();
    // 3. the pixel walks the chunk's list in order
    if (inside) {
      for (int j = 0; j < count; ++j) {
        blend_row(rows, threads, j, fx, fy, px, py, atlas, ah, aw, o);
      }
    }
    __syncthreads();   // the next chunk restages rows and warp_hits
  }
  if (inside) out[(long long)iy * pw + ix] = o;
}

}  // namespace

// Plain C entry point (loaded with ctypes). table: n_tris contiguous rows of
// 32 f32 (16-byte aligned); atlas: (ah, aw, 4) contiguous f32 (16-byte
// aligned); out: (ph, pw, 4) f32, every value written. The tile is
// tile_w x tile_h pixels, a whole number of warps up to 256 threads, each
// warp on warp_w x (32 / warp_w) pixels (warp_w divides 32 and tile_w,
// 32 / warp_w divides tile_h). Launches on `stream`, does not synchronise,
// allocates nothing, and returns a CUDA error code (0: launched).
extern "C" int overlay_raster_launch(const void* table, int n_tris,
                                     const void* atlas, int ah, int aw,
                                     int ph, int pw, int tile_w, int tile_h,
                                     int warp_w, void* out, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(atlas) |
                          reinterpret_cast<uintptr_t>(out);
  const int threads = tile_w * tile_h;
  const bool tile_ok =
      tile_w > 0 && tile_h > 0 && tile_w <= MAX_THREADS &&
      tile_h <= MAX_THREADS && threads % 32 == 0 && threads <= MAX_THREADS &&
      warp_w > 0 && 32 % warp_w == 0 && tile_w % warp_w == 0 &&
      tile_h % (32 / warp_w) == 0;
  if (n_tris < 0 || (n_tris > 0 && table == nullptr) || atlas == nullptr ||
      out == nullptr || ah <= 0 || aw <= 0 || ph <= 0 || pw <= 0 ||
      align % 16 != 0 || (long long)ph * pw > 0x7fffffffLL ||
      (long long)ah * aw > 0x7fffffffLL || !tile_ok) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((pw + tile_w - 1) / tile_w, (ph + tile_h - 1) / tile_h);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float4) * ROW_FLOAT4 * threads;
  overlay_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float4*>(table), n_tris,
      static_cast<const float4*>(atlas), ah, aw, ph, pw, tile_w, tile_h,
      warp_w, static_cast<float4*>(out));
  return (int)cudaGetLastError();
}
