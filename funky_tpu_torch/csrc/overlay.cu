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
// (1.5 MB written), the table ~53 KB for the ~416 triangles of the debug
// window and the atlas 0.2 MB; each pixel tests each triangle's crop box
// and evaluates ~17 FP32 operations for the triangles whose box holds it,
// ~100 more where one covers it. That is microseconds of work; the serial
// walk over the table in draw order (the blend is order dependent) is the
// kernel's latency. The JAX pass and the port's former loop paid one
// full-panel step (XLA) or ~70 launches (torch) per triangle instead.
//
// Design: one thread per panel pixel, 256 threads a block, rows of the
// panel contiguous in x so a warp reads neighbouring atlas texels. Every
// thread of a block walks the whole table in order; a row is eight float4
// loads through the read-only path that all threads of a warp share (one
// broadcast transaction each), and the crop test reads two of them first.
// The pixel's colour stays in registers until the single float4 store.
// Shared-memory staging of the table is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
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

// table: n_tris rows of 32 floats, columns (passes/overlay.py TABLE_*):
//   0 inv_area, 1 dx21, 2 dy21, 3 dx02, 4 dy02, 5 x1, 6 y1, 7 x2, 8 y2,
//   9 cx0, 10 cx1, 11 cy0, 12 cy1 (integers as floats),
//   13-18 uv0, uv1, uv2, 19-30 col0, col1, col2 (premultiplied RGBA), 31 0.
__global__ void __launch_bounds__(THREADS)
overlay_kernel(const float4* __restrict__ table, int n_tris,
               const float4* __restrict__ atlas, int ah, int aw, int ph,
               int pw, float4* __restrict__ out) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= ph * pw) return;
  const int iy = idx / pw, ix = idx - iy * pw;
  const float fx = (float)ix, fy = (float)iy;
  const float px = __fadd_rn(fx, 0.5f), py = __fadd_rn(fy, 0.5f);
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int t = 0; t < n_tris; ++t) {
    const float4* row = table + (long long)t * ROW_FLOAT4;
    const float4 r2 = __ldg(row + 2);   // y2, cx0, cx1, cy0
    const float4 r3 = __ldg(row + 3);   // cy1, uv0.x, uv0.y, uv1.x
    if (fx < r2.y || fx >= r2.z || fy < r2.w || fy >= r3.x) continue;
    const float4 r0 = __ldg(row);       // inv_area, dx21, dy21, dx02
    const float4 r1 = __ldg(row + 1);   // dy02, x1, y1, x2
    const float b0 = __fmul_rn(
        __fsub_rn(__fmul_rn(r0.y, __fsub_rn(py, r1.z)),
                  __fmul_rn(r0.z, __fsub_rn(px, r1.y))), r0.x);
    const float b1 = __fmul_rn(
        __fsub_rn(__fmul_rn(r0.w, __fsub_rn(py, r2.x)),
                  __fmul_rn(r1.x, __fsub_rn(px, r1.w))), r0.x);
    const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
    if (!(b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f)) continue;
    const float4 r4 = __ldg(row + 4);   // uv1.y, uv2.x, uv2.y, col0.r
    const float4 r5 = __ldg(row + 5);   // col0.gba, col1.r
    const float4 r6 = __ldg(row + 6);   // col1.gba, col2.r
    const float4 r7 = __ldg(row + 7);   // col2.gba, 0
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
  out[idx] = o;
}

}  // namespace

// Plain C entry point (loaded with ctypes). table: n_tris contiguous rows of
// 32 f32 (16-byte aligned); atlas: (ah, aw, 4) contiguous f32 (16-byte
// aligned); out: (ph, pw, 4) f32, every value written. Launches on
// `stream`, does not synchronise, allocates nothing, and returns a CUDA
// error code (0: launched).
extern "C" int overlay_raster_launch(const void* table, int n_tris,
                                     const void* atlas, int ah, int aw,
                                     int ph, int pw, void* out,
                                     void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(atlas) |
                          reinterpret_cast<uintptr_t>(out);
  if (n_tris < 0 || (n_tris > 0 && table == nullptr) || atlas == nullptr ||
      out == nullptr || ah <= 0 || aw <= 0 || ph <= 0 || pw <= 0 ||
      align % 16 != 0 || (long long)ph * pw > 0x7fffffffLL ||
      (long long)ah * aw > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = ph * pw;
  overlay_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                   (cudaStream_t)stream>>>(
      static_cast<const float4*>(table), n_tris,
      static_cast<const float4*>(atlas), ah, aw, ph, pw,
      static_cast<float4*>(out));
  return (int)cudaGetLastError();
}
