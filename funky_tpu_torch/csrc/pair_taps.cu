// Shadow-filter tap sets for Hopper (sm_90a): the PCSS blocker search,
// penumbra and penumbra-radius PCF, or the fixed-radius PCF, of N entries,
// one thread per entry.
//
// K6 pair_taps_launch replaces the JAX package's jnp tap cores
// funky_tpu/passes/shadow_filter.py::_pcss_taps (:159-219) and ::_pcf_taps
// (:248-283), which XLA fuses into a few fusions per pair group on the TPU.
// Its plain twins are funky_tpu_torch/passes/shadow_filter.py::
// _pcss_taps_plain and _pcf_taps_plain: per tap set a (16, N) Vogel offset
// tensor, one row gather (K3) of (16, N, 4) quads and ~150-200 elementwise
// launches on (16, N) tensors.
//
// Semantics (identical to the plain twins):
//   - Vogel tap k of entry e: r = sqrt(k + 0.5) / sqrt(16),
//     theta = k * 2.4f + phi[e], (dx, dy) = (r cos theta, r sin theta);
//     the tap's uv is uv[e] + (dx, dy) * scale, scale = (softness * 2) *
//     texel for the blocker search, penumbra * texel for the PCSS compare
//     taps, max(softness, 0.5) * texel for fixed-radius PCF, and
//     (i, j) * texel for its 3x3 kernel (dy-major);
//   - a tap at (u, v) in a map of side s: x = u * s - 0.5, base texel
//     x0 = to_i32(floor(x)) (XLA's saturating conversion, NaN -> 0), the
//     quad row of (clamp(y0, 0, s - 1), clamp(x0, 0, s - 1)) read from
//     the packed maps at (layer * s + cy) * s + cx (int32 arithmetic, then
//     take_rows' normalisation: a negative index counts from the end, then
//     the clamp), or from the window at (clamp(cy - oy, 0, wh - 1),
//     clamp(cx - ox, 0, ww - 1)) with the origin as passed;
//     the quad's corners replaced where the base was clamped up from a
//     negative index (_quad_corners);
//   - nearest (blocker taps): the corner of to_i32(floor(u * s)) relative
//     to the base, clamped to the quad, 1.0 outside the map; compare taps:
//     per corner 1.0 outside the map, else receiver <= depth, lerped top,
//     then bottom, then the two, with (1 - f) computed once;
//   - sums in tap order (_sum_taps); a sum over 16 or 9 taps is multiplied
//     by the f32 reciprocal of 16 or 9 (torch's division by a host number
//     on the card); blocker depth and penumbra ratio are IEEE divisions;
//   - PCSS: penumbra = min(max(ratio * ls, 0.5), ls * 2) with NaN
//     propagated (torch.clamp, torch.minimum); radius-only mode stops after
//     it with m1 = m2 = 1; rows [m1, m2, penumbra, has_blockers (1 or 0)];
//   - fixed radius: the 3x3 kernel where radius <= 1.25, else 16 Vogel taps;
//     rows [m1, m2, 1 or radius, 0].
// Every multiply, add, subtract and divide is written with the _rn
// intrinsics (no FMA contraction), and cosf / sinf / sqrt without fast
// math, so the rows equal the plain twin's bit for bit on the card.
//
// What bounds it on this card: FP32 work, just ahead of the bytes. Per
// entry ~1,400 operations (the 16 Vogel offsets with a sin and a cos each
// are half of them, then 16 blocker and 16 compare taps); it reads its
// uv, receiver, phi and layer (20 B) and the distinct quad rows of its 32
// taps (16 B each; neighbouring entries share most of them) and writes
// one 16-byte row. The shipped frame's five pair groups are ~164 K entry
// slots: ~0.23 G operations, ~8.6 MB.
//
// Design: one thread per entry, 256 threads a block. The 16 Vogel offsets
// are computed once into registers and serve both tap sets. Quad rows are
// read through the read-only path (__ldg, 16-byte loads where the table is
// aligned): the entries of a compacted group are neighbouring pixels, so
// L1 serves much of the reuse. Nothing is staged in global memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TAPS = 16;  // BLOCKER_SAMPLES == PCF_SAMPLES

enum Mode { PCSS = 0, RADIUS_ONLY = 1, PCF = 2 };

// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float nan_max(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// int32 arithmetic with two's-complement wrap, as torch's int32 tensors.
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int sub_wrap(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int mul_wrap(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// XLA's saturating f32 -> s32 (ops/sampling.py::to_i32): NaN -> 0.
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return (int)0x80000000u;
  return (int)x;
}

__device__ __forceinline__ bool in_map(int iy, int ix, int s) {
  return iy >= 0 && iy < s && ix >= 0 && ix < s;
}

// Where the quad rows come from: the packed maps (L * s * s rows) at a
// per-entry layer, or a (wh, ww) window of one cascade at origin (oy, ox).
struct Source {
  const float* __restrict__ base;
  long long n_rows;       // packed: L * s * s
  long long row_stride;   // window: floats between window rows
  int s;                  // the full map's side
  int wh, ww, oy, ox;
  bool windowed, aligned;

  __device__ __forceinline__ float4 quad(int layer, int cy, int cx) const {
    const float* p;
    if (windowed) {
      const int ly = clampi(sub_wrap(cy, oy), 0, wh - 1);
      const int lx = clampi(sub_wrap(cx, ox), 0, ww - 1);
      p = base + (long long)ly * row_stride + (long long)lx * 4;
    } else {
      const int idx = add_wrap(mul_wrap(add_wrap(mul_wrap(layer, s), cy), s),
                               cx);
      long long i = idx < 0 ? (long long)idx + n_rows : (long long)idx;
      i = i < 0 ? 0 : (i > n_rows - 1 ? n_rows - 1 : i);
      p = base + i * 4;
    }
    if (aligned) return __ldg(reinterpret_cast<const float4*>(p));
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
};

// The quad of the tap at (u, v): its base texel (x0, y0) before the clamp,
// the fractions, and the four corners after _quad_corners.
struct Quad {
  int x0, y0, cx, cy;
  float fx, fy;
  float c00, c10, c01, c11;
};

__device__ __forceinline__ Quad tap_quad(const Source& src, int layer,
                                         float u, float v) {
  const float sf = (float)src.s;
  const float x = __fsub_rn(__fmul_rn(u, sf), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, sf), 0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  Quad q;
  q.fx = __fsub_rn(x, x0f);
  q.fy = __fsub_rn(y, y0f);
  q.x0 = to_i32(x0f);
  q.y0 = to_i32(y0f);
  q.cx = clampi(q.x0, 0, src.s - 1);
  q.cy = clampi(q.y0, 0, src.s - 1);
  const float4 r = src.quad(layer, q.cy, q.cx);
  const bool x_ok = q.x0 >= 0, y_ok = q.y0 >= 0;
  q.c00 = r.x;
  q.c10 = x_ok ? r.y : r.x;
  q.c11 = x_ok ? r.w : r.z;
  q.c01 = y_ok ? r.z : r.x;
  q.c11 = y_ok ? q.c11 : q.c10;
  return q;
}

// sample_nearest_border_packed / _window with border 1.0.
__device__ __forceinline__ float nearest_tap(const Source& src, int layer,
                                             float u, float v) {
  const Quad q = tap_quad(src, layer, u, v);
  const float sf = (float)src.s;
  const int nxi = to_i32(floorf(__fmul_rn(u, sf)));
  const int nyi = to_i32(floorf(__fmul_rn(v, sf)));
  if (!in_map(nyi, nxi, src.s)) return 1.0f;
  const int nx = clampi(clampi(nxi, 0, src.s - 1) - q.cx, 0, 1);
  const int ny = clampi(clampi(nyi, 0, src.s - 1) - q.cy, 0, 1);
  return ny == 0 ? (nx == 0 ? q.c00 : q.c10) : (nx == 0 ? q.c01 : q.c11);
}

// sample_shadow_compare_packed / _window: border white.
__device__ __forceinline__ float compare_tap(const Source& src, int layer,
                                             float u, float v, float ref) {
  const Quad q = tap_quad(src, layer, u, v);
  const int s = src.s;
  const float t00 = in_map(q.y0, q.x0, s)
      ? (ref <= q.c00 ? 1.0f : 0.0f) : 1.0f;
  const float t10 = in_map(q.y0, add_wrap(q.x0, 1), s)
      ? (ref <= q.c10 ? 1.0f : 0.0f) : 1.0f;
  const float t01 = in_map(add_wrap(q.y0, 1), q.x0, s)
      ? (ref <= q.c01 ? 1.0f : 0.0f) : 1.0f;
  const float t11 = in_map(add_wrap(q.y0, 1), add_wrap(q.x0, 1), s)
      ? (ref <= q.c11 ? 1.0f : 0.0f) : 1.0f;
  const float gx = __fsub_rn(1.0f, q.fx), gy = __fsub_rn(1.0f, q.fy);
  const float top = __fadd_rn(__fmul_rn(t00, gx), __fmul_rn(t10, q.fx));
  const float bot = __fadd_rn(__fmul_rn(t01, gx), __fmul_rn(t11, q.fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, q.fy));
}

// Mean and mean square of the 16 compare taps at uv + (dx, dy) * scale.
__device__ __forceinline__ void vogel_compare(
    const Source& src, int layer, float u, float v, float ref,
    const float* dx, const float* dy, float scale, float* m1, float* m2) {
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const float t = compare_tap(src, layer,
                                __fadd_rn(u, __fmul_rn(dx[k], scale)),
                                __fadd_rn(v, __fmul_rn(dy[k], scale)), ref);
    const float sq = __fmul_rn(t, t);
    s1 = k == 0 ? t : __fadd_rn(s1, t);
    s2 = k == 0 ? sq : __fadd_rn(s2, sq);
  }
  *m1 = __fmul_rn(s1, 1.0f / TAPS);
  *m2 = __fmul_rn(s2, 1.0f / TAPS);
}

__global__ void __launch_bounds__(THREADS)
pair_taps_kernel(Source src, const int* __restrict__ origin,
                 const int* __restrict__ layer,
                 long long layer_stride, const float* __restrict__ uv,
                 long long uv_stride, const float* __restrict__ recv,
                 long long recv_stride, const float* __restrict__ phi,
                 long long phi_stride, const float* __restrict__ texel_p,
                 const float* __restrict__ soft_p, int n, int mode,
                 float4* __restrict__ out) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  if (origin != nullptr) {   // a device-valued window origin
    src.oy = __ldg(origin);
    src.ox = __ldg(origin + 1);
  }
  const int lay = layer != nullptr ? __ldg(layer + e * layer_stride) : 0;
  const float u = __ldg(uv + e * uv_stride), v = __ldg(uv + e * uv_stride + 1);
  const float ref = __ldg(recv + e * recv_stride);
  const float ph = __ldg(phi + e * phi_stride);
  const float texel = __ldg(texel_p), soft = __ldg(soft_p);

  // vogel_disk_all(16, phi): the same offsets for every tap set.
  float dx[TAPS], dy[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const float fk = (float)k;
    const float r = __fdiv_rn(__fsqrt_rn(__fadd_rn(fk, 0.5f)),
                              __fsqrt_rn((float)TAPS));
    const float theta = __fadd_rn(__fmul_rn(fk, 2.4f), ph);
    dx[k] = __fmul_rn(r, cosf(theta));
    dy[k] = __fmul_rn(r, sinf(theta));
  }

  if (mode == PCF) {
    const float radius = nan_max(soft, 0.5f);
    float m1, m2;
    if (radius <= 1.25f) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float ox = __fmul_rn((float)(k % 3 - 1), texel);
        const float oy = __fmul_rn((float)(k / 3 - 1), texel);
        const float t = compare_tap(src, lay, __fadd_rn(u, ox),
                                    __fadd_rn(v, oy), ref);
        const float sq = __fmul_rn(t, t);
        s1 = k == 0 ? t : __fadd_rn(s1, t);
        s2 = k == 0 ? sq : __fadd_rn(s2, sq);
      }
      out[e] = make_float4(__fmul_rn(s1, 1.0f / 9.0f),
                           __fmul_rn(s2, 1.0f / 9.0f), 1.0f, 0.0f);
    } else {
      vogel_compare(src, lay, u, v, ref, dx, dy, __fmul_rn(radius, texel),
                    &m1, &m2);
      out[e] = make_float4(m1, m2, radius, 0.0f);
    }
    return;
  }

  // PCSS: the blocker search (nearest taps, border 1.0).
  const float ls = __fmul_rn(soft, 2.0f);
  const float bscale = __fmul_rn(ls, texel);
  float b_sum = 0.0f, b_cnt = 0.0f;
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const float d = nearest_tap(src, lay,
                                __fadd_rn(u, __fmul_rn(dx[k], bscale)),
                                __fadd_rn(v, __fmul_rn(dy[k], bscale)));
    const bool hit = d < ref;
    const float dv = hit ? d : 0.0f, hv = hit ? 1.0f : 0.0f;
    b_sum = k == 0 ? dv : __fadd_rn(b_sum, dv);
    b_cnt = k == 0 ? hv : __fadd_rn(b_cnt, hv);
  }
  const float has = b_cnt > 0.0f ? 1.0f : 0.0f;
  const float depth = __fdiv_rn(b_sum, nan_max(b_cnt, 1.0f));
  const float ratio = __fdiv_rn(__fsub_rn(ref, depth),
                                nan_max(depth, (float)1e-8));
  const float pen = nan_min(nan_max(__fmul_rn(ratio, ls), 0.5f),
                            __fmul_rn(ls, 2.0f));
  if (mode == RADIUS_ONLY) {
    out[e] = make_float4(1.0f, 1.0f, pen, has);
    return;
  }
  float m1, m2;
  vogel_compare(src, lay, u, v, ref, dx, dy, __fmul_rn(pen, texel), &m1, &m2);
  out[e] = make_float4(m1, m2, pen, has);
}

}  // namespace

// Plain C entry point (loaded with ctypes). The quad rows: `windowed` 0,
// `table` the packed maps, n_rows = L * s * s rows of 4 f32 and `layer`
// (int32, element stride layer_stride) each entry's layer; `windowed` 1,
// `table` the window's first row, wh x ww rows of 4 f32 with row_stride
// floats between window rows, origin (oy, ox) in full-map texels, read
// from `origin` (two int32 on the card) where it is not null, else the
// host values oy, ox; `layer` unused. uv: rows of 2 f32 (uv_stride floats
// apart); recv, phi: f32 with element strides; texel, softness: one f32
// each on the card (the uniforms shadow_map_size[2] and shadow_bias[0]);
// mode 0 PCSS, 1 PCSS radius-only, 2 fixed-radius PCF; out: (n, 4) f32,
// 16-byte aligned, every row written. Launches on `stream`, does not
// synchronise, allocates nothing, and returns a CUDA error code (0:
// launched).
extern "C" int pair_taps_launch(
    const void* table, long long n_rows, int s, int windowed, int wh, int ww,
    long long row_stride, const void* origin, int oy, int ox,
    const void* layer, long long layer_stride, const void* uv,
    long long uv_stride, const void* recv, long long recv_stride,
    const void* phi, long long phi_stride, const void* texel,
    const void* softness, int n, int mode, void* out, void* stream) {
  if (table == nullptr || uv == nullptr || recv == nullptr ||
      phi == nullptr || texel == nullptr || softness == nullptr ||
      out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      s <= 0 || n < 0 || mode < 0 || mode > 2 ||
      (!windowed && (layer == nullptr || n_rows <= 0)) ||
      (windowed && (wh <= 0 || ww <= 0 || row_stride < 4 * (long long)ww))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  Source src;
  src.base = static_cast<const float*>(table);
  src.n_rows = n_rows;
  src.row_stride = row_stride;
  src.s = s;
  src.wh = wh;
  src.ww = ww;
  src.oy = oy;
  src.ox = ox;
  src.windowed = windowed != 0;
  src.aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                (!windowed || row_stride % 4 == 0);
  pair_taps_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
      src, static_cast<const int*>(windowed ? origin : nullptr),
      static_cast<const int*>(windowed ? nullptr : layer), layer_stride,
      static_cast<const float*>(uv), uv_stride,
      static_cast<const float*>(recv), recv_stride,
      static_cast<const float*>(phi), phi_stride,
      static_cast<const float*>(texel), static_cast<const float*>(softness),
      n, mode, static_cast<float4*>(out));
  return (int)cudaGetLastError();
}
