// Light-space ground light map for Hopper (sm_90a): dense PCSS / PCF of a
// planar receiver over a (wc, wc) window of one cascade's raw depth map.
//
// K5 light_map_launch replaces the JAX package's jnp pass
// funky_tpu/passes/shadow_lightspace.py::build_light_shadow_map (:210-331),
// which XLA fuses on the TPU. Its plain twin is funky_tpu_torch/passes/
// shadow_lightspace.py::build_light_shadow_map_plain: every phase over the
// whole window as (16, P, wc, wc, 4) tap tensors, one row gather per tap
// set, then one phase kept per texel.
//
// Semantics (identical to the plain twin; the per-frame tap geometry comes
// from the same helper, shadow_lightspace.py::light_map_taps, packed by
// ops/lightmap_cuda.py::kernel_params, so both read the same values):
//   - texel (i, j) of the window at origin (oy, ox) keeps phase
//     p = ((oy + i) % 2 * 2 + (ox + j) % 2) % phases and only that phase is
//     evaluated (the twin evaluates all and discards the others);
//   - window depth w(y, x), y and x in [0, wc + 2 halo), reads the raw map
//     at (sy0 + y - halo, sx0 + x - halo), 1.0 outside the map (the twin's
//     1.0 pad), with (sy0, sx0) the origin clamped as lax.dynamic_slice
//     clamps it into the padded map;
//   - receiver = ((p0*tx + p1*ty) + p2) - bias, tx = ((ox + j) + 0.5) * inv_s
//     (torch on the card divides by the host number S as a multiply by its
//     reciprocal);
//   - a tap at integer shift (dy, dx) reads the window at
//     (clamp(halo + dy, 0, 2 halo) + i, the same in x), the twin's clamped
//     view starts; a compare-bilinear tap reads that texel and its right,
//     lower and lower-right neighbours clamped to the window's last row and
//     column (quad_pack), compares receiver <= depth, and lerps the four
//     0/1 results with (fx, fy): top then bottom then the two;
//   - taps are summed 0..15 in order (_sum_taps) and the sums multiplied by
//     1/16 (1/9 for the 3x3 kernel): torch's division by a host number;
//   - fixed radius: the 3x3 kernel where radius <= 1.25, else 16 Vogel taps
//     at the radius; rows [m1, m2, 1 or radius, 1];
//   - PCSS: 16 nearest blocker taps (hit = depth < receiver), blocker depth
//     sum / max(count, 1), ratio = (receiver - depth) / max(depth, 1e-8),
//     penumbra = min(max(ratio * ls, 0.5), ls * 2),
//     pos = ((rungs - 1) * log(penumbra * 2)) / span, and for each rung j
//     m = m + clamp(1 - |pos - j|, 0, 1) * m_j; rows [m1, m2, penumbra, 1],
//     or [1, 1, 0, 1] where no tap hit.
// NaN-propagating max / min / clamp, as torch's clamp, clamp_min and
// minimum. Every multiply, add, subtract and divide is written with the
// _rn intrinsics, and log is logf without fast math, so the kernel's rows
// equal the plain twin's bit for bit on the card. A rung whose weight is 0
// is skipped where its taps' weights are finite: its m_j lies in [0, 1],
// so m + 0 * m_j == m. A texel with no blocker skips the rungs: its row is
// the constant override.
//
// What bounds it on this card: FP32 work. Per texel: 16 blocker taps
// (~4 ops each), the penumbra (~15), and 16 compare taps of ~18 ops for
// each rung with a nonzero weight (one or two of the six); a 768^2 window
// is ~0.6 M texels, ~0.4 G ops, ~6 us at 67 TFLOP/s. The bytes are the
// haloed window read once (~2.6 MB) and the (wc^2, 4) rows written
// (~9.4 MB at 768^2). The twin moved ~150 MB of tap tensors per tap set
// through ~680 launches per window.
//
// Design: one thread per texel, 256 threads a block over the row-major
// window, so a warp holds 32 neighbouring texels of one row (two phases,
// alternating). Every tap reads the raw map through the read-only path:
// the taps of neighbouring texels overlap, so L1 serves most of them. The
// per-frame parameters (a few KB) are read through the same path. The
// output row is one float4 store. Shared-memory staging of the window is
// left for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TAPS = 16;        // BLOCKER_SAMPLES == PCF_SAMPLES

// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float nan_max(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.clamp(v, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// int32 add with two's-complement wrap, as torch adds int32 tensors.
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct Window {
  const float* __restrict__ raw;
  int s;        // the raw map is (s, s)
  int sy0, sx0; // window start in the padded map, minus halo: raw origin
  int wp;       // window side, wc + 2 halo
  int span;     // 2 halo: the largest clamped view start

  // Depth of window texel (y, x): the raw map, 1.0 outside it.
  __device__ __forceinline__ float at(int y, int x) const {
    const int ry = sy0 + y, rx = sx0 + x;
    return (ry >= 0 && ry < s && rx >= 0 && rx < s)
               ? __ldg(raw + (long long)ry * s + rx) : 1.0f;
  }
};

// Mean and mean square of the 16 compare-bilinear taps of one PCF radius
// for phase p: y0/x0/fy/fx hold the radius's (16, phases) taps, tap-major.
__device__ __forceinline__ void compare_taps(
    const Window& w, int halo, int i, int j, float receiver,
    const int* __restrict__ y0, const int* __restrict__ x0,
    const float* __restrict__ fy, const float* __restrict__ fx, int phases,
    int p, float* m1, float* m2) {
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
  for (int k = 0; k < TAPS; ++k) {
    const int q = k * phases + p;
    const int y = clampi(add_wrap(halo, __ldg(y0 + q)), 0, w.span) + i;
    const int x = clampi(add_wrap(halo, __ldg(x0 + q)), 0, w.span) + j;
    const int y1 = min(y + 1, w.wp - 1), x1 = min(x + 1, w.wp - 1);
    const float t00 = receiver <= w.at(y, x) ? 1.0f : 0.0f;
    const float t10 = receiver <= w.at(y, x1) ? 1.0f : 0.0f;
    const float t01 = receiver <= w.at(y1, x) ? 1.0f : 0.0f;
    const float t11 = receiver <= w.at(y1, x1) ? 1.0f : 0.0f;
    const float ffx = __ldg(fx + q), ffy = __ldg(fy + q);
    const float gx = __fsub_rn(1.0f, ffx), gy = __fsub_rn(1.0f, ffy);
    const float top = __fadd_rn(__fmul_rn(t00, gx), __fmul_rn(t10, ffx));
    const float bot = __fadd_rn(__fmul_rn(t01, gx), __fmul_rn(t11, ffx));
    const float tap = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, ffy));
    const float sq = __fmul_rn(tap, tap);
    s1 = k == 0 ? tap : __fadd_rn(s1, tap);
    s2 = k == 0 ? sq : __fadd_rn(s2, sq);
  }
  *m1 = __fmul_rn(s1, 1.0f / TAPS);
  *m2 = __fmul_rn(s2, 1.0f / TAPS);
}

// ints:   [oy, ox, (PCSS) sy[16 * P], sx[16 * P],
//          y0[R * 16 * P], x0[R * 16 * P]]
// floats: [p0, p1, p2, bias, a, b, fy[R * 16 * P], fx[R * 16 * P],
//          finite[R * P]]
// with a, b = light_size, span (PCSS) or radius, radius <= 1.25 (fixed),
// R = rungs (PCSS) or 1 (fixed), every (16, P) block tap-major.
__global__ void __launch_bounds__(THREADS)
light_map_kernel(const float* __restrict__ raw, int s,
                 const int* __restrict__ ints,
                 const float* __restrict__ floats, int wc, int halo,
                 int phases, int rungs, int use_pcss, float inv_s,
                 float4* __restrict__ out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= wc * wc) return;
  const int i = t / wc, j = t - i * wc;
  const int oy = __ldg(ints), ox = __ldg(ints + 1);

  // dynamic_slice's start: negative counts from the end of the padded
  // axis (s + 2 halo), then clamped into [0, s - wc].
  const long long dim = (long long)s + 2 * halo;
  const long long sty = oy < 0 ? oy + dim : oy, stx = ox < 0 ? ox + dim : ox;
  Window w;
  w.raw = raw;
  w.s = s;
  w.sy0 = (int)min(max(sty, 0LL), (long long)(s - wc)) - halo;
  w.sx0 = (int)min(max(stx, 0LL), (long long)(s - wc)) - halo;
  w.wp = wc + 2 * halo;
  w.span = 2 * halo;

  const long long gy = (long long)oy + i, gx = (long long)ox + j;
  const int p = (int)((((gy % 2) + 2) % 2 * 2 + ((gx % 2) + 2) % 2) % phases);

  const float tx = __fmul_rn(__fadd_rn(__fadd_rn((float)ox, (float)j), 0.5f),
                             inv_s);
  const float ty = __fmul_rn(__fadd_rn(__fadd_rn((float)oy, (float)i), 0.5f),
                             inv_s);
  const float receiver = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__ldg(floats), tx),
                          __fmul_rn(__ldg(floats + 1), ty)),
                __ldg(floats + 2)),
      __ldg(floats + 3));
  const float a = __ldg(floats + 4), b = __ldg(floats + 5);
  const int tp = TAPS * phases;
  const int* shifts = ints + 2;
  const int* corners = use_pcss ? shifts + 2 * tp : shifts;
  const int n_r = use_pcss ? rungs : 1;
  const int* y0 = corners;
  const int* x0 = corners + n_r * tp;
  const float* fy = floats + 6;
  const float* fx = fy + n_r * tp;
  const float* finite = fx + n_r * tp;

  float4 row;
  if (!use_pcss) {
    float m1, m2;
    if (b != 0.0f) {   // radius <= 1.25: the 3x3 kernel
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int dy = k / 3 - 1, dx = k % 3 - 1;
        const float v = receiver <= w.at(halo + dy + i, halo + dx + j)
                            ? 1.0f : 0.0f;
        s1 = k == 0 ? v : __fadd_rn(s1, v);
        s2 = k == 0 ? __fmul_rn(v, v) : __fadd_rn(s2, __fmul_rn(v, v));
      }
      m1 = __fmul_rn(s1, 1.0f / 9.0f);
      m2 = __fmul_rn(s2, 1.0f / 9.0f);
      row = make_float4(m1, m2, 1.0f, 1.0f);
    } else {
      compare_taps(w, halo, i, j, receiver, y0, x0, fy, fx, phases, p, &m1,
                   &m2);
      row = make_float4(m1, m2, a, 1.0f);
    }
  } else {
    const float ls = a, span = b;
    float b_sum = 0.0f, b_cnt = 0.0f;
#pragma unroll 4
    for (int k = 0; k < TAPS; ++k) {
      const int q = k * phases + p;
      const int y = clampi(add_wrap(halo, __ldg(shifts + q)), 0, w.span) + i;
      const int x =
          clampi(add_wrap(halo, __ldg(shifts + tp + q)), 0, w.span) + j;
      const float d = w.at(y, x);
      const bool hit = d < receiver;
      const float dv = hit ? d : 0.0f, hv = hit ? 1.0f : 0.0f;
      b_sum = k == 0 ? dv : __fadd_rn(b_sum, dv);
      b_cnt = k == 0 ? hv : __fadd_rn(b_cnt, hv);
    }
    if (!(b_cnt > 0.0f)) {
      row = make_float4(1.0f, 1.0f, 0.0f, 1.0f);
    } else {
      const float depth = __fdiv_rn(b_sum, nan_max(b_cnt, 1.0f));
      const float ratio = __fdiv_rn(__fsub_rn(receiver, depth),
                                    nan_max(depth, (float)1e-8));
      const float pen = nan_min(nan_max(__fmul_rn(ratio, ls), 0.5f),
                                __fmul_rn(ls, 2.0f));
      const float pos = __fdiv_rn(
          __fmul_rn((float)(rungs - 1), logf(__fmul_rn(pen, 2.0f))), span);
      float m1 = 0.0f, m2 = 0.0f;
      for (int r = 0; r < rungs; ++r) {
        const float wj =
            clamp01(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)r))));
        if (wj == 0.0f && __ldg(finite + r * phases + p) != 0.0f) continue;
        float m1j, m2j;
        compare_taps(w, halo, i, j, receiver, y0 + r * tp, x0 + r * tp,
                     fy + r * tp, fx + r * tp, phases, p, &m1j, &m2j);
        m1 = __fadd_rn(m1, __fmul_rn(wj, m1j));
        m2 = __fadd_rn(m2, __fmul_rn(wj, m2j));
      }
      row = make_float4(m1, m2, pen, 1.0f);
    }
  }
  out[t] = row;
}

}  // namespace

// Plain C entry point (loaded with ctypes). raw: (s, s) contiguous f32;
// ints / floats: the packed parameters above (ops/lightmap_cuda.py::
// kernel_params); out: (wc * wc, 4) f32, 16-byte aligned, every value
// written. Launches on `stream`, does not synchronise, allocates nothing,
// and returns a CUDA error code (0: launched).
extern "C" int light_map_launch(const void* raw, int s, const void* ints,
                                const void* floats, int wc, int halo,
                                int phases, int rungs, int use_pcss,
                                float inv_s, void* out, void* stream) {
  if (raw == nullptr || ints == nullptr || floats == nullptr ||
      out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      wc <= 0 || wc > s || halo < 1 || halo > (1 << 20) || phases < 1 ||
      phases > 4 || (use_pcss && rungs < 2) ||
      (long long)wc * wc > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = wc * wc;
  light_map_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const float*>(raw), s, static_cast<const int*>(ints),
      static_cast<const float*>(floats), wc, halo, phases, rungs,
      use_pcss != 0, inv_s, static_cast<float4*>(out));
  return (int)cudaGetLastError();
}
