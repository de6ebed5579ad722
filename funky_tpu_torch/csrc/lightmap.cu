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
// through ~680 launches per window. A texel reads ~100-150 depths within
// +-halo texels of itself, and a tap-table entry per tap: the reuse is
// between neighbouring texels, vertical as much as horizontal. In
// practice the instructions bound it: a compare tap kept bit-exact is ~26
// issued instructions (its table entry, four depths, four compares, the
// lerp without contraction, two sums), so a texel on two rungs issues
// ~1,100. On an H100, variants that cut shared-memory wavefronts but
// added instructions (a parity-split tile, a split tap table) ran slower,
// and so did one that looked each compare tap up in a per-block table of
// its 16 outcomes (ten FP32 operations fewer, one shared load more, 48
// registers); fewer loop instructions (the taps fully unrolled) ran
// faster.
//
// Design: one thread per texel, a block per 2D tile of TILE_W x rows
// texels (a block of 32 x 8 threads, each taking rows / 8 texels of its
// column; rows is 24, 16 or 8, the tallest that still leaves ~4 blocks an
// SM: ops/lightmap_cuda.py::tile_rows), so a warp holds 32 neighbouring
// texels of one row (two phases, alternating). The block first stages,
// with cp.async, the tile's haloed window (TILE_W + 2 halo + 1) x (rows +
// 2 halo + 1) into shared memory, resolving on the way dynamic_slice's
// clamped start, the 1.0 border outside the map and the window's
// last-row and last-column clamp of the compare quads (window
// coordinates, not the tile's: a staged texel past the window's last row
// or column repeats it), and the per-frame tap tables, each tap's clamped
// shift turned into one offset into the staged tile. The taps then read
// shared memory with no bounds checks and no clamps: a compare tap is one
// 16-byte table read and four depths. A texel walks only its own live
// rungs, so a warp whose texels sit on different rungs runs two rung
// passes, not their union. The output row is one float4 store.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;      // texels per tile row: one warp
constexpr int BLOCK_Y = 8;      // warps a block
constexpr int MAX_SMEM = 232448;   // a block's shared memory on sm_90
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

// A block's shared memory: the compare taps (R * 16 * P of {offset, fy,
// fx, 1 - fx}), the blocker taps (16 * P offsets, PCSS), the finite flags
// (R * P), then the staged tile ((rows + span + 1) x sw).
struct Layout {
  int n_cmp, n_blk, n_fin, sw, tile;
  __host__ __device__ Layout(int rows, int halo, int phases, int rungs,
                             int use_pcss) {
    const int n_r = use_pcss ? rungs : 1;
    n_cmp = n_r * TAPS * phases;
    n_blk = use_pcss ? TAPS * phases : 0;
    n_fin = n_r * phases;
    sw = TILE_W + 2 * halo + 1;
    tile = (rows + 2 * halo + 1) * sw;
  }
  __host__ __device__ long long bytes() const {
    return 16LL * n_cmp + 4LL * (n_blk + n_fin) + 4LL * tile;
  }
};

// Mean and mean square of the 16 compare-bilinear taps of one PCF radius
// for phase p: `cmp` holds the radius's (16, phases) taps, tap-major, as
// {offset from the texel's own staged origin `at`, fy, fx, 1 - fx}; sw is
// the staged tile's row length.
__device__ __forceinline__ void compare_taps(
    const float* at, int sw, const int4* cmp, int phases, int p,
    float receiver, float* m1, float* m2) {
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const int4 c = cmp[k * phases + p];
    const float* q = at + c.x;
    const float ffy = __int_as_float(c.y), ffx = __int_as_float(c.z);
    const float t00 = receiver <= q[0] ? 1.0f : 0.0f;
    const float t10 = receiver <= q[1] ? 1.0f : 0.0f;
    const float t01 = receiver <= q[sw] ? 1.0f : 0.0f;
    const float t11 = receiver <= q[sw + 1] ? 1.0f : 0.0f;
    const float gx = __int_as_float(c.w), gy = __fsub_rn(1.0f, ffy);
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

// One texel's row: (i, j) of the window, `at` its staged origin.
__device__ __forceinline__ float4 texel_row(
    const float* at, int sw, int i, int j, int oy, int ox, int halo,
    int phases, int rungs, int use_pcss, float inv_s,
    const float* __restrict__ floats, const int4* cmp, const int* blk,
    const float* fin) {
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
  const int tp = TAPS * phases;   // compare entries per radius

  if (!use_pcss) {
    float m1, m2;
    if (b != 0.0f) {   // radius <= 1.25: the 3x3 kernel
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int dy = k / 3 - 1, dx = k % 3 - 1;
        const float v = receiver <= at[(halo + dy) * sw + halo + dx]
                            ? 1.0f : 0.0f;
        s1 = k == 0 ? v : __fadd_rn(s1, v);
        s2 = k == 0 ? __fmul_rn(v, v) : __fadd_rn(s2, __fmul_rn(v, v));
      }
      m1 = __fmul_rn(s1, 1.0f / 9.0f);
      m2 = __fmul_rn(s2, 1.0f / 9.0f);
      return make_float4(m1, m2, 1.0f, 1.0f);
    }
    compare_taps(at, sw, cmp, phases, p, receiver, &m1, &m2);
    return make_float4(m1, m2, a, 1.0f);
  }
  const float ls = a, span_log = b;
  float b_sum = 0.0f, b_cnt = 0.0f;
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const float d = at[blk[k * phases + p]];
    const bool hit = d < receiver;
    const float dv = hit ? d : 0.0f, hv = hit ? 1.0f : 0.0f;
    b_sum = k == 0 ? dv : __fadd_rn(b_sum, dv);
    b_cnt = k == 0 ? hv : __fadd_rn(b_cnt, hv);
  }
  if (!(b_cnt > 0.0f)) return make_float4(1.0f, 1.0f, 0.0f, 1.0f);
  const float depth = __fdiv_rn(b_sum, nan_max(b_cnt, 1.0f));
  const float ratio = __fdiv_rn(__fsub_rn(receiver, depth),
                                nan_max(depth, (float)1e-8));
  const float pen = nan_min(nan_max(__fmul_rn(ratio, ls), 0.5f),
                            __fmul_rn(ls, 2.0f));
  const float pos = __fdiv_rn(
      __fmul_rn((float)(rungs - 1), logf(__fmul_rn(pen, 2.0f))), span_log);
  // The rungs this texel evaluates, in order: all but those of weight 0
  // whose taps are finite. A warp then walks each texel's own rungs in
  // step (one or two of them), not the union of its texels' rungs.
  float m1 = 0.0f, m2 = 0.0f;
  for (int base = 0; base < rungs; base += 32) {
    const int top = min(rungs - base, 32);
    unsigned live = 0;
    for (int r = 0; r < top; ++r) {
      const float wj = clamp01(
          __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)(base + r)))));
      if (!(wj == 0.0f && fin[(base + r) * phases + p] != 0.0f)) {
        live |= 1u << r;
      }
    }
    while (live != 0) {
      const int r = base + __ffs(live) - 1;
      live &= live - 1;
      const float wj =
          clamp01(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)r))));
      float m1j, m2j;
      compare_taps(at, sw, cmp + r * tp, phases, p, receiver, &m1j, &m2j);
      m1 = __fadd_rn(m1, __fmul_rn(wj, m1j));
      m2 = __fadd_rn(m2, __fmul_rn(wj, m2j));
    }
  }
  return make_float4(m1, m2, pen, 1.0f);
}

// ints:   [oy, ox, (PCSS) sy[16 * P], sx[16 * P],
//          y0[R * 16 * P], x0[R * 16 * P]]
// floats: [p0, p1, p2, bias, a, b, fy[R * 16 * P], fx[R * 16 * P],
//          finite[R * P]]
// with a, b = light_size, span (PCSS) or radius, radius <= 1.25 (fixed),
// R = rungs (PCSS) or 1 (fixed), every (16, P) block tap-major. The block
// is (TILE_W, BLOCK_Y) threads over the tile of TILE_W x rows texels at
// (blockIdx.y * rows, blockIdx.x * TILE_W); a thread takes the tile's
// texel rows threadIdx.y, threadIdx.y + BLOCK_Y, ...
__global__ void __launch_bounds__(TILE_W * BLOCK_Y)
light_map_kernel(const float* __restrict__ raw, int s,
                 const int* __restrict__ ints,
                 const float* __restrict__ floats, int wc, int halo,
                 int phases, int rungs, int use_pcss, int rows, float inv_s,
                 float4* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(rows, halo, phases, rungs, use_pcss);
  int4* cmp = reinterpret_cast<int4*>(smem);
  int* blk = reinterpret_cast<int*>(cmp + lay.n_cmp);
  float* fin = reinterpret_cast<float*>(blk + lay.n_blk);
  float* tile = fin + lay.n_fin;
  const int span = 2 * halo;          // the largest clamped view start
  const int wp = wc + span;           // the haloed window's side
  const int sw = lay.sw;              // the staged tile's row length
  const int th = rows + span + 1;     // the staged tile's rows
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int nthreads = TILE_W * BLOCK_Y;
  const int ti = blockIdx.y * rows, tj = blockIdx.x * TILE_W;
  const int oy = __ldg(ints), ox = __ldg(ints + 1);

  // dynamic_slice's start: negative counts from the end of the padded
  // axis (s + 2 halo), then clamped into [0, s - wc]; minus the halo, the
  // raw texel of window texel (0, 0).
  const long long dim = (long long)s + 2 * halo;
  const long long sty = oy < 0 ? oy + dim : oy, stx = ox < 0 ? ox + dim : ox;
  const int sy0 = (int)min(max(sty, 0LL), (long long)(s - wc)) - halo;
  const int sx0 = (int)min(max(stx, 0LL), (long long)(s - wc)) - halo;

  // Staged texel (yy, xx) holds window texel (min(ti + yy, wp - 1),
  // min(tj + xx, wp - 1)): the raw map there, 1.0 outside it.
  for (int yy = threadIdx.y; yy < th; yy += BLOCK_Y) {
    const int ry = sy0 + min(ti + yy, wp - 1);
    const bool row_in = ry >= 0 && ry < s;
    const float* src = raw + (long long)ry * s;
    for (int xx = threadIdx.x; xx < sw; xx += TILE_W) {
      const int rx = sx0 + min(tj + xx, wp - 1);
      if (row_in && rx >= 0 && rx < s) {
        cp_async4(tile + yy * sw + xx, src + rx);
      } else {
        tile[yy * sw + xx] = 1.0f;
      }
    }
  }

  // The tap tables, each tap's clamped shift (clamp(halo + d, 0, span))
  // as an offset into the staged tile.
  const int tp = TAPS * phases;
  const int* shifts = ints + 2;
  const int* corners = use_pcss ? shifts + 2 * tp : shifts;
  for (int q = tid; q < lay.n_cmp; q += nthreads) {
    const int cy = clampi(add_wrap(halo, __ldg(corners + q)), 0, span);
    const int cx = clampi(add_wrap(halo, __ldg(corners + lay.n_cmp + q)), 0,
                          span);
    const float fx = __ldg(floats + 6 + lay.n_cmp + q);
    cmp[q] = make_int4(cy * sw + cx, __float_as_int(__ldg(floats + 6 + q)),
                       __float_as_int(fx),
                       __float_as_int(__fsub_rn(1.0f, fx)));
  }
  for (int q = tid; q < lay.n_blk; q += nthreads) {
    const int cy = clampi(add_wrap(halo, __ldg(shifts + q)), 0, span);
    const int cx = clampi(add_wrap(halo, __ldg(shifts + tp + q)), 0, span);
    blk[q] = cy * sw + cx;
  }
  for (int q = tid; q < lay.n_fin; q += nthreads) {
    fin[q] = __ldg(floats + 6 + 2 * lay.n_cmp + q);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int j = tj + threadIdx.x;
  if (j >= wc) return;
  for (int li = threadIdx.y; li < rows; li += BLOCK_Y) {
    const int i = ti + li;
    if (i >= wc) break;
    // A tap at clamped shift (cy, cx) reads at[cy * sw + cx].
    out[(long long)i * wc + j] = texel_row(
        tile + li * sw + threadIdx.x, sw, i, j, oy, ox, halo, phases, rungs,
        use_pcss, inv_s, floats, cmp, blk, fin);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). raw: (s, s) contiguous f32;
// ints / floats: the packed parameters above (ops/lightmap_cuda.py::
// kernel_params); rows: the tile's texel rows, 8, 16 or 24 (each of a
// block's 32 x 8 threads takes rows / 8 texels of its column);
// out: (wc * wc, 4) f32, 16-byte aligned, every value written. Launches
// on `stream`, does not synchronise, allocates nothing, and returns a
// CUDA error code (0: launched; cudaErrorInvalidValue also where a
// block's shared memory would exceed the card's 227 KB).
extern "C" int light_map_launch(const void* raw, int s, const void* ints,
                                const void* floats, int wc, int halo,
                                int phases, int rungs, int use_pcss,
                                int rows, float inv_s, void* out,
                                void* stream) {
  if (raw == nullptr || ints == nullptr || floats == nullptr ||
      out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      wc <= 0 || wc > s || halo < 1 || halo > (1 << 20) || phases < 1 ||
      phases > 4 || (use_pcss && (rungs < 2 || rungs > (1 << 20))) ||
      (rows != BLOCK_Y && rows != 2 * BLOCK_Y && rows != 3 * BLOCK_Y) ||
      (long long)wc * wc > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const long long bytes = Layout(rows, halo, phases, rungs, use_pcss).bytes();
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        light_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((wc + TILE_W - 1) / TILE_W, (wc + rows - 1) / rows);
  light_map_kernel<<<grid, dim3(TILE_W, BLOCK_Y), (size_t)bytes,
                     (cudaStream_t)stream>>>(
      static_cast<const float*>(raw), s, static_cast<const int*>(ints),
      static_cast<const float*>(floats), wc, halo, phases, rungs,
      use_pcss != 0, rows, inv_s, static_cast<float4*>(out));
  return (int)cudaGetLastError();
}
