// Shadow class maps for Hopper (sm_90a): per coarse cell of each cascade,
// the map's local relief at a ladder of window sizes and the residual
// range against the cascade's ground plane.
//
// K10 class_maps_launch replaces the jnp pass funky_tpu/passes/
// shadow_classify.py::build_class_maps (:199-275), which XLA fuses on the
// TPU. Its plain twin is funky_tpu_torch/passes/shadow_classify.py::
// _class_rows_plain: square dilations by composed shifts (every shift a
// pair of torch.cat copies of the whole map), 2x2 pools, cell maxima and
// the plane residuals, ~200 launches over the (L, S, S) maps.
//
// Semantics (identical to the plain twin): with x the map plus 0.0 (no
// -0 enters a reduction, so every min / max tie is between equal bits and
// the result does not depend on the order), per cell of `coarse` x
// `coarse` texels, row (L * Sc * Sc, 8):
//   - pooled branch (coarse and S even): column 0 the cell max of
//     x - min7x7(x) (reach 3 at full resolution); on the 2x2-pooled maps
//     hi = max, lo = min, columns 1-4 the cell max (over coarse / 2
//     pooled texels) of hi - min over lo at half reaches 3, 6, 10, 17
//     (the rungs 6, 12, 20, 34), column 5 the cell max of max over hi at
//     the rise reach (rise_window + 1) / 2 minus lo;
//   - unpooled branch: columns 0-4 the cell max of x - min(x) at reaches
//     3, 6, 12, 20, 34, column 5 the cell max of max(x) at rise_window
//     minus x;
//   - every window reaches past the map's edge into BORDER_DEPTH (1.0);
//   - column 6 the cell min of resid - eps and column 7 the cell max of
//     resid + eps, resid = x - ((a * u + b * v) + c), u = (j + 0.5) *
//     (1 / S) (torch divides by a host number on the card as a multiply
//     by its f32 reciprocal, which the wrapper passes), eps per cascade
//     computed in torch; the min as the twin takes it, -max(-(...)).
// min and max propagate NaN (min.NaN / max.NaN: after the + 0.0 every
// NaN on the card is the canonical one, so the bits agree with torch's
// NaN-first minimum and maximum); subtractions and the plane are _rn
// intrinsics, so the rows equal the twin's bit for bit.
//
// What bounds it on this card: shared-memory instructions, well ahead of
// the bytes. The byte bound is the map read once and the rows written
// (~69 MB on the shipped frame's 4 x 2048^2 maps, ~0.021 ms at 3.35
// TB/s); each pooled texel takes ~100 shared loads and min / max for its
// row and column windows.
//
// Design: one block per tile of tc x tc cells of one cascade, in two
// stages (pooled: the full-resolution rung and the residuals, then the
// pooled rungs and the rise; unpooled: one stage). A stage stages its
// tile's haloed window (the halo is its largest reach: 3 or 34 fine
// texels, 17 pooled) in shared memory, BORDER_DEPTH outside the map,
// pooling 2x2 on the fly; takes every reach's window min (and the rise's
// max) along rows in one walk outward from the centre, then along
// columns per reach (each step's two new texels taken together, so the
// chain of dependent min / max is one per step); writes each texel's
// values; and reduces each cell's values down its texel columns, then
// across them. The wrapper picks tc so that a block stays under ~113 KB
// of shared memory (two blocks per SM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_LADDER = 5;
constexpr int ROW = 8;   // floats per output row
constexpr int STAGE_BATCH = 8;   // window texels a thread loads at once

__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float tmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch's amax: a NaN operand is the result, its bits kept (the negated
// residuals' NaN has the sign bit set, which max.NaN would drop).
__device__ __forceinline__ float keep_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// torch.neg: the sign bit flipped, a NaN's too (the compiler may negate
// by an add, which returns the canonical NaN).
__device__ __forceinline__ float neg(float x) {
  return __int_as_float(__float_as_int(x) ^ 0x80000000);
}

// The min reaches of each kind of stage, known to the compiler so that
// the window walks unroll: the pooled branch's full-resolution rung, its
// half reaches (r + 1) / 2 on the pooled maps, the full-resolution ladder.
enum Kind { FINE_RUNG = 0, HALF = 1, FULL = 2 };
template <int KIND> struct Reach;
template <> struct Reach<FINE_RUNG> {
  static constexpr int NK = 1;
  __host__ __device__ static constexpr int at(int) { return 3; }
};
template <> struct Reach<HALF> {
  static constexpr int NK = 4;
  __host__ __device__ static constexpr int at(int k) {
    return k == 0 ? 3 : k == 1 ? 6 : k == 2 ? 10 : 17;
  }
};
template <> struct Reach<FULL> {
  static constexpr int NK = N_LADDER;
  __host__ __device__ static constexpr int at(int k) {
    return k == 0 ? 3 : k == 1 ? 6 : k == 2 ? 12 : k == 3 ? 20 : 34;
  }
};

// One stage's geometry, in the stage's own texels (fine or pooled).
struct Stage {
  int n;           // the stage's map side (S or S / 2)
  int cell;        // texels per cell side
  int halo;        // the window's halo: the largest reach
  int nk;          // min reaches
  int rise;        // the rise's max reach, 0 = none
  int col0;        // output column of the first min reach
  bool pooled;     // texels are 2x2 pools of the fine map
  bool resid;      // also the residual columns 6 and 7 (fine stages)
};

struct Layout {   // float offsets into shared memory
  int P, side, nv;
  int lo, hi, rowmin, rowmax, vals, part, total;
};

__host__ __device__ inline Layout layout(const Stage& st, int tc) {
  Layout l;
  l.P = tc * st.cell;
  l.side = l.P + 2 * st.halo;
  l.nv = st.nk + (st.rise > 0 ? 1 : 0) + (st.resid ? 2 : 0);
  l.lo = 0;
  l.hi = st.pooled ? l.side * l.side : 0;
  int at = l.side * l.side * (st.pooled ? 2 : 1);
  l.rowmin = at;
  at += st.nk * l.side * l.P;
  l.rowmax = at;
  at += st.rise > 0 ? l.side * l.P : 0;
  l.vals = at;
  at += l.nv * l.P * l.P;
  l.part = at;
  at += l.nv * tc * tc * st.cell;
  l.total = at;
  return l;
}

struct Params {
  const float* __restrict__ maps;    // (L, S, S)
  const float* __restrict__ planes;  // (L, 3), row stride plane_stride
  const float* __restrict__ eps;     // (L,), stride eps_stride
  float* __restrict__ out;           // (L * Sc * Sc, 8)
  long long plane_stride, eps_stride;
  int S, Sc, tc;
  float inv_s;
};

// The stage texel (gy, gx) of cascade `map` as (lo, hi): the map value
// plus 0.0, or the 2x2 pool's min and max; BORDER_DEPTH outside.
__device__ __forceinline__ void texel(const float* __restrict__ map, int S,
                                      int n, bool pooled, int gy, int gx,
                                      float* lo, float* hi) {
  if (gy < 0 || gx < 0 || gy >= n || gx >= n) {
    *lo = 1.0f;
    *hi = 1.0f;
    return;
  }
  if (!pooled) {
    const float x = __fadd_rn(__ldg(map + (long long)gy * S + gx), 0.0f);
    *lo = x;
    *hi = x;
    return;
  }
  const float* r0 = map + (long long)(2 * gy) * S + 2 * gx;
  const float* r1 = r0 + S;
  const float a = __fadd_rn(__ldg(r0), 0.0f);
  const float b = __fadd_rn(__ldg(r0 + 1), 0.0f);
  const float c = __fadd_rn(__ldg(r1), 0.0f);
  const float d = __fadd_rn(__ldg(r1 + 1), 0.0f);
  // _pool2: rows first, then columns
  *hi = tmax(tmax(a, c), tmax(b, d));
  *lo = tmin(tmin(a, c), tmin(b, d));
}

template <int KIND>
__device__ __forceinline__ void run_stage(const Params& p, const Stage st,
                                          int layer, int cy0, int cx0,
                                          float* sm) {
  using R = Reach<KIND>;
  const int tc = p.tc;
  const Layout L = layout(st, tc);
  const int P = L.P, side = L.side, H = st.halo;
  float* lo = sm + L.lo;
  float* hi = sm + L.hi;
  float* rowmin = sm + L.rowmin;
  float* rowmax = sm + L.rowmax;
  float* vals = sm + L.vals;
  float* part = sm + L.part;
  const float* map = p.maps + (long long)layer * p.S * p.S;
  const int ty0 = cy0 * st.cell, tx0 = cx0 * st.cell;

  // 1. the haloed window, STAGE_BATCH texels a thread in flight (one at
  // a time, each thread waited out a load per texel)
  for (int i0 = threadIdx.x; i0 < side * side; i0 += THREADS * STAGE_BATCH) {
    float a[STAGE_BATCH], b[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * THREADS;
      const int r = i / side, c = i - r * side;
      texel(map, p.S, st.n, st.pooled, i < side * side ? ty0 - H + r : -1,
            tx0 - H + c, &a[u], &b[u]);
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * THREADS;
      if (i < side * side) {
        lo[i] = a[u];
        if (st.pooled) hi[i] = b[u];
      }
    }
  }
  __syncthreads();

  // 2. rows: every reach's min (one walk outward) and the rise's max
  for (int i = threadIdx.x; i < side * P; i += THREADS) {
    const int r = i / P, j = i - r * P;
    const float* row = lo + r * side + j + H;
    float m = row[0];
#pragma unroll
    for (int k = 0; k < R::NK; ++k) {
#pragma unroll
      for (int d = k == 0 ? 1 : R::at(k - 1) + 1; d <= R::at(k); ++d)
        m = tmin(m, tmin(row[-d], row[d]));
      rowmin[k * side * P + i] = m;
    }
    if (st.rise > 0) {
      const float* hrow = hi + r * side + j + H;
      float x = hrow[0];
      for (int d = 1; d <= st.rise; ++d) x = tmax(x, tmax(hrow[-d], hrow[d]));
      rowmax[i] = x;
    }
  }
  __syncthreads();

  // 3. columns, and each texel's values
  const float pa = __ldg(p.planes + layer * p.plane_stride);
  const float pb = __ldg(p.planes + layer * p.plane_stride + 1);
  const float pc = __ldg(p.planes + layer * p.plane_stride + 2);
  const float e = __ldg(p.eps + layer * p.eps_stride);
  for (int i = threadIdx.x; i < P * P; i += THREADS) {
    const int r = i / P, j = i - r * P;
    const int centre = (r + H) * side + j + H;
    int v = 0;
#pragma unroll
    for (int k = 0; k < R::NK; ++k, ++v) {
      const float* col = rowmin + k * side * P + (r + H) * P + j;
      float m = col[0];
#pragma unroll
      for (int d = 1; d <= R::at(k); ++d)
        m = tmin(m, tmin(col[-d * P], col[d * P]));
      vals[v * P * P + i] = __fsub_rn(hi[centre], m);
    }
    if (st.rise > 0) {
      const float* col = rowmax + (r + H) * P + j;
      float x = col[0];
      for (int d = 1; d <= st.rise; ++d)
        x = tmax(x, tmax(col[-d * P], col[d * P]));
      vals[v * P * P + i] = __fsub_rn(x, lo[centre]);
      ++v;
    }
    if (st.resid) {
      const float u = __fmul_rn(__fadd_rn((float)(tx0 + j), 0.5f), p.inv_s);
      const float w = __fmul_rn(__fadd_rn((float)(ty0 + r), 0.5f), p.inv_s);
      const float plane =
          __fadd_rn(__fadd_rn(__fmul_rn(pa, u), __fmul_rn(pb, w)), pc);
      const float res = __fsub_rn(lo[centre], plane);
      vals[v * P * P + i] = neg(__fsub_rn(res, e));
      vals[(v + 1) * P * P + i] = __fadd_rn(res, e);
    }
  }
  __syncthreads();

  // 4. cell maxima: down each texel column of a cell row (neighbouring
  // threads on neighbouring columns, no bank conflict), then across the
  // cell's columns
  const int c = st.cell, cells = tc * tc;
  for (int i = threadIdx.x; i < L.nv * tc * P; i += THREADS) {
    const int k = i / (tc * P), rest = i - k * tc * P;
    const int ccy = rest / P, j = rest - ccy * P;
    const float* col = vals + k * P * P + ccy * c * P + j;
    float m = col[0];
    for (int q = 1; q < c; ++q) m = keep_max(m, col[q * P]);
    part[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L.nv * cells; i += THREADS) {
    const int k = i / cells, cell = i - k * cells;
    const int ccy = cell / tc, ccx = cell - ccy * tc;
    const int gy = cy0 + ccy, gx = cx0 + ccx;
    if (gy >= p.Sc || gx >= p.Sc) continue;
    const float* pr = part + (k * tc + ccy) * P + ccx * c;
    float m = pr[0];
    for (int q = 1; q < c; ++q) m = keep_max(m, pr[q]);
    int col;
    if (k < st.nk) {
      col = st.col0 + k;
    } else if (st.rise > 0 && k == st.nk) {
      col = 5;
    } else {
      const int which = k - st.nk - (st.rise > 0 ? 1 : 0);
      col = 6 + which;
      if (which == 0) m = neg(m);
    }
    p.out[((long long)layer * p.Sc * p.Sc + (long long)gy * p.Sc + gx) * ROW
          + col] = m;
  }
  __syncthreads();
}

template <bool POOLED>
__global__ void __launch_bounds__(THREADS, 2)
class_maps_kernel(Params p, Stage first, Stage second) {
  extern __shared__ float sm[];
  const int layer = blockIdx.z;
  const int cy0 = blockIdx.y * p.tc, cx0 = blockIdx.x * p.tc;
  if (POOLED) {
    run_stage<FINE_RUNG>(p, first, layer, cy0, cx0, sm);
    run_stage<HALF>(p, second, layer, cy0, cx0, sm);
  } else {
    run_stage<FULL>(p, first, layer, cy0, cx0, sm);
  }
}

Stage fine_stage(int S, int coarse, bool pooled, int rise) {
  Stage st{};
  st.n = S;
  st.cell = coarse;
  st.pooled = false;
  st.resid = true;
  st.col0 = 0;
  if (pooled) {
    st.nk = Reach<FINE_RUNG>::NK;
    st.rise = 0;
    st.halo = Reach<FINE_RUNG>::at(0);
  } else {
    const int top = Reach<FULL>::at(N_LADDER - 1);
    st.nk = Reach<FULL>::NK;
    st.rise = rise;
    st.halo = rise > top ? rise : top;
  }
  return st;
}

Stage pooled_stage(int S, int coarse, int rise) {
  Stage st{};
  st.n = S / 2;
  st.cell = coarse / 2;
  st.pooled = true;
  st.resid = false;
  st.col0 = 1;
  const int top = Reach<HALF>::at(Reach<HALF>::NK - 1);
  st.nk = Reach<HALF>::NK;
  st.rise = rise;
  st.halo = rise > top ? rise : top;
  return st;
}

}  // namespace

extern "C" {

// Bytes of shared memory a block takes for these arguments.
int class_maps_smem(int S, int coarse, int pooled, int rise, int tc) {
  const Layout a = layout(fine_stage(S, coarse, pooled != 0, rise), tc);
  if (!pooled) return a.total * (int)sizeof(float);
  const Layout b = layout(pooled_stage(S, coarse, rise), tc);
  return (a.total > b.total ? a.total : b.total) * (int)sizeof(float);
}

// rise: the rise window (unpooled) or its half reach (pooled), 0..34.
// Returns a CUDA error code (0 = launched).
int class_maps_launch(const float* maps, long long L, int S, int coarse,
                      int pooled, int rise, int tc, const float* planes,
                      long long plane_stride, const float* eps,
                      long long eps_stride, float inv_s, float* out,
                      void* stream) {
  Params p;
  p.maps = maps;
  p.planes = planes;
  p.eps = eps;
  p.out = out;
  p.plane_stride = plane_stride;
  p.eps_stride = eps_stride;
  p.S = S;
  p.Sc = S / coarse;
  p.tc = tc;
  p.inv_s = inv_s;
  const Stage first = fine_stage(S, coarse, pooled != 0, rise);
  const Stage second = pooled ? pooled_stage(S, coarse, rise) : first;
  const int smem = class_maps_smem(S, coarse, pooled, rise, tc);
  const auto kernel = pooled ? class_maps_kernel<true>
                             : class_maps_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.Sc + tc - 1) / tc;
  const dim3 grid(tiles, tiles, (unsigned)L);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p, first, second);
  return (int)cudaGetLastError();
}

}  // extern "C"
