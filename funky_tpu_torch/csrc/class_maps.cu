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
// What bounds it on this card: the instructions and shared-memory
// traffic of the window walks and the latency of the block's phases
// between barriers, far ahead of the bytes (the map read once and the
// rows written, ~69 MB on the shipped frame's 4 x 2048^2 maps, ~0.021 ms
// at 3.35 TB/s). Walking every reach outward from the centre would take
// ~100 shared loads and min / max per pooled texel, most of them repeated
// between the reaches.
//
// Design: one block per tile of tc x tc cells of one cascade, in two
// stages (pooled: the full-resolution rung and the residuals, then the
// pooled rungs and the rise; unpooled: one stage), each staging its
// haloed window once, BORDER_DEPTH outside the map: the fine window by
// cp.async in 16-byte chunks (they bypass the L1, which three blocks'
// shared memory leaves small: loaded through registers it took a quarter
// of the block's time), the pooled window by loads four texels a thread
// in flight, pooled on the fly. A square window is a row window
// of a column window, and a reach r + s window is three reach r windows
// shifted by -s, 0, +s (for s <= 2r + 1), as the twin composes its
// dilations; the axes commute. So the ladder is one chain of 1-D passes
// that alternate between the columns and the rows: each applies the last
// step of one rung (the square of that rung is then complete: it is
// emitted at the core into a small core plane) and the first step of the
// next (3 -> 6 -> 10 -> 17 on the pooled maps: NK + 1 = 5 passes for 4
// rungs, each 3 taps whatever the reach); the rise takes one pass each
// way (its base reach and one step; past reach 10, 3-tap steps follow).
// A pass gives each thread a run of RUN outputs along its axis: it loads
// the run and its neighbours once, applies its steps in registers and
// stores the run transposed, so that the next pass walks the other axis
// the same way (neighbouring threads on neighbouring columns, odd
// pitches: no bank conflicts). Each pass works only on the part of the
// window the passes after it need. A rung's cell maxima are taken from
// its core plane while the next pass runs: down each texel column of a
// cell row, then across the cell's columns by warp shuffles (a cell a
// power of two of lanes; else through shared partials), into one shared
// row per cell, and the block writes its rows as float4s. The wrapper
// picks tc so that three blocks fit on an SM (4 x 4 cells at coarse 16,
// 8 x 8 at coarse 8): the phases' latency, not the halo's work, set the
// time of larger tiles at one or two blocks per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW = 8;        // floats per output row
constexpr int RUN = 8;        // outputs per thread along a pass's axis
constexpr int POOL_BATCH = 4;    // pooled texels a thread loads at once
constexpr float BORDER = 1.0f;

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

template <bool MAX>
__device__ __forceinline__ float op(float a, float b) {
  return MAX ? tmax(a, b) : tmin(a, b);
}

// The min reaches of each kind of stage, known to the compiler so that
// the passes unroll: the pooled branch's full-resolution rung, its half
// reaches (r + 1) / 2 on the pooled maps, the full-resolution ladder.
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
  static constexpr int NK = 5;
  __host__ __device__ static constexpr int at(int k) {
    return k == 0 ? 3 : k == 1 ? 6 : k == 2 ? 12 : k == 3 ? 20 : 34;
  }
};

// One stage's geometry, in the stage's own texels (fine or pooled). The
// window is the tile's P x P core with `halo` texels around it; window
// index i is stage texel t0 - halo + i on each axis. Each buffer holds
// (side + RUN) rows of `pitch` (odd) floats: a pass's last run may read
// up to RUN - 1 rows past the window, into values it does not store.
struct Stage {
  int n;           // the stage's map side (S or S / 2)
  int cell;        // texels per cell side
  int halo;        // the largest reach, of the ladder or the rise
  int rise;        // the rise's max reach, 0 = none
  int col0;        // output column of the first min reach
  bool pooled;     // texels are 2x2 pools of the fine map
  bool resid;      // also the residual columns 6 and 7 (fine stages)
};

struct Geo {
  int P, side, pitch, sp, buf, nv;
};

// pitch: the pass buffers' (odd: transposed stores meet no bank
// conflict); sp: the staged fine window's (16-byte rows with room for
// the window to start anywhere in its first 16 bytes); buf: the floats of
// each buffer of the stage, a multiple of 4.
__host__ __device__ inline Geo geo(const Stage& st, int nk, int tc) {
  Geo g;
  g.P = tc * st.cell;
  g.side = g.P + 2 * st.halo;
  g.pitch = g.side | 1;
  g.sp = (g.side + 6) & ~3;
  g.buf = ((g.side + RUN) * (st.pooled ? g.pitch : g.sp) + 3) & ~3;
  g.nv = nk + (st.rise > 0 ? 1 : 0) + (st.resid ? 2 : 0);
  return g;
}

// Shared floats of a stage: its window buffers (the staged window, X,
// and Y where a second rung or a rise follows the first: `with_y`), its
// core planes of P x (P + 1) (two, or one for a lone rung) and, in the
// pooled stage, the hi core (P x P).
__host__ __device__ inline bool with_y(const Stage& st, int nk) {
  return st.pooled || nk > 1 || st.rise > 0;
}
__host__ __device__ inline int stage_bufs(const Stage& st, int nk, int tc) {
  const Geo g = geo(st, nk, tc);
  const bool y = with_y(st, nk);
  return (y ? 3 : 2) * g.buf + (y ? 2 : 1) * g.P * (g.P + 1)
         + (st.pooled ? g.P * g.P : 0);
}
__host__ __device__ inline int stage_part(const Stage& st, int nk, int tc) {
  const Geo g = geo(st, nk, tc);
  const int c = st.cell;
  return c <= 32 && (c & (c - 1)) == 0 ? 0 : g.nv * tc * g.P;
}

struct Params {
  const float* __restrict__ maps;    // (L, S, S)
  const float* __restrict__ planes;  // (L, 3), row stride plane_stride
  const float* __restrict__ eps;     // (L,), stride eps_stride
  float* __restrict__ out;           // (L * Sc * Sc, 8)
  long long plane_stride, eps_stride;
  int S, Sc, tc;
  int part_floats;                   // the largest stage's partials
  bool vec;                          // the map's rows are 16-B aligned
  float inv_s;
};

// A window buffer read as (a, b): a its rows.
struct Buf {
  static constexpr bool ADD0 = false;
  const float* p;
  int pitch;
  __device__ __forceinline__ float operator()(int a, int b) const {
    return p[a * pitch + b];
  }
};

// The staged fine window: the map as it is, read plus 0.0.
struct Fine {
  static constexpr bool ADD0 = true;
  const float* p;
  int pitch;
  __device__ __forceinline__ float operator()(int a, int b) const {
    return __fadd_rn(p[a * pitch + b], 0.0f);
  }
};

// The hi core of the pooled stage, read at window indices.
struct Core {
  const float* p;
  int P, halo;
  __device__ __forceinline__ float operator()(int a, int b) const {
    return p[(a - halo) * P + b - halo];
  }
};

// Calls f(run, b) for the items of a pass (nb columns of nruns runs, b
// fastest), THREADS apart, without a division per item.
template <class F>
__device__ __forceinline__ void for_items(int nb, int nruns, const F& f) {
  int run = threadIdx.x / nb, b = threadIdx.x - run * nb;
  const int dr = THREADS / nb, db = THREADS - dr * nb;
  while (run < nruns) {
    f(run, b);
    run += dr;
    b += db;
    if (b >= nb) {
      b -= nb;
      ++run;
    }
  }
}

// One step of a pass in registers: v[j] = op(v[j - S], v[j], v[j + S])
// over [LO + S, HI - S), the values valid before over [LO, HI).
template <int S, int LO, int HI, bool MAX, int N>
__device__ __forceinline__ void step(float (&v)[N]) {
  if constexpr (S > 0) {
    float w[N];
#pragma unroll
    for (int j = LO + S; j < HI - S; ++j)
      w[j] = op<MAX>(op<MAX>(v[j - S], v[j + S]), v[j]);
#pragma unroll
    for (int j = LO + S; j < HI - S; ++j) v[j] = w[j];
  }
}

// A pass down the columns (VERT: a = y, b = x) or along the rows of src
// ([a][b]): for a in [a_lo, a_hi), b in [b_lo, b_hi), the window along a
// of the steps G1, G2, G3 (a rung's, 0: none), each out[a] = op(in[a - s],
// in[a], in[a + s]); that window at the core is emitted (when `emit` is
// given) into the core plane emit[y][x] (pitch ep); then the step D (0:
// none), whose window is stored transposed, dst[b * pitch + a] (when
// `dst` is given), for the next pass to walk the other axis. A thread
// takes a run of RUN outputs: RUN + 2 (G1 + G2 + G3 + D) loads, the steps
// in registers.
template <int G1, int G2, int G3, int D, bool MAX, bool VERT, class Src>
__device__ __forceinline__ void pass(const Src& src, float* dst, int pitch,
                                     float* emit, int ep, int H, int P,
                                     int a_lo, int a_hi, int b_lo,
                                     int b_hi) {
  constexpr int G = G1 + G2 + G3, R = G + D, N = RUN + 2 * R;
  for_items(b_hi - b_lo, (a_hi - a_lo + RUN - 1) / RUN, [&](int run, int bb) {
    const int b = b_lo + bb;
    const int a0 = a_lo + run * RUN;
    const float* c = src.p + (a0 - R) * src.pitch + b;
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = Src::ADD0 ? __fadd_rn(c[j * src.pitch], 0.0f) : c[j * src.pitch];
    step<G1, 0, N, MAX>(v);
    step<G2, G1, N - G1, MAX>(v);
    step<G3, G1 + G2, N - G1 - G2, MAX>(v);
    if (emit != nullptr && b >= H && b < H + P) {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        const int a = a0 + k;
        if (a >= H && a < H + P) {
          if (VERT)
            emit[(a - H) * ep + b - H] = v[R + k];
          else
            emit[(b - H) * ep + a - H] = v[R + k];
        }
      }
    }
    if (dst != nullptr) {
      step<D, G, N - G, MAX>(v);
      float* o = dst + b * pitch + a0;
      if (a0 + RUN <= a_hi) {
#pragma unroll
        for (int k = 0; k < RUN; ++k) o[k] = v[R + k];
      } else {
#pragma unroll
        for (int k = 0; k < RUN; ++k)
          if (a0 + k < a_hi) o[k] = v[R + k];
      }
    }
  });
}

// One 3-tap step of a reach known only at run time (a rise past reach
// 10): three loads per output.
template <bool MAX>
__device__ __forceinline__ void step_pass(const float* src, float* dst,
                                          int pitch, int s, int a_lo,
                                          int a_hi, int b_lo, int b_hi) {
  for_items(b_hi - b_lo, (a_hi - a_lo + RUN - 1) / RUN, [&](int run, int bb) {
    const int b = b_lo + bb;
    const int a0 = a_lo + run * RUN;
    const float* c = src + a0 * pitch + b;
    float* o = dst + b * pitch + a0;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (a0 + k < a_hi)
        o[k] = op<MAX>(op<MAX>(c[(k - s) * pitch], c[(k + s) * pitch]),
                       c[k * pitch]);
    }
  });
}

struct Tile {
  const Params* p;
  Stage st;
  Geo g;
  int layer, ty0, tx0;             // the tile's first texel
  float* part;                     // (nv, tc, P) partial maxima
  float* rows;                     // (tc * tc, ROW) the tile's rows
  // window index range [lo, hi) of the core widened by e
  __device__ __forceinline__ int lo(int e) const { return st.halo - e; }
  __device__ __forceinline__ int hi(int e) const {
    return st.halo + g.P + e;
  }
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;");
}

// A row span of the fine map, 16-byte aligned: the window columns
// [x0, x0 + width) sit at offset `o` of `floats` (a multiple of 4) from
// column x0 - o.
struct Span {
  int o, floats;
  __device__ __forceinline__ Span(int x0, int width) {
    o = x0 & 3;
    floats = (o + width + 3) & ~3;
  }
};

// Stages the fine window of the tile (side x side from texel (ty0 - H,
// tx0 - H)) into S, row r at S + r * sp, the window's column c at offset
// Span.o + c: the map as it is (the readers add 0.0), BORDER_DEPTH outside
// it. With 16-byte rows (p.vec) by cp.async, 16-byte chunks that bypass
// the L1 (a chunk lies wholly inside or outside the map: its edges are
// multiples of 4), else by loads a warp coalesces.
__device__ __forceinline__ void stage_fine(const Tile& t, float* S, int sp) {
  const Params& p = *t.p;
  const int side = t.g.side, H = t.st.halo;
  const int y0 = t.ty0 - H, x0 = t.tx0 - H;
  const Span sp_ = Span(x0, side);
  const int xa = x0 - sp_.o;
  const float* map = p.maps + (long long)t.layer * p.S * p.S;
  if (p.vec) {
    const int q4 = sp_.floats / 4;
    for (int i = threadIdx.x; i < side * q4; i += THREADS) {
      const int r = i / q4, q = i - r * q4;
      const int gy = y0 + r, gx = xa + 4 * q;
      float* d = S + r * sp + 4 * q;
      if (gy >= 0 && gy < p.S && gx >= 0 && gx < p.S)
        cp16(d, map + (long long)gy * p.S + gx);
      else
        *reinterpret_cast<float4*>(d) =
            make_float4(BORDER, BORDER, BORDER, BORDER);
    }
    cp_wait_all();
  } else {
    for (int i = threadIdx.x; i < side * sp_.floats; i += THREADS) {
      const int r = i / sp_.floats, c = i - r * sp_.floats;
      const int gy = y0 + r, gx = xa + c;
      S[r * sp + c] = gy >= 0 && gy < p.S && gx >= 0 && gx < p.S
                          ? __ldg(map + (long long)gy * p.S + gx)
                          : BORDER;
    }
  }
}

// Stages the pooled window of the tile (side x side pooled texels) into
// lo (min) and hi (max) of the 2x2 pools of the map plus 0.0, BORDER_DEPTH
// outside the pooled map, POOL_BATCH texels a thread in flight. (Staging
// the fine rows by cp.async and pooling them from shared memory was
// slower: the pooling's shared loads cost more than the loads' latency.)
__device__ __forceinline__ void stage_pooled(const Tile& t, float* lo,
                                             float* hi) {
  const Params& p = *t.p;
  const int side = t.g.side, pitch = t.g.pitch, H = t.st.halo;
  const int n = t.st.n;
  const int y0 = t.ty0 - H, x0 = t.tx0 - H;   // pooled texels
  const float* map = p.maps + (long long)t.layer * p.S * p.S;
  for (int i0 = threadIdx.x; i0 < side * side; i0 += THREADS * POOL_BATCH) {
    float v[POOL_BATCH][4];
#pragma unroll
    for (int u = 0; u < POOL_BATCH; ++u) {
      const int i = i0 + u * THREADS;
      const int r = i / side, c = i - r * side;
      const int gy = y0 + r, gx = x0 + c;
      v[u][0] = v[u][1] = v[u][2] = v[u][3] = BORDER;
      if (i < side * side && gy >= 0 && gy < n && gx >= 0 && gx < n) {
        const float* r0p = map + (long long)(2 * gy) * p.S + 2 * gx;
        v[u][0] = __ldg(r0p);
        v[u][1] = __ldg(r0p + 1);
        v[u][2] = __ldg(r0p + p.S);
        v[u][3] = __ldg(r0p + p.S + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < POOL_BATCH; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= side * side) break;
      const int r = i / side, c = i - r * side;
      const float a = __fadd_rn(v[u][0], 0.0f), b = __fadd_rn(v[u][1], 0.0f);
      const float cc = __fadd_rn(v[u][2], 0.0f);
      const float d = __fadd_rn(v[u][3], 0.0f);
      // _pool2: rows first, then columns
      hi[r * pitch + c] = tmax(tmax(a, cc), tmax(b, d));
      lo[r * pitch + c] = tmin(tmin(a, cc), tmin(b, d));
    }
  }
}

// A square window at the tile's core, read as (y, x) in core texels: a
// core plane (off 0) or a window buffer (off = the halo).
struct Plane {
  const float* p;
  int pitch, off;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return p[(y + off) * pitch + x + off];
  }
};

// Whether a stage's cell maxima are taken across lanes: its cells are c
// neighbouring lanes of a warp (c a power of two up to 32). Else they go
// through part and cell_rows.
__host__ __device__ inline bool lane_cells(int c) {
  return c <= 32 && (c & (c - 1)) == 0;
}

// Hands one lane's value m of cell row cy at core column x (of items
// [0, n), `on` for this lane's) to its cell: the max (MIN: the min) over
// the cell's columns across its lanes, into column `col` of the tile's
// rows; or part[v] for cell_rows. All lanes of a warp call it together.
template <bool MIN>
__device__ __forceinline__ void to_cell(const Tile& t, int v, int col,
                                        bool on, int cy, int x, float m) {
  const int c = t.st.cell, P = t.g.P, tc = t.p->tc;
  if (lane_cells(c)) {
    for (int o = 1; o < c; o <<= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, m, o);
      m = MIN ? tmin(m, w) : tmax(m, w);
    }
    if (on && (x & (c - 1)) == 0) t.rows[(cy * tc + x / c) * ROW + col] = m;
  } else if (on) {
    t.part[(v * tc + cy) * P + x] = m;
  }
}

// The items of a reduction, (cell row, core column) pairs, rounded up to
// whole warps where the cells go across lanes.
__device__ __forceinline__ int reduce_items(const Tile& t) {
  const int n = t.p->tc * t.g.P;
  return lane_cells(t.st.cell) ? (n + 31) & ~31 : n;
}

// Column `col` (partial v) of the cells: the max over each cell of centre -
// sq (a min window, DROP) or sq - centre (the rise), the centre read at
// window indices. Every NaN here is the canonical one (the map was taken
// plus 0.0, and every value since is a min, max or _rn difference), so
// max.NaN keeps torch's amax bits.
template <bool DROP, class Centre>
__device__ __forceinline__ void reduce_window(const Tile& t, int v, int col,
                                              const Plane& sq,
                                              const Centre& centre) {
  const int P = t.g.P, c = t.st.cell, H = t.st.halo, n = t.p->tc * P;
  for (int i = threadIdx.x; i < reduce_items(t); i += THREADS) {
    const bool on = i < n;
    const int cy = i / P, x = i - cy * P;
    float m = -INFINITY;
    if (on) {
#pragma unroll 4
      for (int q = 0; q < c; ++q) {
        const int y = cy * c + q;
        const float w = sq(y, x);
        const float ctr = centre(H + y, H + x);
        m = tmax(m, DROP ? __fsub_rn(ctr, w) : __fsub_rn(w, ctr));
      }
    }
    to_cell<false>(t, v, col, on, cy, x, m);
  }
}

// Columns 6 and 7 (partials v, v + 1): the cells' min of resid - eps and
// max of resid + eps over the fine core (x the staged fine window); with
// DROP also the last rung's column (partial v - 1: no rise follows it),
// the cells' max of x - sq, sq that rung's square, off the same loads. The twin's min, -max(-(...)), is the min: its NaN is the
// canonical one after the two negations, and no -0 meets a +0 (resid is
// never -0).
template <bool DROP, class X>
__device__ __forceinline__ void reduce_resid(const Tile& t, int v,
                                             const X& x, const Plane& sq) {
  const Params& p = *t.p;
  const int P = t.g.P, c = t.st.cell, H = t.st.halo, n = p.tc * P;
  const float pa = __ldg(p.planes + t.layer * p.plane_stride);
  const float pb = __ldg(p.planes + t.layer * p.plane_stride + 1);
  const float pc = __ldg(p.planes + t.layer * p.plane_stride + 2);
  const float e = __ldg(p.eps + t.layer * p.eps_stride);
  for (int i = threadIdx.x; i < reduce_items(t); i += THREADS) {
    const bool on = i < n;
    const int cy = i / P, j = i - cy * P;
    const float u = __fmul_rn(__fadd_rn((float)(t.tx0 + j), 0.5f), p.inv_s);
    const float au = __fmul_rn(pa, u);
    float lo = INFINITY, hi = -INFINITY, drop = -INFINITY;
    if (on) {
#pragma unroll 4
      for (int q = 0; q < c; ++q) {
        const int r = cy * c + q;
        const float w = __fmul_rn(__fadd_rn((float)(t.ty0 + r), 0.5f),
                                  p.inv_s);
        const float plane = __fadd_rn(__fadd_rn(au, __fmul_rn(pb, w)), pc);
        const float xv = x(H + r, H + j);
        const float res = __fsub_rn(xv, plane);
        lo = tmin(lo, __fsub_rn(res, e));
        hi = tmax(hi, __fadd_rn(res, e));
        if (DROP) drop = tmax(drop, __fsub_rn(xv, sq(r, j)));
      }
    }
    if (DROP) to_cell<false>(t, v - 1, t.st.col0 + v - 1, on, cy, j, drop);
    to_cell<true>(t, v, 6, on, cy, j, lo);
    to_cell<false>(t, v + 1, 7, on, cy, j, hi);
  }
}

// The tile's working buffers: the staged window S (lo), two pass
// buffers X and Y, two core planes C[2] that the passes emit the rungs
// into (one read by a reduction while the next pass emits into the
// other).
struct Bufs {
  float *S, *X, *Y, *C[2];
  int cp;    // the core planes' pitch, P + 1
};

struct Nothing {
  __device__ __forceinline__ void operator()() const {}
};

// The min ladder over lo (a window buffer), each rung's square emitted at
// the core into C[k & 1] and its cell maxima taken from there during the
// pass after it. Passes alternate down the columns and along the rows;
// pass j applies rung j - 2's last step, emits rung j - 2 and applies rung
// j - 1's step ([1, 2] the base reach 3), so NK rungs take NK + 1 passes,
// each over the window widened by what the passes after it still need.
// Rung K leaves its partial maxima in part[K]; `pending` runs beside the
// first pass, `centre` is the drops' hi.
template <int KIND, int J, class Lo, class Centre, class Pending>
__device__ __forceinline__ void ladder(const Tile& t, const Bufs& b,
                                       const Lo& lo, const Centre& centre,
                                       const Pending& pending) {
  using R = Reach<KIND>;
  constexpr int NK = R::NK, TOP = R::at(NK - 1);
  constexpr bool VERT = (J & 1) == 0;    // J = 0 walks the columns
  // the steps this pass applies: the last of rung J - 1 (emitted), then
  // the first of rung J (stored)
  constexpr int EMITS = J - 1;           // the rung emitted, -1: none
  constexpr int G = J == 0 ? 0 : J == 1 ? 3 : R::at(J - 1) - R::at(J - 2);
  constexpr int D = J >= NK ? 0 : J == 0 ? 3 : R::at(J) - R::at(J - 1);
  // the reach on the pass's axis after it, and on the other axis
  constexpr int ra = J >= NK ? TOP : R::at(J);
  constexpr int rb = J == 0 ? 0 : R::at(J - 1);
  const int P = t.g.P, H = t.st.halo, pitch = t.g.pitch;
  const Buf src{(J & 1) ? b.X : b.Y, pitch};   // after the first pass
  float* dst = J >= NK ? nullptr : ((J & 1) ? b.Y : b.X);
  float* emit = EMITS >= 0 ? b.C[EMITS & 1] : nullptr;
  const int a_lo = t.lo(TOP - ra), a_hi = t.hi(TOP - ra);
  const int b_lo = t.lo(TOP - rb), b_hi = t.hi(TOP - rb);
  if constexpr (J == 0) {
    pass<1, 2, 0, 0, false, VERT>(lo, dst, pitch, nullptr, 0, H, P, a_lo,
                                  a_hi, b_lo, b_hi);
    pending();
  } else if constexpr (J == 1) {
    pass<1, 2, 0, D, false, VERT>(src, dst, pitch, emit, b.cp, H, P, a_lo,
                                  a_hi, b_lo, b_hi);
  } else {
    pass<G, 0, 0, D, false, VERT>(src, dst, pitch, emit, b.cp, H, P, a_lo,
                                  a_hi, b_lo, b_hi);
  }
  if constexpr (J >= 2)
    reduce_window<true>(t, J - 2, t.st.col0 + J - 2,
                        Plane{b.C[(J - 2) & 1], b.cp, 0}, centre);
  __syncthreads();
  if constexpr (J < NK) ladder<KIND, J + 1>(t, b, lo, centre, Nothing{});
}

// The rise's window pass for reach R <= 10 (the base reach min(R, 3),
// then one step of R - 3), or the base and a step of 7 (reach 10) for a
// longer one, down the columns or along the rows.
template <bool VERT, class Src>
__device__ __forceinline__ void rise_pass(int R, const Src& src, float* dst,
                                          int pitch, float* emit, int ep,
                                          int H, int P, int a_lo, int a_hi,
                                          int b_lo, int b_hi) {
#define RISE_PASS(G2, G3)                                                  \
  pass<1, G2, G3, 0, true, VERT>(src, dst, pitch, emit, ep, H, P, a_lo,    \
                                 a_hi, b_lo, b_hi)
  switch (R) {
    case 1: RISE_PASS(0, 0); break;
    case 2: RISE_PASS(1, 0); break;
    case 3: RISE_PASS(2, 0); break;
    case 4: RISE_PASS(2, 1); break;
    case 5: RISE_PASS(2, 2); break;
    case 6: RISE_PASS(2, 3); break;
    case 7: RISE_PASS(2, 4); break;
    case 8: RISE_PASS(2, 5); break;
    case 9: RISE_PASS(2, 6); break;
    default: RISE_PASS(2, 7); break;
  }
#undef RISE_PASS
}

// The rise over hi: down the columns into X (`pending` beside it), then
// along the rows, emitted into C[0] (reach <= 10), or into Y and on by
// 3-tap steps of s <= 2r + 1 (r the reach so far). Returns the plane of
// the rise's square at the core.
template <class Src, class Pending>
__device__ __forceinline__ Plane rise_chain(const Tile& t, const Bufs& b,
                                            const Src& hi,
                                            const Pending& pending) {
  const int R = t.st.rise, pitch = t.g.pitch, H = t.st.halo, P = t.g.P;
  const int r0 = R < 10 ? R : 10;
  rise_pass<true>(R, hi, b.X, pitch, nullptr, 0, H, P, t.lo(R - r0),
                  t.hi(R - r0), t.lo(R), t.hi(R));
  pending();
  __syncthreads();
  if (R <= 10) {
    rise_pass<false>(R, Buf{b.X, pitch}, nullptr, pitch, b.C[0], b.cp, H, P,
                     t.lo(0), t.hi(0), t.lo(0), t.hi(0));
    __syncthreads();
    return Plane{b.C[0], b.cp, 0};
  }
  rise_pass<false>(R, Buf{b.X, pitch}, b.Y, pitch, nullptr, 0, H, P,
                   t.lo(R - r0), t.hi(R - r0), t.lo(R - r0), t.hi(R - r0));
  __syncthreads();
  for (int r = r0; r < R;) {
    const int s = min(2 * r + 1, R - r);
    r += s;
    step_pass<true>(b.Y, b.X, pitch, s, t.lo(R - r), t.hi(R - r),
                    t.lo(R - r + s), t.hi(R - r + s));
    __syncthreads();
    step_pass<true>(b.X, b.Y, pitch, s, t.lo(R - r), t.hi(R - r),
                    t.lo(R - r), t.hi(R - r));
    __syncthreads();
  }
  return Plane{b.Y, pitch, H};
}

// The stage's cell rows: each partial's max (the residual min column's
// min) across the cell's columns, into the tile's shared rows.
__device__ __forceinline__ void cell_rows(const Tile& t, int nk) {
  const int tc = t.p->tc, cells = tc * tc, c = t.st.cell, P = t.g.P;
  const int resid0 = nk + (t.st.rise > 0 ? 1 : 0);
  for (int i = threadIdx.x; i < t.g.nv * cells; i += THREADS) {
    const int k = i / cells, cell = i - k * cells;
    const int ccy = cell / tc, ccx = cell - ccy * tc;
    const float* pr = t.part + (k * tc + ccy) * P + ccx * c;
    const bool is_min = t.st.resid && k == resid0;
    float m = pr[0];
    for (int q = 1; q < c; ++q) m = is_min ? tmin(m, pr[q]) : tmax(m, pr[q]);
    int col = 6 + (k - resid0);   // the residual columns
    if (k < nk) {
      col = t.st.col0 + k;
    } else if (k < resid0) {      // the rise
      col = 5;
    }
    t.rows[cell * ROW + col] = m;
  }
}

// The buffers of a stage, laid out from `bufs` (csrc's stage_bufs).
__device__ __forceinline__ Bufs bufs_of(const Tile& t, float* bufs,
                                        bool with_y) {
  Bufs b;
  const int P = t.g.P;
  b.cp = P + 1;
  b.S = bufs;
  b.X = bufs + t.g.buf;
  b.Y = with_y ? bufs + 2 * t.g.buf : nullptr;
  b.C[0] = bufs + (with_y ? 3 : 2) * t.g.buf;
  b.C[1] = with_y ? b.C[0] + P * b.cp : nullptr;
  return b;
}

// A stage over the fine map (the pooled branch's rung 3 and residuals, or
// the whole unpooled ladder and rise): the window staged once in S.
template <int KIND>
__device__ __forceinline__ void fine_stage(const Params& p, const Stage& st,
                                           int layer, int cy0, int cx0,
                                           float* part, float* rows,
                                           float* bufs) {
  constexpr int NK = Reach<KIND>::NK;
  const Tile t{&p, st, geo(st, NK, p.tc), layer, cy0 * st.cell,
               cx0 * st.cell, part, rows};
  const Bufs b = bufs_of(t, bufs, with_y(st, NK));
  stage_fine(t, b.S, t.g.sp);
  __syncthreads();
  const Fine x{b.S + Span(t.tx0 - st.halo, t.g.side).o, t.g.sp};
  ladder<KIND, 0>(t, b, x, x, Nothing{});
  const Plane last{b.C[(NK - 1) & 1], b.cp, 0};
  if (st.rise > 0) {
    const Plane rise = rise_chain(t, b, x, [&] {
      reduce_window<true>(t, NK - 1, st.col0 + NK - 1, last, x);
    });
    reduce_window<false>(t, NK, 5, rise, x);
    reduce_resid<false>(t, NK + 1, x, last);
  } else {   // the last rung's drops beside the residuals
    reduce_resid<true>(t, NK, x, last);
  }
  __syncthreads();
  if (!lane_cells(st.cell)) {
    cell_rows(t, NK);
    __syncthreads();
  }
}

// The pooled branch's second stage: the window's 2x2 pools staged once
// (lo = min into S, hi = max into Y, BORDER outside), the rise over hi
// (its core kept apart, for the drops), then the half-reach rungs over
// lo.
__device__ __forceinline__ void pooled_stage(const Params& p,
                                             const Stage& st, int layer,
                                             int cy0, int cx0, float* part,
                                             float* rows, float* bufs) {
  constexpr int NK = Reach<HALF>::NK;
  const Tile t{&p, st, geo(st, NK, p.tc), layer, cy0 * st.cell,
               cx0 * st.cell, part, rows};
  const int pitch = t.g.pitch, P = t.g.P, H = st.halo;
  const Bufs b = bufs_of(t, bufs, true);
  float* hc = b.C[1] + P * b.cp;
  stage_pooled(t, b.S, b.Y);
  __syncthreads();
  const Buf lo{b.S, pitch};
  const Plane rise = rise_chain(t, b, Buf{b.Y, pitch}, [&] {
    for (int i = threadIdx.x; i < P * P; i += THREADS) {
      const int r = i / P, c = i - r * P;
      hc[i] = b.Y[(H + r) * pitch + H + c];
    }
  });
  const Core hi{hc, P, H};
  ladder<HALF, 0>(t, b, lo, hi,
                  [&] { reduce_window<false>(t, NK, 5, rise, lo); });
  reduce_window<true>(t, NK - 1, st.col0 + NK - 1,
                      Plane{b.C[(NK - 1) & 1], b.cp, 0}, hi);
  __syncthreads();
  if (!lane_cells(st.cell)) {
    cell_rows(t, NK);
    __syncthreads();
  }
}

template <bool POOLED>
__global__ void __launch_bounds__(THREADS, 3)
class_maps_kernel(Params p, Stage first, Stage second) {
  extern __shared__ float4 sm4[];
  float* rows = reinterpret_cast<float*>(sm4);
  const int tc = p.tc;
  float* part = rows + tc * tc * ROW;
  float* bufs = part + p.part_floats;
  const int layer = blockIdx.z;
  const int cy0 = blockIdx.y * tc, cx0 = blockIdx.x * tc;
  if constexpr (POOLED) {
    fine_stage<FINE_RUNG>(p, first, layer, cy0, cx0, part, rows, bufs);
    pooled_stage(p, second, layer, cy0, cx0, part, rows, bufs);
  } else {
    fine_stage<FULL>(p, first, layer, cy0, cx0, part, rows, bufs);
  }
  // the tile's rows, two float4 a cell
  for (int i = threadIdx.x; i < tc * tc * 2; i += THREADS) {
    const int cell = i >> 1;
    const int ccy = cell / tc, ccx = cell - ccy * tc;
    const int gy = cy0 + ccy, gx = cx0 + ccx;
    if (gy >= p.Sc || gx >= p.Sc) continue;
    float4* o = reinterpret_cast<float4*>(
        p.out + ((long long)layer * p.Sc * p.Sc + (long long)gy * p.Sc + gx)
                    * ROW);
    o[i & 1] = sm4[i];
  }
}

Stage fine_stage_of(int S, int coarse, bool pooled, int rise) {
  Stage st{};
  st.n = S;
  st.cell = coarse;
  st.pooled = false;
  st.resid = true;
  st.col0 = 0;
  if (pooled) {
    st.rise = 0;
    st.halo = Reach<FINE_RUNG>::at(0);
  } else {
    const int top = Reach<FULL>::at(Reach<FULL>::NK - 1);
    st.rise = rise;
    st.halo = rise > top ? rise : top;
  }
  return st;
}

Stage pooled_stage_of(int S, int coarse, int rise) {
  Stage st{};
  st.n = S / 2;
  st.cell = coarse / 2;
  st.pooled = true;
  st.resid = false;
  st.col0 = 1;
  const int top = Reach<HALF>::at(Reach<HALF>::NK - 1);
  st.rise = rise;
  st.halo = rise > top ? rise : top;
  return st;
}

struct Sizes {
  int part, bufs;
};

Sizes sizes(int S, int coarse, bool pooled, int rise, int tc) {
  Sizes z;
  if (pooled) {
    const Stage a = fine_stage_of(S, coarse, true, rise);
    const Stage b = pooled_stage_of(S, coarse, rise);
    const int pa = stage_part(a, Reach<FINE_RUNG>::NK, tc);
    const int pb = stage_part(b, Reach<HALF>::NK, tc);
    const int ba = stage_bufs(a, Reach<FINE_RUNG>::NK, tc);
    const int bb = stage_bufs(b, Reach<HALF>::NK, tc);
    z.part = pa > pb ? pa : pb;
    z.bufs = ba > bb ? ba : bb;
  } else {
    const Stage a = fine_stage_of(S, coarse, false, rise);
    z.part = stage_part(a, Reach<FULL>::NK, tc);
    z.bufs = stage_bufs(a, Reach<FULL>::NK, tc);
  }
  z.part = (z.part + 3) & ~3;   // keeps the buffers 16-B aligned
  return z;
}

}  // namespace

extern "C" {

// Bytes of shared memory a block takes for these arguments.
int class_maps_smem(int S, int coarse, int pooled, int rise, int tc) {
  const Sizes z = sizes(S, coarse, pooled != 0, rise, tc);
  return (tc * tc * ROW + z.part + z.bufs) * (int)sizeof(float);
}

// rise: the rise window (unpooled) or its half reach (pooled), 1..34.
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
  p.part_floats = sizes(S, coarse, pooled != 0, rise, tc).part;
  p.vec = ((uintptr_t)maps & 15) == 0 && S % 4 == 0;
  p.inv_s = inv_s;
  const Stage first = fine_stage_of(S, coarse, pooled != 0, rise);
  const Stage second = pooled ? pooled_stage_of(S, coarse, rise) : first;
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
