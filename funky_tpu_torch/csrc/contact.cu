// Contact shadows for Hopper (sm_90a): the screen-space ray toward the
// light of every pixel of a domain (K8), the stage-2 probe certificate of
// the compacted candidates (K9 certify) and the exact march of the
// survivors (K9 march).
//
// K8 contact_front_launch replaces the jnp stages funky_tpu/passes/
// contact.py::_ray_setup (:76-121), _jitter / _jitter_at (:197-212) and
// _segment_cert (:496-587); K9 contact_certify_launch replaces
// _stage2_certify (:590-608) with its level-0 min reads (:466-493),
// contact_certify_compact_launch the same and stage 3's compaction
// (:760-770: the survivors of the stage-2 slots, compacted into the
// march's slots), and contact_march_launch replaces _march (:124-186) and
// _soft_term (:189-194) with the dual depth reads of funky_tpu/ops/
// sampling.py (:437-516). XLA fuses each into a few fusions on the TPU.
// Their plain twins are funky_tpu_torch/passes/contact.py::
// _contact_front_plain, _contact_certify_plain,
// _contact_certify_compact_plain and _contact_march_plain: hundreds of
// elementwise launches over the domain, the candidates' (cap, 7) payload
// gathered twice, each probe's quad rows gathered through K3, and a
// stable argsort over the stage-2 slots.
//
// Semantics (identical to the plain twins on the card):
//   - K8, one pixel: n.l as torch's sum over the last axis of three
//     products reduces it on the card ((x * lx + z * lz) + y * ly: two
//     lanes, the first taking elements 0 and 2); the ray from world +
//     normal * 0.01 to it + light_dir * 0.5, each end through
//     math3d.apply_rows' [p, 1] x vp (products summed in order) and
//     divided by w (|w| > 1e-12, else 1e-12); the slab clip to
//     [-1, 1]^2 x [0, 1] where |d| > 1e-4; the jitter IGN(frag + frame *
//     (13.37, 17.17)) with torch.remainder (fmod, then + 1 where the
//     result is negative); cand = facing & on screen (& valid); with the
//     residual pyramid's bbox and plane, stage2 = cand & (the segment
//     meets the occluder bbox | its four endpoints are not certified);
//     the payload [march start (3), march dir (3), jitter];
//   - K9 certify, one slot: slots at or past the live count are
//     certified (true); else the payload row at take_rows' index (clamped
//     into range), its 8 probes at t = (k + jitter) / 8 each either off
//     screen or at most the plane bound plus the level-0 box min minus
//     eps (8-texel cells, quad rows of 4 mins); in the compact mode, the
//     slots before the count with slot_valid set and not certified, in
//     slot order: comp2's index of each in out_idx (the first cap of
//     them, the rest -1), out_valid true there, out_count all of them;
//   - K9 march, one slot: 8 linear probes, then 4 bisection steps, each
//     probe the bilinear and the nearest read of the quad at its base
//     texel (prev_depth read directly with quad_pack's edge clamp, or
//     through sample_depth_dual_window's (cw, cw) window at a device
//     origin), linearized (the reciprocal times NEAR * FAR, as torch
//     evaluates a host number over a tensor); the soft term, whose
//     smoothstep over 0.05 is a multiply by 20 (torch's division by a
//     host number on the card); with an index, the term of the slots
//     before the live count written at their pixel of a ones-filled
//     output (scatter_back), else each ray's term where its mask holds.
// Every multiply, add, subtract and divide is an _rn intrinsic (no FMA
// contraction), and min / max / clamp propagate NaN as torch's do, so the
// outputs equal the twins' bit for bit.
//
// What bounds them on this card: K8 its arithmetic and latency more than
// its bytes (a pixel's world, normal and frag, 32 B, in; its payload and
// masks, 30 B, out: ~0.026 ms at the shipped frame's 1,382,400 pixels;
// per pixel two projections, ten correctly rounded divides, two fmod and
// the segment certificate's two intervals). Staging a block's 11-float
// attribute rows in shared memory with 16-byte loads and writing its
// payload and masks through shared memory as 16-byte and 4-byte stores
// (1, 2 or 4 pixels a thread) took 0.084-0.116 ms against this kernel's
// 0.055 ms on that frame (H100): the barriers and shared-memory traffic
// cost more than the rows' unused bytes. K9 the latency of its dependent
// reads (slot index, payload row, then each probe's quad; ~0.002 ms of
// bytes for the shipped frame's 180 K live certificate slots, ~0.001 ms
// for its 52 K marched rays). So each slot's probes are spread over lanes
// and put in flight together: the certificate's 8 probes over 8 lanes (one
// ballot ANDs them), each thread 8 probes of a chunk of slots with all
// the chunk's loads in flight, and its compact mode places the survivors
// itself (a ballot and prefix in the block, a decoupled look-back across
// blocks in ticket order; the twin sorts all the stage-2 slots); the
// march's 8 linear probes over 8 lanes and its 4
// bisection steps as a speculative tree (the 7 midpoints of its first 3
// steps at once, then the one of the 4th), so a marched ray waits for 3
// rounds of reads where one thread a slot waits for a chain of up to 12.
// The tree probes more midpoints than the chain, and with many live rays
// the march is bound by its instruction count, not by that wait: past
// LANES_LIVE_MAX live slots (ops/contact_cuda.py, read on the card) the
// same kernel runs one thread a slot, its grid a thread a slot or more.
// Slots past the live count, read on the card, cost no block of the
// compact certificate (its blocks take chunks by a ticket and stop) and
// no probe of the march, and a ray masked off probes nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW = 7;            // payload floats per ray
constexpr int LINEAR_STEPS = 8;
constexpr int BISECTION_STEPS = 4;
constexpr float FOOT = 2.0f;

// Host numbers as torch rounds them to f32.
constexpr float NORMAL_OFFSET = 0x1.47ae14p-7f;   // 0.01
constexpr float W_EPS = 0x1.197998p-40f;          // 1e-12
constexpr float DIR_EPS = 0x1.a36e2ep-14f;        // 1e-4
constexpr float SEG_EPS = 0x1.0c6f7ap-20f;        // 1e-6
constexpr float FRAME_X = 0x1.abd70ap+3f;         // 13.37
constexpr float FRAME_Y = 0x1.12b852p+4f;         // 17.17
constexpr float IGN_X = 0x1.12e286p-4f;           // 0.06711056
constexpr float IGN_Y = 0x1.7e8b2p-8f;            // 0.00583715
constexpr float IGN_SCALE = 0x1.a7dd04p+5f;       // 52.9829189
constexpr float DEPTH_RANGE = 0x1.8f999ap+6f;     // FAR - NEAR = 99.9
constexpr float NEAR_FAR = 10.0f;                 // NEAR * FAR
constexpr float DENOM_MIN = 0x1.0624dep-10f;      // 1e-3
constexpr float THICKNESS = 0x1.99999ap-5f;       // 0.05
constexpr float INV_THICKNESS = 20.0f;            // f32(1) / f32(0.05)
constexpr float DARKNESS = 0x1.99999ap-1f;        // 0.8

// torch.minimum / torch.maximum: a NaN operand is the result.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// XLA's saturating f32 -> s32 (ops/sampling.py::to_i32).
__device__ __forceinline__ int to_i32(float x) { return __float2int_rz(x); }

// torch.remainder(a, 1.0) on the card: fmod, then + 1 where negative.
__device__ __forceinline__ float rem1(float a) {
  float m = fmodf(a, 1.0f);
  if (m != 0.0f && m < 0.0f) m = __fadd_rn(m, 1.0f);
  return m;
}

// contact.py::_linearize: clamp(FAR - z * (FAR - NEAR), min=1e-3), then
// NEAR * FAR / denom, which torch evaluates as reciprocal(denom) * 10.
__device__ __forceinline__ float linearize(float z) {
  const float denom = tclamp(__fsub_rn(100.0f, __fmul_rn(z, DEPTH_RANGE)),
                             DENOM_MIN, INFINITY);
  return __fmul_rn(__fdiv_rn(1.0f, denom), NEAR_FAR);
}

// The residual pyramid's device values (contact.py::ResidualPyramid).
struct Pyramid {
  const float* __restrict__ occl_lo;   // (2,)
  const float* __restrict__ occl_hi;   // (2,)
  const float* __restrict__ plane;     // (3,)
  const float* __restrict__ eps;       // ()
};

// ---------------------------------------------------------------------
// K8: the front.
// ---------------------------------------------------------------------

struct Front {
  const float* __restrict__ world;
  long long world_stride;
  const float* __restrict__ normal;
  long long normal_stride;
  const float* __restrict__ light;     // light_dir (3,)
  long long light_stride;
  const float* __restrict__ vp;        // (4, 4) row-major
  const float* __restrict__ frame;     // debug_flags[3]
  const float* __restrict__ frag;      // (n, 2), or null: pixel centres
  long long frag_stride;
  const float* __restrict__ y0;        // the slab's first row, or null
  float y0_host;
  int width;                           // the slab's width (no frag)
  const bool* __restrict__ valid;      // or null
  Pyramid pyr;                         // occl_lo null: no certificate
  float size_w, size_h;                // the depth buffer's (W, H)
};

// apply_rows([p, 1], vp) / w: the clip-space point in NDC.
__device__ __forceinline__ void to_cs(const float* vp, const float p[3],
                                      float cs[3]) {
  float clip[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float o = __fmul_rn(p[0], vp[4 * r]);
    o = __fadd_rn(o, __fmul_rn(p[1], vp[4 * r + 1]));
    o = __fadd_rn(o, __fmul_rn(p[2], vp[4 * r + 2]));
    o = __fadd_rn(o, __fmul_rn(1.0f, vp[4 * r + 3]));
    clip[r] = o;
  }
  const float w = fabsf(clip[3]) > W_EPS ? clip[3] : W_EPS;
#pragma unroll
  for (int c = 0; c < 3; ++c) cs[c] = __fdiv_rn(clip[c], w);
}

struct Endpoint {
  float z, pl, q0, q1;
};

__device__ __forceinline__ Endpoint endpoint(const float ms[3],
                                             const float md[3],
                                             const float p0[2],
                                             const float p1[2], float t,
                                             float a, float b, float c) {
  Endpoint e;
  e.z = __fadd_rn(ms[2], __fmul_rn(md[2], t));
  e.q0 = __fadd_rn(p0[0], __fmul_rn(__fsub_rn(p1[0], p0[0]), t));
  e.q1 = __fadd_rn(p0[1], __fmul_rn(__fsub_rn(p1[1], p0[1]), t));
  e.pl = __fadd_rn(__fadd_rn(__fmul_rn(a, e.q0), __fmul_rn(b, e.q1)), c);
  return e;
}

// _segment_cert's interval_ok over [ts, te].
__device__ __forceinline__ bool interval_ok(const float ms[3],
                                            const float md[3],
                                            const float p0[2],
                                            const float p1[2], float ts,
                                            float te, float a, float b,
                                            float c, float m, float thresh,
                                            float one_thresh, float lim_w,
                                            float lim_h) {
  const Endpoint s = endpoint(ms, md, p0, p1, ts, a, b, c);
  const Endpoint e = endpoint(ms, md, p0, p1, te, a, b, c);
  const bool touch = tmin(s.q0, e.q0) < FOOT || tmax(s.q0, e.q0) > lim_w
                     || tmin(s.q1, e.q1) < FOOT || tmax(s.q1, e.q1) > lim_h;
  const float pen = __fadd_rn(m, touch ? m : 0.0f);
  const bool okc =
      __fsub_rn(s.z, __fsub_rn(tclamp_max(s.pl, 1.0f), pen)) <= thresh
      && __fsub_rn(e.z, __fsub_rn(tclamp_max(e.pl, 1.0f), pen)) <= thresh;
  const bool case_a = __fadd_rn(tmax(s.pl, e.pl), m) <= 1.0f && !touch;
  const bool oka = case_a && __fsub_rn(s.z, s.pl) <= thresh
                   && __fsub_rn(e.z, e.pl) <= thresh;
  const bool case_b = __fsub_rn(tmin(s.pl, e.pl), m) >= 1.0f && !touch;
  const bool okb = case_b && s.z <= one_thresh && e.z <= one_thresh;
  return okc || oka || okb;
}

// contact_classify: cand & (intersects | ~cert) given cand.
__device__ __forceinline__ bool segment_needs(const Pyramid& pyr,
                                              const float ms[3],
                                              const float md[3], float W,
                                              float H) {
  const float size[2] = {W, H};
  float p0[2], p1[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    p0[k] = __fmul_rn(__fadd_rn(__fmul_rn(ms[k], 0.5f), 0.5f), size[k]);
    p1[k] = __fmul_rn(
        __fadd_rn(__fmul_rn(__fadd_rn(ms[k], md[k]), 0.5f), 0.5f), size[k]);
  }
  const float lo[2] = {__ldg(pyr.occl_lo), __ldg(pyr.occl_lo + 1)};
  const float hi[2] = {__ldg(pyr.occl_hi), __ldg(pyr.occl_hi + 1)};
  float t_in = 0.0f, t_out = 1.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float d = __fsub_rn(p1[k], p0[k]);
    const float s = p0[k];
    const bool moving = fabsf(d) > SEG_EPS;
    const float safe_d = moving ? d : SEG_EPS;
    const float t1 = __fdiv_rn(__fsub_rn(lo[k], s), safe_d);
    const float t2 = __fdiv_rn(__fsub_rn(hi[k], s), safe_d);
    const bool inside = s >= lo[k] && s <= hi[k];
    t_in = moving ? tmax(t_in, tmin(t1, t2)) : (inside ? t_in : 2.0f);
    t_out = moving ? tmin(t_out, tmax(t1, t2)) : (inside ? t_out : -1.0f);
  }
  const bool nonempty = lo[0] <= hi[0];
  const bool intersects = nonempty && t_in <= t_out && t_in <= 1.0f
                          && t_out >= 0.0f;
  if (intersects) return true;
  // not intersecting: a = b = 1
  const float a = __ldg(pyr.plane), b = __ldg(pyr.plane + 1),
              c = __ldg(pyr.plane + 2), eps = __ldg(pyr.eps);
  const float m = __fmul_rn(__fadd_rn(fabsf(a), fabsf(b)), FOOT + 0.5f);
  const float thresh = __fsub_rn(-eps, eps);
  const float one_thresh = __fadd_rn(1.0f, thresh);
  const float lim_w = __fsub_rn(W, FOOT), lim_h = __fsub_rn(H, FOOT);
  const bool cert =
      interval_ok(ms, md, p0, p1, 0.0f, 1.0f, a, b, c, m, thresh,
                  one_thresh, lim_w, lim_h)
      && interval_ok(ms, md, p0, p1, 1.0f, 1.0f, a, b, c, m, thresh,
                     one_thresh, lim_w, lim_h);
  return !cert;
}

__global__ void __launch_bounds__(THREADS)
contact_front_kernel(Front f, long long n, bool* __restrict__ cand_out,
                     bool* __restrict__ stage2_out,
                     float* __restrict__ payload) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const float* w = f.world + e * f.world_stride;
  const float* nn = f.normal + e * f.normal_stride;
  const float world[3] = {__ldg(w), __ldg(w + 1), __ldg(w + 2)};
  const float normal[3] = {__ldg(nn), __ldg(nn + 1), __ldg(nn + 2)};
  float light[3], vp[16];
#pragma unroll
  for (int c = 0; c < 3; ++c) light[c] = __ldg(f.light + c * f.light_stride);
#pragma unroll
  for (int c = 0; c < 16; ++c) vp[c] = __ldg(f.vp + c);

  // (normal * light_dir).sum(-1) as torch reduces it on the card
  const float ndl = __fadd_rn(__fadd_rn(__fmul_rn(normal[0], light[0]),
                                        __fmul_rn(normal[2], light[2])),
                              __fmul_rn(normal[1], light[1]));
  const bool facing = ndl > 0.0f;
  float start[3], end[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    start[c] = __fadd_rn(world[c], __fmul_rn(normal[c], NORMAL_OFFSET));
    end[c] = __fadd_rn(start[c], __fmul_rn(light[c], 0.5f));
  }
  float s_cs[3], e_cs[3], dir[3];
  to_cs(vp, start, s_cs);
  to_cs(vp, end, e_cs);
#pragma unroll
  for (int c = 0; c < 3; ++c) dir[c] = __fsub_rn(e_cs[c], s_cs[c]);
  float t_min = 0.0f, t_max = 1.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = k < 2 ? -1.0f : 0.0f;
    const float d = dir[k], s = s_cs[k];
    const bool moving = fabsf(d) > DIR_EPS;
    const float safe_d = moving ? d : 1.0f;
    const float t1 = __fdiv_rn(__fsub_rn(lo, s), safe_d);
    const float t2 = __fdiv_rn(__fsub_rn(1.0f, s), safe_d);
    if (moving) {
      t_min = tmax(t_min, tmin(t1, t2));
      t_max = tmin(t_max, tmax(t1, t2));
    }
  }
  const bool on_screen = t_min < t_max;
  float ms[3], md[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ms[c] = __fadd_rn(s_cs[c], __fmul_rn(dir[c], t_min));
    md[c] = __fsub_rn(__fadd_rn(s_cs[c], __fmul_rn(dir[c], t_max)), ms[c]);
  }

  // the march jitter
  float fx, fy;
  if (f.frag != nullptr) {
    fx = __ldg(f.frag + e * f.frag_stride);
    fy = __ldg(f.frag + e * f.frag_stride + 1);
  } else {
    const long long row = e / f.width;
    const float y0 = f.y0 != nullptr ? __ldg(f.y0) : f.y0_host;
    fx = __fadd_rn((float)(e - row * f.width), 0.5f);
    fy = __fadd_rn(__fadd_rn((float)row, 0.5f), y0);
  }
  const float frame = __ldg(f.frame);
  const float sx = __fadd_rn(fx, __fmul_rn(frame, FRAME_X));
  const float sy = __fadd_rn(fy, __fmul_rn(frame, FRAME_Y));
  const float d = __fadd_rn(__fmul_rn(sx, IGN_X), __fmul_rn(sy, IGN_Y));
  const float jitter = rem1(__fmul_rn(IGN_SCALE, rem1(d)));

  bool cand = facing && on_screen;
  if (f.valid != nullptr) cand = cand && f.valid[e];
  cand_out[e] = cand;
  if (stage2_out != nullptr) {
    stage2_out[e] = cand && segment_needs(f.pyr, ms, md, f.size_w, f.size_h);
  }
  float* out = payload + e * ROW;
  out[0] = ms[0];
  out[1] = ms[1];
  out[2] = ms[2];
  out[3] = md[0];
  out[4] = md[1];
  out[5] = md[2];
  out[6] = jitter;
}

// ---------------------------------------------------------------------
// K9: the certificate and the march over compacted slots.
// ---------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;

struct Slots {
  const float* __restrict__ payload;   // (n, 7)
  long long n;                         // payload rows
  const int* __restrict__ idx;         // (m,) payload row per slot, or null
  long long m;                         // slots
  const int* __restrict__ count;       // live slots, or null: all m
};

// The payload row of slot s: take_rows(payload, idx.clamp(min=0)).
__device__ __forceinline__ long long row_of(const Slots& sl, long long s) {
  if (sl.idx == nullptr) return s;
  long long i = __ldg(sl.idx + s);
  i = i < 0 ? 0 : i;
  return i > sl.n - 1 ? sl.n - 1 : i;
}

// The slots before the live count, read on the card: count clamped into
// [0, m] (all m without one).
__device__ __forceinline__ long long live_of(const Slots& sl) {
  if (sl.count == nullptr) return sl.m;
  const long long c = __ldg(sl.count);
  return c < 0 ? 0 : (c < sl.m ? c : sl.m);
}

// The 7 payload floats of a lane group's ray, loaded once a group (lane
// k < 7 of the group loads float k) and spread by shuffles. Every lane of
// the warp calls this together.
__device__ __forceinline__ void group_row(float v, int g0, float ms[3],
                                          float md[3], float* jit) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ms[c] = __shfl_sync(FULL, v, g0 + c);
    md[c] = __shfl_sync(FULL, v, g0 + 3 + c);
  }
  *jit = __shfl_sync(FULL, v, g0 + 6);
}

struct Certify {
  const float* __restrict__ rows;      // (lh * lw, 4) level-0 quad mins
  int lw, lh;
  float inv_base;                      // f32(1) / base
  Pyramid pyr;
  float size_w, size_h;
};

// Stage 3's compaction, written by the certificate in its compact mode:
// the live stage-2 slots (before the count, slot_valid set) that are not
// certified, in slot order, as comp3 (idx, valid, count).
struct Stage3 {
  const bool* __restrict__ slot_valid;   // comp2's (m,)
  int* __restrict__ idx;                 // (cap,): -1 past the count
  bool* __restrict__ valid;              // (cap,)
  int* __restrict__ count;               // (): every survivor, past cap too
  long long cap;
  // [ticket, blocks done, one status word per chunk], zero between
  // launches: the last block to finish resets what the launch used.
  unsigned long long* __restrict__ sync;
};

constexpr int CERT_THREADS = 256;
constexpr int CERT_WARPS = CERT_THREADS / 32;
constexpr int PROBE_LANES = LINEAR_STEPS;        // lane k takes probe k
constexpr int CHUNK = 256;                       // slots a block takes
constexpr int PASS_SLOTS = CERT_THREADS / PROBE_LANES;   // 32
constexpr int PASSES = CHUNK / PASS_SLOTS;       // 8 probes a thread
constexpr int GROUPS_PER_WARP = 32 / PROBE_LANES;
constexpr int CERT_MIN_BLOCKS = 3;   // blocks an SM holds (registers)
static_assert(CHUNK == CERT_THREADS, "thread t places slot t of a chunk");
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 2ull << 62;

enum { MASK_MODE = 0, COMPACT_MODE = 1 };

// One probe of _stage2_certify at t = (k + jit) / 8: in bounds, its ray
// depth, the plane bound less eps before the box min, and the level-0 quad
// row that holds the box min (_point_min_l0; _probe_bound).
struct CertProbe {
  bool inb;
  float z, bound;
  const float* quad;
};

__device__ __forceinline__ CertProbe cert_probe(const Certify& cf, float a,
                                                float b, float c, float m,
                                                float lim_w, float lim_h,
                                                const float ms[3],
                                                const float md[3], float jit,
                                                int k) {
  CertProbe p;
  const float t = __fmul_rn(__fadd_rn((float)k, jit), 0.125f);
  const float cs0 = __fadd_rn(ms[0], __fmul_rn(md[0], t));
  const float cs1 = __fadd_rn(ms[1], __fmul_rn(md[1], t));
  p.z = __fadd_rn(ms[2], __fmul_rn(md[2], t));
  const float u = __fadd_rn(__fmul_rn(cs0, 0.5f), 0.5f);
  const float v = __fadd_rn(__fmul_rn(cs1, 0.5f), 0.5f);
  p.inb = u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f;
  const float q0 = __fmul_rn(u, cf.size_w), q1 = __fmul_rn(v, cf.size_h);
  const int cx = clampi(
      to_i32(floorf(__fmul_rn(__fsub_rn(q0, FOOT), cf.inv_base))), 0,
      cf.lw - 1);
  const int cy = clampi(
      to_i32(floorf(__fmul_rn(__fsub_rn(q1, FOOT), cf.inv_base))), 0,
      cf.lh - 1);
  p.quad = cf.rows + ((long long)cy * cf.lw + cx) * 4;
  const float pq = __fadd_rn(__fadd_rn(__fmul_rn(a, q0), __fmul_rn(b, q1)),
                             c);
  const float bound0 =
      __fadd_rn(pq, m) <= 1.0f ? pq
      : (__fsub_rn(pq, m) >= 1.0f ? 1.0f
                                  : __fsub_rn(tclamp_max(pq, 1.0f), m));
  const bool band = q0 < FOOT || q0 > lim_w || q1 < FOOT || q1 > lim_h;
  p.bound = __fsub_rn(bound0, band ? m : 0.0f);
  return p;
}

// Single-pass decoupled look-back (warp 0 of a block, all 32 lanes) over
// the chunks in ticket order: publishes this chunk's aggregate, sums its
// predecessors' words back to the nearest inclusive prefix, publishes its
// own inclusive prefix and returns the exclusive one. A chunk waits only
// on chunks of lower tickets, whose blocks are already running.
__device__ long long look_back(unsigned long long* status, long long chunk,
                               unsigned agg, int lane) {
  if (chunk == 0) {
    if (lane == 0) atomicExch(status, INCLUSIVE | agg);
    return 0;
  }
  if (lane == 0) atomicExch(status + chunk, AGGREGATE | agg);
  long long prefix = 0;
  for (long long top = chunk - 1;; top -= 32) {
    const long long q = top - lane;
    unsigned long long w = INCLUSIVE;   // before chunk 0: a prefix of 0
    if (q >= 0) {
      do {
        w = *reinterpret_cast<volatile unsigned long long*>(status + q);
      } while ((w >> 62) == 0);
    }
    const unsigned done = __ballot_sync(FULL, (w >> 62) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    prefix += __reduce_add_sync(FULL, lane <= stop ? (unsigned)w : 0u);
    if (done) break;
  }
  if (lane == 0) {
    atomicExch(status + chunk,
               INCLUSIVE | (unsigned long long)(prefix + agg));
  }
  return prefix;
}

// The stage-2 certificate, 8 lanes a slot (lane k evaluates probe k; the
// slot is certified where no lane's in-bounds probe fails, one ballot),
// each thread 8 probes of a chunk of CHUNK slots with every load of the
// chunk in flight together: the slots' indices, then their payload rows
// (7 floats a group, one a lane), then the 8 quad rows.
// MASK_MODE: the (m,) certificate, true at and past the live count, one
// chunk a block. COMPACT_MODE: stage 3's compaction instead (Stage3);
// blocks take chunks in order by an atomic ticket, stop past the live
// count (the dead slots cost no block), place each survivor by a ballot,
// a popcount and a prefix over the warps in the block and the decoupled
// look-back across blocks; once every chunk is taken, each block waits
// for the last chunk's inclusive prefix (stage 3's count) and fills its
// share of the slots past it with -1 / false, so nothing is pre-filled;
// the last block resets the ticket and status words, so a replayed CUDA
// graph finds them zero.
template <int MODE>
__global__ void __launch_bounds__(CERT_THREADS, CERT_MIN_BLOCKS)
contact_certify_kernel(Slots sl, Certify cf, bool* __restrict__ out,
                       Stage3 s3) {
  __shared__ int flags[CHUNK];
  __shared__ long long warp_off[CERT_WARPS];
  __shared__ long long chunk_sh, total_sh;
  __shared__ bool last_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = lane & (PROBE_LANES - 1);
  const int g0 = lane - k;
  const long long live = live_of(sl);
  const long long chunks =
      ((MODE == COMPACT_MODE ? live : sl.m) + CHUNK - 1) / CHUNK;
  const float a = __ldg(cf.pyr.plane), b = __ldg(cf.pyr.plane + 1),
              c = __ldg(cf.pyr.plane + 2), eps = __ldg(cf.pyr.eps);
  const float m = __fmul_rn(__fadd_rn(fabsf(a), fabsf(b)), FOOT + 0.5f);
  const float lim_w = __fsub_rn(cf.size_w, FOOT);
  const float lim_h = __fsub_rn(cf.size_h, FOOT);
  const bool vec = (reinterpret_cast<uintptr_t>(cf.rows) & 15) == 0;
  long long chunk = blockIdx.x;
  for (;; chunk += gridDim.x) {
    if (MODE == COMPACT_MODE) {
      if (threadIdx.x == 0) chunk_sh = (long long)atomicAdd(s3.sync, 1ull);
      __syncthreads();
      chunk = chunk_sh;
    }
    if (chunk >= chunks) break;
    const long long base = chunk * CHUNK;
    if (MODE == MASK_MODE && base >= live) {   // past the count: certified
      if (base + threadIdx.x < sl.m) out[base + threadIdx.x] = true;
      continue;
    }
    long long slot[PASSES], row[PASSES];
    bool lv[PASSES], sv[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      slot[p] = base + p * PASS_SLOTS + warp * GROUPS_PER_WARP
                + lane / PROBE_LANES;
      lv[p] = slot[p] < live;
      row[p] = lv[p] ? row_of(sl, slot[p]) : 0;
      sv[p] = MODE == COMPACT_MODE && lv[p]
              && __ldg(reinterpret_cast<const unsigned char*>(s3.slot_valid)
                       + slot[p]);
    }
    float v[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      v[p] = lv[p] && k < ROW ? __ldg(sl.payload + row[p] * ROW + k) : 0.0f;
    }
    CertProbe pr[PASSES];
    float4 qv[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      float ms[3], md[3], jit;
      group_row(v[p], g0, ms, md, &jit);
      pr[p] = cert_probe(cf, a, b, c, m, lim_w, lim_h, ms, md, jit, k);
      qv[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lv[p] && pr[p].inb) {
        qv[p] = vec ? __ldg(reinterpret_cast<const float4*>(pr[p].quad))
                    : make_float4(__ldg(pr[p].quad), __ldg(pr[p].quad + 1),
                                  __ldg(pr[p].quad + 2),
                                  __ldg(pr[p].quad + 3));
      }
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const float min_r = tmin(tmin(qv[p].x, qv[p].y), tmin(qv[p].z, qv[p].w));
      const bool fail =
          lv[p] && pr[p].inb
          && !(pr[p].z <= __fsub_rn(__fadd_rn(pr[p].bound, min_r), eps));
      const unsigned fails = (__ballot_sync(FULL, fail) >> g0) & 0xffu;
      if (k == 0) {
        if (MODE == MASK_MODE) {
          if (slot[p] < sl.m) out[slot[p]] = fails == 0;
        } else {
          flags[slot[p] - base] = sv[p] && fails != 0;
        }
      }
    }
    if (MODE == MASK_MODE) continue;

    // stage 3: thread t places slot base + t
    __syncthreads();
    const bool f = flags[threadIdx.x] != 0;
    const unsigned bal = __ballot_sync(FULL, f);
    if (lane == 0) warp_off[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int own = lane < CERT_WARPS ? (int)warp_off[lane] : 0;
      int incl = own;
#pragma unroll
      for (int d = 1; d < CERT_WARPS; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
      }
      const unsigned agg = (unsigned)__shfl_sync(FULL, incl, CERT_WARPS - 1);
      const long long prefix = look_back(s3.sync + 2, chunk, agg, lane);
      if (lane < CERT_WARPS) warp_off[lane] = prefix + incl - own;
    }
    __syncthreads();
    if (f) {
      const long long pos =
          warp_off[warp] + __popc(bal & ((1u << lane) - 1u));
      if (pos < s3.cap) {
        s3.idx[pos] = __ldg(sl.idx + base + threadIdx.x);
        s3.valid[pos] = true;
      }
    }
  }
  if (MODE == MASK_MODE) return;
  // Every chunk is now a running block's (the tickets go out in order):
  // wait for the last one's inclusive prefix, stage 3's count, then fill
  // this block's share of the slots past it with -1 / false.
  if (threadIdx.x == 0) {
    unsigned long long w = INCLUSIVE;
    if (chunks > 0) {
      do {
        w = *reinterpret_cast<volatile unsigned long long*>(s3.sync + 2
                                                            + chunks - 1);
      } while ((w >> 62) != 2);
    }
    total_sh = (unsigned)w;
    if (blockIdx.x == 0) *s3.count = (int)(unsigned)w;
  }
  __syncthreads();
  for (long long i = (total_sh < s3.cap ? total_sh : s3.cap)
                     + (long long)blockIdx.x * CERT_THREADS + threadIdx.x;
       i < s3.cap; i += (long long)gridDim.x * CERT_THREADS) {
    s3.idx[i] = -1;
    s3.valid[i] = false;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();   // this block's status words before it counts done
    last_sh = atomicAdd(s3.sync + 1, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_sh) return;
  // every block has taken its last ticket and published: reset
  for (long long i = threadIdx.x; i < chunks; i += CERT_THREADS) {
    s3.sync[2 + i] = 0;
  }
  if (threadIdx.x == 0) {
    s3.sync[0] = 0;
    s3.sync[1] = 0;
  }
}

struct Depth {
  const float* __restrict__ d;         // (h, w) prev_depth
  int h, w;
  const int* __restrict__ origin;      // window (oy, ox), or null
  int cw;
};

// One probe of _march at parameter t: (hit, penetration, in bounds).
__device__ __forceinline__ bool probe(const Depth& dp, int sy, int sx,
                                      int oy, int ox, const float ms[3],
                                      const float md[3], float t,
                                      float* pen, bool* inb) {
  const float cs0 = __fadd_rn(ms[0], __fmul_rn(md[0], t));
  const float cs1 = __fadd_rn(ms[1], __fmul_rn(md[1], t));
  const float cs2 = __fadd_rn(ms[2], __fmul_rn(md[2], t));
  const float u = __fadd_rn(__fmul_rn(cs0, 0.5f), 0.5f);
  const float v = __fadd_rn(__fmul_rn(cs1, 0.5f), 0.5f);
  *inb = u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f;
  const float wf = (float)dp.w, hf = (float)dp.h;
  // _dual_setup
  const float x = __fsub_rn(__fmul_rn(u, wf), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, hf), 0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = to_i32(x0f), y0 = to_i32(y0f);
  const float fx = tclamp(__fsub_rn(x, x0f), 0.0f, 1.0f);
  const float fy = tclamp(__fsub_rn(y, y0f), 0.0f, 1.0f);
  const int ix = clampi(x0, 0, dp.w - 1), iy = clampi(y0, 0, dp.h - 1);
  int r = iy, c = ix;
  if (dp.origin != nullptr) {   // the window's row at (ly, lx)
    r = sy + clampi(iy - oy, 0, dp.cw - 1);
    c = sx + clampi(ix - ox, 0, dp.cw - 1);
  }
  // quad_pack's edge-clamped quad at (r, c)
  const int c1 = c + 1 < dp.w ? c + 1 : dp.w - 1;
  const int r1 = r + 1 < dp.h ? r + 1 : dp.h - 1;
  const float* row0 = dp.d + (long long)r * dp.w;
  const float* row1 = dp.d + (long long)r1 * dp.w;
  const float q0 = __ldg(row0 + c), q1 = __ldg(row0 + c1);
  const float q2 = __ldg(row1 + c), q3 = __ldg(row1 + c1);
  // _quad_corners
  const bool x_ok = x0 >= 0, y_ok = y0 >= 0;
  const float c00 = q0;
  const float c10 = x_ok ? q1 : q0;
  float c11 = x_ok ? q3 : q2;
  const float c01 = y_ok ? q2 : q0;
  c11 = y_ok ? c11 : c10;
  // _dual_read
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float top = __fadd_rn(__fmul_rn(c00, gx), __fmul_rn(c10, fx));
  const float bot = __fadd_rn(__fmul_rn(c01, gx), __fmul_rn(c11, fx));
  const float bil = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
  const int nx = clampi(clampi(to_i32(floorf(__fmul_rn(u, wf))), 0,
                               dp.w - 1) - ix, 0, 1);
  const int ny = clampi(clampi(to_i32(floorf(__fmul_rn(v, hf))), 0,
                               dp.h - 1) - iy, 0, 1);
  const float nearest = ny == 0 ? (nx == 0 ? c00 : c10)
                                : (nx == 0 ? c01 : c11);
  const float d_lin = linearize(bil), d_nst = linearize(nearest);
  const float d_max = tmax(d_lin, d_nst), d_min = tmin(d_lin, d_nst);
  const float ray = linearize(cs2);
  *pen = __fsub_rn(ray, d_min);
  return __fsub_rn(d_max, ray) < 0.0f && *pen < THICKNESS;
}

// 1 - smoothstep(0, edge, x), the division by the host `edge` as a
// multiply by `inv` (torch on the card).
__device__ __forceinline__ float fade(float x, float inv) {
  const float t = tclamp(__fmul_rn(x, inv), 0.0f, 1.0f);
  return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(t, t),
                                   __fsub_rn(3.0f, __fmul_rn(2.0f, t))));
}

__device__ __forceinline__ float soft_term(float max_t, float last_pen) {
  const float strength = fade(max_t, 2.0f);
  const float pen_fade = fade(last_pen, INV_THICKNESS);
  return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(strength, pen_fade), DARKNESS));
}

// The march window's start: dynamic_slice's, a negative origin counting
// from the end, then clamped.
__device__ __forceinline__ void window_start(const Depth& dp, int* sy,
                                             int* sx, int* oy, int* ox) {
  *sy = *sx = *oy = *ox = 0;
  if (dp.origin == nullptr) return;
  *oy = __ldg(dp.origin);
  *ox = __ldg(dp.origin + 1);
  *sy = clampi(*oy < 0 ? *oy + dp.h : *oy, 0, dp.h - dp.cw);
  *sx = clampi(*ox < 0 ? *ox + dp.w : *ox, 0, dp.w - dp.cw);
}

// A slot's term into the output: at the slot without an index, else at
// its pixel (scatter_back: a negative index counts from the end).
__device__ __forceinline__ void put_term(const Slots& sl, long long s,
                                         float term, float* out) {
  if (sl.idx == nullptr) {
    out[s] = term;
  } else {
    long long i = __ldg(sl.idx + s);
    i = i < 0 ? i + sl.n : i;
    if (i >= 0 && i < sl.n) out[i] = term;
  }
}

constexpr int MARCH_THREADS = 256;

// The march of slot s by one thread: 8 linear probes in a chain (none
// after a hit), then 4 bisection steps (none without a hit).
__device__ void march_chain(const Slots& sl, const Depth& dp,
                            const bool* __restrict__ mask, int sy, int sx,
                            int oy, int ox, long long s,
                            float* __restrict__ out) {
  if (mask != nullptr && !mask[s]) {   // masked off: lit, no probe
    out[s] = 1.0f;
    return;
  }
  const long long r = row_of(sl, s);
  const float* pr = sl.payload + r * ROW;
  float ms[3], md[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ms[c] = __ldg(pr + c);
    md[c] = __ldg(pr + 3 + c);
  }
  const float jit = __ldg(pr + 6);
  float min_t = 0.0f, max_t = 1.0f, last_pen = 0.0f;
  bool inter = false;
  for (int k = 0; k < LINEAR_STEPS && !inter; ++k) {
    const float t = __fmul_rn(__fadd_rn((float)k, jit), 0.125f);
    float pen;
    bool inb;
    const bool hit = probe(dp, sy, sx, oy, ox, ms, md, t, &pen, &inb);
    if (!inb) continue;
    if (hit) {
      max_t = t;
      last_pen = pen;
      inter = true;
    } else {
      min_t = t;
    }
  }
  if (inter) {
    for (int k = 0; k < BISECTION_STEPS; ++k) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(min_t, max_t));
      float pen;
      bool inb;
      if (probe(dp, sy, sx, oy, ox, ms, md, mid, &pen, &inb)) {
        max_t = mid;
        last_pen = pen;
      } else {
        min_t = mid;
      }
    }
  }
  put_term(sl, s, inter ? soft_term(max_t, last_pen) : 1.0f, out);
}

// The march, 8 lanes a slot (lane k < 8 takes linear probe k). The
// linear probes are independent: a ballot gives the first in-bounds hit
// (max_t and last_pen from its lane) and the last in-bounds miss before
// it (min_t, else 0), which is what the chain computes. The 4 bisection
// steps form a tree of 15 midpoints (heap order: node n's hit child
// 2n + 1, its miss child 2n + 2), each node's interval following from
// (min_t, max_t) and its path alone, every mid computed as the chain
// computes it; so lane k < 7 probes node k of depths 0-2 speculatively, a
// walk down the path (hit bits by ballot, pens by shuffles) takes those
// three steps, and every lane then probes the one node of depth 3 on the
// path. Slots past the live count and rays masked off probe nothing; the
// warps stride over the slots up to the live count. Past `chain_above`
// live slots, where the tree's extra probes cost more instructions than
// the chain's wait saves, each thread takes a slot of its own
// (march_chain); the launch gives at least a thread a slot, so it takes
// at most one.
__global__ void __launch_bounds__(MARCH_THREADS)
contact_march_kernel(Slots sl, Depth dp, const bool* __restrict__ mask,
                     long long chain_above, float* __restrict__ out) {
  constexpr int LANES = LINEAR_STEPS;
  constexpr int PER_WARP = 32 / LANES;
  constexpr int SPECULATIVE = 7;   // the nodes of depths 0-2
  const int lane = threadIdx.x & 31;
  const int k = lane % LANES, g0 = lane - k;
  const long long live = live_of(sl);
  int sy, sx, oy, ox;
  window_start(dp, &sy, &sx, &oy, &ox);
  if (live > chain_above) {
    for (long long s = (long long)blockIdx.x * MARCH_THREADS + threadIdx.x;
         s < live; s += (long long)gridDim.x * MARCH_THREADS) {
      march_chain(sl, dp, mask, sy, sx, oy, ox, s, out);
    }
    return;
  }
  const long long warps = (long long)gridDim.x * (MARCH_THREADS / 32);
  for (long long wb = ((long long)blockIdx.x * (MARCH_THREADS / 32)
                       + (threadIdx.x >> 5)) * PER_WARP;
       wb < live; wb += warps * PER_WARP) {
    const long long s = wb + lane / LANES;
    bool act = s < live;
    const long long r = act ? row_of(sl, s) : 0;
    if (act && mask != nullptr) act = mask[s];   // masked off: lit
    const float v = act && k < ROW ? __ldg(sl.payload + r * ROW + k) : 0.0f;
    float ms[3], md[3], jit;
    group_row(v, g0, ms, md, &jit);

    // the linear probes
    bool hit = false, inb = false;
    float pen = 0.0f;
    if (act) {
      hit = probe(dp, sy, sx, oy, ox, ms, md,
                  __fmul_rn(__fadd_rn((float)k, jit), 0.125f), &pen, &inb);
    }
    const unsigned hits = (__ballot_sync(FULL, hit && inb) >> g0) & 0xffu;
    const unsigned inbs = (__ballot_sync(FULL, inb) >> g0) & 0xffu;
    const bool inter = hits != 0;
    const int first = inter ? __ffs(hits) - 1 : 0;
    float last_pen = __shfl_sync(FULL, pen, g0 + first);
    float min_t = 0.0f, max_t = 1.0f;
    if (inter) {
      max_t = __fmul_rn(__fadd_rn((float)first, jit), 0.125f);
      const unsigned before = inbs & ~hits & ((1u << first) - 1u);
      if (before != 0) {
        min_t = __fmul_rn(__fadd_rn((float)(31 - __clz(before)), jit),
                          0.125f);
      }
    } else {
      last_pen = 0.0f;
    }

    // the speculative bisection: lane k < SPECULATIVE probes node k
    bool bhit = false;
    float bpen = 0.0f;
    if (act && inter && k < SPECULATIVE) {
      float lo = min_t, hi = max_t;
      const int path = k + 1;                 // the bits after its top 1
      for (int d = 30 - __clz(path); d >= 0; --d) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        if ((path >> d) & 1) lo = mid; else hi = mid;
      }
      bool unused;
      bhit = probe(dp, sy, sx, oy, ox, ms, md,
                   __fmul_rn(0.5f, __fadd_rn(lo, hi)), &bpen, &unused);
    }
    const unsigned bhits = (__ballot_sync(FULL, bhit) >> g0) & 0xffu;
    int node = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float p = __shfl_sync(FULL, bpen, g0 + node);
      const float mid = __fmul_rn(0.5f, __fadd_rn(min_t, max_t));
      const bool h = (bhits >> node) & 1u;
      if (h) {
        max_t = mid;
        last_pen = p;
      } else {
        min_t = mid;
      }
      node = 2 * node + (h ? 1 : 2);
    }
    if (act && inter) {   // depth 3, on every lane
      const float mid = __fmul_rn(0.5f, __fadd_rn(min_t, max_t));
      float p;
      bool unused;
      if (probe(dp, sy, sx, oy, ox, ms, md, mid, &p, &unused)) {
        max_t = mid;
        last_pen = p;
      }
    }
    if (k == 0 && s < live) {
      put_term(sl, s, act && inter ? soft_term(max_t, last_pen) : 1.0f, out);
    }
  }
}

int grid_of(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

int capped(long long blocks, int max_blocks) {
  return (int)(blocks < 1 ? 1 : (blocks < max_blocks ? blocks : max_blocks));
}

Certify certify_of(const float* rows, int lw, int lh, float inv_base,
                          const float* plane, const float* eps, float size_w,
                          float size_h) {
  Certify cf;
  cf.rows = rows;
  cf.lw = lw;
  cf.lh = lh;
  cf.inv_base = inv_base;
  cf.pyr.occl_lo = nullptr;
  cf.pyr.occl_hi = nullptr;
  cf.pyr.plane = plane;
  cf.pyr.eps = eps;
  cf.size_w = size_w;
  cf.size_h = size_h;
  return cf;
}

}  // namespace

extern "C" {

// Each returns a CUDA error code (0 = launched).
int contact_front_launch(
    const float* world, long long world_stride, const float* normal,
    long long normal_stride, const float* light, long long light_stride,
    const float* vp, const float* frame, const float* frag,
    long long frag_stride, const float* y0, float y0_host, int width,
    const bool* valid, const float* occl_lo, const float* occl_hi,
    const float* plane, const float* eps, float size_w, float size_h,
    long long n, bool* cand, bool* stage2, float* payload, void* stream) {
  Front f;
  f.world = world;
  f.world_stride = world_stride;
  f.normal = normal;
  f.normal_stride = normal_stride;
  f.light = light;
  f.light_stride = light_stride;
  f.vp = vp;
  f.frame = frame;
  f.frag = frag;
  f.frag_stride = frag_stride;
  f.y0 = y0;
  f.y0_host = y0_host;
  f.width = width;
  f.valid = valid;
  f.pyr.occl_lo = occl_lo;
  f.pyr.occl_hi = occl_hi;
  f.pyr.plane = plane;
  f.pyr.eps = eps;
  f.size_w = size_w;
  f.size_h = size_h;
  contact_front_kernel<<<grid_of(n, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(f, n, cand, stage2,
                                                 payload);
  return (int)cudaGetLastError();
}

// The (m,) certificate: one block a chunk of CHUNK slots.
int contact_certify_launch(const float* payload, long long n, const int* idx,
                           long long m, const int* count, const float* rows,
                           int lw, int lh, float inv_base,
                           const float* plane, const float* eps,
                           float size_w, float size_h, bool* out,
                           void* stream) {
  Slots sl{payload, n, idx, m, count};
  const Certify cf = certify_of(rows, lw, lh, inv_base, plane, eps, size_w,
                                size_h);
  Stage3 s3{};
  contact_certify_kernel<MASK_MODE>
      <<<grid_of(m, CHUNK), CERT_THREADS, 0, (cudaStream_t)stream>>>(
          sl, cf, out, s3);
  return (int)cudaGetLastError();
}

// Stage 3 of the compacted slots (idx (m,), count, slot_valid), into
// out_idx / out_valid (cap,) and out_count, every entry written; `sync` is
// zero and holds 2 + ceil(m / CHUNK) words; at most max_blocks blocks.
int contact_certify_compact_launch(
    const float* payload, long long n, const int* idx, long long m,
    const int* count, const float* rows, int lw, int lh, float inv_base,
    const float* plane, const float* eps, float size_w, float size_h,
    const bool* slot_valid, int* out_idx, bool* out_valid, int* out_count,
    long long cap, unsigned long long* sync, int max_blocks, void* stream) {
  if (idx == nullptr || count == nullptr || slot_valid == nullptr ||
      out_count == nullptr || sync == nullptr || max_blocks < 1 || m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Slots sl{payload, n, idx, m, count};
  const Certify cf = certify_of(rows, lw, lh, inv_base, plane, eps, size_w,
                                size_h);
  Stage3 s3{slot_valid, out_idx, out_valid, out_count, cap, sync};
  contact_certify_kernel<COMPACT_MODE>
      <<<capped(grid_of(m, CHUNK), max_blocks), CERT_THREADS, 0,
         (cudaStream_t)stream>>>(sl, cf, nullptr, s3);
  return (int)cudaGetLastError();
}

// The march over m slots: at least a thread a slot, and at least the
// lesser of max_blocks and 8 lanes a slot; one thread a slot past
// chain_above live slots.
int contact_march_launch(const float* depth, int h, int w,
                         const float* payload, long long n, const int* idx,
                         long long m, const int* count, const bool* mask,
                         const int* origin, int cw, float* out,
                         long long chain_above, int max_blocks,
                         void* stream) {
  Slots sl{payload, n, idx, m, count};
  Depth dp{depth, h, w, origin, cw};
  const int chain = grid_of(m, MARCH_THREADS);
  const int lanes = capped(grid_of(m * LINEAR_STEPS, MARCH_THREADS),
                           max_blocks);
  contact_march_kernel<<<chain > lanes ? chain : lanes, MARCH_THREADS, 0,
                         (cudaStream_t)stream>>>(sl, dp, mask, chain_above,
                                                 out);
  return (int)cudaGetLastError();
}

}  // extern "C"
