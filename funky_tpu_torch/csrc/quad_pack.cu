// Edge-clamped 2x2 quads of depth maps for Hopper (sm_90a): the table the
// shadow filter's taps read, one 16-byte row per texel.
//
// K11 quad_pack_launch replaces the JAX package's
// funky_tpu/ops/sampling.py::quad_pack (:192-199), which XLA fuses into one
// copy on the TPU. Its plain twin is
// funky_tpu_torch/ops/sampling.py::quad_pack_plain: three torch.cat and a
// torch.stack, which write the table twice through three map-sized
// temporaries, the stack as a last-axis interleave with a 4-float stride.
//
// Semantics: in (L, H, W) 32-bit words, out (L, H, W, 4):
// out[l, y, x] = [d(y, x), d(y, x + 1), d(y + 1, x), d(y + 1, x + 1)], the
// +1 neighbours clamped to the last column and row. A pure copy: the words
// move as unsigned integers through loads, shuffles, selects and stores,
// never through float arithmetic, so NaN payloads, infinities and -0.0
// arrive bit for bit.
//
// What bounds it on this card: the bytes. Each texel is read once (4 B)
// and written as its quad (16 B): at the frame's 4 x 2048^2 cascades
// 67.1 MB read and 268.4 MB written, 0.100 ms at 3.35 TB/s. The table is
// five times the 50 MB L2, so the stores stream through it.
//
// Design: one thread a texel column of a strip of `rows` rows, a block 256
// columns of one strip. A step loads the word of the row below (128 B a
// warp, coalesced), takes its right neighbour from the next lane by a
// shuffle (lane 31 loads it; the row's last texel clamps to itself), and
// stores the quad of the row above as one 16-byte streaming store
// (st.global.cs): each store instruction of a warp writes 512 contiguous
// bytes. The row below is carried in registers as the next step's row, so
// each word is read once, plus one row a strip. Every 32-bit word is 4-byte
// aligned and every output row 16-byte aligned (the wrapper allocates the
// output), so one path takes every shape: no width or offset needs a
// scalar fallback. Blocks walk strips, then images, on one grid axis.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// A texel's word and its right neighbour's, clamped to the row's end.
struct Pair {
  unsigned d, r;
};

// Row `row` at column x: the load is skipped past the row's end, but every
// lane takes part in the shuffle.
__device__ __forceinline__ Pair load_pair(const unsigned* __restrict__ row,
                                          int x, int w, bool lane_last) {
  const unsigned d = x < w ? __ldg(row + x) : 0u;
  unsigned r = __shfl_down_sync(0xffffffffu, d, 1);
  if (x + 1 >= w) {
    r = d;
  } else if (lane_last) {
    r = __ldg(row + x + 1);
  }
  return {d, r};
}

__global__ void __launch_bounds__(THREADS)
quad_pack_kernel(const unsigned* __restrict__ in, uint4* __restrict__ out,
                 int h, int w, int rows, int col_blocks, int strips) {
  const int cb = blockIdx.x % col_blocks;
  const int strip_image = blockIdx.x / col_blocks;
  const int strip = strip_image % strips;
  const long long image = strip_image / strips;
  const int x = cb * THREADS + threadIdx.x;
  const int y0 = strip * rows;
  const int y1 = min(y0 + rows, h);
  const long long plane = (long long)h * w;
  const unsigned* src = in + image * plane;
  uint4* dst = out + image * plane;
  const bool lane_last = (threadIdx.x & 31) == 31;
  Pair above = load_pair(src + (long long)y0 * w, x, w, lane_last);
#pragma unroll 4
  for (int y = y0; y < y1; ++y) {
    const int below_y = min(y + 1, h - 1);
    const Pair below = load_pair(src + (long long)below_y * w, x, w,
                                 lane_last);
    if (x < w) {
      __stcs(dst + (long long)y * w + x,
             make_uint4(above.d, above.r, below.d, below.r));
    }
    above = below;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). in: images x h x w 32-bit
// words, contiguous; out: images x h x w x 4 words, 16-byte aligned, every
// word written. rows: the height of a thread's strip (>= 1). Launches one
// kernel on `stream`, does not synchronise, allocates nothing, and
// returns a CUDA error code (0: launched).
extern "C" int quad_pack_launch(const void* in, void* out, long long images,
                                int h, int w, int rows, void* stream) {
  if (in == nullptr || out == nullptr || images < 1 || h < 1 || w < 1 ||
      rows < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int col_blocks = (w + THREADS - 1) / THREADS;
  const int strips = (h + rows - 1) / rows;
  const long long blocks = images * col_blocks * strips;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  quad_pack_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned*>(in), static_cast<uint4*>(out), h, w, rows,
      col_blocks, strips);
  return (int)cudaGetLastError();
}
