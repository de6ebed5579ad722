"""Texture / shadow-map samplers as gathers (port of funky_tpu/ops/sampling.py).

The samplers the glTF frame calls are ported, with the windowed variants
of the committed and routed tap groups, the overlay's
`sample_bilinear_edge`, `dynamic_slice` /
`dynamic_update_slice`, JAX's slices at device-valued starts, and
`resize_linear`, the frame's `jax.image.resize` upsample. Two semantic
differences between the libraries are handled here for every sampler:

- A JAX gather clamps out-of-range indices; torch raises on the CPU and
  device-asserts on CUDA. `take_rows` clamps the flat index itself, which
  is what XLA's gather does with a 1-D start index (on the card, inside
  the row-gather kernel).
- `x.astype(jnp.int32)` saturates (NaN -> 0) in XLA; `.to(torch.int32)` of
  NaN or out-of-range floats is undefined and differs between the CPU and
  CUDA. `to_i32` reproduces XLA's saturating conversion. Sky pixels reach
  the samplers with garbage coordinates (they interpolate through
  triangle 0, passes/deferred.py), so this matters.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quad_pack_cuda

_I32_MAX = 2147483647


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's saturating f32 -> s32 conversion: truncation toward zero,
    NaN -> 0, out-of-range values clamp to the int32 range."""
    x = torch.nan_to_num(x, nan=0.0)
    big = x >= 2147483648.0
    i = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(big, torch.full_like(i, _I32_MAX), i)


def take_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with jnp indexing semantics (sampling.py:31-61): a
    negative index counts from the end, then the index is clamped into
    range. A CUDA table goes to the row-gather kernel K3
    (ops/gather_cuda.py::row_gather), which takes contiguous tensors and
    int32 indices and raises on anything else; a CPU table to the plain
    twin. The JAX version's index reshape is a TPU layout trick and changes
    no value."""
    if flat.device.type == "cuda":
        from . import gather_cuda   # imports this module

        return gather_cuda.row_gather(flat, idx)
    return take_rows_plain(flat, idx)


def take_rows_plain(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_rows as torch indexing on the normalized indices: the CPU path
    and the kernel's test oracle."""
    n = flat.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return flat[idx.long()]


def _slice_start(s, dim: int, size: int):
    """jax.lax.dynamic_slice's rule for one start: a negative start counts
    from the end, then it is clamped so that the slice stays in bounds."""
    if isinstance(s, torch.Tensor):
        s = s.to(torch.int64)
        return torch.clamp(torch.where(s < 0, s + dim, s), 0, dim - size)
    s = s + dim if s < 0 else s
    return min(max(int(s), 0), dim - size)


def _slice_index(x: torch.Tensor, starts, sizes):
    """Index of the dynamic slice over x's leading axes: plain slices for
    host starts, broadcast index tensors once any start is a tensor."""
    starts = [_slice_start(s, x.shape[d], n)
              for d, (s, n) in enumerate(zip(starts, sizes))]
    if not any(isinstance(s, torch.Tensor) for s in starts):
        return tuple(slice(s, s + n) for s, n in zip(starts, sizes))
    k = len(sizes)
    index = []
    for d, (s, n) in enumerate(zip(starts, sizes)):
        shape = [1] * k
        shape[d] = n
        index.append((torch.arange(n, device=x.device) + s).reshape(shape))
    return tuple(index)


def dynamic_slice(x: torch.Tensor, starts, sizes) -> torch.Tensor:
    """jax.lax.dynamic_slice over the leading len(starts) axes of x (the
    others whole). A start may be a 0-d device tensor: it is clamped and
    applied by index arithmetic on the device, never read on the host."""
    return x[_slice_index(x, starts, sizes)]


def dynamic_update_slice(x: torch.Tensor, update: torch.Tensor,
                         starts) -> torch.Tensor:
    """jax.lax.dynamic_update_slice over x's leading axes (starts clamped
    as in dynamic_slice); returns a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    out[_slice_index(x, starts, update.shape[:len(starts)])] = update
    return out


def _gather2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """img (H, W) or (H, W, C) (sampling.py:64-68)."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape((h * w,) + tuple(img.shape[2:]))
    return take_rows(flat, iy * w + ix)


def _bilinear_clamped_taps(shape_hw, uv):
    """Bilinear tap setup (sampling.py:93-117): (iy0, ix0, iy1, ix1, fy,
    fx, inside), the indices clamped into the image and `inside` flagging
    each of the four taps as in range before the clamp."""
    h, w = shape_hw
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = to_i32(x0f)
    y0 = to_i32(y0f)
    x1 = x0 + 1
    y1 = y0 + 1

    def inb(iy, ix):
        return (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)

    inside = (inb(y0, x0), inb(y0, x1), inb(y1, x0), inb(y1, x1))
    return (y0.clamp(0, h - 1), x0.clamp(0, w - 1), y1.clamp(0, h - 1),
            x1.clamp(0, w - 1), fy, fx, inside)


def sample_bilinear_edge(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """LINEAR + CLAMP_TO_EDGE of an (H, W) or (H, W, C) image
    (sampling.py:168-180)."""
    cy0, cx0, cy1, cx1, fy, fx, _ = _bilinear_clamped_taps(img.shape[:2], uv)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    t00 = _gather2d(img, cy0, cx0)
    t10 = _gather2d(img, cy0, cx1)
    t01 = _gather2d(img, cy1, cx0)
    t11 = _gather2d(img, cy1, cx1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _bilinear(t00, t10, t01, t11, fy, fx):
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear_repeat(tex: torch.Tensor, uv: torch.Tensor
                           ) -> torch.Tensor:
    """LINEAR + REPEAT of an (H, W, C) texture (sampling.py:71-90)."""
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # jnp.mod of int32 takes the divisor's sign, as torch.remainder does
    ix0 = torch.remainder(to_i32(x0), w)
    iy0 = torch.remainder(to_i32(y0), h)
    ix1 = torch.remainder(ix0 + 1, w)
    iy1 = torch.remainder(iy0 + 1, h)
    return _bilinear(_gather2d(tex, iy0, ix0), _gather2d(tex, iy0, ix1),
                     _gather2d(tex, iy1, ix0), _gather2d(tex, iy1, ix1),
                     fy, fx)


def _compare_taps(read, shape_hw, uv, ref_depth):
    """Hardware 2x2 PCF: each clamped tap read(iy, ix) compared LESS_OR_EQUAL
    with ref_depth, a tap outside the map against the white border."""
    cy0, cx0, cy1, cx1, fy, fx, inside = _bilinear_clamped_taps(shape_hw, uv)

    def tap(iy, ix, inb):
        d = torch.where(inb, read(iy, ix), 1.0)
        return (ref_depth <= d).to(torch.float32)

    return _bilinear(tap(cy0, cx0, inside[0]), tap(cy0, cx1, inside[1]),
                     tap(cy1, cx0, inside[2]), tap(cy1, cx1, inside[3]),
                     fy, fx)


def _border_taps(read, shape_hw, uv, border):
    """LINEAR + CLAMP_TO_BORDER from tap reads read(iy, ix)."""
    cy0, cx0, cy1, cx1, fy, fx, inside = _bilinear_clamped_taps(shape_hw, uv)

    def tap(iy, ix, inb):
        return torch.where(inb, read(iy, ix), border)

    return _bilinear(tap(cy0, cx0, inside[0]), tap(cy0, cx1, inside[1]),
                     tap(cy1, cx0, inside[2]), tap(cy1, cx1, inside[3]),
                     fy, fx)


def sample_shadow_compare(shadow_map: torch.Tensor, uv: torch.Tensor,
                          ref_depth: torch.Tensor) -> torch.Tensor:
    """sampler2DArrayShadow tap of one (S, S) cascade: hardware 2x2 PCF,
    compare LESS_OR_EQUAL, border white (sampling.py:120-147). Returns
    (...,) visibility in [0, 1]."""
    return _compare_taps(lambda iy, ix: _gather2d(shadow_map, iy, ix),
                         shadow_map.shape, uv, ref_depth)


def sample_bilinear_border(img: torch.Tensor, uv: torch.Tensor,
                           border: float = 1.0) -> torch.Tensor:
    """LINEAR + CLAMP_TO_BORDER of an (H, W) image (sampling.py:150-165)."""
    return _border_taps(lambda iy, ix: _gather2d(img, iy, ix),
                        img.shape[:2], uv, border)


def _gather_layered(maps: torch.Tensor, layer: torch.Tensor,
                    iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """maps (L, H, W) read at a per-element layer (sampling.py:519-524)."""
    _, h, w = maps.shape
    return take_rows(maps.reshape(-1), (layer * h + iy) * w + ix)


def sample_shadow_compare_array(maps: torch.Tensor, layer: torch.Tensor,
                                uv: torch.Tensor,
                                ref_depth: torch.Tensor) -> torch.Tensor:
    """sampler2DArrayShadow over (L, S, S) maps with a per-element layer
    (sampling.py:527-549)."""
    return _compare_taps(
        lambda iy, ix: _gather_layered(maps, layer, iy, ix),
        maps.shape[1:], uv, ref_depth)


def sample_bilinear_border_array(maps: torch.Tensor, layer: torch.Tensor,
                                 uv: torch.Tensor,
                                 border: float = 1.0) -> torch.Tensor:
    """sampler2DArray raw depth, LINEAR + border (sampling.py:552-568)."""
    return _border_taps(
        lambda iy, ix: _gather_layered(maps, layer, iy, ix),
        maps.shape[1:], uv, border)


def quad_pack(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, 4) edge-clamped 2x2 neighbourhoods
    [d(y,x), d(y,x+1), d(y+1,x), d(y+1,x+1)] (sampling.py:192-199). A CUDA
    tensor goes to the quad-packing kernel K11
    (ops/quad_pack_cuda.py::quad_pack), which takes a contiguous float32
    (..., H, W) and raises on anything else; a CPU tensor to the plain
    twin."""
    if img.device.type == "cuda":
        return quad_pack_cuda.quad_pack(img)
    return quad_pack_plain(img)


def quad_pack_plain(img: torch.Tensor) -> torch.Tensor:
    """quad_pack as three cats and a stack: the CPU path and the kernel's
    test oracle."""
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    down_right = torch.cat([down[..., :, 1:], down[..., :, -1:]], dim=-1)
    return torch.stack([img, right, down, down_right], dim=-1)


def quad_pack_nhwc(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H, W, 4C), wrap-addressed (REPEAT)
    (sampling.py:202-208)."""
    right = torch.roll(img, -1, dims=-2)
    down = torch.roll(img, -1, dims=-3)
    down_right = torch.roll(down, -1, dims=-2)
    return torch.cat([img, right, down, down_right], dim=-1)


def _row_gather(packed: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """sampling.py:211-215."""
    h, w, k = packed.shape
    return take_rows(packed.reshape(h * w, k), iy * w + ix)


def sample_bilinear_repeat_packed_layers(tex_packed: torch.Tensor,
                                         sizes: torch.Tensor,
                                         layer: torch.Tensor,
                                         uv: torch.Tensor) -> torch.Tensor:
    """Bilinear REPEAT from quad-packed texture layers (N, H, W, 4C)
    (sampling.py:218-250)."""
    n, hp, wp, k4 = tex_packed.shape
    c = k4 // 4
    oh = layer[..., None] == torch.arange(n, dtype=torch.int32,
                                          device=layer.device)
    h = torch.where(oh, sizes[:, 0], 0.0).sum(-1)
    w = torch.where(oh, sizes[:, 1], 0.0).sum(-1)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # jnp.mod on floats is torch.remainder (sign of the divisor), not fmod.
    ix = to_i32(torch.remainder(x0, w))
    iy = to_i32(torch.remainder(y0, h))
    flat = tex_packed.reshape(n * hp * wp, k4)
    quad = take_rows(flat, (layer * hp + iy) * wp + ix)
    t00 = quad[..., 0 * c:1 * c]
    t10 = quad[..., 1 * c:2 * c]
    t01 = quad[..., 2 * c:3 * c]
    t11 = quad[..., 3 * c:4 * c]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _quad_corners(quad, x_ok, y_ok):
    """Corners of a quad whose base was clamped up from a negative index
    (sampling.py:253-263)."""
    c00, c10, c01, c11 = (quad[..., 0], quad[..., 1],
                          quad[..., 2], quad[..., 3])
    c10 = torch.where(x_ok, c10, c00)
    c11 = torch.where(x_ok, c11, c01)
    c01 = torch.where(y_ok, c01, c00)
    c11 = torch.where(y_ok, c11, c10)
    return c00, c10, c01, c11


def _quad_tap_setup(shape_hw, uv):
    """sampling.py:266-286."""
    h, w = shape_hw
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = to_i32(x0f)
    y0 = to_i32(y0f)

    def inb(iy, ix):
        return (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)

    inside = (inb(y0, x0), inb(y0, x0 + 1), inb(y0 + 1, x0),
              inb(y0 + 1, x0 + 1))
    cy = y0.clamp(0, h - 1)
    cx = x0.clamp(0, w - 1)
    return cy, cx, fy, fx, inside, (x0 >= 0), (y0 >= 0)


def sample_shadow_compare_packed(packed_maps: torch.Tensor,
                                 layer: torch.Tensor, uv: torch.Tensor,
                                 ref_depth: torch.Tensor) -> torch.Tensor:
    """Hardware-PCF compare tap from quad-packed cascades (L, S, S, 4),
    border white (sampling.py:289-309)."""
    l, s = packed_maps.shape[0], packed_maps.shape[1]
    cy, cx, fy, fx, inside, x_ok, y_ok = _quad_tap_setup((s, s), uv)
    flat = packed_maps.reshape(l * s * s, 4)
    quad = take_rows(flat, (layer * s + cy) * s + cx)
    c00, c10, c01, c11 = _quad_corners(quad, x_ok, y_ok)

    def cmp(d, inb):
        return torch.where(inb, (ref_depth <= d).to(torch.float32), 1.0)

    t00 = cmp(c00, inside[0])
    t10 = cmp(c10, inside[1])
    t01 = cmp(c01, inside[2])
    t11 = cmp(c11, inside[3])
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear_border_packed(packed_maps: torch.Tensor,
                                  layer: torch.Tensor, uv: torch.Tensor,
                                  border: float = 1.0) -> torch.Tensor:
    """Raw-depth LINEAR + CLAMP_TO_BORDER tap from quad-packed cascades
    (L, S, S, 4): one gathered row per tap (sampling.py:312-329)."""
    l, s = packed_maps.shape[0], packed_maps.shape[1]
    cy, cx, fy, fx, inside, x_ok, y_ok = _quad_tap_setup((s, s), uv)
    quad = take_rows(packed_maps.reshape(l * s * s, 4),
                     (layer * s + cy) * s + cx)
    corners = _quad_corners(quad, x_ok, y_ok)
    return _bilinear(*(torch.where(inb, c, border)
                       for c, inb in zip(corners, inside)), fy, fx)


def sample_nearest_border_packed(packed_maps: torch.Tensor,
                                 layer: torch.Tensor, uv: torch.Tensor,
                                 border: float = 1.0) -> torch.Tensor:
    """NEAREST + CLAMP_TO_BORDER raw-depth tap from quad-packed cascades
    (sampling.py:332-362)."""
    l, s = packed_maps.shape[0], packed_maps.shape[1]
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = to_i32(torch.floor(x))
    y0 = to_i32(torch.floor(y))
    cx = x0.clamp(0, s - 1)
    cy = y0.clamp(0, s - 1)
    flat = packed_maps.reshape(l * s * s, 4)
    quad = take_rows(flat, (layer * s + cy) * s + cx)
    c00, c10, c01, c11 = _quad_corners(quad, x0 >= 0, y0 >= 0)
    return _nearest_of_quad(uv, s, cx, cy, c00, c10, c01, c11, border)


# Windowed variants (sampling.py:365-434): the same arithmetic in full-map
# coordinates, with the row read from a (Wh, Ww, 4) window of one cascade's
# quad-packed table at `origin` (oy, ox). Bit-identical to the full-table
# samplers for taps whose clamped base texel lies inside the window; others
# clamp to the window's edge.

def _window_fetch(window: torch.Tensor, origin, cy: torch.Tensor,
                  cx: torch.Tensor) -> torch.Tensor:
    """sampling.py:381-386."""
    wh, ww = window.shape[0], window.shape[1]
    ly = (cy - origin[0]).clamp(0, wh - 1)
    lx = (cx - origin[1]).clamp(0, ww - 1)
    return take_rows(window.reshape(wh * ww, 4), ly * ww + lx)


def sample_shadow_compare_window(window: torch.Tensor, origin,
                                 full_size: int, uv: torch.Tensor,
                                 ref_depth: torch.Tensor) -> torch.Tensor:
    """sample_shadow_compare_packed through a window (sampling.py:
    389-408); the border is white outside the full map."""
    s = full_size
    cy, cx, fy, fx, inside, x_ok, y_ok = _quad_tap_setup((s, s), uv)
    quad = _window_fetch(window, origin, cy, cx)
    c00, c10, c01, c11 = _quad_corners(quad, x_ok, y_ok)

    def cmp(d, inb):
        return torch.where(inb, (ref_depth <= d).to(torch.float32), 1.0)

    t00 = cmp(c00, inside[0])
    t10 = cmp(c10, inside[1])
    t01 = cmp(c01, inside[2])
    t11 = cmp(c11, inside[3])
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _nearest_of_quad(uv, s, cx, cy, c00, c10, c01, c11, border):
    nxi = to_i32(torch.floor(uv[..., 0] * s))
    nyi = to_i32(torch.floor(uv[..., 1] * s))
    inb = (nxi >= 0) & (nxi < s) & (nyi >= 0) & (nyi < s)
    nx = (nxi.clamp(0, s - 1) - cx).clamp(0, 1)
    ny = (nyi.clamp(0, s - 1) - cy).clamp(0, 1)
    nearest = torch.where(
        ny == 0,
        torch.where(nx == 0, c00, c10),
        torch.where(nx == 0, c01, c11))
    return torch.where(inb, nearest, border)


def sample_nearest_border_window(window: torch.Tensor, origin,
                                 full_size: int, uv: torch.Tensor,
                                 border: float = 1.0) -> torch.Tensor:
    """sample_nearest_border_packed through a window (sampling.py:
    411-434)."""
    s = full_size
    x0 = to_i32(torch.floor(uv[..., 0] * s - 0.5))
    y0 = to_i32(torch.floor(uv[..., 1] * s - 0.5))
    cx = x0.clamp(0, s - 1)
    cy = y0.clamp(0, s - 1)
    quad = _window_fetch(window, origin, cy, cx)
    c00, c10, c01, c11 = _quad_corners(quad, x0 >= 0, y0 >= 0)
    return _nearest_of_quad(uv, s, cx, cy, c00, c10, c01, c11, border)


def _dual_read(quad, uv, h, w, ix, iy, fx, fy, x0, y0):
    """Bilinear + nearest of one gathered quad (sampling.py:455-473)."""
    c00, c10, c01, c11 = _quad_corners(quad, x0 >= 0, y0 >= 0)
    fx = fx.clamp(0.0, 1.0)
    fy = fy.clamp(0.0, 1.0)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    bilinear = top * (1 - fy) + bot * fy
    nx = to_i32(torch.floor(uv[..., 0] * w)).clamp(0, w - 1) - ix
    ny = to_i32(torch.floor(uv[..., 1] * h)).clamp(0, h - 1) - iy
    nx = nx.clamp(0, 1)
    ny = ny.clamp(0, 1)
    nearest = torch.where(
        ny == 0,
        torch.where(nx == 0, c00, c10),
        torch.where(nx == 0, c01, c11))
    return bilinear, nearest


def _dual_setup(uv, h, w):
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    x0 = to_i32(x0f)
    y0 = to_i32(y0f)
    return x - x0f, y - y0f, x0, y0, x0.clamp(0, w - 1), y0.clamp(0, h - 1)


def sample_depth_dual_window(window: torch.Tensor, origin, full_hw,
                             uv: torch.Tensor):
    """sample_depth_dual_packed through a (wh, ww, 4) window of the full
    (H, W, 4) quad-packed depth at `origin` (oy, ox) (sampling.py:
    476-516)."""
    h, w = full_hw
    wh, ww = window.shape[0], window.shape[1]
    fx, fy, x0, y0, ix, iy = _dual_setup(uv, h, w)
    lx = (ix - origin[1]).clamp(0, ww - 1)
    ly = (iy - origin[0]).clamp(0, wh - 1)
    quad = _row_gather(window, ly, lx)
    return _dual_read(quad, uv, h, w, ix, iy, fx, fy, x0, y0)


def sample_depth_dual_packed(packed: torch.Tensor, uv: torch.Tensor):
    """Bilinear + nearest CLAMP_TO_EDGE reads of one quad-packed depth
    buffer (H, W, 4) from one row gather (sampling.py:437-473). Returns
    (bilinear, nearest)."""
    h, w, _ = packed.shape
    fx, fy, x0, y0, ix, iy = _dual_setup(uv, h, w)
    return _dual_read(_row_gather(packed, iy, ix), uv, h, w, ix, iy, fx, fy,
                      x0, y0)


def sample_nearest_edge(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """NEAREST + CLAMP_TO_EDGE (sampling.py:571-576)."""
    h, w = img.shape[0], img.shape[1]
    ix = to_i32(torch.floor(uv[..., 0] * w)).clamp(0, w - 1)
    iy = to_i32(torch.floor(uv[..., 1] * h)).clamp(0, h - 1)
    return _gather2d(img, iy, ix)


def _linear_weights(m: int, n: int) -> np.ndarray:
    """(m, n) f32 weights that resample m samples to n with the triangle
    kernel, jax/_src/image/scale.py::compute_weight_mat for an upsampling
    resize (scale n / m, no translation): sample positions (j + 0.5) / scale
    - 0.5, each column normalised by its sum, columns whose sample lies
    outside the input zeroed. The f32 arithmetic is XLA's run op by op."""
    inv = np.float32(1.0 / (n / m))
    f = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.0) - np.float32(0.5)
    x = np.abs(f[None, :] - np.arange(m, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (f >= -0.5) & (f <= m - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


_WEIGHTS: dict = {}


def _weights_on(m: int, n: int, device) -> torch.Tensor:
    """_linear_weights(m, n) on `device`, uploaded once per shape (through
    math3d.const, so a CUDA-graph capture reads the kept tensor)."""
    from ..math3d import const

    key = (m, n, str(torch.device(device)))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = const(_linear_weights(m, n), torch.float32, device)
    return _WEIGHTS[key]


def resize_linear(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """jax.image.resize(a, (h, w), "linear") for a 2-D f32 image enlarged
    to (h, w) in both dimensions (frame.py:794-795): the separable weight
    matrices of `_linear_weights` contracted over the columns first, then
    the rows, in full f32 products, as XLA's einsum orders them.
    F.interpolate is not this function: it rounds its sample positions
    apart (1 ulp on about a third of the pixels) and differs at shapes
    that are not multiples."""
    hs, ws = a.shape
    return _weights_on(hs, h, a.device).T @ (a @ _weights_on(ws, w,
                                                             a.device))
