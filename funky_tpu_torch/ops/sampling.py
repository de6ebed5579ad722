"""Texture / shadow-map samplers as gathers (port of funky_tpu/ops/sampling.py).

Only the samplers the dense glTF frame calls are ported. Two semantic
differences between the libraries are handled here for every sampler:

- A JAX gather clamps out-of-range indices; torch raises on the CPU and
  device-asserts on CUDA. `take_rows` clamps the flat index itself, which
  is what XLA's gather does with a 1-D start index.
- `x.astype(jnp.int32)` saturates (NaN -> 0) in XLA; `.to(torch.int32)` of
  NaN or out-of-range floats is undefined and differs between the CPU and
  CUDA. `to_i32` reproduces XLA's saturating conversion. Sky pixels reach
  the samplers with garbage coordinates (they interpolate through
  triangle 0, passes/deferred.py), so this matters.
"""

from __future__ import annotations

import torch

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
    range. The JAX version's index reshape is a TPU layout trick; here it
    is plain indexing on the normalized indices."""
    n = flat.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return flat[idx.long()]


def _gather2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """img (H, W) or (H, W, C) (sampling.py:64-68)."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape((h * w,) + tuple(img.shape[2:]))
    return take_rows(flat, iy * w + ix)


def quad_pack(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, 4) edge-clamped 2x2 neighbourhoods
    [d(y,x), d(y,x+1), d(y+1,x), d(y+1,x+1)] (sampling.py:192-199)."""
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


def sample_depth_dual_packed(packed: torch.Tensor, uv: torch.Tensor):
    """Bilinear + nearest CLAMP_TO_EDGE reads of one quad-packed depth
    buffer (H, W, 4) from one row gather (sampling.py:437-473). Returns
    (bilinear, nearest)."""
    h, w, _ = packed.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = to_i32(x0f)
    y0 = to_i32(y0f)
    ix = x0.clamp(0, w - 1)
    iy = y0.clamp(0, h - 1)
    quad = _row_gather(packed, iy, ix)
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


def sample_nearest_edge(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """NEAREST + CLAMP_TO_EDGE (sampling.py:571-576)."""
    h, w = img.shape[0], img.shape[1]
    ix = to_i32(torch.floor(uv[..., 0] * w)).clamp(0, w - 1)
    iy = to_i32(torch.floor(uv[..., 1] * h)).clamp(0, h - 1)
    return _gather2d(img, iy, ix)
