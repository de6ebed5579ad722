"""UI overlay rasterization and premultiplied-alpha compositing (port of
funky_tpu/passes/overlay.py).

Screen-space triangles with (pos, uv, premultiplied RGBA) vertices are
blended ONE / ONE_MINUS_SRC_ALPHA into a fixed panel image, which is then
composited over the frame. Blending is order-dependent, so triangles are
drawn one after another. The JAX version scans all MAX_TRIS slots, padded
ones included; a padded or degenerate triangle leaves the panel unchanged
(overlay.py:51, :75), so the port loops on the host over the real
triangles only, in the same order, with the same per-pixel arithmetic,
each on the pixels its bounding box can cover.
The triangle list is host data (app/ui.py's Tessellator), so each
triangle's vertex terms are numpy f32 scalars, rounded as XLA rounds its
f32 scalars. The atlas reads go through `take_rows` (K3 on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.sampling import (dynamic_slice, dynamic_update_slice,
                            sample_bilinear_edge)


def rasterize_overlay(verts, uvs, colors, tris, n_tris: int,
                      atlas: torch.Tensor, panel_hw: tuple) -> torch.Tensor:
    """Rasterize UI triangles into a premultiplied RGBA panel image
    (overlay.py:26-82).

    Args:
      verts: (V, 2) panel-relative pixel positions (numpy f32).
      uvs: (V, 2) atlas uv (numpy f32).
      colors: (V, 4) premultiplied linear RGBA (numpy f32).
      tris: (T, 3) int32 vertex indices, padded with -1 rows (numpy).
      n_tris: the real triangle count (a host int).
      atlas: (Ah, Aw, 4) font atlas tensor (rgb 1, a coverage); the panel
        is made on its device.
      panel_hw: (H, W) of the panel.

    Returns (H, W, 4) premultiplied RGBA.
    """
    ph, pw = panel_hw
    dev = atlas.device
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris)
    uvs_t = torch.as_tensor(np.asarray(uvs, np.float32), device=dev)
    cols_t = torch.as_tensor(np.asarray(colors, np.float32), device=dev)
    px = torch.arange(pw, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(ph, dtype=torch.float32, device=dev)[:, None] + 0.5

    out = torch.zeros((ph, pw, 4), dtype=torch.float32, device=dev)
    for i in range(int(n_tris)):
        t0, t1, t2 = (int(k) for k in tris[i])
        if t0 < 0:
            continue
        (x0, y0), (x1, y1), (x2, y2) = verts[t0], verts[t1], verts[t2]
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        if not abs(area) > 1e-12:
            continue                   # covers nothing (overlay.py:61-62)
        # The pixels the triangle can cover: its bounding box with a
        # one-pixel margin. A pixel centre farther out has a barycentric
        # below -1/460 (the panel's diagonal), which f32 rounding at these
        # coordinates cannot lift to 0 once the triangle's area is 8 px^2
        # or more (|area| is twice that); a smaller one is evaluated on
        # the whole panel. The panel is the same as without the crop.
        xs, ys = (x0, x1, x2), (y0, y1, y2)
        if abs(area) >= 16.0:
            cx0 = max(int(math.floor(min(xs) - 0.5)) - 1, 0)
            cx1 = min(int(math.ceil(max(xs) - 0.5)) + 2, pw)
            cy0 = max(int(math.floor(min(ys) - 0.5)) - 1, 0)
            cy1 = min(int(math.ceil(max(ys) - 0.5)) + 2, ph)
        else:
            cx0, cx1, cy0, cy1 = 0, pw, 0, ph
        if cx0 >= cx1 or cy0 >= cy1:
            continue
        # f32 scalars as exact Python floats: torch applies them in f32
        f = [float(v) for v in (np.float32(1.0) / area, x2 - x1, y2 - y1,
                                x0 - x2, y0 - y2, x1, y1, x2, y2)]
        inv_area, dx21, dy21, dx02, dy02, x1, y1, x2, y2 = f
        cpx, cpy = px[:, cx0:cx1], py[cy0:cy1]
        b0 = (dx21 * (cpy - y1) - dy21 * (cpx - x1)) * inv_area
        b1 = (dx02 * (cpy - y2) - dy02 * (cpx - x2)) * inv_area
        b2 = 1.0 - b0 - b1
        cover = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)

        b0, b1, b2 = b0[..., None], b1[..., None], b2[..., None]
        uv = b0 * uvs_t[t0] + b1 * uvs_t[t1] + b2 * uvs_t[t2]
        col = b0 * cols_t[t0] + b1 * cols_t[t1] + b2 * cols_t[t2]

        tex = sample_bilinear_edge(atlas, uv)
        src_rgb = col[..., :3] * tex[..., :3] * tex[..., 3:4]
        src_a = col[..., 3:4] * tex[..., 3:4]
        src = torch.cat([src_rgb, src_a], dim=-1)

        crop = out[cy0:cy1, cx0:cx1]
        blended = src + crop * (1.0 - src_a)               # ONE/1-SRC_ALPHA
        out[cy0:cy1, cx0:cx1] = torch.where(cover[..., None], blended, crop)
    return out


def composite_overlay(image: torch.Tensor, overlay: torch.Tensor,
                      panel_x: int, panel_y: int) -> torch.Tensor:
    """Blend the premultiplied overlay panel over the frame at (x, y)
    (overlay.py:85-102): the overlay pass loads the framebuffer and blends
    over it. The starts are clamped as jax.lax.dynamic_slice clamps them."""
    ph, pw = overlay.shape[:2]
    region = dynamic_slice(image, (panel_y, panel_x), (ph, pw))
    a = overlay[..., 3:4]
    rgb = overlay[..., :3] + region[..., :3] * (1.0 - a)
    out_a = torch.clamp(a + region[..., 3:4] * (1.0 - a), 0.0, 1.0)
    blended = torch.cat([rgb, out_a], dim=-1)
    return dynamic_update_slice(image, blended, (panel_y, panel_x))
