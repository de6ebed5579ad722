"""UI overlay rasterization and premultiplied-alpha compositing (port of
funky_tpu/passes/overlay.py).

Screen-space triangles with (pos, uv, premultiplied RGBA) vertices are
blended ONE / ONE_MINUS_SRC_ALPHA into a fixed panel image, which is then
composited over the frame. Blending is order-dependent, so triangles are
drawn one after another. The JAX version scans all MAX_TRIS slots, padded
ones included; a padded or degenerate triangle leaves the panel unchanged
(overlay.py:51, :75), so the port keeps the real triangles only, in the
same order, with the same per-pixel arithmetic, each on the pixels its
bounding box can cover.

The triangle list is host data (app/ui.py's Tessellator): `overlay_table`
turns it into one f32 row per drawn triangle in numpy, rounded as XLA
rounds its f32 scalars, and `rasterize_overlay` draws the table:
`rasterize_overlay_plain` (the host loop over the table, each triangle's
torch ops on its crop box, the atlas read through `take_rows`) for a CPU
atlas; for any other it uploads the table in one copy to the overlay
kernel K4 (ops/overlay_cuda.py::overlay_raster, csrc/overlay.cu), one
thread per panel pixel walking the table in order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import overlay_cuda
from ..ops.overlay_cuda import (TABLE_COLOR, TABLE_COLS, TABLE_CROP,
                                TABLE_SCALARS, TABLE_UV)
from ..ops.sampling import (dynamic_slice, dynamic_update_slice,
                            sample_bilinear_edge)


def overlay_table(verts, uvs, colors, tris, n_tris: int,
                  panel_hw: tuple) -> np.ndarray:
    """(T, TABLE_COLS) f32 rows of the triangles the panel draws, in draw
    order: the first n_tris of `tris` less the padded rows (t0 < 0), the
    degenerate ones (!(|area| > 1e-12), overlay.py:61-62) and those whose
    crop box holds no pixel.

    The crop box is the triangle's bounding box with a one-pixel margin. A
    pixel centre farther out has a barycentric below -1/460 (the panel's
    diagonal), which f32 rounding at these coordinates cannot lift to 0
    once the triangle's area is 8 px^2 or more (|area| is twice that); a
    smaller one gets the whole panel. The panel is the same as without
    the crop. Every value is a numpy f32 operation in the JAX body's
    order, one triangle per element."""
    ph, pw = panel_hw
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris)[:int(n_tris)]
    tris = tris[tris[:, 0] >= 0]
    (x0, y0), (x1, y1), (x2, y2) = (verts[tris[:, k]].T for k in range(3))
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    xs, ys = np.stack([x0, x1, x2]), np.stack([y0, y1, y2])
    big = np.abs(area) >= 16.0

    def box(lo, hi, n):
        a = np.maximum(np.floor(lo - 0.5).astype(np.int64) - 1, 0)
        b = np.minimum(np.ceil(hi - 0.5).astype(np.int64) + 2, n)
        return np.where(big, a, 0), np.where(big, b, n)

    cx0, cx1 = box(xs.min(0), xs.max(0), pw)
    cy0, cy1 = box(ys.min(0), ys.max(0), ph)
    keep = (np.abs(area) > 1e-12) & (cx0 < cx1) & (cy0 < cy1)
    tris, area = tris[keep], area[keep]
    x0, y0, x1, y1, x2, y2 = (v[keep] for v in (x0, y0, x1, y1, x2, y2))
    table = np.zeros((len(tris), TABLE_COLS), np.float32)
    table[:, :TABLE_SCALARS] = np.stack(
        [np.float32(1.0) / area, x2 - x1, y2 - y1, x0 - x2, y0 - y2, x1, y1,
         x2, y2], axis=-1)
    table[:, TABLE_CROP:TABLE_CROP + 4] = np.stack(
        [cx0[keep], cx1[keep], cy0[keep], cy1[keep]], axis=-1)
    uvs = np.asarray(uvs, np.float32)
    colors = np.asarray(colors, np.float32)
    for k in range(3):
        table[:, TABLE_UV + 2 * k:TABLE_UV + 2 * k + 2] = uvs[tris[:, k]]
        table[:, TABLE_COLOR + 4 * k:TABLE_COLOR + 4 * k + 4] = \
            colors[tris[:, k]]
    return table


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
    table = torch.from_numpy(overlay_table(verts, uvs, colors, tris, n_tris,
                                           panel_hw))
    if atlas.device.type == "cpu":
        return rasterize_overlay_plain(table, atlas, panel_hw)
    return overlay_cuda.overlay_raster(table.to(atlas.device), atlas,
                                       panel_hw)


def rasterize_overlay_plain(table: torch.Tensor, atlas: torch.Tensor,
                            panel_hw: tuple) -> torch.Tensor:
    """The overlay kernel's plain twin: the panel of an overlay_table as a
    host loop over its rows, each triangle's torch ops on its crop box, on
    the atlas's device (the CPU path and the kernel's test oracle)."""
    ph, pw = panel_hw
    dev = atlas.device
    rows_t = table.to(dev)
    px = torch.arange(pw, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(ph, dtype=torch.float32, device=dev)[:, None] + 0.5

    out = torch.zeros((ph, pw, 4), dtype=torch.float32, device=dev)
    # f32 scalars as exact Python floats: torch applies them in f32
    for i, row in enumerate(table.cpu().tolist()):
        inv_area, dx21, dy21, dx02, dy02, x1, y1, x2, y2 = \
            row[:TABLE_SCALARS]
        cx0, cx1, cy0, cy1 = (int(v) for v in
                              row[TABLE_CROP:TABLE_CROP + 4])
        uv0, uv1, uv2 = (rows_t[i, TABLE_UV + 2 * k:TABLE_UV + 2 * k + 2]
                         for k in range(3))
        c0, c1, c2 = (rows_t[i, TABLE_COLOR + 4 * k:TABLE_COLOR + 4 * k + 4]
                      for k in range(3))
        cpx, cpy = px[:, cx0:cx1], py[cy0:cy1]
        b0 = (dx21 * (cpy - y1) - dy21 * (cpx - x1)) * inv_area
        b1 = (dx02 * (cpy - y2) - dy02 * (cpx - x2)) * inv_area
        b2 = 1.0 - b0 - b1
        cover = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)

        b0, b1, b2 = b0[..., None], b1[..., None], b2[..., None]
        uv = b0 * uv0 + b1 * uv1 + b2 * uv2
        col = b0 * c0 + b1 * c1 + b2 * c2

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
