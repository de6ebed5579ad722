"""Triangle setup + tile binning (port of funky_tpu/ops/binning.py).

Setup rows are the same flat (T, 16) f32 layout as the JAX package:
  [0:9]   barycentric planes  bary_i(p) = a_i*px + b_i*py + c_i
  [9:12]  NDC-depth plane     z(p) = za*px + zb*py + zc
  [12:16] screen AABB (x0, y0, x1, y1)
The expressions are written in the JAX code's association so that each
product and sum rounds where XLA's does (XLA on the CPU may still contract
some of them into FMAs; the tests state the resulting tolerance).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import profiling
from .sampling import to_i32

SETUP_WIDTH = 16
_W_EPS = 1e-6


class TriangleSetup(NamedTuple):
    data: torch.Tensor   # (T, 16) f32
    valid: torch.Tensor  # (T,) bool


def triangle_setup(clip: torch.Tensor, tri_indices: torch.Tensor,
                   width: int, height: int,
                   num_triangles: int | None = None) -> TriangleSetup:
    """Setup from clip-space vertices + index triples (binning.py:56-73)."""
    tri_clip = clip[tri_indices.long()]
    valid_mask = None
    if num_triangles is not None:
        valid_mask = torch.arange(tri_indices.shape[0],
                                  device=clip.device) < num_triangles
    return triangle_setup_corners(tri_clip, width, height, valid_mask)


def triangle_setup_corners(tri_clip: torch.Tensor, width: int, height: int,
                           valid_mask: torch.Tensor | None = None
                           ) -> TriangleSetup:
    """Setup from per-corner clip positions (T, 3, 4)
    (binning.py:76-147)."""
    w = tri_clip[..., 3]
    w_ok = torch.all(w > _W_EPS, dim=-1)

    inv_w = 1.0 / torch.where(w > _W_EPS, w, 1.0)
    ndc = tri_clip[..., :3] * inv_w[..., None]

    sx = (ndc[..., 0] + 1.0) * (0.5 * width)
    sy = (ndc[..., 1] + 1.0) * (0.5 * height)
    sz = ndc[..., 2]

    x0, y0 = sx[:, 0], sy[:, 0]
    x1, y1 = sx[:, 1], sy[:, 1]
    x2, y2 = sx[:, 2], sy[:, 2]

    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    area_ok = torch.abs(area) > 1e-12
    inv_area = torch.where(area_ok, 1.0 / torch.where(area_ok, area, 1.0),
                           0.0)

    def edge(ax, ay, bx, by):
        ca = -(by - ay)
        cb = bx - ax
        cc = (by - ay) * ax - (bx - ax) * ay
        return ca, cb, cc

    e0 = edge(x1, y1, x2, y2)
    e1 = edge(x2, y2, x0, y0)
    e2 = edge(x0, y0, x1, y1)

    coeffs = torch.stack([
        e0[0] * inv_area, e0[1] * inv_area, e0[2] * inv_area,
        e1[0] * inv_area, e1[1] * inv_area, e1[2] * inv_area,
        e2[0] * inv_area, e2[1] * inv_area, e2[2] * inv_area,
    ], dim=-1)

    za = (coeffs[:, 0] * sz[:, 0] + coeffs[:, 3] * sz[:, 1]
          + coeffs[:, 6] * sz[:, 2])
    zb = (coeffs[:, 1] * sz[:, 0] + coeffs[:, 4] * sz[:, 1]
          + coeffs[:, 7] * sz[:, 2])
    zc = (coeffs[:, 2] * sz[:, 0] + coeffs[:, 5] * sz[:, 1]
          + coeffs[:, 8] * sz[:, 2])

    bx0 = torch.minimum(torch.minimum(x0, x1), x2).clamp(0.0, float(width))
    by0 = torch.minimum(torch.minimum(y0, y1), y2).clamp(0.0, float(height))
    bx1 = torch.maximum(torch.maximum(x0, x1), x2).clamp(0.0, float(width))
    by1 = torch.maximum(torch.maximum(y0, y1), y2).clamp(0.0, float(height))

    valid = w_ok & area_ok & (bx1 > bx0) & (by1 > by0)
    if valid_mask is not None:
        valid = valid & valid_mask

    data = torch.cat(
        [coeffs, torch.stack([za, zb, zc], dim=-1),
         torch.stack([bx0, by0, bx1, by1], dim=-1)], dim=-1)
    data = torch.where(valid[:, None], data, 0.0)
    return TriangleSetup(data=data, valid=valid)


def bin_triangles(setup: TriangleSetup, width: int, height: int,
                  tile_h: int, tile_w: int, capacity: int,
                  y_offset: int = 0, drops: str | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile triangle lists (binning.py:150-200).

    Returns bins (n_tiles, capacity) int32, ascending ids, -1 padded, and
    counts (n_tiles,) int32 clamped to capacity: a tile holding more than
    `capacity` triangles keeps its lowest ids and drops the rest. `drops`
    names the counter (utils/profiling.DROP_COUNTERS) that the dropped
    entries are added to on the device.
    """
    dev = setup.data.device
    t = setup.data.shape[0]
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)

    aabb = setup.data[:, 12:16]
    tx0 = to_i32(torch.floor(aabb[:, 0] / tile_w))
    ty0 = to_i32(torch.floor(aabb[:, 1] / tile_h))
    tx1 = to_i32(torch.floor((aabb[:, 2] - 1e-6) / tile_w))
    ty1 = to_i32(torch.floor((aabb[:, 3] - 1e-6) / tile_h))

    tile_ix = torch.arange(tiles_x, dtype=torch.int32, device=dev)
    tile_iy = (torch.arange(tiles_y, dtype=torch.int32, device=dev)
               + y_offset // tile_h)

    in_x = ((tile_ix[None, :] >= tx0[:, None])
            & (tile_ix[None, :] <= tx1[:, None]))
    in_y = ((tile_iy[None, :] >= ty0[:, None])
            & (tile_iy[None, :] <= ty1[:, None]))

    mask = (in_y[:, :, None] & in_x[:, None, :]
            & setup.valid[:, None, None])
    mask = mask.reshape(t, tiles_y * tiles_x)

    total = mask.sum(dim=0)
    counts = torch.clamp(total, max=capacity).to(torch.int32)
    if drops is not None:
        profiling.count_drops(drops, torch.clamp(total - capacity,
                                                 min=0).sum())

    big = 2 ** 30
    keys = torch.where(
        mask, torch.arange(t, dtype=torch.int32, device=dev)[:, None], big)
    # the sort is the binning's largest allocation: the mask goes first
    del mask
    if t < capacity:
        keys = torch.cat([keys, torch.full((capacity - t, keys.shape[1]),
                                           big, dtype=torch.int32,
                                           device=dev)])
    keys = torch.sort(keys, dim=0).values[:capacity]
    bins = torch.where(keys >= big, -1, keys).T.contiguous()
    return bins, counts


def bin_stats(clip: torch.Tensor, tri_indices: torch.Tensor, width: int,
              height: int, tile_h: int, tile_w: int,
              num_triangles: int | None = None):
    """Per-tile bin occupancy of one view (binning.py:203-222): dict of
    device tensors max, mean, total and the tile count n_tiles. It sizes
    RasterConfig.capacity (a full bin drops its highest ids)."""
    return _stats(triangle_setup(clip, tri_indices, width, height,
                                 num_triangles), width, height, tile_h,
                  tile_w)


def bin_stats_corners(tri_clip: torch.Tensor, valid_mask: torch.Tensor,
                      width: int, height: int, tile_h: int, tile_w: int):
    """bin_stats of per-corner clip positions (T, 3, 4): the main pass's
    triangles after the near-clip expansion."""
    return _stats(triangle_setup_corners(tri_clip, width, height,
                                         valid_mask), width, height, tile_h,
                  tile_w)


def _stats(setup: TriangleSetup, width: int, height: int, tile_h: int,
           tile_w: int):
    _, counts = bin_triangles(setup, width, height, tile_h, tile_w,
                              capacity=setup.data.shape[0])
    return {"max": counts.max(), "mean": counts.to(torch.float32).mean(),
            "total": counts.sum(), "n_tiles": counts.shape[0]}


def gather_bin_data(setup: TriangleSetup, bins: torch.Tensor) -> torch.Tensor:
    """Pre-gathered (n_tiles, C, 16) rows with the id bitcast into column
    12 (binning.py:225-237)."""
    rows = setup.data[bins.clamp(min=0).long()]
    rows[..., 12] = bins.view(torch.float32)
    return rows
