"""Deferred attribute interpolation from the visibility buffer (port of
funky_tpu/passes/deferred.py): perspective-correct barycentric weights
from the winning triangle's setup planes and shade block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.sampling import take_rows


class GBuffer(NamedTuple):
    """deferred.py:27-35; all (H, W, ...) tensors."""
    valid: torch.Tensor   # (H, W) bool
    world: torch.Tensor   # (H, W, 3)
    normal: torch.Tensor  # (H, W, 3), normalized in shading
    uv: torch.Tensor      # (H, W, 2)
    color: torch.Tensor   # (H, W, 3)
    flags: torch.Tensor   # (H, W) int32
    depth: torch.Tensor   # (H, W)


def interpolate_at(tri_id: torch.Tensor, depth: torch.Tensor,
                   setup_data: torch.Tensor, shade_blocks: torch.Tensor,
                   tri_flags: torch.Tensor, px: torch.Tensor,
                   py: torch.Tensor) -> GBuffer:
    """deferred.py:38-91. Sky pixels (tri_id -1) interpolate through
    triangle 0, as in JAX; their values are masked downstream."""
    valid = tri_id >= 0
    safe_id = tri_id.clamp(min=0)
    t = setup_data.shape[0]
    fused = torch.cat([
        setup_data[:, :9],
        shade_blocks.reshape(t, 36),
        tri_flags[:, None].to(torch.float32),
    ], dim=-1)                                           # (T, 46)
    rows = take_rows(fused, safe_id)
    planes = rows[..., :9]
    blocks = rows[..., 9:45].reshape(rows.shape[:-1] + (3, 12))
    flags = rows[..., 45].to(torch.int32)

    b0 = planes[..., 0] * px + planes[..., 1] * py + planes[..., 2]
    b1 = planes[..., 3] * px + planes[..., 4] * py + planes[..., 5]
    b2 = planes[..., 6] * px + planes[..., 7] * py + planes[..., 8]
    b = torch.stack([b0, b1, b2], dim=-1)

    inv_w = blocks[..., 11]
    pw = b * inv_w
    denom = pw.sum(dim=-1, keepdim=True)
    weights = pw / torch.where(torch.abs(denom) > 1e-20, denom, 1.0)

    # the three corners' attributes summed in order, per pixel (not a
    # batched matmul, whose kernel and rounding depend on the pixel count:
    # math3d.apply_rows)
    attrs = (weights[..., 0:1] * blocks[..., 0, :11]
             + weights[..., 1:2] * blocks[..., 1, :11]) \
        + weights[..., 2:3] * blocks[..., 2, :11]

    return GBuffer(
        valid=valid,
        world=attrs[..., 0:3],
        normal=attrs[..., 3:6],
        uv=attrs[..., 6:8],
        color=attrs[..., 8:11],
        flags=torch.where(valid, flags, 0),
        depth=depth,
    )


def pixel_centers(h: int, w: int, y0, device):
    """(H, W) x + 0.5 and global-row y + 0.5 + y0 pixel centres; y0 is an
    int or a 0-d device tensor (the row slab's start)."""
    px = (torch.arange(w, dtype=torch.float32, device=device)[None, :]
          + 0.5).expand(h, w)
    y0 = y0.to(torch.float32) if isinstance(y0, torch.Tensor) else float(y0)
    py = (torch.arange(h, dtype=torch.float32, device=device)[:, None]
          + 0.5 + y0).expand(h, w)
    return px, py


def interpolate(tri_id: torch.Tensor, depth: torch.Tensor,
                setup_data: torch.Tensor, shade_blocks: torch.Tensor,
                tri_flags: torch.Tensor, y0=0) -> GBuffer:
    """Full-slab interpolation starting at global row y0, an int or a 0-d
    device tensor (deferred.py:94-106)."""
    h, w = tri_id.shape
    px, py = pixel_centers(h, w, y0, tri_id.device)
    return interpolate_at(tri_id, depth, setup_data, shade_blocks,
                          tri_flags, px, py)
