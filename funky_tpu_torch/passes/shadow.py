"""Shadow cascade depth passes (port of
funky_tpu/passes/shadow.py::render_shadow_maps; the synthesized-map mode
is not ported yet). Each cascade is one depth-only run of the shared tile
raster, so on a card each cascade is one raster-kernel launch.
"""

from __future__ import annotations

import torch

from ..ops.raster import RasterConfig, raster_scene
from .uniforms import SHADOW_MAP_SIZE

SHADOW_RASTER_CFG = RasterConfig(tile_h=128, tile_w=256, capacity=None)


def render_shadow_maps(world: torch.Tensor, tri_indices: torch.Tensor,
                       num_triangles: int, light_view_proj: torch.Tensor,
                       cfg: RasterConfig = SHADOW_RASTER_CFG,
                       size: int = SHADOW_MAP_SIZE) -> torch.Tensor:
    """shadow.py:29-50. Returns (C, size, size) f32 NDC depth, 1.0 empty."""
    ones = torch.ones((world.shape[0], 1), dtype=torch.float32,
                      device=world.device)
    hom = torch.cat([world, ones], dim=-1)
    depths = []
    for c in range(light_view_proj.shape[0]):
        clip = hom @ light_view_proj[c].T
        _, depth, _ = raster_scene(clip, tri_indices, size, size,
                                   num_triangles, cfg)
        depths.append(depth)
    return torch.stack(depths)
