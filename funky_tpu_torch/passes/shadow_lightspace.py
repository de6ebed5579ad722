"""Light-space footprint windows (port of the parts of
funky_tpu/passes/shadow_lightspace.py that the synthesized cascade maps
and the routed tap groups use): the occluders' uv bounding box, which is
their shadow footprint on the ground under the orthographic light, and the
per-cascade window origins placed on it.

The dense light-space ground evaluation itself (`build_light_shadow_map`,
`biased_ground_planes`, flag `light_space_ground_shadows`) is not ported
yet; `ground_eligible` is, because `shadow_filter.classify_stats` splits
its counts with it.

Window origins stay device tensors: the frame slices with them by index
arithmetic, never by reading them on the host.
"""

from __future__ import annotations

import math

import torch

from .uniforms import FrameUniforms

# World height of the planar receiver: the ground quad lies at y = 0 with an
# identity model matrix (shadow_lightspace.py:58-60).
GROUND_Y = 0.0


def halo_texels(max_softness: float) -> int:
    """Tap reach in texels (shadow_lightspace.py:66-67)."""
    return math.ceil(4.0 * max_softness) + 2


def occluder_uv_bbox(world_v: torch.Tensor, vert_object: torch.Tensor,
                     light_view_proj: torch.Tensor):
    """Per-cascade uv bbox of every vertex off the ground (object slot 0):
    the scene's shadow footprint (shadow_lightspace.py:100-115). Returns
    (lo, hi), each (L, 2) in uv units."""
    mask = (vert_object != 0)[None, :, None]                 # (1, V, 1)
    ones = torch.ones((world_v.shape[0], 1), dtype=torch.float32,
                      device=world_v.device)
    hom = torch.cat([world_v, ones], dim=-1)
    clip = torch.einsum("cij,vj->cvi", light_view_proj, hom)  # (L, V, 4)
    uv = clip[..., :2] / clip[..., 3:4] * 0.5 + 0.5          # (L, V, 2)
    lo = torch.where(mask, uv, 1e30).amin(dim=1)
    hi = torch.where(mask, uv, -1e30).amax(dim=1)
    return lo, hi


def window_pad(max_softness: float, coarse: int) -> int:
    """Texels of margin around the footprint that can still hold unclosed
    ground pixels (shadow_lightspace.py:118-122)."""
    return halo_texels(max_softness) + 2 * coarse + 16


def window_size_for_extent(extent: int, pad: int,
                           fetch_count: int = 1 << 30) -> int:
    """Static window size for a measured footprint extent, host math
    (shadow_lightspace.py:125-134): footprint + 2 pad rounded up to 128,
    between 256 and 768; 0 when too few pixels fetch."""
    if fetch_count < 1024 or extent <= 0:
        return 0
    want = -(-(extent + 2 * pad) // 128) * 128
    return int(min(max(want, 256), 768))


def window_origin(lo_uv: torch.Tensor, hi_uv: torch.Tensor, size: int,
                  wc: int, pad: int):
    """Clamped, 8-aligned window origin (oy, ox) as 0-d int32 tensors,
    centred on the footprint bbox + pad texels (shadow_lightspace.py:
    156-167)."""
    from ..ops.sampling import to_i32

    lo_t = to_i32(torch.floor(lo_uv * size)) - pad
    hi_t = to_i32(torch.ceil(hi_uv * size)) + pad
    center = torch.div(lo_t + hi_t, 2, rounding_mode="floor")
    org = torch.clamp(center - wc // 2, 0, max(size - wc, 0))
    org = torch.div(org, 8, rounding_mode="floor") * 8
    return org[1], org[0]     # (oy, ox) from (u, v) = (x, y)


def plan_windows(uni: FrameUniforms, world_v: torch.Tensor,
                 vert_object: torch.Tensor, sizes, map_size: int,
                 max_softness: float, coarse: int):
    """Per-cascade window origins for the static `sizes` (None where a
    size is 0), on the shadow-footprint bbox (shadow_lightspace.py:
    137-153). Returns (origins, (lo, hi))."""
    lo, hi = occluder_uv_bbox(world_v, vert_object, uni.light_view_proj)
    pad = window_pad(max_softness, coarse)
    origins = tuple(window_origin(lo[c], hi[c], map_size, sizes[c], pad)
                    if sizes[c] else None for c in range(len(sizes)))
    return origins, (lo, hi)


def ground_eligible(world: torch.Tensor, normal: torch.Tensor,
                    receiver: torch.Tensor) -> torch.Tensor:
    """Pixels whose shadow evaluation is exactly the planar-receiver math:
    on the plane, unit up normal, receiver <= 1 (shadow_lightspace.py:
    334-342)."""
    return ((torch.abs(world[..., 1] - GROUND_Y) < 1e-4)
            & (normal[..., 1] > 0.9999)
            & (receiver <= 1.0))
