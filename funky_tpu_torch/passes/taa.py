"""Shadow TAA: history reprojection + variance clamp (port of
funky_tpu/passes/taa.py::apply_shadow_taa on a row slab).

The JAX version picks between an aligned-history fast path (taa.py:159-189)
and the gathered read (taa.py:131-133) with a lax.cond; both give the same
output, so the port always takes the gathered read. The sparse `need`-set
read (taa_need_capacity) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.sampling import sample_nearest_edge
from .deferred import pixel_centers
from .shadow_filter import ShadowResult
from .uniforms import FrameUniforms


def init_history(height: int, width: int, device) -> torch.Tensor:
    """(1, 1) = lit, far (taa.py:26-27)."""
    return torch.ones((height, width, 2), dtype=torch.float32, device=device)


def apply_shadow_taa(cur: ShadowResult, world: torch.Tensor,
                     uni: FrameUniforms, history: torch.Tensor,
                     use_shadow_taa: bool, y0: int = 0,
                     full_height: int | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """taa.py:30-193 for an (h, W) row slab at global row y0 with the
    dense gathered history read. `history` is the full-frame buffer.
    Returns (out_shadow, new_history (h, W, 2))."""
    current = cur.v
    h, w = current.shape
    fh = full_height if full_height is not None else h
    fw = w
    frag_x, frag_y = pixel_centers(h, w, y0, current.device)

    ones = torch.ones(world.shape[:-1] + (1,), dtype=torch.float32,
                      device=world.device)
    hom = torch.cat([world, ones], dim=-1)
    cur_clip = torch.einsum("ij,...j->...i", uni.view_proj, hom)
    cur_ndc_depth = torch.where(cur_clip[..., 3] != 0.0,
                                cur_clip[..., 2] / cur_clip[..., 3], 1.0)
    cur_ndc_depth = cur_ndc_depth.clamp(0.0, 1.0)

    if not use_shadow_taa:
        return current, torch.stack([current, cur_ndc_depth], dim=-1)

    current_uv = torch.stack(
        [(frag_x + 0.5) / fw, (frag_y + 0.5) / fh], dim=-1)

    prev_clip = torch.einsum("ij,...j->...i", uni.prev_view_proj, hom)
    w_ok = prev_clip[..., 3] > 0.0
    prev_ndc = prev_clip[..., :3] / torch.where(w_ok[..., None],
                                                prev_clip[..., 3:4], 1.0)
    prev_uv = prev_ndc[..., :2] * 0.5 + 0.5
    in_bounds = (w_ok
                 & (prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0)
                 & (prev_ndc[..., 2] >= 0.0) & (prev_ndc[..., 2] <= 1.0))

    motion = torch.linalg.vector_norm(prev_uv - current_uv, dim=-1)

    variance = torch.clamp(cur.m2 - cur.m1 * cur.m1, min=0.0)
    stdev = torch.sqrt(variance)
    softness = torch.clamp(cur.kernel_radius_texels / 8.0, 0.0, 1.0)
    sigma = 2.5 + (0.9 - 2.5) * softness
    lo = cur.m1 - sigma * stdev
    hi = cur.m1 + sigma * stdev
    history_weight = 0.55 + (0.85 - 0.55) * softness

    hist = sample_nearest_edge(history, prev_uv)
    history_shadow = hist[..., 0]
    history_depth = hist[..., 1]
    delta = torch.abs(history_shadow - current)
    depth_delta = torch.abs(history_depth - prev_ndc[..., 2])
    reject = (motion > 0.02) | (depth_delta > 0.02) | (delta > 0.35)
    history_clamped = torch.minimum(torch.maximum(history_shadow, lo), hi)
    blended = current + (history_clamped - current) * history_weight
    out = torch.where(in_bounds & ~reject, blended, current)
    return out, torch.stack([out, cur_ndc_depth], dim=-1)
