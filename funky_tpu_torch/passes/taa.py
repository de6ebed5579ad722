"""Shadow TAA: history reprojection + variance clamp (port of
funky_tpu/passes/taa.py::apply_shadow_taa), on a row slab or on any batch
with explicit pixel centres (the blocked back half's flat domain).

The history read, and how the port takes it:
- by default the gathered read (taa.py:131-133). On a row slab JAX picks
  between it and an aligned fast path (taa.py:159-189) with a lax.cond;
  both give the same output, so the port always gathers;
- with `need_capacity`, the compacted read of the pixels that consume
  their history (taa.py:135-157). Without `committed` an overflow takes
  the gathered read (one host branch). With `committed` the compacted
  read runs unconditionally and an overflow truncates it: the dropped
  pixels blend with the (1, 1) init value, as in JAX. On a row slab JAX
  still takes its aligned fast path where every pixel reads its own
  texel; the port selects the slab's own history rows there on the
  device, with no branch. On the flat domain there is no fast path, so a
  parked view needs the whole need set: utils/diagnostics.py counts it
  there, so the tuned capacity holds it and the poll names an overflow.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..math3d import apply_rows
from ..ops.compact import compact_indices, gather_rows, host_cond, scatter_back
from ..ops.sampling import dynamic_slice, sample_nearest_edge, to_i32
from .deferred import pixel_centers
from .shadow_filter import ShadowResult
from .uniforms import FrameUniforms


def init_history(height: int, width: int, device) -> torch.Tensor:
    """(1, 1) = lit, far (taa.py:26-27)."""
    return torch.ones((height, width, 2), dtype=torch.float32, device=device)


def apply_shadow_taa(cur: ShadowResult, world: torch.Tensor,
                     uni: FrameUniforms, history: torch.Tensor,
                     use_shadow_taa: bool, y0=0,
                     full_height: int | None = None,
                     frag: torch.Tensor | None = None,
                     full_width: int | None = None,
                     need_capacity: int | None = None,
                     committed: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """taa.py:30-193 for an (h, W) row slab at global row y0 (an int or a
    0-d device tensor; frag=None), or for any batch shape with explicit
    `frag` pixel centres (x + 0.5 convention) and the full framebuffer
    size. `history` is the full-frame buffer. Returns (out_shadow,
    new_history (..., 2)) shaped like cur.v."""
    current = cur.v
    if frag is None:
        h, w = current.shape
        fh = full_height if full_height is not None else h
        fw = w
        frag_x, frag_y = pixel_centers(h, w, y0, current.device)
    else:
        assert full_height is not None and full_width is not None
        fh, fw = full_height, full_width
        frag_x, frag_y = frag[..., 0], frag[..., 1]

    ones = torch.ones(world.shape[:-1] + (1,), dtype=torch.float32,
                      device=world.device)
    hom = torch.cat([world, ones], dim=-1)
    cur_clip = apply_rows(hom, uni.view_proj)
    cur_ndc_depth = torch.where(cur_clip[..., 3] != 0.0,
                                cur_clip[..., 2] / cur_clip[..., 3], 1.0)
    cur_ndc_depth = cur_ndc_depth.clamp(0.0, 1.0)

    if not use_shadow_taa:
        return current, torch.stack([current, cur_ndc_depth], dim=-1)

    current_uv = torch.stack(
        [(frag_x + 0.5) / fw, (frag_y + 0.5) / fh], dim=-1)

    prev_clip = apply_rows(hom, uni.prev_view_proj)
    w_ok = prev_clip[..., 3] > 0.0
    prev_ndc = prev_clip[..., :3] / torch.where(w_ok[..., None],
                                                prev_clip[..., 3:4], 1.0)
    prev_uv = prev_ndc[..., :2] * 0.5 + 0.5
    in_bounds = (w_ok
                 & (prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0)
                 & (prev_ndc[..., 2] >= 0.0) & (prev_ndc[..., 2] <= 1.0))

    motion = torch.linalg.vector_norm(prev_uv - current_uv, dim=-1)
    need = in_bounds & (motion <= 0.02)

    variance = torch.clamp(cur.m2 - cur.m1 * cur.m1, min=0.0)
    stdev = torch.sqrt(variance)
    softness = torch.clamp(cur.kernel_radius_texels / 8.0, 0.0, 1.0)
    sigma = 2.5 + (0.9 - 2.5) * softness
    lo = cur.m1 - sigma * stdev
    hi = cur.m1 + sigma * stdev
    history_weight = 0.55 + (0.85 - 0.55) * softness

    hist = None
    if need_capacity is not None:
        n = need.numel()
        cap = min(need_capacity, n)
        comp = compact_indices(need, cap)
        if committed or host_cond(comp.count <= cap, "taa_need",
                                  [(comp.count, cap)]):
            uv_rows = gather_rows(prev_uv.reshape(n, 2), comp)
            rows = sample_nearest_edge(history, uv_rows)
            ones2 = torch.ones((n, 2), dtype=torch.float32,
                               device=need.device)
            hist = scatter_back(ones2, comp, rows).reshape(need.shape + (2,))
        if committed and frag is None:
            # JAX's aligned fast path (taa.py:159-189): where every needed
            # pixel reprojects onto its own texel, the slab's own rows.
            ix = to_i32(torch.floor(prev_uv[..., 0] * fw)).clamp(0, fw - 1)
            iy = to_i32(torch.floor(prev_uv[..., 1] * fh)).clamp(0, fh - 1)
            aligned = ((ix == to_i32(frag_x - 0.5))
                       & (iy == to_i32(frag_y - 0.5)))
            all_aligned = (aligned | ~need).all()
            own = dynamic_slice(history, (y0, 0), (h, w))
            hist = torch.where(all_aligned, own, hist)
    if hist is None:
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
