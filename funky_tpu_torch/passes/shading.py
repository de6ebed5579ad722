"""Fragment shading (port of funky_tpu/passes/shading.py): the cube demo's
`shade_cube`, `shade_gltf` with dense or block-sparse texture sampling,
and the cascade debug view.
"""

from __future__ import annotations

import torch

from ..math3d import f32
from ..models.scene import FLAG_USE_TEXTURE
from ..ops.compact import (compact_blocks_any, gather_rows, host_cond,
                           scatter_back)
from ..ops.sampling import (quad_pack_nhwc,
                            sample_bilinear_repeat_packed_layers)
from .deferred import GBuffer

_FILL_DIR = (-0.5, 0.3, -0.8)


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def shade_cube(gbuf: GBuffer, camera_pos: torch.Tensor,
               light_dir: torch.Tensor,
               background: torch.Tensor) -> torch.Tensor:
    """cube.frag lighting (shading.py:35-64): ambient, key and fill
    diffuse, specular and a blue rim. Returns (H, W, 4) linear RGBA."""
    normal = _normalize(gbuf.normal)
    light = _normalize(light_dir)
    view = _normalize(camera_pos)

    n_dot_l = (normal * light).sum(dim=-1, keepdim=True)
    diff = torch.clamp(n_dot_l, min=0.0)

    fill_dir = _normalize(f32(_FILL_DIR, normal.device))
    fill_diff = torch.clamp((normal * fill_dir).sum(dim=-1, keepdim=True),
                            min=0.0) * 0.3

    half_dir = _normalize(light + view)
    spec = torch.pow(torch.clamp((normal * half_dir).sum(dim=-1,
                                                        keepdim=True),
                                 min=0.0), 64.0)

    rim = 1.0 - torch.clamp((normal * view).sum(dim=-1, keepdim=True),
                            min=0.0)
    rim = torch.pow(rim, 2.0) * 0.5

    color = gbuf.color
    result = (0.20 * color + 0.65 * diff * color + fill_diff * color
              + 0.4 * spec + rim * f32([0.8, 0.9, 1.0], normal.device))

    rgb = torch.where(gbuf.valid[..., None], result, background)
    alpha = torch.ones_like(rgb[..., :1])
    return torch.cat([rgb, alpha], dim=-1)


def shade_gltf(gbuf: GBuffer, texture: torch.Tensor,
               texture_sizes: torch.Tensor, camera_pos: torch.Tensor,
               light_dir: torch.Tensor, shadow: torch.Tensor,
               background: torch.Tensor,
               texture_block_capacity: int | None = None,
               committed: bool = False) -> torch.Tensor:
    """gltf.frag main lighting with the shadow term supplied
    (shading.py:67-157). Returns (..., 4) linear RGBA.

    texture_block_capacity: sample the texture only for the 8x8 screen
    blocks (64-runs on a flat domain) that hold textured pixels; overflow
    takes the dense sampling (one host branch), or with `committed` leaves
    the dropped blocks flat white, as in JAX. None = dense. The same
    sampler on the same inputs either way."""
    use_texture = (gbuf.flags & FLAG_USE_TEXTURE) != 0
    layer = gbuf.flags >> 8
    tex_packed = quad_pack_nhwc(texture)
    comp = None
    if texture_block_capacity is not None:
        comp = compact_blocks_any(use_texture, texture_block_capacity)
    if comp is not None and (committed or host_cond(
            comp.count <= texture_block_capacity, "texture_blocks",
            [(comp.count, texture_block_capacity)])):
        n = use_texture.numel()
        # the G-buffer's uv is a column slice: the row gather takes a
        # contiguous table ((n, 2) f32, one copy)
        uv_e = gather_rows(gbuf.uv.reshape(n, 2).contiguous(), comp)
        layer_e = gather_rows(layer.reshape(n), comp)
        vals = sample_bilinear_repeat_packed_layers(tex_packed, texture_sizes,
                                                    layer_e, uv_e)
        ones = torch.ones((n, 4), dtype=torch.float32, device=uv_e.device)
        tex = scatter_back(ones, comp, vals).reshape(
            use_texture.shape + (4,))
    else:
        tex = sample_bilinear_repeat_packed_layers(tex_packed, texture_sizes,
                                                   layer, gbuf.uv)
    tex = torch.where(use_texture[..., None], tex, 1.0)

    normal = _normalize(gbuf.normal)
    light = _normalize(light_dir)
    view = _normalize(camera_pos)

    n_dot_l = (normal * light).sum(dim=-1, keepdim=True)
    diff = torch.clamp(n_dot_l, min=0.0)

    fill_dir = _normalize(f32(_FILL_DIR, normal.device))
    fill_diff = torch.clamp((normal * fill_dir).sum(dim=-1, keepdim=True),
                            min=0.0) * 0.3

    half_dir = _normalize(light + view)
    spec = torch.pow(torch.clamp((normal * half_dir).sum(dim=-1,
                                                        keepdim=True),
                                 min=0.0), 32.0)

    base_color = tex[..., :3] * gbuf.color
    ambient = 0.25 * base_color
    diffuse = 0.65 * diff * base_color * shadow[..., None]
    fill = fill_diff * base_color
    spec_factor = torch.where(use_texture[..., None], 1.0, 0.0)
    specular = 0.3 * spec * spec_factor

    result = ambient + diffuse + fill + specular
    rgb = torch.where(gbuf.valid[..., None], result, background)
    alpha = torch.where(gbuf.valid[..., None], tex[..., 3:4], 1.0)
    return torch.cat([rgb, alpha], dim=-1)


def cascade_debug_color(gbuf: GBuffer, c0: torch.Tensor, c1: torch.Tensor,
                        ct: torch.Tensor, shadow: torch.Tensor,
                        background: torch.Tensor) -> torch.Tensor:
    """Cascade visualization (shading.py:160-179)."""
    colors = f32([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.4, 1.0],
                  [1.0, 1.0, 0.2]], shadow.device)

    def pick(idx):
        oh = (idx[..., None] == torch.arange(
            4, dtype=torch.int32, device=idx.device)).to(torch.float32)
        return oh @ colors

    base = pick(c0)
    blended = torch.where((ct > 0.0)[..., None],
                          base * (1.0 - ct[..., None])
                          + pick(c1) * ct[..., None],
                          base)
    rgb = blended * (0.35 + 0.65 * shadow[..., None])
    rgb = torch.where(gbuf.valid[..., None], rgb, background)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
