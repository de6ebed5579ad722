"""Shadow cascade depth passes (port of funky_tpu/passes/shadow.py): the
full depth raster of each cascade (`render_shadow_maps`) and the
synthesized maps of GltfFrameFlags.synth_shadow_maps
(`synthesize_shadow_maps`): the ground evaluated as an affine plane in
light uv over the whole map, and the occluders rastered into a small
footprint window per cascade. Every raster goes through
ops/raster.py::raster_corners, so on a card each cascade's full raster or
occluder window is one raster-kernel launch.

The synthesized maps deviate from the full raster by about one ulp (plane
fit instead of edge-function interpolation, the ground quad's rim by the
texel-centre box test, the window raster through a cropped light matrix),
as documented at shadow.py:53-75.
"""

from __future__ import annotations

import torch

from ..math3d import f32
from ..ops.raster import RasterConfig, raster_corners, raster_scene
from ..ops.sampling import dynamic_slice, dynamic_update_slice, to_i32
from .shadow_classify import light_ground_planes
from .shadow_lightspace import GROUND_Y, occluder_uv_bbox
from .uniforms import SHADOW_MAP_SIZE

SHADOW_RASTER_CFG = RasterConfig(tile_h=128, tile_w=256, capacity=None)


def render_shadow_maps(world: torch.Tensor, tri_indices: torch.Tensor,
                       num_triangles: int, light_view_proj: torch.Tensor,
                       cfg: RasterConfig = SHADOW_RASTER_CFG,
                       size: int = SHADOW_MAP_SIZE, binning=None,
                       drops: str | None = None) -> torch.Tensor:
    """shadow.py:29-50. Returns (C, size, size) f32 NDC depth, 1.0 empty.
    `binning` and `drops`: the frame's span and drop counter of each
    cascade's raster (ops/raster.py::raster_corners)."""
    ones = torch.ones((world.shape[0], 1), dtype=torch.float32,
                      device=world.device)
    hom = torch.cat([world, ones], dim=-1)
    depths = []
    for c in range(light_view_proj.shape[0]):
        clip = hom @ light_view_proj[c].T
        _, depth, _ = raster_scene(clip, tri_indices, size, size,
                                   num_triangles, cfg, binning=binning,
                                   drops=drops)
        depths.append(depth)
    return torch.stack(depths)


def _crop_matrix(lvp: torch.Tensor, origin, wc: int, size: int):
    """The light matrix re-aimed at the (wc, wc) texel window at `origin`:
    window pixel centres land on full-map texel centres (shadow.py:
    78-91)."""
    oy, ox = origin
    sx = torch.full((), float(size), device=lvp.device) / wc
    kx = (float(size) - 2.0 * ox.to(torch.float32)) / wc - 1.0
    ky = (float(size) - 2.0 * oy.to(torch.float32)) / wc - 1.0
    return torch.stack([lvp[0] * sx + lvp[3] * kx, lvp[1] * sx + lvp[3] * ky,
                        lvp[2], lvp[3]])


def _texel_span(lo_uv, hi_uv, size: int):
    """The occluder bbox in texels with the raster's 1-texel margin."""
    return (to_i32(torch.floor(lo_uv * size)) - 1,
            to_i32(torch.ceil(hi_uv * size)) + 1)


def _window_fits(lo_uv, hi_uv, size: int, wc: int, origin):
    """One cascade's window-fit certificate (shadow.py:108-128): the
    on-map part of the occluder bbox lies inside the window, or the
    occluders are entirely off the map."""
    if wc:
        oy, ox = origin
        lo_t, hi_t = _texel_span(lo_uv, hi_uv, size)
        lo_t = torch.clamp(lo_t, min=0)
        hi_t = torch.clamp(hi_t, max=size)
        ok_c = ((torch.clamp(lo_t[0], max=size) >= ox)
                & (hi_t[0] <= ox + wc)
                & (torch.clamp(lo_t[1], max=size) >= oy)
                & (hi_t[1] <= oy + wc))
        return ok_c | (hi_t[0] <= lo_t[0]) | (hi_t[1] <= lo_t[1])
    lo_t = torch.floor(lo_uv * size) - 1.0
    hi_t = torch.ceil(hi_uv * size) + 1.0
    return ((hi_t[0] <= 0) | (lo_t[0] >= size)
            | (hi_t[1] <= 0) | (lo_t[1] >= size))


def synth_windows_fit(world_v: torch.Tensor, vert_object: torch.Tensor,
                      light_view_proj: torch.Tensor, size: int, sizes,
                      origins) -> torch.Tensor:
    """The window-fit certificate of synthesize_shadow_maps alone, no
    raster (shadow.py:94-129): the frame's fallback test and the
    occupancy poll's `synth_window_overflow`. Returns a 0-d bool."""
    lo_uv, hi_uv = occluder_uv_bbox(world_v, vert_object, light_view_proj)
    ok = torch.ones((), dtype=torch.bool, device=world_v.device)
    for c in range(light_view_proj.shape[0]):
        wc = min(sizes[c], size) if sizes[c] else 0
        ok = ok & _window_fits(lo_uv[c], hi_uv[c], size, wc, origins[c])
    return ok


def synthesize_shadow_maps(scene, world_v: torch.Tensor, uni, size: int,
                           sizes, origins,
                           win_cfg: RasterConfig | None = None,
                           binning=None):
    """Analytic-ground + windowed-occluder cascade maps (shadow.py:
    132-225). Returns ((L, size, size) maps, ok), `ok` the window-fit
    certificate. Occluders are every object but slot 0, the ground quad.
    Each cascade with a nonzero window size rasters its occluders once
    through raster_corners with `win_cfg` (128x128 tiles by default),
    its binning inside the frame's span `binning`."""
    if win_cfg is None:
        win_cfg = RasterConfig(tile_h=128, tile_w=128)
    dev = world_v.device
    lvp = uni.light_view_proj
    planes = light_ground_planes(lvp, GROUND_Y)

    # Ground-quad extent in world xz (the object-slot-0 vertices).
    gmask = (scene.vert_object == 0)[:, None]
    lo_w = torch.where(gmask, scene.positions, 1e30).amin(dim=0)
    hi_w = torch.where(gmask, scene.positions, -1e30).amax(dim=0)

    # world (x, z) -> uv is affine per cascade: fit from 3 projected
    # on-plane points and invert the 2x2 (inv_ex: no singularity check, so
    # no host synchronisation).
    hom3 = f32([[0.0, GROUND_Y, 0.0, 1.0], [1.0, GROUND_Y, 0.0, 1.0],
                [0.0, GROUND_Y, 1.0, 1.0]], dev)
    clip3 = torch.einsum("cij,nj->cni", lvp, hom3)
    uv3 = clip3[..., :2] / clip3[..., 3:4] * 0.5 + 0.5          # (L, 3, 2)
    uv_b = uv3[:, 0]
    fwd = torch.stack([uv3[:, 1] - uv_b, uv3[:, 2] - uv_b], dim=-1)
    inv = torch.linalg.inv_ex(fwd).inverse                        # (L, 2, 2)

    t = scene.tri_indices.shape[0]
    occl_valid = ((torch.arange(t, device=dev) < scene.num_triangles)
                  & (scene.tri_object != 0))
    homv = torch.cat([world_v, torch.ones((world_v.shape[0], 1),
                                          dtype=torch.float32, device=dev)],
                     dim=-1)
    lo_uv, hi_uv = occluder_uv_bbox(world_v, scene.vert_object, lvp)

    u_ax = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    uv_u = u_ax[None, :]
    uv_v = u_ax[:, None]
    maps = []
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for c in range(lvp.shape[0]):
        du = uv_u - uv_b[c, 0]
        dv = uv_v - uv_b[c, 1]
        x_w = inv[c, 0, 0] * du + inv[c, 0, 1] * dv
        z_w = inv[c, 1, 0] * du + inv[c, 1, 1] * dv
        inside = ((x_w >= lo_w[0]) & (x_w <= hi_w[0])
                  & (z_w >= lo_w[2]) & (z_w <= hi_w[2]))
        z = planes[c, 0] * uv_u + planes[c, 1] * uv_v + planes[c, 2]
        # LESS against the 1.0 clear: a fragment at z >= 1 never lands.
        base = torch.where(inside & (z < 1.0), z, 1.0)

        wc = min(sizes[c], size) if sizes[c] else 0
        if wc:
            oy, ox = origins[c]
            mat = _crop_matrix(lvp[c], (oy, ox), wc, size)
            tri_clip = (homv @ mat.T)[scene.tri_indices.long()]
            _, win_depth, _ = raster_corners(tri_clip, occl_valid, wc, wc,
                                             win_cfg, binning=binning)
            sl = dynamic_slice(base, (oy, ox), (wc, wc))
            base = dynamic_update_slice(base, torch.minimum(sl, win_depth),
                                        (oy, ox))
        ok = ok & _window_fits(lo_uv[c], hi_uv[c], size, wc, origins[c])
        maps.append(base)
    return torch.stack(maps), ok
