"""The glTF frame (port of funky_tpu/frame.py::render_gltf_frame on the exact
dense path): shadow cascades -> main visibility pass -> deferred PCF/PCSS
shading -> shadow TAA -> contact shadows.

Frames are chained through `FrameState`, as in JAX. Configuration classes
keep the JAX package's fields and defaults; a flag or knob that this port
does not honour yet raises NotImplementedError naming it
(`check_supported`). In particular the defaults select the sparse paths,
so a port config sets `sparse_shadows=False, sparse_contact=False`,
`valid_block_capacity=0` and `texture_block_capacity=0`.

On a card every raster (four cascades + the main pass) runs the
hand-written kernel (ops/raster_cuda.py): five launches per frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import math3d as m3
from .models.scene import DeviceScene
from .ops.clipping import expand_near_clipped
from .ops.raster import RasterConfig, raster_corners
from .ops.sampling import quad_pack
from .passes import (contact, deferred, geometry, shading, shadow,
                     shadow_filter, taa, uniforms)

GLTF_CLEAR = (0.53, 0.81, 0.92)    # frame.py:29
NEAR, FAR = 0.1, 100.0


@dataclasses.dataclass(frozen=True)
class GltfFrameFlags:
    """Static pipeline switches (frame.py:147-231); same fields and
    defaults. See the JAX docstrings for what each one does."""
    use_pcss: bool = True
    use_shadow_taa: bool = True
    debug_cascades: bool = False
    enable_shadows: bool = True
    enable_contact_shadows: bool = True
    sparse_shadows: bool = True
    sparse_contact: bool = True
    half_res_shadows: bool = False
    shadow_eval_scale: int = 1
    light_space_ground_shadows: bool = False
    skip_backfacing_shadows: bool = False
    synth_shadow_maps: bool = False
    committed: bool = False

    @property
    def effective_shadow_scale(self) -> int:
        return max(self.shadow_eval_scale, 2 if self.half_res_shadows else 1)


@dataclasses.dataclass(frozen=True)
class GltfConfig:
    """Static frame configuration (frame.py:234-401); same fields and
    defaults. The sparse-path knobs are only read by paths that
    `check_supported` refuses."""
    width: int = 1920
    height: int = 1080
    shadow_map_size: int = uniforms.SHADOW_MAP_SIZE
    raster: RasterConfig = dataclasses.field(
        default_factory=lambda: RasterConfig(tile_h=32, tile_w=128))
    shadow_raster: RasterConfig = dataclasses.field(
        default_factory=lambda: RasterConfig(tile_h=128, tile_w=256))
    flags: GltfFrameFlags = dataclasses.field(default_factory=GltfFrameFlags)
    shadow_pen_capacity: int | None = None
    shadow_pen_cascade_caps: tuple | None = None
    shadow_lit_cascade_caps: tuple | None = None
    shadow_tap_windows: tuple | None = None
    shadow_pen_block_capacity: int | None = None
    contact_block_capacity: int | None = None
    shadow_route_windows: tuple | None = None
    shadow_route_caps: tuple | None = None
    contact_window: int | None = None
    taa_need_capacity: int | None = None
    max_softness: float = 4.0
    class_coarse: int = 16
    contact_capacity: int | None = None
    contact_march_capacity: int | None = None
    clip_capacity: int = 64
    texture_block_capacity: int | None = None
    valid_block_capacity: int | None = None
    light_window_sizes: tuple | None = None
    light_fetch_caps: tuple | None = None
    light_pcf_rungs: int = 6
    valid_slab_rows: int | None = None

    @property
    def effective_texture_blocks(self) -> int | None:
        if self.texture_block_capacity == 0:
            return None
        if self.texture_block_capacity is not None:
            return self.texture_block_capacity
        return max((self.height // 8) * (self.width // 8) // 4, 64)

    def effective_valid_blocks(self, h: int, w: int) -> int | None:
        if self.valid_block_capacity == 0:
            return None
        if h % 8 != 0 or w % 8 != 0:
            return None
        nb = (h // 8) * (w // 8)
        if self.valid_block_capacity is not None:
            return min(self.valid_block_capacity, nb)
        return min(max(-(-nb * 3 // 4 // 128) * 128, 128), nb)

    def effective_slab_rows(self, h: int) -> int | None:
        if not self.valid_slab_rows:
            return None
        rows = min(-(-self.valid_slab_rows // 8) * 8, h)
        return rows if rows < h else None

    @property
    def aspect(self) -> float:
        return self.width / self.height


def check_supported(cfg: GltfConfig) -> None:
    """Raise NotImplementedError naming every flag or knob of `cfg` that
    selects a path this port does not have yet."""
    f = cfg.flags
    names = [name for name, on in (
        ("flags.sparse_shadows", f.sparse_shadows),
        ("flags.sparse_contact", f.sparse_contact),
        ("flags.synth_shadow_maps", f.synth_shadow_maps),
        ("flags.committed", f.committed),
        ("flags.light_space_ground_shadows", f.light_space_ground_shadows),
        ("flags.skip_backfacing_shadows", f.skip_backfacing_shadows),
        ("flags.shadow_eval_scale > 1 (or half_res_shadows)",
         f.effective_shadow_scale > 1),
        ("valid_block_capacity (set 0)",
         cfg.effective_valid_blocks(cfg.height, cfg.width) is not None),
        ("texture_block_capacity (set 0)",
         cfg.effective_texture_blocks is not None),
        ("valid_slab_rows", cfg.effective_slab_rows(cfg.height) is not None),
        ("taa_need_capacity", cfg.taa_need_capacity is not None),
    ) if on]
    if names:
        raise NotImplementedError(
            "funky_tpu_torch runs the exact dense glTF frame only; not yet "
            "ported: " + ", ".join(names))


@dataclasses.dataclass(frozen=True)
class GltfParams:
    """Per-frame inputs (frame.py:404-414), f32 tensors on one device."""
    camera_pos: torch.Tensor     # (3,)
    camera_yaw: torch.Tensor     # ()
    camera_pitch: torch.Tensor
    camera_fov: torch.Tensor
    duck_position: torch.Tensor  # (3,)
    duck_scale: torch.Tensor
    shadow_softness: torch.Tensor

    def to(self, device) -> "GltfParams":
        return GltfParams(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def default_gltf_params(gltf_min_y: float = 0.0, gltf_scale: float = 0.01,
                        shadow_softness: float = 2.5,
                        device="cpu") -> GltfParams:
    """Reference defaults (frame.py:424-447): the yaw/pitch are derived
    from f32 vectors exactly as the JAX version derives them."""
    position = torch.tensor([0.0, 2.5, 10.0], dtype=torch.float32)
    target = torch.tensor([0.0, 0.6, 0.0], dtype=torch.float32)
    d = target - position
    dn = d / torch.linalg.vector_norm(d)
    yaw = math.atan2(float(dn[2]), float(dn[0]))
    pitch = math.asin(float(dn[1]))
    duck_y = -gltf_min_y * gltf_scale + 0.001
    return GltfParams(
        camera_pos=position,
        camera_yaw=m3.f32(yaw, "cpu"),
        camera_pitch=m3.f32(pitch, "cpu"),
        camera_fov=m3.f32(math.radians(45.0), "cpu"),
        duck_position=m3.f32([0.0, duck_y, 0.0], "cpu"),
        duck_scale=m3.f32(gltf_scale, "cpu"),
        shadow_softness=m3.f32(shadow_softness, "cpu"),
    ).to(device)


def orbit_params(params: GltfParams, i: int) -> GltfParams:
    """Pose i of bench.py's motion trajectory (bench.py:38-64, in numpy):
    the camera orbits the model at 0.02 rad/frame while the model slides."""
    a = 0.02 * i
    target = np.asarray([0.0, 0.6, 0.0], np.float32)
    rel = np.asarray([0.0, 2.5, 10.0], np.float32) - target
    rot = np.asarray([[math.cos(a), 0, math.sin(a)],
                      [0, 1, 0],
                      [-math.sin(a), 0, math.cos(a)]], np.float32)
    pos = target + rot @ rel
    d = target - pos
    dn = d / np.linalg.norm(d)
    dev = params.camera_pos.device
    slide = m3.f32([0.3 * math.sin(3 * a), 0.0,
                    0.3 * math.cos(3 * a) - 0.3], dev)
    return dataclasses.replace(
        params,
        camera_pos=m3.f32(pos, dev),
        camera_yaw=m3.f32(math.atan2(float(dn[2]), float(dn[0])), dev),
        camera_pitch=m3.f32(math.asin(float(dn[1])), dev),
        duck_position=params.duck_position + slide)


class FrameState(NamedTuple):
    """Carried temporal state (frame.py:450-458)."""
    shadow_history: torch.Tensor  # (H, W, 2): shadow, ndcDepth
    prev_depth: torch.Tensor      # (H, W)
    prev_view_proj: torch.Tensor  # (4, 4)
    has_prev: torch.Tensor        # () bool
    frame_index: torch.Tensor     # () int32


def init_frame_state(cfg: GltfConfig, device="cpu") -> FrameState:
    """frame.py:461-468."""
    return FrameState(
        shadow_history=taa.init_history(cfg.height, cfg.width, device),
        prev_depth=torch.ones((cfg.height, cfg.width), dtype=torch.float32,
                              device=device),
        prev_view_proj=torch.eye(4, dtype=torch.float32, device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
        frame_index=torch.zeros((), dtype=torch.int32, device=device),
    )


def compute_frame_uniforms(params: GltfParams, state: FrameState,
                           cfg: GltfConfig) -> uniforms.FrameUniforms:
    """frame.py:471-506 (the optimization barrier has no counterpart)."""
    flags = cfg.flags
    return uniforms.compute_uniforms(
        camera_pos=params.camera_pos,
        camera_yaw=params.camera_yaw,
        camera_pitch=params.camera_pitch,
        camera_fov=params.camera_fov,
        aspect_ratio=cfg.aspect,
        duck_position=params.duck_position,
        duck_scale=params.duck_scale,
        prev_view_proj=state.prev_view_proj,
        has_prev=state.has_prev,
        frame_index=state.frame_index,
        debug_cascades=flags.debug_cascades,
        use_pcss=flags.use_pcss,
        use_shadow_taa=flags.use_shadow_taa,
        shadow_softness=params.shadow_softness,
        shadow_map_size=cfg.shadow_map_size,
    )


def _main_raster_inputs(scene: DeviceScene, clip: torch.Tensor,
                        blocks: torch.Tensor, clip_capacity: int):
    """Near-clip expansion for the main pass (frame.py:47-65). Returns
    (tri_clip, blocks, tri_flags, valid)."""
    tri_clip = clip[scene.tri_indices.long()]
    if clip_capacity <= 0:
        valid = (torch.arange(scene.tri_indices.shape[0], device=clip.device)
                 < scene.num_triangles)
        return tri_clip, blocks, scene.tri_flags, valid
    g = expand_near_clipped(tri_clip, blocks, scene.tri_flags,
                            scene.num_triangles, capacity=clip_capacity,
                            w_eps=NEAR * 0.1)
    return g.tri_clip, g.blocks, g.tri_flags, g.valid


def _shade_slab_dense(scene: DeviceScene, uni, state: FrameState,
                      shadow_maps, tri_id, depth, setup_data, blocks,
                      cfg: GltfConfig, y0: int = 0, tri_flags=None):
    """Dense 2D back half for the row slab [y0, y0 + h)
    (frame.py:764-892 at shadow_eval_scale 1, no class maps). Returns
    (rgba (h, W, 4), history slab (h, W, 2))."""
    flags = cfg.flags
    if tri_flags is None:
        tri_flags = scene.tri_flags
    gbuf = deferred.interpolate(tri_id, depth, setup_data, blocks,
                                tri_flags, y0)

    normal = gbuf.normal / torch.clamp(
        torch.linalg.vector_norm(gbuf.normal, dim=-1, keepdim=True),
        min=1e-12)
    n_dot_l = torch.clamp((normal * uni.light_dir).sum(dim=-1), min=0.0)

    view_z = (gbuf.world @ uni.view[2, :3]) + uni.view[2, 3]
    view_depth = -view_z

    h, w = tri_id.shape
    frag = torch.stack(deferred.pixel_centers(h, w, y0, tri_id.device),
                       dim=-1)

    if flags.enable_shadows:
        sres, c0, c1, ct = shadow_filter.cascaded_shadow(
            uni, shadow_maps, gbuf.world, normal, n_dot_l, view_depth, frag,
            flags.use_pcss)
    else:
        one = torch.ones((h, w), dtype=torch.float32, device=tri_id.device)
        sres = shadow_filter.ShadowResult(one, one, one,
                                          torch.zeros_like(one))
        c0 = torch.zeros((h, w), dtype=torch.int32, device=tri_id.device)
        c1 = c0
        ct = torch.zeros_like(one)

    shadow_term, new_history = taa.apply_shadow_taa(
        sres, gbuf.world, uni, state.shadow_history, flags.use_shadow_taa,
        y0, cfg.height)

    if flags.enable_contact_shadows:
        contact_term = contact.compute_contact_shadow(
            gbuf.world, normal, uni, state.prev_depth, y0)
        shadow_term = torch.minimum(shadow_term, contact_term)

    # History only updates where fragments shaded (frame.py:873-879).
    old_slab = state.shadow_history[y0:y0 + h]
    new_history = torch.where(gbuf.valid[..., None], new_history, old_slab)

    background = torch.tensor(GLTF_CLEAR, dtype=torch.float32,
                              device=tri_id.device)
    if flags.debug_cascades:
        rgba = shading.cascade_debug_color(gbuf, c0, c1, ct, shadow_term,
                                           background)
    else:
        rgba = shading.shade_gltf(gbuf, scene.texture, scene.texture_sizes,
                                  uni.camera_pos, uni.light_dir,
                                  shadow_term, background)
    return rgba, new_history


def render_gltf_frame_ids(scene: DeviceScene, params: GltfParams,
                          state: FrameState, cfg: GltfConfig):
    """render_gltf_frame that also returns the main pass's visibility
    buffer: (rgba (H, W, 4), new FrameState, tri_id (H, W) int32). The
    main depth is the new state's prev_depth."""
    check_supported(cfg)
    flags = cfg.flags
    uni = compute_frame_uniforms(params, state, cfg)

    world_v, clip, normals_v = geometry.transform_vertices(
        scene, uni.models, uni.view_proj)
    blocks = geometry.build_shade_blocks(scene, world_v, clip, normals_v)

    shadow_maps = None
    if flags.enable_shadows:
        raw_maps = shadow.render_shadow_maps(
            world_v, scene.tri_indices, scene.num_triangles,
            uni.light_view_proj, cfg.shadow_raster, cfg.shadow_map_size)
        shadow_maps = quad_pack(raw_maps)              # (4, S, S, 4)

    tri_clip, blocks_m, tri_flags_m, tri_valid = _main_raster_inputs(
        scene, clip, blocks, cfg.clip_capacity)
    tri_id, depth, setup = raster_corners(
        tri_clip, tri_valid, cfg.width, cfg.height, cfg.raster)

    rgba, new_history = _shade_slab_dense(
        scene, uni, state, shadow_maps, tri_id, depth, setup.data, blocks_m,
        cfg, 0, tri_flags_m)

    new_state = FrameState(
        shadow_history=new_history,
        prev_depth=depth,
        prev_view_proj=uni.view_proj,
        has_prev=torch.ones((), dtype=torch.bool, device=depth.device),
        frame_index=state.frame_index + 1,
    )
    return rgba, new_state, tri_id


def render_gltf_frame(scene: DeviceScene, params: GltfParams,
                      state: FrameState, cfg: GltfConfig):
    """One full frame (frame.py:895-1027). Returns (linear RGBA (H, W, 4),
    new FrameState)."""
    rgba, new_state, _ = render_gltf_frame_ids(scene, params, state, cfg)
    return rgba, new_state
