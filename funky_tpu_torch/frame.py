"""The frames (port of funky_tpu/frame.py): the rotating cube
(`render_cube_frame`), the glTF frame (`render_gltf_frame`: shadow
cascades -> main visibility pass -> deferred PCF/PCSS shading -> shadow
TAA -> contact shadows), and their cached entry points
`compiled_cube_frame` / `compiled_gltf_frame`, which on the card record a
frame without a host branch once as a CUDA graph and replay it.

Frames are chained through `FrameState`, as in JAX. Configuration classes
keep the JAX package's fields and defaults. `GltfConfig()` runs (the
sparse-exact shadow filter and contact march, block-sparse texture
sampling, the valid-block back half), and so does the configuration
bench.py ships: `GltfFrameFlags(committed=True, synth_shadow_maps=True)`
with the capacities of utils/autotune.py::autotune_config (synthesized
cascade maps, the row-slab back half, per-cascade, radius-only and routed
tap groups, tap and march windows, two-level compactions, the sparse TAA
read). So does every other flag combination of the JAX package: the
reduced-rate shadow evaluation (`shadow_eval_scale`, `half_res_shadows`),
the light-space ground evaluation (`light_space_ground_shadows`) and the
back-face skip (`skip_backfacing_shadows`).

Each of the JAX package's capacity-overflow `lax.cond`s becomes a host
branch on one device bool (ops/compact.py::host_cond, counted in
HOST_SYNCS). On overflow the branch takes the exact dense computation, as
in JAX, so the image does not depend on the capacities. A committed frame
takes no branch: it runs the tuned sparse paths unconditionally and slices
at device-valued offsets by index arithmetic, so it never waits on the
card. An overflow then gives JAX's bounded artifact, not a dense frame.

Entry points put their tensors on the card unless asked for the CPU
(`device="cpu"`). On a card every raster runs a hand-written kernel
(ops/raster.py picks K1 or K2 by table size): the four cascades and the
main pass, or, with synthesized maps, one occluder window per cascade
with a nonzero window size and the main pass.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import math3d as m3
from .models.scene import DeviceScene
from .ops.clipping import expand_near_clipped
from .ops.compact import (compact_valid_blocks, gather_blocks, host_cond,
                          scatter_blocks)
from .ops.raster import RasterConfig, raster_corners
from .ops.sampling import (dynamic_slice, dynamic_update_slice, quad_pack,
                           resize_linear)
from .passes import (contact, deferred, geometry, shading, shadow,
                     shadow_filter, shadow_lightspace, taa, uniforms)
from .passes.shadow_classify import build_class_maps, light_ground_planes
from .utils import profiling
from .utils.profiling import span

CUBE_CLEAR = (0.39, 0.58, 0.93)    # frame.py:28
GLTF_CLEAR = (0.53, 0.81, 0.92)    # frame.py:29
NEAR, FAR = 0.1, 100.0


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """The cube frame's static configuration (frame.py:33-44)."""
    width: int = 1920
    height: int = 1080
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    clip_capacity: int = 32

    @property
    def aspect(self) -> float:
        return self.width / self.height


@dataclasses.dataclass(frozen=True)
class CubeParams:
    """Per-frame inputs of the cube demo (frame.py:68-77), f32 tensors on
    one device; yaw and pitch follow cube.rs's convention."""
    rotation: torch.Tensor     # () radians
    position: torch.Tensor     # (3,)
    camera_pos: torch.Tensor   # (3,)
    yaw: torch.Tensor
    pitch: torch.Tensor
    fov: torch.Tensor
    scale: torch.Tensor

    def to(self, device) -> "CubeParams":
        return CubeParams(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def default_cube_params(rotation: float = 0.0, device="cuda") -> CubeParams:
    """frame.py:87-100: the camera at (0, 0, 3) looks down -Z at the
    origin (yaw = pi in cube.rs's convention), fov 45 degrees."""
    return CubeParams(
        rotation=m3.f32(rotation, "cpu"),
        position=m3.f32([0.0, 0.0, 0.0], "cpu"),
        camera_pos=m3.f32([0.0, 0.0, 3.0], "cpu"),
        yaw=m3.f32(3.14159265, "cpu"),
        pitch=m3.f32(0.0, "cpu"),
        fov=m3.f32(0.7853981634, "cpu"),
        scale=m3.f32(1.0, "cpu"),
    ).to(device)


def render_cube_frame(scene: DeviceScene, params: CubeParams,
                      cfg: FrameConfig) -> torch.Tensor:
    """The rotating-cube demo (frame.py:103-134): linear RGBA (H, W, 4).
    Its one raster takes K1 on the card (a 12-triangle table)."""
    dev = params.rotation.device
    model = (m3.mat4_from_translation(params.position)
             @ m3.mat4_from_rotation_y(params.rotation)
             @ m3.mat4_from_rotation_x(params.rotation * 0.5)
             @ m3.mat4_from_scale(params.scale))
    front = torch.stack([
        torch.sin(params.yaw) * torch.cos(params.pitch),
        torch.sin(params.pitch),
        torch.cos(params.yaw) * torch.cos(params.pitch),
    ])
    view = m3.look_at_rh(params.camera_pos, params.camera_pos + front,
                         m3.f32([0.0, 1.0, 0.0], dev))
    proj = m3.perspective_vk(params.fov, cfg.aspect, NEAR, FAR)
    view_proj = proj @ view

    world, clip, normals = geometry.transform_vertices(scene, model[None],
                                                       view_proj)
    blocks = geometry.build_shade_blocks(scene, world, clip, normals)
    tri_clip, blocks, tri_flags, tri_valid = _main_raster_inputs(
        scene, clip, blocks, cfg.clip_capacity)
    tri_id, depth, setup = raster_corners(tri_clip, tri_valid, cfg.width,
                                          cfg.height, cfg.raster)
    gbuf = deferred.interpolate(tri_id, depth, setup.data, blocks,
                                tri_flags)
    return shading.shade_cube(gbuf, params.camera_pos,
                              m3.f32([1.0, 1.0, 1.0], dev),
                              m3.f32(CUBE_CLEAR, dev))


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
    defaults."""
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

    def effective_light_windows(self) -> tuple | None:
        """Per-cascade footprint window sizes, or None when neither the
        synthesized maps nor the light-space ground evaluation is on
        (frame.py:380-389)."""
        if not ((self.flags.light_space_ground_shadows
                 or self.flags.synth_shadow_maps)
                and self.flags.sparse_shadows):
            return None
        sizes = (self.light_window_sizes if self.light_window_sizes
                 is not None else (512, 512, 512, 512))
        return tuple(min(s, self.shadow_map_size) for s in sizes)

    def effective_slab_rows(self, h: int) -> int | None:
        if not self.valid_slab_rows:
            return None
        rows = min(-(-self.valid_slab_rows // 8) * 8, h)
        return rows if rows < h else None

    @property
    def aspect(self) -> float:
        return self.width / self.height


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
                        device="cuda") -> GltfParams:
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


def bench_poses(params: GltfParams, n: int) -> list:
    """The poses bench.py autotunes over (bench.py:67-70): the parked view
    and orbit poses n // 3, 2n // 3 and n - 1."""
    return [params, orbit_params(params, n // 3),
            orbit_params(params, 2 * n // 3), orbit_params(params, n - 1)]


def motion_poses(params: GltfParams, n: int) -> list:
    """bench.py's motion run (bench.py:159-168): orbit_params(params, i)
    for i < n, chained in order."""
    return [orbit_params(params, i) for i in range(n)]


def tuning_poses(params: GltfParams, n: int = 24) -> list:
    """The poses the port's autotune reads: bench_poses, then the motion
    run of n poses in order, so that utils/diagnostics.
    measure_sparse_occupancy reads each motion pose against its
    predecessor's state, the regime of a chained motion frame."""
    return bench_poses(params, n) + motion_poses(params, n)


class FrameState(NamedTuple):
    """Carried temporal state (frame.py:450-458)."""
    shadow_history: torch.Tensor  # (H, W, 2): shadow, ndcDepth
    prev_depth: torch.Tensor      # (H, W)
    prev_view_proj: torch.Tensor  # (4, 4)
    has_prev: torch.Tensor        # () bool
    frame_index: torch.Tensor     # () int32


def init_frame_state(cfg: GltfConfig, device="cuda") -> FrameState:
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
                        blocks: torch.Tensor, clip_capacity: int,
                        drops: str | None = None):
    """Near-clip expansion for the main pass (frame.py:47-65). Returns
    (tri_clip, blocks, tri_flags, valid). `drops`: the counter the
    crossing triangles past the capacity add to (_drop_counters)."""
    tri_clip = clip[scene.tri_indices.long()]
    if clip_capacity <= 0:
        valid = (torch.arange(scene.tri_indices.shape[0], device=clip.device)
                 < scene.num_triangles)
        return tri_clip, blocks, scene.tri_flags, valid
    g = expand_near_clipped(tri_clip, blocks, scene.tri_flags,
                            scene.num_triangles, capacity=clip_capacity,
                            w_eps=NEAR * 0.1, drops=drops)
    return g.tri_clip, g.blocks, g.tri_flags, g.valid


def _drop_counters(scene: DeviceScene, cfg: GltfConfig) -> tuple:
    """The counters (utils/profiling.DROP_COUNTERS) that the frame's near
    clip, main raster bins and cascade raster bins add their drops to, each
    None where its capacity cannot drop anything on this scene: at most
    num_triangles triangles cross the near plane or fall in a cascade's
    bin, and num_triangles plus one per split triangle in a main-pass bin.
    A count that is 0 by construction is not made, so a frame whose
    capacities cover the scene runs no operation for it."""
    n = scene.num_triangles
    t = scene.tri_indices.shape[0]
    k = min(cfg.clip_capacity, t) if cfg.clip_capacity > 0 else 0

    def can_drop(name, capacity, most):
        return name if capacity < most else None

    return (can_drop("clip_capacity", k, n) if k else None,
            can_drop("raster.capacity",
                     cfg.raster.resolve_capacity(t + 2 * k), n + min(n, k)),
            can_drop("shadow_raster.capacity",
                     cfg.shadow_raster.resolve_capacity(t), n))


def _background(dev, alpha: bool = False) -> torch.Tensor:
    """The clear colour (with alpha 1) as an f32 tensor on `dev`."""
    rgb = GLTF_CLEAR + ((1.0,) if alpha else ())
    return m3.f32(rgb, dev)


def shade_slab(scene: DeviceScene, uni, state: FrameState, shadow_maps,
               tri_id, depth, setup_data, blocks, cfg: GltfConfig,
               y0=0, class_maps=None, tri_flags=None, light_maps=None,
               tap_routes=None):
    """Per-pixel back half for the row slab [y0, y0 + h) (frame.py:509-553):
    the row-slab back half when cfg sets one, else the valid-block back
    half when cfg's block budget applies to this shape and the shadow is
    evaluated at full rate, else the dense 2D one. Identical outputs while
    the capacities hold. Returns (rgba (h, W, 4), history slab (h, W, 2))."""
    if tri_flags is None:
        tri_flags = scene.tri_flags
    h, w = tri_id.shape
    args = (scene, uni, state, shadow_maps, tri_id, depth, setup_data,
            blocks, cfg, y0, class_maps, tri_flags)
    maps = (light_maps, tap_routes)
    kind, size, _ = back_half(cfg, h, w)
    with span("back_half"):
        if kind == "rows":
            return _shade_slab_rows(*args, size, *maps)
        if kind == "blocks":
            return _shade_slab_blocked(*args, size, *maps)
        return _shade_slab_dense(*args, *maps)


def back_half(cfg: GltfConfig, h: int, w: int) -> tuple:
    """(kind, size, n) of the back half shade_slab runs on an (h, w) slab:
    "rows" with the slab's row count, "blocks" with the block budget (a
    flat domain, on which TAA has no aligned fast path), or "dense"
    (size None); n is the element count of the domain the shadow filter
    classifies on, at the shadow rate. utils/diagnostics.py polls with
    the same domain."""
    scale = cfg.flags.effective_shadow_scale

    def at_rate(rows: int, cols: int) -> int:
        return -(-rows // scale) * -(-cols // scale)

    srows = cfg.effective_slab_rows(h)
    if srows is not None:
        return "rows", srows, at_rate(srows, w)
    bcap = cfg.effective_valid_blocks(h, w)
    if bcap is not None and scale == 1:
        return "blocks", bcap, bcap * 64
    return "dense", None, at_rate(h, w)


def _shade_core(scene: DeviceScene, uni, state: FrameState, shadow_maps,
                gbuf, frag, cfg: GltfConfig, class_maps, old_history,
                y0=None, light_maps=None, tap_routes=None):
    """The per-pixel back half on any domain shape (frame.py:556-638 and
    764-892): shadow filter -> TAA -> contact -> final shading. `frag`
    holds pixel centres (x + 0.5) in global framebuffer coordinates,
    `old_history` matches gbuf's shape + (2,). `y0` marks a 2D row slab
    starting at that global row (an int or a 0-d device tensor), for which
    TAA takes JAX's row-slab form. With shadow_eval_scale > 1 (2D domains
    only, frame.py:797-871) the shadow filter and the contact march run on
    every scale-th row and column, with their global pixel centres, and
    each result is upsampled back by `resize_linear`; the cascade ids, TAA
    and shading stay at full rate. Returns (rgba, new_history)."""
    flags = cfg.flags
    dev = gbuf.valid.device
    normal = gbuf.normal / torch.clamp(
        torch.linalg.vector_norm(gbuf.normal, dim=-1, keepdim=True),
        min=1e-12)
    n_dot_l = torch.clamp((normal * uni.light_dir).sum(dim=-1), min=0.0)

    view_z = m3.apply_rows(gbuf.world, uni.view[2:3, :3])[..., 0] \
        + uni.view[2, 3]
    view_depth = -view_z

    scale = flags.effective_shadow_scale
    shape = gbuf.valid.shape

    def at_rate(a):
        return a[::scale, ::scale].contiguous() if scale > 1 else a

    def up(a):
        return resize_linear(a, *shape) if scale > 1 else a

    with span("shadow_filter"):
        if flags.enable_shadows:
            args = (gbuf.world, normal, n_dot_l, view_depth, frag)
            if class_maps is not None:
                sres, c0, c1, ct = shadow_filter.cascaded_shadow_sparse(
                    uni, shadow_maps, class_maps,
                    *(at_rate(a) for a in args), flags.use_pcss,
                    at_rate(gbuf.valid), cfg.shadow_pen_capacity,
                    cfg.shadow_pen_cascade_caps,
                    cfg.shadow_pen_block_capacity, cfg.shadow_tap_windows,
                    light_maps, flags.skip_backfacing_shadows,
                    flags.committed, cfg.shadow_lit_cascade_caps,
                    tap_routes, cfg.shadow_route_caps)
            else:
                sres, c0, c1, ct = shadow_filter.cascaded_shadow(
                    uni, shadow_maps, *(at_rate(a) for a in args),
                    flags.use_pcss)
            if scale > 1:
                sres = shadow_filter.ShadowResult(*(up(f) for f in sres))
                c0, c1, ct = shadow_filter.select_cascade_blend(
                    view_depth, uni.cascade_splits)
        else:
            one = torch.ones(shape, dtype=torch.float32, device=dev)
            sres = shadow_filter.ShadowResult(one, one, one,
                                              torch.zeros_like(one))
            c0 = torch.zeros(shape, dtype=torch.int32, device=dev)
            c1 = c0
            ct = torch.zeros_like(one)

    taa_domain = (dict(y0=y0) if y0 is not None
                  else dict(frag=frag, full_width=cfg.width))
    with span("taa"):
        shadow_term, new_history = taa.apply_shadow_taa(
            sres, gbuf.world, uni, state.shadow_history,
            flags.use_shadow_taa, full_height=cfg.height,
            need_capacity=cfg.taa_need_capacity, committed=flags.committed,
            **taa_domain)

    with span("contact"):
        if flags.enable_contact_shadows:
            # A back-facing pixel shows no contact shadow either: the perf
            # mode skips its march (frame.py:601-604).
            cvalid = (gbuf.valid & (n_dot_l > 0.0)
                      if flags.skip_backfacing_shadows else gbuf.valid)
            if flags.sparse_contact:
                contact_term = contact.compute_contact_shadow_sparse(
                    at_rate(gbuf.world), at_rate(normal), uni,
                    state.prev_depth, capacity=cfg.contact_capacity,
                    march_capacity=cfg.contact_march_capacity,
                    valid=at_rate(cvalid),
                    block_capacity=cfg.contact_block_capacity,
                    frag=at_rate(frag),
                    plane=contact.reference_plane(
                        scene.positions, scene.tri_indices,
                        uni.prev_view_proj, cfg.width, cfg.height),
                    committed=flags.committed,
                    march_window=cfg.contact_window)
            else:
                contact_term = contact.compute_contact_shadow(
                    at_rate(gbuf.world), at_rate(normal), uni,
                    state.prev_depth, frag=at_rate(frag))
            shadow_term = torch.minimum(shadow_term, up(contact_term))

    with span("shading"):
        # History only updates where fragments shaded (frame.py:623-626).
        new_history = torch.where(gbuf.valid[..., None], new_history,
                                  old_history)

        background = _background(dev)
        if flags.debug_cascades:
            rgba = shading.cascade_debug_color(gbuf, c0, c1, ct,
                                               shadow_term, background)
        else:
            rgba = shading.shade_gltf(
                gbuf, scene.texture, scene.texture_sizes, uni.camera_pos,
                uni.light_dir, shadow_term, background,
                cfg.effective_texture_blocks, committed=flags.committed)
    return rgba, new_history


def slab_start(covered: torch.Tensor, cfg: GltfConfig, slab_h: int):
    """(y0, span) of the row slab on an (h, w) coverage mask, as 0-d
    device tensors: the first covered row rounded down to a multiple of 8
    (less 8 rows of margin with shadow_eval_scale > 1), clamped so that
    the slab fits, and the covered span from there. utils/diagnostics.py
    polls on the same slab."""
    h = covered.shape[0]
    row_any = covered.any(dim=1)
    any_valid = row_any.any()
    row_any = row_any.to(torch.uint8)
    y_lo = torch.argmax(row_any).to(torch.int32)
    y_hi = (h - torch.argmax(row_any.flip(0))).to(torch.int32)
    pad = 8 if cfg.flags.effective_shadow_scale > 1 else 0
    y0d = torch.clamp(torch.where(
        any_valid, (torch.clamp(y_lo - pad, min=0) // 8) * 8, 0), 0,
        h - slab_h)
    span = torch.where(any_valid, torch.clamp(y_hi + pad, max=h) - y0d, 0)
    return y0d, span


def _shade_slab_rows(scene: DeviceScene, uni, state: FrameState,
                     shadow_maps, tri_id, depth, setup_data, blocks,
                     cfg: GltfConfig, y0, class_maps, tri_flags,
                     slab_h: int, light_maps=None, tap_routes=None):
    """The row-slab back half (frame.py:641-699): the dense back half on
    the (slab_h, W) slab at the first covered row, rounded down to a
    multiple of 8; rows outside keep the clear colour and the carried
    history. With shadow_eval_scale > 1 the slab keeps 8 rows of margin
    around the covered band where it can, so that the upsample of covered
    rows has full support and equals the full-height path there. The slab
    start stays on the device. A covered span taller than the slab takes
    the full-height dense path (one host branch), or in committed mode
    leaves the rows past the slab unshaded, as in JAX."""
    h, w = tri_id.shape
    y0d, span = slab_start(tri_id >= 0, cfg, slab_h)
    maps = (light_maps, tap_routes)
    if not (cfg.flags.committed or host_cond(
            span <= slab_h, "valid_slab_rows", [(span, slab_h)])):
        return _shade_slab_dense(scene, uni, state, shadow_maps, tri_id,
                                 depth, setup_data, blocks, cfg, y0,
                                 class_maps, tri_flags, *maps)
    rgba_s, hist_s = _shade_slab_dense(
        scene, uni, state, shadow_maps,
        dynamic_slice(tri_id, (y0d,), (slab_h,)),
        dynamic_slice(depth, (y0d,), (slab_h,)), setup_data, blocks, cfg,
        y0 + y0d, class_maps, tri_flags, *maps)
    dev = tri_id.device
    rgba = dynamic_update_slice(_background(dev, alpha=True).expand(h, w, 4),
                                rgba_s, (y0d,))
    old = dynamic_slice(state.shadow_history, (y0,), (h,))
    return rgba, dynamic_update_slice(old, hist_s, (y0d,))


def _shade_slab_blocked(scene: DeviceScene, uni, state: FrameState,
                        shadow_maps, tri_id, depth, setup_data, blocks,
                        cfg: GltfConfig, y0, class_maps, tri_flags,
                        bcap: int, light_maps=None, tap_routes=None):
    """The valid-block back half (frame.py:702-761): compact the 8x8
    blocks with any coverage, run the whole back half on flat (bcap*64,)
    block-major arrays, scatter (rgba, history) back in one block write.
    More than `bcap` covered blocks takes the dense 2D path (one host
    branch), or in committed mode drops the excess blocks, as in JAX."""
    h, w = tri_id.shape
    bc = compact_valid_blocks(tri_id >= 0, 8, 8, bcap)
    if not (cfg.flags.committed or host_cond(
            bc.fits, "valid_blocks", [(bc.comp_b.count, bcap)])):
        return _shade_slab_dense(scene, uni, state, shadow_maps, tri_id,
                                 depth, setup_data, blocks, cfg, y0,
                                 class_maps, tri_flags, light_maps,
                                 tap_routes)
    old_slab = dynamic_slice(state.shadow_history, (y0,), (h,))
    # One block-row gather moves the raster outputs and the carried
    # history; the int32 ids ride as bitcast f32 lanes.
    payload = torch.cat([tri_id.view(torch.float32)[..., None],
                         depth[..., None], old_slab], dim=-1)   # (h, w, 4)
    rows = gather_blocks(payload, bc)                           # (bcap*64, 4)
    tri_e = rows[:, 0].contiguous().view(torch.int32)
    depth_e = rows[:, 1]
    old_hist_e = rows[:, 2:4]
    px, py, slot_valid = bc.pixel_xy()
    tri_e = torch.where(slot_valid, tri_e, -1)
    pxf = px.to(torch.float32) + 0.5
    pyf = py.to(torch.float32) + 0.5 + float(y0)
    frag = torch.stack([pxf, pyf], dim=-1)

    with span("deferred"):
        gbuf = deferred.interpolate_at(tri_e, depth_e, setup_data, blocks,
                                       tri_flags, pxf, pyf)
    rgba_e, hist_e = _shade_core(scene, uni, state, shadow_maps, gbuf,
                                 frag, cfg, class_maps, old_hist_e,
                                 light_maps=light_maps,
                                 tap_routes=tap_routes)

    background = _background(tri_id.device, alpha=True)
    base = torch.cat([background.expand(h, w, 4), old_slab], dim=-1)
    out = scatter_blocks(base, bc, torch.cat([rgba_e, hist_e], dim=-1))
    # the history is the next frame's gather table: a contiguous copy
    return out[..., 0:4], out[..., 4:6].contiguous()


def _shade_slab_dense(scene: DeviceScene, uni, state: FrameState,
                      shadow_maps, tri_id, depth, setup_data, blocks,
                      cfg: GltfConfig, y0=0, class_maps=None,
                      tri_flags=None, light_maps=None, tap_routes=None):
    """Dense 2D back half for the row slab [y0, y0 + h), y0 an int or a
    0-d device tensor (frame.py:764-892): the other back halves' overflow
    branch, the reduced-rate shadow mode and the parity reference.
    Returns (rgba (h, W, 4), history slab (h, W, 2))."""
    if tri_flags is None:
        tri_flags = scene.tri_flags
    with span("deferred"):
        gbuf = deferred.interpolate(tri_id, depth, setup_data, blocks,
                                    tri_flags, y0)
    h, w = tri_id.shape
    frag = torch.stack(deferred.pixel_centers(h, w, y0, tri_id.device),
                       dim=-1)
    return _shade_core(scene, uni, state, shadow_maps, gbuf, frag, cfg,
                       class_maps,
                       dynamic_slice(state.shadow_history, (y0,), (h,)),
                       y0, light_maps, tap_routes)


def _cascade_maps(scene: DeviceScene, uni, world_v, cfg: GltfConfig,
                  origins, drops: str | None = None):
    """The four raw cascade depth maps (frame.py:929-958): the full raster,
    or with synth_shadow_maps the synthesized maps on the footprint
    windows at `origins`. An occluder outgrowing its window takes the full
    raster (one host branch); committed mode keeps the synthesized maps,
    whose window-fit certificate the occupancy poll reads instead. Each
    raster's binning lies in the span `cascade_binning`; the full rasters
    add their dropped bin entries to `drops`."""
    if cfg.flags.synth_shadow_maps and origins is not None:
        maps, ok = shadow.synthesize_shadow_maps(
            scene, world_v, uni, cfg.shadow_map_size,
            cfg.effective_light_windows(), origins,
            RasterConfig(tile_h=128, tile_w=128,
                         backend=cfg.shadow_raster.backend),
            binning=span("cascade_binning"))
        if cfg.flags.committed or host_cond(ok, "synth_window_fit"):
            return maps
    return shadow.render_shadow_maps(
        world_v, scene.tri_indices, scene.num_triangles,
        uni.light_view_proj, cfg.shadow_raster, cfg.shadow_map_size,
        binning=span("cascade_binning"), drops=drops)


def _light_maps(raw_maps, uni, cfg: GltfConfig, origins):
    """(rows, origins, sizes, fetch caps) of the light-space ground
    evaluation (frame.py:973-988): one build_light_shadow_map per cascade
    with a window, from its raw depth."""
    sizes = cfg.effective_light_windows()
    _, n_off, gbias = shadow_lightspace.ground_constants(uni)
    planes = shadow_lightspace.biased_ground_planes(
        uni.light_view_proj, shadow_lightspace.GROUND_Y + n_off)
    # the tap geometry depends on the frame, not the window: built once
    taps = shadow_lightspace.light_map_taps(
        uni, cfg.flags.use_pcss, cfg.light_pcf_rungs,
        shadow_lightspace.PHASES, gbias.device) if any(sizes) else None
    rows = tuple(
        shadow_lightspace.build_light_shadow_map(
            raw_maps[c], origins[c], planes[c], uni, cfg.flags.use_pcss,
            sizes[c], cfg.max_softness, gbias, cfg.light_pcf_rungs,
            taps=taps)
        if sizes[c] else None for c in range(len(sizes)))
    return rows, origins, sizes, cfg.light_fetch_caps


def render_gltf_frame_ids(scene: DeviceScene, params: GltfParams,
                          state: FrameState, cfg: GltfConfig):
    """render_gltf_frame that also returns the main pass's visibility
    buffer: (rgba (H, W, 4), new FrameState, tri_id (H, W) int32). The
    main depth is the new state's prev_depth."""
    flags = cfg.flags
    with span("uniforms"):
        uni = compute_frame_uniforms(params, state, cfg)

    with span("vertices"):
        world_v, clip, normals_v = geometry.transform_vertices(
            scene, uni.models, uni.view_proj)
        blocks = geometry.build_shade_blocks(scene, world_v, clip,
                                             normals_v)

    clip_drops, main_drops, cascade_drops = _drop_counters(scene, cfg)
    shadow_maps = None
    class_maps = None
    light_maps = None
    tap_routes = None
    if flags.enable_shadows:
        # Footprint windows shared by the synthesized maps and the
        # light-space ground evaluation, planned once (frame.py:920-927).
        sizes = cfg.effective_light_windows()
        origins = None
        with span("window_plans"):
            if sizes is not None and any(sizes):
                origins, _ = shadow_lightspace.plan_windows(
                    uni, world_v, scene.vert_object, sizes,
                    cfg.shadow_map_size, cfg.max_softness, cfg.class_coarse)
        with span("cascade_maps"):
            raw_maps = _cascade_maps(scene, uni, world_v, cfg, origins,
                                     cascade_drops)
        with span("class_maps"):
            if flags.sparse_shadows:
                class_maps = build_class_maps(
                    raw_maps, cfg.class_coarse, cfg.max_softness,
                    light_ground_planes(uni.light_view_proj))
        with span("quad_pack"):
            shadow_maps = quad_pack(raw_maps)          # (4, S, S, 4)
        with span("light_maps"):
            if (flags.light_space_ground_shadows and class_maps is not None
                    and origins is not None):
                light_maps = _light_maps(raw_maps, uni, cfg, origins)
        routes = cfg.shadow_route_windows
        if flags.sparse_shadows and routes is not None and any(routes) \
                and cfg.shadow_route_caps is not None:
            # Routed tap groups on the footprint windows at the route
            # sizes (frame.py:990-1003).
            with span("window_plans"):
                r_origins, _ = shadow_lightspace.plan_windows(
                    uni, world_v, scene.vert_object, routes,
                    cfg.shadow_map_size, cfg.max_softness, cfg.class_coarse)
            tap_routes = (r_origins, tuple(routes))

    with span("main_raster"):
        tri_clip, blocks_m, tri_flags_m, tri_valid = _main_raster_inputs(
            scene, clip, blocks, cfg.clip_capacity, clip_drops)
        tri_id, depth, setup = raster_corners(
            tri_clip, tri_valid, cfg.width, cfg.height, cfg.raster,
            binning=span("main_binning"), drops=main_drops)

    rgba, new_history = shade_slab(
        scene, uni, state, shadow_maps, tri_id, depth, setup.data, blocks_m,
        cfg, 0, class_maps, tri_flags_m, light_maps, tap_routes)

    with span("state"):
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


# ---------------------------------------------------------------------------
# Compiled frames (frame.py:1030-1054). JAX jit-caches one program per
# static config. The port's counterpart is a CUDA graph: the frame is
# recorded once per (config, scene) and replayed, so the host enqueues one
# graph instead of thousands of small launches. A frame is recorded only
# where it has no host branch: the config alone decides, before any run.
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def _launch_counts() -> dict:
    from .ops import (binning_cuda, class_maps_cuda, contact_cuda,
                      gather_cuda, group_counts_cuda, lightmap_cuda,
                      pair_taps_cuda, quad_pack_cuda, raster_cuda)

    return {"binning": binning_cuda.LAUNCHES,
            "raster_table": raster_cuda.LAUNCHES,
            "raster_padded": raster_cuda.PADDED_LAUNCHES,
            "row_gather": gather_cuda.LAUNCHES,
            "light_map": lightmap_cuda.LAUNCHES,
            "pair_taps": pair_taps_cuda.LAUNCHES,
            "group_counts": group_counts_cuda.LAUNCHES,
            "contact_front": contact_cuda.FRONT_LAUNCHES,
            "contact_certify": contact_cuda.CERTIFY_LAUNCHES,
            "contact_march": contact_cuda.MARCH_LAUNCHES,
            "class_maps": class_maps_cuda.LAUNCHES,
            "quad_pack": quad_pack_cuda.LAUNCHES}


def _copy_in(dst: torch.Tensor, src) -> int:
    """One input into its static buffer: a host number is filled in on the
    card (no copy from host memory), a tensor copied unless it already is
    the buffer (the graph's own state, handed back). Returns the device
    operations enqueued (0 or 1)."""
    if not isinstance(src, torch.Tensor):
        dst.fill_(src)
    elif src is dst:
        return 0
    else:
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"graph input {tuple(src.shape)} {src.dtype} "
                             f"does not match the recorded "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)
    return 1


def _record(fn, static: list, donate, count=None):
    """The body GraphFrame records: fn on the static inputs, then the
    donated outputs copied into their inputs' buffers (the `handoff`
    span), under a capture table. Returns (outputs, GraphLayout)."""
    with profiling.capture_table(count) as table:
        outputs = tuple(fn(*static))
        with span("handoff"):
            for o, i in (donate or {}).items():
                static[i].copy_(outputs[o])
    return outputs, table.layout


class GraphFrame:
    """fn(*inputs) -> tuple of tensors, recorded as one CUDA graph on static
    copies of the first call's inputs and replayed on each call.

    Before the capture, fn runs once eagerly on a side stream, as torch's
    graph documentation asks: that builds and loads the kernels and
    uploads every host constant (math3d.kept_constants). Each call copies
    its inputs into the static buffers, replays, and returns the graph's
    own outputs, which the next replay overwrites. `donate` maps an output
    index to an input index: the graph copies that output into that
    input's buffer at its end, which is JAX's donation (frame.py:1053) made
    literal. A failed capture or replay raises. `launches` counts the
    kernel launches the capture recorded: the wrappers' counters do not
    move on replay. `layout` (utils/profiling.GraphLayout) places the
    frame's layer spans among the graph's device operations, and counts
    the operations a call enqueues around its replay; with a `key` it is
    published for profiling.graph_layout(key)."""

    def __init__(self, fn, inputs, donate=None, key=None):
        dev = next(x.device for x in inputs if isinstance(x, torch.Tensor))
        self.static = [x.detach().clone() if isinstance(x, torch.Tensor)
                       else torch.full((), x, dtype=torch.float32,
                                       device=dev) for x in inputs]
        self.replays = 0
        # True from the first input copy of a call until its replay is
        # enqueued: a failure in between leaves the donated state half
        # written (app/driver.py rebuilds it then).
        self.replaying = False
        self._constants: dict = {}
        with m3.kept_constants(self._constants):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.static)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            with torch.cuda.graph(self.graph):
                self.outputs, self.layout = _record(fn, self.static, donate)
            after = _launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        if key is not None:
            profiling.publish_layout(key, self.layout)

    def __call__(self, inputs) -> tuple:
        self.replaying = True
        copies = 0
        for dst, src in zip(self.static, inputs):
            copies += _copy_in(dst, src)
        self.graph.replay()
        self.replaying = False
        self.replays += 1
        self.layout.before = copies
        return self.outputs


class CompiledFrame:
    """A cached frame callable: eager on the CPU and for a config with a
    host branch, one GraphFrame per (scene, device) otherwise. `captures`
    holds them; `last` is the one the last call replayed (None after an
    eager call)."""

    def __init__(self, eager, graphable: bool, key=None):
        self.eager = eager
        self.graphable = graphable
        self.key = key
        self.captures: dict = {}
        self.last = None

    def uses_graph(self, device) -> bool:
        return self.graphable and torch.device(device).type == "cuda"

    def _graph(self, scene, dev, fn, inputs, donate=None) -> GraphFrame:
        key = (id(scene), str(dev))
        entry = self.captures.get(key)
        if entry is None or entry[0] is not scene:
            # the entry holds the scene, whose tensors the graph reads by
            # address, so an id is never reused while its graph lives
            entry = (scene, GraphFrame(fn, inputs, donate, self.key))
            self.captures[key] = entry
        self.last = entry[1]
        return entry[1]


class _CompiledCube(CompiledFrame):
    def __init__(self, cfg: FrameConfig):
        super().__init__(functools.partial(render_cube_frame, cfg=cfg), True)

    def __call__(self, scene: DeviceScene, params: CubeParams):
        dev = params.rotation.device
        if not self.uses_graph(dev):
            self.last = None
            return self.eager(scene, params)
        inputs = [getattr(params, f) for f in _CUBE_FIELDS]
        g = self._graph(scene, dev, lambda *xs: (self.eager(
            scene, CubeParams(*xs)),), inputs)
        (rgba,) = g(inputs)
        return rgba.clone()


class _CompiledGltf(CompiledFrame):
    """eager(scene, params, state) -> (rgba, new_state) as a CompiledFrame:
    render_gltf_frame here, the rank's frame of a row-sharded mesh in
    parallel/sharded_frame.py."""

    def __call__(self, scene: DeviceScene, params: GltfParams,
                 state: FrameState):
        dev = params.camera_pos.device
        if not self.uses_graph(dev):
            self.last = None
            return self.eager(scene, params, state)
        # The rgba is cloned, so a frame the caller keeps does not change
        # under the next replay.
        fn, inputs, donate = self.recordable(scene, params, state)
        g = self._graph(scene, dev, fn, inputs, donate)
        outs = g(inputs)
        g.layout.after = 1          # the clone below
        return outs[0].clone(), FrameState(*g.static[len(_PARAM_FIELDS):])

    def recordable(self, scene: DeviceScene, params: GltfParams,
                   state: FrameState):
        """(fn, inputs, donate) of the graph a call records: fn(*inputs)
        is the frame's (rgba, *new_state). The new state is written into
        the state's static buffers at the graph's end: the state is
        donated and updated in place, as JAX donates it (frame.py:1053).
        The FrameState a call returns is those buffers; the next call
        overwrites it."""
        n = len(_PARAM_FIELDS)
        inputs = [getattr(params, f) for f in _PARAM_FIELDS] + list(state)

        def frame(*xs):
            rgba, new = self.eager(scene, GltfParams(*xs[:n]),
                                   FrameState(*xs[n:]))
            return (rgba,) + tuple(new)

        return frame, inputs, {1 + k: n + k for k in range(len(state))}


_CUBE_FIELDS = tuple(f.name for f in dataclasses.fields(CubeParams))
_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(GltfParams))


def compiled_cube_frame(cfg: FrameConfig) -> CompiledFrame:
    """Cached (scene, params) -> rgba (frame.py:1038-1043). On the card
    the frame is a CUDA graph: it has no host branch."""
    key = ("cube", cfg)
    if key not in _CACHE:
        _CACHE[key] = _CompiledCube(cfg)
    return _CACHE[key]


def compiled_gltf_frame(cfg: GltfConfig) -> CompiledFrame:
    """Cached (scene, params, state) -> (rgba, new_state) (frame.py:
    1046-1054). On the card a committed config replays a CUDA graph with
    the state updated in place; any other config runs eagerly."""
    key = ("gltf", cfg)
    if key not in _CACHE:
        # A committed frame takes no host branch (host_cond) and reads no
        # device value on the host: it can be recorded whole. The cond'd
        # and default frames branch on the host 5-7 times per frame.
        # Its graph's layout is published under cfg (profiling.
        # graph_layout(cfg)).
        _CACHE[key] = _CompiledGltf(
            functools.partial(render_gltf_frame, cfg=cfg), cfg.flags.committed,
            key=cfg)
    return _CACHE[key]
