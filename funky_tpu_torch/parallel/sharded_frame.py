"""Multi-device frame sharded over framebuffer rows (port of
funky_tpu/parallel/sharded_frame.py:1-182).

The decomposition is JAX's (sharded_frame.py:1-18):
- scene buffers, per-frame params and temporal state are replicated on
  every rank;
- each rank rasterizes and shades its row slab of the framebuffer (H / n
  rows) and its row slab of every shadow cascade (S / n rows);
- the cascade slabs are gathered before filtering (any pixel may sample
  any texel); the finished rgba, history and depth slabs are gathered at
  the end, so the returned state is replicated for the next frame.

Every collective is `_gather_rows`, an all-gather along dim 0 over the
mesh's group: 4 per frame on the raster path, 3 with synthesized maps
(which are replicated math). The frame is the stage functions below with
the gathers between them, and each rank calls it SPMD-style. A host
branch that gates a collective (`synth_window_fit`, cond'd configs only)
reads replicated values, so every rank takes it the same way; the
capacity branches inside a rank's `shade_slab` gate no collective.

JAX returns the sharded frame jitted (:177-182). Here, on the card with
an NCCL group and a committed config (no host branch, no host read), the
rank's whole frame, all-gathers included, is recorded as one CUDA graph
per scene at its first call and replayed (frame.py's GraphFrame), the
state donated and updated in place; every rank captures and replays in
lockstep, since each replay issues the collectives. Every other case
runs the stages eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..frame import (FrameState, GltfConfig, _CompiledGltf, _light_maps,
                     _main_raster_inputs, compute_frame_uniforms, shade_slab)
from ..models.scene import DeviceScene
from ..ops.compact import host_cond
from ..ops.raster import RasterConfig, raster_corners, raster_scene
from ..ops.sampling import quad_pack
from ..passes import geometry, shadow, shadow_lightspace
from ..passes.shadow_classify import build_class_maps, light_ground_planes
from .mesh import ROWS_AXIS

class Front(NamedTuple):
    """The replicated front of a frame (sharded_frame.py:56-85)."""
    uni: object                    # passes/uniforms.FrameUniforms
    world_v: torch.Tensor          # (V, 3)
    clip: torch.Tensor             # (V, 4)
    blocks: torch.Tensor           # (T, 12) shade blocks
    origins: tuple | None          # footprint window origins per cascade


def slab_rows(cfg: GltfConfig, n: int) -> tuple:
    """(framebuffer rows, cascade rows) of one of n slabs; both must be
    whole raster tiles (sharded_frame.py:43-54)."""
    slab_h = cfg.height // n
    sm_slab = cfg.shadow_map_size // n
    if slab_h * n != cfg.height or slab_h % cfg.raster.tile_h:
        raise ValueError(
            f"height {cfg.height} must split into {n} tile-aligned slabs")
    if (sm_slab * n != cfg.shadow_map_size
            or sm_slab % cfg.shadow_raster.tile_h):
        raise ValueError("shadow map size must split into tile-aligned slabs")
    return slab_h, sm_slab


def replicated_front(scene: DeviceScene, params, state: FrameState,
                     cfg: GltfConfig) -> Front:
    """Uniforms, the vertex stage and the footprint windows (:56-85)."""
    uni = compute_frame_uniforms(params, state, cfg)
    world_v, clip, normals_v = geometry.transform_vertices(
        scene, uni.models, uni.view_proj)
    blocks = geometry.build_shade_blocks(scene, world_v, clip, normals_v)
    sizes = cfg.effective_light_windows()
    origins = None
    if cfg.flags.enable_shadows and sizes is not None and any(sizes):
        origins, _ = shadow_lightspace.plan_windows(
            uni, world_v, scene.vert_object, sizes, cfg.shadow_map_size,
            cfg.max_softness, cfg.class_coarse)
    return Front(uni, world_v, clip, blocks, origins)


def synthesizes(cfg: GltfConfig, front: Front) -> bool:
    """Whether the cascades are the replicated synthesized maps (no
    cascade gather) rather than gathered raster slabs (:93)."""
    return (cfg.flags.enable_shadows and cfg.flags.synth_shadow_maps
            and front.origins is not None)


def synth_cascades(scene: DeviceScene, front: Front,
                   cfg: GltfConfig) -> torch.Tensor:
    """The synthesized maps, or the replicated full raster when an occluder
    outgrows its window (:93-100): JAX's lax.cond, a host branch on `ok`,
    which is computed from replicated inputs, so every rank branches
    alike. Committed mode keeps the synthesized maps, as the single-device
    frame does (frame.py::_cascade_maps, JAX's frame.py:943-953): the
    occupancy poll's `synth_window_fit` reports an occluder that outgrows
    its window. Where the window fit holds, the committed and cond'd
    frames are equal (ROADMAP, deliberate divergences)."""
    maps, ok = shadow.synthesize_shadow_maps(
        scene, front.world_v, front.uni, cfg.shadow_map_size,
        cfg.effective_light_windows(), front.origins,
        RasterConfig(tile_h=128, tile_w=128,
                     backend=cfg.shadow_raster.backend))
    if cfg.flags.committed or host_cond(ok, "synth_window_fit"):
        return maps
    return shadow.render_shadow_maps(
        front.world_v, scene.tri_indices, scene.num_triangles,
        front.uni.light_view_proj, cfg.shadow_raster, cfg.shadow_map_size)


def cascade_slab(scene: DeviceScene, front: Front, cfg: GltfConfig, y0: int,
                 rows: int) -> torch.Tensor:
    """Rows [y0, y0 + rows) of every cascade's depth raster, (L, rows, S)
    (:101-115): one raster per cascade."""
    world_v = front.world_v
    ones = torch.ones((world_v.shape[0], 1), dtype=torch.float32,
                      device=world_v.device)
    hom = torch.cat([world_v, ones], dim=-1)
    lvp = front.uni.light_view_proj
    size = cfg.shadow_map_size
    return torch.stack([
        raster_scene(hom @ lvp[c].T, scene.tri_indices, size, size,
                     scene.num_triangles, cfg.shadow_raster, y0, rows)[1]
        for c in range(lvp.shape[0])])


def replicated_maps(front: Front, raw_maps: torch.Tensor,
                    cfg: GltfConfig) -> tuple:
    """(shadow_maps, class_maps, light_maps) from the full raw cascades
    (:119-145), computed whole on every rank."""
    flags = cfg.flags
    class_maps = (build_class_maps(
        raw_maps, cfg.class_coarse, cfg.max_softness,
        light_ground_planes(front.uni.light_view_proj))
        if flags.sparse_shadows else None)
    shadow_maps = quad_pack(raw_maps)
    light_maps = None
    if (flags.light_space_ground_shadows and class_maps is not None
            and front.origins is not None):
        light_maps = _light_maps(raw_maps, front.uni, cfg, front.origins)
    return shadow_maps, class_maps, light_maps


def frame_slab(scene: DeviceScene, state: FrameState, front: Front,
               maps: tuple, cfg: GltfConfig, y0: int, rows: int) -> tuple:
    """One rank's framebuffer slab [y0, y0 + rows) (:147-160): the
    replicated near-clip expansion, the slab's main raster and its back
    half. JAX passes no tap routes here, and neither does this. Returns
    (rgba (rows, W, 4), history (rows, W, 2), depth (rows, W))."""
    shadow_maps, class_maps, light_maps = maps
    tri_clip, blocks_m, tri_flags_m, tri_valid = _main_raster_inputs(
        scene, front.clip, front.blocks, cfg.clip_capacity)
    tri_id, depth, setup = raster_corners(
        tri_clip, tri_valid, cfg.width, cfg.height, cfg.raster, y0, rows)
    rgba, history = shade_slab(
        scene, front.uni, state, shadow_maps, tri_id, depth, setup.data,
        blocks_m, cfg, y0, class_maps=class_maps, tri_flags=tri_flags_m,
        light_maps=light_maps)
    return rgba, history, depth


def next_state(front: Front, state: FrameState, history: torch.Tensor,
               depth: torch.Tensor) -> FrameState:
    """The replicated state after the frame (:168-174)."""
    return FrameState(
        shadow_history=history,
        prev_depth=depth,
        prev_view_proj=front.uni.view_proj,
        has_prev=torch.ones((), dtype=torch.bool, device=depth.device),
        frame_index=state.frame_index + 1)


def join_cascade_slabs(slabs: torch.Tensor, n: int) -> torch.Tensor:
    """(n * L, S/n, S) rank-major cascade slabs -> (L, S, S) maps: the
    gather stacks ranks along dim 0, JAX's along the rows (:114-115)."""
    _, rows, size = slabs.shape
    return (slabs.view(n, -1, rows, size).transpose(0, 1)
            .reshape(-1, n * rows, size))


# Calls of _gather_rows in this process: the all-gathers the frames
# enqueued (entry.py's dry run prints them per frame). A CUDA graph's
# replay issues its recorded gathers without a call.
GATHERS = 0


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather along dim 0 over `group`, rank-major (JAX's tiled
    all_gather on axis 0): the frame's only collective."""
    global GATHERS
    GATHERS += 1
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def sharded_gltf_frame(mesh: DeviceMesh, cfg: GltfConfig):
    """fn(scene, params, state) -> (rgba, new_state) for this rank of a 1D
    rows mesh (sharded_frame.py:35-182). Every rank calls it with the same
    replicated inputs and gets the same replicated outputs. Requires
    cfg.height and cfg.shadow_map_size to split into tile-aligned slabs
    (ValueError otherwise).

    The config decides, before any run, how fn runs (module docstring): on
    the card with a committed config it is a CUDA graph, replayed, and
    the FrameState returned is the graph's own buffers (the next call
    overwrites them); a capture or a replay that fails raises. A graph
    captures NCCL collectives only, so a committed config on a "cuda"
    mesh over another backend raises ValueError. Otherwise the stages run
    eagerly."""
    n = mesh.size()
    group = mesh.get_group(ROWS_AXIS)
    rank = mesh.get_local_rank(ROWS_AXIS)
    slab_h, sm_slab = slab_rows(cfg, n)
    nccl = dist.get_backend(group) == "nccl"
    if cfg.flags.committed and mesh.device_type == "cuda" and not nccl:
        raise ValueError(
            f"a committed sharded frame on the card is recorded as a CUDA "
            f"graph, which needs an NCCL group, not "
            f"{dist.get_backend(group)}")

    def frame(scene: DeviceScene, params, state: FrameState):
        front = replicated_front(scene, params, state, cfg)
        maps = (None, None, None)
        if cfg.flags.enable_shadows:
            if synthesizes(cfg, front):
                raw_maps = synth_cascades(scene, front, cfg)
            else:
                raw_maps = join_cascade_slabs(_gather_rows(cascade_slab(
                    scene, front, cfg, rank * sm_slab, sm_slab), group), n)
            maps = replicated_maps(front, raw_maps, cfg)
        rgba, history, depth = frame_slab(scene, state, front, maps, cfg,
                                          rank * slab_h, slab_h)
        rgba = _gather_rows(rgba, group)
        history = _gather_rows(history, group)
        depth = _gather_rows(depth, group)
        return rgba, next_state(front, state, history, depth)

    return _CompiledGltf(frame, cfg.flags.committed and nccl)
