"""Occupancy diagnostics for the sparse-evaluation capacities (port of
funky_tpu/utils/diagnostics.py): the counts that size GltfConfig's
compaction capacities, measured on a representative scene and view, and
polled to detect an overflow of a committed frame.

Each function re-runs the front half of the frame with the same code the
frame runs (the full cascade raster, as in JAX, also for a synthesized-map
configuration). `sparse_occupancy` returns device tensors;
`measure_sparse_occupancy` renders frames, reads the counts on the host
and max-combines them over poses; `measure_coverage` reads only the main
pass's coverage, which sizes the back half; `probe_occupancy` is the
running frame's poll. Divergences from JAX, each so that the counts are
the ones the frame meets (ROADMAP, deliberate divergences):
- `synth_window_overflow` is the certificate of a tuned config's own
  window sizes, the ones its frames raster, where JAX re-derives the
  sizes from the poses measured;
- the blend band is classified on the domain the frame classifies on, its
  row slab or block budget (frame.py::back_half), with that domain's
  budget: `band_bcap` is the frame's, and the pixels of the band blocks
  a committed frame drops past it are counted as the pairs they become.
  JAX classifies on the full frame with the full frame's budget;
- `taa_need` is counted on the valid-block back half even where every
  pixel reads its own texel (that back half has no aligned fast path);
- measure_sparse_occupancy reads every pose against its own state (the
  view parked there) and against its predecessor's (chained motion, when
  the poses are a motion run: frame.tuning_poses). JAX reads only the
  TAA need, and only across its poses' jumps;
- probe_occupancy carries the view's candidate window sizes, so that a
  retune can widen a footprint window and keep an adopted route.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.sampling import to_i32
from .profiling import DROP_COUNTERS, drop_counts


def _main_pass(scene, uni, cfg):
    """The vertex stage and the main raster (frame.py's main pass).
    Returns (world_v, clip, blocks, tri_flags, tri_id, depth, setup)."""
    from ..frame import _main_raster_inputs
    from ..ops.raster import raster_corners
    from ..passes import geometry

    world_v, clip, normals_v = geometry.transform_vertices(
        scene, uni.models, uni.view_proj)
    blocks = geometry.build_shade_blocks(scene, world_v, clip, normals_v)
    tri_clip, blocks, tri_flags, tri_valid = _main_raster_inputs(
        scene, clip, blocks, cfg.clip_capacity)
    tri_id, depth, setup = raster_corners(
        tri_clip, tri_valid, cfg.width, cfg.height, cfg.raster)
    return world_v, clip, blocks, tri_flags, tri_id, depth, setup


def _frame_intermediates(scene, params, state, cfg):
    """The front half of render_gltf_frame up to the shade inputs
    (diagnostics.py:15-53). Returns (uni, cmaps, gbuf, normal, n_dot_l,
    view_depth, clip_crossing, world_v)."""
    from ..frame import NEAR, compute_frame_uniforms
    from ..ops.clipping import near_crossing
    from ..passes import deferred, shadow
    from ..passes.shadow_classify import (build_class_maps,
                                          light_ground_planes)

    uni = compute_frame_uniforms(params, state, cfg)
    (world_v, clip, blocks, tri_flags, tri_id, depth,
     setup) = _main_pass(scene, uni, cfg)
    raw = shadow.render_shadow_maps(
        world_v, scene.tri_indices, scene.num_triangles,
        uni.light_view_proj, cfg.shadow_raster, cfg.shadow_map_size)
    cmaps = build_class_maps(raw, cfg.class_coarse, cfg.max_softness,
                             light_ground_planes(uni.light_view_proj))
    g = deferred.interpolate(tri_id, depth, setup.data, blocks, tri_flags)
    # near-plane clip pressure against GltfConfig.clip_capacity
    clip_crossing = near_crossing(clip[scene.tri_indices.long()],
                                  scene.num_triangles,
                                  NEAR * 0.1)[2].sum(dtype=torch.int32)
    normal = g.normal / torch.clamp(
        torch.linalg.vector_norm(g.normal, dim=-1, keepdim=True), min=1e-12)
    n_dot_l = torch.clamp((normal * uni.light_dir).sum(dim=-1), min=0.0)
    view_depth = -((g.world @ uni.view[2, :3]) + uni.view[2, 3])
    return (uni, cmaps, g, normal, n_dot_l, view_depth, clip_crossing,
            world_v)


def footprint_extents(scene, params, state, cfg) -> torch.Tensor:
    """(L,) int32 per-cascade shadow-footprint extent in texels
    (diagnostics.py:56-69): sizes the footprint windows."""
    from ..frame import compute_frame_uniforms
    from ..passes.geometry import transform_vertices
    from ..passes.shadow_lightspace import occluder_uv_bbox

    uni = compute_frame_uniforms(params, state, cfg)
    world_v, _, _ = transform_vertices(scene, uni.models, uni.view_proj)
    lo, hi = occluder_uv_bbox(world_v, scene.vert_object,
                              uni.light_view_proj)
    ext = to_i32(torch.ceil((hi - lo) * cfg.shadow_map_size))
    return torch.maximum(ext[:, 0], ext[:, 1])


def _blocks_of(mask: torch.Tensor) -> torch.Tensor:
    """8x8 blocks (of the whole-block part) with any True element."""
    *lead, hh, ww = mask.shape
    m = mask[..., :hh // 8 * 8, :ww // 8 * 8]
    return m.reshape(*lead, hh // 8, 8, ww // 8, 8).any(dim=-1).any(
        dim=-2).sum(dtype=torch.int32)


def sparse_occupancy(scene, params, state, cfg, light_sizes=None,
                     route_sizes=None) -> dict:
    """Counts for sizing the sparse capacities on one (scene, view), as a
    dict of device tensors (diagnostics.py:72-247). `state` should carry a
    real prev_depth (render a frame first). light_sizes / route_sizes:
    static per-cascade footprint and route window sizes to split the pair
    counts against (route_sizes defaults to cfg.shadow_route_windows).
    The shadow and contact counts are taken on the subsampled grid with
    shadow_eval_scale > 1 and honour skip_backfacing_shadows, as the
    frame evaluates them (diagnostics.py:87, 128-147). The shadow
    classification runs on the domain the frame classifies on: its row
    slab (frame.py::slab_start), or the whole frame with the block
    budget's band budget (the flat block domain holds the covered 8x8
    blocks in the same order)."""
    from ..frame import back_half, slab_start
    from ..ops.sampling import dynamic_slice
    from ..passes import contact, shadow_filter
    from ..passes.shadow import synth_windows_fit
    from ..passes.shadow_lightspace import plan_windows

    (uni, cmaps, g, normal, n_dot_l, view_depth, clip_crossing,
     world_v) = _frame_intermediates(scene, params, state, cfg)
    h, w = g.depth.shape
    kind, size, domain = back_half(cfg, h, w)
    dev = g.depth.device
    frag_x, frag_y = (
        (torch.arange(w, dtype=torch.float32, device=dev)[None, :]
         + 0.5).expand(h, w),
        (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
         + 0.5).expand(h, w))
    frag = torch.stack([frag_x, frag_y], dim=-1)

    def windows(sizes):
        origins, _ = plan_windows(uni, world_v, scene.vert_object, sizes,
                                  cfg.shadow_map_size, cfg.max_softness,
                                  cfg.class_coarse)
        return origins, tuple(sizes)

    light_windows = (windows(light_sizes)
                     if light_sizes is not None and any(light_sizes)
                     else None)
    if route_sizes is None:
        route_sizes = cfg.shadow_route_windows
    route_windows = (windows(route_sizes)
                     if route_sizes is not None and any(route_sizes)
                     else None)

    scale = cfg.flags.effective_shadow_scale

    def sub(a):
        return a[::scale, ::scale].contiguous() if scale > 1 else a

    cls = sub
    if kind == "rows":
        y0, _ = slab_start(g.valid, cfg, size)

        def cls(a):
            return sub(dynamic_slice(a, (y0,), (size,)))

    skip = cfg.flags.skip_backfacing_shadows
    stats = shadow_filter.classify_stats(
        uni, cmaps, cls(g.world), cls(normal), cls(n_dot_l),
        cls(view_depth), cls(frag), cfg.flags.use_pcss, cls(g.valid),
        light_windows=light_windows, skip_backfacing=skip,
        committed=cfg.flags.committed, route_windows=route_windows,
        domain=domain)
    # The synth window-fit certificate of the windows the frame rasters:
    # a tuned config's own (JAX measures the re-derived ones, which hides
    # an occluder outgrowing the live windows), else the measured ones.
    # Inverted so that a max over poses keeps "some pose overflowed".
    synth = light_windows
    if cfg.light_window_sizes is not None:
        live = cfg.effective_light_windows()
        synth = windows(live) if live and any(live) else None
    if cfg.flags.synth_shadow_maps and synth is not None:
        fit = synth_windows_fit(world_v, scene.vert_object,
                                uni.light_view_proj, cfg.shadow_map_size,
                                synth[1], synth[0])
        stats["synth_window_overflow"] = 1 - fit.to(torch.int32)

    cvalid = g.valid & (n_dot_l > 0.0) if skip else g.valid
    stats.update(contact.contact_occupancy(
        sub(g.world), sub(normal), uni, state.prev_depth, valid=sub(cvalid),
        plane=contact.reference_plane(scene.positions, scene.tri_indices,
                                      uni.prev_view_proj, cfg.width,
                                      cfg.height)))

    # TAA history-read need: in-bounds pixels with reprojection motion
    # <= 0.02. On a row-form back half it is zero when every such pixel
    # reads its own texel (the frame's aligned fast path); the valid-block
    # back half has none, so there the need is always counted (JAX zeroes
    # it on any domain).
    ones = torch.ones(g.world.shape[:-1] + (1,), dtype=torch.float32,
                      device=dev)
    hom = torch.cat([g.world, ones], dim=-1)
    prev_clip = torch.einsum("ij,...j->...i", uni.prev_view_proj, hom)
    w_ok = prev_clip[..., 3] > 0.0
    prev_ndc = prev_clip[..., :3] / torch.where(w_ok[..., None],
                                                prev_clip[..., 3:4], 1.0)
    prev_uv = prev_ndc[..., :2] * 0.5 + 0.5
    tin = (w_ok
           & (prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
           & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0)
           & (prev_ndc[..., 2] >= 0.0) & (prev_ndc[..., 2] <= 1.0))
    cur_uv = (frag + 0.5) / torch.stack([frag_x.new_full((), float(w)),
                                         frag_x.new_full((), float(h))])
    motion = torch.linalg.vector_norm(prev_uv - cur_uv, dim=-1)
    need = tin & (motion <= 0.02) & g.valid
    ix = to_i32(torch.floor(prev_uv[..., 0] * w)).clamp(0, w - 1)
    iy = to_i32(torch.floor(prev_uv[..., 1] * h)).clamp(0, h - 1)
    aligned = (ix == to_i32(frag_x - 0.5)) & (iy == to_i32(frag_y - 0.5))
    all_aligned = (aligned | ~need).all() & (kind != "blocks")
    stats["taa_need"] = torch.where(all_aligned, 0,
                                    need.sum(dtype=torch.int32))

    stats["pair_blocks"] = _blocks_of(stats.pop("_needs"))
    stats["contact_blocks"] = _blocks_of(stats.pop("_stage2"))

    c0, _, t = shadow_filter.select_cascade_blend(sub(view_depth),
                                                  uni.cascade_splits)
    stats["blend_band"] = (sub(g.valid) & (t > 0.0)).sum(dtype=torch.int32)
    stats["clip_crossing"] = clip_crossing
    stats["texture_blocks"] = _blocks_of(g.valid & ((g.flags & 1) != 0))
    stats.update(_coverage(g.valid))

    # Per-screen-tile shadow-cell spans (64x128 tiles).
    uv, _, _, inb = shadow_filter._light_project(
        uni, c0, sub(g.world), sub(normal), sub(n_dot_l))
    sc = cfg.shadow_map_size // cfg.class_coarse
    cc = to_i32(uv * sc).clamp(0, sc - 1)
    th, tw = 64, 128
    h2, w2 = inb.shape

    def tiled(a):
        return a[:h2 // th * th, :w2 // tw * tw].reshape(
            h2 // th, th, w2 // tw, tw).permute(0, 2, 1, 3)

    tm = tiled(inb & sub(g.valid))
    spans = []
    for axis in (0, 1):
        ta = tiled(cc[..., axis])
        amin = torch.where(tm, ta, 1 << 30).amin(dim=(2, 3))
        amax = torch.where(tm, ta, -1).amax(dim=(2, 3))
        spans.append(torch.where(amax >= 0, amax - amin + 1, 0))
    span = spans[0] * spans[1]
    stats["tile_cell_span_max"] = span.max()
    stats["tile_cell_span_mean"] = span.sum() / torch.clamp(
        (span > 0).sum(), min=1)
    return stats


def _coverage(valid) -> dict:
    """The main pass's covered 8x8 blocks and covered row span, which size
    the back half (autotune.py::derive_sparse_config)."""
    row_any = valid.any(dim=1)
    h = valid.shape[0]
    return {"valid_blocks": _blocks_of(valid),
            "valid_row_span": torch.where(
                row_any.any(),
                h - torch.argmax(row_any.flip(0).to(torch.uint8))
                - torch.argmax(row_any.to(torch.uint8)), 0)}


def measure_coverage(scene, params, cfg) -> dict:
    """valid_blocks and valid_row_span of the main pass at each pose,
    max-combined as Python ints: the coverage does not depend on the
    carried state, so this needs the main raster alone. The autotune
    sizes the back half from it before it reads the sparse counts on that
    back half."""
    from ..frame import compute_frame_uniforms, init_frame_state

    poses = params if isinstance(params, (list, tuple)) else [params]
    st0 = init_frame_state(cfg, poses[0].camera_pos.device)

    def covered(p):
        uni = compute_frame_uniforms(p, st0, cfg)
        tri_id = _main_pass(scene, uni, cfg)[4]
        return {k: _host(v) for k, v in _coverage(tri_id >= 0).items()}

    return _max_combine(covered(p) for p in poses)


def _host(v):
    a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return int(a) if a.size == 1 else tuple(int(x) for x in a.ravel())


def candidate_windows(scene, poses, state, cfg) -> tuple:
    """(light_sizes, route_sizes) for the poses' largest footprint extents
    (diagnostics.py:272-298): the footprint window sizes
    (window_size_for_extent; None without footprint windows), and the
    route-window candidates, footprint plus tap reach and at most 384
    texels (None when no cascade has one), or the config's own route
    windows when it has them (the live config is polled)."""
    from ..passes.shadow_lightspace import window_pad, window_size_for_extent

    ext = np.max([np.asarray(footprint_extents(scene, p, state, cfg).cpu())
                  for p in poses], axis=0)
    light_sizes = None
    if cfg.effective_light_windows() is not None:
        pad = window_pad(cfg.max_softness, cfg.class_coarse)
        light_sizes = tuple(window_size_for_extent(int(e), pad)
                            for e in ext)
    if cfg.shadow_route_windows is not None:
        return light_sizes, cfg.shadow_route_windows
    pad_route = math.ceil(4.0 * cfg.max_softness) + 2 + 8
    cand = []
    for e in ext:
        need = -(-(int(e) + 2 * pad_route) // 64) * 64
        cand.append(need if 0 < int(e) and need <= 384
                    and need < cfg.shadow_map_size else 0)
    return light_sizes, (tuple(cand) if any(cand) else None)


def _max_combine(readings) -> dict:
    out = {}
    for cur in readings:
        for k, v in cur.items():
            if k not in out:
                out[k] = v
            elif isinstance(v, tuple):
                out[k] = tuple(max(a, b) for a, b in zip(out[k], v))
            else:
                out[k] = max(out[k], v)
    return out


def measure_sparse_occupancy(scene, params, cfg, frames: int = 2) -> dict:
    """Render `frames` frames of the first pose (so prev_depth is real),
    then measure sparse_occupancy per pose and max-combine the counts as
    Python ints (diagnostics.py:250-328). `params` may be a list of poses.
    With footprint windows on, their sizes come first from the footprint
    extents, so the measured split matches the windows the derived config
    uses; route-window candidates come from the same extents.

    Each pose is read against its own state (the view parked there: on
    the valid-block back half its TAA need is the whole need set) and,
    after the first, against the state its predecessor left, whose TAA
    need JAX reads too: for poses of a motion run (frame.tuning_poses)
    that is the chained motion frame, whose TAA need and contact counts
    follow the carried state, and between bench_poses a jump. `drops`
    holds the most that one frame dropped past each capacity of utils/
    profiling.DROP_COUNTERS, in that order, read from the device counters
    around every frame rendered here."""
    from ..frame import init_frame_state, render_gltf_frame

    poses = params if isinstance(params, (list, tuple)) else [params]
    dev = poses[0].camera_pos.device
    readings = []

    def frame(p, st):
        before = drop_counts(dev)
        _, st = render_gltf_frame(scene, p, st, cfg)
        after = drop_counts(dev)
        readings.append({"drops": tuple(after[k] - before[k]
                                        for k in DROP_COUNTERS)})
        return st

    state = init_frame_state(cfg, dev)
    for _ in range(frames):
        state = frame(poses[0], state)
    light_sizes, route_sizes = candidate_windows(scene, poses, state, cfg)

    def occupancy(p, st):
        return {k: _host(v) for k, v in sparse_occupancy(
            scene, p, st, cfg, light_sizes, route_sizes).items()}

    for i, p in enumerate(poses):
        if i:
            readings.append(occupancy(p, state))
            state = frame(p, state)
        readings.append(occupancy(p, state))
    out = _max_combine(readings)
    if light_sizes is not None:
        out["light_window_sizes"] = light_sizes
    if route_sizes is not None:
        out["route_window_sizes"] = route_sizes
    return out


def probe_occupancy(scene, params, state, cfg) -> dict:
    """One poll of a running frame, as Python ints (app/driver.py's
    runtime retune): this view against the state the frame carries, split
    against the config's own footprint windows, so capacity_overflows
    reads what the frame does. It also carries this view's candidate
    windows (candidate_windows), so that derive_sparse_config can re-size
    them: `light_window_sizes`, each at least the config's window (a
    retune widens a window an occluder outgrew and narrows none), and
    `route_window_sizes`, the config's adopted routes or the candidates."""
    light, route = candidate_windows(scene, [params], state, cfg)
    live = cfg.effective_light_windows()
    occ = {k: _host(v) for k, v in sparse_occupancy(
        scene, params, state, cfg, live, route).items()}
    if light is not None:
        occ["light_window_sizes"] = tuple(max(a, b)
                                          for a, b in zip(light, live))
    if route is not None:
        occ["route_window_sizes"] = route
    return occ
