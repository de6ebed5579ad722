"""Capacity tuning from measured occupancy (port of
funky_tpu/utils/autotune.py): render a couple of frames, read the
occupancy diagnostics, and re-derive GltfConfig's capacities with
headroom. `autotune_config` keeps JAX's contract and swallows a failure,
leaving the defaults; `tune_raster_capacities` and
`tune_sparse_capacities` raise, so a caller that must not hide a failure
calls them directly.

Deliberate divergences from JAX (ROADMAP). Given the same GltfConfig the
port's frame equals JAX's; only the derived capacities and windows and
the poll differ:
- for a frame without light_space_ground_shadows, which builds no light
  maps, the entries the diagnostics count as light-map fetches are tap
  entries: derive_sparse_config adds them to the per-cascade tap caps
  (`shadow_pen_cascade_caps`), or to the radius-only and route caps for
  the ones those groups take, and sizes the tap windows from the extent
  that holds them. JAX leaves them out and undersizes the synth-only
  frame's caps. capacity_overflows counts each full tap group as the
  frame fills it: with those entries, and with the route candidates of a
  cascade whose route was not adopted, which JAX's poll also leaves out;
- `light_window_sizes` keeps every measured footprint window, with light
  maps too, and `light_fetch_caps` gives each window a cap. JAX drops the
  window of a cascade with fewer than 128 fetch entries, which only a
  light map reads; the synthesized maps use the same sizes, so a cascade
  whose occluders land on its map then loses them (the committed frame)
  or takes the full raster (the cond'd one);
- the occupancy itself is read in the regimes the frame runs in
  (utils/diagnostics.py): every pose parked and after its predecessor
  (chained motion over frame.tuning_poses), on the back half the derived
  config runs: tune_sparse_capacities sizes that back half from the
  poses' coverage first (diagnostics.measure_coverage), so that the band
  budget, the pairs of the band blocks a committed frame drops past it,
  and the TAA need are that back half's. JAX reads them on the back half
  of the config it is given.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import torch

from .profiling import DROP_COUNTERS

_ZERO4 = (0, 0, 0, 0)


def _round_up(value, quantum: int) -> int:
    return -(-int(value) // quantum) * quantum


def tune_raster_capacities(scene, params, cfg):
    """The near-clip capacity and the per-tile bin occupancy of the main
    and the four cascade rasters over the poses -> `clip_capacity` (the
    most triangles crossing the near plane with 1.25x headroom, rounded to
    64 and never below the configured one) and RasterConfig capacities
    with 1.5x headroom, rounded to 128 and at most the triangle count
    (autotune.py:31-77). The main raster is binned as the frame bins it,
    after the near-clip expansion at the tuned capacity; JAX bins the
    unclipped triangles and leaves the clip capacity as configured."""
    from ..frame import (NEAR, _main_raster_inputs, compute_frame_uniforms,
                         init_frame_state)
    from ..ops.binning import triangle_setup, triangle_setup_corners
    from ..ops.raster import bin_occupancy
    from ..ops.clipping import near_crossing
    from ..passes.geometry import build_shade_blocks, transform_vertices

    poses = params if isinstance(params, (list, tuple)) else [params]
    st0 = init_frame_state(cfg, poses[0].camera_pos.device)

    def views():
        for p in poses:
            uni = compute_frame_uniforms(p, st0, cfg)
            yield uni, transform_vertices(scene, uni.models, uni.view_proj)

    crossing_max = 0
    for _, (_, clip, _) in views():
        crossing = near_crossing(clip[scene.tri_indices.long()],
                                 scene.num_triangles, NEAR * 0.1)[2]
        crossing_max = max(crossing_max, int(crossing.sum()))
    clip_capacity = cfg.clip_capacity
    if clip_capacity > 0:
        clip_capacity = max(clip_capacity,
                            _round_up(crossing_max * 1.25, 64))
    main_max = sm_max = 0
    for uni, (world, clip, normals) in views():
        blocks = build_shade_blocks(scene, world, clip, normals)
        tri_clip, _, _, valid = _main_raster_inputs(scene, clip, blocks,
                                                    clip_capacity)
        del blocks
        main = bin_occupancy(
            triangle_setup_corners(tri_clip, cfg.width, cfg.height, valid),
            cfg.width, cfg.height, cfg.raster)["max"]
        del tri_clip, valid
        world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
        size = cfg.shadow_map_size
        sm = torch.stack([bin_occupancy(
            triangle_setup(world_h @ uni.light_view_proj[c].T,
                           scene.tri_indices, size, size,
                           scene.num_triangles),
            size, size, cfg.shadow_raster)["max"] for c in range(4)]).max()
        main_max = max(main_max, int(main))
        sm_max = max(sm_max, int(sm))

    def cap(max_count):
        if max_count <= 0:
            return None
        return min(_round_up(max_count * 1.5, 128),
                   scene.tri_indices.shape[0])

    return dataclasses.replace(
        cfg, clip_capacity=clip_capacity,
        raster=dataclasses.replace(cfg.raster, capacity=cap(main_max)),
        shadow_raster=dataclasses.replace(cfg.shadow_raster,
                                          capacity=cap(sm_max)))


def tune_sparse_capacities(scene, params, cfg, frames: int = 2):
    """Measured occupancy -> tightened sparse capacities
    (autotune.py:80-88), the counts read on the back half the derived
    config runs (module docstring). Returns (cfg, occupancy dict)."""
    from .diagnostics import measure_coverage, measure_sparse_occupancy

    on_back_half = dataclasses.replace(
        cfg, **_back_half(cfg, measure_coverage(scene, params, cfg)))
    occ = measure_sparse_occupancy(scene, params, on_back_half,
                                   frames=frames)
    return derive_sparse_config(cfg, occ), occ


def _fetch_taps(cfg, occ):
    """Per cascade: the fetch entries a frame without light maps taps
    (all, or none with light maps on), of them the ones that go to the
    radius-only and the routed groups, and the tap extent that holds
    them. An occupancy dict of JAX's, which lacks the port's keys, gives
    no fetch entries to the groups and JAX's extent."""
    extent = occ.get("tap_extent_per_cascade", _ZERO4)
    if cfg.flags.light_space_ground_shadows:
        return _ZERO4, _ZERO4, _ZERO4, extent
    return (occ.get("light_fetch_per_cascade", _ZERO4),
            occ.get("light_fetch_lit_per_cascade", _ZERO4),
            occ.get("light_fetch_route_per_cascade", _ZERO4),
            occ.get("need_extent_per_cascade", extent))


def derive_sparse_config(cfg, occ):
    """Occupancy counts -> tightened sparse capacities
    (autotune.py:91-231), with the fetch-entry fold described in the
    module docstring."""

    def cap1k(count, headroom=1.3):
        return max(_round_up(count * headroom, 1024), 1024)

    # Routed window groups: adopt a cascade's route when its candidate
    # window exists and enough entries route.
    route_counts = occ.get("pairs_route_per_cascade", _ZERO4)
    route_sizes_meas = occ.get("route_window_sizes")
    fetch, fetch_lit, fetch_route, tap_extent = _fetch_taps(cfg, occ)
    route_w = [0, 0, 0, 0]
    route_c = [0, 0, 0, 0]
    if route_sizes_meas:
        for c in range(4):
            if route_sizes_meas[c] and route_counts[c] >= 4096:
                route_w[c] = route_sizes_meas[c]
                route_c[c] = cap1k(route_counts[c] + fetch_route[c], 1.15)
    route_on = any(route_w)

    # Committed-mode tap windows, for cascades without an adopted route.
    tap_windows = None
    if cfg.flags.committed and "tap_extent_per_cascade" in occ:
        pad_max = math.ceil(4.0 * cfg.max_softness) + 2
        wins = []
        for c in range(4):
            ext = int(tap_extent[c])
            if ext <= 0 or route_w[c]:
                wins.append(0)
                continue
            need = _round_up(ext + 2 * pad_max + 6, 64)
            wins.append(need if need <= 384
                        and need < cfg.shadow_map_size // 2 else 0)
        tap_windows = tuple(wins) if any(wins) else None

    # Footprint windows: every measured window is kept, with or without
    # light maps, since the synthesized maps raster their occluders in the
    # same windows (module docstring); JAX drops a light-space window with
    # under 128 fetches.
    light_sizes = cfg.light_window_sizes
    light_caps = cfg.light_fetch_caps
    if "light_window_sizes" in occ:
        fetches = occ.get("light_fetch_per_cascade", _ZERO4)
        light_sizes = tuple(occ["light_window_sizes"])
        light_caps = tuple(cap1k(f, 1.25) if s else 0
                           for f, s in zip(fetches, light_sizes))

    # Radius-only groups: split only when enough entries qualify and
    # every cascade with route candidates adopted its route.
    lit_counts = occ.get("pairs_lit_per_cascade", _ZERO4)
    routes_consistent = all(
        route_w[c] or not route_counts[c] for c in range(4))
    lit_split = sum(lit_counts) >= 16384 and routes_consistent

    return dataclasses.replace(
        cfg,
        shadow_pen_capacity=cap1k(occ["pairs"], 1.25),
        shadow_pen_cascade_caps=tuple(
            cap1k(_full_group_count(occ, c, fetch, fetch_lit,
                                    fetch_route, lit_split, route_w[c]),
                  1.15) for c in range(4)),
        shadow_lit_cascade_caps=(tuple(
            cap1k(lc + fl, 1.15) if lc + fl else 0
            for lc, fl in zip(lit_counts, fetch_lit))
            if lit_split else None),
        shadow_route_windows=tuple(route_w) if route_on else None,
        shadow_route_caps=tuple(route_c) if route_on else None,
        light_window_sizes=light_sizes,
        light_fetch_caps=light_caps,
        shadow_tap_windows=tap_windows,
        contact_capacity=cap1k(occ["contact_stage2"], 1.15),
        contact_march_capacity=cap1k(occ["contact_march"], 1.15),
        contact_window=(
            _round_up(int(occ["contact_march_extent"] * 1.15) + 16, 64)
            if cfg.flags.committed
            and 0 < occ.get("contact_march_extent", 0)
            and _round_up(int(occ["contact_march_extent"] * 1.15) + 16,
                          64) <= 384
            else None),
        taa_need_capacity=(
            cap1k(occ["taa_need"], 1.3)
            if occ.get("taa_need")
            and cap1k(occ["taa_need"], 1.3) <= occ["pixels"] // 2
            else None),
        texture_block_capacity=_blocks128(occ["texture_blocks"]),
        shadow_pen_block_capacity=_blocks128(occ["pair_blocks"]),
        contact_block_capacity=_blocks128(occ["contact_blocks"]),
        **_back_half(cfg, occ))


def _blocks128(count, headroom=1.3) -> int:
    return max(_round_up(count * headroom, 128), 128)


def _back_half(cfg, occ) -> dict:
    """The back half's fields from the coverage counts: a row slab of the
    covered span with 10% and 8 rows of headroom where it holds at most
    twice the covered blocks' pixels, else the valid-block budget
    (autotune.py:143-147, 229-231)."""
    span_rows = _round_up(min(occ["valid_row_span"] * 1.1 + 8,
                              cfg.height), 8)
    block_cap = _blocks128(occ["valid_blocks"], 1.2)
    use_slab = span_rows < cfg.height and span_rows * cfg.width <= (
        2 * block_cap * 64)
    return dict(valid_slab_rows=span_rows if use_slab else 0,
                valid_block_capacity=0 if use_slab else block_cap)


def _full_group_count(occ, c, fetch, fetch_lit, fetch_route,
                      lit_split: bool, routed) -> int:
    """Entries of cascade c's full tap group in a frame: the measured full
    entries and the folded fetch entries, plus the radius-only ones
    without a lit split and the route candidates without an adopted
    route, less the fetch entries those groups take."""
    n = occ["pairs_per_cascade"][c] + fetch[c]
    if lit_split:
        n -= fetch_lit[c]
    else:
        n += occ.get("pairs_lit_per_cascade", _ZERO4)[c]
    if routed:
        n -= fetch_route[c]
    else:
        n += occ.get("pairs_route_per_cascade", _ZERO4)[c]
    return n


def capacity_overflows(cfg, occ) -> list:
    """Names of the capacities the measured occupancy exceeds: the
    conditions whose lax.cond takes the dense fallback, polled to catch a
    committed frame's overflow (autotune.py:234-316). The full tap groups
    are counted as derive_sparse_config sizes them (module docstring)."""
    over = []

    def chk(name, count, cap):
        if cap is not None and count > cap:
            over.append(name)

    fetch, fetch_lit, fetch_route, tap_extent = _fetch_taps(cfg, occ)
    route_caps = cfg.shadow_route_caps or _ZERO4
    chk("shadow_pen_capacity", occ["pairs"], cfg.shadow_pen_capacity)
    if cfg.shadow_pen_cascade_caps is not None:
        lit_split = (cfg.shadow_lit_cascade_caps is not None
                     and "pairs_lit_per_cascade" in occ)
        for c, cap in enumerate(cfg.shadow_pen_cascade_caps):
            chk(f"shadow_pen_cascade_caps[{c}]",
                _full_group_count(occ, c, fetch, fetch_lit, fetch_route,
                                  lit_split, route_caps[c]), cap)
    if cfg.shadow_lit_cascade_caps is not None \
            and "pairs_lit_per_cascade" in occ:
        for c, (n, cap) in enumerate(zip(occ["pairs_lit_per_cascade"],
                                         cfg.shadow_lit_cascade_caps)):
            n = n + fetch_lit[c]
            if cap:
                chk(f"shadow_lit_cascade_caps[{c}]", n, cap)
            elif n:
                over.append(f"shadow_lit_cascade_caps[{c}]")
    chk("shadow_pen_block_capacity", occ["pair_blocks"],
        cfg.shadow_pen_block_capacity)
    if cfg.shadow_route_caps is not None \
            and "pairs_route_per_cascade" in occ:
        for c, (n2, cap2) in enumerate(zip(occ["pairs_route_per_cascade"],
                                           cfg.shadow_route_caps)):
            if cap2:
                chk(f"shadow_route_caps[{c}]", n2 + fetch_route[c], cap2)
    if occ.get("synth_window_overflow", 0) > 0:
        over.append("synth_window_fit")
    chk("clip_capacity", occ.get("clip_crossing", 0), cfg.clip_capacity)
    # what the frames measured dropped on the device (utils/profiling.
    # DROP_COUNTERS): the bins have no other poll
    for name, n in zip(DROP_COUNTERS, occ.get("drops", ())):
        if n > 0 and name not in over:
            over.append(name)
    if (cfg.shadow_tap_windows is not None
            and "tap_extent_per_cascade" in occ):
        pad_max = math.ceil(4.0 * cfg.max_softness) + 2
        for c, wc in enumerate(cfg.shadow_tap_windows):
            if wc:
                chk(f"shadow_tap_windows[{c}]",
                    tap_extent[c] + 2 * pad_max + 2, wc)
    if cfg.light_fetch_caps is not None \
            and "light_fetch_per_cascade" in occ \
            and cfg.flags.light_space_ground_shadows:
        sizes = cfg.effective_light_windows() or _ZERO4
        for c, (n, cap) in enumerate(zip(occ["light_fetch_per_cascade"],
                                         cfg.light_fetch_caps)):
            if sizes[c]:
                chk(f"light_fetch_caps[{c}]", n, cap)
    if "band_blocks" in occ and "band_bcap" in occ:
        chk("band_block_capacity", occ["band_blocks"], occ["band_bcap"])
    chk("contact_capacity", occ["contact_stage2"], cfg.contact_capacity)
    chk("contact_march_capacity", occ["contact_march"],
        cfg.contact_march_capacity)
    chk("contact_block_capacity", occ["contact_blocks"],
        cfg.contact_block_capacity)
    if "contact_march_extent" in occ:
        chk("contact_window", occ["contact_march_extent"],
            cfg.contact_window)
    if "taa_need" in occ:
        chk("taa_need_capacity", occ["taa_need"], cfg.taa_need_capacity)
    chk("texture_block_capacity", occ["texture_blocks"],
        cfg.effective_texture_blocks)
    if cfg.valid_slab_rows:
        chk("valid_slab_rows", occ["valid_row_span"], cfg.valid_slab_rows)
    elif cfg.valid_block_capacity:
        chk("valid_block_capacity", occ["valid_blocks"],
            cfg.valid_block_capacity)
    return over


def capacity_slack(cfg, occ) -> list:
    """Names of the major capacities sized at least twice what
    re-deriving from `occ` gives (autotune.py:319-344)."""
    new = derive_sparse_config(cfg, occ)
    slack = []

    def chk(name, cur, derived):
        if cur is not None and derived is not None and cur >= 2 * derived:
            slack.append(name)

    chk("shadow_pen_capacity", cfg.shadow_pen_capacity,
        new.shadow_pen_capacity)
    if (cfg.shadow_pen_cascade_caps is not None
            and new.shadow_pen_cascade_caps is not None):
        for c, (cur, der) in enumerate(zip(cfg.shadow_pen_cascade_caps,
                                           new.shadow_pen_cascade_caps)):
            chk(f"shadow_pen_cascade_caps[{c}]", cur, der)
    chk("contact_capacity", cfg.contact_capacity, new.contact_capacity)
    chk("contact_march_capacity", cfg.contact_march_capacity,
        new.contact_march_capacity)
    return slack


def autotune_config(scene, params, cfg, frames: int = 2, verbose=False):
    """Raster bins, then the sparse and block capacities measured with the
    bin-tuned config (autotune.py:347-375) over the poses `params`
    (frame.tuning_poses reads chained motion too). As in JAX, a failure of
    either step leaves its capacities at their defaults."""
    try:
        cfg = tune_raster_capacities(scene, params, cfg)
        if verbose:
            print(f"# autotune: raster capacity {cfg.raster.capacity}, "
                  f"shadow {cfg.shadow_raster.capacity}", file=sys.stderr)
    except Exception as e:  # diagnostics must never break startup
        if verbose:
            print(f"# autotune raster failed ({e!r}); using defaults",
                  file=sys.stderr)
    try:
        cfg, occ = tune_sparse_capacities(scene, params, cfg, frames=frames)
        if verbose:
            print(f"# autotune: occupancy {occ} -> pen "
                  f"{cfg.shadow_pen_capacity}, contact "
                  f"{cfg.contact_capacity}/{cfg.contact_march_capacity}, "
                  f"slab rows {cfg.valid_slab_rows}, "
                  f"valid blocks {cfg.valid_block_capacity}, "
                  f"tap windows {cfg.shadow_tap_windows}",
                  file=sys.stderr)
    except Exception as e:
        if verbose:
            print(f"# autotune sparse failed ({e!r}); using defaults",
                  file=sys.stderr)
    return cfg
