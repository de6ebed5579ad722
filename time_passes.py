#!/usr/bin/env python3
"""Time the debug panel and its raster (K4), the light-space ground light
maps (K5), the shadow filter's tap sets (K6) and its pair histogram (K7),
the class maps (K10) and the contact stage (K8, K9) of the port
(funky_tpu_torch) on one NVIDIA GPU, in this checkout or another one:

    python3 time_passes.py [--tree PATH] [--skip-panel]

PATH (default: the directory of this script) is the root of a checkout;
its funky_tpu_torch and chip_smoke.py are imported, so two commits are
compared in one process each, on one card, e.g. in the order parent,
change, change, parent. Measures, at 1920x1080 with 4 x 2048^2 cascades
on chip_smoke.py's multimesh scene:

- `DebugPanel.render_over` of the debug window (the driver's default
  UiData) over a 1080p frame: host clock to a synchronize,
  RENDER_OVER_RUNS runs after one untimed; then K4 alone
  (ops/overlay_cuda.py::overlay_raster) on the tables of the debug
  window and of the toggled panel (every checkbox flipped, the error line
  shown): device ms behind a sleep (chip_smoke.device_ms, CUDA events),
  and, where the checkout's wrapper has a tile (overlay_cuda.TILE), the
  same at every tile of TILES, patched into the module (not with
  --skip-panel);
- the shipped configuration (bench.py's: committed, synthesized maps),
  autotuned over frame.tuning_poses(params, 24): 8 chained replays of its
  compiled_gltf_frame (2 parked, 6 orbit poses), host-clock and
  CUDA-event medians after the first, twice; then every K6 call
  (ops/pair_taps_cuda.py::pair_taps) of one eager frame at the last
  pose, recorded and replayed through the wrapper: device ms behind a
  sleep kernel (chip_smoke.device_ms, CUDA events), with each call's
  live count against its slots where the checkout's frame passes one,
  and, where the checkout's wrapper picks a lane width
  (pair_taps_cuda.lanes_for), the same at every width it takes; and the
  frame's K7 call (ops/group_counts_cuda.py::group_counts) through the
  wrapper, device ms behind a sleep, and, where the checkout's wrapper
  has a grid cap (group_counts_cuda.BLOCKS_PER_SM), the same at every
  cap of BLOCKS_PER_SM, patched into the module;
- the same eager frame's class-map build (frame.build_class_maps) and
  contact stage (contact.compute_contact_shadow_sparse), each recorded
  and replayed by device ms behind a sleep: K10 and K8 + K9 with the
  torch around them where the checkout has them (contact.contact_front),
  the jnp ports before; and there each kernel's dispatcher (K8
  contact_front, K9 contact_certify or, where the checkout's frame calls
  it, contact_certify_compact (the certificate with stage 3's
  compaction), and contact_march, K10 shadow_classify._class_rows) on
  its recorded calls alone; K10's calls also at coarse 16 and 8 at every
  tile of K10_TILES the checkout's block takes (tile_cells replaced); the
  march's with each call's live slots (the count, or the rays its mask
  keeps) and its bound and, where the checkout's march switches its layout by the live
  count (contact_cuda.LANES_LIVE_MAX), also in each layout for every
  live count (a thread a slot, 8 lanes a slot; the indexed calls also
  with their live count cut to each of LIVE_CUTS), the compacting
  certificate's at every grid cap of BLOCKS_PER_SM
  (CERTIFY_BLOCKS_PER_SM patched);
- the dense frame (every pixel filtered, chip_smoke.dense_config): its K6
  calls and its K9 march (every ray its mask keeps, in each layout as
  above) of one frame, timed as above, and, where the checkout picks a
  lane width, n = 2^14 .. 2^21 entries at every width, drawn from the
  dense frame's first call and from the shipped frame's largest pair
  group (its live entries, evenly spaced or repeated);
- the light-space configuration (the shipped flags with
  light_space_ground_shadows, skip_backfacing_shadows and
  synth_shadow_maps), autotuned the same way: 8 chained replays, twice,
  and 8 chained eager frames' K3 (row gather) launches;
- each light map of one eager light-space frame: the K5 launch alone
  (ops/lightmap_cuda.py::light_map on the recorded arguments) and the
  whole call (build_light_shadow_map: the window's parameters, then K5),
  each by device ms behind a sleep (CUDA events), and, where the
  checkout's wrapper picks a tile height (lightmap_cuda.tile_rows), K5
  alone at every height it takes;
- the same frame's whole light-map stage (frame._light_maps: the tap
  geometry and every window's map): the kernels it launches and their
  summed device time, from torch.profiler over three calls.

Prints the card's nvidia-smi line, then one JSON object. Needs a CUDA
card; imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import sys
import time

RENDER_OVER_RUNS = 8
SLEEP = 400_000_000     # cycles: longer than the host's enqueue of a frame's K6
# K4's tiles swept: (width, height, warp width) in pixels
TILES = ((16, 16, 16), (16, 16, 8), (32, 8, 32), (32, 8, 8), (16, 8, 16),
         (16, 8, 8), (8, 8, 8), (64, 4, 32))
# K7's grid caps swept: 256-thread blocks per SM
BLOCKS_PER_SM = (1, 2, 4, 8)
LIVE_CUTS = (1024, 4096, 16384, 32768, 65536)   # a cut march's live slots
# K10's tiles swept: cells a side
K10_TILES = (1, 2, 3, 4, 6, 8, 12, 16)


def record(module, name: str, fn):
    """Run fn() with module.name wrapped; return every call's (args,
    kwargs), the tensors held by reference."""
    calls, inner = [], getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        fn()
    finally:
        setattr(module, name, inner)
    return calls


@contextlib.contextmanager
def patched(module, name: str, value):
    """module.name set to `value` inside the block."""
    inner = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, inner)


def forced(module, name: str, value):
    """module.name replaced by a function that returns `value`."""
    return patched(module, name, lambda *_: value)


def k4_report(cs, dev) -> dict:
    """K4 alone on the debug window's table and the toggled panel's:
    device ms, at the checkout's tile and, where it has one, at each of
    TILES."""
    import torch

    from funky_tpu_torch.app import ui
    from funky_tpu_torch.ops import overlay_cuda
    from funky_tpu_torch.passes import overlay

    hw = (ui.PANEL_H, ui.PANEL_W)
    atlas = torch.from_numpy(ui.build_font_atlas()[0]).to(dev)
    toggled = ui.UiData(fps=59.9, frame_time_ms=16.7, gltf_scale=0.0123,
                        debug_cascades=True, use_pcss=False,
                        use_shadow_taa=False, entity_count=3,
                        component_count=7, gpu_info="NVIDIA H100",
                        last_error="frame 3: boom")
    out = {}
    for name, data in (("debug_window", ui.UiData()), ("toggled", toggled)):
        arrays = ui.build_panel(data).arrays()
        table = torch.from_numpy(overlay.overlay_table(
            *arrays[:4], int(arrays[4]), hw)).to(dev)

        def run():
            overlay_cuda.overlay_raster(table, atlas, hw)

        row = {"rows": table.shape[0], "ms": cs.device_ms(run, iters=50)}
        if hasattr(overlay_cuda, "TILE"):
            row["tile"] = list(overlay_cuda.TILE)
            row["tile_ms"] = {}
            for tile in TILES:
                with patched(overlay_cuda, "TILE", tile):
                    row["tile_ms"]["x".join(map(str, tile))] = cs.device_ms(
                        run, iters=50)
        out[name] = row
    return out


def k7_report(cs, calls) -> dict:
    """The frame's K7 call through the wrapper: device ms, at the
    checkout's grid cap and, where it has one, at each of BLOCKS_PER_SM."""
    from funky_tpu_torch.ops import group_counts_cuda

    (args, kw), = calls

    def run():
        group_counts_cuda.group_counts(*args, **kw)

    out = {"entries": args[0].numel(), "n_groups": args[2],
           "needed": int(args[0].sum()), "ms": cs.device_ms(run, iters=50)}
    if hasattr(group_counts_cuda, "BLOCKS_PER_SM"):
        out["blocks_per_sm"] = group_counts_cuda.BLOCKS_PER_SM
        out["blocks_ms"] = {}
        for b in BLOCKS_PER_SM:
            with patched(group_counts_cuda, "BLOCKS_PER_SM", b):
                out["blocks_ms"][b] = cs.device_ms(run, iters=50)
    return out


def time_taps(cs, calls) -> float:
    """Device ms of the recorded K6 calls replayed through the wrapper."""
    from funky_tpu_torch.ops import pair_taps_cuda

    def run():
        for a, kw in calls:
            pair_taps_cuda.pair_taps(*a, **kw)

    return cs.device_ms(run, iters=10, sleep_cycles=SLEEP)


def taps_report(cs, calls) -> dict:
    """K6 calls of one frame: their slots, live counts (the `count`
    argument, where passed), device ms, and per lane width where taken."""
    from funky_tpu_torch.ops import pair_taps_cuda

    out = {"calls": len(calls), "slots": [], "live": [],
           "ms": time_taps(cs, calls)}
    for a, kw in calls:
        slots = a[2].numel() // 2
        count = kw.get("count", a[9] if len(a) > 9 else None)
        out["slots"].append(slots)
        out["live"].append(slots if count is None
                           else min(int(count), slots))
    if hasattr(pair_taps_cuda, "lanes_for"):
        out["lanes_ms"] = {}
        for n in pair_taps_cuda.LANES:
            with forced(pair_taps_cuda, "lanes_for", n):
                out["lanes_ms"][n] = time_taps(cs, calls)
    return out


def lanes_by_entries(cs, call, live: int) -> dict:
    """K6 at every lane width on n entries taken from one recorded call,
    n from 2^14 to 2^21: its first `live` entries evenly spaced (n below
    live) or repeated (n above), so each size keeps the call's mix of
    work. Shows where one width overtakes the other."""
    import torch

    from funky_tpu_torch.ops import pair_taps_cuda

    args, kw = call
    args, kw = list(args), dict(kw)
    if len(args) > 9:
        args[9] = None
    kw.pop("count", None)
    flat = [None if t is None else t.reshape((-1,) + t.shape[len(
        args[3].shape):]) for t in args[1:5]]
    out = {}
    for k in range(14, 22):
        n = 1 << k
        idx = (torch.linspace(0, live - 1, n, device=flat[2].device).long()
               if n < live else
               torch.arange(n, device=flat[2].device) % live)
        part = [None if t is None else t[idx] for t in flat]
        out[n] = {}
        for w in pair_taps_cuda.LANES:
            with forced(pair_taps_cuda, "lanes_for", w):
                out[n][w] = time_taps(cs, [(args[:1] + part + args[5:], kw)])
    return out


def k10_report(cs, calls) -> dict:
    """K10's recorded calls of one frame at coarse 16 (as the frame makes
    them) and 8 (on the same maps): device ms behind a sleep at the
    wrapper's tile and at every tile of K10_TILES whose block the
    checkout's kernel takes (forced by replacing tile_cells)."""
    from funky_tpu_torch.ops import class_maps_cuda as k10
    from funky_tpu_torch.passes import shadow_classify

    out = {}
    for coarse in (16, 8):
        runs = []
        for a, kw in calls:
            a = list(a)
            a[1] = coarse
            runs.append((a, kw))

        def run(runs=runs):
            for a, kw in runs:
                shadow_classify._class_rows(*a, **kw)

        maps, soft = runs[0][0][0], runs[0][0][2]
        s = maps.shape[1]
        pooled = k10.pooled_branch(s, coarse)
        rise = k10.rise_reach(s, coarse, shadow_classify.rise_window(soft))
        row = {"tile": k10.tile_cells(s, coarse, pooled, rise),
               "wrapper_ms": cs.device_ms(run, iters=20)}
        for tc in K10_TILES:
            if (tc > s // coarse
                    or k10.smem_bytes(coarse, pooled, rise, tc)
                    > k10.MAX_SMEM):
                continue
            with forced(k10, "tile_cells", tc):
                row[f"tile_{tc}_ms"] = cs.device_ms(run, iters=20)
        out[f"coarse_{coarse}"] = row
    return out


def stages_report(cs, one_frame, cfg) -> dict:
    """The class-map build and the contact stage of one eager frame of
    `cfg`, and each K8-K10 dispatcher's calls where the checkout has
    them: device ms behind a sleep (the jnp ports' thousands of launches
    fit in it)."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.passes import contact, shadow_classify

    def timed(calls, fn):
        def run():
            for a, kw in calls:
                fn(*a, **kw)
        return cs.device_ms(run, iters=5, sleep_cycles=SLEEP)

    out = {}
    for key, module, name in (
            ("class_maps_stage", frame, "build_class_maps"),
            ("contact_stage", contact, "compute_contact_shadow_sparse")):
        calls = one_frame(cfg, module, name)
        out[key] = {"calls": len(calls),
                    "ms": timed(calls, getattr(module, name))}
    for key, module, name in (
            ("K8 contact_front", contact, "contact_front"),
            ("K9 contact_certify", contact, "contact_certify"),
            ("K9 contact_certify_compact", contact,
             "contact_certify_compact"),
            ("K9 contact_march", contact, "contact_march"),
            ("K10 class_maps", shadow_classify, "_class_rows")):
        if hasattr(module, name):
            calls = one_frame(cfg, module, name)
            if not calls:   # the frame calls the other mode
                continue
            out[key] = {"calls": len(calls),
                        "ms": timed(calls, getattr(module, name))}
            if name == "_class_rows":
                out["k10_tiles"] = k10_report(cs, calls)
            if name == "contact_march":
                out["k9_march_lanes"] = march_lanes_report(cs, calls)
            if name == "contact_certify_compact":
                out["k9_certify_blocks"] = certify_blocks_report(cs, calls)
    return out


def certify_blocks_report(cs, calls) -> dict:
    """K9's compacting certificate on a frame's recorded calls at every
    grid cap of BLOCKS_PER_SM (contact_cuda.CERTIFY_BLOCKS_PER_SM patched
    into the module): device ms behind a sleep."""
    from funky_tpu_torch.ops import contact_cuda
    from funky_tpu_torch.passes import contact

    def run():
        for a, kw in calls:
            contact.contact_certify_compact(*a, **kw)

    out = {"blocks_per_sm": contact_cuda.CERTIFY_BLOCKS_PER_SM}
    for b in BLOCKS_PER_SM:
        with patched(contact_cuda, "CERTIFY_BLOCKS_PER_SM", b):
            out[f"blocks_{b}_ms"] = cs.device_ms(run, iters=20,
                                                 sleep_cycles=SLEEP)
    return out


# K9's march layouts swept: the live count past which it runs one thread
# a slot (contact_cuda.LANES_LIVE_MAX patched)
MARCH_LAYOUTS = (("chain", -1), ("lanes", 2 ** 62))


def march_lanes_report(cs, calls) -> dict:
    """K9's march on a frame's recorded calls through its dispatcher, with
    each call's slots and live slots (before its count, and kept by its
    mask) and the calls' bound (chip_smoke.stage_work), and, where the checkout switches the march's layout by the live
    count (contact_cuda.LANES_LIVE_MAX), in each layout of MARCH_LAYOUTS
    for every live count, there also the indexed calls with their live
    count cut to each of LIVE_CUTS: device ms behind a sleep."""
    import inspect

    import torch

    from funky_tpu_torch.ops import contact_cuda
    from funky_tpu_torch.passes import contact

    def run():
        for a, kw in calls:
            contact.contact_march(*a, **kw)

    def slots(a, kw):
        b = inspect.signature(contact.contact_march).bind(*a, **kw)
        b.apply_defaults()
        g = b.arguments
        m = (g["payload"] if g["idx"] is None else g["idx"]).shape[0]
        need = torch.arange(m, device=g["payload"].device) < (
            m if g["count"] is None else int(g["count"]))
        if g["mask"] is not None:
            need &= g["mask"]
        return m, int(need.sum())

    counts = [slots(a, kw) for a, kw in calls]
    out = {"slots": [c[0] for c in counts], "live": [c[1] for c in counts],
           "ms": cs.device_ms(run, iters=20, sleep_cycles=SLEEP)}
    # the calls' bound, as the checkout's chip_smoke.py reckons it
    work = [cs.stage_work("contact_march", a, kw) for a, kw in calls]
    out["bound_ms"] = max(sum(w[0] for w in work) / cs.HBM_BPS,
                          sum(w[1] for w in work) / cs.FP32_OPS) * 1e3
    if hasattr(contact_cuda, "LANES_LIVE_MAX"):
        out["live_max"] = contact_cuda.LANES_LIVE_MAX
        for key, live_max in MARCH_LAYOUTS:
            with patched(contact_cuda, "LANES_LIVE_MAX", live_max):
                out[f"{key}_ms"] = cs.device_ms(run, iters=20,
                                                sleep_cycles=SLEEP)
                # the same slots cut to fewer live ones
                for live in LIVE_CUTS:
                    cut = [(a[:3] + (torch.full_like(a[3], live),) + a[4:],
                            kw) for a, kw in calls if len(a) > 3
                           and a[2].shape[0] >= live]
                    if cut:
                        out[f"{key}_live_{live}_ms"] = cs.device_ms(
                            lambda cut=cut: [contact.contact_march(*a, **kw)
                                             for a, kw in cut],
                            iters=20, sleep_cycles=SLEEP)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parent))
    ap.add_argument("--skip-panel", action="store_true")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from funky_tpu_torch import frame
    from funky_tpu_torch.app import ui
    from funky_tpu_torch.ops import (group_counts_cuda, lightmap_cuda,
                                     pair_taps_cuda)
    from funky_tpu_torch.passes import contact, shadow_lightspace

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: time_passes.py measures on the card")
    cs.phase_build()
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    dev = torch.device("cuda:0")
    out = {"tree": str(tree), "gpu": gpu}

    # the debug panel over a 1080p frame
    if not args.skip_panel:
        image = torch.rand((cs.HEIGHT, cs.WIDTH, 4),
                           generator=torch.Generator().manual_seed(0)).to(dev)
        panel = ui.DebugPanel(cs.WIDTH, cs.HEIGHT, device=dev)
        data = ui.UiData()
        panel.render_over(image, data)
        walls = []
        for _ in range(RENDER_OVER_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            panel.render_over(image, data)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["render_over_ms"] = walls
        out["render_over_median_ms"] = statistics.median(walls)
        out["k4"] = k4_report(cs, dev)

    gltf, scene = cs.load_scene(dev, large=False)
    params = cs.scene_params(gltf, dev)
    poses = cs.poses_for(params, cs.N_PARKED, cs.N_ORBIT)

    def replays(cfg, key):
        fn = frame.compiled_gltf_frame(cfg)
        for i in (1, 2):
            run = cs.gltf_frames(fn, scene, poses, cfg, dev)
            out[f"{key}_replay_{i}_host_ms"] = statistics.median(
                run["wall"][1:])
            out[f"{key}_replay_{i}_events_ms"] = statistics.median(
                run["ms"][1:])

    def one_frame(cfg, module, name):
        """The calls of module.name in one eager frame at the last pose,
        after one frame at the first (a chained state)."""
        state = frame.init_frame_state(cfg, dev)
        _, state = frame.render_gltf_frame(scene, poses[0], state, cfg)
        return record(module, name, lambda: frame.render_gltf_frame(
            scene, poses[-1], state, cfg))

    # the shipped configuration: its replays, then K6 on one frame's calls
    _, cfg, _, tune_s = cs.autotune_shipped(
        dev, scene, frame.tuning_poses(params, cs.N_TUNE))
    out["shipped_tune_s"] = tune_s
    replays(cfg, "shipped")
    ship_calls = one_frame(cfg, pair_taps_cuda, "pair_taps")
    out["k6_shipped"] = taps_report(cs, ship_calls)
    out["k7_shipped"] = k7_report(cs, one_frame(cfg, group_counts_cuda,
                                                "group_counts"))
    out["stages_shipped"] = stages_report(cs, one_frame, cfg)

    # the dense frame's K6 calls and its K9 march (every ray)
    dense = cs.dense_config(cs.WIDTH, cs.HEIGHT, cs.SHADOW, "auto")
    dense_calls = one_frame(dense, pair_taps_cuda, "pair_taps")
    out["k6_dense"] = taps_report(cs, dense_calls)
    out["k9_march_dense"] = march_lanes_report(
        cs, one_frame(dense, contact, "contact_march"))
    if hasattr(pair_taps_cuda, "lanes_for"):
        live = out["k6_shipped"]["live"]
        g = live.index(max(live))
        out["k6_lanes_by_entries"] = {
            "dense": lanes_by_entries(cs, dense_calls[0],
                                      out["k6_dense"]["live"][0]),
            "pair_group": lanes_by_entries(cs, ship_calls[g], live[g])}

    # the light-space configuration
    _, cfg, _, tune_s = cs.autotune_shipped(
        dev, scene, frame.tuning_poses(params, cs.N_TUNE),
        **cs.PERF_MODES["lightspace"])
    out["tune_s"] = tune_s
    out["windows"] = list(cfg.effective_light_windows())
    replays(cfg, "lightspace")
    out["stages_lightspace"] = stages_report(cs, one_frame, cfg)
    eager = cs.run_frames(scene, poses, cfg, dev)
    out["k3_per_eager_frame"] = eager["k3"]

    # each light map of one eager frame: K5 alone and the whole call
    calls = one_frame(cfg, shadow_lightspace, "build_light_shadow_map")
    kernel_calls = []
    for a, kw in calls:
        kernel_calls += record(
            lightmap_cuda, "light_map",
            lambda: shadow_lightspace.build_light_shadow_map(*a, **kw))
    maps = []
    for (a, kw), (ka, kkw) in zip(calls, kernel_calls):
        row = {"wc": a[5],
               "k5_ms": cs.device_ms(
                   lambda: lightmap_cuda.light_map(*ka, **kkw), iters=20),
               "call_ms": cs.device_ms(
                   lambda: shadow_lightspace.build_light_shadow_map(
                       *a, **kw), iters=20)}
        if hasattr(lightmap_cuda, "tile_rows"):
            row["rows"] = lightmap_cuda.tile_rows(a[5])
            row["k5_rows_ms"] = {}
            for r in lightmap_cuda.ROWS:
                with forced(lightmap_cuda, "tile_rows", r):
                    row["k5_rows_ms"][r] = cs.device_ms(
                        lambda: lightmap_cuda.light_map(*ka, **kkw),
                        iters=20)
        maps.append(row)
    out["light_maps"] = maps
    out["light_maps_k5_ms"] = sum(m["k5_ms"] for m in maps)
    out["light_maps_call_ms"] = sum(m["call_ms"] for m in maps)

    # the frame's whole light-map stage
    state = frame.init_frame_state(cfg, dev)
    _, state = frame.render_gltf_frame(scene, poses[0], state, cfg)
    (a, kw), = record(frame, "_light_maps", lambda: frame.render_gltf_frame(
        scene, poses[-1], state, cfg))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            frame._light_maps(*a, **kw)
        torch.cuda.synchronize()
    ks = cs.trace_kernels(prof, words=("",))
    out["light_stage_launches"] = len(ks) // 3
    out["light_stage_busy_ms"] = sum(k[1] for k in ks) / 3
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
