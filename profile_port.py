#!/usr/bin/env python3
"""Where the time of the port's glTF frame goes, on one NVIDIA GPU.

    python3 profile_port.py [--config dense|default|shipped]
                            [--scene multimesh|large] [--trace trace.json]
                            [--graph]

Renders one of chip_smoke.py's configurations at 1920x1080 with 4 x
2048^2 cascades and kernel rasters: the exact dense path (`dense`, the
default), GltfConfig() (`default`: sparse shadows and contact,
valid-block back half, block-sparse texture sampling) or bench.py's
shipped configuration (`shipped`: committed mode with synthesized
cascade maps, autotuned over bench_poses first), on the multimesh or the
large scene. 8 chained frames (2 parked, 6 orbit poses) with a
synchronize around every stage (per-stage host-clock medians), 8 more
without (frame time), then one frame under torch.profiler (device time
by kernel, device busy and idle share, the device time of the row-gather
kernel K3 and of torch indexing `aten::index`, and the launch geometry of
the frame's largest gather kernels). Writes the profiler's chrome trace
to the path given, if any. With `--graph` (the shipped configuration,
whose committed frame frame.compiled_gltf_frame records as a CUDA graph)
it then times 8 chained replays and profiles one: the device's own kernel
times with the host's launches out of the way, summed by kernel name from
the trace. Needs a CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from chip_smoke import (HEIGHT, SHADOW, WIDTH, autotune_shipped,
                        default_config, dense_config, fail, gpu_line,
                        load_scene, poses_for, scene_params, trace_kernels)

# (module, attribute, label) of each stage render_gltf_frame calls: the
# common stages, then each configuration's own. No stage calls another.
COMMON = (
    ("frame", "compute_frame_uniforms", "uniforms"),
    ("geometry", "transform_vertices", "geometry"),
    ("shadow", "render_shadow_maps", "shadow rasters x4"),
    ("frame", "quad_pack", "quad_pack"),
    ("frame", "_main_raster_inputs", "near clip"),
    ("frame", "raster_corners", "main raster"),
    ("taa", "apply_shadow_taa", "taa"),
    ("shading", "shade_gltf", "shading"),
)
STAGES = {
    "dense": COMMON + (
        ("deferred", "interpolate", "deferred"),
        ("shadow_filter", "cascaded_shadow", "shadow filter"),
        ("contact", "compute_contact_shadow", "contact"),
    ),
    "default": COMMON + (
        ("frame", "light_ground_planes", "class planes"),
        ("frame", "build_class_maps", "class maps"),
        ("frame", "compact_valid_blocks", "valid-block compaction"),
        ("frame", "gather_blocks", "valid-block gather"),
        ("deferred", "interpolate_at", "deferred"),
        ("shadow_filter", "cascaded_shadow_sparse", "shadow filter (sparse)"),
        ("contact", "reference_plane", "contact plane"),
        ("contact", "compute_contact_shadow_sparse", "contact (sparse)"),
        ("frame", "scatter_blocks", "valid-block scatter"),
    ),
    "shipped": COMMON + (
        ("shadow_lightspace", "plan_windows", "window plans"),
        ("shadow", "synthesize_shadow_maps", "synthesized maps"),
        ("frame", "light_ground_planes", "class planes"),
        ("frame", "build_class_maps", "class maps"),
        ("deferred", "interpolate", "deferred (row slab)"),
        ("shadow_filter", "cascaded_shadow_sparse", "shadow filter (sparse)"),
        ("contact", "reference_plane", "contact plane"),
        ("contact", "compute_contact_shadow_sparse", "contact (sparse)"),
    ),
}


def chain(scene, poses, cfg, dev):
    """Host-clock ms of each chained frame, each ended by a synchronize."""
    from funky_tpu_torch import frame

    state = frame.init_frame_state(cfg, dev)
    ms = []
    for p in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = frame.render_gltf_frame(scene, p, state, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, state


def stage_times(scene, poses, cfg, dev, stages):
    """Per-stage ms: each stage function wrapped in synchronizes for the
    length of one chain, then restored."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.passes import (contact, deferred, geometry, shading,
                                        shadow, shadow_filter,
                                        shadow_lightspace, taa)

    mods = dict(frame=frame, geometry=geometry, shadow=shadow,
                deferred=deferred, shadow_filter=shadow_filter, taa=taa,
                contact=contact, shading=shading,
                shadow_lightspace=shadow_lightspace)
    times = {label: [] for _, _, label in stages}
    saved = []

    def timed(fn, label):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for mod, attr, label in stages:
        fn = getattr(mods[mod], attr)
        saved.append((mods[mod], attr, fn))
        setattr(mods[mod], attr, timed(fn, label))
    try:
        chain(scene, poses, cfg, dev)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(STAGES), default="dense")
    ap.add_argument("--scene", choices=("multimesh", "large"),
                    default="multimesh")
    ap.add_argument("--trace", help="write the profiler's chrome trace here")
    ap.add_argument("--graph", action="store_true",
                    help="also profile the compiled frame's graph replay "
                         "(--config shipped)")
    args = ap.parse_args()
    if args.graph and args.config != "shipped":
        fail("--graph needs --config shipped: only a committed frame is "
             "recorded as a CUDA graph")
    if not torch.cuda.is_available():
        fail("no CUDA device: this profile needs an NVIDIA GPU")
    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import compact
    from torch.profiler import ProfilerActivity, profile

    gpu = gpu_line()
    print(gpu, flush=True)
    dev = torch.device("cuda:0")
    gltf, scene = load_scene(dev, large=args.scene == "large")
    params = scene_params(gltf, dev)
    if args.config == "dense":
        cfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    elif args.config == "default":
        cfg = default_config()
    else:
        _, cfg, _, tune_s = autotune_shipped(dev, scene, params)
        print(f"autotune {tune_s:.3f} s: {cfg}", flush=True)
    poses = poses_for(params, 2, 6)
    print(f"{args.config} configuration, {args.scene} scene", flush=True)

    times = stage_times(scene, poses, cfg, dev, STAGES[args.config])
    total = sum(statistics.median(v[1:]) for v in times.values() if v[1:])
    for label, v in times.items():
        if not v[1:]:
            print(f"stage {label:24s} not run", flush=True)
            continue
        m = statistics.median(v[1:])
        print(f"stage {label:24s} {m:10.3f} ms  {m / total:6.1%}  "
              f"({len(v)} calls)", flush=True)
    compact.reset_host_syncs()
    ms, state = chain(scene, poses, cfg, dev)
    frame_ms = statistics.median(ms[1:])
    print(f"frame {WIDTH}x{HEIGHT}: median {frame_ms:.3f} ms host clock "
          f"without stage syncs, stages summed {total:.3f} ms; host branches "
          f"over {len(poses)} frames {dict(compact.BRANCHES)} [{gpu}]",
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame.render_gltf_frame(scene, frame.orbit_params(params, 7), state,
                                cfg)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # Kernels and copies only: an aten op's row repeats its kernels' time.
    dev_rows = [e for e in ka
                if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e3
    print(f"profiled frame: {sum(e.count for e in dev_rows)} device "
          f"launches, device busy {busy:.3f} ms; idle share against the "
          f"unprofiled frame {1 - busy / frame_ms:.3f} [{gpu}]", flush=True)
    # K3's kernel rows, and torch indexing with the kernels it launched
    k3 = [e for e in dev_rows if "row_gather" in e.key]
    index = [e for e in ka if e.key == "aten::index"]
    k3_ms = sum(e.self_device_time_total for e in k3) / 1e3
    index_ms = sum(e.device_time_total for e in index) / 1e3
    print(f"profiled frame: K3 row_gather {k3_ms:.3f} ms device time over "
          f"{sum(e.count for e in k3)} launches; aten::index {index_ms:.3f} "
          f"ms device time over {sum(e.count for e in index)} calls [{gpu}]",
          flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=25))
    for name, ms, grid, block in trace_kernels(prof)[:8]:
        print(f"gather kernel {name[:90]}: {ms:.3f} ms, grid {grid}, block "
              f"{block}", flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if args.graph:
        replay_profile(scene, params, poses, cfg, dev, gpu)


def replay_profile(scene, params, poses, cfg, dev, gpu) -> None:
    """Host-clock ms of chained replays of the compiled committed frame,
    then one replay under torch.profiler: its kernels by name from the
    trace (a graph's kernels carry no aten op), longest first."""
    from torch.profiler import ProfilerActivity, profile

    from funky_tpu_torch import frame

    fn = frame.compiled_gltf_frame(cfg)
    state = frame.init_frame_state(cfg, dev)
    ms = []
    for p in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = fn(scene, p, state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if fn.last is None:
        fail("the compiled frame recorded no graph")
    print(f"graph replay {WIDTH}x{HEIGHT}: median {statistics.median(ms[1:]):.3f}"
          f" ms host clock over {len(ms) - 1} replays after the capture; "
          f"launches at capture {fn.last.launches} [{gpu}]", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(scene, frame.orbit_params(params, 7), state)
        torch.cuda.synchronize()
    kernels = trace_kernels(prof, words=("",))
    busy = sum(k[1] for k in kernels)
    by_name: dict = {}
    for name, k_ms, _, _ in kernels:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + k_ms, n + 1)
    print(f"profiled replay: {len(kernels)} kernels, device busy "
          f"{busy:.3f} ms [{gpu}]", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"replay kernel {t:8.3f} ms {t / busy:6.1%} x{n:4d}  "
              f"{name[:110]}", flush=True)


if __name__ == "__main__":
    main()
