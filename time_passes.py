#!/usr/bin/env python3
"""Time the debug panel and the light-space ground light maps of the port
(funky_tpu_torch) on one NVIDIA GPU, in this checkout or another one:

    python3 time_passes.py [--tree PATH]

PATH (default: the directory of this script) is the root of a checkout;
its funky_tpu_torch and chip_smoke.py are imported, so two commits are
compared in one process each, on one card, e.g. in the order parent,
change, change, parent. Measures, at 1920x1080 with 4 x 2048^2 cascades
on chip_smoke.py's multimesh scene:

- `DebugPanel.render_over` of the debug window (the driver's default
  UiData) over a 1080p frame: host clock to a synchronize,
  RENDER_OVER_RUNS runs after one untimed;
- the light-space configuration (the shipped flags with
  light_space_ground_shadows, skip_backfacing_shadows and
  synth_shadow_maps), autotuned over frame.tuning_poses(params, 24): 8
  chained replays of its compiled_gltf_frame (2 parked, 6 orbit poses),
  host-clock and CUDA-event medians after the first, and 8 chained eager
  frames' K3 (row gather) launches;
- each light map of one eager frame (build_light_shadow_map, one per
  light window): device ms behind a sleep kernel (where enqueueing the
  call takes longer than the sleep, the host's gaps count too), and the
  kernels it launches and their summed device time, from torch.profiler
  over three calls;
- the same frame's whole light-map stage (frame._light_maps: the tap
  geometry and every window's map): the kernels it launches and their
  summed device time, from torch.profiler over three calls.

Prints the card's nvidia-smi line, then one JSON object. Needs a CUDA
card; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

RENDER_OVER_RUNS = 8


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parent))
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from funky_tpu_torch import frame
    from funky_tpu_torch.app import ui
    from funky_tpu_torch.passes import shadow_lightspace

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: time_passes.py measures on the card")
    cs.phase_build()
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    dev = torch.device("cuda:0")
    out = {"tree": str(tree), "gpu": gpu}

    # the debug panel over a 1080p frame
    image = torch.rand((cs.HEIGHT, cs.WIDTH, 4), generator=torch.Generator(
        ).manual_seed(0)).to(dev)
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

    # the light-space configuration
    gltf, scene = cs.load_scene(dev, large=False)
    params = cs.scene_params(gltf, dev)
    _, cfg, _, tune_s = cs.autotune_shipped(
        dev, scene, frame.tuning_poses(params, cs.N_TUNE),
        **cs.PERF_MODES["lightspace"])
    out["tune_s"] = tune_s
    out["windows"] = list(cfg.effective_light_windows())
    poses = cs.poses_for(params, cs.N_PARKED, cs.N_ORBIT)
    fn = frame.compiled_gltf_frame(cfg)
    for name in ("replay_1", "replay_2"):
        run = cs.gltf_frames(fn, scene, poses, cfg, dev)
        out[f"{name}_host_ms"] = statistics.median(run["wall"][1:])
        out[f"{name}_events_ms"] = statistics.median(run["ms"][1:])
    eager = cs.run_frames(scene, poses, cfg, dev)
    out["k3_per_eager_frame"] = eager["k3"]

    # each light map of one eager frame
    state = frame.init_frame_state(cfg, dev)
    _, state = frame.render_gltf_frame(scene, poses[0], state, cfg)
    calls = cs.record_light_maps(
        lambda: frame.render_gltf_frame(scene, poses[-1], state, cfg))
    maps = []
    for a, kw, *_ in calls:
        def one():
            return shadow_lightspace.build_light_shadow_map(*a, **kw)

        ms = cs.device_ms(one, iters=3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                one()
            torch.cuda.synchronize()
        ks = cs.trace_kernels(prof, words=("",))
        maps.append([a[5], ms, len(ks) // 3, sum(k[1] for k in ks) / 3])
    out["light_maps"] = maps            # [wc, ms, launches, busy ms]
    out["light_maps_ms"] = sum(m[1] for m in maps)
    out["light_maps_busy_ms"] = sum(m[3] for m in maps)

    # the frame's whole light-map stage
    stage, light_maps = [], frame._light_maps

    def record(*a, **kw):
        stage.append((a, kw))
        return light_maps(*a, **kw)

    frame._light_maps = record
    try:
        frame.render_gltf_frame(scene, poses[-1], state, cfg)
    finally:
        frame._light_maps = light_maps
    a, kw = stage[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            light_maps(*a, **kw)
        torch.cuda.synchronize()
    ks = cs.trace_kernels(prof, words=("",))
    out["light_stage_launches"] = len(ks) // 3
    out["light_stage_busy_ms"] = sum(k[1] for k in ks) / 3
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
