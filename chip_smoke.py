#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (funky_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
torch. It imports nothing of jax or of the JAX package. Phases (any
failure raises and the script exits non-zero):

1. build both kernel sources (csrc/raster.cu: K1 and K2; csrc/gather.cu:
   K3) with one nvcc each, started together, and print the ptxas lines;
2. K1 and K2 vs their plain torch twin on numpy-seeded random triangles
   (degenerate and w-culled ones included) at small and at the main
   path's shapes: full capacity, an overflowing tight capacity, a row
   slab, coplanar equal-depth duplicates, a long bin (4,000 small
   triangles in one tile), a ragged 250x130 framebuffer and tiles smaller
   than the kernels' rectangle. K2 is reached by patching the 4 MiB table
   limit to 0. tri_id and depth bit-equal;
3. a 256x144 multimesh frame on the card against the committed golden
   image (tests/goldens/multimesh_pbr_256x144.png, 3/255 tolerance);
4. the dense path: 4 chained 1920x1080 frames of the exact dense glTF
   frame with 4 x 2048^2 cascades (2 parked poses, then bench.py's
   orbit), once through the kernel and once with the plain raster: K1
   launches 5 times per frame, the runs are equal;
5. the default path: GltfConfig() (sparse shadows and contact, valid-block
   back half, block-sparse texture sampling) on the multimesh scene, 8
   chained frames (2 parked, 6 orbit): equal to the dense path bit for
   bit (tri_id, depth, rgba, history), host syncs per frame counted;
5b. the shipped path: bench.py's configuration, committed mode with
   synthesized cascade maps (GltfFrameFlags(committed=True,
   synth_shadow_maps=True)), autotuned over bench_poses(params, 24) by
   utils/autotune.py's tune_raster_capacities and tune_sparse_capacities
   (called directly, so a failure fails the run). Prints the tuned config,
   the occupancy and each cascade's light-fetch entries with the tap caps
   JAX's rule and the port's give. 8 chained committed frames (2 parked,
   6 orbit): no host sync, K1 launched once per nonzero occluder window
   plus once for the main pass in every frame, K1 == plain bit for bit on
   every recorded raster, the sync count torch's sync debug mode reports
   for one frame; then the same poses with committed=False: equal bit for
   bit when capacity_overflows names nothing on those poses but the
   band-block budget, whose committed drop is conservative;
6. the large scene (tests/torch_scenes.build_large_glb: 73,754
   triangles, past the table limit): 3 chained GltfConfig() frames, K2
   launches 5 times per frame and K1 never; one frame through the plain
   raster is equal to the K2 run; K1, K2 and the plain raster timed on
   the frame's own rasters, with the survivors of the kernels' exact cull
   counted by its plain twin (ops/raster.py::subtile_keep) for a
   culled-work bound;
7. K3, the row-gather probe, at the dense shadow filter's tap shape: a
   (4*2048*2048, 4) f32 table and 16 x 1080 x 1920 indices (uniform, one
   recorded PCF tap set), and a table that fits in L2; bit-equal to the
   plain gather, timed beside torch's `table[idx]`;
8. timings with CUDA events and the median frame times. Kernel times are
   device times (launches queued behind a sleep kernel, `device_ms`),
   printed beside the time through the wrapper with its host enqueue
   (`cuda_ms`: what a caller enqueueing one raster at a time waits).

Before the last line stdout carries the card's nvidia-smi line and a JSON
object describing the kernels; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "goldens" / "multimesh_pbr_256x144.png"
GOLDEN_TOL, GOLDEN_BAD_FRAC = 3.0 / 255.0, 2e-3
WIDTH, HEIGHT, SHADOW = 1920, 1080, 2048
N_DENSE = 4                # dense path: 2 parked + 2 orbit poses
N_PARKED, N_ORBIT = 2, 6   # default and shipped paths
N_TUNE = 24                # bench.py's chain: autotune over bench_poses(, 24)
N_LARGE = 3                # large scene: parked + 2 orbit poses
RASTERS_PER_FRAME = 5      # 4 cascades + the main pass
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s, FP32 non-tensor.
HBM_BPS, FP32_OPS = 3.35e12, 67e12
TAP_SHAPE = (16, HEIGHT, WIDTH)
# Rectangle heights (raster_cuda.RECT_H) timed per raster besides the
# shipped one: 32 gives 32x32 rectangles in the frame's tiles, 16 gives
# 16x64.
RECT_HEIGHTS = (32, 16)

_GPU = ""


def kernel_cases():
    """(name, clip, tris, width, height, RasterConfig kwargs, y_offset,
    slice_height) for the kernel-vs-plain comparison: numpy-seeded random
    screen triangles, one zero-area and one w-culled among them; a long
    bin (thousands of small triangles in one tile); a ragged framebuffer
    (width not a multiple of 4 or of the rectangle); tiles smaller than
    the kernel's rectangle, one of them 6 pixels wide."""
    from tests.torch_scenes import (random_clip_scene, small_triangles_scene,
                                    with_coplanar_duplicates)

    small = random_clip_scene(0, 300, 128, 64)
    dup = with_coplanar_duplicates(small[0])
    main = random_clip_scene(1, 2000, WIDTH, HEIGHT)
    shadow = random_clip_scene(2, 2000, SHADOW, SHADOW)
    long_bin = small_triangles_scene(3, 4000, (0, 0, 256, 128), 2.0, 256, 256)
    ragged = random_clip_scene(4, 400, 250, 130)
    return [
        ("small_full", *small, 128, 64, dict(tile_h=8, tile_w=128), 0, None),
        ("small_tight", *small, 128, 64,
         dict(tile_h=8, tile_w=128, capacity=4), 0, None),
        ("small_slab", *small, 128, 64, dict(tile_h=8, tile_w=128), 32, 16),
        ("small_ties", *dup, 128, 64, dict(tile_h=8, tile_w=128), 0, None),
        ("main_1080p_full", *main, WIDTH, HEIGHT,
         dict(tile_h=32, tile_w=128), 0, None),
        ("main_1080p_tight", *main, WIDTH, HEIGHT,
         dict(tile_h=32, tile_w=128, capacity=8), 0, None),
        ("shadow_2048", *shadow, SHADOW, SHADOW,
         dict(tile_h=128, tile_w=256), 0, None),
        ("shadow_2048_slab", *shadow, SHADOW, SHADOW,
         dict(tile_h=128, tile_w=256), 512, 256),
        ("long_bin", *long_bin, 256, 256, dict(tile_h=128, tile_w=256), 0,
         None),
        ("long_bin_main_tiles", *long_bin, 256, 256,
         dict(tile_h=32, tile_w=128), 0, None),
        ("ragged_250x130", *ragged, 250, 130, dict(tile_h=32, tile_w=128), 0,
         None),
        ("ragged_250x130_shadow_tiles", *ragged, 250, 130,
         dict(tile_h=128, tile_w=256), 0, None),
        ("tiny_tiles_8x16", *small, 128, 64, dict(tile_h=8, tile_w=16), 0,
         None),
        ("tiny_tiles_5x6", *small, 128, 64, dict(tile_h=5, tile_w=6), 0,
         None),
    ]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over `iters` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds of fn() over `iters` runs. The runs are
    enqueued behind a ~5 ms sleep kernel, so the events bracket the
    kernels alone and not the host's cost of enqueueing them (cuda_ms
    includes that wherever a run is shorter than its enqueue). fn must not
    synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def reset_counts() -> None:
    from funky_tpu_torch.ops import compact, gather_cuda, raster_cuda

    raster_cuda.reset_launches()
    gather_cuda.reset_launches()
    compact.reset_host_syncs()


def read_counts() -> dict:
    from funky_tpu_torch.ops import gather_cuda, raster_cuda

    return {"raster_table": raster_cuda.LAUNCHES,
            "raster_padded": raster_cuda.PADDED_LAUNCHES,
            "row_gather": gather_cuda.LAUNCHES}


def phase_build() -> None:
    from funky_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build_all(["raster", "gather"])
    say(f"build: {', '.join(str(p.relative_to(REPO)) for p in libs.values())}"
        f" in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)"
        f" [{_GPU}]")
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                say(f"  ptxas {name}.cu: {line.strip()}")


def phase_kernel_cases(dev, padded: bool) -> float:
    """K1 (padded=False) or K2 (the table limit patched to 0) against the
    plain twin on every case. Returns the max |depth| difference."""
    import torch

    from funky_tpu_torch.ops import raster, raster_cuda
    from funky_tpu_torch.ops.raster import RasterConfig

    saved = raster.TABLE_LIMIT_BYTES
    if padded:
        raster.TABLE_LIMIT_BYTES = 0
    label = "K2" if padded else "K1"
    max_err = 0.0
    ids = {}
    try:
        for name, clip, tris, w, h, kw, y0, sh in kernel_cases():
            out = {}
            for backend in ("cuda", "torch"):
                before = (raster_cuda.LAUNCHES, raster_cuda.PADDED_LAUNCHES)
                tri_id, depth, _ = raster.raster_scene(
                    torch.from_numpy(clip).to(dev),
                    torch.from_numpy(tris).to(dev), w, h, len(tris),
                    RasterConfig(backend=backend, **kw), y0, sh)
                sync(dev)
                k1 = raster_cuda.LAUNCHES - before[0]
                k2 = raster_cuda.PADDED_LAUNCHES - before[1]
                want = (backend == "cuda")
                check((k1, k2) == ((0, want) if padded else (want, 0)),
                      f"{label} {name}: launches K1 {k1}, K2 {k2}")
                out[backend] = (tri_id.cpu().numpy(), depth.cpu().numpy())
            (ik, zk), (ip, zp) = out["cuda"], out["torch"]
            err = float(np.abs(zk - zp).max())
            max_err = max(max_err, err)
            check(np.array_equal(ik, ip), f"{label} {name}: tri_id differs "
                  f"at {int((ik != ip).sum())} pixels")
            check(np.array_equal(zk.view(np.int32), zp.view(np.int32)),
                  f"{label} {name}: depth not bit-equal (max {err})")
            ids[name] = ik
            if name.endswith("_tight"):   # the capacity really drops some
                full = ids[name.removesuffix("_tight") + "_full"]
                check((full != ik).any(), f"{label} {name}: the tight "
                      "capacity dropped nothing")
            say(f"{label} case {name}: {w}x{h} tiles {kw['tile_h']}x"
                f"{kw['tile_w']} cap {kw.get('capacity')} y0 {y0}: "
                f"bit-equal, covered {float((ik >= 0).mean()):.3f}")
    finally:
        raster.TABLE_LIMIT_BYTES = saved
    return max_err


def load_scene(dev, large: bool):
    from funky_tpu_torch.models.gltf import GltfScene
    from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
    from funky_tpu_torch.models.scene import build_device_scene
    from tests.torch_scenes import build_large_glb

    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "scene.glb"
        gltf = GltfScene.load(build_large_glb(path) if large
                              else build_multimesh_glb(path,
                                                       two_textures=True))
    return gltf, build_device_scene(gltf, device=dev)


def scene_params(gltf, dev):
    from funky_tpu_torch import frame

    return frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                     gltf_scale=1.0, device=dev)


def dense_config(width, height, shadow, backend, tiles=None, stiles=None):
    from funky_tpu_torch.frame import GltfConfig, GltfFrameFlags
    from funky_tpu_torch.ops.raster import RasterConfig

    th, tw = tiles or (32, 128)
    sth, stw = stiles or (128, 256)
    return GltfConfig(
        width=width, height=height, shadow_map_size=shadow,
        raster=RasterConfig(tile_h=th, tile_w=tw, backend=backend),
        shadow_raster=RasterConfig(tile_h=sth, tile_w=stw, backend=backend),
        flags=GltfFrameFlags(sparse_shadows=False, sparse_contact=False),
        valid_block_capacity=0, texture_block_capacity=0, clip_capacity=64)


def default_config(backend="auto", **flags):
    """GltfConfig() at its defaults (1920x1080, 4 x 2048^2), the raster
    backend and the flags given aside."""
    import dataclasses

    from funky_tpu_torch.frame import GltfConfig, GltfFrameFlags

    cfg = GltfConfig(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                     flags=GltfFrameFlags(**flags))
    return dataclasses.replace(
        cfg, raster=dataclasses.replace(cfg.raster, backend=backend),
        shadow_raster=dataclasses.replace(cfg.shadow_raster,
                                          backend=backend))


def say_branches(label) -> None:
    """Which branch each overflow site took, and the largest count it read
    against its capacity, over the last run_frames."""
    from funky_tpu_torch.ops import compact

    for site in sorted(compact.OCCUPANCY):
        calls = compact.OCCUPANCY[site]
        sparse = compact.BRANCHES[(site, True)]
        peaks = [f"{max(c[k][0] for c in calls)}/{calls[0][k][1]}"
                 for k in range(len(calls[0]))]
        say(f"{label}: {site}: sparse branch {sparse} of {len(calls)} "
            f"frames; max count/capacity {', '.join(peaks)}")


def phase_golden(dev, gltf, scene):
    from funky_tpu_torch import frame
    from funky_tpu_torch.models.png_io import linear_to_srgb, read_png

    cfg = dense_config(256, 144, 256, "auto", (16, 128), (16, 128))
    params = scene_params(gltf, dev)
    state = frame.init_frame_state(cfg, dev)
    for _ in range(2):
        rgba, state = frame.render_gltf_frame(scene, params, state, cfg)
    sync(dev)
    got = linear_to_srgb(rgba[..., :3].cpu().numpy())
    want = read_png(GOLDEN)[..., :3].astype(np.float32) / 255.0
    diff = np.abs(got - want).max(-1)
    bad = float((diff > GOLDEN_TOL).mean())
    say(f"golden 256x144 multimesh on the card: {bad:.5f} of pixels over "
        f"3/255 (limit {GOLDEN_BAD_FRAC}), max diff {diff.max():.4f}")
    check(bad <= GOLDEN_BAD_FRAC, "golden image mismatch")


def poses_for(params, n_parked, n_orbit):
    from funky_tpu_torch import frame

    return ([params] * n_parked
            + [frame.orbit_params(params, i) for i in range(1, n_orbit + 1)])


def run_frames(scene, poses, cfg, dev):
    """Chained frames. Returns per-frame host copies (tri_id, depth, rgba,
    history), CUDA-event ms from the first enqueued op to the last, host
    ms up to the frame's synchronize, host syncs and K1 launches per
    frame, and the peak device memory (GiB)."""
    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import compact, raster_cuda

    state = frame.init_frame_state(cfg, dev)
    out = dict(frames=[], ms=[], wall=[], syncs=[], k1=[])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for p in poses:
        syncs0 = compact.HOST_SYNCS
        k1_0 = raster_cuda.LAUNCHES
        sync(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        rgba, state, tri_id = frame.render_gltf_frame_ids(scene, p, state,
                                                          cfg)
        if dev.type == "cuda":
            end.record()
        sync(dev)
        out["wall"].append((time.perf_counter() - t0) * 1e3)
        out["ms"].append(start.elapsed_time(end) if dev.type == "cuda"
                         else out["wall"][-1])
        out["syncs"].append(compact.HOST_SYNCS - syncs0)
        out["k1"].append(raster_cuda.LAUNCHES - k1_0)
        out["frames"].append(tuple(x.cpu().numpy() for x in (
            tri_id, state.prev_depth, rgba, state.shadow_history)))
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                       if dev.type == "cuda" else float("nan"))
    return out


def frames_diff(a, b) -> list:
    """(frame, field, differing elements) wherever two runs differ."""
    out = []
    for i, (fa, fb) in enumerate(zip(a["frames"], b["frames"])):
        for name, x, y in zip(("tri_id", "depth", "rgba", "history"), fa, fb):
            n = int((x.view(np.int32) != y.view(np.int32)).sum())
            if n:
                out.append((i, name, n))
    return out


def frames_equal(a, b, label):
    for i, (fa, fb) in enumerate(zip(a["frames"], b["frames"])):
        for name, x, y in zip(("tri_id", "depth", "rgba", "history"), fa, fb):
            check(np.array_equal(x.view(np.int32), y.view(np.int32)),
                  f"{label}: frame {i} {name} differs (max "
                  f"{np.abs(x.astype(np.float64) - y).max()})")


def report(label, run):
    ev, wall = run["ms"], run["wall"]
    say(f"{label}: median {statistics.median(ev[1:]):.3f} ms (CUDA events), "
        f"{statistics.median(wall[1:]):.3f} ms (host clock) over "
        f"{len(ev) - 1} frames after the first; peak device memory "
        f"{run['peak_gib']:.2f} GiB; host syncs per frame {run['syncs']} "
        f"[{_GPU}]")
    check(all(math.isfinite(x) for x in ev + wall), f"{label}: timing")


def check_image(run, poses, cfg, dev, label, on_ground=True):
    """The last frame: shape, finite, sky the clear colour, and shadow on
    the ground plane (on_ground) or on any covered pixel."""
    from funky_tpu_torch import frame

    tri_id, depth, rgba, hist = run["frames"][-1]
    check(rgba.shape == (cfg.height, cfg.width, 4), f"rgba shape {rgba.shape}")
    check(bool(np.isfinite(rgba).all()), f"{label}: non-finite pixels")
    sky = tri_id < 0
    clear = np.asarray(frame.GLTF_CLEAR + (1.0,), np.float32)
    check(not sky.any() or bool((rgba[sky] == clear).all()),
          f"{label}: sky pixels are not the clear colour")
    where = (ground_pixels(tri_id, depth, poses[-1], cfg, dev) if on_ground
             else tri_id >= 0)
    shadowed = float((hist[..., 0][where] < 1.0).mean()) if where.any() \
        else 0.0
    what = "ground" if on_ground else "covered"
    say(f"{label} final frame: sky {sky.mean():.3f} of pixels, {what} "
        f"{where.mean():.3f}, shadowed {what} {shadowed:.3f}")
    check(where.any(), f"{label}: no {what} pixel in view")
    check(shadowed > 0.0, f"{label}: no {what} pixel has a shadow below 1")


def ground_pixels(tri_id, depth, params, cfg, dev, band=0.02) -> np.ndarray:
    """Covered pixels within `band` of the plane y = 0 (the textured quad
    1 mm above it included), found by unprojecting the depth buffer in
    float64. The ground crosses the near plane, so its pixels carry the
    ids of clipped sub-triangles, not of the ground's own triangles."""
    from funky_tpu_torch import frame

    uni = frame.compute_frame_uniforms(params, frame.init_frame_state(cfg, dev),
                                       cfg)
    inv = np.linalg.inv(uni.view_proj.cpu().numpy().astype(np.float64))
    h, w = depth.shape
    x = (np.arange(w) + 0.5) / w * 2.0 - 1.0
    y = (np.arange(h) + 0.5) / h * 2.0 - 1.0
    ndc = np.stack(np.broadcast_arrays(x[None, :], y[:, None],
                                       depth.astype(np.float64), 1.0), -1)
    world = ndc @ inv.T
    world_y = world[..., 1] / world[..., 3]
    return (tri_id >= 0) & (np.abs(world_y) < band)


def phase_dense(dev, gltf, scene):
    """The exact dense path through K1 and through the plain raster."""
    params = scene_params(gltf, dev)
    poses = poses_for(params, 2, N_DENSE - 2)
    reset_counts()
    krun = run_frames(scene, poses, dense_config(WIDTH, HEIGHT, SHADOW,
                                                 "auto"), dev)
    counts = read_counts()
    say(f"dense path: {len(poses)} frames, launches {counts}")
    check(counts["raster_table"] == RASTERS_PER_FRAME * len(poses)
          and counts["raster_padded"] == 0,
          f"dense path: expected {RASTERS_PER_FRAME} K1 launches per frame")
    reset_counts()
    prun = run_frames(scene, poses, dense_config(WIDTH, HEIGHT, SHADOW,
                                                 "torch"), dev)
    check(sum(read_counts().values()) == 0, "the plain run launched a kernel")
    frames_equal(krun, prun, "dense kernel vs plain raster")
    say(f"dense path: kernel run == plain run, all {len(poses)} frames bit "
        f"for bit")
    check_image(krun, poses, dense_config(WIDTH, HEIGHT, SHADOW, "auto"),
                dev, "dense path")
    report(f"dense frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2, kernel raster",
           krun)
    report(f"dense frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2, plain raster", prun)
    return params, poses, krun


def phase_default(dev, gltf, scene, params):
    """GltfConfig() on the multimesh scene, held against the dense path
    over the same 8 poses."""
    from funky_tpu_torch.ops import compact

    poses = poses_for(params, N_PARKED, N_ORBIT)
    reset_counts()
    srun = run_frames(scene, poses, default_config(), dev)
    counts = read_counts()
    say(f"default path (multimesh): {len(poses)} frames, launches {counts}")
    say_branches("default path (multimesh)")
    check(counts["raster_table"] == RASTERS_PER_FRAME * len(poses)
          and counts["raster_padded"] == 0,
          "default path: expected 5 K1 launches per frame")
    drun = run_frames(scene, poses, dense_config(WIDTH, HEIGHT, SHADOW,
                                                 "auto"), dev)
    frames_equal(srun, drun, "default (sparse) vs dense")
    say(f"default path == dense path: tri_id, depth, rgba and history of "
        f"all {len(poses)} frames bit for bit")
    check_image(srun, poses, default_config(), dev, "default path")
    report(f"default frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 (multimesh)", srun)
    report(f"dense frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 (multimesh, same "
           f"poses)", drun)
    return counts, srun, drun


def autotune_shipped(dev, scene, params):
    """bench.py's configuration before tuning (GltfConfig() with committed
    mode and synthesized maps) and after: the raster capacities, then the
    sparse ones, each step called directly so that a failure raises.
    Returns (raster-tuned config, tuned config, occupancy, seconds)."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.utils import autotune

    base = default_config(committed=True, synth_shadow_maps=True)
    poses = frame.bench_poses(params, N_TUNE)
    sync(dev)
    t0 = time.perf_counter()
    raster_cfg = autotune.tune_raster_capacities(scene, poses, base)
    cfg, occ = autotune.tune_sparse_capacities(scene, poses, raster_cfg)
    sync(dev)
    return raster_cfg, cfg, occ, time.perf_counter() - t0


def check_rasters_bitwise(calls, label) -> float:
    """K1 against the plain raster on every recorded raster's inputs (these
    launches are comparisons, not the main path's). Returns the max |depth|
    difference."""
    import torch

    from funky_tpu_torch.ops.binning import TriangleSetup, gather_bin_data
    from funky_tpu_torch.ops.raster import RasterConfig, _rasterize_torch
    from funky_tpu_torch.ops.raster_cuda import raster_table_cuda

    err = 0.0
    for i, c in enumerate(calls):
        args = (c["w"], c["h"], c["th"], c["tw"], c["y0"])
        tri_k, dep_k = raster_table_cuda(c["table"], c["bins"], c["counts"],
                                         *args)
        tri_p, dep_p = _rasterize_torch(
            gather_bin_data(TriangleSetup(data=c["table"], valid=None),
                            c["bins"]), c["bins"], c["counts"], c["y0"],
            c["w"], c["h"], RasterConfig(tile_h=c["th"], tile_w=c["tw"],
                                         backend="torch"))
        err = max(err, float((dep_k - dep_p).abs().max()))
        check(torch.equal(tri_k, tri_p)
              and torch.equal(dep_k.view(torch.int32),
                              dep_p.view(torch.int32)),
              f"{label}: raster {i} ({c['w']}x{c['h']}, tiles {c['th']}x"
              f"{c['tw']}): K1 differs from the plain raster")
    return err


def count_syncs_reported(fn) -> list:
    """Run fn() under torch.cuda.set_sync_debug_mode("warn") and return
    the synchronising calls it reports, as 'file:line'."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def phase_shipped(dev, gltf, scene, params):
    """bench.py's shipped configuration on the multimesh scene: autotune,
    8 chained committed frames, and the same poses cond'd. Returns (K1
    launches, max |depth| difference of K1 against plain, the tuned
    config)."""
    import dataclasses

    from funky_tpu_torch import frame
    from funky_tpu_torch.utils import autotune, diagnostics

    label = "shipped path (multimesh)"
    raster_cfg, cfg, occ, tune_s = autotune_shipped(dev, scene, params)
    base = default_config(committed=True, synth_shadow_maps=True)
    tuned = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if getattr(cfg, f.name) != getattr(base, f.name)}
    say(f"{label}: autotune over bench_poses(params, {N_TUNE}) took "
        f"{tune_s:.3f} s [{_GPU}]")
    say(f"{label}: tuned config (fields changed from the base): {tuned}")
    say(f"{label}: occupancy {occ}")
    # derive_sparse_config folds the light-fetch entries into the tap caps
    # only when the frame builds no light maps; with them on, the same
    # occupancy gives the JAX package's rule.
    with_maps = dataclasses.replace(raster_cfg, flags=dataclasses.replace(
        raster_cfg.flags, light_space_ground_shadows=True))
    jax_caps = autotune.derive_sparse_config(
        with_maps, occ).shadow_pen_cascade_caps
    for c in range(4):
        say(f"{label}: cascade {c}: light_fetch_per_cascade "
            f"{occ['light_fetch_per_cascade'][c]}, full-group pairs "
            f"{occ['pairs_per_cascade'][c]}; tap cap by JAX's rule "
            f"{jax_caps[c]}, by the port's {cfg.shadow_pen_cascade_caps[c]}")
    windows = cfg.effective_light_windows() or (0, 0, 0, 0)
    n_win = sum(1 for s in windows if s)
    say(f"{label}: occluder windows {windows}: {n_win} window rasters + the "
        f"main raster per frame")

    poses = poses_for(params, N_PARKED, N_ORBIT)
    reset_counts()
    box = {}
    calls = record_raster_calls(lambda: box.update(
        run=run_frames(scene, poses, cfg, dev)))
    crun = box["run"]
    counts = read_counts()
    say(f"{label}: {len(poses)} committed frames, launches {counts}, K1 per "
        f"frame {crun['k1']}, host syncs per frame {crun['syncs']}")
    check(all(s == 0 for s in crun["syncs"]),
          f"{label}: a committed frame took a host branch")
    check(all(k == n_win + 1 for k in crun["k1"])
          and counts["raster_padded"] == 0,
          f"{label}: expected {n_win + 1} K1 launches per frame")
    check(len(calls) == (n_win + 1) * len(poses),
          f"{label}: {len(calls)} rasters recorded")
    err = check_rasters_bitwise(calls, label)
    say(f"{label}: K1 == plain raster bit for bit on all {len(calls)} "
        f"recorded rasters ({n_win * len(poses)} window rasters)")
    check_image(crun, poses, cfg, dev, label)

    state = frame.init_frame_state(cfg, dev)
    _, state = frame.render_gltf_frame(scene, poses[0], state, cfg)
    sync(dev)
    reported = count_syncs_reported(lambda: frame.render_gltf_frame(
        scene, poses[-1], state, cfg))
    say(f"{label}: one committed frame under torch.cuda.set_sync_debug_mode"
        f"('warn'): {len(reported)} synchronising calls reported")
    for line, n in collections.Counter(reported).items():
        say(f"  {n} x {line}")

    conded = dataclasses.replace(cfg, flags=dataclasses.replace(
        cfg.flags, committed=False))
    # The tuned poses as the autotuner renders them: the first pose twice,
    # then each other pose once.
    tuned_poses = [params] + frame.bench_poses(params, N_TUNE)
    for name, ps, poll in (
            ("tuned poses", tuned_poses, occ),
            ("frame poses", poses, diagnostics.measure_sparse_occupancy(
                scene, poses, cfg, frames=1))):
        crun_p = crun if ps is poses else run_frames(scene, ps, cfg, dev)
        reset_counts()
        drun = run_frames(scene, ps, conded, dev)
        say_branches(f"{label}, cond'd, {name}")
        over = autotune.capacity_overflows(cfg, poll)
        diffs = frames_diff(crun_p, drun)
        say(f"{label}, {name}: capacity_overflows {over}; committed vs "
            f"cond'd: {diffs or 'all frames bit for bit'}")
        if set(over) <= {"band_block_capacity"}:
            check(not diffs, f"{label}, {name}: committed != cond'd with no "
                  f"capacity overflow")
    for name, run in (("committed", crun), ("cond'd", drun)):
        ev, wall = run["ms"], run["wall"]
        say(f"shipped frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 (multimesh, "
            f"{name}): parked {ev[1]:.3f} ms (the second frame), motion "
            f"median {statistics.median(ev[N_PARKED:]):.3f} ms over "
            f"{N_ORBIT} orbit frames (CUDA events); host clock "
            f"{wall[1]:.3f} / {statistics.median(wall[N_PARKED:]):.3f} ms; "
            f"peak device memory {run['peak_gib']:.2f} GiB; host syncs per "
            f"frame {run['syncs']} [{_GPU}]")
        check(all(math.isfinite(x) for x in ev + wall), f"{name}: timing")
    return counts["raster_table"], err, cfg


def phase_shipped_timings(dev, scene, params, cfg):
    """K1 vs plain raster on one shipped frame's rasters (the occluder
    windows, then the main pass). Returns the window rasters' summed
    device ms."""
    from funky_tpu_torch import frame

    calls = record_raster_calls(lambda: frame.render_gltf_frame(
        scene, frame.orbit_params(params, N_ORBIT), frame.init_frame_state(
            cfg, dev), cfg))
    rows = time_rasters(calls, plain_iters=3, kernels=("K1",))
    for r in rows:
        say_raster("shipped raster", r, ("K1",), padded=False)
    win = [r for r in rows if (r["th"], r["tw"]) == (128, 128)]
    ms = sum(r["K1"] for r in win)
    say(f"shipped path: {len(win)} window rasters per frame: K1 {ms:.4f} ms "
        f"device time, plain {sum(r['plain'] for r in win):.4f} ms; with the "
        f"main raster K1 {sum(r['K1'] for r in rows):.4f} ms [{_GPU}]")
    return ms


def record_raster_calls(fn):
    """Run fn() and return, per raster it makes, the setup table, bins,
    counts and the kernel's framebuffer arguments."""
    from funky_tpu_torch.ops import raster

    calls = []
    bin_triangles = raster.bin_triangles

    def record(setup, width, height, tile_h, tile_w, capacity, y_offset=0):
        bins, counts = bin_triangles(setup, width, height, tile_h, tile_w,
                                     capacity, y_offset)
        calls.append(dict(table=setup.data, bins=bins, counts=counts,
                          w=width, h=height, th=tile_h, tw=tile_w,
                          y0=y_offset))
        return bins, counts

    raster.bin_triangles = record
    try:
        fn()
    finally:
        raster.bin_triangles = bin_triangles
    return calls


def raster_bound(c, padded: bool):
    """(bound ms, bytes, ops) of one raster's work on this run's inputs:
    K2 reads each binned row once (64 B), K1 the distinct rows it needs
    plus the bin ids; both read the counts and write 8 B per pixel; ~16
    FP32 operations per pixel of a tile and entry of its bin."""
    import torch

    counts = c["counts"].to(torch.int64)
    total = int(counts.sum())
    written = 8 * c["w"] * c["h"]
    if padded:
        read = 64 * total
    else:
        valid = c["bins"][c["bins"] >= 0]
        read = 64 * int(torch.unique(valid).numel()) + 4 * total
    read += 4 * counts.numel()
    ops = 16 * c["th"] * c["tw"] * total
    return max((read + written) / HBM_BPS, ops / FP32_OPS) * 1e3, \
        read + written, ops


def culled_work(c):
    """What the kernels' exact cull leaves of one recorded raster, counted
    on the card with the cull's plain twin (ops/raster.py::subtile_keep)
    over every (bin entry, rectangle) pair of the kernel's rectangles:
    (survivors in the fullest block, survivors in all blocks, FP32 ops =
    16 x survivors x their rectangle's pixels)."""
    import torch

    from funky_tpu_torch.ops.raster import subtile_keep
    from funky_tpu_torch.ops.raster_cuda import rect_shape

    bins, counts = c["bins"], c["counts"]
    th, tw, w, h = c["th"], c["tw"], c["w"], c["h"]
    rh, rw = rect_shape(th, tw)
    dev = bins.device
    live = (torch.arange(bins.shape[1], device=dev)[None, :]
            < counts[:, None].clamp(max=bins.shape[1]))
    tile_of = live.nonzero()[:, 0]
    rows = c["table"][bins[live].long()]                  # (E, 16)
    tiles_x = -(-w // tw)
    ty, tx = tile_of // tiles_x, tile_of % tiles_x
    ry, rx = torch.meshgrid(torch.arange(-(-th // rh), device=dev),
                            torch.arange(-(-tw // rw), device=dev),
                            indexing="ij")
    ry, rx = ry.reshape(1, -1), rx.reshape(1, -1)         # (1, R)
    x0 = tx[:, None] * tw + rx * rw
    y0 = ty[:, None] * th + ry * rh
    x1 = torch.minimum(x0 + rw, (tx[:, None] + 1) * tw).clamp(max=w)
    y1 = torch.minimum(y0 + rh, (ty[:, None] + 1) * th).clamp(max=h)
    pixels = (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)   # (E, R)
    keep = subtile_keep(rows[:, None, :], x0, x1 - 1, y0 + c["y0"],
                        y1 - 1 + c["y0"]) & (pixels > 0)
    block = tile_of[:, None] * ry.shape[1] + torch.arange(
        ry.shape[1], device=dev)[None, :]
    per_block = torch.bincount(block[keep], minlength=1)
    return (int(per_block.max()) if per_block.numel() else 0,
            int(keep.sum()), 16 * int((keep * pixels).sum()))


def time_rasters(calls, plain_iters, kernels=("K1", "K2")):
    """Per-raster ms of K1 and K2 on recorded calls: device time at the
    shipped rectangle (key "K1") and at every other height of
    RECT_HEIGHTS (key "K1 at 16x64"), and the time through the wrapper
    with its enqueue ("K1 wrapper", cuda_ms); and the plain twin's."""
    from funky_tpu_torch.ops import raster_cuda
    from funky_tpu_torch.ops.binning import TriangleSetup, gather_bin_data
    from funky_tpu_torch.ops.raster import RasterConfig, _rasterize_torch
    from funky_tpu_torch.ops.raster_cuda import (raster_padded_cuda,
                                                 raster_table_cuda)

    rows = []
    for c in calls:
        setup = TriangleSetup(data=c["table"], valid=None)
        args = (c["w"], c["h"], c["th"], c["tw"], c["y0"])
        bin_data = gather_bin_data(setup, c["bins"])
        run = {"K1": lambda: raster_table_cuda(c["table"], c["bins"],
                                               c["counts"], *args),
               "K2": lambda: raster_padded_cuda(bin_data, c["counts"],
                                                *args)}
        r = dict(c, tiles=tuple(c["bins"].shape),
                 fullest=int(c["counts"].max()))
        for k in kernels:
            r[k] = device_ms(run[k])
            r[k + " wrapper"] = cuda_ms(run[k], iters=20)
        shipped = raster_cuda.RECT_H
        try:
            for rect_h in RECT_HEIGHTS:
                if rect_h == shipped:
                    continue
                raster_cuda.RECT_H = rect_h
                rh, rw = raster_cuda.rect_shape(c["th"], c["tw"])
                for k in kernels:
                    r[f"{k} at {rh}x{rw}"] = device_ms(run[k])
        finally:
            raster_cuda.RECT_H = shipped
        cfg = RasterConfig(tile_h=c["th"], tile_w=c["tw"], backend="torch")
        r["plain"] = cuda_ms(lambda: _rasterize_torch(
            gather_bin_data(setup, c["bins"]), c["bins"], c["counts"],
            c["y0"], c["w"], c["h"], cfg), iters=plain_iters,
            warmup=min(plain_iters, 1))
        del bin_data, run
        r["fullest_block"], r["survivors"], r["culled_ops"] = culled_work(c)
        rows.append(r)
    return rows


def say_raster(label, r, kernels, padded):
    """One raster's line: kernel device times (and through the wrapper,
    and at the other rectangle heights), the unculled bound, the
    culled-work bound and the cull's survivors. Returns (bound ms, bytes,
    ops, culled bound ms)."""
    from funky_tpu_torch.ops import raster_cuda

    b, nbytes, ops = raster_bound(r, padded)
    culled = max(nbytes / HBM_BPS, r["culled_ops"] / FP32_OPS) * 1e3
    times = ", ".join(f"{k} {r[k]:.4f} ms ({r[k + ' wrapper']:.4f} ms "
                      f"through the wrapper)" for k in kernels)
    rh, rw = raster_cuda.rect_shape(r["th"], r["tw"])
    sweep = "".join(f"; {key} {r[key]:.4f} ms" for key in r
                    if key.split(" ")[0] in kernels and " at " in key)
    say(f"{label} {r['w']}x{r['h']} tiles {r['th']}x{r['tw']} bins "
        f"{r['tiles']} fullest bin {r['fullest']} binned "
        f"{int(r['counts'].sum())}: {times} (rect {rh}x{rw}{sweep}), plain "
        f"{r['plain']:.4f} ms; bound {b:.4f} ms ({nbytes} B, {ops} FP32 "
        f"ops), culled bound {culled:.4f} ms ({r['culled_ops']} FP32 "
        f"ops); survivors per block: fullest {r['fullest_block']}, total "
        f"{r['survivors']} [{_GPU}]")
    return b, nbytes, ops, culled


def phase_timings(dev, scene, params):
    """K1 vs plain raster on the dense path's own five rasters. Returns
    per-frame sums (kernel ms, plain ms, bound ms, bound_by, culled bound
    ms)."""
    from funky_tpu_torch import frame

    cfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    calls = record_raster_calls(lambda: frame.render_gltf_frame(
        scene, params, frame.init_frame_state(cfg, dev), cfg))
    check(len(calls) == RASTERS_PER_FRAME, f"{len(calls)} rasters per frame")
    rows = time_rasters(calls, plain_iters=5, kernels=("K1",))
    bounds = [say_raster("K1 raster", r, ("K1",), padded=False)
              for r in rows]
    by = ("bytes" if sum(x[1] for x in bounds) / HBM_BPS
          >= sum(x[2] for x in bounds) / FP32_OPS else "operations")
    return (sum(r["K1"] for r in rows), sum(r["plain"] for r in rows),
            sum(b[0] for b in bounds), by, sum(b[3] for b in bounds))


def phase_large(dev):
    """GltfConfig() on the large scene: every raster past the table limit
    takes K2. Returns (launch counts, per-frame sums of K2 ms, plain ms,
    bound ms, bound_by, K1 ms on the same rasters, culled bound ms)."""
    from funky_tpu_torch import frame

    gltf, scene = load_scene(dev, large=True)
    say(f"large scene: {scene.num_triangles} triangles "
        f"({scene.tri_indices.shape[0]} padded, a {scene.tri_indices.shape[0]}"
        f" x 16 f32 setup table = {scene.tri_indices.shape[0] * 64} B)")
    params = scene_params(gltf, dev)
    poses = poses_for(params, 1, N_LARGE - 1)
    reset_counts()
    krun = run_frames(scene, poses, default_config(), dev)
    counts = read_counts()
    say(f"large scene: {len(poses)} frames, launches {counts}")
    say_branches("large scene")
    check(counts["raster_padded"] == RASTERS_PER_FRAME * len(poses)
          and counts["raster_table"] == 0,
          "large scene: expected 5 K2 launches and no K1 launch per frame")
    prun = run_frames(scene, poses[:1], default_config("torch"), dev)
    krun1 = dict(krun, frames=krun["frames"][:1])
    frames_equal(krun1, prun, "large scene K2 vs plain raster")
    say("large scene: the first frame through the plain raster == the K2 "
        "run, tri_id, depth, rgba and history bit for bit")
    check_image(krun, poses, default_config(), dev, "large scene",
                on_ground=False)
    report(f"large-scene default frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2", krun)
    say(f"large scene, plain raster frame: {prun['ms'][0]:.3f} ms [{_GPU}]")

    cfg = default_config()
    calls = record_raster_calls(lambda: frame.render_gltf_frame(
        scene, poses[-1], frame.init_frame_state(cfg, dev), cfg))
    check(len(calls) == RASTERS_PER_FRAME, f"{len(calls)} rasters per frame")
    rows = time_rasters(calls, plain_iters=1)
    bounds = [say_raster("large raster", r, ("K2", "K1"), padded=True)
              for r in rows]
    by = ("bytes" if sum(x[1] for x in bounds) / HBM_BPS
          >= sum(x[2] for x in bounds) / FP32_OPS else "operations")
    return (counts, sum(r["K2"] for r in rows),
            sum(r["plain"] for r in rows), sum(b[0] for b in bounds), by,
            sum(r["K1"] for r in rows), sum(b[3] for b in bounds))


def record_tap_indices(scene, params, dev):
    """The row indices of one PCF tap set (the first cascade's 16 compare
    taps over the 1080p frame) from a dense frame of the main path."""
    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import sampling

    sets = []
    take_rows = sampling.take_rows
    n_rows = 4 * SHADOW * SHADOW

    def record(flat, idx):
        if flat.shape == (n_rows, 4) and tuple(idx.shape) == TAP_SHAPE:
            sets.append(idx.to(torch.int32).clone())
        return take_rows(flat, idx)

    cfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    sampling.take_rows = record
    try:
        frame.render_gltf_frame(scene, params,
                                frame.init_frame_state(cfg, dev), cfg)
    finally:
        sampling.take_rows = take_rows
    # per cascade: blocker search (nearest), then PCF compare
    check(len(sets) >= 2, f"recorded {len(sets)} tap sets")
    return sets[1]


def phase_gather(dev, scene, params):
    """K3 at the tap shape. Returns the JSON numbers of the recorded PCF
    tap set: (ms, plain_ms, library_ms, bound_ms, max_abs_err)."""
    import torch

    from funky_tpu_torch.ops import gather_cuda
    from funky_tpu_torch.ops.sampling import take_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_big = 4 * SHADOW * SHADOW
    n_l2 = 1 << 20                       # 16 MB table: fits the 50 MB L2
    tap = record_tap_indices(scene, params, dev)
    cases = [
        (f"uniform, {16 * n_big / 1e6:.0f} MB table", n_big,
         torch.randint(0, n_big, TAP_SHAPE, generator=gen, device=dev,
                       dtype=torch.int32)),
        (f"PCF tap set, {16 * n_big / 1e6:.0f} MB table", n_big, tap),
        (f"uniform, {16 * n_l2 / 1e6:.0f} MB table (in L2)", n_l2,
         torch.randint(0, n_l2, TAP_SHAPE, generator=gen, device=dev,
                       dtype=torch.int32)),
    ]
    out = None
    for name, n, idx in cases:
        table = torch.rand((n, 4), generator=gen, device=dev)
        got = gather_cuda.row_gather(table, idx)
        want = take_rows(table, idx)
        sync(dev)
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"K3 {name}: not bit-equal")
        idx64 = idx.long().clamp(0, n - 1)   # in range already; no device
        ms = cuda_ms(lambda: gather_cuda.row_gather(table, idx), iters=10)
        plain = cuda_ms(lambda: take_rows(table, idx), iters=5)
        lib = cuda_ms(lambda: table[idx64], iters=10)
        m = idx.numel()
        rows = int(torch.unique(idx64).numel())
        nbytes = 4 * m + 16 * m + 16 * rows
        bound = nbytes / HBM_BPS * 1e3
        sectors = 4 * m + 16 * m + 32 * m   # a 32 B sector per random row
        say(f"K3 {name}: {m} rows of 16 B from {n} ({rows} distinct): "
            f"kernel {ms:.4f} ms ({16 * m / ms / 1e6:.1f} GB/s written), "
            f"torch table[idx] {lib:.4f} ms, plain take_rows {plain:.4f} ms; "
            f"bound {bound:.4f} ms ({nbytes} B), {sectors / HBM_BPS * 1e3:.4f}"
            f" ms counting 32 B sectors; bit-equal [{_GPU}]")
        if name.startswith("PCF"):
            out = (ms, plain, lib, bound, err)
        del table, idx64, got, want
    return out


def main() -> None:
    global _GPU
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if not (REPO / "funky_tpu_torch" / "__init__.py").exists():
        fail(f"no funky_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))

    _GPU = gpu_line()
    say(_GPU)     # name, power limit (nvidia-smi's own line)
    dev = torch.device("cuda:0")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    phase_build()
    err_k1 = phase_kernel_cases(dev, padded=False)
    err_k2 = phase_kernel_cases(dev, padded=True)
    gltf, scene = load_scene(dev, large=False)
    phase_golden(dev, gltf, scene)
    params, _, _ = phase_dense(dev, gltf, scene)
    counts, _, _ = phase_default(dev, gltf, scene, params)
    k1_shipped, err_shipped, shipped_cfg = phase_shipped(dev, gltf, scene,
                                                         params)
    err_k1 = max(err_k1, err_shipped)
    k1_ms, k1_plain, k1_bound, k1_by, k1_culled = phase_timings(dev, scene,
                                                                params)
    say(f"K1 per frame (4 cascades + main, multimesh): kernel {k1_ms:.4f} "
        f"ms, plain {k1_plain:.4f} ms, bound {k1_bound:.4f} ms, culled "
        f"bound {k1_culled:.4f} ms [{_GPU}]")
    phase_shipped_timings(dev, scene, params, shipped_cfg)
    (large_counts, k2_ms, k2_plain, k2_bound, k2_by, k1_large,
     k2_culled) = phase_large(dev)
    say(f"large scene per frame (5 rasters): K2 {k2_ms:.4f} ms, K1 on the "
        f"same rasters {k1_large:.4f} ms, plain {k2_plain:.4f} ms, K2 bound "
        f"{k2_bound:.4f} ms, culled bound {k2_culled:.4f} ms [{_GPU}]")
    g_ms, g_plain, g_lib, g_bound, g_err = phase_gather(dev, scene, params)
    say("K3 row_gather is a probe on no frame path: 0 launches on the main "
        "paths above")
    say(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [
        dict(name="raster_table", route="cuda",
             source="funky_tpu_torch/csrc/raster.cu",
             replaces="funky_tpu/ops/raster_pallas.py:208",
             launches=counts["raster_table"] + k1_shipped,
             max_abs_err=err_k1, ms=k1_ms,
             plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None, bound_culled_ms=k1_culled),
        dict(name="raster_padded", route="cuda",
             source="funky_tpu_torch/csrc/raster.cu",
             replaces="funky_tpu/ops/raster_pallas.py:90",
             launches=large_counts["raster_padded"], max_abs_err=err_k2,
             ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, bound_culled_ms=k2_culled),
        dict(name="row_gather", route="cuda",
             source="funky_tpu_torch/csrc/gather.cu",
             replaces="experiments/bench_gather.py:160",
             launches=counts["row_gather"] + large_counts["row_gather"],
             max_abs_err=g_err, ms=g_ms, plain_ms=g_plain, bound_ms=g_bound,
             bound_by="bytes", library_ms=g_lib),
    ]
    say(_GPU)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
