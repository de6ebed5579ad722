#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (funky_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
torch. It imports nothing of jax or of the JAX package. Phases (any
failure raises and the script exits non-zero):

1. build the hand-written raster kernel (csrc/raster.cu) with nvcc;
2. kernel vs its plain torch twin on numpy-seeded random triangles
   (degenerate and w-culled ones included) at small and at the main
   path's shapes: full capacity, an overflowing tight capacity, a row
   slab, coplanar equal-depth duplicates. tri_id and depth bit-equal;
3. a 256x144 multimesh frame on the card against the committed golden
   image (tests/goldens/multimesh_pbr_256x144.png, 3/255 tolerance);
4. the main path: 8 chained 1920x1080 frames of the dense glTF frame with
   4 x 2048^2 shadow cascades (2 parked poses, then 6 poses of bench.py's
   orbit), once through the kernel and once with the plain raster. The
   kernel must launch 5 times per frame and the plain run never; main
   tri_id/depth, rgba and history must be equal across the two runs; the
   image finite, the sky the clear colour, some ground in shadow;
5. timings with CUDA events: kernel vs plain raster on the arguments one
   frame of the main path passes the kernel (four 2048^2 cascades, the
   1080p main pass), and the median frame time.

The second-to-last line of stdout is a JSON object describing the kernel;
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
N_PARKED, N_ORBIT = 2, 6
RASTERS_PER_FRAME = 5      # 4 cascades + the main pass


def kernel_cases():
    """(name, clip, tris, width, height, RasterConfig kwargs, y_offset,
    slice_height) for the kernel-vs-plain comparison: numpy-seeded random
    screen triangles, one zero-area and one w-culled among them."""
    from tests.torch_scenes import random_clip_scene, with_coplanar_duplicates

    small = random_clip_scene(0, 300, 128, 64)
    dup = with_coplanar_duplicates(small[0])
    main = random_clip_scene(1, 2000, WIDTH, HEIGHT)
    shadow = random_clip_scene(2, 2000, SHADOW, SHADOW)
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
    ]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


def phase_kernel_cases(dev):
    import torch

    from funky_tpu_torch.ops import raster
    from funky_tpu_torch.ops.raster import RasterConfig

    max_err = 0.0
    ids = {}
    for name, clip, tris, w, h, kw, y0, sh in kernel_cases():
        out = {}
        for backend in ("cuda", "torch"):
            tri_id, depth, _ = raster.raster_scene(
                torch.from_numpy(clip).to(dev), torch.from_numpy(tris).to(dev),
                w, h, len(tris), RasterConfig(backend=backend, **kw), y0, sh)
            torch.cuda.synchronize()
            out[backend] = (tri_id.cpu().numpy(), depth.cpu().numpy())
        (ik, zk), (ip, zp) = out["cuda"], out["torch"]
        err = float(np.abs(zk - zp).max())
        max_err = max(max_err, err)
        check(np.array_equal(ik, ip), f"{name}: tri_id differs at "
              f"{int((ik != ip).sum())} pixels")
        check(np.array_equal(zk.view(np.int32), zp.view(np.int32)),
              f"{name}: depth not bit-equal (max {err})")
        ids[name] = ik
        if name.endswith("_tight"):   # the capacity really drops triangles
            full = ids[name.removesuffix("_tight") + "_full"]
            check((full != ik).any(), f"{name}: the tight capacity dropped "
                  "nothing")
        covered = float((ik >= 0).mean())
        print(f"kernel case {name}: {w}x{h} tiles {kw['tile_h']}x"
              f"{kw['tile_w']} cap {kw.get('capacity')} y0 {y0}: bit-equal, "
              f"covered {covered:.3f}", flush=True)
    return max_err


def multimesh(dev):
    from funky_tpu_torch.models.gltf import GltfScene
    from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
    from funky_tpu_torch.models.scene import build_device_scene

    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(
            pathlib.Path(td) / "multi.glb", two_textures=True))
    return gltf, build_device_scene(gltf, device=dev)


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


def phase_golden(dev, gltf, scene):
    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.models.png_io import linear_to_srgb, read_png

    cfg = dense_config(256, 144, 256, "auto", (16, 128), (16, 128))
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=dev)
    state = frame.init_frame_state(cfg, dev)
    for _ in range(2):
        rgba, state = frame.render_gltf_frame(scene, params, state, cfg)
    torch.cuda.synchronize()
    got = linear_to_srgb(rgba[..., :3].cpu().numpy())
    want = read_png(GOLDEN)[..., :3].astype(np.float32) / 255.0
    diff = np.abs(got - want).max(-1)
    bad = float((diff > GOLDEN_TOL).mean())
    print(f"golden 256x144 multimesh on the card: {bad:.5f} of pixels over "
          f"3/255 (limit {GOLDEN_BAD_FRAC}), max diff {diff.max():.4f}",
          flush=True)
    check(bad <= GOLDEN_BAD_FRAC, "golden image mismatch")


def run_frames(scene, poses, cfg, dev):
    """Chained frames; returns per-frame (tri_id, depth) on the host, the
    final rgba/history, and per-frame milliseconds: CUDA events from the
    first enqueued op to the last, and the host clock around the frame
    up to its synchronize."""
    import torch

    from funky_tpu_torch import frame

    state = frame.init_frame_state(cfg, dev)
    ids, depths, ms, wall = [], [], [], []
    for p in poses:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        rgba, state, tri_id = frame.render_gltf_frame_ids(scene, p, state,
                                                          cfg)
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ms.append(start.elapsed_time(end))
        ids.append(tri_id.cpu().numpy())
        depths.append(state.prev_depth.cpu().numpy())
    return ids, depths, rgba, state, (ms, wall)


def phase_frames(dev, gltf, scene):
    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import raster_cuda

    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=dev)
    poses = ([params] * N_PARKED
             + [frame.orbit_params(params, i) for i in range(1, N_ORBIT + 1)])
    kcfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    pcfg = dense_config(WIDTH, HEIGHT, SHADOW, "torch")

    torch.cuda.reset_peak_memory_stats(dev)
    raster_cuda.reset_launches()
    kid, kdep, krgba, kstate, kms = run_frames(scene, poses, kcfg, dev)
    launches = raster_cuda.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"main path: {len(poses)} frames through the kernel, "
          f"{launches} kernel launches, peak device memory "
          f"{peak_gib:.2f} GiB", flush=True)
    check(launches == RASTERS_PER_FRAME * len(poses),
          f"expected {RASTERS_PER_FRAME} launches per frame, got {launches}")

    raster_cuda.reset_launches()
    pid, pdep, prgba, pstate, pms = run_frames(scene, poses, pcfg, dev)
    check(raster_cuda.LAUNCHES == 0, "the plain run launched the kernel")

    for i in range(len(poses)):
        check(np.array_equal(kid[i], pid[i]), f"frame {i}: tri_id differs")
        check(np.array_equal(kdep[i].view(np.int32), pdep[i].view(np.int32)),
              f"frame {i}: depth differs")
    rk, rp = krgba.cpu().numpy(), prgba.cpu().numpy()
    hk = kstate.shadow_history.cpu().numpy()
    hp = pstate.shadow_history.cpu().numpy()
    check(np.array_equal(rk, rp), f"final rgba differs (max "
          f"{np.abs(rk - rp).max()})")
    check(np.array_equal(hk, hp), "final history differs")
    print("kernel run == plain run: main tri_id/depth of all "
          f"{len(poses)} frames, final rgba and history bit-equal",
          flush=True)

    check(rk.shape == (HEIGHT, WIDTH, 4), f"rgba shape {rk.shape}")
    check(bool(np.isfinite(rk).all()), "non-finite pixels")
    tri_id = kid[-1]
    sky = tri_id < 0
    clear = np.asarray(frame.GLTF_CLEAR + (1.0,), np.float32)
    check(sky.any() and bool((rk[sky] == clear).all()),
          "sky pixels are not the clear colour")
    ground = ground_pixels(tri_id, kdep[-1], poses[-1], kcfg, dev)
    shadowed = float((hk[..., 0][ground] < 1.0).mean()) if ground.any() else 0
    print(f"final frame: sky {sky.mean():.3f} of pixels, ground "
          f"{ground.mean():.3f}, shadowed ground {shadowed:.3f}", flush=True)
    check(ground.any(), "no ground pixel in view")
    check(shadowed > 0.0, "no ground pixel has a shadow term below 1")
    return launches, params, kms, pms


def ground_pixels(tri_id, depth, params, cfg, dev) -> np.ndarray:
    """Covered pixels on the ground plane y = 0 (the textured quad 1 mm
    above it included), found by unprojecting the depth buffer in float64.
    The ground crosses the near plane, so its pixels carry the ids of
    clipped sub-triangles, not of the ground's own triangles."""
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
    return (tri_id >= 0) & (np.abs(world_y) < 0.02)


def main_path_raster_calls(scene, params, dev):
    """The raster kernel's arguments as one frame of the main path passes
    them: four 2048^2 cascades, then the 1080p main pass."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import raster_cuda

    calls = []
    launch = raster_cuda.raster_table_cuda

    def record(*args):
        calls.append(args)
        return launch(*args)

    cfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    raster_cuda.raster_table_cuda = record
    try:
        frame.render_gltf_frame(scene, params, frame.init_frame_state(cfg, dev),
                                cfg)
    finally:
        raster_cuda.raster_table_cuda = launch
    check(len(calls) == RASTERS_PER_FRAME, f"{len(calls)} rasters per frame")
    return calls


def phase_timings(dev, scene, params):
    """Kernel vs plain raster on the main path's own inputs. Returns the
    per-frame sums (ms) over the five rasters."""
    from funky_tpu_torch.ops.binning import TriangleSetup, gather_bin_data
    from funky_tpu_torch.ops.raster import RasterConfig, _rasterize_torch
    from funky_tpu_torch.ops.raster_cuda import raster_table_cuda

    kern, plain = [], []
    for table, bins, counts, w, h, th, tw, y0 in main_path_raster_calls(
            scene, params, dev):
        cfg = RasterConfig(tile_h=th, tile_w=tw, backend="torch")
        setup = TriangleSetup(data=table, valid=None)
        kern.append(cuda_ms(lambda: raster_table_cuda(
            table, bins, counts, w, h, th, tw, y0), iters=50))
        plain.append(cuda_ms(lambda: _rasterize_torch(
            gather_bin_data(setup, bins), bins, counts, y0, w, h, cfg),
            iters=10))
        print(f"raster {w}x{h}, tiles {th}x{tw}, bins {tuple(bins.shape)}: "
              f"kernel {kern[-1]:.4f} ms, plain {plain[-1]:.4f} ms",
              flush=True)
    return sum(kern), sum(plain)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if not (REPO / "funky_tpu_torch" / "__init__.py").exists():
        fail(f"no funky_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    from funky_tpu_torch.ops import raster_cuda

    gpu = gpu_line()
    print(gpu, flush=True)     # name, power limit (nvidia-smi's own line)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = raster_cuda.build()
    print(f"build: {lib.relative_to(REPO)} in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    for line in raster_cuda.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    max_err = phase_kernel_cases(dev)
    gltf, scene = multimesh(dev)
    phase_golden(dev, gltf, scene)
    launches, params, kms, pms = phase_frames(dev, gltf, scene)
    kernel_frame_ms, plain_frame_ms = phase_timings(dev, scene, params)

    # frame 0 includes first-call set-up (cuBLAS handles, allocator)
    for label, (ev, wall) in (("kernel", kms), ("plain", pms)):
        frame_ms, wall_ms = statistics.median(ev[1:]), statistics.median(
            wall[1:])
        print(f"frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 cascades, {label} "
              f"raster: median {frame_ms:.3f} ms (CUDA events), "
              f"{wall_ms:.3f} ms (host clock) over {len(ev) - 1} frames "
              f"[{gpu}]", flush=True)
        check(math.isfinite(frame_ms) and math.isfinite(wall_ms), "timing")
    print(f"raster per frame (4 cascades + main): kernel "
          f"{kernel_frame_ms:.4f} ms, plain {plain_frame_ms:.4f} ms [{gpu}]",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "raster_table",
        "route": "cuda",
        "source": "funky_tpu_torch/csrc/raster.cu",
        "replaces": "funky_tpu/ops/raster_pallas.py:208",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_frame_ms,
        "plain_ms": plain_frame_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
