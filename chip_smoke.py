#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (funky_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
torch. It imports nothing of jax or of the JAX package. Phases (any
failure raises and the script exits non-zero):

1. build both kernel sources (csrc/raster.cu: K1 and K2; csrc/gather.cu:
   K3) with one nvcc each, started together, and print the ptxas lines;
1b. K3, the frame's row gather, vs its plain twin (take_rows_plain) bit
   for bit on unit cases: f32 rows of 1, 2, 4, 7, 8, 16 and 46, 1-D f32,
   int32, bool and f16 tables, f64 rows, tables 4 and 2 bytes past a
   16-byte boundary, negative and out-of-range indices, an empty index, a
   1-row table;
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
   orbit), once through the kernels, once with the plain raster and once
   with the plain row gather: K1 launches 5 times per frame and K3 on
   every frame (0 times in the plain-gather run), the runs are equal;
5. the default path: GltfConfig() (sparse shadows and contact, valid-block
   back half, block-sparse texture sampling) on the multimesh scene, 8
   chained frames (2 parked, 6 orbit): equal to the dense path bit for
   bit (tri_id, depth, rgba, history), host syncs per frame counted; K3
   on every frame, and the same frames with the plain row gather equal;
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
   for one frame; K3 on every frame, and the same committed frames with the
   plain row gather equal bit for bit; then the same poses with
   committed=False: equal bit for bit when capacity_overflows names
   nothing on those poses but the band-block budget, whose committed drop
   is conservative;
6. the large scene (tests/torch_scenes.build_large_glb: 73,754
   triangles, past the table limit): 3 chained GltfConfig() frames, K2
   launches 5 times per frame and K1 never, K3 on every frame; one frame
   through the plain raster and the frames with the plain row gather are
   equal to the K2 run; K1, K2 and the plain raster timed on
   the frame's own rasters, with the survivors of the kernels' exact cull
   counted by its plain twin (ops/raster.py::subtile_keep) for a
   culled-work bound;
7. K3 at the dense shadow filter's tap shape: a (4*2048*2048, 4) f32
   table and 16 x 1080 x 1920 indices (uniform, one recorded PCF tap set),
   and a table that fits in L2; bit-equal to the plain gather, timed
   beside torch's `table[idx]` and the plain twin; then every K3 call of
   one dense and one shipped frame, recorded and replayed: the summed
   device time per frame against its byte bound;
8. timings with CUDA events and the median frame times. Kernel times are
   device times (launches queued behind a sleep kernel, `device_ms`),
   printed beside the time through the wrapper with its host enqueue
   (`cuda_ms`: what a caller enqueueing one raster at a time waits);
9. the cube: compiled_cube_frame(FrameConfig(512, 512)) over bench.py's
   30 rotations, recorded as a CUDA graph: no synchronising call in an
   eager frame (torch's sync debug mode), K1 once per frame at capture,
   graph == eager == plain-raster frames bit for bit, the 128x128 frame
   at rotation 0.6 against tests/goldens/cube_r06_128.png; eager and
   replay medians;
10. the compiled shipped frame: compiled_gltf_frame on the tuned
   committed config, 8 chained frames == the eager frames bit for bit
   (rgba and every FrameState field), K1 and K3 at capture as the eager
   frame launches them, the cond'd and default configs refused a capture
   by the config alone; then eager and replay in turns (eager, graph,
   eager, graph) with host-clock and CUDA-event medians and peak memory;
11. the SDF frame: compiled_sdf_frame(SdfConfig(960, 540)) over 20 times
   (bench.py:221-251), finite, graph == eager, the 160x96 frame at t = 1
   against tests/goldens/sdf_t1_160x96.png;
12. the FrameDriver at 1920x1080 with the shipped flags on the multimesh
   scene, autotuned, the debug panel on and the retune probe every 4
   frames: 12 steps with camera keys, each == eager render_gltf_frame with
   the driver's config and params bit for bit, readback, save_png to
   local/, save_state / load_state and one more step; fails if a step or
   a probe failed (the driver swallows both by design). Times per step and
   of the panel's render_over.

Launch counters do not move on a graph replay: the app phases count
launches at capture (GraphFrame.launches) and in the warm-up and capture
runs, which the kernels line adds to the main paths' counts.

Before the last line stdout carries the card's nvidia-smi line and a JSON
object describing the kernels; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
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


@contextlib.contextmanager
def plain_gathers():
    """take_rows runs its plain twin on the card (0 K3 launches) inside the
    block: the script's own reference run, never the port's path."""
    from funky_tpu_torch.ops import gather_cuda, sampling

    kernel = gather_cuda.row_gather
    gather_cuda.row_gather = sampling.take_rows_plain
    try:
        yield
    finally:
        gather_cuda.row_gather = kernel


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


def gather_cases():
    """(label, table, idx) of K3's unit cases (tests/torch_scenes.py): the
    frame's row types at 150,001 indices into 100,000 rows, 3-D, empty,
    1-row and tap-major (16, 3, 4099) cases."""
    from tests.torch_scenes import GATHER_ROWS, gather_case

    out = [(f"{rows} large", *gather_case(rows, "large"))
           for rows in GATHER_ROWS]
    out += [(f"f32x4 {kind}", *gather_case("f32x4", kind))
            for kind in ("3d", "empty", "one_row", "taps")]
    out += [(f"{rows} taps", *gather_case(rows, "taps"))
            for rows in ("f32x46", "f32x7", "i32", "bool")]
    out += [(f"bool {kind}", *gather_case("bool", kind))
            for kind in ("empty", "one_row")]
    return out


def offset_table(table, offset: int, dev):
    """A contiguous copy of `table` on the card whose first byte lies
    `offset` bytes past a 16-byte boundary, as bytes (N, row bytes)."""
    import torch

    raw = torch.from_numpy(table).to(dev).reshape(table.shape[0], -1)
    rows = raw.view(torch.uint8)
    buf = torch.empty(rows.numel() + offset, dtype=torch.uint8, device=dev)
    view = buf[offset:].view(rows.shape)
    view.copy_(rows)
    check(view.data_ptr() % 16 == offset, "offset table misplaced")
    return view


def phase_gather_cases(dev) -> None:
    """K3 against its plain twin on every unit case, bit for bit."""
    import torch

    from funky_tpu_torch.ops import gather_cuda
    from funky_tpu_torch.ops.sampling import take_rows_plain
    from tests.torch_scenes import gather_case

    cases = [(label, torch.from_numpy(t).to(dev), torch.from_numpy(i).to(dev))
             for label, t, i in gather_cases()]
    for rows, offset in (("f32x4", 4), ("f32x46", 4), ("f32x4", 2)):
        t, i = gather_case(rows, "large")
        cases.append((f"{rows} {offset} bytes off", offset_table(t, offset, dev),
                      torch.from_numpy(i).to(dev)))
    for label, table, idx in cases:
        before = gather_cuda.LAUNCHES
        got = gather_cuda.row_gather(table, idx)
        sync(dev)
        check(gather_cuda.LAUNCHES - before == (idx.numel() > 0),
              f"K3 case {label}: {gather_cuda.LAUNCHES - before} launches")
        want = take_rows_plain(table, idx)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"K3 case {label}: {tuple(got.shape)} {got.dtype}")
        check(torch.equal(got.contiguous().view(torch.uint8),
                          want.contiguous().view(torch.uint8)),
              f"K3 case {label}: not bit-equal to the plain twin")
        say(f"K3 case {label}: table {tuple(table.shape)} {table.dtype} at "
            f"{table.data_ptr() % 16} past 16 B, idx {tuple(idx.shape)}: "
            f"bit-equal")


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
    ms up to the frame's synchronize, host syncs, K1 and K3 launches per
    frame, and the peak device memory (GiB)."""
    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import compact, gather_cuda, raster_cuda

    state = frame.init_frame_state(cfg, dev)
    out = dict(frames=[], ms=[], wall=[], syncs=[], k1=[], k3=[])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for p in poses:
        syncs0 = compact.HOST_SYNCS
        k1_0 = raster_cuda.LAUNCHES
        k3_0 = gather_cuda.LAUNCHES
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
        out["k3"].append(gather_cuda.LAUNCHES - k3_0)
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


def check_gathers(run, plain_run, label) -> None:
    """K3 launched on every frame of `run` and never in `plain_run` (the
    same frames with the plain row gather), and the two equal bit for
    bit."""
    check(all(k > 0 for k in run["k3"]),
          f"{label}: a frame launched no K3: {run['k3']}")
    check(all(k == 0 for k in plain_run["k3"]),
          f"{label}: the plain-gather run launched K3: {plain_run['k3']}")
    frames_equal(run, plain_run, f"{label}: K3 vs plain row gather")
    say(f"{label}: K3 launches per frame {run['k3']}; the frames with the "
        f"plain row gather == the K3 frames, tri_id, depth, rgba and history "
        f"of all {len(plain_run['frames'])} frames bit for bit")


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
    counts = read_counts()
    check(counts["raster_table"] + counts["raster_padded"] == 0,
          "the plain-raster run launched a raster kernel")
    frames_equal(krun, prun, "dense kernel vs plain raster")
    say(f"dense path: kernel run == plain-raster run, all {len(poses)} "
        f"frames bit for bit")
    with plain_gathers():
        grun = run_frames(scene, poses, dense_config(WIDTH, HEIGHT, SHADOW,
                                                     "auto"), dev)
    check_gathers(krun, grun, "dense path")
    check_image(krun, poses, dense_config(WIDTH, HEIGHT, SHADOW, "auto"),
                dev, "dense path")
    report(f"dense frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2, kernel raster",
           krun)
    report(f"dense frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2, plain raster", prun)
    report(f"dense frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2, plain row gather",
           grun)
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
    with plain_gathers():
        grun = run_frames(scene, poses, default_config(), dev)
    check_gathers(srun, grun, "default path (multimesh)")
    drun = run_frames(scene, poses, dense_config(WIDTH, HEIGHT, SHADOW,
                                                 "auto"), dev)
    frames_equal(srun, drun, "default (sparse) vs dense")
    say(f"default path == dense path: tri_id, depth, rgba and history of "
        f"all {len(poses)} frames bit for bit")
    check_image(srun, poses, default_config(), dev, "default path")
    report(f"default frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 (multimesh)", srun)
    report(f"dense frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 (multimesh, same "
           f"poses)", drun)
    report(f"default frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 (multimesh), plain "
           f"row gather", grun)
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
    with plain_gathers():
        grun = run_frames(scene, poses, cfg, dev)
    check_gathers(crun, grun, label)
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
    # K3 against the plain row gather on the host-bound committed frame,
    # in turns in one process: the first two runs above, then two more.
    runs = [("K3", crun), ("plain row gather", grun)]
    runs.append(("K3", run_frames(scene, poses, cfg, dev)))
    with plain_gathers():
        runs.append(("plain row gather", run_frames(scene, poses, cfg, dev)))
    for name, run in runs:
        say(f"shipped frame (committed), {name}: host clock per frame "
            f"{[round(x, 3) for x in run['wall']]} ms, median after the "
            f"first {statistics.median(run['wall'][1:]):.3f} ms [{_GPU}]")
    return counts["raster_table"], err, cfg, crun["k3"]


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
    with plain_gathers():
        grun = run_frames(scene, poses, default_config(), dev)
    check_gathers(krun, grun, "large scene")
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
            sum(r["K1"] for r in rows), sum(b[3] for b in bounds), krun["k3"])


def record_gather_calls(fn):
    """Run fn() and return the (table, idx) of every K3 call it makes."""
    from funky_tpu_torch.ops import gather_cuda

    calls = []
    kernel = gather_cuda.row_gather

    def record(table, idx):
        calls.append((table, idx))
        return kernel(table, idx)

    gather_cuda.row_gather = record
    try:
        fn()
    finally:
        gather_cuda.row_gather = kernel
    return calls


def trace_kernels(prof, words=("gather", "index")) -> list:
    """(name, device ms, grid, block) of every kernel in a torch.profiler
    run whose name holds one of `words`, longest first, from its trace."""
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], e.get("dur", 0) / 1e3, e.get("args", {}).get("grid"),
            e.get("args", {}).get("block")) for e in events
           if e.get("cat") == "kernel"
           and any(w in e.get("name", "") for w in words)]
    return sorted(out, key=lambda k: -k[1])


def say_launches(label, fn) -> None:
    """The gather kernels one call of fn() launches, with their grids."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for name, ms, grid, block in trace_kernels(prof):
        say(f"{label}: kernel {name[:80]}: {ms:.4f} ms, grid {grid}, block "
            f"{block} [{_GPU}]")


def gather_bytes(table, idx) -> int:
    """Bytes one gather must move: the indices read, the rows written, and
    each distinct row of the table read once."""
    import torch

    n = table.shape[0]
    row = table[0].numel() * table.element_size()
    norm = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return 4 * idx.numel() + row * idx.numel() \
        + row * int(torch.unique(norm).numel())


def dense_frame_gathers(scene, params, dev):
    from funky_tpu_torch import frame

    cfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    return record_gather_calls(lambda: frame.render_gltf_frame(
        scene, params, frame.init_frame_state(cfg, dev), cfg))


def phase_gather(dev, scene, params):
    """K3 at the tap shape. Returns the JSON numbers of the recorded PCF tap set: (ms, plain_ms,
    library_ms, bound_ms, max_abs_err)."""
    import torch

    from funky_tpu_torch.ops import gather_cuda
    from funky_tpu_torch.ops.sampling import take_rows_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_big = 4 * SHADOW * SHADOW
    n_l2 = 1 << 20                       # 16 MB table: fits the 50 MB L2
    # one PCF tap set of the dense frame: per cascade the blocker search
    # (nearest), then the PCF compare; the first cascade's compare
    taps = [i for t, i in dense_frame_gathers(scene, params, dev)
            if t.shape == (n_big, 4) and tuple(i.shape) == TAP_SHAPE]
    check(len(taps) >= 2, f"recorded {len(taps)} tap sets")
    cases = [
        (f"uniform, {16 * n_big / 1e6:.0f} MB table", n_big,
         torch.randint(0, n_big, TAP_SHAPE, generator=gen, device=dev,
                       dtype=torch.int32)),
        (f"PCF tap set, {16 * n_big / 1e6:.0f} MB table", n_big, taps[1]),
        (f"uniform, {16 * n_l2 / 1e6:.0f} MB table (in L2)", n_l2,
         torch.randint(0, n_l2, TAP_SHAPE, generator=gen, device=dev,
                       dtype=torch.int32)),
    ]
    del taps
    out = None
    for name, n, idx in cases:
        table = torch.rand((n, 4), generator=gen, device=dev)
        got = gather_cuda.row_gather(table, idx)
        want = take_rows_plain(table, idx)
        sync(dev)
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"K3 {name}: not bit-equal")
        idx64 = idx.long().clamp(0, n - 1)   # in range already; no device
        ms = cuda_ms(lambda: gather_cuda.row_gather(table, idx), iters=10)
        plain = cuda_ms(lambda: take_rows_plain(table, idx), iters=5)
        lib = cuda_ms(lambda: table[idx64], iters=10)
        m = idx.numel()
        nbytes = gather_bytes(table, idx)
        bound = nbytes / HBM_BPS * 1e3
        rows = (nbytes - 20 * m) // 16
        sectors = 4 * m + 16 * m + 32 * m   # a 32 B sector per random row
        say(f"K3 {name}: {m} rows of 16 B from {n} ({rows} distinct): "
            f"kernel {ms:.4f} ms ({16 * m / ms / 1e6:.1f} GB/s written, "
            f"{bound / ms:.0%} of the bound), torch table[idx] {lib:.4f} ms, "
            f"plain take_rows {plain:.4f} ms; bound {bound:.4f} ms "
            f"({nbytes} B), {sectors / HBM_BPS * 1e3:.4f} ms counting 32 B "
            f"sectors; bit-equal [{_GPU}]")
        if name.startswith("PCF"):
            out = (ms, plain, lib, bound, err)
            say_launches(f"K3 {name}, torch table[idx]", lambda: table[idx64])
            say_launches(f"K3 {name}, K3",
                         lambda: gather_cuda.row_gather(table, idx))
        del table, idx64, got, want
    return out


def time_frame_gathers(calls, label):
    """Summed device ms of one frame's recorded K3 calls, each replayed
    alone (device_ms), and of the plain twin; and the bound: every call's
    bytes over 3.35 TB/s. Returns (K3 ms, plain ms, bound ms)."""
    from funky_tpu_torch.ops import gather_cuda
    from funky_tpu_torch.ops.sampling import take_rows_plain

    nbytes = sum(gather_bytes(t, i) for t, i in calls)
    bound = nbytes / HBM_BPS * 1e3
    ms = sum(device_ms(lambda: gather_cuda.row_gather(t, i))
             for t, i in calls)
    plain = sum(device_ms(lambda: take_rows_plain(t, i), iters=5)
                for t, i in calls)
    rows = sum(i.numel() for _, i in calls)
    say(f"K3 per {label} frame: {len(calls)} calls, {rows} rows, "
        f"{nbytes} B: kernel {ms:.4f} ms device time ({bound / ms:.0%} of "
        f"the bound), plain twin {plain:.4f} ms; bound {bound:.4f} ms "
        f"[{_GPU}]")
    by_size = sorted(calls, key=lambda c: -c[1].numel())[:6]
    for t, i in by_size:
        say(f"  {label} gather: table {tuple(t.shape)} {t.dtype}, idx "
            f"{tuple(i.shape)}: {device_ms(lambda: gather_cuda.row_gather(t, i)):.4f}"
            f" ms, bound {gather_bytes(t, i) / HBM_BPS * 1e3:.4f} ms")
    return ms, plain, bound


def phase_gather_frames(dev, scene, params, shipped_cfg):
    """K3 per dense and per shipped frame (orbit pose N_ORBIT): every call
    recorded from one frame, then replayed. Returns {path: (ms, plain ms,
    bound ms)}."""
    from funky_tpu_torch import frame

    pose = frame.orbit_params(params, N_ORBIT)
    out = {"dense": time_frame_gathers(dense_frame_gathers(scene, pose, dev),
                                       "dense")}
    state = frame.init_frame_state(shipped_cfg, dev)
    _, state = frame.render_gltf_frame(scene, params, state, shipped_cfg)
    calls = record_gather_calls(lambda: frame.render_gltf_frame(
        scene, pose, state, shipped_cfg))
    out["shipped"] = time_frame_gathers(calls, "shipped")
    return out


# ---------------------------------------------------------------------------
# The app's entry points: compiled frames (CUDA graphs), the cube and SDF
# frames, and the FrameDriver with its debug panel.
# ---------------------------------------------------------------------------

CUBE_GOLDEN = REPO / "tests" / "goldens" / "cube_r06_128.png"
SDF_GOLDEN = REPO / "tests" / "goldens" / "sdf_t1_160x96.png"
N_CUBE = 30                # bench.py:255-269: rotations i * 0.02
N_SDF = 20                 # bench.py:221-251: times 1.0 + i * 0.02
N_DRIVER = 12              # driver steps with camera keys
DRIVER_RETUNE_EVERY = 4


def golden_bad(img, path) -> tuple:
    """(share of pixels over 3/255, max diff) of a linear RGBA tensor
    against a committed sRGB golden."""
    from funky_tpu_torch.models.png_io import linear_to_srgb, read_png

    got = linear_to_srgb(img[..., :3].cpu().numpy())
    want = read_png(path)[..., :3].astype(np.float32) / 255.0
    check(got.shape == want.shape, f"{path.name}: shape {got.shape}")
    diff = np.abs(got - want).max(-1)
    return float((diff > GOLDEN_TOL).mean()), float(diff.max())


def timed(fn, dev):
    """(result, host ms up to the synchronize, CUDA-event ms) of fn()."""
    import torch

    sync(dev)
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def phase_cube(dev):
    """compiled_cube_frame(FrameConfig(512, 512)) over N_CUBE rotations:
    no synchronising call in an eager frame, K1 once per frame at capture,
    graph == eager == plain raster bit for bit, the 128x128 golden.
    Returns (launch counts of the run, eager ms, replay ms)."""
    import dataclasses

    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.models.scene import build_cube_scene
    from funky_tpu_torch.ops.raster import RasterConfig

    label = "cube 512x512"
    scene = build_cube_scene(device=dev)
    cfg = frame.FrameConfig(width=512, height=512)
    params = [frame.default_cube_params(i * 0.02, device=dev)
              for i in range(N_CUBE)]
    frame.render_cube_frame(scene, params[0], cfg)
    sync(dev)
    reported = count_syncs_reported(
        lambda: frame.render_cube_frame(scene, params[1], cfg))
    say(f"{label}: one eager frame under torch.cuda.set_sync_debug_mode"
        f"('warn'): {len(reported)} synchronising calls reported")
    check(not reported, f"{label}: the eager frame synchronises: "
          f"{collections.Counter(reported)}")
    fn = frame.compiled_cube_frame(cfg)
    check(fn.uses_graph(dev), f"{label}: the cube frame is not recorded")
    reset_counts()
    graph, g_wall, g_ev = [], [], []
    for p in params:
        img, wall, ev = timed(lambda: fn(scene, p), dev)
        graph.append(img)
        g_wall.append(wall)
        g_ev.append(ev)
    counts = read_counts()
    g = fn.last
    say(f"{label}: {N_CUBE} frames through compiled_cube_frame: launches "
        f"{counts} (warm-up + capture), at capture {g.launches}, "
        f"{g.replays} replays")
    check(g.launches["raster_table"] == 1 and counts["raster_table"] >= 1,
          f"{label}: expected one K1 launch per frame at capture")
    check(g.replays == N_CUBE, f"{label}: {g.replays} replays")
    eager, e_wall, e_ev = [], [], []
    for p in params:
        img, wall, ev = timed(lambda: frame.render_cube_frame(scene, p, cfg),
                              dev)
        eager.append(img)
        e_wall.append(wall)
        e_ev.append(ev)
    plain_cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
        cfg.raster, backend="torch"))
    for i, p in enumerate(params):
        check(bits_equal(graph[i], eager[i]),
              f"{label}: graph frame {i} differs from the eager frame")
        check(bits_equal(eager[i], frame.render_cube_frame(scene, p,
                                                           plain_cfg)),
              f"{label}: frame {i} differs through the plain raster")
        check(bool(torch.isfinite(graph[i]).all()), f"{label}: non-finite")
    say(f"{label}: graph frames == eager frames == plain-raster frames, all "
        f"{N_CUBE} bit for bit")
    small = frame.FrameConfig(width=128, height=128, raster=RasterConfig(
        tile_h=16, tile_w=128, capacity=32))
    img = frame.compiled_cube_frame(small)(
        scene, frame.default_cube_params(0.6, device=dev))
    bad, mx = golden_bad(img, CUBE_GOLDEN)
    say(f"cube 128x128 golden (rotation 0.6, CUDA graph): {bad:.5f} of "
        f"pixels over 3/255 (limit {GOLDEN_BAD_FRAC}), max diff {mx:.4f}")
    check(bad <= GOLDEN_BAD_FRAC, "cube golden image mismatch")
    e_ms = statistics.median(e_wall[1:])
    r_ms = statistics.median(g_wall[1:])
    say(f"{label}: eager median {e_ms:.3f} ms host clock, "
        f"{statistics.median(e_ev[1:]):.3f} ms CUDA events; replay median "
        f"{r_ms:.3f} ms host clock, {statistics.median(g_ev[1:]):.3f} ms "
        f"CUDA events (frames after the first) [{_GPU}]")
    return counts, e_ms, r_ms


def gltf_frames(fn, scene, poses, cfg, dev):
    """Chained frames through fn(scene, params, state): per frame host
    copies of rgba and of every FrameState field, host and CUDA-event ms,
    and the peak device memory (GiB) of the run."""
    import torch

    from funky_tpu_torch import frame

    state = frame.init_frame_state(cfg, dev)
    out = dict(frames=[], wall=[], ms=[])
    torch.cuda.reset_peak_memory_stats(dev)
    for p in poses:
        (rgba, state), wall, ev = timed(lambda: fn(scene, p, state), dev)
        out["wall"].append(wall)
        out["ms"].append(ev)
        out["frames"].append([rgba.cpu()] + [x.cpu() for x in state])
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
    return out


def phase_compiled_shipped(dev, scene, params, cfg):
    """compiled_gltf_frame on the shipped (committed, tuned) config: 8
    chained frames == the eager frames bit for bit (rgba and every state
    field), K1 and K3 at capture as the eager frame launches them; the
    cond'd and default configs refused a capture by the config alone;
    then eager and replay timed in turns. Returns (launch counts of the
    graph run, capture launches)."""
    import dataclasses
    import functools

    from funky_tpu_torch import frame

    label = "compiled shipped frame"
    names = ("rgba",) + frame.FrameState._fields
    poses = poses_for(params, N_PARKED, N_ORBIT)
    eager_fn = functools.partial(frame.render_gltf_frame, cfg=cfg)
    reset_counts()
    erun = gltf_frames(eager_fn, scene, poses, cfg, dev)
    e_counts = read_counts()
    fn = frame.compiled_gltf_frame(cfg)
    check(fn.uses_graph(dev), f"{label}: a committed config is not recorded")
    reset_counts()
    grun = gltf_frames(fn, scene, poses, cfg, dev)
    counts = read_counts()
    g = fn.last
    say(f"{label}: {len(poses)} frames: eager launches {e_counts}; graph "
        f"run launches {counts} (warm-up + capture), at capture "
        f"{g.launches}, {g.replays} replays")
    per_frame = {k: v // len(poses) for k, v in e_counts.items()}
    check(all(v % len(poses) == 0 for v in e_counts.values())
          and g.launches == per_frame,
          f"{label}: capture launches {g.launches} != the eager frame's "
          f"{per_frame}")
    check(g.launches["raster_table"] > 0 and g.launches["row_gather"] > 0,
          f"{label}: K1 or K3 missing at capture")
    for i, (fe, fg) in enumerate(zip(erun["frames"], grun["frames"])):
        for name, a, b in zip(names, fe, fg):
            check(bits_equal(a, b), f"{label}: frame {i} {name} differs "
                  f"from the eager frame")
    say(f"{label}: graph == eager, rgba and all {len(names) - 1} FrameState "
        f"fields of all {len(poses)} frames bit for bit")
    for name, flags in (("cond'd", dict(committed=False)),
                        ("default", None)):
        c = (dataclasses.replace(cfg, flags=dataclasses.replace(
            cfg.flags, **flags)) if flags else default_config())
        f = frame.compiled_gltf_frame(c)
        check(not f.uses_graph(dev), f"{label}: {name} config recorded")
        f(scene, poses[0], frame.init_frame_state(c, dev))
        sync(dev)
        check(not f.captures and f.last is None,
              f"{label}: the {name} config captured a graph")
        say(f"{label}: the {name} config runs eagerly (capture refused by "
            f"the config alone)")
    # eager and replay in turns in one process: eager, graph, eager, graph
    runs = [("eager", erun), ("graph", grun),
            ("eager", gltf_frames(eager_fn, scene, poses, cfg, dev)),
            ("graph", gltf_frames(fn, scene, poses, cfg, dev))]
    for name, run in runs:
        say(f"{label} {WIDTH}x{HEIGHT} ({name}): host clock median "
            f"{statistics.median(run['wall'][1:]):.3f} ms, CUDA events "
            f"median {statistics.median(run['ms'][1:]):.3f} ms over "
            f"{len(poses) - 1} frames after the first; per frame "
            f"{[round(x, 3) for x in run['wall']]} ms; peak device memory "
            f"{run['peak_gib']:.2f} GiB allocated, {run['reserved_gib']:.2f} "
            f"GiB reserved (a graph's pool included) [{_GPU}]")
    return counts, g.launches


def phase_sdf(dev):
    """compiled_sdf_frame(SdfConfig(960, 540)) over N_SDF times: finite,
    graph == eager on the first, and the 160x96 golden at t = 1."""
    import torch

    from funky_tpu_torch.models.sdf import (SdfConfig, compiled_sdf_frame,
                                            default_sdf_camera,
                                            render_sdf_frame)

    label = "sdf 960x540"
    cam = default_sdf_camera(device=dev)
    cfg = SdfConfig(width=960, height=540)
    fn = compiled_sdf_frame(cfg)
    walls, evs = [], []
    for i in range(N_SDF):
        img, wall, ev = timed(lambda: fn(1.0 + i * 0.02, *cam), dev)
        walls.append(wall)
        evs.append(ev)
        check(img.shape == (540, 960, 4) and bool(torch.isfinite(img).all()),
              f"{label}: frame {i} not finite or of shape {img.shape}")
    eager, e_wall, _ = timed(lambda: render_sdf_frame(
        1.0 + (N_SDF - 1) * 0.02, *cam, cfg), dev)
    check(bits_equal(img, eager), f"{label}: graph frame != eager frame")
    small = compiled_sdf_frame(SdfConfig(width=160, height=96))(1.0, *cam)
    bad, mx = golden_bad(small, SDF_GOLDEN)
    say(f"sdf 160x96 golden (t = 1, CUDA graph): {bad:.5f} of pixels over "
        f"3/255 (limit {GOLDEN_BAD_FRAC}), max diff {mx:.4f}")
    check(bad <= GOLDEN_BAD_FRAC, "sdf golden image mismatch")
    ms = statistics.median(walls[1:])
    say(f"{label}: {N_SDF} frames, replay median {ms:.3f} ms per frame host "
        f"clock, {statistics.median(evs[1:]):.3f} ms CUDA events; eager "
        f"frame {e_wall:.3f} ms; graph == eager bit for bit; launches at "
        f"capture {fn.last.launches} [{_GPU}]")
    return ms


def phase_driver(dev):
    """FrameDriver on the multimesh scene at 1920x1080 with the shipped
    flags, autotuned, the debug panel on and the retune probe every
    DRIVER_RETUNE_EVERY frames: N_DRIVER steps with camera keys, each equal
    to eager render_gltf_frame with the driver's config and params;
    readback, save_png, save_state / load_state and one more step. Fails
    on any failed step or probe. Returns (launch counts, capture launches,
    step ms, render_over ms)."""
    import io

    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.app.camera import Keys
    from funky_tpu_torch.app.driver import FrameDriver
    from funky_tpu_torch.frame import GltfConfig, GltfFrameFlags

    label = "driver 1920x1080"
    base = GltfConfig(width=WIDTH, height=HEIGHT, flags=GltfFrameFlags(
        committed=True, synth_shadow_maps=True))
    keys = [[Keys.W], [Keys.LEFT], [Keys.W, Keys.RIGHT], [], [Keys.S],
            [Keys.UP], [Keys.D], [], [Keys.A, Keys.DOWN], [Keys.E], [Keys.Q],
            [Keys.Z]]
    out_dir = REPO / "local"
    out_dir.mkdir(exist_ok=True)
    log = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(log), \
            tempfile.TemporaryDirectory() as td:
        from funky_tpu_torch.models.sample_scenes import build_multimesh_glb

        glb = build_multimesh_glb(pathlib.Path(td) / "multi.glb",
                                  two_textures=True)
        t0 = time.perf_counter()
        drv = FrameDriver(base, scene_path=glb, autotune=True,
                          enable_ui=True,
                          retune_check_every=DRIVER_RETUNE_EVERY,
                          device=dev, gltf_scale=1.0)
        sync(dev)
        tune_s = time.perf_counter() - t0
        check(drv.cfg.shadow_pen_capacity is not None
              and drv.cfg.raster.capacity is not None,
              f"{label}: the start-up autotune left the defaults")
        steps, diffs = [], 0
        for k in keys[:N_DRIVER]:
            cfg0 = drv.cfg
            before = frame.FrameState(*(x.clone() for x in drv.state))
            img, wall, _ = timed(lambda: drv.step(k), dev)
            steps.append(wall)
            check(drv.consecutive_failures == 0 and not drv.last_error,
                  f"{label}: step {drv.frame_count} failed: "
                  f"{drv.last_error}")
            want, _ = frame.render_gltf_frame(drv.device_scene,
                                              drv.last_params, before, cfg0)
            check(bits_equal(img, want), f"{label}: step {drv.frame_count} "
                  f"differs from the eager frame")
            diffs += 1
        g = drv._frame_fn.last
        img_back = drv.readback()
        drv.save_png(out_dir / "driver_1080p_ui.png")
        sync(dev)
        t1 = time.perf_counter()
        over = drv.ui.render_over(drv._last_image, drv.ui_data())
        sync(dev)
        ui_ms = (time.perf_counter() - t1) * 1e3
        drv.save_state(out_dir / "driver_session.pkl")
        drv.load_state(out_dir / "driver_session.pkl")
        drv.step([Keys.W])
        sync(dev)
        check(drv.consecutive_failures == 0 and not drv.last_error,
              f"{label}: the step after load_state failed: {drv.last_error}")
    text = log.getvalue()
    counts = read_counts()
    for line in text.splitlines():
        say(f"  driver stdout: {line}")
    check("failed" not in text, f"{label}: a step or probe failed")
    check(img_back.shape == (HEIGHT, WIDTH, 3)
          and bool(np.isfinite(img_back).all()), f"{label}: readback")
    check(over.shape == (HEIGHT, WIDTH, 4), f"{label}: render_over shape")
    say(f"{label}: autotune {tune_s:.3f} s; {N_DRIVER + 1} steps, "
        f"{drv.retune_count} re-tunes, {diffs} frames == eager "
        f"render_gltf_frame bit for bit; launches {counts}; at the last "
        f"capture {g.launches if g else None}; step median "
        f"{statistics.median(steps[1:]):.3f} ms host clock (the first "
        f"{steps[0]:.3f} ms records the graph); render_over {ui_ms:.3f} ms; "
        f"wrote local/driver_1080p_ui.png [{_GPU}]")
    check(g is not None, f"{label}: the shipped config recorded no graph")
    return counts, g.launches, statistics.median(steps[1:]), ui_ms


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
    phase_gather_cases(dev)
    err_k1 = phase_kernel_cases(dev, padded=False)
    err_k2 = phase_kernel_cases(dev, padded=True)
    gltf, scene = load_scene(dev, large=False)
    phase_golden(dev, gltf, scene)
    params, _, dense_run = phase_dense(dev, gltf, scene)
    counts, default_run, _ = phase_default(dev, gltf, scene, params)
    k1_shipped, err_shipped, shipped_cfg, k3_shipped = phase_shipped(
        dev, gltf, scene, params)
    err_k1 = max(err_k1, err_shipped)
    k1_ms, k1_plain, k1_bound, k1_by, k1_culled = phase_timings(dev, scene,
                                                                params)
    say(f"K1 per frame (4 cascades + main, multimesh): kernel {k1_ms:.4f} "
        f"ms, plain {k1_plain:.4f} ms, bound {k1_bound:.4f} ms, culled "
        f"bound {k1_culled:.4f} ms [{_GPU}]")
    phase_shipped_timings(dev, scene, params, shipped_cfg)
    (large_counts, k2_ms, k2_plain, k2_bound, k2_by, k1_large,
     k2_culled, k3_large) = phase_large(dev)
    say(f"large scene per frame (5 rasters): K2 {k2_ms:.4f} ms, K1 on the "
        f"same rasters {k1_large:.4f} ms, plain {k2_plain:.4f} ms, K2 bound "
        f"{k2_bound:.4f} ms, culled bound {k2_culled:.4f} ms [{_GPU}]")
    g_ms, g_plain, g_lib, g_bound, g_err = phase_gather(dev, scene, params)
    g_frames = phase_gather_frames(dev, scene, params, shipped_cfg)
    k3_per_frame = {"dense": dense_run["k3"], "default": default_run["k3"],
                    "shipped": k3_shipped, "large": k3_large}
    say(f"K3 launches per frame on the main paths: {k3_per_frame}")
    cube_counts, _, _ = phase_cube(dev)
    comp_counts, _ = phase_compiled_shipped(dev, scene, params, shipped_cfg)
    phase_sdf(dev)
    drv_counts, _, _, _ = phase_driver(dev)
    app_counts = {k: cube_counts[k] + comp_counts[k] + drv_counts[k]
                  for k in cube_counts}
    say(f"launches on the app paths (cube, compiled shipped, driver; "
        f"warm-ups and captures): {app_counts}")
    say(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [
        dict(name="raster_table", route="cuda",
             source="funky_tpu_torch/csrc/raster.cu",
             replaces="funky_tpu/ops/raster_pallas.py:208",
             launches=(counts["raster_table"] + k1_shipped
                       + app_counts["raster_table"]),
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
             launches=(sum(sum(v) for v in k3_per_frame.values())
                       + app_counts["row_gather"]),
             max_abs_err=g_err, ms=g_ms, plain_ms=g_plain,
             bound_ms=g_bound, bound_by="bytes", library_ms=g_lib,
             timed_on="PCF tap set: (16, 1080, 1920) int32 rows of 16 B from "
                      "the 268 MB cascade table",
             launches_per_frame=k3_per_frame,
             frame_ms={k: v[0] for k, v in g_frames.items()},
             frame_plain_ms={k: v[1] for k, v in g_frames.items()},
             frame_bound_ms={k: v[2] for k, v in g_frames.items()}),
    ]
    say(_GPU)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
