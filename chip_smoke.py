#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (funky_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
torch. It imports nothing of jax or of the JAX package. Phases (any
failure raises and the script exits non-zero):

1. build the nine kernel sources (csrc/raster.cu: K1 and K2;
   csrc/gather.cu: K3; csrc/overlay.cu: K4; csrc/lightmap.cu: K5;
   csrc/pair_taps.cu: K6; csrc/group_counts.cu: K7; csrc/class_maps.cu:
   K10; csrc/contact.cu: K8 and K9; csrc/quad_pack.cu: K11) with one nvcc
   each, started together, and print the ptxas lines;
1a. K11, the cascade maps' quad packing, vs its plain twin
   (sampling.quad_pack_plain) bit for bit as int32 at the shipped maps'
   4 x 2048^2 and the contact pyramid's (135, 240), with NaN payloads,
   +/-inf and -0.0 along the clamped last row and column; one kernel node
   in a graph; timed by CUDA events behind a sleep beside its byte bound
   and the twin's three cats and a stack (phase_quad_pack);
1b. K3, the frame's row gather, vs its plain twin (take_rows_plain) bit
   for bit on unit cases: f32 rows of 1, 2, 4, 7, 8, 16 and 46, 1-D f32,
   int32, bool and f16 tables, f64 rows, tables 4 and 2 bytes past a
   16-byte boundary, negative and out-of-range indices, an empty index, a
   1-row table;
1c. K6 (the shadow filter's tap sets) and K7 (its per-group pair
   histogram) vs their plain twins bit for bit on synthetic entries
   (phase_filter_cases): PCSS, radius-only, fixed-radius PCF with 16
   Vogel taps and with the 3x3 kernel on the packed 2048^2 maps with
   edge entries (NaN, infinite and far-off uv, texel boundaries) and
   through a window at an origin past S - Wc; K7 at the 1080p pair shape,
   a ragged length and an unaligned view;
2. K1 and K2 vs their plain torch twin on numpy-seeded random triangles
   (degenerate and w-culled ones included) at small and at the main
   path's shapes: full capacity, an overflowing tight capacity, a row
   slab, coplanar equal-depth duplicates, a long bin (4,000 small
   triangles in one tile), a ragged 250x130 framebuffer and tiles smaller
   than the kernels' rectangle, each on K12's bins against the plain
   binning's. K2 is reached by patching ops/raster.py's table limit
   (32 MiB) to 0. tri_id and depth bit-equal;
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
   synth_shadow_maps=True)), autotuned over frame.tuning_poses(params,
   24) (bench_poses(params, 24), then bench.py's motion run of 24 poses)
   by utils/autotune.py's tune_raster_capacities and
   tune_sparse_capacities (called directly, so a failure fails the run;
   the tune over bench_poses alone is timed too). Prints the tuned config,
   the occupancy and each cascade's light-fetch entries with the tap caps
   JAX's rule and the port's give. 8 chained committed frames (2 parked,
   6 orbit): no host sync, K1 launched once per nonzero occluder window
   plus once for the main pass in every frame, K1 == plain bit for bit on
   every recorded raster, the sync count torch's sync debug mode reports
   for one frame; K3 on every frame, and the same committed frames with the
   plain row gather equal bit for bit; then the same poses with
   committed=False: equal bit for bit; then (check_tuned_and_chained)
   the tuned poses as the autotune renders them, and the chained
   trajectory: 2 parked frames and orbit poses 0..47, twice the tuned
   motion run. Each frame is polled before it is rendered
   (diagnostics.probe_occupancy against the state the frame carries,
   the pairs of the band blocks a committed frame drops counted):
   capacity_overflows names nothing but the band-block budget, and
   committed == cond'd bit for bit on every frame;
6. the large scene (tests/torch_scenes.build_large_glb: 73,754
   triangles, 4.6 MiB tables within the table limit): 3 chained
   GltfConfig() frames, K12 and K1 launch 5 times per frame and K2
   never, K3 on every frame; one frame through the plain binning and
   raster and the frames with the plain row gather are equal to the K1
   run; the rastered deployment (phase_large_committed) tuned, replayed,
   and again with the table limit at 0 (K2 on K12's pre-gathered bins):
   all equal; K12 == the twin binning on its recorded calls and timed at
   its tuned shapes and the shipped ones (phase 5b) beside its byte
   bound and the twin; K1, K2 and the plain raster timed on
   the frame's own rasters, with the survivors of the kernels' exact cull
   counted by its plain twin (ops/raster.py::subtile_keep) for a
   culled-work bound;
7. K3 at the dense shadow filter's tap shape: a (4*2048*2048, 4) f32
   table and 16 x 1080 x 1920 indices (uniform, one PCF tap set recorded
   from the dense frame's plain tap twins, which gather through K3 as the
   frame did before K6), and a table that fits in L2; bit-equal to the
   plain gather, timed beside torch's `table[idx]` and the plain twin;
   then every K3 call of one dense and one shipped frame, recorded and
   replayed: the summed device time per frame against its byte bound;
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
10b. the perf modes of the shipped configuration, each autotuned on its
   own over tuning_poses(params, 24) (bench.py:203-212 re-tunes half-res
   shadows so): half_res_shadows, shadow_eval_scale=4, and
   __graft_entry__'s trio light_space_ground_shadows +
   skip_backfacing_shadows + synth_shadow_maps. 8 chained committed frames
   (2 parked, 6 orbit): no host sync, K1 once per occluder window + main
   and == plain on every raster, K3 == the plain row gather, finite with
   shadow on the ground; the same poses cond'd, == committed bit for
   bit; the tuned poses and the chained trajectory as in 5b; the frames
   through compiled_gltf_frame == the eager frames in rgba and every
   FrameState field, the capture's launches the first eager frame's. The
   light-space mode also checks that light-map fetches are counted, times
   the replay with every footprint window against the replay with the
   windows JAX's rule keeps, in turns; K5 launches once per window in
   every frame (the capture counts it too), every light map of a frame
   == the plain twin (build_light_shadow_map_plain) bit for bit, and each
   is timed against the twin by CUDA events (K5 alone behind a sleep,
   each call behind a sleep and as a replayed graph) beside its bound;
11. the SDF frame: compiled_sdf_frame(SdfConfig(960, 540)) over 20 times
   (bench.py:221-251), finite, graph == eager, the 160x96 frame at t = 1
   against tests/goldens/sdf_t1_160x96.png;
12. the FrameDriver at 1920x1080 with the shipped flags on the multimesh
   scene, autotuned, the debug panel on and the retune probe every 4
   frames: 12 steps with camera keys, each == eager render_gltf_frame with
   the driver's config and params bit for bit, readback, save_png to
   local/, save_state / load_state and one more step; fails if a step or
   a probe failed (the driver swallows both by design). Times per step and
   of the panel's render_over; the panel goes through K4 once per
   readback, save_png and render_over; K4 == the plain twin
   (rasterize_overlay_plain) bit for bit on the driver's panel, on one
   with every checkbox toggled and the error line shown, on a full
   2048-row table (more rows than one chunk of K4's tile lists) and on a
   ragged 100x130 panel; render_over at 1080p timed by parts
   (tessellation, table, kernel, composite), K4 by device time on the
   driver's and the toggled panel, the twin on the host clock;
13. the row-sharded frame (funky_tpu_torch/parallel) at the JAX package's
   sharded scale, 1920x1088 with 4 x 2048^2 cascades, 8x128 main and
   128x128 shadow tiles, for GltfConfig()'s flags (3 frames: 1 parked, 2
   orbit) and __graft_entry__'s trio (2 frames): sharded_gltf_frame on a
   one-rank NCCL group, and the stages of 4 slabs composed in one process
   (272 main rows, 512 cascade rows; tests/torch_sharded_worker.py::
   compose_frame), each == render_gltf_frame in rgba, history and depth
   bit for bit. 4 gathers per frame on the raster path, 3 with
   synthesized maps; K1 5 times per slab per raster-path frame (once per
   occluder window plus once per slab with synthesized maps); K3 on every
   frame. Prints eager frame times, the device ms (torch.profiler) of the
   replicated front and of each slab's stages, and each gather's bytes.
   Then the committed frame (the shipped flags and the trio) on the
   one-rank NCCL group as a CUDA graph (sharded_graph): 8 chained frames
   (2 parked, 6 orbit) == the eager sharded frames == render_gltf_frame
   in rgba and every FrameState field, 3 gathers at capture and none on
   a replay, K1 and K3 at capture as the eager frame launches them,
   every raster of the eager frames == the plain raster, and the eager
   frames with the plain row gather == the K3 frames in rgba and every
   FrameState field; eager and replay in turns and the device busy of
   one replay;
14. bench_torch.py, the port of bench.py: its run_primary and
   run_secondaries on the multimesh scene at 1920x1080 with n = 24 and
   r = 1 (the autotune over tuning_poses, the parked and motion runs
   through compiled_gltf_frame, half-res shadows tuned on their own, the
   SDF chain and the cube): one JSON line with bench.py's keys, the
   tuned shipped and half-res configs == those phases 5b and 10b held
   against the plain raster and row gather, one capture of the shipped
   graph replayed by both runs,
   the last motion frame == the same chain through eager
   render_gltf_frame bit for bit, a drained run's host time >= its CUDA
   events; then `python3 bench_torch.py` in a subprocess with
   BENCH_REPEATS=1 (the ground plane alone): exit 0, one JSON line;
15. funky_tpu_torch/entry.py, the port of __graft_entry__.py: entry()'s
   fn for 3 chained poses (the ground plane alone at 1080p), every raster
   == the plain raster, the chain with the plain row gather == the K3
   chain, and compiled_gltf_frame of its config == the chain, in rgba and
   every FrameState field bit for bit; dryrun_multichip(1) on a one-rank
   NCCL group in a spawned process: the toy frame and 2 perf-mode frames
   finite, 4 gathers and 3 per perf-mode frame, K1 and K3 in the rank;
   then both runs again in process on a one-rank NCCL group at the same
   shapes: == the rank's frames, every raster == plain, the plain row
   gather == K3.

Every path that reaches the shadow filter (dense, default, shipped,
large, the perf modes, the sharded runs and the committed sharded eager
frames, entry's chain and the dry run's frames in process) launches K6 on
every frame and K7 once per sparse frame, and its frames are rendered
again with every K6 and K7 call recorded (verify_filter: the inputs held
by reference, unchanged since the call) and held against the plain twins
(passes/shadow_filter.py::_pcss_taps_plain, _pcf_taps_plain,
_group_counts_plain) bit for bit, as many calls as that run launched.
The sparse frames pass each pair group's live count to K6, which
zeroes the slots past it and does no tap work for them. K6 is timed per
dense and per shipped frame, its bound reckoned over the live entries
(the slots beside them), K7 per shipped frame beside torch.bincount of
the same keys (and the syncs torch's debug mode reports for it), with
its launches per call and the node kinds of a CUDA graph that records
one call (one kernel node, no memset).

Every path that reaches the contact shadows or the class maps (dense:
K8 and K9's march; default, shipped committed and cond'd, large, the
perf modes, the sharded runs, entry's chain, the dry run's frames in
process: K8, both K9 and K10; the sparse frames' certificate in its
compact mode, which also writes stage 3's compaction, the polls' in its
mask mode) launches them on every frame, and every K8-K10 call of the
reference runs above, of the cond'd frames, of every tuned-pose and
chained-trajectory check (its polls and both frames), of the driver
phase and of the bench phase's in-process run is held against its plain
twin (passes/contact.py::_contact_front_plain, _contact_certify_plain,
_contact_certify_compact_plain (idx, slot_valid and count),
_contact_march_plain; passes/shadow_classify.py::_class_rows_plain) bit
for bit as it returns (checked_stages, the twin with the plain row
gather), as many calls as the run launched, a call made while a CUDA
graph captures counted apart. Each of the four is timed on one shipped
and one dense frame's calls beside its twin (a replayed graph) and its
bound on this run's data. K10 is also held against its twin at every
tile of K10_TILES on the shipped maps with NaN, +/-inf and BORDER_DEPTH
marks, and K8 on the shipped call's rows re-laid in memory
(phase_stage_cases); K9's compacting certificate on stage-2 slots that
overflow cap3, have no live slot, are all live, or whose count passes
them, its march on seeded rays (hits on probe 0 and 7, after an
out-of-bounds probe, NaN rows) at every lane count, and two replays in a
row of a graph holding the shipped frame's compacting call
(phase_k9_cases).

The scene loads print which route decoded their textures (the native
library of utils/native.py, built from native/ on first use, or the
numpy and PIL decoders).

Launch counters do not move on a graph replay: the app phases count
launches at capture (GraphFrame.launches) and in the warm-up and capture
runs, which the kernels line adds to the main paths' counts, with the
bench and entry phases' (their autotunes, eager frames and captures, and
the dry run's rank, which counts its own).

Before the last line stdout carries the card's nvidia-smi line and a JSON
object describing the kernels; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
import json
import math
import os
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
N_TUNE = 24                # bench.py's run: autotune over tuning_poses(, 24)
N_CHAIN = 48               # the chained check: orbit 0..47 after 2 parked
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


def device_ms(fn, iters: int = 20, sleep_cycles: int = 10_000_000) -> float:
    """Mean device milliseconds of fn() over `iters` runs. The runs are
    enqueued behind a sleep kernel (~5 ms at the default `sleep_cycles`),
    so the events bracket the kernels alone and not the host's cost of
    enqueueing them (cuda_ms includes that wherever a run is shorter than
    its enqueue), as long as the enqueue fits in the sleep. fn must not
    synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_gathers():
    """take_rows and quad_pack run their plain twins on the card (0 K3 and
    0 K11 launches) inside the block: the script's own reference run,
    never the port's path."""
    from funky_tpu_torch.ops import gather_cuda, quad_pack_cuda, sampling

    kernels = gather_cuda.row_gather, quad_pack_cuda.quad_pack
    gather_cuda.row_gather = sampling.take_rows_plain
    quad_pack_cuda.quad_pack = sampling.quad_pack_plain
    try:
        yield
    finally:
        gather_cuda.row_gather, quad_pack_cuda.quad_pack = kernels


@contextlib.contextmanager
def plain_filter_taps():
    """The shadow filter's tap sets run their plain twins on the card (0
    K6 launches) inside the block: the script's own reference, never the
    port's path."""
    from funky_tpu_torch.passes import shadow_filter

    saved = shadow_filter._pcss_taps, shadow_filter._pcf_taps
    shadow_filter._pcss_taps = shadow_filter._pcss_taps_plain
    shadow_filter._pcf_taps = shadow_filter._pcf_taps_plain
    try:
        yield
    finally:
        shadow_filter._pcss_taps, shadow_filter._pcf_taps = saved


def reset_counts() -> None:
    from funky_tpu_torch.ops import (binning_cuda, class_maps_cuda, compact,
                                     contact_cuda, gather_cuda,
                                     group_counts_cuda, lightmap_cuda,
                                     overlay_cuda, pair_taps_cuda,
                                     quad_pack_cuda, raster_cuda)

    binning_cuda.reset_launches()
    class_maps_cuda.reset_launches()
    contact_cuda.reset_launches()
    raster_cuda.reset_launches()
    gather_cuda.reset_launches()
    lightmap_cuda.reset_launches()
    overlay_cuda.reset_launches()
    pair_taps_cuda.reset_launches()
    group_counts_cuda.reset_launches()
    quad_pack_cuda.reset_launches()
    compact.reset_host_syncs()


def read_counts() -> dict:
    """The frame kernels' launch counts, keyed as a captured graph counts
    them (frame.GraphFrame.launches). K4 is read on its own (the driver
    phase): no frame launches it."""
    from funky_tpu_torch import frame

    return frame._launch_counts()


def phase_build() -> None:
    from funky_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build_all(["raster", "gather", "overlay", "lightmap",
                                 "pair_taps", "group_counts", "class_maps",
                                 "contact", "quad_pack", "binning"])
    say(f"build: {', '.join(str(p.relative_to(REPO)) for p in libs.values())}"
        f" in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)"
        f" [{_GPU}]")
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                say(f"  ptxas {name}.cu: {line.strip()}")


# K11's shapes on the main path: the shipped frame's four 2048^2 cascade
# maps, and the contact pyramid's level 0 at 1080p (the depth's 8x8 cells).
QUAD_PACK_SHAPES = ((4, 2048, 2048), (135, 240))


def phase_quad_pack(dev) -> dict:
    """K11 against its plain twin at QUAD_PACK_SHAPES, bit for bit as
    int32 (tests/torch_scenes.quad_pack_maps: NaN payloads, +/-inf and
    -0.0, all along the clamped last row and column), one launch and one
    kernel node a call; then each shape timed behind a sleep (device_ms):
    K11, and the twin's three cats and a stack, beside the byte bound
    (every texel read once, its 16-byte quad written)."""
    import torch

    from funky_tpu_torch.ops import quad_pack_cuda, sampling
    from tests.torch_scenes import quad_pack_maps

    times = {}
    for shape in QUAD_PACK_SHAPES:
        img = torch.from_numpy(quad_pack_maps(sum(shape), shape)).to(dev)
        before = quad_pack_cuda.LAUNCHES
        got = sampling.quad_pack(img)
        sync(dev)
        check(quad_pack_cuda.LAUNCHES - before == 1,
              f"K11 {shape}: {quad_pack_cuda.LAUNCHES - before} launches")
        want = sampling.quad_pack_plain(img)
        check(got.shape == want.shape and torch.equal(
                  got.view(torch.int32), want.view(torch.int32)),
              f"K11 {shape}: not bit-equal to the plain twin")
        nodes = graph_node_kinds(lambda: sampling.quad_pack(img))
        check(nodes == {"kernel": 1}, f"K11 {shape}: graph nodes {nodes}")
        nbytes = img.numel() * 4 * 5
        t = dict(ms=device_ms(lambda: sampling.quad_pack(img)),
                 plain_ms=device_ms(lambda: sampling.quad_pack_plain(img)),
                 bound_ms=nbytes / HBM_BPS * 1e3, bytes=nbytes)
        times[shape] = t
        say(f"K11 {shape}: == the plain twin bit for bit (NaN payloads, "
            f"+/-inf, -0.0), one kernel node; kernel {t['ms']:.4f} ms, "
            f"the twin's cats and stack {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms (bytes: {nbytes} B), "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of it [{_GPU}]")
    return times


def phase_kernel_cases(dev, padded: bool) -> float:
    """K1 (padded=False) or K2 (the table limit patched to 0), each on
    K12's bins, against the plain twins (binning and raster) on every
    case. Returns the max |depth| difference."""
    import torch

    from funky_tpu_torch.ops import binning_cuda, raster, raster_cuda
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
                before = (raster_cuda.LAUNCHES, raster_cuda.PADDED_LAUNCHES,
                          binning_cuda.LAUNCHES)
                tri_id, depth, _ = raster.raster_scene(
                    torch.from_numpy(clip).to(dev),
                    torch.from_numpy(tris).to(dev), w, h, len(tris),
                    RasterConfig(backend=backend, **kw), y0, sh)
                sync(dev)
                k1 = raster_cuda.LAUNCHES - before[0]
                k2 = raster_cuda.PADDED_LAUNCHES - before[1]
                k12 = binning_cuda.LAUNCHES - before[2]
                want = (backend == "cuda")
                check((k1, k2, k12) == ((0, want, want) if padded
                                        else (want, 0, want)),
                      f"{label} {name}: launches K1 {k1}, K2 {k2}, K12 {k12}")
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


@contextlib.contextmanager
def decode_routes():
    """Counts the images the port's decoders offer the native library
    (utils/native.py) while the block runs: decoded there, or declined
    and left to the next rung (PIL, then numpy, for PNG; numpy, then PIL,
    for JPEG)."""
    from funky_tpu_torch.utils import native

    counts = collections.Counter()
    saved = native.decode_png, native.decode_jpeg

    def counting(fn, fmt):
        def run(data):
            out = fn(data)
            route = "native" if out is not None else "declined"
            counts[f"{fmt} {route}"] += 1
            return out
        return run

    native.decode_png = counting(saved[0], "png")
    native.decode_jpeg = counting(saved[1], "jpeg")
    try:
        yield counts
    finally:
        native.decode_png, native.decode_jpeg = saved


def load_scene(dev, large: bool):
    from funky_tpu_torch.models.gltf import GltfScene
    from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
    from funky_tpu_torch.models.scene import build_device_scene
    from funky_tpu_torch.utils import native
    from tests.torch_scenes import build_large_glb

    with tempfile.TemporaryDirectory() as td, decode_routes() as routes:
        path = pathlib.Path(td) / "scene.glb"
        gltf = GltfScene.load(build_large_glb(path) if large
                              else build_multimesh_glb(path,
                                                       two_textures=True))
    lib = (f"built at {native._SO.relative_to(REPO)}" if native.available()
           else "unavailable")
    say(f"{'large' if large else 'multimesh'} scene textures: "
        f"{dict(routes)}; native library {lib}")
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
    ms up to the frame's synchronize, host syncs, K1, K3, K5, K6, K7 and
    K8-K11 (keyed as frame._launch_counts) launches per frame, and the
    peak device memory (GiB)."""
    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import (compact, gather_cuda, group_counts_cuda,
                                     lightmap_cuda, pair_taps_cuda,
                                     raster_cuda)

    state = frame.init_frame_state(cfg, dev)
    out = dict(frames=[], ms=[], wall=[], syncs=[], k1=[], k3=[], k5=[],
               k6=[], k7=[],
               **{k: [] for k in STAGE_KERNELS + ("quad_pack", "binning")})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for p in poses:
        syncs0 = compact.HOST_SYNCS
        k1_0 = raster_cuda.LAUNCHES
        k3_0 = gather_cuda.LAUNCHES
        k5_0 = lightmap_cuda.LAUNCHES
        k6_0, k7_0 = pair_taps_cuda.LAUNCHES, group_counts_cuda.LAUNCHES
        stages0 = frame._launch_counts()
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
        out["k5"].append(lightmap_cuda.LAUNCHES - k5_0)
        out["k6"].append(pair_taps_cuda.LAUNCHES - k6_0)
        out["k7"].append(group_counts_cuda.LAUNCHES - k7_0)
        stages1 = frame._launch_counts()
        for k in STAGE_KERNELS + ("quad_pack", "binning"):
            out[k].append(stages1[k] - stages0[k])
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
          and counts["raster_padded"] == 0
          and counts["binning"] == counts["raster_table"],
          f"dense path: expected {RASTERS_PER_FRAME} K1 and K12 launches "
          f"per frame")
    reset_counts()
    prun = run_frames(scene, poses, dense_config(WIDTH, HEIGHT, SHADOW,
                                                 "torch"), dev)
    counts = read_counts()
    check(counts["raster_table"] + counts["raster_padded"]
          + counts["binning"] == 0,
          "the plain-raster run launched a raster or binning kernel")
    frames_equal(krun, prun, "dense kernel vs plain raster")
    say(f"dense path: kernel run == plain-raster run, all {len(poses)} "
        f"frames bit for bit")
    check_filter_launches(krun, "dense", "dense path", dense=True)
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
    cfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    verify_filter("dense path", lambda: run_frames(scene, poses, cfg, dev))
    FILTER_TIMES["dense"] = time_pair_taps(
        frame_filter_calls(scene, poses[-1], cfg, dev))
    STAGE_TIMES["dense"] = time_stage_kernels(frame_stage_calls(
        scene, poses[-1], cfg, dev))
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
    check_filter_launches(srun, "default", "default path (multimesh)")
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
    verify_filter("default path (multimesh)",
                  lambda: run_frames(scene, poses, default_config(), dev))
    return counts, srun, drun


def autotune_shipped(dev, scene, poses, **flags):
    """bench.py's configuration before tuning (GltfConfig() with committed
    mode and synthesized maps, and `flags`) and after: the raster
    capacities, then the sparse ones over `poses` (frame.tuning_poses:
    bench_poses(params, N_TUNE) and bench.py's motion run), each step
    called directly so that a failure raises. A perf mode is tuned on its
    own from the base, as bench.py:203-212 re-tunes half-res shadows.
    Returns (raster-tuned config, tuned config, occupancy, seconds)."""
    from funky_tpu_torch.utils import autotune

    base = default_config(**{"committed": True, "synth_shadow_maps": True,
                             **flags})
    sync(dev)
    t0 = time.perf_counter()
    raster_cfg = autotune.tune_raster_capacities(scene, poses, base)
    cfg, occ = autotune.tune_sparse_capacities(scene, poses, raster_cfg)
    sync(dev)
    return raster_cfg, cfg, occ, time.perf_counter() - t0


def conded_config(cfg):
    import dataclasses

    return dataclasses.replace(cfg, flags=dataclasses.replace(
        cfg.flags, committed=False))


def chained_trajectory(params):
    """N_PARKED parked frames, then bench.py's motion run over N_CHAIN
    poses: orbit_params(params, i) for i < N_CHAIN, twice the motion run
    the autotune reads, so half its poses are ones it never saw."""
    from funky_tpu_torch import frame

    return [params] * N_PARKED + frame.motion_poses(params, N_CHAIN)


def check_trajectory(dev, scene, traj, cfg, label) -> None:
    """The tuned committed config and the same config cond'd over the
    chained poses `traj`: before each frame the occupancy poll against the
    state the committed frame carries (diagnostics.probe_occupancy, which
    counts the pairs of the band blocks a committed frame drops), whose
    capacity_overflows must name nothing but band_block_capacity, and
    after it committed == cond'd in tri_id, depth, rgba and history, bit
    for bit, with no condition; every K8-K10 call of the polls and frames
    == its plain twin (checked_stages)."""
    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.utils import autotune, diagnostics

    conded = conded_config(cfg)
    sc = frame.init_frame_state(cfg, dev)
    sd = frame.init_frame_state(cfg, dev)
    polls, bad_over, bad_eq = [], [], []
    t0 = time.perf_counter()
    with checked_stages(label):
        for i, p in enumerate(traj):
            occ = diagnostics.probe_occupancy(scene, p, sc, cfg)
            over = autotune.capacity_overflows(cfg, occ)
            polls.append(occ)
            if set(over) - {"band_block_capacity"}:
                bad_over.append((i, over))
            rgba_c, sc, tri_c = frame.render_gltf_frame_ids(scene, p, sc,
                                                            cfg)
            rgba_d, sd, tri_d = frame.render_gltf_frame_ids(scene, p, sd,
                                                            conded)
            for name, a, b in (("tri_id", tri_c, tri_d),
                               ("depth", sc.prev_depth, sd.prev_depth),
                               ("rgba", rgba_c, rgba_d),
                               ("history", sc.shadow_history,
                                sd.shadow_history)):
                if not torch.equal(a.view(torch.int32),
                                   b.view(torch.int32)):
                    bad_eq.append((i, name))
        sync(dev)
    band = sum(1 for o in polls if o["band_blocks"] > o["band_bcap"])

    def peak(key):
        return max(max(np.atleast_1d(o[key])) for o in polls)

    def use(key, cap):
        return f"{peak(key)} (cap {cap})"

    say(f"{label} ({len(traj)} frames, {time.perf_counter() - t0:.1f} s): "
        f"capacity_overflows beyond band_block_capacity on "
        f"{len(bad_over)} frames {bad_over[:6]}; the band budget exceeded "
        f"on {band}; committed vs cond'd "
        f"{bad_eq[:8] or 'all frames bit for bit'}; peaks: pairs "
        f"{use('pairs', cfg.shadow_pen_capacity)}, full-group pairs per "
        f"cascade {tuple(max(o['pairs_per_cascade'][c] for o in polls) for c in range(4))}"
        f" (caps {cfg.shadow_pen_cascade_caps}), taa_need "
        f"{use('taa_need', cfg.taa_need_capacity)}, contact_stage2 "
        f"{use('contact_stage2', cfg.contact_capacity)}, contact_march "
        f"{use('contact_march', cfg.contact_march_capacity)}, light fetches "
        f"{tuple(max(o['light_fetch_per_cascade'][c] for o in polls) for c in range(4))}"
        f" (caps {cfg.light_fetch_caps}), synth window overflows "
        f"{sum(o.get('synth_window_overflow', 0) for o in polls)}")
    check(not bad_over, f"{label}: capacity overflows {bad_over[:6]}")
    check(not bad_eq, f"{label}: committed != cond'd {bad_eq[:8]}")


def check_tuned_and_chained(dev, scene, params, cfg, label) -> None:
    """check_trajectory over the tuned poses as the autotune renders them
    (the first pose twice, then each pose once), then over
    chained_trajectory."""
    from funky_tpu_torch import frame

    check_trajectory(dev, scene,
                     [params] + frame.tuning_poses(params, N_TUNE), cfg,
                     f"{label}, tuned poses")
    check_trajectory(dev, scene, chained_trajectory(params), cfg,
                     f"{label}, chained trajectory ({N_PARKED} parked + "
                     f"orbit 0..{N_CHAIN - 1})")


def check_rasters_bitwise(calls, label) -> float:
    """The kernel each recorded raster's route takes (K1 on a setup table
    within ops/raster.py's TABLE_LIMIT_BYTES, K2 on its pre-gathered bins
    past it) against the plain raster on the same inputs (these launches
    are comparisons, not the main path's). Returns the max |depth|
    difference."""
    import torch

    from funky_tpu_torch.ops import raster
    from funky_tpu_torch.ops.binning import TriangleSetup, gather_bin_data
    from funky_tpu_torch.ops.raster import RasterConfig, _rasterize_torch
    from funky_tpu_torch.ops.raster_cuda import (raster_padded_cuda,
                                                 raster_table_cuda)

    err = 0.0
    for i, c in enumerate(calls):
        args = (c["w"], c["h"], c["th"], c["tw"], c["y0"])
        bin_data = gather_bin_data(TriangleSetup(data=c["table"], valid=None),
                                   c["bins"])
        if c["table"].shape[0] * 64 <= raster.TABLE_LIMIT_BYTES:
            name = "K1"
            tri_k, dep_k = raster_table_cuda(c["table"], c["bins"],
                                             c["counts"], *args)
        else:
            name = "K2"
            tri_k, dep_k = raster_padded_cuda(bin_data, c["counts"], *args)
        tri_p, dep_p = _rasterize_torch(
            bin_data, c["bins"], c["counts"], c["y0"], c["w"], c["h"],
            RasterConfig(tile_h=c["th"], tile_w=c["tw"], backend="torch"))
        err = max(err, float((dep_k - dep_p).abs().max()))
        check(torch.equal(tri_k, tri_p)
              and torch.equal(dep_k.view(torch.int32),
                              dep_p.view(torch.int32)),
              f"{label}: raster {i} ({c['w']}x{c['h']}, tiles {c['th']}x"
              f"{c['tw']}): {name} differs from the plain raster")
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
    from funky_tpu_torch.utils import autotune

    label = "shipped path (multimesh)"
    *_, pose_tune_s = autotune_shipped(dev, scene,
                                       frame.bench_poses(params, N_TUNE))
    raster_cfg, cfg, occ, tune_s = autotune_shipped(
        dev, scene, frame.tuning_poses(params, N_TUNE))
    base = default_config(committed=True, synth_shadow_maps=True)
    tuned = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if getattr(cfg, f.name) != getattr(base, f.name)}
    say(f"{label}: autotune over bench_poses(params, {N_TUNE}) alone took "
        f"{pose_tune_s:.3f} s, over tuning_poses(params, {N_TUNE}) (those "
        f"and bench.py's motion run of {N_TUNE} poses) {tune_s:.3f} s "
        f"[{_GPU}]")
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
    check_filter_launches(crun, "shipped", label)
    with plain_gathers():
        grun = run_frames(scene, poses, cfg, dev)
    check_gathers(crun, grun, label)
    err = check_rasters_bitwise(calls, label)
    n_bins = check_bins(calls, label)
    say(f"{label}: K1 == plain raster bit for bit on all {len(calls)} "
        f"recorded rasters ({n_win * len(poses)} window rasters); K12 == "
        f"the twin on all {n_bins} binnings (bins, counts, drops)")
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

    reset_counts()
    with checked_stages(f"{label}, cond'd"):
        drun = run_frames(scene, poses, conded_config(cfg), dev)
    say_branches(f"{label}, cond'd, frame poses")
    diffs = frames_diff(crun, drun)
    say(f"{label}, frame poses: committed vs cond'd: "
        f"{diffs or 'all frames bit for bit'}")
    check(not diffs, f"{label}, frame poses: committed != cond'd")
    # the tuned and the chained poses, each frame polled (the chained
    # trajectory starts with the frame poses)
    check_tuned_and_chained(dev, scene, params, cfg, label)
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
    verify_filter(label, lambda: run_frames(scene, poses, cfg, dev))
    calls = frame_filter_calls(scene, poses[-1], cfg, dev)
    FILTER_TIMES["shipped"] = time_pair_taps(calls)
    FILTER_TIMES["histogram"] = time_group_counts(calls)
    calls = frame_stage_calls(scene, poses[-1], cfg, dev)
    STAGE_TIMES["shipped"] = time_stage_kernels(calls)
    phase_stage_cases(dev, calls)
    phase_k9_cases(dev, calls)
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
    time_bins("shipped", calls, "shipped path")
    win = [r for r in rows if (r["th"], r["tw"]) == (128, 128)]
    ms = sum(r["K1"] for r in win)
    say(f"shipped path: {len(win)} window rasters per frame: K1 {ms:.4f} ms "
        f"device time, plain {sum(r['plain'] for r in win):.4f} ms; with the "
        f"main raster K1 {sum(r['K1'] for r in rows):.4f} ms [{_GPU}]")
    return ms


def record_raster_calls(fn):
    """Run fn() and return, per raster it makes, its setup (and setup
    table), bins, counts, capacity and the kernel's framebuffer
    arguments, and which binning made the bins: "K12" or the twin."""
    from funky_tpu_torch.ops import binning_cuda, raster

    calls = []
    saved = raster.bin_triangles, binning_cuda.bin_triangles

    def recorder(bin_fn, name):
        def record(setup, width, height, tile_h, tile_w, capacity,
                   y_offset=0, drops=None):
            bins, counts = bin_fn(setup, width, height, tile_h, tile_w,
                                  capacity, y_offset, drops)
            calls.append(dict(setup=setup, table=setup.data, bins=bins,
                              counts=counts, w=width, h=height, th=tile_h,
                              tw=tile_w, cap=capacity, y0=y_offset,
                              binning=name))
            return bins, counts
        return record

    raster.bin_triangles = recorder(saved[0], "twin")
    binning_cuda.bin_triangles = recorder(saved[1], "K12")
    try:
        fn()
    finally:
        raster.bin_triangles, binning_cuda.bin_triangles = saved
    return calls


# K12's device times (and the twin's, and the byte bound) per frame of
# the shipped and the rastered configurations, at their tuned shapes.
BIN_TIMES: dict = {}
# [binnings held against the twin, entries that differed] over the run
BIN_CHECKED = [0, 0]
DROP_PROBE = "raster.capacity"


def bin_args(c) -> tuple:
    return c["w"], c["h"], c["th"], c["tw"], c["cap"], c["y0"]


def check_bins(calls, label) -> int:
    """Each recorded K12 call against the twin on the same setup (these
    launches are comparisons, not the main path's): the recorded bins and
    counts, and those of both again with their drops added to one
    counter, bit for bit. Adds the calls held and the entries that
    differed (bins, counts and drop totals) to BIN_CHECKED; returns the
    calls held."""
    import torch

    from funky_tpu_torch.ops import binning, binning_cuda
    from funky_tpu_torch.utils import profiling

    def dropped(fn, dev):
        before = profiling.drop_counts(dev)[DROP_PROBE]
        out = fn()
        return out, profiling.drop_counts(dev)[DROP_PROBE] - before

    k12 = [c for c in calls if c["binning"] == "K12"]
    check(k12 and len(k12) == len(calls),
          f"{label}: {len(k12)} of {len(calls)} rasters binned by K12")
    for i, c in enumerate(k12):
        dev = c["table"].device
        args = bin_args(c)
        (kb, kc), kd = dropped(lambda: binning_cuda.bin_triangles(
            c["setup"], *args, drops=DROP_PROBE), dev)
        (tb, tc), td = dropped(lambda: binning.bin_triangles(
            c["setup"], *args, drops=DROP_PROBE), dev)
        differ = sum(int((a != b).sum()) if a.shape == b.shape
                     else max(a.numel(), b.numel()) for a, b in (
                         (c["bins"], tb), (c["counts"], tc), (kb, tb),
                         (kc, tc))) + int(kd != td)
        BIN_CHECKED[0] += 1
        BIN_CHECKED[1] += differ
        check(differ == 0,
              f"{label}: K12 call {i} {args} differs from the twin in "
              f"{differ} entries (drops {kd} against {td})")
    return len(k12)


def bin_bound(c) -> tuple:
    """(bound ms, bytes) of one binning: the AABB columns and the valid
    mask read once, the bins (with their -1 fill) and counts written."""
    rows = c["table"].shape[0]
    nbytes = 17 * rows + 4 * c["bins"].numel() + 4 * c["counts"].numel()
    return nbytes / HBM_BPS * 1e3, nbytes


def time_bins(key, calls, label, plain_iters=3) -> dict:
    """K12 and the twin on one frame's recorded calls, device time behind
    a sleep, beside K12's byte bound; K12 records three kernel nodes a
    call. Sums into BIN_TIMES[key]."""
    from funky_tpu_torch.ops import binning, binning_cuda

    t = dict(calls=len(calls), ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0)
    for c in calls:
        args = bin_args(c)
        ms = device_ms(lambda: binning_cuda.bin_triangles(c["setup"], *args))
        plain = device_ms(lambda: binning.bin_triangles(c["setup"], *args),
                          iters=plain_iters)
        b, nbytes = bin_bound(c)
        say(f"{label}: K12 ({c['table'].shape[0]} rows, tiles {c['th']}x"
            f"{c['tw']} over {c['w']}x{c['h']}, bins {tuple(c['bins'].shape)}"
            f", fullest {int(c['counts'].max())}): {ms:.4f} ms, the twin "
            f"{plain:.4f} ms, bound {b:.5f} ms ({nbytes} B) [{_GPU}]")
        t["ms"] += ms
        t["plain_ms"] += plain
        t["bound_ms"] += b
        t["bytes"] += nbytes
    big = max(calls, key=lambda c: c["bins"].numel())
    nodes = graph_node_kinds(lambda: binning_cuda.bin_triangles(
        big["setup"], *bin_args(big)))
    check(nodes == {"kernel": 3}, f"{label}: K12 graph nodes {nodes}")
    say(f"{label}: K12 per frame ({len(calls)} calls) {t['ms']:.4f} ms "
        f"device time, the twin {t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.5f} ms (bytes: {t['bytes']} B), "
        f"{100 * t['bound_ms'] / t['ms']:.1f}% of it; graph nodes a call "
        f"{nodes} [{_GPU}]")
    BIN_TIMES[key] = t
    return t


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
    """GltfConfig() on the large scene: every raster takes K1 on K12's
    bins (its 4.6 MiB tables are within the table limit). Returns (launch
    counts, per-frame sums of K2 ms, plain ms, bound ms, bound_by, K1 ms
    on the same rasters, culled bound ms, K3 launches per frame, K2
    launches of the limit-0 runs)."""
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
    check(counts["raster_table"] == RASTERS_PER_FRAME * len(poses)
          and counts["binning"] == counts["raster_table"]
          and counts["raster_padded"] == 0,
          "large scene: expected 5 K12 and 5 K1 launches and no K2 launch "
          "per frame")
    check_filter_launches(krun, "large", "large scene")
    prun = run_frames(scene, poses[:1], default_config("torch"), dev)
    krun1 = dict(krun, frames=krun["frames"][:1])
    frames_equal(krun1, prun, "large scene K1 vs plain raster")
    say("large scene: the first frame through the plain binning and raster "
        "== the K12 and K1 run, tri_id, depth, rgba and history bit for "
        "bit")
    with plain_gathers():
        grun = run_frames(scene, poses, default_config(), dev)
    check_gathers(krun, grun, "large scene")
    check_image(krun, poses, default_config(), dev, "large scene",
                on_ground=False)
    report(f"large-scene default frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2", krun)
    say(f"large scene, plain raster frame: {prun['ms'][0]:.3f} ms [{_GPU}]")
    verify_filter("large scene", lambda: run_frames(scene, poses,
                                                    default_config(), dev))
    k2_launches = phase_large_committed(dev, scene, params)

    cfg = default_config()
    calls = record_raster_calls(lambda: frame.render_gltf_frame(
        scene, poses[-1], frame.init_frame_state(cfg, dev), cfg))
    check(len(calls) == RASTERS_PER_FRAME, f"{len(calls)} rasters per frame")
    rows = time_rasters(calls, plain_iters=1)
    bounds = [say_raster("large raster", r, ("K1", "K2"), padded=True)
              for r in rows]
    by = ("bytes" if sum(x[1] for x in bounds) / HBM_BPS
          >= sum(x[2] for x in bounds) / FP32_OPS else "operations")
    return (counts, sum(r["K2"] for r in rows),
            sum(r["plain"] for r in rows), sum(b[0] for b in bounds), by,
            sum(r["K1"] for r in rows), sum(b[3] for b in bounds), krun["k3"],
            k2_launches)


# Rows of the synthetic setup tables phase_table_route times K1 against
# the pre-gather and K2 on: the rastered frame's 74,880, then 16, 32
# (TABLE_LIMIT_BYTES), 64 and 128 MiB tables.
ROUTE_ROWS = (74_880, 262_144, 524_288, 1_048_576, 2_097_152)


def phase_table_route(dev) -> list:
    """The route at ops/raster.py's TABLE_LIMIT_BYTES, measured: for each
    of ROUTE_ROWS, that many random triangles of up to 6 pixels spread
    over a 1920x1080 frame at the main pass's 32x128 tiles, binned by K12
    at the fullest tile's capacity; K1 on the bins against the pre-gather
    (binning.gather_bin_data) and K2 on its rows, device times behind a
    sleep (the binning, which both routes share, is left out); K1 == K2
    bit for bit. Returns one dict a table size."""
    import torch

    from funky_tpu_torch.ops import binning, binning_cuda, raster
    from funky_tpu_torch.ops.raster_cuda import (raster_padded_cuda,
                                                 raster_table_cuda)

    w, h, th, tw = 1920, 1080, 32, 128
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    out = []
    for t in ROUTE_ROWS:
        g = torch.Generator(device=dev).manual_seed(t)
        centre = torch.rand((t, 1, 2), device=dev, generator=g) * size
        pts = centre + 6.0 * (torch.rand((t, 3, 2), device=dev,
                                         generator=g) - 0.5)
        z = 0.05 + 0.9 * torch.rand((t, 3, 1), device=dev, generator=g)
        tri_clip = torch.cat([pts / size * 2.0 - 1.0, z, torch.ones_like(z)],
                             dim=-1)
        setup = binning.triangle_setup_corners(tri_clip, w, h)
        del tri_clip, pts, centre, z
        cap = int(binning_cuda.bin_counts(setup, w, h, th, tw).max())
        bins, counts = binning_cuda.bin_triangles(setup, w, h, th, tw, cap)
        args = (w, h, th, tw, 0)
        k1_ms = device_ms(lambda: raster_table_cuda(setup.data, bins, counts,
                                                    *args))
        gather_ms = device_ms(lambda: binning.gather_bin_data(setup, bins))
        rows = binning.gather_bin_data(setup, bins)
        k2_ms = device_ms(lambda: raster_padded_cuda(rows, counts, *args))
        k1 = raster_table_cuda(setup.data, bins, counts, *args)
        k2 = raster_padded_cuda(rows, counts, *args)
        check(all(bits_equal(a, b) for a, b in zip(k1, k2)),
              f"table route, {t} rows: K2 differs from K1")
        table = t * 64
        r = dict(rows=t, table_mib=table / 2**20, capacity=cap,
                 entries=int(counts.sum()), k1_ms=k1_ms,
                 pregather_ms=gather_ms, k2_ms=k2_ms,
                 route="K1" if table <= raster.TABLE_LIMIT_BYTES
                 else "pre-gather + K2")
        say(f"table route: {t} rows ({r['table_mib']:.1f} MiB, capacity "
            f"{cap}, {r['entries']} entries): K1 {k1_ms:.4f} ms, pre-gather "
            f"{gather_ms:.4f} + K2 {k2_ms:.4f} = {gather_ms + k2_ms:.4f} ms;"
            f" the limit takes {r['route']} [{_GPU}]")
        out.append(r)
        del setup, bins, counts, rows, k1, k2
        torch.cuda.empty_cache()
    return out


def ids_graph(scene, cfg, params, state):
    """(GraphFrame, inputs) of render_gltf_frame_ids on `cfg`, recorded as
    compiled_gltf_frame records the frame (the state donated), with the
    main pass's tri_id as its last output."""
    from funky_tpu_torch import frame

    n = len(frame._PARAM_FIELDS)
    inputs = [getattr(params, f) for f in frame._PARAM_FIELDS] + list(state)

    def fn(*xs):
        rgba, new, tri_id = frame.render_gltf_frame_ids(
            scene, frame.GltfParams(*xs[:n]), frame.FrameState(*xs[n:]),
            cfg)
        return (rgba,) + tuple(new) + (tri_id,)

    return frame.GraphFrame(fn, inputs,
                            {1 + k: n + k for k in range(len(state))}), n


def graph_frames(scene, cfg, poses, dev):
    """run_frames's per-frame (tri_id, depth, rgba, history) host copies
    through ids_graph's replays, chained from the initial state, and the
    GraphFrame."""
    from funky_tpu_torch import frame

    g, n = ids_graph(scene, cfg, poses[0], frame.init_frame_state(cfg, dev))
    out = dict(frames=[], ms=[])
    for p in poses:
        inputs = [getattr(p, f) for f in frame._PARAM_FIELDS] + g.static[n:]
        outs, _, ev = timed(lambda: g(inputs), dev)
        out["ms"].append(ev)
        state = frame.FrameState(*g.static[n:])
        out["frames"].append(tuple(x.cpu().numpy() for x in (
            outs[-1], state.prev_depth, outs[0], state.shadow_history)))
    return out, g


def phase_large_committed(dev, scene, params):
    """The rastered deployment (benchmark/configs/rastered.json) on the
    large scene: committed, synthesized maps off, autotuned over
    frame.tuning_poses. Its CUDA graph (K12 and K1 captured) == the eager
    frames, tri_id, depth, rgba and history bit for bit, over parked and
    orbit poses, and so do the eager frames and the graph with the table
    limit at 0 (K12's bins pre-gathered for K2); compiled_gltf_frame (the
    benchmark's path) == eager on rgba and every state field; at the
    tuned shapes K12 == the twin binning, K1 == the plain raster and K2 ==
    K1, K3 and K11 == the plain gathers, K6-K10 == their twins; the drop
    counters read 0 over the replays; with each raster's bin capacity and
    the clip capacity halved, the replays add what the eager frame drops.
    Returns the K2 launches of the limit-0 eager frames."""
    import dataclasses
    import functools

    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import raster
    from funky_tpu_torch.ops.binning import TriangleSetup, gather_bin_data
    from funky_tpu_torch.ops.raster_cuda import (raster_padded_cuda,
                                                 raster_table_cuda)
    from funky_tpu_torch.utils import profiling

    label = "large scene, rastered committed frame"
    _, cfg, occ, tune_s = autotune_shipped(
        dev, scene, frame.tuning_poses(params, N_TUNE),
        synth_shadow_maps=False)
    say(f"{label}: tuned in {tune_s:.1f} s: clip {cfg.clip_capacity}, main "
        f"bins {cfg.raster.capacity}, cascade bins "
        f"{cfg.shadow_raster.capacity}; occupancy drops {occ.get('drops')}")
    poses = poses_for(params, N_PARKED, N_ORBIT)
    reset_counts()
    erun = run_frames(scene, poses, cfg, dev)
    e_counts = read_counts()
    check(e_counts["raster_table"] == RASTERS_PER_FRAME * len(poses)
          and e_counts["binning"] == e_counts["raster_table"]
          and e_counts["raster_padded"] == 0,
          f"{label}: expected 5 K12 and 5 K1 launches a frame and no K2: "
          f"{e_counts}")
    drops0 = profiling.drop_counts(dev)
    grun, g = graph_frames(scene, cfg, poses, dev)
    drops1 = profiling.drop_counts(dev)
    check(g.launches["raster_table"] == RASTERS_PER_FRAME
          and g.launches["binning"] == RASTERS_PER_FRAME
          and g.launches["raster_padded"] == 0,
          f"{label}: capture launches {g.launches}")
    frames_equal(erun, grun, f"{label}: graph vs eager")
    # the K2 route: the table limit at 0 pre-gathers K12's bins for K2
    saved = raster.TABLE_LIMIT_BYTES
    raster.TABLE_LIMIT_BYTES = 0
    try:
        reset_counts()
        k2run = run_frames(scene, poses, cfg, dev)
        k2_counts = read_counts()
        k2grun, g2 = graph_frames(scene, cfg, poses, dev)
    finally:
        raster.TABLE_LIMIT_BYTES = saved
    check(k2_counts["raster_padded"] == RASTERS_PER_FRAME * len(poses)
          and k2_counts["binning"] == k2_counts["raster_padded"]
          and k2_counts["raster_table"] == 0
          and g2.launches["raster_padded"] == RASTERS_PER_FRAME
          and g2.launches["raster_table"] == 0,
          f"{label}, table limit 0: launches {k2_counts}, at capture "
          f"{g2.launches}")
    frames_equal(erun, k2run, f"{label}: K1 route vs K2 route, eager")
    frames_equal(grun, k2grun, f"{label}: K1 route vs K2 route, replayed")
    say(f"{label}: with the table limit at 0 (5 K2 launches a frame on "
        f"K12's pre-gathered bins, none of K1) the eager frames and the "
        f"graph == the K1 route's, bit for bit; eager ms "
        f"{[round(x, 3) for x in k2run['ms']]}, replay ms "
        f"{[round(x, 3) for x in k2grun['ms']]}, against the K1 route's "
        f"replay ms {[round(x, 3) for x in grun['ms']]} [{_GPU}]")
    check(drops1 == drops0, f"{label}: the replays dropped entries: "
          f"{drops0} -> {drops1}")
    say(f"{label}: graph == eager, tri_id, depth, rgba and history of all "
        f"{len(poses)} frames bit for bit; drop counters unchanged over "
        f"the replays ({drops1}); eager ms {[round(x, 3) for x in erun['ms']]}"
        f", replay ms {[round(x, 3) for x in grun['ms']]} [{_GPU}]")
    names = ("rgba",) + frame.FrameState._fields
    eager = gltf_frames(functools.partial(frame.render_gltf_frame, cfg=cfg),
                        scene, poses, cfg, dev)
    comp = gltf_frames(frame.compiled_gltf_frame(cfg), scene, poses, cfg,
                       dev)
    for i, (fe, fg) in enumerate(zip(eager["frames"], comp["frames"])):
        for name, a, b in zip(names, fe, fg):
            check(bits_equal(a, b), f"{label}: compiled_gltf_frame frame "
                  f"{i} {name} differs from the eager frame")
    say(f"{label}: compiled_gltf_frame == eager, rgba and every state field "
        f"of all {len(poses)} frames; peak {comp['peak_gib']:.3f} GiB "
        f"allocated, {comp['reserved_gib']:.3f} reserved [{_GPU}]")
    # the path's kernels against their plain versions at the tuned shapes
    # (the script's reference runs: their launches are not counted): K2 on
    # a parked and an orbit frame's rasters, K3 and K11 against the plain
    # gathers, K6-K10 against their twins
    check(all(k > 0 for k in erun["k6"]),
          f"{label}: a frame launched no K6: {erun['k6']}")
    two = [poses[0], poses[-1]]
    calls = record_raster_calls(lambda: run_frames(scene, two, cfg, dev))
    check(len(calls) == RASTERS_PER_FRAME * len(two),
          f"{label}: {len(calls)} rasters recorded")
    err = check_rasters_bitwise(calls, label)
    for i, c in enumerate(calls):
        args = (c["w"], c["h"], c["th"], c["tw"], c["y0"])
        k1 = raster_table_cuda(c["table"], c["bins"], c["counts"], *args)
        k2 = raster_padded_cuda(gather_bin_data(
            TriangleSetup(c["table"], None), c["bins"]), c["counts"], *args)
        check(all(bits_equal(a, b) for a, b in zip(k1, k2)),
              f"{label}: raster {i}: K2 differs from K1")
    n_bins = check_bins(calls, label)
    shapes = sorted({(c["table"].shape[0], c["bins"].shape[1], c["w"],
                      c["h"]) for c in calls})
    say(f"{label}: K1 == plain raster and K2 == K1 bit for bit on all "
        f"{len(calls)} rasters of {len(two)} frames (max |depth| difference "
        f"{err}); K12 == the twin on all {n_bins} binnings; (table rows, bin "
        f"capacity, width, height): {shapes}")
    time_bins("rastered", calls[-RASTERS_PER_FRAME:], label)
    with plain_gathers():
        prun = run_frames(scene, poses, cfg, dev)
    check_gathers(erun, prun, label)
    verify_filter(label, lambda: run_frames(scene, poses, cfg, dev))
    half = dataclasses.replace(
        cfg, clip_capacity=cfg.clip_capacity // 2,
        raster=dataclasses.replace(cfg.raster,
                                   capacity=cfg.raster.capacity // 2),
        shadow_raster=dataclasses.replace(
            cfg.shadow_raster, capacity=cfg.shadow_raster.capacity // 2))
    d0 = profiling.drop_counts(dev)
    run_frames(scene, poses[:1], half, dev)
    d1 = profiling.drop_counts(dev)
    run_frames(scene, poses[1:], half, dev)
    d2 = profiling.drop_counts(dev)
    graph_frames(scene, half, poses, dev)
    d3 = profiling.drop_counts(dev)
    first = {k: d1[k] - d0[k] for k in d0}
    eager_drop = {k: d2[k] - d0[k] for k in d0}
    replay_drop = {k: d3[k] - d2[k] for k in d0}
    check(all(v > 0 for v in eager_drop.values()),
          f"{label}: halved capacities dropped nothing on {len(poses)} "
          f"poses: {eager_drop}")
    # the graph's eager warm-up renders the first pose once more
    check(replay_drop == {k: v + first[k] for k, v in eager_drop.items()},
          f"{label}: halved capacities: eager drops {eager_drop} (first "
          f"pose {first}), warm-up and replays {replay_drop}")
    say(f"{label}: halved capacities drop {eager_drop} over {len(poses)} "
        f"eager frames, the same in their replays")
    return k2_counts["raster_padded"]


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
    # (nearest), then the PCF compare; the first cascade's compare. The
    # frame's tap sets run in K6, so they are recorded from its plain
    # twins, which gather the same rows through K3.
    with plain_filter_taps():
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
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


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
    check(g.launches["raster_table"] > 0 and g.launches["row_gather"] > 0
          and g.launches["pair_taps"] > 0 and g.launches["group_counts"] == 1
          and g.launches["quad_pack"] == 2,
          f"{label}: K1, K3, K6 or K7 missing at capture, or K11 not twice "
          f"(the cascade maps, the contact pyramid)")
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


# The perf-mode flags on top of the shipped configuration: bench.py's
# half-res secondary line (bench.py:203-216), the quarter rate, and
# __graft_entry__'s light-space trio (__graft_entry__.py:165-167).
PERF_MODES = {
    "half_res": dict(half_res_shadows=True),
    "quarter_res": dict(shadow_eval_scale=4),
    "lightspace": dict(light_space_ground_shadows=True,
                       skip_backfacing_shadows=True, synth_shadow_maps=True),
}


def light_map_work(args, kwargs, rows):
    """(bytes, FP32 operations) one light map needs on these inputs: the
    haloed window of the raw map read once, the parameters, the (wc^2, 4)
    rows written; per texel the receiver (7) and, by the kernel's own
    path: 16 blocker taps (4 each) and, where a tap hit, the penumbra
    (12), the rung weights (4 each) and 16 compare taps (18 each, + 6 to
    fold) for each rung whose weight this texel's penumbra makes nonzero;
    or the 3x3 kernel (3 per tap + 2) or 16 Vogel taps (18 each + 2) of
    fixed-radius PCF."""
    import torch

    from funky_tpu_torch.ops import lightmap_cuda
    from funky_tpu_torch.passes import shadow_lightspace

    a = inspect.signature(shadow_lightspace.build_light_shadow_map_plain
                          ).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    wc, use_pcss, rungs = a["wc"], a["use_pcss"], a["rungs"]
    wp = wc + 2 * shadow_lightspace.halo_texels(a["max_softness"])
    params = sum(lightmap_cuda.param_sizes(use_pcss, rungs, a["phases"]))
    nbytes = 4 * wp * wp + 4 * params + 16 * wc * wc
    texels = wc * wc
    taps = shadow_lightspace.light_map_taps(a["uni"], use_pcss, rungs,
                                            a["phases"], rows.device)
    if not use_pcss:
        per = 9 * 3 + 2 if bool(taps.small) else 16 * 18 + 2
        return nbytes, texels * (7 + per)
    pen = rows[:, 2]
    hit = pen > 0
    pos = (rungs - 1) * torch.log(pen[hit] / 0.5) / taps.span
    live = sum(int((torch.clamp(1.0 - torch.abs(pos - j), 0.0, 1.0) > 0)
                   .sum()) for j in range(rungs))
    ops = (texels * (7 + 16 * 4) + int(hit.sum()) * (12 + 4 * rungs)
           + live * (16 * 18 + 6))
    return nbytes, ops


def time_light_maps(calls):
    """Per recorded build_light_shadow_map call (one per cascade with a
    window), all by CUDA events: its window size; K5's own device time (the
    kernel's wrapper on the call's recorded arguments, behind a sleep);
    for K5's path (build_light_shadow_map on the frame's tap geometry: the
    parameters' torch ops, then the kernel) and for the plain twin the
    device ms behind a sleep (device_ms; where enqueueing takes longer
    than the sleep, the host's gaps count too) and the device ms of one
    call's kernels back to back, recorded as a CUDA graph and replayed
    (graph_ms: the busy time); and the bound (light_map_work over the
    card's peaks). Returns (those rows, the busy ms of building the tap
    geometry, once per frame)."""
    from funky_tpu_torch.ops import lightmap_cuda
    from funky_tpu_torch.passes import shadow_lightspace

    out = []
    for args, kwargs, _ in calls:
        row = {"wc": args[5]}
        kernel = []
        light_map = lightmap_cuda.light_map

        def record(*a, **kw):
            kernel.append((a, kw))
            return light_map(*a, **kw)

        lightmap_cuda.light_map = record
        try:
            rows = shadow_lightspace.build_light_shadow_map(*args, **kwargs)
        finally:
            lightmap_cuda.light_map = light_map
        (ka, kkw), = kernel
        row["k5_ms"] = device_ms(lambda: light_map(*ka, **kkw))
        for name, fn in (
                ("kernel", lambda: shadow_lightspace.build_light_shadow_map(
                    *args, **kwargs)),
                ("plain", lambda: shadow_lightspace
                 .build_light_shadow_map_plain(*args, **kwargs))):
            row[f"{name}_ms"] = device_ms(fn, iters=3)
            row[f"{name}_graph_ms"] = graph_ms(fn, iters=3)
        nbytes, ops = light_map_work(args, kwargs, rows)
        row["bound_ms"] = max(nbytes / HBM_BPS, ops / FP32_OPS) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BPS > ops / FP32_OPS \
            else "operations"
        out.append(row)
    args, kwargs, _ = calls[0]
    a = inspect.signature(shadow_lightspace.build_light_shadow_map_plain
                          ).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    return out, graph_ms(lambda: shadow_lightspace.light_map_taps(
        a["uni"], a["use_pcss"], a["rungs"], a["phases"], args[0].device),
        iters=3)


def _copied(x):
    """x with every tensor in it (in tuples and named tuples too) copied."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [_copied(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def record_light_maps(fn):
    """Run fn() and return every build_light_shadow_map call it makes as
    (args, kwargs, rows): copies of its arguments taken at the call (a
    chained or sharded frame overwrites its buffers) and the rows it
    returned."""
    from funky_tpu_torch.passes import shadow_lightspace

    calls = []
    build = shadow_lightspace.build_light_shadow_map

    def record(*args, **kwargs):
        copies = (_copied(args), {k: _copied(v) for k, v in kwargs.items()})
        rows = build(*args, **kwargs)
        calls.append(copies + (rows,))
        return rows

    shadow_lightspace.build_light_shadow_map = record
    try:
        fn()
    finally:
        shadow_lightspace.build_light_shadow_map = build
    return calls


def check_light_maps(calls, launched, label) -> float:
    """Every recorded light map (one per K5 launch of the run, `launched`)
    against the plain twin's rows on the same inputs, bit for bit. Returns
    the largest absolute difference."""
    from funky_tpu_torch.passes import shadow_lightspace

    check(len(calls) == launched, f"{label}: {len(calls)} light maps "
          f"recorded, K5 launched {launched} times")
    err = 0.0
    for i, (args, kwargs, rows) in enumerate(calls):
        want = shadow_lightspace.build_light_shadow_map_plain(*args, **kwargs)
        check(bits_equal(rows, want), f"{label}: light map {i} ({args[5]}^2 "
              f"window) differs from the plain twin")
        err = max(err, float((rows - want).abs().max()))
    say(f"{label}: K5 == plain bit for bit on all {len(calls)} light maps "
        f"of the run (windows {sorted({a[5] for a, _, _ in calls})})")
    return err


# The shadow filter's kernels, K6 (the tap sets, passes/shadow_filter.py::
# _pcss_taps / _pcf_taps on CUDA tensors) and K7 (the per-group pair
# histogram, _group_counts): each dispatcher and its plain twin.
FILTER_TWINS = {"_pcss_taps": "_pcss_taps_plain",
                "_pcf_taps": "_pcf_taps_plain",
                "_group_counts": "_group_counts_plain"}
# Every K6 and K7 call held against its twin so far: [calls, max |diff|].
FILTER_CHECKED = {"pair_taps": [0, 0.0], "group_counts": [0, 0.0]}
# K6 and K7 launches of each main path's run: key -> (K6, K7, frames).
FILTER_RUNS: dict = {}
# K6 per dense and per shipped frame, K7 per shipped frame (time_*).
FILTER_TIMES: dict = {}
# Reckoned FP32 operations per entry of a K6 call (csrc/pair_taps.cu): the
# 16 Vogel offsets (4 operations, a sin and a cos at 20 each), a blocker
# tap (16: its uv, the texel setup, the nearest pick, the sums), the
# penumbra (12), a compare tap (27: its uv, the setup, four compares, the
# lerp, the two sums), and the sums' scaling (2).
TAP_OPS = dict(offsets=16 * 44, blocker=16, penumbra=12, compare=27, scale=2)


def _kernel_name(name: str) -> str:
    return "group_counts" if name == "_group_counts" else "pair_taps"


def _tensors(x) -> list:
    """Every tensor in x (in tuples, named tuples and lists too)."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def record_filter_calls(fn):
    """Run fn() and return every K6 and K7 call it makes, as (dispatcher
    name, args, kwargs, outputs, held): the arguments and outputs kept by
    reference, `held` their version counters at the call, so the check
    can tell that nothing wrote them since (a copy of every frame's maps
    would add 268 MB per call)."""
    from funky_tpu_torch.passes import shadow_filter

    calls = []
    saved = {name: getattr(shadow_filter, name) for name in FILTER_TWINS}

    def recorder(name, dispatch):
        def record(*args, **kwargs):
            out = dispatch(*args, **kwargs)
            held = _tensors((args, tuple(kwargs.values()), out))
            calls.append((name, args, kwargs, out,
                          [(t, t._version) for t in held]))
            return out
        return record

    for name, dispatch in saved.items():
        setattr(shadow_filter, name, recorder(name, dispatch))
    try:
        fn()
    finally:
        for name, dispatch in saved.items():
            setattr(shadow_filter, name, dispatch)
    return calls


def check_filter_calls(calls, launched, label) -> None:
    """Every recorded K6 and K7 call against its plain twin on the same
    inputs, bit for bit, with as many calls of each as the run launched
    (`launched`, read_counts() after it); the inputs and outputs unchanged
    since the call."""
    from funky_tpu_torch.passes import shadow_filter

    n = collections.Counter(_kernel_name(c[0]) for c in calls)
    check(n["pair_taps"] == launched["pair_taps"]
          and n["group_counts"] == launched["group_counts"],
          f"{label}: {dict(n)} shadow-filter calls recorded, K6 launched "
          f"{launched['pair_taps']} and K7 {launched['group_counts']} times")
    modes, sizes = collections.Counter(), collections.Counter()
    for i, (name, args, kwargs, out, held) in enumerate(calls):
        check(all(t._version == v for t, v in held),
              f"{label}: a tensor of {name} call {i} was written after it")
        want = getattr(shadow_filter, FILTER_TWINS[name])(*args, **kwargs)
        got = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        check(len(got) == len(want) and all(
            bits_equal(a, b) for a, b in zip(got, want)),
            f"{label}: {name} call {i} ({tuple(got[0].shape)}) differs from "
            f"its plain twin")
        kernel = _kernel_name(name)
        err = max((float((a.double() - b.double()).abs().nan_to_num().max())
                   for a, b in zip(got, want) if a.numel()), default=0.0)
        FILTER_CHECKED[kernel][0] += 1
        FILTER_CHECKED[kernel][1] = max(FILTER_CHECKED[kernel][1], err)
        if kernel == "pair_taps":
            sizes[got[0].numel()] += 1
            window = kwargs.get("window", args[6] if len(args) > 6 else None)
            ro = "(radius_only)" if kwargs.get("radius_only") else ""
            cnt = "" if kwargs.get("count") is None else " counted"
            name = (f"{name}{ro} {'packed' if window is None else 'window'}"
                    f"{cnt}")
        modes[name] += 1
    say(f"{label}: K6 and K7 == their plain twins bit for bit on all "
        f"{n['pair_taps']} tap sets and {n['group_counts']} histograms of "
        f"the run ({dict(modes)})")
    if sizes:
        from funky_tpu_torch.ops import pair_taps_cuda

        say(f"{label}: K6 calls by entries (calls, lanes per entry): "
            + ", ".join(f"{e} ({c}, {pair_taps_cuda.lanes_for(e)})"
                        for e, c in sorted(sizes.items())))


def verify_filter(label, fn) -> dict:
    """fn() (a run the phase has already counted, again) with every K6 and
    K7 call recorded and held against its twin, and every K8-K10 call
    held against its twin as it returns (checked_stages). The script's
    reference run: its launches do not count. Returns its launch
    counts."""
    reset_counts()
    with checked_stages(label):
        calls = record_filter_calls(fn)
    counts = read_counts()
    check_filter_calls(calls, counts, label)
    return counts


def check_filter_launches(run, key, label, dense: bool = False) -> None:
    """The main run of a path (run_frames') reached K6 on every frame, and
    K7 once per sparse frame (never on the dense path); its launches are
    kept under `key` for the kernels line."""
    check(all(k > 0 for k in run["k6"]),
          f"{label}: a frame launched no K6: {run['k6']}")
    check(all(k == (0 if dense else 1) for k in run["k7"]),
          f"{label}: K7 launches per frame {run['k7']}")
    FILTER_RUNS[key] = (sum(run["k6"]), sum(run["k7"]), len(run["k6"]))
    say(f"{label}: K6 launches per frame {run['k6']}, K7 {run['k7']}")
    note_stage_runs(key, {k: sum(run[k]) for k in STAGE_KERNELS},
                    len(run["k6"]), dense, label)
    say(f"{label}: K8-K10 launches per frame "
        + ", ".join(f"{k} {run[k]}" for k in STAGE_KERNELS))


def frame_filter_calls(scene, pose, cfg, dev):
    """The K6 and K7 calls of one frame at `pose`, rendered after one frame
    at the same pose (a chained state, as the main runs' frames have)."""
    from funky_tpu_torch import frame

    state = frame.init_frame_state(cfg, dev)
    _, state = frame.render_gltf_frame(scene, pose, state, cfg)
    return record_filter_calls(
        lambda: frame.render_gltf_frame(scene, pose, state, cfg))


def pair_tap_work(name, args, kwargs):
    """(bytes, FP32 operations, live entries, slots) one K6 call needs on
    these inputs. A call with a live count (a pair group's) does tap work
    for the slots before it only: each live entry's uv, receiver and phi
    (and its layer on the packed maps) read, each distinct quad row the
    live entries' taps read (the union of the rows of the twin's two
    gathers over those entries, counted as K3's distinct-row bytes) read
    once, and the operations per TAP_OPS for the call's mode (fixed-radius
    PCF: 9 or 16 compare taps by the radius); every slot's 16-byte row
    written, and the count read."""
    import torch

    from funky_tpu_torch.passes import shadow_filter

    twin = getattr(shadow_filter, FILTER_TWINS[name])
    a = _bound_args(name, args, kwargs)
    n = a["uv"].numel() // 2
    count = a["count"]
    live = n if count is None else max(0, min(int(count), n))
    gathers = record_gather_calls(lambda: twin(*args, **kwargs))
    rows = torch.unique(torch.cat([
        torch.where(idx < 0, idx + t.shape[0], idx).clamp(
            0, t.shape[0] - 1).reshape(idx.shape[0], -1)[:, :live]
        .reshape(-1) for t, idx in gathers]))
    per_entry = 16 + (0 if a["window"] is not None else 4)
    nbytes = (live * per_entry + 16 * n + 16 * int(rows.numel())
              + (0 if count is None else 4))
    o = TAP_OPS
    if name == "_pcss_taps":
        ops = o["offsets"] + 16 * o["blocker"] + o["penumbra"]
        if not a["radius_only"]:
            ops += 16 * o["compare"] + o["scale"]
    else:
        radius = max(float(a["uni"].shadow_bias[0]), 0.5)
        ops = o["offsets"] + (9 if radius <= 1.25 else 16) * o["compare"] \
            + o["scale"]
    return nbytes, live * ops, live, n


def _bound_args(name, args, kwargs) -> dict:
    """The arguments of a recorded dispatcher call, by name."""
    from funky_tpu_torch.passes import shadow_filter

    a = inspect.signature(getattr(shadow_filter, FILTER_TWINS[name])).bind(
        *args, **kwargs)
    a.apply_defaults()
    return a.arguments


def wrapper_args(name, args, kwargs) -> tuple:
    """pair_taps_cuda.pair_taps' arguments for a recorded dispatcher call,
    as the dispatcher hands them over."""
    a = _bound_args(name, args, kwargs)
    if name == "_pcf_taps":
        mode, recv = "pcf", a["ref"]
    else:
        mode = "radius_only" if a["radius_only"] else "pcss"
        recv = a["receiver"]
    return (a["shadow_maps"], a["layer"], a["uv"], recv, a["phi"],
            a["uni"].shadow_map_size, a["uni"].shadow_bias, mode,
            a["window"], a["count"])


def graph_ms(fn, iters: int = 5) -> float:
    """Device ms of fn() recorded once as a CUDA graph (after a warm-up
    on a side stream) and replayed behind a sleep (device_ms). For the
    plain twins: enqueued one by one, their ~270 launches per call outrun
    the sleep, and the time follows the host (on an H100, five times the
    summed kernel time of the shipped frame's five calls); replayed, they
    run back to back, as a committed frame's graph ran them before K6.
    Host constants (math3d.const) are uploaded in the warm-up and reused
    by the capture, as compiled frames do."""
    import torch

    from funky_tpu_torch import math3d

    with math3d.kept_constants({}):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return device_ms(graph.replay, iters=iters)


# CUgraphNodeType (the driver API's cuda.h) by value.
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def graph_node_kinds(fn) -> dict:
    """{node kind: count} of a CUDA graph that records one call of fn(),
    after one eager call (as compiled frames warm up), read through the
    driver API (cuGraphGetNodes, cuGraphNodeGetType); the graph is never
    replayed."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kinds = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kinds[NODE_KINDS.get(kind.value, str(kind.value))] += 1
    return dict(kinds)


def time_pair_taps(calls) -> dict:
    """The K6 calls of one frame (`calls`, record_filter_calls'): K6
    through its wrapper (pair_taps_cuda.pair_taps on each call's
    arguments) by device time behind a sleep long enough for the host's
    enqueue (device_ms), the plain twins by device time as a replayed CUDA
    graph (graph_ms), each call's live entries against its slots, and the
    bound over the card's peaks of the calls' summed bytes and operations
    on their live entries (pair_tap_work)."""
    from funky_tpu_torch.ops import pair_taps_cuda
    from funky_tpu_torch.passes import shadow_filter

    taps = [c for c in calls if c[0] != "_group_counts"]
    wrapper = [wrapper_args(name, args, kwargs)
               for name, args, kwargs, _, _ in taps]

    def run_wrapper():
        for w in wrapper:
            pair_taps_cuda.pair_taps(*w)

    def run_twins():
        for name, args, kwargs, _, _ in taps:
            getattr(shadow_filter, FILTER_TWINS[name])(*args, **kwargs)

    work = [pair_tap_work(c[0], c[1], c[2]) for c in taps]
    nbytes, ops = sum(w[0] for w in work), sum(w[1] for w in work)
    return dict(
        calls=len(taps), entries=sum(w[3] for w in work),
        live=sum(w[2] for w in work),
        live_per_call=[[w[2], w[3]] for w in work],
        lanes=[pair_taps_cuda.lanes_for(w[3]) for w in work],
        ms=device_ms(run_wrapper, iters=10, sleep_cycles=400_000_000),
        plain_ms=graph_ms(run_twins),
        bytes=nbytes, ops=ops,
        bound_ms=max(nbytes / HBM_BPS, ops / FP32_OPS) * 1e3,
        bound_by="bytes" if nbytes / HBM_BPS > ops / FP32_OPS
        else "operations")


def time_group_counts(calls) -> dict:
    """The K7 call of one frame: K7 and the twin by device time behind a
    sleep; torch.bincount of the same masked keys (the where() outside
    the timing) by CUDA events with its host time, and the synchronising
    calls torch's sync debug mode reports for it; K7's launches per call
    and the node kinds of a graph that records one call (one kernel, no
    memset); the byte bound of this run's data: every `needs` byte read,
    the key of each needed entry (only those are counted), the counts
    written."""
    import torch

    from funky_tpu_torch.ops import group_counts_cuda
    from funky_tpu_torch.passes import shadow_filter

    (_, args, kwargs, _, _), = [c for c in calls if c[0] == "_group_counts"]
    needs, key, n_groups = args
    masked = torch.where(needs, key, n_groups).reshape(-1)
    nbytes = needs.numel() + 4 * int(needs.sum()) + 4 * n_groups
    syncs = count_syncs_reported(
        lambda: torch.bincount(masked, minlength=n_groups + 1))
    before = group_counts_cuda.LAUNCHES
    shadow_filter._group_counts(*args)
    per_call = group_counts_cuda.LAUNCHES - before
    nodes = graph_node_kinds(lambda: shadow_filter._group_counts(*args))
    check(per_call == 1 and nodes == {"kernel": 1},
          f"K7: {per_call} launches per call, graph nodes {nodes}; "
          f"expected one launch, one kernel node")
    return dict(
        entries=needs.numel(), n_groups=n_groups, launches_per_call=per_call,
        graph_nodes=nodes,
        ms=device_ms(lambda: shadow_filter._group_counts(*args)),
        plain_ms=device_ms(lambda: shadow_filter._group_counts_plain(*args)),
        library_ms=cuda_ms(lambda: torch.bincount(
            masked, minlength=n_groups + 1), iters=20),
        library_syncs=len(syncs),
        bound_ms=nbytes / HBM_BPS * 1e3, bound_by="bytes")


# The contact shadows' kernels K8 (passes/contact.py::contact_front) and K9
# (contact_certify and, in its compact mode, contact_certify_compact;
# contact_march), and the class maps' K10 (passes/shadow_classify.py::
# _class_rows): dispatcher -> (module, plain twin). Their launch counters
# are keyed by the dispatchers' names, K10's as "class_maps" and the
# compact mode's as the certificate's.
STAGE_TWINS = {"contact_front": ("contact", "_contact_front_plain"),
               "contact_certify": ("contact", "_contact_certify_plain"),
               "contact_certify_compact": ("contact",
                                           "_contact_certify_compact_plain"),
               "contact_march": ("contact", "_contact_march_plain"),
               "_class_rows": ("shadow_classify", "_class_rows_plain")}
STAGE_KERNELS = ("contact_front", "contact_certify", "contact_march",
                 "class_maps")
# Every K8-K10 call held against its twin so far: kernel -> [calls, max
# |diff|], and the calls counted at a capture (their outputs are a graph's
# until it replays, so they are counted, not compared).
STAGE_CHECKED = {k: [0, 0.0] for k in STAGE_KERNELS}
STAGE_CAPTURED = collections.Counter()
# K8-K10 launches of each main path's run: key -> {kernel: launches,
# "frames": frames}.
STAGE_RUNS: dict = {}
# Reckoned FP32 operations per pixel of K8 (the ray, its clip, the jitter,
# the segment certificate at its four endpoints), per live slot of K9's
# certificate (8 probes; its compact mode's ballot and prefix are integer
# work and not counted) and per marched ray of K9's march (8 linear and 4
# bisection probes: the work of the chain; the speculative tree probes 7
# or 15 midpoints where the chain probes 4, a layout's cost, not the
# function's), and per fine texel of K10 (its rung-3 row and column
# windows, the residuals, and on the pooled maps a quarter of the pools,
# the four rungs' and the rise's windows and the cell maxima).
STAGE_OPS = dict(front=220, certify=8 * 30, march=12 * 60,
                 class_fine=24, class_pooled=158)


def _stage_module(name: str):
    from funky_tpu_torch.passes import contact, shadow_classify

    return {"contact": contact,
            "shadow_classify": shadow_classify}[STAGE_TWINS[name][0]]


def _stage_kernel(name: str) -> str:
    return {"_class_rows": "class_maps",
            "contact_certify_compact": "contact_certify"}.get(name, name)


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _stage_equal(got, want) -> tuple:
    """(equal bit for bit, max |diff|) of two dispatcher results (a tuple
    may hold None: the front's stage-2 mask without a pyramid)."""
    got, want = _outputs(got), _outputs(want)
    ok, err = len(got) == len(want), 0.0
    for a, b in zip(got, want):
        if a is None or b is None:
            ok = ok and a is b
            continue
        ok = ok and bits_equal(a, b)
        if a.numel() and a.shape == b.shape:
            err = max(err, float((a.double() - b.double()).abs()
                                 .nan_to_num().max()))
    return ok, err


@contextlib.contextmanager
def checked_stages(label):
    """Inside the block every K8, K9 and K10 call is held against its plain
    twin on the same inputs right after it returns, bit for bit (the twin
    with the plain row gather, so it launches no K3); a call made while a
    CUDA graph captures is counted (STAGE_CAPTURED), not compared. On
    exit, each kernel's compared and captured calls must equal its
    launches in the block. These comparisons are the script's own: their
    twins launch no kernel of the port."""
    import torch

    from funky_tpu_torch import frame

    counts = collections.Counter()
    saved = {name: getattr(_stage_module(name), name)
             for name in STAGE_TWINS}

    def checked(name, dispatch):
        twin = getattr(_stage_module(name), STAGE_TWINS[name][1])
        kernel = _stage_kernel(name)

        def run(*args, **kwargs):
            out = dispatch(*args, **kwargs)
            if (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                STAGE_CAPTURED[kernel] += 1
                counts[kernel, "captured"] += 1
                return out
            with plain_gathers():
                want = twin(*args, **kwargs)
            ok, err = _stage_equal(out, want)
            shapes = [tuple(o.shape) for o in _outputs(out) if o is not None]
            check(ok, f"{label}: {name} call {counts[kernel]} ({shapes}) "
                  f"differs from its plain twin")
            counts[kernel] += 1
            STAGE_CHECKED[kernel][0] += 1
            STAGE_CHECKED[kernel][1] = max(STAGE_CHECKED[kernel][1], err)
            return out
        return run

    before = frame._launch_counts()
    for name, dispatch in saved.items():
        setattr(_stage_module(name), name, checked(name, dispatch))
    try:
        yield counts
    finally:
        for name, dispatch in saved.items():
            setattr(_stage_module(name), name, dispatch)
    after = frame._launch_counts()
    for k in STAGE_KERNELS:
        launched = after[k] - before[k]
        check(counts[k] + counts[k, "captured"] == launched,
              f"{label}: {k}: {counts[k]} calls held against the twin and "
              f"{counts[k, 'captured']} captured, {launched} launches")
    held = ", ".join(f"{k} {counts[k]}" for k in STAGE_KERNELS)
    captured = sum(counts[k, "captured"] for k in STAGE_KERNELS)
    say(f"{label}: K8, K9 and K10 == their plain twins bit for bit on every "
        f"call of the run ({held}; at captures {captured})")


def note_stage_runs(key, counts, frames, dense=False, label="") -> None:
    """A main path's K8-K10 launches (`counts`, keyed as
    frame._launch_counts) over `frames` frames, kept for the kernels line;
    each kernel of the path must have launched (K8 and K9's march on every
    path, the certificate and K10 on the sparse ones)."""
    need = (("contact_front", "contact_march") if dense else STAGE_KERNELS)
    launched = {k: counts[k] for k in STAGE_KERNELS}
    check(all(counts[k] >= frames for k in need),
          f"{label or key}: K8-K10 launches {launched} over {frames} frames")
    STAGE_RUNS[key] = dict({k: counts[k] for k in STAGE_KERNELS},
                           frames=frames)


def frame_stage_calls(scene, pose, cfg, dev):
    """(dispatcher name, args, kwargs) of every K8-K10 call of one frame
    at `pose` after one frame at the same pose (the arguments held by
    reference: the frame state is a new tensor per eager frame)."""
    from funky_tpu_torch import frame

    state = frame.init_frame_state(cfg, dev)
    _, state = frame.render_gltf_frame(scene, pose, state, cfg)
    calls = []
    saved = {name: getattr(_stage_module(name), name)
             for name in STAGE_TWINS}

    def recorder(name, dispatch):
        def record(*args, **kwargs):
            calls.append((name, args, kwargs))
            return dispatch(*args, **kwargs)
        return record

    for name, dispatch in saved.items():
        setattr(_stage_module(name), name, recorder(name, dispatch))
    try:
        frame.render_gltf_frame(scene, pose, state, cfg)
        sync(dev)
    finally:
        for name, dispatch in saved.items():
            setattr(_stage_module(name), name, dispatch)
    return calls


def _stage_args(name, args, kwargs) -> dict:
    m = _stage_module(name)
    a = inspect.signature(getattr(m, STAGE_TWINS[name][1])).bind(
        *args, **kwargs)
    a.apply_defaults()
    return a.arguments


def stage_work(name, args, kwargs) -> tuple:
    """(bytes, FP32 operations, live, slots) one K8-K10 call needs on these
    inputs. K8: each pixel's world, normal, frag and valid read, its
    payload row and masks written. K9: the needed slots' indices and
    payload rows read (the certificate's live slots, their slot_valid
    bytes too in the compact mode; the march's live slots, or without an
    index the rays its mask keeps), each distinct row their probes read
    (the pyramid's quad rows, or the depth's quads, counted from the rows
    the twin gathers for those slots, as K3's distinct-row bytes) read
    once; written: the certificates (every slot), or stage 3's idx and
    slot_valid (every one of its slots) and count, or the needed terms.
    K10: the map read once and the cell rows written."""
    import torch

    a = _stage_args(name, args, kwargs)
    if name == "_class_rows":
        maps, coarse = a["shadow_maps"], a["coarse"]
        l, s, _ = maps.shape
        cells = l * (s // coarse) ** 2
        nbytes = maps.numel() * 4 + cells * 32 + l * 16
        pooled = coarse % 2 == 0 and s % 2 == 0
        ops = maps.numel() * (STAGE_OPS["class_fine"]
                              + (STAGE_OPS["class_pooled"] / 4 if pooled
                                 else 0))
        return nbytes, ops, cells, cells
    if name == "contact_front":
        n = a["world"].numel() // 3
        per = (24 + (8 if a["frag"] is not None else 0)
               + (1 if a["valid"] is not None else 0) + 28 + 1
               + (1 if a["pyr"] is not None else 0))
        return n * per, n * STAGE_OPS["front"], n, n
    payload = a["payload"]
    if name == "contact_certify_compact":
        idx, count = a["comp2"].idx, a["comp2"].count
    else:
        idx, count = a["idx"], a["count"]
    m = payload.shape[0] if idx is None else idx.shape[0]
    need = torch.arange(m, device=payload.device) < (
        m if count is None else int(count))
    if name == "contact_march" and a["mask"] is not None:
        need &= a["mask"]
    live = int(need.sum())
    twin = getattr(_stage_module(name), STAGE_TWINS[name][1])
    gathers = record_gather_calls(lambda: twin(*args, **kwargs))
    rows = [torch.where(i < 0, i + t.shape[0], i).clamp(
        0, t.shape[0] - 1).reshape(-1, m)[:, need].reshape(-1)
        for t, i in gathers if t is not payload and i.numel() % m == 0]
    distinct = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    nbytes = live * (4 + 28) + 16 * distinct
    if name == "contact_certify":
        nbytes += m
    elif name == "contact_certify_compact":
        cap = min(a["cap3"], m)
        nbytes += live + 5 * cap + 4
    else:
        nbytes += 4 * live
    ops = live * STAGE_OPS["march" if name == "contact_march"
                           else "certify"]
    return nbytes, ops, live, m


def time_stage_kernels(calls) -> dict:
    """Each K8-K10 kernel on one frame's calls (frame_stage_calls'): the
    dispatchers (the kernels) by device time behind a sleep, the plain
    twins by device time as a replayed CUDA graph, and the bound over the
    card's peaks of the calls' bytes and operations on this run's data
    (stage_work). No single PyTorch call computes any of these
    functions: library_ms is None."""
    out = {}
    for name in STAGE_TWINS:
        mine = [c for c in calls if c[0] == name]
        if not mine:
            continue
        m = _stage_module(name)
        dispatch = getattr(m, name)
        twin = getattr(m, STAGE_TWINS[name][1])

        def run_kernel(mine=mine, dispatch=dispatch):
            for _, args, kwargs in mine:
                dispatch(*args, **kwargs)

        def run_twin(mine=mine, twin=twin):
            for _, args, kwargs in mine:
                twin(*args, **kwargs)

        work = [stage_work(*c) for c in mine]
        nbytes, ops = sum(w[0] for w in work), sum(w[1] for w in work)
        if _stage_kernel(name) in out:
            fail(f"{name}: a frame calls both modes of "
                 f"{_stage_kernel(name)}; time them apart")
        out[_stage_kernel(name)] = dict(
            calls=len(mine), live=sum(w[2] for w in work),
            slots=sum(w[3] for w in work),
            ms=device_ms(run_kernel, iters=20, sleep_cycles=100_000_000),
            plain_ms=graph_ms(run_twin), bytes=nbytes, ops=ops,
            bound_ms=max(nbytes / HBM_BPS, ops / FP32_OPS) * 1e3,
            bound_by="bytes" if nbytes / HBM_BPS > ops / FP32_OPS
            else "operations", library_ms=None)
    return out


# Per-frame K8-K10 timings of the shipped and the dense frame.
STAGE_TIMES: dict = {}


def phase_filter_cases(dev) -> None:
    """K6 and K7 against their twins bit for bit on synthetic entries the
    frames do not reach: every mode (PCSS, radius-only, fixed-radius PCF
    with 16 Vogel taps and with the 3x3 kernel) on the packed 2048^2 maps
    with the edge entries of tests/torch_scenes.py::pair_taps_case, and
    through a 512^2 window at an origin past S - Wc (host ints and int32
    tensors), each also with a live count (half the slots, and past
    them); K7 on random keys at the 1080p pair shape, a ragged length and
    an unaligned needs view."""
    import torch

    from funky_tpu_torch.ops import sampling
    from funky_tpu_torch.passes import shadow_filter
    from funky_tpu_torch.passes.uniforms import FrameUniforms
    from tests.torch_scenes import light_uniform_fields, pair_taps_case

    n = 163_840    # the shipped frame's tap slots
    depth, uv, layer, recv, phi = pair_taps_case(0, n, SHADOW)
    maps = sampling.quad_pack(torch.from_numpy(depth).to(dev))
    uv, layer, recv, phi = (torch.from_numpy(x).to(dev)
                            for x in (uv, layer, recv, phi))
    wc, origin = 512, (1700, 1650)
    rows = sampling.dynamic_slice(maps[3], origin, (wc, wc))
    win_uv = (torch.tensor(origin[::-1], device=dev) - 8
              + torch.rand((n, 2), generator=torch.Generator(
                  device=dev).manual_seed(1), device=dev) * (wc + 16)) / SHADOW
    layer0 = torch.zeros_like(layer)
    cases = []
    for mode, soft in (("pcss", 2.5), ("radius_only", 2.5),
                       ("pcf_vogel", 2.5), ("pcf_3x3", 1.0)):
        uni = FrameUniforms(**{k: torch.from_numpy(v).to(dev) for k, v in
                               light_uniform_fields(soft, SHADOW).items()})
        kw = {"radius_only": True} if mode == "radius_only" else {}
        fn = "_pcf_taps" if mode.startswith("pcf") else "_pcss_taps"
        cases.append((fn, (uni, maps, layer, uv, recv, phi), kw))
        for org in (origin, tuple(torch.tensor(o, dtype=torch.int32,
                                               device=dev) for o in origin)):
            cases.append((fn, (uni, maps[3:4], layer0, win_uv, recv, phi),
                          dict(kw, window=(rows, org, SHADOW))))
        # live counts: an odd split (a warp whose lane groups are partly
        # live) and a committed overflow past the slots
        cases.append((fn, (uni, maps, layer, uv, recv, phi), dict(
            kw, count=torch.tensor(n // 2 + 1, dtype=torch.int32,
                                   device=dev))))
        cases.append((fn, (uni, maps[3:4], layer0, win_uv, recv, phi), dict(
            kw, window=(rows, origin, SHADOW), count=torch.full(
                (1,), n + 7, dtype=torch.int32, device=dev))))
    rng = np.random.default_rng(2)
    for shape in ((2, HEIGHT, WIDTH), (2, 4097)):
        needs = torch.from_numpy(rng.random(shape) < 0.03).to(dev)
        key = torch.from_numpy(rng.integers(0, 16, shape).astype(np.int32)
                               ).to(dev)
        cases.append(("_group_counts", (needs, key, 16), {}))
    base = torch.from_numpy(rng.random(2 * 4097 + 1) < 0.5).to(dev)
    cases.append(("_group_counts", (base[1:].reshape(2, 4097), key, 16), {}))

    def run():   # the dispatchers looked up at the call: the recorder's
        for name, args, kw in cases:
            getattr(shadow_filter, name)(*args, **kw)

    verify_filter("K6 / K7 synthetic cases", run)


def phase_stage_cases(dev, calls) -> None:
    """K10 and K8 against their twins bit for bit where the frames do not
    take them (these launches are the script's own, outside the main
    paths' counts). K10 on the shipped frame's four maps with NaN, +/-inf
    and BORDER_DEPTH runs written in (tests/torch_scenes.py::
    special_maps' marks) at coarse 16 and 8, each at the wrapper's tile
    and at every other tile of K10_TILES, forced by replacing tile_cells,
    and the unpooled branch on 2 x 250^2 special maps at coarse 5; K8 on
    the shipped frame's front call with its rows re-laid (contiguous (n,
    3) rows 4 bytes off a 16-byte boundary, rows of 20 floats) and cut to
    a pixel count inside a block."""
    import torch

    from funky_tpu_torch.ops import class_maps_cuda
    from funky_tpu_torch.passes import contact, shadow_classify
    from tests.torch_scenes import random_planes, special_maps

    (_, cargs, ckw), = [c for c in calls if c[0] == "_class_rows"]
    a = _stage_args("_class_rows", cargs, ckw)
    maps = a["shadow_maps"].clone()
    l, s, _ = maps.shape
    marks = torch.from_numpy(special_maps(7, l, 256)).to(dev)
    maps[:, :256, :256] = marks
    maps[:, -256:, -256:] = marks
    planes, eps, soft = a["planes"], a["eps"], a["max_softness"]
    cases = [(maps, coarse, soft, planes, eps) for coarse in (16, 8)]
    small = torch.from_numpy(special_maps(8, 2, 250)).to(dev)
    small_planes = torch.from_numpy(random_planes(8, 2)).to(dev)
    cases.append((small, 5, soft, small_planes,
                  small_planes.abs().sum(dim=-1) * 4e-7 + 2e-7))
    n_k10 = 0
    for m, coarse, soft_, pl, ep in cases:
        want = shadow_classify._class_rows_plain(m, coarse, soft_, pl, ep)
        uw = shadow_classify.rise_window(soft_)
        pooled = class_maps_cuda.pooled_branch(m.shape[1], coarse)
        own = class_maps_cuda.tile_cells(
            m.shape[1], coarse, pooled,
            class_maps_cuda.rise_reach(m.shape[1], coarse, uw))
        for tc in sorted({own, *K10_TILES.get(coarse, ())}):
            inner = class_maps_cuda.tile_cells
            class_maps_cuda.tile_cells = lambda *_, tc=tc: tc
            try:
                got = class_maps_cuda.class_rows(m, coarse, uw, pl, ep)
            finally:
                class_maps_cuda.tile_cells = inner
            check(bits_equal(got, want), f"K10 at coarse {coarse}, tile "
                  f"{tc}, on special maps {tuple(m.shape)} differs from "
                  f"its plain twin")
            n_k10 += 1
    (_, fargs, fkw), = [c for c in calls if c[0] == "contact_front"]
    f = _stage_args("contact_front", fargs, fkw)
    world, normal = f["world"].reshape(-1, 3), f["normal"].reshape(-1, 3)
    n = world.shape[0] - 37
    gen = torch.Generator(device=dev).manual_seed(5)
    frag, valid = f["frag"], f["valid"]
    if frag is None:     # a slab's pixel centres at its first row y0
        rows, width = f["world"].shape[:2]
        y0 = float(f["y0"])
        fy, fx = torch.meshgrid(torch.arange(rows, device=dev) + 0.5 + y0,
                                torch.arange(width, device=dev) + 0.5,
                                indexing="ij")
        frag = torch.stack([fx, fy], dim=-1).float()
    if valid is None:
        valid = torch.rand(world.shape[0], generator=gen, device=dev) < 0.9
    rest = dict(uni=f["uni"], depth_shape=f["depth_shape"],
                valid=valid.reshape(-1)[:n], pyr=f["pyr"],
                frag=frag.reshape(-1, 2)[:n])

    def laid(t, width, offset, at):
        buf = torch.rand((n * width + offset,), generator=gen,
                         device=dev)[offset:].view(n, width)
        buf[:, at:at + t.shape[1]] = t[:n]
        return buf[:, at:at + t.shape[1]]

    layouts = {"frame rows": (world[:n], normal[:n]),
               "unaligned (n, 3)": (laid(world, 3, 1, 0),
                                    laid(normal, 3, 2, 0)),
               "20-float rows": (laid(world, 20, 0, 5),
                                 laid(normal, 20, 0, 12))}
    for name, (w, nn) in layouts.items():
        ok, _ = _stage_equal(contact.contact_front(w, nn, **rest),
                             contact._contact_front_plain(w, nn, **rest))
        check(ok, f"K8 on {name} differs from its plain twin")
    sync(dev)
    say(f"K10 == its plain twin bit for bit on {n_k10} special-map calls "
        f"(coarse 16, 8 and 5, every tile of {K10_TILES}); K8 == its twin "
        f"on {n} pixels laid out as {list(layouts)}")


# K9's march layouts by the live count past which it runs one thread a
# slot (contact_cuda.LANES_LIVE_MAX; None: the module's own).
MARCH_LAYOUTS = {"the shipped switch": None, "a thread a slot": -1,
                 "8 lanes a slot": 2 ** 62}


def phase_k9_cases(dev, calls) -> None:
    """K9 against its twins bit for bit where the frames do not take it
    (these launches are the script's own, outside the main paths' counts):
    the compacting certificate on the shipped frame's pyramid and payload
    over random stage-2 slots with stage 3 past cap3, no live slot, every
    slot live, a count past the stage-2 slots and cap3 past them; the
    march on rays drawn from the frame's payload (tests/torch_scenes.py::
    contact_rays: first hits on every linear probe, probe 0 and 7 among
    them, hits after an out-of-bounds probe, misses, NaN rows) at each
    live-count switch of MARCH_LAYOUTS (contact_cuda.LANES_LIVE_MAX
    patched: the shipped one, and each layout for every live count),
    through an index with a live count inside a warp, a mask and a window;
    and a CUDA graph holding the frame's own compacting call, replayed
    twice in a row (the status words its last block resets), == the twin
    both times."""
    import torch

    from funky_tpu_torch.ops import contact_cuda
    from funky_tpu_torch.ops.compact import Compacted
    from funky_tpu_torch.passes import contact
    from tests.torch_scenes import contact_rays

    (_, cargs, ckw), = [c for c in calls
                        if c[0] == "contact_certify_compact"]
    a = _stage_args("contact_certify_compact", cargs, ckw)
    pyr, payload, shape = a["pyr"], a["payload"], a["depth_shape"]
    m = a["comp2"].idx.shape[0]
    gen = torch.Generator(device=dev).manual_seed(17)

    def stage2(live):
        return Compacted(
            idx=torch.randint(0, payload.shape[0], (m,), generator=gen,
                              dtype=torch.int32, device=dev),
            slot_valid=torch.arange(m, device=dev) < live,
            count=torch.tensor(live, dtype=torch.int32, device=dev))

    cases = {"stage 3 past cap3": (stage2(m), 1024),
             "no live slot": (stage2(0), a["cap3"]),
             "every slot live": (stage2(m), m),
             "count past the stage-2 slots": (stage2(m + 13), a["cap3"]),
             "cap3 past the slots": (stage2(m // 2), m + 100)}
    for label, (comp2, cap3) in cases.items():
        got = contact.contact_certify_compact(pyr, payload, shape, comp2,
                                              cap3)
        with plain_gathers():
            want = contact._contact_certify_compact_plain(pyr, payload,
                                                          shape, comp2, cap3)
        ok, _ = _stage_equal(got, want)
        check(ok, f"K9's compacting certificate, {label}: differs from its "
              f"plain twin")
        if label == "stage 3 past cap3":
            check(int(want.count) > cap3, f"K9 case '{label}': stage 3 "
                  f"holds {int(want.count)}, within cap3 {cap3}")

    (_, margs, mkw), = [c for c in calls if c[0] == "contact_march"]
    depth = _stage_args("contact_march", margs, mkw)["prev_depth"]
    rows = torch.from_numpy(contact_rays(payload.cpu().numpy(), 7, 200_001)
                            ).to(dev)
    n = rows.shape[0]
    cw = min(depth.shape) // 2
    marches = {
        "indexed": dict(idx=torch.randperm(n, generator=gen, device=dev)[
            :150_000].to(torch.int32), count=torch.tensor(
                149_989, dtype=torch.int32, device=dev)),
        "masked": dict(mask=torch.rand(n, generator=gen, device=dev) < 0.8),
        "windowed": dict(idx=torch.arange(n, dtype=torch.int32, device=dev),
                         count=torch.tensor(n, dtype=torch.int32,
                                            device=dev),
                         window=(torch.tensor((depth.shape[0] // 4,
                                               depth.shape[1] // 5),
                                              dtype=torch.int32, device=dev),
                                 cw))}
    lit = {}
    shipped = contact_cuda.LANES_LIVE_MAX
    for layout, live_max in MARCH_LAYOUTS.items():
        contact_cuda.LANES_LIVE_MAX = (shipped if live_max is None
                                       else live_max)
        try:
            for label, kw in marches.items():
                got = contact.contact_march(depth, rows, **kw)
                with plain_gathers():
                    want = contact._contact_march_plain(depth, rows, **kw)
                ok, _ = _stage_equal(got, want)
                check(ok, f"K9's march, {layout}, {label} seeded rays: "
                      f"differs from its plain twin")
                lit[label] = int((want < 1.0).sum())
        finally:
            contact_cuda.LANES_LIVE_MAX = shipped
    check(all(v > 0 for v in lit.values()),
          f"K9's seeded rays shadow nothing: {lit}")

    contact.contact_certify_compact(*cargs, **ckw)
    sync(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = contact.contact_certify_compact(*cargs, **ckw)
    with plain_gathers():
        want = contact._contact_certify_compact_plain(*cargs, **ckw)
    for replay in (1, 2):
        graph.replay()
        sync(dev)
        ok, _ = _stage_equal(out, want)
        check(ok, f"K9's compacting certificate, graph replay {replay} in "
              f"a row: differs from its plain twin")
    say(f"K9 == its plain twins bit for bit on {len(cases)} compacting "
        f"cases ({list(cases)}), on {n} seeded rays by {list(MARCH_LAYOUTS)}"
        f" ({list(marches)}; shadowed {lit}), and on 2 "
        f"graph replays in a row of the shipped frame's compacting call")


# K10's tiles (cells a side) held against the twin at each coarse.
K10_TILES = {16: (2, 3, 4, 6), 8: (4, 6, 8, 12)}


def phase_perf_mode(dev, scene, params, name, cfg, occ, tune_s):
    """One perf mode of the shipped configuration, `cfg` tuned on its own
    (committed): 8 chained committed frames eager (no host sync, K1 ==
    plain on every raster, K3 == the plain row gather, finite, shadow on
    the ground), the same poses cond'd, committed == cond'd on the tuned
    and chained poses with each frame polled (check_tuned_and_chained),
    and the frames through compiled_gltf_frame == the eager ones bit for
    bit in rgba and every FrameState field, with the capture's launches
    the eager frame's. The light-space mode also launches K5 once per
    window in every frame, and every light map of a frame equals the plain
    twin's bit for bit.
    Prints frame, replay and light-map times. Returns (launch counts of the
    eager committed run, K3 launches per frame, the light maps' K5 numbers
    or None)."""
    import dataclasses
    import functools

    from funky_tpu_torch import frame

    label = f"{name} path (multimesh)"
    scale = cfg.flags.effective_shadow_scale
    base = default_config(**{"committed": True, "synth_shadow_maps": True,
                             **PERF_MODES[name]})
    tuned = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if getattr(cfg, f.name) != getattr(base, f.name)}
    say(f"{label}: shadow evaluated at 1/{scale} rate; autotune {tune_s:.3f}"
        f" s; tuned config (fields changed from the base): {tuned} "
        f"[{_GPU}]")
    say(f"{label}: occupancy {occ}")
    windows = cfg.effective_light_windows() or (0, 0, 0, 0)
    n_win = sum(1 for s in windows if s)
    if cfg.flags.light_space_ground_shadows:
        fetch = occ["light_fetch_per_cascade"]
        say(f"{label}: light windows {windows}, light_fetch_per_cascade "
            f"{fetch}, light_fetch_caps {cfg.light_fetch_caps}")
        check(sum(fetch) > 0, f"{label}: no entry fetches from a light map")

    poses = poses_for(params, N_PARKED, N_ORBIT)
    reset_counts()
    box = {}
    rasters = record_raster_calls(lambda: box.update(
        maps=record_light_maps(lambda: box.update(
            run=run_frames(scene, poses, cfg, dev)))))
    crun = box["run"]
    counts = read_counts()
    say(f"{label}: {len(poses)} committed frames, launches {counts}, K1 per "
        f"frame {crun['k1']}, host syncs per frame {crun['syncs']}")
    check(all(s == 0 for s in crun["syncs"]),
          f"{label}: a committed frame took a host branch")
    check(all(k == n_win + 1 for k in crun["k1"])
          and counts["raster_padded"] == 0,
          f"{label}: expected {n_win + 1} K1 launches per frame")
    err = check_rasters_bitwise(rasters, label)
    say(f"{label}: K1 == plain raster bit for bit on all {len(rasters)} "
        f"recorded rasters (max |depth| difference {err})")
    check_filter_launches(crun, name, label)
    if cfg.flags.light_space_ground_shadows:
        check(all(k == n_win for k in crun["k5"]),
              f"{label}: expected {n_win} K5 launches per frame, got "
              f"{crun['k5']}")
        say(f"{label}: K5 launches per frame {crun['k5']}, K3 launches per "
            f"frame {crun['k3']}")
        k5_err = check_light_maps(box["maps"], counts["light_map"], label)
    with plain_gathers():
        prun = run_frames(scene, poses, cfg, dev)
    check_gathers(crun, prun, label)
    check_image(crun, poses, cfg, dev, label)

    conded = conded_config(cfg)
    with checked_stages(f"{label}, cond'd"):
        drun = run_frames(scene, poses, conded, dev)
    say_branches(f"{label}, cond'd")
    diffs = frames_diff(crun, drun)
    say(f"{label}, frame poses: committed vs cond'd: "
        f"{diffs or 'all frames bit for bit'}")
    check(not diffs, f"{label}: committed != cond'd on the frame poses")
    check_tuned_and_chained(dev, scene, params, cfg, label)
    verify_filter(label, lambda: run_frames(scene, poses, cfg, dev))

    fn = frame.compiled_gltf_frame(cfg)
    check(fn.uses_graph(dev), f"{label}: a committed config is not recorded")
    erun = gltf_frames(functools.partial(frame.render_gltf_frame, cfg=cfg),
                       scene, poses, cfg, dev)
    grun = gltf_frames(fn, scene, poses, cfg, dev)
    g = fn.last
    names = ("rgba",) + frame.FrameState._fields
    for i, (fe, fg) in enumerate(zip(erun["frames"], grun["frames"])):
        for field, a, b in zip(names, fe, fg):
            check(bits_equal(a, b), f"{label}: graph frame {i} {field} "
                  f"differs from the eager frame")
    # the graph is recorded from the first frame's inputs
    first = {"raster_table": crun["k1"][0], "raster_padded": 0,
             "row_gather": crun["k3"][0], "light_map": crun["k5"][0],
             "pair_taps": crun["k6"][0], "group_counts": crun["k7"][0],
             **{k: crun[k][0]
                for k in STAGE_KERNELS + ("quad_pack", "binning")}}
    check(g.launches == first, f"{label}: capture launches {g.launches} "
          f"!= the first eager frame's {first}")
    say(f"{label}: CUDA graph recorded (launches at capture {g.launches}); "
        f"graph == eager, rgba and all {len(names) - 1} FrameState fields "
        f"of all {len(poses)} frames bit for bit")

    for run_name, run in (("committed eager", crun), ("cond'd eager", drun)):
        say(f"{name} frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 (multimesh, "
            f"{run_name}): host clock median "
            f"{statistics.median(run['wall'][1:]):.3f} ms, CUDA events "
            f"median {statistics.median(run['ms'][1:]):.3f} ms over "
            f"{len(poses) - 1} frames after the first; peak device memory "
            f"{run['peak_gib']:.2f} GiB; host syncs per frame "
            f"{run['syncs']} [{_GPU}]")
    say(f"{name} frame {WIDTH}x{HEIGHT}, 4x{SHADOW}^2 (multimesh, graph "
        f"replay): host clock median {statistics.median(grun['wall'][1:]):.3f}"
        f" ms, CUDA events median {statistics.median(grun['ms'][1:]):.3f} ms"
        f"; per frame {[round(x, 3) for x in grun['wall']]} ms; peak device "
        f"memory {grun['peak_gib']:.2f} GiB allocated, "
        f"{grun['reserved_gib']:.2f} GiB reserved [{_GPU}]")
    check(all(math.isfinite(x) for x in crun["ms"] + grun["ms"]),
          f"{label}: timing")

    if cfg.flags.light_space_ground_shadows:
        # The replay with only the windows JAX's rule keeps (a window with
        # under 128 fetches dropped, and its light map with it), in turns
        # with the tuned config's: the device time the kept windows' light
        # maps add.
        fetch = occ["light_fetch_per_cascade"]
        jax_rule = dataclasses.replace(
            cfg, light_window_sizes=tuple(
                s if f >= 128 else 0
                for s, f in zip(cfg.light_window_sizes, fetch)),
            light_fetch_caps=tuple(
                c if f >= 128 else 0
                for c, f in zip(cfg.light_fetch_caps, fetch)))
        jfn = frame.compiled_gltf_frame(jax_rule)
        for run_name, f, c in (("JAX's windows", jfn, jax_rule),
                               ("tuned windows", fn, cfg),
                               ("JAX's windows", jfn, jax_rule),
                               ("tuned windows", fn, cfg)):
            r = gltf_frames(f, scene, poses, c, dev)
            say(f"{name} frame replay with {run_name} "
                f"{c.effective_light_windows()}: host clock median "
                f"{statistics.median(r['wall'][1:]):.3f} ms, CUDA events "
                f"median {statistics.median(r['ms'][1:]):.3f} ms [{_GPU}]")
        state = frame.init_frame_state(cfg, dev)
        _, state = frame.render_gltf_frame(scene, poses[0], state, cfg)
        calls = record_light_maps(
            lambda: frame.render_gltf_frame(scene, poses[-1], state, cfg))
        maps, taps_ms = time_light_maps(calls)
        for m in maps:
            say(f"{label}: light map on a {m['wc']}^2 window (CUDA events):"
                f" K5 alone {m['k5_ms']:.4f} ms; with its parameters "
                f"{m['kernel_graph_ms']:.4f} ms as a replayed graph, "
                f"{m['kernel_ms']:.4f} ms behind a sleep; plain twin "
                f"{m['plain_graph_ms']:.4f} ms as a graph, "
                f"{m['plain_ms']:.4f} ms "
                f"behind a sleep; bound "
                f"{m['bound_ms']:.5f} ms ({m['bound_by']}) [{_GPU}]")
        k5 = {k: sum(m[k] for m in maps)
              for k in ("kernel_ms", "plain_ms", "bound_ms", "k5_ms",
                        "kernel_graph_ms", "plain_graph_ms")}
        k5.update(err=k5_err, maps=maps, taps_ms=taps_ms,
                  frame_graph_ms=k5["kernel_graph_ms"] + taps_ms,
                  bound_by=max(maps, key=lambda m: m["bound_ms"])["bound_by"])
        say(f"{label}: light maps per frame: K5 alone {k5['k5_ms']:.4f} ms;"
            f" the tap geometry, built once, {taps_ms:.4f} ms busy; with it"
            f" and each window's parameters "
            f"{k5['frame_graph_ms']:.4f} ms as replayed graphs "
            f"({k5['frame_graph_ms'] / statistics.median(grun['ms'][1:]):.1%}"
            f" of the graph replay's CUDA-event median), plain twin "
            f"{k5['plain_graph_ms']:.4f} ms as graphs [{_GPU}]")
        return counts, crun["k3"], k5
    return counts, crun["k3"], None


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
    on any failed step or probe; the panel goes through K4 once per
    readback, save_png and render_over (phase_overlay then holds K4 to its
    plain twin and times the panel); every K8-K10 call outside a capture
    (the autotune's and the re-tunes' probes and frames, the graphs'
    warm-ups, the eager reference frames) == its plain twin. Returns
    (launch counts, capture launches, step ms, render_over ms, K4's
    numbers)."""
    import io

    import torch

    from funky_tpu_torch import frame
    from funky_tpu_torch.app.camera import Keys
    from funky_tpu_torch.app.driver import FrameDriver
    from funky_tpu_torch.frame import GltfConfig, GltfFrameFlags

    from funky_tpu_torch.ops import overlay_cuda

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
    with checked_stages(label), contextlib.redirect_stdout(log), \
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
    k4 = overlay_cuda.LAUNCHES
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
        f"K4 launches {k4} (readback, save_png, render_over); "
        f"wrote local/driver_1080p_ui.png [{_GPU}]")
    check(g is not None, f"{label}: the shipped config recorded no graph")
    check(k4 == 3, f"{label}: the panel launched K4 {k4} times, expected 3")
    k4_info = phase_overlay(dev, drv.ui_data())
    k4_info["launches"] = k4
    return (counts, g.launches, statistics.median(steps[1:]), ui_ms,
            k4_info)


def overlay_work(table: np.ndarray, panel_hw, atlas_bytes: int):
    """(bytes, FP32 operations) one panel raster needs on this table: the
    table and the atlas read once, the (H, W, 4) panel written; 17
    operations (barycentrics and the cover test) per pixel of each
    triangle's crop box and 93 more (uv, colour, the bilinear sample, the
    blend) per pixel a triangle covers, counted here in numpy with the
    kernel's expressions."""
    from funky_tpu_torch.passes import overlay

    ph, pw = panel_hw
    px = np.arange(pw, dtype=np.float32)[None, :] + np.float32(0.5)
    py = np.arange(ph, dtype=np.float32)[:, None] + np.float32(0.5)
    boxed = covered = 0
    for row in table:
        inv, dx21, dy21, dx02, dy02, x1, y1, x2, y2 = \
            row[:overlay.TABLE_SCALARS]
        cx0, cx1, cy0, cy1 = (int(v) for v in
                              row[overlay.TABLE_CROP:overlay.TABLE_CROP + 4])
        cpx, cpy = px[:, cx0:cx1], py[cy0:cy1]
        b0 = (dx21 * (cpy - y1) - dy21 * (cpx - x1)) * inv
        b1 = (dx02 * (cpy - y2) - dy02 * (cpx - x2)) * inv
        b2 = np.float32(1.0) - b0 - b1
        boxed += (cx1 - cx0) * (cy1 - cy0)
        covered += int(((b0 >= 0) & (b1 >= 0) & (b2 >= 0)).sum())
    return table.nbytes + atlas_bytes + 16 * ph * pw, 17 * boxed + 93 * covered


def phase_overlay(dev, data) -> dict:
    """K4 against its plain twin (rasterize_overlay_plain) bit for bit on
    the panel of `data` (the driver's UiData), on one with every checkbox
    toggled and the error line shown, on a full table of 2048 rows
    (tests/torch_scenes.py::overlay_chunks_case: more rows than one chunk
    of the kernel's tile lists, tiny full-panel triangles in every chunk)
    and on a 100x130 panel, whose sides the tile does not divide
    (overlay_case's triangles across the edges); then render_over at
    1080p timed by parts on the host clock (tessellation, table, kernel,
    composite), K4 by device time on the driver's and the toggled panel,
    the plain twin on the host clock, and the bound. Returns the kernel's
    numbers for the kernels line."""
    import dataclasses

    import torch

    from funky_tpu_torch.app import ui
    from funky_tpu_torch.ops import overlay_cuda
    from funky_tpu_torch.passes import overlay
    from tests.torch_scenes import overlay_case, overlay_chunks_case

    label = "overlay K4"
    hw = (ui.PANEL_H, ui.PANEL_W)
    atlas = torch.from_numpy(ui.build_font_atlas()[0]).to(dev)
    toggled = dataclasses.replace(
        data, debug_cascades=not data.debug_cascades,
        use_pcss=not data.use_pcss, use_shadow_taa=not data.use_shadow_taa,
        last_error="frame 7: a failure shown on the panel")
    err = 0.0
    tables = {}
    cases = [("driver", ui.build_panel(data).arrays(), hw),
             ("toggled", ui.build_panel(toggled).arrays(), hw),
             ("2048-row", overlay_chunks_case(hw), hw),
             ("ragged 100x130", overlay_case("edges", (100, 130)),
              (100, 130))]
    for name, arrays, panel_hw in cases:
        table = torch.from_numpy(overlay.overlay_table(
            *arrays[:4], int(arrays[4]), panel_hw)).to(dev)
        tables[name] = table
        got = overlay_cuda.overlay_raster(table, atlas, panel_hw)
        want = overlay.rasterize_overlay_plain(table, atlas, panel_hw)
        check(bits_equal(got, want), f"{label}: the {name} panel differs "
              f"from the plain twin's")
        # the panels: alpha above 0.5 on most pixels; the synthetic tables
        # draw through the atlas's sparse glyph texels
        alpha = 0.5 if name in ("driver", "toggled") else 0.0
        drawn = float((got[..., 3] > alpha).float().mean())
        check(drawn > (0.5 if alpha else 0.05), f"{label}: the {name} panel "
              f"is not drawn ({drawn:.3f} of its pixels)")
        err = max(err, float((got - want).abs().max()))
        say(f"{label}: the {name} panel {panel_hw} ({table.shape[0]} "
            f"triangles of {int(arrays[4])}, {drawn:.3f} of its pixels "
            f"above alpha {alpha}) == plain twin bit for bit; tile "
            f"{overlay_cuda.TILE}")
    check(tables["2048-row"].shape[0] == 2048,
          f"{label}: the full table has {tables['2048-row'].shape[0]} rows")

    # render_over at 1080p by parts, host clock (medians of 20)
    image = torch.rand((HEIGHT, WIDTH, 4), generator=torch.Generator(
        ).manual_seed(0)).to(dev)
    panel = ui.DebugPanel(WIDTH, HEIGHT, device=dev)
    parts = collections.defaultdict(list)
    for _ in range(20):
        sync(dev)
        t0 = time.perf_counter()
        arrays = ui.build_panel(data).arrays()
        t1 = time.perf_counter()
        table_np = overlay.overlay_table(*arrays[:4], int(arrays[4]), hw)
        table = torch.from_numpy(table_np).to(dev)
        t2 = time.perf_counter()
        ov = overlay_cuda.overlay_raster(table, atlas, hw)
        sync(dev)
        t3 = time.perf_counter()
        overlay.composite_overlay(image, ov, ui.PANEL_X, ui.PANEL_Y)
        sync(dev)
        t4 = time.perf_counter()
        panel.render_over(image, data)
        sync(dev)
        t5 = time.perf_counter()
        for k, v in (("tessellation", t1 - t0), ("table", t2 - t1),
                     ("kernel", t3 - t2), ("composite", t4 - t3),
                     ("render_over", t5 - t4)):
            parts[k].append(v * 1e3)
    med = {k: statistics.median(v) for k, v in parts.items()}
    ms = device_ms(lambda: overlay_cuda.overlay_raster(table, atlas, hw))
    toggled_ms = device_ms(lambda: overlay_cuda.overlay_raster(
        tables["toggled"], atlas, hw))
    plain = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        overlay.rasterize_overlay_plain(table, atlas, hw)
        sync(dev)
        plain.append((time.perf_counter() - t0) * 1e3)
    nbytes, ops = overlay_work(table_np, hw, atlas.numel() * 4)
    bound = max(nbytes / HBM_BPS, ops / FP32_OPS) * 1e3
    by = "bytes" if nbytes / HBM_BPS > ops / FP32_OPS else "operations"
    say(f"{label}: render_over {WIDTH}x{HEIGHT} {med['render_over']:.3f} ms "
        f"host clock (median of 20): tessellation {med['tessellation']:.3f}"
        f", table {med['table']:.3f}, kernel {med['kernel']:.3f}, composite"
        f" {med['composite']:.3f} ms; K4 {ms:.4f} ms device time, plain twin"
        f" {statistics.median(plain):.3f} ms host clock (its own launches), "
        f"bound {bound:.5f} ms ({by}: {nbytes} B, {ops} FP32 operations) "
        f"[{_GPU}]")
    return dict(err=err, ms=ms, toggled_ms=toggled_ms,
                plain_ms=statistics.median(plain), bound_ms=bound,
                bound_by=by, parts=med)


# The row-sharded frame at the JAX package's full sharded scale
# (experiments/multichip_scale.py:79-85): 1088 rows split into tile-aligned
# slabs (1080 does not), 4 x 2048^2 cascades, 8x128 main and 128x128
# shadow tiles.
SHARD_HEIGHT = 1088
SHARD_SLABS = 4            # 272 main rows (34 tiles of 8), 512 cascade rows


def sharded_config(**flags):
    from funky_tpu_torch.frame import GltfConfig, GltfFrameFlags
    from funky_tpu_torch.ops.raster import RasterConfig

    return GltfConfig(
        width=WIDTH, height=SHARD_HEIGHT, shadow_map_size=SHADOW,
        raster=RasterConfig(tile_h=8, tile_w=128, capacity=1664),
        shadow_raster=RasterConfig(tile_h=128, tile_w=128, capacity=4224),
        flags=GltfFrameFlags(**flags))


def shard_chain(fn, scene, poses, cfg, dev):
    """Chained frames of fn(scene, params, state): per frame (rgba,
    history, depth) on the card, host ms up to the frame's synchronize,
    K1 and K3 launches, the `synth_window_fit` fallbacks taken, and each
    gather's (shape, dtype, bytes in)."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import compact, gather_cuda, raster_cuda
    from tests.torch_sharded_worker import counted_gathers

    state = frame.init_frame_state(cfg, dev)
    out = dict(frames=[], wall=[], k1=[], k3=[], fallback=[], gathers=[])
    for p in poses:
        k1, k3 = raster_cuda.LAUNCHES, gather_cuda.LAUNCHES
        fb = compact.BRANCHES[("synth_window_fit", False)]
        sync(dev)
        t0 = time.perf_counter()
        with counted_gathers() as calls:
            rgba, state = fn(scene, p, state)
        sync(dev)
        out["wall"].append((time.perf_counter() - t0) * 1e3)
        out["k1"].append(raster_cuda.LAUNCHES - k1)
        out["k3"].append(gather_cuda.LAUNCHES - k3)
        out["fallback"].append(
            compact.BRANCHES[("synth_window_fit", False)] - fb)
        out["gathers"].append(calls)
        out["frames"].append((rgba, state.shadow_history, state.prev_depth))
    return out, state


def device_busy_ms(fn) -> float:
    """Summed device time of the kernels and copies one call of fn()
    launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def slab_stage_ms(scene, params, state, cfg):
    """Device ms of the 4-slab composition's stages on one frame
    (tests/torch_sharded_worker.py::compose_frame, after one untimed run):
    the replicated front (uniforms, vertex stage, windows, the synthesized
    or joined cascades, class maps, quad_pack, light maps) and each rank's
    slab stages (its cascade slab, its main raster and back half)."""
    from tests.torch_sharded_worker import compose_frame

    ms = collections.defaultdict(float)

    def stage(key, fn):
        out = []
        ms[key] += device_busy_ms(lambda: out.append(fn()))
        return out[0]

    compose_frame(scene, params, state, cfg, SHARD_SLABS)
    compose_frame(scene, params, state, cfg, SHARD_SLABS, stage)
    return ms["front"], [ms[r] for r in range(SHARD_SLABS)]


def sharded_graph(dev, scene, params, mesh, name, flags):
    """The committed sharded frame on `mesh` (one NCCL rank) as a CUDA
    graph, for `flags` plus committed mode at the sharded scale: N_PARKED
    + N_ORBIT chained frames through the graph == the eager sharded frames
    == render_gltf_frame in rgba and every FrameState field, bit for bit;
    the gathers of the first call (the warm-up's and the capture's, none
    on a replay) and K1 and K3 at capture as the eager frame launches
    them; every raster of the eager frames == the plain raster, every
    light map of them == the plain twin, and the eager frames with the
    plain row gather == the K3 frames; eager and
    replay timed in turns, and the device busy of one replay. Returns
    (launch counts of the eager and graph runs, K3 launches per eager
    frame)."""
    import functools

    from funky_tpu_torch import frame
    from funky_tpu_torch.parallel import sharded_gltf_frame
    from tests.torch_sharded_worker import counted_gathers

    cfg = sharded_config(committed=True, **flags)
    label = f"sharded committed {name} {WIDTH}x{SHARD_HEIGHT}"
    poses = poses_for(params, N_PARKED, N_ORBIT)
    names = ("rgba",) + frame.FrameState._fields
    fn = sharded_gltf_frame(mesh, cfg)
    check(fn.uses_graph(dev), f"{label}: the committed config is not "
          f"recorded on the NCCL group")
    reset_counts()
    box = {}
    rasters = record_raster_calls(lambda: box.update(
        maps=record_light_maps(lambda: box.update(
            run=gltf_frames(fn.eager, scene, poses, cfg, dev)))))
    erun = box["run"]
    e_counts = read_counts()
    reset_counts()
    with counted_gathers() as calls:
        grun = gltf_frames(fn, scene, poses, cfg, dev)
    g_counts = read_counts()
    g = fn.last
    # the script's references, after the counts are read: every raster of
    # the eager frames against the plain raster, every light map against
    # the plain twin, and the eager frames again with the plain row gather
    # (the graph equals the eager frames, so its kernels are held to all
    # three too)
    check(len(rasters) == e_counts["raster_table"],
          f"{label}: {len(rasters)} rasters recorded, K1 launched "
          f"{e_counts['raster_table']} times")
    check_rasters_bitwise(rasters, label)
    if flags.get("light_space_ground_shadows"):
        check(e_counts["light_map"] > 0, f"{label}: no light map launched")
        check_light_maps(box["maps"], e_counts["light_map"], label)
    reset_counts()
    with plain_gathers():
        prun = gltf_frames(fn.eager, scene, poses, cfg, dev)
    check(read_counts()["row_gather"] == 0,
          f"{label}: the plain-gather run launched K3")
    ref = gltf_frames(functools.partial(frame.render_gltf_frame, cfg=cfg),
                      scene, poses, cfg, dev)
    for i, (fe, fp) in enumerate(zip(erun["frames"], prun["frames"])):
        for field, a, b in zip(names, fe, fp):
            check(bits_equal(a, b), f"{label}: frame {i} {field}: K3 vs "
                  f"plain row gather differ")
    for i, (fe, fg, fr) in enumerate(zip(erun["frames"], grun["frames"],
                                         ref["frames"])):
        for field, a, b, c in zip(names, fe, fg, fr):
            check(bits_equal(a, b), f"{label}: frame {i} {field}: the graph "
                  f"differs from the eager sharded frame")
            check(bits_equal(a, c), f"{label}: frame {i} {field}: the eager "
                  f"sharded frame differs from render_gltf_frame")
    per_frame = {k: v // len(poses) for k, v in e_counts.items()}
    check(all(v % len(poses) == 0 for v in e_counts.values())
          and g.launches == per_frame and per_frame["raster_table"] > 0
          and per_frame["row_gather"] > 0,
          f"{label}: capture launches {g.launches}, eager per frame "
          f"{e_counts} over {len(poses)} frames")
    check(g_counts == {k: 2 * v for k, v in g.launches.items()},
          f"{label}: the graph run launched {g_counts}, expected the "
          f"warm-up's and the capture's {g.launches} each")
    check(len(calls) == 2 * 3 and g.replays == len(poses),
          f"{label}: {len(calls)} gathers in the graph run (expected 3 at "
          f"the warm-up and 3 at the capture), {g.replays} replays")
    check(per_frame["pair_taps"] > 0 and per_frame["group_counts"] == 1,
          f"{label}: K6 / K7 per eager frame {per_frame}")
    FILTER_RUNS[f"sharded_committed_{name}"] = (
        e_counts["pair_taps"], e_counts["group_counts"], len(poses))
    FILTER_RUNS[f"sharded_committed_{name}_graph"] = (
        g_counts["pair_taps"], g_counts["group_counts"], 2)
    note_stage_runs(f"sharded_committed_{name}", e_counts, len(poses),
                    label=label)
    note_stage_runs(f"sharded_committed_{name}_graph", g_counts, 2,
                    label=label)
    verify_filter(f"{label} eager", lambda: gltf_frames(
        fn.eager, scene, poses, cfg, dev))
    say(f"{label}: every raster of the eager frames == the plain raster "
        f"({len(rasters)} rasters); the eager frames with the plain row "
        f"gather == the K3 frames, rgba and every FrameState field")
    say(f"{label}: {len(poses)} chained frames through the CUDA graph == "
        f"the eager sharded frames == render_gltf_frame, rgba and all "
        f"{len(names) - 1} FrameState fields bit for bit; 3 gathers per "
        f"frame recorded at capture ({[c[0] for c in calls[3:]]}), none on "
        f"{g.replays} replays; launches at capture {g.launches} == the "
        f"eager frame's")
    runs = [("eager", erun), ("graph", grun),
            ("eager", gltf_frames(fn.eager, scene, poses, cfg, dev)),
            ("graph", gltf_frames(fn, scene, poses, cfg, dev))]
    for run_name, run in runs:
        say(f"{label} ({run_name}): host clock median "
            f"{statistics.median(run['wall'][1:]):.3f} ms, CUDA events "
            f"median {statistics.median(run['ms'][1:]):.3f} ms over "
            f"{len(poses) - 1} frames after the first; per frame "
            f"{[round(x, 3) for x in run['wall']]} ms; peak device memory "
            f"{run['peak_gib']:.2f} GiB allocated, {run['reserved_gib']:.2f} "
            f"GiB reserved [{_GPU}]")
    state = frame.init_frame_state(cfg, dev)
    _, state = fn(scene, poses[0], state)
    busy = device_busy_ms(lambda: fn(scene, poses[-1], state))
    say(f"{label}: one replay keeps the device busy {busy:.3f} ms (torch."
        f"profiler, kernels and copies) [{_GPU}]")
    counts = {k: e_counts[k] + g_counts[k] for k in e_counts}
    return counts, [per_frame["row_gather"]] * len(poses)


def phase_sharded(dev, scene, params):
    """The row-sharded frame (funky_tpu_torch/parallel) at 1920x1088 with
    4 x 2048^2 cascades, for GltfConfig()'s flags (3 chained frames: 1
    parked, 2 orbit) and __graft_entry__'s trio (2 frames): (a) through
    sharded_gltf_frame on a one-rank NCCL group, (b) as the stages of 4
    slabs composed in one process (tests/torch_sharded_worker.py::
    compose_frame); each == render_gltf_frame in rgba, history and depth
    bit for bit, every raster of both == the plain raster at its own
    y_offset and height, and both again with the plain row gather == the
    K3 frames. Gathers per frame: 4 on the raster path, 3 with
    synthesized maps; K1 5 times per slab per raster-path frame; K3 on
    every frame. Prints eager frame times, the device ms of the front and
    of each slab's stages, and the bytes each gather moves. Returns (K1
    launches, K3 launches per frame, K5 launches) of the sharded runs."""
    import datetime
    import functools

    import torch.distributed as dist

    from funky_tpu_torch import frame
    from funky_tpu_torch.parallel import make_mesh, sharded_gltf_frame
    from tests.torch_sharded_worker import CASES, TRIO, compose_frame, poses

    n = SHARD_SLABS
    k1_total, k3_runs, k5_total = 0, {}, 0
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{td}/store", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh(1, device=dev.type)
            for name in ("default", "trio"):
                flags, n_frames = CASES[name]
                cfg = sharded_config(**flags)
                label = f"sharded {name} {WIDTH}x{SHARD_HEIGHT}"
                pose_list = poses(params, n_frames)
                windows = sum(1 for s in cfg.effective_light_windows() or ()
                              if s)
                ref, _ = shard_chain(functools.partial(
                    frame.render_gltf_frame, cfg=cfg), scene, pose_list,
                    cfg, dev)
                sharded = sharded_gltf_frame(mesh, cfg)

                def composed(s, p, st, cfg=cfg):
                    return compose_frame(s, p, st, cfg, n)

                box = {}
                reset_counts()
                one_rasters = record_raster_calls(lambda: box.update(
                    one_maps=record_light_maps(lambda: box.update(
                        one=shard_chain(sharded, scene, pose_list, cfg,
                                        dev)))))
                one = box["one"][0]
                one["counts"] = read_counts()
                reset_counts()
                four_rasters = record_raster_calls(lambda: box.update(
                    four_maps=record_light_maps(lambda: box.update(
                        four=shard_chain(composed, scene, pose_list, cfg,
                                         dev)))))
                four, state = box["four"]
                four["counts"] = read_counts()
                # the script's references, after the counts are read: every
                # raster of both runs (each slab at its own y_offset and
                # height) against the plain raster, every light map against
                # the plain twin, and both chains again with the plain row
                # gather
                for run_name, run, rasters, maps in (
                        ("one-rank NCCL", one, one_rasters, box["one_maps"]),
                        (f"{n} slabs", four, four_rasters,
                         box["four_maps"])):
                    check(len(rasters) == sum(run["k1"]),
                          f"{label} {run_name}: {len(rasters)} rasters "
                          f"recorded, K1 launched {sum(run['k1'])} times")
                    check_rasters_bitwise(rasters, f"{label} {run_name}")
                    lit = bool(windows and flags.get(
                        "light_space_ground_shadows"))
                    check(bool(maps) == lit, f"{label} {run_name}: "
                          f"{len(maps)} light maps over {len(pose_list)} "
                          f"frames, {windows} windows")
                    if maps:
                        check_light_maps(maps, run["counts"]["light_map"],
                                         f"{label} {run_name}")
                    check(run["counts"]["pair_taps"] > 0
                          and run["counts"]["group_counts"] > 0,
                          f"{label} {run_name}: K6 or K7 not launched: "
                          f"{run['counts']}")
                    key = "nccl" if run is one else f"{n}slabs"
                    FILTER_RUNS[f"sharded_{name}_{key}"] = (
                        run["counts"]["pair_taps"],
                        run["counts"]["group_counts"], len(pose_list))
                    note_stage_runs(f"sharded_{name}_{key}", run["counts"],
                                    len(pose_list), label=label)
                verify_filter(f"{label} one-rank NCCL", lambda: shard_chain(
                    sharded, scene, pose_list, cfg, dev))
                verify_filter(f"{label} {n} slabs", lambda: shard_chain(
                    composed, scene, pose_list, cfg, dev))
                with plain_gathers():
                    one_plain, _ = shard_chain(sharded, scene, pose_list, cfg,
                                               dev)
                    four_plain, _ = shard_chain(composed, scene, pose_list,
                                                cfg, dev)
                for run_name, run, plain in (
                        ("one-rank NCCL", one, one_plain),
                        (f"{n} slabs", four, four_plain)):
                    check(all(k == 0 for k in plain["k3"]),
                          f"{label} {run_name}: the plain-gather run launched "
                          f"K3: {plain['k3']}")
                    for i, (a, b) in enumerate(zip(run["frames"],
                                                   plain["frames"])):
                        for field, x, y in zip(("rgba", "history", "depth"),
                                               a, b):
                            check(bits_equal(x, y), f"{label} {run_name}: "
                                  f"frame {i} {field}: K3 vs plain row "
                                  f"gather differ")
                say(f"{label}: every raster of both runs == the plain raster "
                    f"at its own y_offset and height ({len(one_rasters)} + "
                    f"{len(four_rasters)} rasters); both runs with the plain "
                    f"row gather == the K3 runs, rgba, history and depth bit "
                    f"for bit")
                for run_name, run in (("one-rank NCCL", one),
                                      (f"{n} slabs", four)):
                    for i, (a, b) in enumerate(zip(run["frames"],
                                                   ref["frames"])):
                        for field, x, y in zip(("rgba", "history", "depth"),
                                               a, b):
                            check(bits_equal(x, y), f"{label} {run_name}: "
                                  f"frame {i} {field} differs from "
                                  f"render_gltf_frame")
                    check(all(k > 0 for k in run["k3"])
                          and run["counts"]["row_gather"] == sum(run["k3"])
                          and run["counts"]["raster_padded"] == 0,
                          f"{label} {run_name}: K3 per frame {run['k3']}, "
                          f"launches {run['counts']}")
                synth = windows > 0 and flags.get("synth_shadow_maps")
                gathers = 3 if synth else 4
                check(all(len(g) == gathers for g in one["gathers"]),
                      f"{label}: gathers per frame "
                      f"{[len(g) for g in one['gathers']]}, expected "
                      f"{gathers}")
                for run_name, run, slabs in (("one-rank NCCL", one, 1),
                                             (f"{n} slabs", four, n)):
                    want = [(windows + 4 * fb + slabs) if synth
                            else 5 * slabs for fb in run["fallback"]]
                    check(run["k1"] == want, f"{label} {run_name}: K1 "
                          f"launches per frame {run['k1']}, expected {want}")
                k1_total += (one["counts"]["raster_table"]
                             + four["counts"]["raster_table"])
                k5_total += (one["counts"]["light_map"]
                             + four["counts"]["light_map"])
                k3_runs[f"sharded_{name}_nccl"] = one["k3"]
                k3_runs[f"sharded_{name}_{n}slabs"] = four["k3"]
                say(f"{label}: one-rank NCCL frame and {n}-slab composition "
                    f"== render_gltf_frame, rgba, history and depth of all "
                    f"{len(pose_list)} frames bit for bit; gathers per frame "
                    f"{gathers}; K1 per frame {one['k1']} (one rank), "
                    f"{four['k1']} ({n} slabs, synth fallbacks "
                    f"{four['fallback']}); K3 per frame {one['k3']} / "
                    f"{four['k3']}")
                say(f"{label}: eager host ms per frame: sharded one-rank "
                    f"{[round(x, 3) for x in one['wall']]}, render_gltf_frame "
                    f"{[round(x, 3) for x in ref['wall']]}, {n} slabs "
                    f"{[round(x, 3) for x in four['wall']]} [{_GPU}]")
                for shape, dtype, nbytes in one["gathers"][-1]:
                    say(f"{label}: gather of {shape} {dtype}: {nbytes} B "
                        f"per frame out of one rank; at n = {n} each rank "
                        f"sends its {nbytes // n} B slab and receives "
                        f"{nbytes // n * (n - 1)} B [{_GPU}]")
                front_ms, rank_ms = slab_stage_ms(scene, pose_list[-1],
                                                  state, cfg)
                say(f"{label}: device ms at n = {n}: replicated front "
                    f"{front_ms:.4f} (computed whole on every rank), each "
                    f"slab's stages {[round(x, 4) for x in rank_ms]} "
                    f"[{_GPU}]")
            for name, flags in (("shipped", {"synth_shadow_maps": True}),
                                ("trio", TRIO)):
                counts, k3 = sharded_graph(dev, scene, params, mesh, name,
                                           flags)
                k1_total += counts["raster_table"]
                k5_total += counts["light_map"]
                k3_runs[f"sharded_committed_{name}"] = k3
                k3_runs[f"sharded_committed_{name}_graph"] = [
                    counts["row_gather"] - sum(k3)]
        finally:
            dist.destroy_process_group()
    return k1_total, k3_runs, k5_total


# bench.py:180-190's keys of the primary line
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "median_of", "min",
              "max", "motion_fps"}


def check_bench_output(label: str, stdout: str, stderr: str) -> None:
    """Echo a bench run's output; it must be one JSON line with bench.py's
    keys."""
    for name, text in (("stdout", stdout), ("stderr", stderr)):
        for line in text.splitlines():
            say(f"{label} {name}: {line}")
    lines = stdout.splitlines()
    check(len(lines) == 1 and set(json.loads(lines[0])) == BENCH_KEYS,
          f"{label}: stdout is not one line with bench.py's keys: {lines}")


def phase_bench(dev, scene, params, shipped_cfg, half_cfg):
    """bench_torch.py (the port of bench.py): run_primary and
    run_secondaries on the multimesh scene at full width, n = N_TUNE,
    r = 1; then `python3 bench_torch.py` in a subprocess with
    BENCH_REPEATS=1 (the ground plane alone: the Duck is not in the
    repository; phase_entry holds its config's kernels against their
    plain versions). Checks: one JSON line on stdout with bench.py's
    keys; the tuned shipped and half-res configs == `shipped_cfg` and
    `half_cfg`, the configs the shipped and half-res phases held against
    the plain raster and the plain row gather (a failed tuning step
    raises out of entry.tune); the motion run replayed the graph its
    parked run recorded (one capture, 2 (n + 1) replays); the last motion
    frame == the same pose chain through eager render_gltf_frame bit for
    bit; a chained run drained by bench_torch.drain takes no less host
    time than its CUDA-event time; every K8-K10 call of the in-process run
    outside a capture == its plain twin (checked_stages: the autotunes'
    probes and frames, the graphs' warm-ups). Returns the launch counts of
    the in-process run."""
    import io

    import torch

    import bench_torch
    from funky_tpu_torch import entry, frame

    label = "bench"
    # every compiled frame records its graph afresh, as in a new process
    frame._CACHE.clear()
    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with checked_stages(label), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        primary = bench_torch.run_primary(scene, params,
                                          entry.shipped_config(), N_TUNE, 1,
                                          dev, "multimesh")
        second = bench_torch.run_secondaries(scene, params,
                                             entry.shipped_config(), N_TUNE,
                                             1, dev)
    counts = read_counts()
    seconds = time.perf_counter() - t0
    check_bench_output(label, out.getvalue(), err.getvalue())
    check(counts["raster_table"] > 0 and counts["row_gather"] > 0,
          f"{label}: launches {counts}")
    check(primary.cfg == shipped_cfg, f"{label}: the tuned shipped config "
          f"differs from the shipped phase's")
    check(second["half_cfg"] == half_cfg, f"{label}: the tuned half-res "
          f"config differs from the half_res phase's")
    cfg = primary.cfg
    fn = frame.compiled_gltf_frame(cfg)
    g = fn.last
    replays = getattr(g, "replays", None)
    check(len(fn.captures) == 1 and replays == 2 * (N_TUNE + 1),
          f"{label}: {len(fn.captures)} captures, {replays} replays of the "
          f"shipped graph (expected 1 and {2 * (N_TUNE + 1)})")
    motion = frame.motion_poses(params, N_TUNE)
    state = frame.init_frame_state(cfg, dev)
    for p in motion[:1] + motion:
        rgba, state = frame.render_gltf_frame(scene, p, state, cfg)
    check(bits_equal(primary.last, rgba), f"{label}: the last motion frame "
          f"differs from eager render_gltf_frame on the same chain")
    state = frame.init_frame_state(cfg, dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync(dev)
    t1 = time.perf_counter()
    start.record()
    for p in motion:
        _, state = fn(scene, p, state)
    end.record()
    bench_torch.drain(dev)
    host_ms = (time.perf_counter() - t1) * 1e3
    event_ms = start.elapsed_time(end)
    check(host_ms >= event_ms, f"{label}: the drain returned before the "
          f"replays ended: host {host_ms:.3f} ms < events {event_ms:.3f} ms")
    say(f"{label}: in process {seconds:.1f} s, launches {counts}; tuned "
        f"shipped and half-res configs == the shipped and half_res phases'; "
        f"the motion run replayed the parked run's graph ({replays} replays, "
        f"1 capture); last motion frame == eager render_gltf_frame bit for "
        f"bit; {N_TUNE} chained replays drained: host {host_ms:.3f} ms >= "
        f"CUDA events {event_ms:.3f} ms; half-res {second['half_res']:.2f}, "
        f"sdf {second['sdf']:.1f}, cube {second['cube']:.1f} fps [{_GPU}]")

    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                         env={**os.environ, "BENCH_REPEATS": "1"},
                         capture_output=True, text=True, timeout=600)
    check_bench_output("bench_torch.py", run.stdout, run.stderr)
    check(run.returncode == 0, f"bench_torch.py exited {run.returncode}")
    say(f"bench_torch.py: exit 0, one JSON line, "
        f"{time.perf_counter() - t0:.1f} s [{_GPU}]")
    return counts


def check_fields_equal(a, b, label, what) -> None:
    """Two chains, per frame rgba and every FrameState field, equal bit
    for bit."""
    from funky_tpu_torch import frame

    names = ("rgba",) + frame.FrameState._fields
    for i, (fa, fb) in enumerate(zip(a, b)):
        for name, x, y in zip(names, fa, fb):
            check(bits_equal(x, y), f"{label}: frame {i} {name}: {what}")


def dryrun_references(dev, out, label) -> int:
    """The dry run's toy frame and perf-mode frames again in this process,
    on a one-rank group (NCCL on the card) at the same shapes: each ==
    the spawned rank's rgba bit for bit, every raster == the plain raster,
    every light map == the plain twin (as many as the rank launched K5),
    and the same chain with the plain row gather == the K3 chain in rgba
    and every FrameState field; every K6 and K7 call == its plain twin (as
    many as the rank launched). These are the script's references: their
    launches do not count. Returns the rasters checked."""
    import datetime

    import torch.distributed as dist

    from funky_tpu_torch import entry
    from funky_tpu_torch.ops import gather_cuda
    from funky_tpu_torch.parallel import make_mesh

    checked, maps, taps = 0, [], []
    stage_calls = collections.Counter()
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{td}/store", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh(1, device=dev.type)
            scene, params, _ = entry.flagship_scene(dev.type)
            for name, cfg, n_frames, want in (
                    ("toy", entry.dryrun_config(1), 1, out["frame"]),
                    ("perf-mode", entry.dryrun_config(1, entry.PERF_FLAGS), 2,
                     out["perf_frame"])):
                box = {}
                with checked_stages(f"{label} {name}") as counted:
                    calls = record_raster_calls(lambda: box.update(
                        maps=record_light_maps(lambda: box.update(
                            taps=record_filter_calls(lambda: box.update(
                                run=entry._sharded_frames(
                                    mesh, cfg, scene, params, n_frames,
                                    dev.type)))))))
                for k in STAGE_KERNELS:
                    stage_calls[k] += counted[k]
                rgba, state, _ = box["run"]
                check(bits_equal(rgba.cpu(), want), f"{label}: the {name} "
                      f"frame in process differs from the dry run's rank")
                check(len(calls) > 0, f"{label}: {name}: no raster recorded")
                check_rasters_bitwise(calls, f"{label} {name}")
                maps += box["maps"]
                taps += box["taps"]
                k3 = gather_cuda.LAUNCHES
                with plain_gathers():
                    prgba, pstate, _ = entry._sharded_frames(
                        mesh, cfg, scene, params, n_frames, dev.type)
                check(gather_cuda.LAUNCHES == k3,
                      f"{label}: {name}: the plain-gather run launched K3")
                check_fields_equal([(rgba,) + tuple(state)],
                                   [(prgba,) + tuple(pstate)], f"{label} "
                                   f"{name}", "K3 vs plain row gather differ")
                checked += len(calls)
            # the rank ran the same frames, so its K5 launches are these
            check(len(maps) > 0, f"{label}: the perf-mode frames built no "
                  f"light map")
            check_light_maps(maps, out["launches"]["light_map"],
                             f"{label} perf-mode")
            check_filter_calls(taps, out["launches"], f"{label} dry run")
            check(all(stage_calls[k] == out["launches"][k]
                      for k in STAGE_KERNELS),
                  f"{label}: K8-K10 calls held against the twins in "
                  f"process {dict(stage_calls)}, the rank launched "
                  f"{out['launches']}")
        finally:
            dist.destroy_process_group()
    return checked


def phase_entry(dev):
    """funky_tpu_torch/entry.py (the port of __graft_entry__.py): entry()'s
    fn for 3 chained poses, every raster of it == the plain raster, the
    chain again with the plain row gather == the K3 chain, and
    compiled_gltf_frame of its config == the eager chain, in rgba and
    every FrameState field bit for bit; then dryrun_multichip(1), a
    one-rank NCCL group in a spawned process (the toy frame and 2
    perf-mode frames, checked in the rank), 4 gathers on the raster path
    and 3 per perf-mode frame, and dryrun_references at the same shapes.
    Returns the launch counts of entry(), the eager and the compiled
    chains and the dry run's rank (counted there)."""
    import torch

    from funky_tpu_torch import entry, frame
    from funky_tpu_torch.ops import gather_cuda

    label = "entry"
    reset_counts()
    t0 = time.perf_counter()
    fn, (scene, params, state) = entry.entry()
    tune_s = time.perf_counter() - t0
    tuned = read_counts()
    cfg = fn.keywords["cfg"]
    check(all(bits_equal(a, b) for a, b in
              zip(state, frame.init_frame_state(cfg, dev))),
          f"{label}: entry's state is not a fresh FrameState")
    poses = [params] + [frame.orbit_params(params, i) for i in (1, 2)]
    box = {}
    calls = record_raster_calls(lambda: box.update(
        eager=gltf_frames(fn, scene, poses, cfg, dev)["frames"]))
    eager = box["eager"]
    counts = read_counts()
    # the script's references, after the counts are read
    rasters = (counts["raster_table"] + counts["raster_padded"]
               - tuned["raster_table"] - tuned["raster_padded"])
    check(len(calls) == rasters and rasters >= len(poses),
          f"{label}: {len(calls)} rasters recorded, {rasters} launched by "
          f"{len(poses)} frames")
    err = check_rasters_bitwise(calls, label)
    k3 = gather_cuda.LAUNCHES
    with plain_gathers():
        plain = gltf_frames(fn, scene, poses, cfg, dev)["frames"]
    check(gather_cuda.LAUNCHES == k3, f"{label}: the plain-gather run "
          f"launched K3")
    check_fields_equal(eager, plain, label, "K3 vs plain row gather differ")
    check(counts["pair_taps"] > 0 and counts["group_counts"] > 0,
          f"{label}: K6 or K7 not launched: {counts}")
    verify_filter(label, lambda: gltf_frames(fn, scene, poses, cfg, dev))
    reset_counts()
    compiled = frame.compiled_gltf_frame(cfg)
    check(compiled.uses_graph(dev), f"{label}: the config is not recorded")
    graph = gltf_frames(compiled, scene, poses, cfg, dev)["frames"]
    counts = {k: counts[k] + v for k, v in read_counts().items()}
    check_fields_equal(eager, graph, label,
                       "entry's fn differs from compiled_gltf_frame")
    check(all(bool(torch.isfinite(f[0]).all()) for f in eager),
          f"{label}: non-finite")
    say(f"{label}: entry() on the "
        f"{'glTF Duck' if entry.find_scene() else 'ground plane only'} "
        f"scene, tuned in {tune_s:.1f} s: {len(poses)} chained frames of fn; "
        f"K1 == plain raster bit for bit on all {len(calls)} rasters "
        f"(max |depth| {err}); with the plain row gather == the K3 chain; "
        f"compiled_gltf_frame == fn, rgba and every FrameState field bit "
        f"for bit; launches {counts}, at capture "
        f"{getattr(compiled.last, 'launches', None)}")
    out = entry.dryrun_multichip(1)
    check(out["gathers"] == 4 and out["perf_gathers"] == 3,
          f"{label}: dry run gathers {out['gathers']}, "
          f"{out['perf_gathers']} per perf-mode frame")
    check(out["backend"] == "nccl", f"{label}: dry run over {out['backend']}")
    check(out["launches"]["raster_table"] > 0
          and out["launches"]["row_gather"] > 0,
          f"{label}: the dry run's rank launched {out['launches']}")
    n_ref = dryrun_references(dev, out, label)
    say(f"{label}: dryrun_multichip(1) over NCCL in {out['seconds']:.1f} s, "
        f"rank launches {out['launches']}; again in process on a one-rank "
        f"NCCL group: == the rank's frames bit for bit, K1 == plain raster "
        f"on all {n_ref} rasters, the plain row gather == K3 [{_GPU}]")
    return {k: counts[k] + out["launches"].get(k, 0) for k in counts}, err


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
    k11 = phase_quad_pack(dev)
    phase_gather_cases(dev)
    phase_filter_cases(dev)
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
     k2_culled, k3_large, k2_launches) = phase_large(dev)
    say(f"large scene per frame (5 rasters): K1 {k1_large:.4f} ms, K2 on "
        f"the same rasters {k2_ms:.4f} ms, plain {k2_plain:.4f} ms, K2 bound "
        f"{k2_bound:.4f} ms, culled bound {k2_culled:.4f} ms [{_GPU}]")
    table_routes = phase_table_route(dev)
    for key, t in BIN_TIMES.items():
        say(f"K12 per {key} frame ({t['calls']} calls): {t['ms']:.4f} ms, "
            f"the twin {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"(bytes) [{_GPU}]")
    g_ms, g_plain, g_lib, g_bound, g_err = phase_gather(dev, scene, params)
    g_frames = phase_gather_frames(dev, scene, params, shipped_cfg)
    k3_per_frame = {"dense": dense_run["k3"], "default": default_run["k3"],
                    "shipped": k3_shipped, "large": k3_large}
    cube_counts, _, _ = phase_cube(dev)
    comp_counts, comp_capture = phase_compiled_shipped(dev, scene, params,
                                                       shipped_cfg)
    from funky_tpu_torch import frame

    perf_counts, perf_cfgs, k5_info = {}, {}, None
    for name, flags in PERF_MODES.items():
        _, cfg, occ, tune_s = autotune_shipped(
            dev, scene, frame.tuning_poses(params, N_TUNE), **flags)
        perf_cfgs[name] = cfg
        perf_counts[name], k3_per_frame[name], k5 = phase_perf_mode(
            dev, scene, params, name, cfg, occ, tune_s)
        k5_info = k5 or k5_info
    phase_sdf(dev)
    drv_counts, _, _, _, k4_info = phase_driver(dev)
    k1_shard, k3_shard, k5_shard = phase_sharded(dev, scene, params)
    k3_per_frame.update(k3_shard)
    bench_counts = phase_bench(dev, scene, params, shipped_cfg,
                               perf_cfgs["half_res"])
    entry_counts, err_entry = phase_entry(dev)
    err_k1 = max(err_k1, err_entry)
    shell_counts = {k: bench_counts[k] + entry_counts[k]
                    for k in bench_counts}
    say(f"launches on the bench and entry paths (autotunes, eager frames, "
        f"warm-ups and captures, the dry run's rank): {shell_counts}")
    app_counts = {k: cube_counts[k] + comp_counts[k] + drv_counts[k]
                  for k in cube_counts}
    say(f"launches on the app paths (cube, compiled shipped, driver; "
        f"warm-ups and captures): {app_counts}")
    say(f"K3 launches per frame on the main paths: {k3_per_frame}")
    check(all(n > 0 for n, _ in FILTER_CHECKED.values()),
          f"K6 / K7 calls held against their twins: {FILTER_CHECKED}")
    check(all(n > 0 for n, _ in STAGE_CHECKED.values()),
          f"K8-K10 calls held against their twins: {STAGE_CHECKED}")
    stage_launches = {k: sum(v[k] for v in STAGE_RUNS.values())
                      + app_counts[k] + shell_counts[k]
                      for k in STAGE_KERNELS}
    stage_per_frame = {k: {key: v[k] / v["frames"]
                           for key, v in STAGE_RUNS.items()}
                       for k in STAGE_KERNELS}
    held = {k: v[0] for k, v in STAGE_CHECKED.items()}
    say(f"K8-K10 launches on the main paths {stage_launches}; calls held "
        f"against the twins {held}, counted at captures "
        f"{dict(STAGE_CAPTURED)}")
    for k in STAGE_KERNELS:
        say(f"{k} launches per frame on the main paths: "
            f"{stage_per_frame[k]}")
    for key, times in STAGE_TIMES.items():
        for k, t in times.items():
            say(f"{k} per {key} frame ({t['calls']} calls, {t['live']} live "
                f"of {t['slots']} pixels or slots): kernel {t['ms']:.4f} ms "
                f"(device time behind a sleep), the plain twin "
                f"{t['plain_ms']:.4f} ms (device time of a graph replay), "
                f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}: "
                f"{t['bytes']} B, {t['ops']:.0f} FP32 operations) [{_GPU}]")
    filter_per_frame = [{k: v[i] / v[2] for k, v in FILTER_RUNS.items()}
                        for i in (0, 1)]
    say(f"K6 launches per frame on the main paths: {filter_per_frame[0]}; "
        f"K7: {filter_per_frame[1]}")
    dense_taps, ship_taps, hist = (FILTER_TIMES[k] for k in (
        "dense", "shipped", "histogram"))
    for key, t in (("dense", dense_taps), ("shipped", ship_taps)):
        say(f"K6 per {key} frame ({t['calls']} calls, {t['entries']} "
            f"entry slots, {t['live']} live; [live, slots] per call "
            f"{t['live_per_call']}, lanes per entry {t['lanes']}): through "
            f"its wrapper {t['ms']:.4f} ms (device time "
            f"behind a sleep), the plain twins {t['plain_ms']:.4f} ms (device "
            f"time of a graph replay); "
            f"bound {t['bound_ms']:.5f} ms on the live entries "
            f"({t['bound_by']}: {t['bytes']} B, {t['ops']} FP32 operations)"
            f" [{_GPU}]")
    say(f"K7 per shipped frame ({hist['entries']} entries, "
        f"{hist['n_groups']} groups; {hist['launches_per_call']} launch per "
        f"call, graph nodes {hist['graph_nodes']}): kernel "
        f"{hist['ms']:.4f} ms, plain "
        f"{hist['plain_ms']:.4f} ms, torch.bincount {hist['library_ms']:.4f}"
        f" ms ({hist['library_syncs']} synchronising calls reported), bound "
        f"{hist['bound_ms']:.5f} ms (bytes) [{_GPU}]")
    say(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [
        dict(name="raster_table", route="cuda",
             source="funky_tpu_torch/csrc/raster.cu",
             replaces="funky_tpu/ops/raster_pallas.py:208",
             launches=(counts["raster_table"] + k1_shipped
                       + app_counts["raster_table"]
                       + sum(c["raster_table"] for c in perf_counts.values())
                       + k1_shard + shell_counts["raster_table"]),
             max_abs_err=err_k1, ms=k1_ms,
             plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None, bound_culled_ms=k1_culled),
        dict(name="raster_padded", route="cuda",
             source="funky_tpu_torch/csrc/raster.cu",
             replaces="funky_tpu/ops/raster_pallas.py:90",
             launches=k2_launches, max_abs_err=err_k2,
             ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, bound_culled_ms=k2_culled,
             timed_on="the large scene's five rasters at GltfConfig()'s "
                      "capacities (launches: the table limit at 0)",
             table_routes=table_routes),
        dict(name="binning", route="cuda",
             source="funky_tpu_torch/csrc/binning.cu",
             replaces="funky_tpu/ops/binning.py:150",
             launches=(large_counts["binning"] + app_counts["binning"]
                       + shell_counts["binning"]
                       + sum(c["binning"] for c in perf_counts.values())),
             max_abs_err=float(BIN_CHECKED[1]),
             checked=BIN_CHECKED[0], ms=BIN_TIMES["rastered"]["ms"],
             plain_ms=BIN_TIMES["rastered"]["plain_ms"],
             bound_ms=BIN_TIMES["rastered"]["bound_ms"], bound_by="bytes",
             library_ms=None,
             timed_on="the rastered frame's five binnings at its tuned "
                      "capacities (ms: behind a sleep)",
             frame_ms={k: v["ms"] for k, v in BIN_TIMES.items()},
             frame_plain_ms={k: v["plain_ms"] for k, v in BIN_TIMES.items()},
             frame_bound_ms={k: v["bound_ms"]
                             for k, v in BIN_TIMES.items()}),
        dict(name="row_gather", route="cuda",
             source="funky_tpu_torch/csrc/gather.cu",
             replaces="experiments/bench_gather.py:160",
             launches=(sum(sum(v) for v in k3_per_frame.values())
                       + app_counts["row_gather"]
                       + shell_counts["row_gather"]),
             max_abs_err=g_err, ms=g_ms, plain_ms=g_plain,
             bound_ms=g_bound, bound_by="bytes", library_ms=g_lib,
             timed_on="PCF tap set: (16, 1080, 1920) int32 rows of 16 B from "
                      "the 268 MB cascade table",
             launches_per_frame=k3_per_frame,
             frame_ms={k: v[0] for k, v in g_frames.items()},
             frame_plain_ms={k: v[1] for k, v in g_frames.items()},
             frame_bound_ms={k: v[2] for k, v in g_frames.items()}),
        dict(name="overlay_raster", route="cuda",
             source="funky_tpu_torch/csrc/overlay.cu",
             replaces="funky_tpu/passes/overlay.py:26",
             launches=k4_info["launches"], max_abs_err=k4_info["err"],
             ms=k4_info["ms"], plain_ms=k4_info["plain_ms"],
             bound_ms=k4_info["bound_ms"], bound_by=k4_info["bound_by"],
             library_ms=None,
             timed_on="the driver's debug panel, 256x384 (plain: host "
                      "clock, its launches included)",
             toggled_ms=k4_info["toggled_ms"],
             render_over_ms=k4_info["parts"]),
        dict(name="light_map", route="cuda",
             source="funky_tpu_torch/csrc/lightmap.cu",
             replaces="funky_tpu/passes/shadow_lightspace.py:210",
             launches=(sum(c["light_map"] for c in perf_counts.values())
                       + app_counts["light_map"] + k5_shard
                       + shell_counts["light_map"]),
             max_abs_err=k5_info["err"], ms=k5_info["k5_ms"],
             plain_ms=k5_info["plain_ms"], bound_ms=k5_info["bound_ms"],
             bound_by=k5_info["bound_by"], library_ms=None,
             timed_on="the light-space frame's maps, windows "
                      f"{[m['wc'] for m in k5_info['maps']]}, summed (ms: "
                      "K5's own device time; plain_ms behind a sleep)",
             call_graph_ms=k5_info["frame_graph_ms"],
             taps_graph_ms=k5_info["taps_ms"],
             plain_graph_ms=k5_info["plain_graph_ms"],
             per_window=[[m["wc"], m["k5_ms"], m["kernel_graph_ms"],
                          m["plain_graph_ms"]] for m in k5_info["maps"]]),
        dict(name="pair_taps", route="cuda",
             source="funky_tpu_torch/csrc/pair_taps.cu",
             replaces="funky_tpu/passes/shadow_filter.py:159",
             launches=(sum(v[0] for v in FILTER_RUNS.values())
                       + app_counts["pair_taps"]
                       + shell_counts["pair_taps"]),
             max_abs_err=FILTER_CHECKED["pair_taps"][1], ms=ship_taps["ms"],
             plain_ms=ship_taps["plain_ms"], bound_ms=ship_taps["bound_ms"],
             bound_by=ship_taps["bound_by"], library_ms=None,
             timed_on=f"the shipped frame's {ship_taps['calls']} pair groups "
                      f"({ship_taps['entries']} entry slots, "
                      f"{ship_taps['live']} live), summed (ms: K6 through "
                      f"its wrapper behind a sleep; plain_ms: the twins as "
                      f"a replayed CUDA graph; bound_ms: the live entries' "
                      f"work)",
             live_per_call=ship_taps["live_per_call"],
             checked_calls=FILTER_CHECKED["pair_taps"][0],
             launches_per_frame=filter_per_frame[0],
             frame_ms={"dense": dense_taps["ms"], "shipped": ship_taps["ms"]},
             frame_plain_ms={"dense": dense_taps["plain_ms"],
                             "shipped": ship_taps["plain_ms"]},
             frame_bound_ms={"dense": dense_taps["bound_ms"],
                             "shipped": ship_taps["bound_ms"]}),
        dict(name="group_counts", route="cuda",
             source="funky_tpu_torch/csrc/group_counts.cu",
             replaces="funky_tpu/passes/shadow_filter.py:714",
             launches=(sum(v[1] for v in FILTER_RUNS.values())
                       + app_counts["group_counts"]
                       + shell_counts["group_counts"]),
             max_abs_err=FILTER_CHECKED["group_counts"][1], ms=hist["ms"],
             plain_ms=hist["plain_ms"], bound_ms=hist["bound_ms"],
             bound_by=hist["bound_by"], library_ms=hist["library_ms"],
             timed_on=f"the shipped frame's histogram, {hist['entries']} "
                      f"pairs into {hist['n_groups']} groups (library: "
                      f"torch.bincount of the masked keys, by CUDA events)",
             library_syncs=hist["library_syncs"],
             launches_per_call=hist["launches_per_call"],
             graph_nodes=hist["graph_nodes"],
             checked_calls=FILTER_CHECKED["group_counts"][0],
             launches_per_frame=filter_per_frame[1]),
        dict(name="quad_pack", route="cuda",
             source="funky_tpu_torch/csrc/quad_pack.cu",
             replaces="funky_tpu/ops/sampling.py:192",
             launches=app_counts["quad_pack"] + shell_counts["quad_pack"],
             launches_at_capture=comp_capture["quad_pack"],
             max_abs_err=0.0, ms=k11[QUAD_PACK_SHAPES[0]]["ms"],
             plain_ms=k11[QUAD_PACK_SHAPES[0]]["plain_ms"],
             bound_ms=k11[QUAD_PACK_SHAPES[0]]["bound_ms"],
             bound_by="bytes", library_ms=None,
             timed_on="the shipped frame's 4 x 2048^2 cascade maps (ms: "
                      "behind a sleep; plain_ms: the twin's cats and "
                      "stack)",
             shapes={str(k): v for k, v in k11.items()}),
    ]
    stage_sources = {
        "contact_front": ("funky_tpu_torch/csrc/contact.cu",
                          "funky_tpu/passes/contact.py:76"),
        "contact_certify": ("funky_tpu_torch/csrc/contact.cu",
                            "funky_tpu/passes/contact.py:590"),
        "contact_march": ("funky_tpu_torch/csrc/contact.cu",
                          "funky_tpu/passes/contact.py:124"),
        "class_maps": ("funky_tpu_torch/csrc/class_maps.cu",
                       "funky_tpu/passes/shadow_classify.py:199")}
    for k in STAGE_KERNELS:
        t = STAGE_TIMES["shipped"][k]
        kernels.append(dict(
            name=k, route="cuda", source=stage_sources[k][0],
            replaces=stage_sources[k][1], launches=stage_launches[k],
            max_abs_err=STAGE_CHECKED[k][1], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None,
            timed_on=f"the shipped frame's {t['calls']} call(s), "
                     f"{t['live']} live of {t['slots']} pixels, slots or "
                     f"cells (ms: the kernel behind a sleep; plain_ms: the "
                     f"twin as a replayed CUDA graph)",
            checked_calls=STAGE_CHECKED[k][0],
            captured_calls=STAGE_CAPTURED[k],
            **({"also_replaces": "funky_tpu/passes/contact.py:764 (stage "
                                 "3's compaction, the compact mode)"}
               if k == "contact_certify" else {}),
            launches_per_frame=stage_per_frame[k],
            frame_ms={key: v[k]["ms"] for key, v in STAGE_TIMES.items()
                      if k in v},
            frame_plain_ms={key: v[k]["plain_ms"]
                            for key, v in STAGE_TIMES.items() if k in v},
            frame_bound_ms={key: v[k]["bound_ms"]
                            for key, v in STAGE_TIMES.items() if k in v}))
    say(_GPU)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
