"""The port's two entry points of __graft_entry__.py: the flagship
frame with its inputs, and a dry run of the row-sharded frame.

    from funky_tpu_torch.entry import dryrun_multichip, entry
    fn, (scene, params, state) = entry()        # on the card
    rgba, state = fn(scene, params, state)
    dryrun_multichip(1)                         # NCCL, one rank per card
    dryrun_multichip(4, device="cpu")           # gloo, 4 processes

Both run on the card unless the caller asks for the CPU. The scene is the
reference's glTF Duck where the checkout holds it at models/scene.gltf,
else the ground plane alone (__graft_entry__.py:11-18 renders
build_device_scene(None) then too). bench_torch.py renders the same
scene in the same configuration.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import math
import os
import pathlib
import sys
import tempfile
import time

import torch

from . import frame
from .frame import GltfConfig, GltfFrameFlags
from .models.gltf import GltfScene
from .models.scene import build_device_scene
from .ops.raster import RasterConfig
from .utils import autotune

REPO = pathlib.Path(__file__).resolve().parent.parent
# bench.py:32-35 also searches an absolute path outside the checkout; the
# port reads nothing outside its checkout.
DUCK_PATH = REPO / "models" / "scene.gltf"
TUNE_FRAMES = 24      # bench.py's n = max(BENCH_FRAMES, 24) (bench.py:137)
DRYRUN_TIMEOUT_S = 300
# __graft_entry__'s perf trio (__graft_entry__.py:165-167)
PERF_FLAGS = GltfFrameFlags(light_space_ground_shadows=True,
                            skip_backfacing_shadows=True,
                            synth_shadow_maps=True)


def find_scene() -> GltfScene | None:
    """The Duck (bench.py:73-80) at DUCK_PATH, else None."""
    return GltfScene.load(DUCK_PATH) if DUCK_PATH.exists() else None


def flagship_scene(device="cuda"):
    """(scene, params, name): the Duck and the ground, or the ground alone,
    on `device`, with the default camera (bench.py:73-80, 134); name is
    "glTF Duck" or "ground plane only"."""
    gltf = find_scene()
    min_y = float(gltf.bounds_min[1]) if gltf else 0.0
    return (build_device_scene(gltf, device=device),
            frame.default_gltf_params(gltf_min_y=min_y, device=device),
            "glTF Duck" if gltf else "ground plane only")


def shipped_config() -> GltfConfig:
    """bench.py's configuration before tuning (bench.py:102-133):
    1920x1080, 4 x 2048^2 cascades, PCSS + TAA + contact, committed mode
    with synthesized cascade maps."""
    return GltfConfig(flags=GltfFrameFlags(committed=True,
                                           synth_shadow_maps=True))


def entry(device="cuda"):
    """(fn, (scene, params, state)) for the flagship frame
    (__graft_entry__.py:21-41): the shipped configuration autotuned over
    frame.tuning_poses(params, 24), the config bench_torch.py runs;
    fn(scene, params, state) -> (rgba, new_state) is render_gltf_frame."""
    scene, params, _ = flagship_scene(device)
    return _entry(scene, params, shipped_config())


def tune(scene, poses, cfg: GltfConfig, verbose=False) -> GltfConfig:
    """utils/autotune.py's two steps over `poses`, raster bins then the
    sparse capacities, with autotune_config's report on stderr when
    verbose. A failed step raises: autotune_config, as JAX's, would carry
    on with that step's defaults, and an entry point or a bench line must
    not run an untuned config."""
    cfg = autotune.tune_raster_capacities(scene, poses, cfg)
    if verbose:
        print(f"# autotune: raster capacity {cfg.raster.capacity}, shadow "
              f"{cfg.shadow_raster.capacity}", file=sys.stderr)
    cfg, occ = autotune.tune_sparse_capacities(scene, poses, cfg)
    if verbose:
        print(f"# autotune: occupancy {occ} -> pen {cfg.shadow_pen_capacity}"
              f", contact {cfg.contact_capacity}/"
              f"{cfg.contact_march_capacity}, slab rows "
              f"{cfg.valid_slab_rows}, valid blocks "
              f"{cfg.valid_block_capacity}, tap windows "
              f"{cfg.shadow_tap_windows}", file=sys.stderr)
    return cfg


def _entry(scene, params, cfg: GltfConfig):
    """entry() for a given scene, params and untuned config."""
    cfg = tune(scene, frame.tuning_poses(params, TUNE_FRAMES), cfg)
    state = frame.init_frame_state(cfg, params.camera_pos.device)
    return (functools.partial(frame.render_gltf_frame, cfg=cfg),
            (scene, params, state))


def dryrun_config(n_devices: int, flags=None) -> GltfConfig:
    """__graft_entry__.py:80-84's toy frame: 256 x 8n, n tile-aligned
    slabs of 8 rows, 8x128 tiles of capacity 256. The maps are S^2 with S
    the least multiple of 8n that the 16-texel class-map cells divide:
    8n, as in JAX, for an even n; 16 at n = 1, where JAX's 8^2 maps fail
    the class maps' assert. The raster backend is "auto" (K1 on the
    card); JAX's "jnp" there serves its CPU fallback."""
    tile = RasterConfig(tile_h=8, tile_w=128, capacity=256)
    cfg = GltfConfig(width=256, height=8 * n_devices, raster=tile,
                     shadow_raster=tile, flags=flags or GltfFrameFlags())
    return dataclasses.replace(
        cfg, shadow_map_size=math.lcm(8 * n_devices, cfg.class_coarse))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The row-sharded frame on an n-rank "rows" mesh
    (__graft_entry__.py:44-185): n spawned processes, over NCCL with one
    card each on the card, over gloo on the CPU. One frame of the toy
    config, checked for its shape, finite values and frame_index == 1,
    then the perf-mode run (light-space ground PCSS, back-face skip,
    synthesized maps) for 2 temporal frames in the same ranks. Prints
    JAX's ok lines, with the row all-gathers per frame counted from
    parallel/sharded_frame.py's _gather_rows (JAX counts them in the HLO
    text). Returns rank 0's results: "frame" and "perf_frame" (rgba on the
    CPU), "gathers" and "perf_gathers" (per frame), "launches" (K1 and K3
    in the rank), "backend" and "seconds".

    With fewer cards than ranks on the card this raises: JAX falls back to
    virtual CPU devices (__graft_entry__.py:56-67), the port does not fall
    back quietly. A rank that fails raises here; so does a group still
    running after DRYRUN_TIMEOUT_S (its processes are killed)."""
    import torch.multiprocessing as mp

    kind = torch.device(device).type
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): {torch.cuda.device_count()} "
            f"CUDA device(s), one per rank needed; pass device='cpu' to run "
            f"the ranks on the CPU over gloo")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as td:
        ctx = mp.spawn(_dryrun_rank, args=(n_devices, kind, td),
                       nprocs=n_devices, join=False)
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"dryrun_multichip({n_devices}): ranks still "
                        f"running after {DRYRUN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = torch.load(pathlib.Path(td) / "rank0.pt")
    out["seconds"] = time.monotonic() - t0
    mesh = {"rows": n_devices}
    print(f"dryrun_multichip({n_devices}): ok — "
          f"{tuple(out['frame'].shape)} frame on {mesh} mesh "
          f"({out['backend']})")
    print(f"dryrun_multichip({n_devices}): perf-mode ok — "
          f"{tuple(out['perf_frame'].shape)} frame, 2 temporal frames, "
          f"{out['perf_gathers']} all-gathers per frame (synth maps: no "
          f"cascade exchange)")
    return out


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _sharded_frames(mesh, cfg, scene, params, n_frames: int, device):
    """n_frames chained frames of sharded_gltf_frame from a fresh state,
    checked as __graft_entry__.py:94-97 checks one: (the last rgba, the
    last state, the gathers of each frame)."""
    from .parallel import sharded_frame as sf

    fn = sf.sharded_gltf_frame(mesh, cfg)
    state = frame.init_frame_state(cfg, device)
    gathers = []
    for _ in range(n_frames):
        before = sf.GATHERS
        rgba, state = fn(scene, params, state)
        gathers.append(sf.GATHERS - before)
    label = f"dryrun_multichip({mesh.size()})"
    _check(tuple(rgba.shape) == (cfg.height, cfg.width, 4),
           f"{label}: frame shape {tuple(rgba.shape)}")
    _check(bool(torch.isfinite(rgba).all()), f"{label}: non-finite frame")
    _check(int(state.frame_index) == n_frames,
           f"{label}: frame_index {int(state.frame_index)} after "
           f"{n_frames} frames")
    return rgba, state, gathers


def _dryrun_rank(rank: int, n: int, kind: str, work_dir: str) -> None:
    """One rank of dryrun_multichip: both runs; rank 0 saves its results
    to work_dir/rank0.pt."""
    import torch.distributed as dist

    from .ops import gather_cuda, raster_cuda
    from .parallel import make_mesh

    os.environ["LOCAL_RANK"] = str(rank)    # make_mesh's card
    if kind == "cpu":
        torch.set_num_threads(1)    # n ranks share the host's cores
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        init_method=f"file://{work_dir}/store", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=DRYRUN_TIMEOUT_S))
    try:
        mesh = make_mesh(n, device=kind)
        scene, params, _ = flagship_scene(kind)
        k1, k3 = raster_cuda.LAUNCHES, gather_cuda.LAUNCHES
        rgba, _, gathers = _sharded_frames(mesh, dryrun_config(n), scene,
                                           params, 1, kind)
        perf, _, perf_gathers = _sharded_frames(
            mesh, dryrun_config(n, PERF_FLAGS), scene, params, 2, kind)
        _check(len(set(perf_gathers)) == 1,
               f"perf-mode gathers per frame differ: {perf_gathers}")
        if rank == 0:
            torch.save(dict(
                frame=rgba.cpu(), perf_frame=perf.cpu(), gathers=gathers[0],
                perf_gathers=perf_gathers[0],
                backend=dist.get_backend(),
                launches={"raster_table": raster_cuda.LAUNCHES - k1,
                          "row_gather": gather_cuda.LAUNCHES - k3}),
                pathlib.Path(work_dir) / "rank0.pt")
    finally:
        dist.destroy_process_group()
