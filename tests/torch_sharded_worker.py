"""Helpers of tests/test_torch_parallel.py and chip_smoke.py for the
row-sharded frame (funky_tpu_torch/parallel): the rank body the tests
spawn over gloo, and the one-process composition of the sharded frame's
stages for n ranks. Imports no jax. Not a test module itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import pathlib
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from funky_tpu_torch import frame
from funky_tpu_torch.models.gltf import GltfScene
from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
from funky_tpu_torch.models.scene import build_device_scene
from funky_tpu_torch.ops import compact
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.parallel import make_mesh, sharded_gltf_frame
from funky_tpu_torch.parallel import sharded_frame as sf

from .torch_host_reads import host_reads

# __graft_entry__'s perf trio (the light-space ground evaluation, the
# back-face skip and the synthesized maps).
TRIO = dict(light_space_ground_shadows=True, skip_backfacing_shadows=True,
            synth_shadow_maps=True)
# bench.py's shipped flags (bench.py:129-130)
SHIPPED = dict(committed=True, synth_shadow_maps=True)
# case -> (flags, chained frames: one parked pose, then bench.py's orbit)
CASES = {"default": ({}, 3), "trio": (TRIO, 2), "committed": (SHIPPED, 3)}
TIMEOUT_S = 120


def small_config(**flags) -> frame.GltfConfig:
    """tests/test_parallel.py:24-30's size: 256x128, 128^2 maps, 8x128
    tiles of capacity 256, GltfConfig()'s other defaults. A committed
    config also gets capacities that hold every entry at this size (and
    the dense back half and textures, which have no budget): where a
    cond'd frame takes the exact dense path, a committed one truncates."""
    tile = RasterConfig(tile_h=8, tile_w=128, capacity=256)
    cfg = frame.GltfConfig(width=256, height=128, shadow_map_size=128,
                           raster=tile, shadow_raster=tile,
                           flags=frame.GltfFrameFlags(**flags))
    if not cfg.flags.committed:
        return cfg
    n = cfg.width * cfg.height
    return dataclasses.replace(cfg, shadow_pen_capacity=2 * n,
                               contact_capacity=n, contact_march_capacity=n,
                               valid_block_capacity=0,
                               texture_block_capacity=0)


def conded(cfg: frame.GltfConfig) -> frame.GltfConfig:
    return dataclasses.replace(cfg, flags=dataclasses.replace(
        cfg.flags, committed=False))


def multimesh(device):
    """The multimesh scene through the port's own loader, and its params."""
    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(
            pathlib.Path(td) / "multi.glb", two_textures=True))
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=device)
    return build_device_scene(gltf, device=device), params


def poses(params, n: int) -> list:
    return [params] + [frame.orbit_params(params, i) for i in range(1, n)]


def compose_frame(scene, params, state, cfg, n: int, stage=None):
    """The sharded frame's stages for n ranks in one process, torch.cat in
    place of each gather: (rgba, new_state) as every rank returns them.
    `stage(key, fn)` runs each stage and returns its result (default:
    fn()); key is "front" for the replicated stages (computed whole on
    every rank) and the rank for a slab's own."""
    run = stage or (lambda key, fn: fn())
    slab_h, sm_slab = sf.slab_rows(cfg, n)
    front = run("front", lambda: sf.replicated_front(scene, params, state,
                                                      cfg))
    maps = (None, None, None)
    if cfg.flags.enable_shadows:
        if sf.synthesizes(cfg, front):
            raw_maps = run("front", lambda: sf.synth_cascades(scene, front,
                                                              cfg))
        else:
            slabs = torch.cat([run(r, lambda r=r: sf.cascade_slab(
                scene, front, cfg, r * sm_slab, sm_slab)) for r in range(n)])
            raw_maps = run("front", lambda: sf.join_cascade_slabs(slabs, n))
        maps = run("front", lambda: sf.replicated_maps(front, raw_maps, cfg))
    slabs = [run(r, lambda r=r: sf.frame_slab(scene, state, front, maps, cfg,
                                              r * slab_h, slab_h))
             for r in range(n)]
    rgba, history, depth = (torch.cat(parts) for parts in zip(*slabs))
    return rgba, sf.next_state(front, state, history, depth)


@contextlib.contextmanager
def counted_gathers():
    """Records the shape, dtype and bytes in of every `_gather_rows`."""
    calls = []
    gather = sf._gather_rows

    def record(x, group):
        calls.append((tuple(x.shape), x.dtype,
                      x.numel() * x.element_size()))
        return gather(x, group)

    sf._gather_rows = record
    try:
        yield calls
    finally:
        sf._gather_rows = gather


def run_chain(fn, scene, pose_list, cfg, device) -> list:
    """Chained frames of fn(scene, params, state): per frame (rgba, history,
    depth) on the CPU, the number of gathers it made, its host branches
    (`syncs`) with the synthesized maps' full-raster fallbacks among them,
    and the device values it read on the host (tests/torch_host_reads.py;
    the plain raster's own reads aside)."""
    state = frame.init_frame_state(cfg, device)
    out = []
    for p in pose_list:
        compact.reset_host_syncs()
        with counted_gathers() as calls, host_reads() as reads:
            rgba, state = fn(scene, p, state)
        out.append(dict(rgba=rgba.cpu(), history=state.shadow_history.cpu(),
                        depth=state.prev_depth.cpu(), gathers=len(calls),
                        frame_index=int(state.frame_index),
                        syncs=compact.HOST_SYNCS,
                        fallbacks=compact.BRANCHES[("synth_window_fit",
                                                    False)],
                        reads=list(reads.reads)))
    return out


def run_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One gloo rank: every case of CASES through sharded_gltf_frame, and
    a committed case's config cond'd (`<case>_conded`), saved to
    out_dir/rank<r>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh(world, device="cpu")
        scene, params = multimesh("cpu")
        out = {}
        for name, (flags, n) in CASES.items():
            cfg = small_config(**flags)
            out[name] = run_chain(sharded_gltf_frame(mesh, cfg), scene,
                                  poses(params, n), cfg, "cpu")
            if cfg.flags.committed:
                out[name + "_conded"] = run_chain(
                    sharded_gltf_frame(mesh, conded(cfg)), scene,
                    poses(params, n), cfg, "cpu")
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, work_dir: pathlib.Path,
                timeout: float = 4 * TIMEOUT_S) -> list:
    """Runs run_rank on `world` spawned processes and returns each rank's
    results. A rank that fails, or a group that hangs past `timeout`
    seconds, raises."""
    work_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(run_rank, args=(world, str(work_dir / "store"),
                                   str(work_dir)),
                   nprocs=world, join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while not ctx.join(timeout=1.0):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"{world} gloo ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(work_dir / f"rank{r}.pt") for r in range(world)]
