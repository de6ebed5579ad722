"""The rastered deployment on the CPU: the large scene's committed frame
with its cascades rastered in full (benchmark/configs/rastered.json),
against the benchmark's bounded plain reference (benchmark/reference/
rastered.py); that reference's bounded raster against render.py's dense
one; the tuned near-clip capacity; and the drop counters the frame adds
its dropped near-clipped triangles and bin entries to
(utils/profiling.DROP_COUNTERS).

The scene is benchmark/scenes/large.py cut to a coarser terrain
(`quads`), at 160x96 with 256^2 maps, so that the plain raster twin runs
it in seconds."""

import dataclasses
import json
import pathlib
import sys
import tempfile

import numpy as np
import pytest
import torch

from funky_tpu_torch import frame
from funky_tpu_torch.ops.clipping import near_crossing
from funky_tpu_torch.utils import autotune, profiling

from .test_torch_compiled import SMALL, multimesh
from .torch_host_reads import host_reads

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import compare, manifest, program, traffic  # noqa: E402
from reference import scene as rs  # noqa: E402

# The plain raster twin runs thousands of small operations a frame: with a
# thread a core, workers that share the cores wait on one another's
# threads (tests/torch_parity.py sets the same).
torch.set_num_threads(2)

SIZE = {"width": 160, "height": 96, "shadow_map_size": 256}
CELL = "rastered-large-orbit"


def _config_file():
    return json.loads((BENCH / "configs" / "rastered.json").read_text())


def _traffic(poses=4):
    tr = json.loads((BENCH / "traffic" / "large-orbit.json").read_text())
    tr["poses"] = poses
    return tr


def large(quads: int, poses: int = 4):
    """(spec, program scene, traffic poses, program params) of the large
    scene at `quads`, over the first `poses` orbit poses."""
    spec = manifest.load_module("scenes", "large").build(quads=quads)
    tr = _traffic(poses)
    base = traffic.base_pose(tr, float(spec.bounds_min[1]))
    poses = [traffic.orbit_pose(base, tr, i) for i in traffic.arc(tr)]
    with tempfile.TemporaryDirectory() as td:
        scene = program.load_scene(spec, pathlib.Path(td) / "s.glb", "cpu")
    return spec, scene, poses, [program.params(p, "cpu") for p in poses]


def untuned():
    cf = _config_file()
    return program.config(cf, dict(cf["frame"], **SIZE))


@pytest.fixture(scope="module")
def tuned_run():
    """entry.tune over the four poses, then the committed frame chained
    over them forward and back, each frame's inputs and outputs kept."""
    spec, scene, poses, params = large(12)
    cfg, _ = program.tune(scene, params, untuned())
    fn = program.compiled(cfg)
    state = program.init_state(cfg, "cpu")
    frames = []
    for at in (0, 1, 2, 3, 2, 1):
        pre = tuple(t.clone() for t in state)
        with host_reads() as reads:
            rgba, state = fn(scene, params[at], state)
        frames.append((at, pre, rgba, state.shadow_history.clone(),
                       state.prev_depth.clone(), list(reads.reads)))
    return dict(spec=spec, scene=scene, poses=poses, params=params, cfg=cfg,
                frames=frames)


def test_committed_frame_matches_the_bounded_reference(tuned_run):
    """The tuned committed frame (cascades rastered in full, pre-gathered
    bins, plain twins) reads nothing on the host and agrees with
    reference/rastered.py, started from the state the program carried into
    each frame, within the cell's limits."""
    rr = manifest.load_module("reference", "rastered")
    cf = _config_file()
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    opt = rr.options(cf, dict(cf["frame"], **SIZE))
    ref_scene = rs.pack(tuned_run["spec"], "cpu")
    assert not tuned_run["cfg"].flags.synth_shadow_maps
    for i, (at, pre, rgba, hist, depth, reads) in enumerate(
            tuned_run["frames"]):
        assert reads == [], (i, reads)
        state = rr.init_state(opt, "cpu") if i == 0 else rr.State(*pre)
        with torch.no_grad():
            ref, nxt = rr.render(ref_scene, compare.ref_pose(
                tuned_run["poses"][at], "cpu", rr), state, opt)
        got = compare.numbers(rgba, hist, depth, ref, nxt.shadow_history,
                              nxt.prev_depth)
        assert all(got[k] <= limits[k] for k in got), (i, got)


def _soup(seed: int, width: int, height: int, n: int = 160):
    """Random triangles as per-corner clip positions, z across [0, 1)'s
    edges, w between 0.5 and 2, with copies of some (exact depth ties,
    the lower id first) and a sliver."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-20, -20], [width + 20, height + 20], (n, 3, 2))
    z = rng.uniform(-0.2, 1.2, (n, 3))
    w = rng.uniform(0.5, 2.0, (n, 3))
    ndc = pts / [width, height] * 2.0 - 1.0
    clip = np.concatenate([ndc * w[..., None], (z * w)[..., None],
                           w[..., None]], -1)
    clip[7, 2, :2] = clip[7, 1, :2] + 1e-3 * clip[7, 1, 3]    # a sliver
    clip = np.concatenate([clip, clip[:30], clip[40:45]])
    return torch.tensor(clip, dtype=torch.float32)


def _terrain_rasters():
    """The small terrain's cascade corners (each cascade) and main-pass
    corners after the near clip, from the reference's own stages."""
    rr = manifest.load_module("reference", "render")
    ra = manifest.load_module("reference", "rastered")
    spec, _, poses, _ = large(12, poses=2)
    cf = _config_file()
    opt = rr.options(cf, dict(cf["frame"], **SIZE))
    scene = rs.pack(spec, "cpu")
    pose = compare.ref_pose(poses[1], "cpu", rr)
    uni = rr.uniforms(pose, rr.init_state(opt, "cpu"), opt)
    world_v, tri_clip, _, _, valid = ra._main_corners(scene, uni)
    s = opt.shadow_map_size
    out = [(c, v, s, s) for c, v in ra._cascade_corners(
        world_v, scene, uni.light_view_proj)]
    return out + [(tri_clip, valid, opt.width, opt.height)]


@pytest.mark.parametrize("case", ["soup0", "soup1", "terrain"])
def test_bounded_raster_equals_dense(case):
    """rastered.raster == render.raster bit for bit, ids and depth: on
    random soups with exact depth ties and on the small terrain's four
    cascades and main pass; and `covered` counts the pairs the dense
    raster's cover test passes."""
    rr = manifest.load_module("reference", "render")
    ra = manifest.load_module("reference", "rastered")
    if case == "terrain":
        rasters = _terrain_rasters()
    else:
        clip = _soup(int(case[-1]), 96, 64)
        rasters = [(clip, torch.ones(clip.shape[0], dtype=torch.bool), 96,
                    64)]
    for tri_clip, valid, w, h in rasters:
        planes, ok = rr.setup(tri_clip, w, h, valid)
        want = rr.raster(planes, ok, w, h)
        got = ra.raster(tri_clip, planes, ok, w, h)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
        assert (want[0] >= 0).any()
        px = torch.arange(w, dtype=torch.float32)[None, :] + 0.5
        py = torch.arange(h, dtype=torch.float32)[:, None] + 0.5
        pairs = 0
        for t in torch.nonzero(ok).flatten().tolist():
            d = planes[t]
            z = d[9] * px + d[10] * py + d[11]
            pairs += int(((d[0] * px + d[1] * py + d[2] >= 0)
                          & (d[3] * px + d[4] * py + d[5] >= 0)
                          & (d[6] * px + d[7] * py + d[8] >= 0)
                          & (z >= 0.0) & (z < 1.0)).sum())
        assert ra.covered(tri_clip, planes, ok, w, h) == pairs


def test_tuned_clip_capacity_covers_every_pose():
    """tune_raster_capacities sizes clip_capacity over the poses: at least
    every pose's near-crossing count, a multiple of 64, above the
    configured 64 where more cross, so that the frame counts its clip
    drops; 64 on the multimesh scene, whose raster capacities then leave
    the frame no drop counter to add to (no operation for one)."""
    _, scene, _, params = large(48, poses=48)
    poses = params[::12] + params[-1:]
    cfg = autotune.tune_raster_capacities(scene, poses, untuned())
    crossing = []
    for p in poses:
        uni = frame.compute_frame_uniforms(p, frame.init_frame_state(
            cfg, "cpu"), cfg)
        clip = frame.geometry.transform_vertices(scene, uni.models,
                                                 uni.view_proj)[1]
        crossing.append(int(near_crossing(
            clip[scene.tri_indices.long()], scene.num_triangles,
            frame.NEAR * 0.1)[2].sum()))
    assert max(crossing) > 64
    assert cfg.clip_capacity >= max(crossing)
    assert cfg.clip_capacity % 64 == 0
    assert frame._drop_counters(scene, cfg)[:2] == (
        "clip_capacity", "raster.capacity")

    mm, mm_params = multimesh("cpu")
    base = frame.GltfConfig(flags=frame.GltfFrameFlags(
        committed=True, synth_shadow_maps=True), **SMALL)
    mm_cfg = autotune.tune_raster_capacities(
        mm, [mm_params, frame.orbit_params(mm_params, 20)], base)
    assert mm_cfg.clip_capacity == 64
    assert frame._drop_counters(mm, mm_cfg) == (None, None, None)


def _halved(cfg):
    return dataclasses.replace(
        cfg, clip_capacity=cfg.clip_capacity // 2,
        raster=dataclasses.replace(cfg.raster,
                                   capacity=cfg.raster.capacity // 2),
        shadow_raster=dataclasses.replace(
            cfg.shadow_raster, capacity=cfg.shadow_raster.capacity // 2))


def test_drop_counters_read_zero_when_tuned_and_count_when_halved():
    """A committed frame with the tuned capacities adds nothing to the
    three drop counters; with each capacity halved it adds to each, and
    measure_sparse_occupancy's `drops` and capacity_overflows name them."""
    _, scene, _, params = large(24, poses=4)
    cfg = autotune.tune_raster_capacities(scene, [params[0], params[3]],
                                          untuned())

    def dropped(c):
        before = profiling.drop_counts("cpu")
        frame.render_gltf_frame(scene, params[0],
                                frame.init_frame_state(c, "cpu"), c)
        after = profiling.drop_counts("cpu")
        return {k: after[k] - before[k] for k in after}

    assert dropped(cfg) == dict.fromkeys(profiling.DROP_COUNTERS, 0)
    half = _halved(cfg)
    assert all(n > 0 for n in dropped(half).values())
    occ = {"drops": tuple(dropped(half).values()), "clip_crossing": 0}
    over = autotune.capacity_overflows(half, dict(
        occ, pairs=0, pair_blocks=0, contact_stage2=0, contact_march=0,
        contact_blocks=0, texture_blocks=0))
    assert over == list(profiling.DROP_COUNTERS)


def test_capacity_overflows_names_the_clip_capacity():
    """A measured near-crossing count past clip_capacity is named, once,
    whether or not the frames' counters saw the drop."""
    cfg = untuned()
    occ = dict(pairs=0, pair_blocks=0, contact_stage2=0, contact_march=0,
               contact_blocks=0, texture_blocks=0)
    assert autotune.capacity_overflows(cfg, dict(occ, clip_crossing=64)) \
        == []
    assert autotune.capacity_overflows(cfg, dict(
        occ, clip_crossing=65, drops=(1, 0, 0))) == ["clip_capacity"]


def test_rastered_cell_loads_through_the_manifest():
    """The cell and its files load by name: the rastered configuration,
    the large scene's traffic, the bounded reference and the two readers
    this deployment adds."""
    cell = manifest.cell(manifest.load(ROOT), CELL, ROOT)
    assert cell.chips == 1
    assert cell.config["flags"]["synth_shadow_maps"] is False
    assert cell.traffic["scene"] == "large"
    assert cell.reference.__name__ == "reference.rastered"
    assert set(cell.limits) == set(compare.NUMBERS)
    names = [m.name for m in cell.per_layer]
    for name in ("binning_replay_ms", "raster_roofline"):
        assert name in names
        assert callable(manifest.reader(name).read)
    opt = cell.reference.options(cell.config, cell.config["frame"])
    assert (opt.width, opt.height, opt.shadow_map_size) == (1920, 1080, 2048)
