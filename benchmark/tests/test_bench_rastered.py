"""The rastered cell's files at a size the CPU holds: the large scene as
the frozen data of tests/torch_scenes.py::build_large_glb, a traced run of
the cell on a coarser terrain, its bfloat16 control and its halved-bin
fault coming out as not correct, and the two readers it adds
(binning_replay_ms, raster_roofline) on synthetic replays."""

import dataclasses
import functools
import pathlib
import sys

import pytest

from bench_tiny import ROOT, SEED, SIZE, tiny_cell, tiny_run

CELL = "rastered-large-orbit"
QUADS = 12


@pytest.fixture
def coarse(monkeypatch):
    """The cell, its scene cut to a QUADS x QUADS terrain, 4 poses."""
    from harness import manifest

    mod = manifest.load_module("scenes", "large")
    monkeypatch.setattr(mod, "build", functools.partial(mod.build,
                                                        quads=QUADS))
    return tiny_cell(CELL)


def test_large_scene_is_the_test_scene_as_data(tmp_path):
    """The GLB of scenes/large.py and build_large_glb's load through the
    program's loader to the same positions, indices, uvs and texture: the
    file's terrain normals are the one thing left out."""
    from funky_tpu_torch.models.gltf import GltfScene
    from harness import scene as scenes
    sys.path.insert(0, str(ROOT))
    from tests.torch_scenes import build_large_glb

    ours = GltfScene.load(scenes.write_glb(scenes.build("large"),
                                           tmp_path / "a.glb"))
    (tmp_path / "b").mkdir()
    theirs = GltfScene.load(build_large_glb(tmp_path / "b" / "b.glb"))
    assert len(ours.meshes) == len(theirs.meshes) == 3
    assert sum(len(m.indices) for m in ours.meshes) // 3 == 73_728 + 24
    for a, b in zip(ours.meshes, theirs.meshes):
        assert (a.indices == b.indices).all()
        for f in ("positions", "tex_coords", "colors"):
            x, y = getattr(a.vertices, f), getattr(b.vertices, f)
            assert x.dtype == y.dtype and (x == y).all(), f
    assert (ours.meshes[2].vertices.normals == [0.0, 1.0, 0.0]).all()
    assert not (theirs.meshes[2].vertices.normals == [0.0, 1.0, 0.0]).all()
    for a, b in zip(ours.materials, theirs.materials):
        assert (a.base_color == b.base_color).all()
        assert (a.metallic, a.roughness, a.base_color_texture_index) == (
            b.metallic, b.roughness, b.base_color_texture_index)
    assert [t.data.tobytes() for t in ours.textures] == [
        t.data.tobytes() for t in theirs.textures]


def test_traced_run_of_the_rastered_cell(coarse):
    """The cell runs through program.config -> entry.tune ->
    compiled_gltf_frame on the CPU, correct against reference/rastered.py,
    its capacity_overflows empty; without device replays its two readers
    find nothing to read."""
    run = tiny_run(coarse, seconds=0.5, trace_on=True)
    out = run["result"]
    assert out["correct"], out["checks"]
    assert "autotune_s" in out["metrics"]
    for name in ("binning_replay_ms", "raster_roofline"):
        assert name not in out["metrics"]
    assert any(n.endswith("over the window's poses: []")
               for n in run["notes"]), run["notes"]


def test_control_and_halved_bins_are_not_correct(coarse):
    """The bfloat16 control, and the program with each raster's bin
    capacity halved after the tune, come out as not correct."""
    import control
    from harness import program

    for seed in (SEED, 2**33 + 1):
        got = control.control_run(coarse, seed, 8, "cpu", SIZE)
        assert not got["correct"], got
    tune = program.tune

    def halved(scene, poses, cfg):
        cfg, s = tune(scene, poses, cfg)
        return dataclasses.replace(
            cfg, raster=dataclasses.replace(
                cfg.raster, capacity=cfg.raster.capacity // 2),
            shadow_raster=dataclasses.replace(
                cfg.shadow_raster,
                capacity=cfg.shadow_raster.capacity // 2)), s

    program.tune = halved
    try:
        out = tiny_run(coarse, seconds=0.5)["result"]
    finally:
        program.tune = tune
    assert not out["correct"], out["checks"]


def _ctx(spans, g):
    """Replays of g operations of 10 us, each 1 us after the one before,
    no copies around them, under a layout of `spans`."""
    from funky_tpu_torch.utils import profiling

    class Cfg:
        pass

    cfg = Cfg()
    profiling.publish_layout(cfg, profiling.GraphLayout(
        ops=g, nodes=g, node_types={0: g}, spans=spans))
    ops, t = [], 0.0
    for _ in range(3):
        for k in range(g):
            t += 1.0
            ops.append((f"op{k}", t, 10.0, "kernel"))
            t += 10.0
    return {"replay_ops": ops, "replays": 3, "cfg": cfg}


def test_binning_replay_ms_sums_the_two_spans():
    from harness import manifest

    read = manifest.reader("binning_replay_ms").read
    spans = (("cascade_maps", None, 0, 4),
             ("cascade_binning", "cascade_maps", 0, 1),
             ("cascade_binning", "cascade_maps", 2, 3),
             ("main_raster", None, 4, 7),
             ("main_binning", "main_raster", 4, 6))
    # the first range from the replay's start, the others from the end
    # of the operation before them
    assert read(_ctx(spans, 7)) == pytest.approx((10 + 11 + 22) / 1e3)
    # a program without the spans: nothing to read
    assert read(_ctx((("cascade_maps", None, 0, 4),
                      ("main_raster", None, 4, 7)), 7)) is None


def test_raster_roofline_bounds(coarse, monkeypatch):
    """The least time is the larger of the bytes and the covered pairs'
    operations; the reader reads the run's cell and seed from its command
    line and nothing without them or without a raster kernel."""
    from harness import manifest, program

    rf = manifest.reader("raster_roofline")
    full = program.config(coarse.config)
    rows = 73_856
    nbytes = 64 * (5 * rows + 2 * 64) + 8 * (4 * 2048 ** 2 + 1920 * 1080)
    assert rf.least_seconds(full, 0, rows) == pytest.approx(nbytes / 3.35e12)
    assert rf.least_seconds(full, 1e12, rows) == pytest.approx(16 / 67)
    assert rf.run_args(["--workload", CELL, "--seed", str(SEED)]) == (
        CELL, SEED)
    assert rf.run_args(["--seed", "3"]) is None

    cfg = program.config(coarse.config, SIZE)
    ctx = {"cfg": cfg, "replays": 5,
           "replay_ops": [("void raster_kernel<true>(...)", 0.0, 20.0,
                           "kernel")] * 25}
    monkeypatch.setattr(sys, "argv", ["run.py"])
    assert rf.read(ctx) is None
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL,
                                      "--seed", str(SEED)])
    monkeypatch.setattr(manifest, "cell", lambda *a, **k: coarse)
    pairs, n = rf.profiled_pairs(coarse, cfg, SEED, "cpu")
    assert pairs > 4 * 0.5 * 256 ** 2 and n == 384
    assert rf.read(ctx) == pytest.approx(
        100 * rf.least_seconds(cfg, pairs, n) / 100e-6)
    assert rf.read(dict(ctx, replay_ops=[("copy", 0.0, 5.0, "kernel")])) \
        is None
    # the pairs come from the cell's own reference: one that counts none
    # gives nothing to read
    other = dataclasses.replace(coarse, config=dict(coarse.config,
                                                    reference="render"))
    monkeypatch.setattr(manifest, "cell", lambda *a, **k: other)
    assert rf.read(ctx) is None


def test_cell_files_are_new_files_alone():
    """The cell's configuration, traffic, scene, reference, limits and
    readers are files of their own, named as manifest.py finds them."""
    bench = ROOT / "benchmark"
    for rel in ("configs/rastered.json", "traffic/large-orbit.json",
                "scenes/large.py", "reference/rastered.py",
                f"limits/{CELL}.json", "metrics/binning_replay_ms.py",
                "metrics/raster_roofline.py"):
        assert pathlib.Path(bench, rel).is_file(), rel
