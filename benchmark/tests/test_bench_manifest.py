"""The manifest and the files it names load by name; a cell, a
configuration, a traffic mix and a per-layer metric are added as new files
and manifest entries alone."""

import json
import re
import shutil

from bench_tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_loads_with_its_files_and_readers():
    from harness import manifest

    m = manifest.load(ROOT)
    for w in m["workloads"]:
        cell = manifest.cell(m, w["name"], ROOT)
        assert cell.chips == 1
        assert set(cell.limits) == {"rgba_bad_share", "history_bad_share",
                                    "depth_bad_share"}
        assert "setup_s" in [e.name for e in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for metric in cell.per_layer:
            assert callable(manifest.reader(metric.name).read)


def test_names_units_and_keys_follow_the_contract():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    moves = {e["name"] for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert p["moves"] in moves
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")


def test_a_cell_added_as_new_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell with its limits and a per-layer metric: new files and manifest
    entries, no file of the copy edited."""
    from harness import manifest

    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", ".work"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "shipped.json").read_text())
    cfg["name"] = "fixture"
    cfg["flags"]["use_pcss"] = False
    (bench / "configs" / "fixture.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "multimesh-orbit.json").read_text())
    tr["rad_per_frame"] = 0.05
    (bench / "traffic" / "fast-orbit.json").write_text(json.dumps(tr))
    (bench / "limits" / "fixture-fast-orbit.json").write_text(json.dumps(
        {"rgba_bad_share": 0.5, "history_bad_share": 0.5,
         "depth_bad_share": 0.5}))
    (bench / "metrics" / "fixture_count.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    m["configs"].append({"name": "fixture", "source": "https://example.org",
                         "file": "benchmark/configs/fixture.json",
                         "reduced": [], "why": "a test fixture"})
    m["workloads"].append({"name": "fixture-fast-orbit", "config": "fixture",
                           "traffic": "fast-orbit", "chips": 1,
                           "why": "a test fixture"})
    m["per_layer"].append({"name": "fixture_count", "unit": "count",
                           "better": "lower", "source": "program_counter",
                           "layer": "fixture", "moves": "frames_per_s",
                           "workloads": ["fixture-fast-orbit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = manifest.cell(manifest.load(root), "fixture-fast-orbit", root,
                         bench)
    assert cell.config["flags"]["use_pcss"] is False
    assert cell.traffic["rad_per_frame"] == 0.05
    assert cell.limits["rgba_bad_share"] == 0.5
    assert "fixture_count" in [p.name for p in cell.per_layer]
    assert manifest.reader("fixture_count", bench).read({}) == 7.0
    old = manifest.cell(manifest.load(root), "shipped-multimesh-orbit", root,
                        bench)
    assert "fixture_count" not in [p.name for p in old.per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data, p


SCENE = '''"""A fixture scene: multimesh's right cube alone on the ground."""

from harness.scene import Material, Mesh, SceneSpec

BUILT = []


def build():
    from scenes import multimesh

    full = multimesh.build()
    BUILT.append(1)
    cube = full.meshes[1]
    return SceneSpec(meshes=[Mesh(cube.positions, cube.indices, None, 0)],
                     materials=[Material((0.1, 0.8, 0.1, 1.0), 0.0, 0.9,
                                         None)],
                     textures=[])
'''

REFERENCE = '''"""A fixture reference: render.py's stages, frames counted."""

from . import render as rr
from .render import Options, Pose, State, init_state, options  # noqa: F401

FRAMES = []


def render(scene, pose, state, opt, store=None):
    FRAMES.append(1)
    q = store or rr.identity
    f = rr.front(scene, pose, state, opt, q)
    cur = rr.cascaded_shadow(f.uni, f.maps, f.g.world, f.normal, f.n_dot_l,
                             f.view_depth, f.frag, opt.use_pcss,
                             opt.use_shadow_taa)
    return rr.finish(scene, state, opt, q, f, cur, f.g.valid)
'''


def test_a_scene_and_a_reference_added_as_files_alone(tmp_path):
    """A copy of the benchmark gains a scene module, a plain reference
    module, a traffic mix naming the scene, a configuration naming the
    reference and a cell: new files and manifest entries alone. A tiny run
    of the cell builds that scene, is judged by that reference, and is
    correct; no file of the copy is edited."""
    import time

    from bench_tiny import SEED, SIZE
    from harness import main as hm
    from harness import manifest

    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", ".work"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    (bench / "scenes" / "fixture_cube.py").write_text(SCENE)
    (bench / "reference" / "fixture_ref.py").write_text(REFERENCE)
    cfg = json.loads((bench / "configs" / "shipped.json").read_text())
    cfg["name"] = "fixture"
    cfg["reference"] = "fixture_ref"
    (bench / "configs" / "fixture.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "multimesh-orbit.json").read_text())
    tr["scene"] = "fixture_cube"
    tr["poses"] = 4
    (bench / "traffic" / "cube-orbit.json").write_text(json.dumps(tr))
    (bench / "limits" / "fixture-cube-orbit.json").write_text(
        (bench / "limits" / "shipped-multimesh-orbit.json").read_text())
    m["configs"].append({"name": "fixture", "source": "https://example.org",
                         "file": "benchmark/configs/fixture.json",
                         "reduced": [], "why": "a test fixture"})
    m["workloads"].append({"name": "fixture-cube-orbit", "config": "fixture",
                           "traffic": "cube-orbit", "chips": 1,
                           "why": "a test fixture"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = manifest.cell(manifest.load(root), "fixture-cube-orbit", root,
                         bench)
    out = hm.run_cell(cell, SEED, 1.0, False, "cpu", time.perf_counter(),
                      SIZE)["result"]
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert manifest.load_module("scenes", "fixture_cube", bench).BUILT
    assert cell.reference.__name__ == "reference.fixture_ref"
    assert cell.reference.FRAMES
    for p, data in before.items():
        assert p.read_bytes() == data, p
