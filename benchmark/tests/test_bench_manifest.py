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
