"""A whole run of a cell at a size the CPU holds, with the device check
skipped: the result line's keys, the output check against the plain
reference, the import check, and a run without a card."""

import json
import os
import subprocess
import sys

import pytest

from bench_tiny import BENCH, ROOT, tiny_cell, tiny_run


@pytest.fixture(scope="module")
def run():
    return tiny_run(seconds=1.0)


def test_result_keys_and_checks_last(run):
    out = run["result"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                   "peak_mem_gib", "setup_s"}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
        # the CPU has no device allocator: its peak reads 0
        assert m["value"] > 0 or name == "peak_mem_gib"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_program_matches_reference_at_small_size(run):
    """At 160x96 the program's frames agree with the plain reference's
    within the cell's limits: every frame kept, from the start on."""
    out = run["result"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_p95_of_a_short_window():
    """A window of one frame has one interval: its p95 is that interval,
    where statistics.quantiles would raise."""
    from harness.main import _p95

    assert _p95([12.5]) == 12.5
    assert _p95([float(i) for i in range(1, 101)]) == pytest.approx(95.05)


def test_traced_run_reports_per_layer_metrics():
    out = tiny_run(seconds=0.5, trace_on=True)["result"]
    assert out["correct"]
    assert "autotune_s" in out["metrics"]
    assert "frames_per_s" not in out["metrics"]
    assert set(out["device"]) >= {"busy_s", "window_s"}


def test_no_jax_in_the_run(run):
    """No module of JAX or the JAX package is loaded by a run (the run's
    own process: pytest has loaded nothing of them either)."""
    from harness.main import forbidden_modules

    assert forbidden_modules() == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from harness import main as hm

    for name in ("funky_tpu_torch", "funky_tpu_torch.frame", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert hm.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax.linen", "funky_tpu",
                 "funky_tpu.frame"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert hm.forbidden_modules() == sorted(
        ["jax", "jaxlib.xla_client", "flax.linen", "funky_tpu",
         "funky_tpu.frame"])


def test_entry_modules_import_no_jax():
    """The modules the entry point runs, and each cell's reference and
    scene, imported in a fresh process: nothing of JAX or the JAX package
    is loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness.main, harness.window, harness.compare, control\n"
        "import reference.render, reference.lightspace, reference.scene\n"
        "import funky_tpu_torch.frame, funky_tpu_torch.entry\n"
        "from funky_tpu_torch.utils import autotune, diagnostics\n"
        "from harness import manifest, scene\n"
        "import pathlib\n"
        "root = pathlib.Path(%r)\n"
        "m = manifest.load(root)\n"
        "[manifest.reader(p['name']) for p in m['per_layer']]\n"
        "for w in m['workloads']:\n"
        "    cell = manifest.cell(m, w['name'], root)\n"
        "    cell.reference, scene.build(cell.traffic['scene'])\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'funky_tpu')))\n"
        % (str(ROOT), str(BENCH), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import reference.render, reference.lightspace, "
            "reference.scene\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('funky_tpu_torch', 'harness', 'jax', 'funky_tpu')))\n"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("where", ["checkout", "benchmark_only"])
def test_without_a_card_it_fails_and_prints_no_result(tmp_path, where):
    """No CUDA device here: the run exits non-zero and prints no result,
    and does not fall back to the CPU. The same in a directory holding
    only BENCHMARK.json and the benchmark's files."""
    import shutil

    if where == "checkout":
        run_py = BENCH / "run.py"
    else:
        shutil.copytree(BENCH, tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        run_py = tmp_path / "benchmark" / "run.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(run_py), "--workload", "shipped-multimesh-orbit",
         "--seed", "5000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=run_py.parent.parent)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
