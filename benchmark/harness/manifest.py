"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each lives in a file of its own: `configs/<config>.json` (the file the
configuration entry gives), `traffic/<traffic>.json`, and the cell's
output limits in `limits/<cell>.json`. Each per-layer metric is read by
`metrics/<name>.py`. Adding a cell, a configuration, a traffic mix or a
metric adds files and manifest entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import List

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    limits: dict          # {number: limit} of the output check
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: pathlib.Path) -> dict:
    """BENCHMARK.json at the checkout's root."""
    return _load_json(root / "BENCHMARK.json")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(manifest: dict, name: str, root: pathlib.Path,
         bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    """The cell `name` with its configuration, traffic, limits and the
    metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(bench_dir / "limits" / f"{name}.json")

    def metrics(key):
        return [Metric(m["name"], m["unit"])
                for m in manifest[key] if _applies(m, name)]

    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))


def reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The module metrics/<name>.py: `read(ctx)` returns the metric's value
    or None where it finds nothing to read; `STAGES`, where present, lists
    the (module, function) pairs of funky_tpu_torch whose device time it
    reads."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
