"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each lives in a file of its own: `configs/<config>.json` (the file the
configuration entry gives), `traffic/<traffic>.json`, and the cell's
output limits in `limits/<cell>.json`. The traffic file's `scene` names
`scenes/<scene>.py`, whose `build()` makes the scene; the configuration
file's `reference` (`render` where it gives none) names the plain
reference `reference/<reference>.py`. Each per-layer metric is read by
`metrics/<name>.py`. Adding a cell, a configuration, a traffic mix, a
scene, a plain reference or a metric adds files and manifest entries and
edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
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
    bench_dir: pathlib.Path = BENCH_DIR   # where its scene and reference are

    @property
    def reference(self):
        """The plain reference module the configuration names."""
        return load_module("reference", self.config.get("reference", "render"),
                           self.bench_dir)


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
                per_layer=metrics("per_layer"), bench_dir=bench_dir)


def load_module(kind: str, name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The file <kind>/<name>.py of the benchmark as the module
    `<kind>.<name>`, so that a reference module can import the stages of
    another (`from . import render`). A module already loaded from that
    file is reused."""
    path = (bench_dir / kind / f"{name}.py").resolve()
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r}: {path} is missing")
    full = f"{kind}.{name}"
    mod = sys.modules.get(full)
    if mod is not None and pathlib.Path(mod.__file__).resolve() == path:
        return mod
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full]
        raise
    return mod


def reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The module metrics/<name>.py: `read(ctx)` returns the metric's value
    or None where it finds nothing to read; `STAGES`, where present, lists
    the (module, function) pairs of funky_tpu_torch whose device time it
    reads."""
    return load_module("metrics", name, bench_dir)
