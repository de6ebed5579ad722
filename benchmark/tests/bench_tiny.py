"""Helpers of the benchmark's CPU tests: a cell at a size the CPU holds.

The cells run here at 160x96 with 256^2 maps and an arc of 4 poses, with
the window's and the reference's code unchanged."""

from __future__ import annotations

import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SIZE = {"width": 160, "height": 96, "shadow_map_size": 256}
SEED = 4294967311      # more than 32 bits


def tiny_cell(name: str = "shipped-multimesh-orbit", poses: int = 4):
    from harness import manifest

    cell = manifest.cell(manifest.load(ROOT), name, ROOT)
    cell.traffic["poses"] = poses
    return cell


def tiny_run(cell=None, seconds: float = 1.0, trace_on: bool = False,
             frame_fn=None) -> dict:
    import time

    from harness import main as hm

    return hm.run_cell(cell or tiny_cell(), SEED, seconds, trace_on, "cpu",
                       time.perf_counter(), SIZE, frame_fn)
