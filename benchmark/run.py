#!/usr/bin/env python3
"""The benchmark of funky_tpu_torch's compiled glTF frame: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout holding BENCHMARK.json and funky_tpu_torch,
on a machine with the NVIDIA GPUs the cell asks for. Set-up builds the
port's kernels (cached in funky_tpu_torch/build/), loads the cell's scene,
autotunes the cell's configuration over the poses the window renders and
records the frame as a CUDA graph; the window then replays it for
`--seconds` with at most three frames in flight. Afterwards frames drawn
from the seed are checked against the plain reference in
benchmark/reference/. The last line of standard output is the result as
JSON: the cell's end-to-end metrics with --trace 0, its per-layer metrics
with --trace 1. Without a CUDA device it exits non-zero and prints no
result.
"""

import os
import time


def _started() -> float:
    """The perf_counter reading at which this process started, from the
    kernel's record of its start (/proc/self/stat, in clock ticks since
    boot); the first line of this file where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _started()

import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
