"""Tracing and profiling utilities (port of funky_tpu/utils/profiling.py).

- FpsCounter: FPS and frame time over 500 ms windows (main.rs:203-215).
- PassTimer: host-clock pass timings, each closed by a synchronize of the
  card (`torch.cuda.synchronize` in place of `block_until_ready`).
- trace(): torch.profiler around a block, the trace written as Chrome
  JSON into `log_dir`.
- device_info(): the card's name and torch's version for the debug panel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List

import torch


def _block() -> None:
    """Wait for the card's queue (nothing to wait for without a card)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclasses.dataclass
class FpsCounter:
    """profiling.py:24-43."""
    window_s: float = 0.5          # 500 ms window (main.rs:212)
    fps: float = 0.0
    frame_time_ms: float = 0.0
    _count: int = 0
    _last: float | None = None

    def tick(self) -> None:
        self._count += 1
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return
        elapsed = now - self._last
        if elapsed >= self.window_s:
            self.fps = self._count / elapsed
            self.frame_time_ms = 1000.0 / self.fps if self.fps else 0.0
            self._count = 0
            self._last = now


class PassTimer:
    """Named pass timings with a synchronize at each end, keeping running
    stats (profiling.py:46-76)."""

    def __init__(self) -> None:
        self.timings: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            _block()
        self.timings.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn: Callable, *args, iters: int = 1):
        out = fn(*args)                  # warm: builds the kernels
        _block()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _block()
        self.timings.setdefault(name, []).append(
            (time.perf_counter() - t0) / iters)
        return out

    def summary(self) -> Dict[str, float]:
        return {k: min(v) for k, v in self.timings.items()}

    def report(self) -> str:
        lines = [f"{k:30s} {min(v)*1000:8.3f} ms (best of {len(v)})"
                 for k, v in sorted(self.timings.items())]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "torch_trace"):
    """torch.profiler around a block (profiling.py:79-86): host and, where
    a card is present, device activity, written to
    `log_dir/trace.json` for chrome://tracing or Perfetto. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _block()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_info(device=None) -> str:
    """The GPU-info line of the debug panel (profiling.py:89-93): the
    card's name, or "cpu" for a CPU device or where there is no card."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        return (f"{torch.cuda.get_device_name(dev)} (cuda), torch "
                f"{torch.__version__}")
    return f"cpu, torch {torch.__version__}"
