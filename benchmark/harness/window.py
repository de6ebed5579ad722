"""The measured window: a closed loop of one client with at most
`frames_in_flight` frames queued.

Before it submits frame i the host waits on the event recorded at the end
of frame i - frames_in_flight, as the reference renderer waits on its
in-flight fences (MAX_FRAMES_IN_FLIGHT = 3, renderer.rs:46). Every frame
records an end event; the window ends, once its seconds have passed on the
host clock, with a synchronize. The frames to check are kept as they
come: the state a frame starts from is copied before it is submitted, its
RGBA (a copy the compiled frame makes) and the state it hands on right
after, since the next replay overwrites the graph's buffers.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import torch

from .compare import Kept


class Window(NamedTuple):
    frames: int
    seconds: float          # first submission to the final synchronize
    intervals_ms: List[float]
    kept: List[Kept]
    profile: Optional[object]
    state: tuple            # the state the last frame handed on
    submit_s: float         # host seconds inside the frame calls
    wait_s: float           # host seconds waiting on a frame in flight


def _device_clock(device):
    """(make an end marker, ms between two markers, wait on a marker)."""
    if torch.device(device).type == "cuda":
        def mark():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return mark, lambda a, b: a.elapsed_time(b), lambda e: e.synchronize()
    # the CPU runs each frame to its end before it returns (CPU tests)
    return (time.perf_counter, lambda a, b: (b - a) * 1e3, lambda e: None)


def run(fn: Callable, scene, params: list, schedule: Callable[[int], int],
        state, seconds: float, in_flight: int, keep: set,
        profile_frames: range | None = None, device="cuda") -> Window:
    """Frames fn(scene, params[schedule(i)], state) for `seconds`, from
    `state`. Frames whose index is in `keep` are kept for the check;
    `profile_frames`, a range of frame indices, runs under torch.profiler
    (drained before and after); a window that has begun them runs on
    until they are done."""
    mark, elapsed, wait = _device_clock(device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    ends = []
    kept = []
    prof = None
    submit_s = wait_s = 0.0
    start = mark()
    t0 = time.perf_counter()
    i = 0
    while (time.perf_counter() - t0 < seconds
           or (prof is not None and i < profile_frames.stop)):
        if profile_frames is not None and i == profile_frames.start:
            sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts, acc_events=True)
            prof.start()
        if i >= in_flight:
            tw = time.perf_counter()
            wait(ends[i - in_flight])
            wait_s += time.perf_counter() - tw
        pose = schedule(i)
        pre = tuple(t.clone() for t in state) if i in keep and i else None
        ts = time.perf_counter()
        rgba, state = fn(scene, params[pose], state)
        submit_s += time.perf_counter() - ts
        if i in keep:
            kept.append(Kept(i, pose, pre, rgba,
                             state.shadow_history.clone(),
                             state.prev_depth.clone()))
        ends.append(mark())
        i += 1
        if prof is not None and i == profile_frames.stop:
            sync()
            prof.stop()
    sync()
    t1 = time.perf_counter()
    marks = [start] + ends
    intervals = [elapsed(a, b) for a, b in zip(marks, marks[1:])]
    return Window(i, t1 - t0, intervals, kept, prof, state, submit_s,
                  wait_s)
