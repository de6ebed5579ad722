"""Reading the profiler: stage device times of one eager frame, and the
device's work and idle time over profiled graph replays.

The stage table and the charging rule are frozen from profile_port.py
(`wrapped_stages`, `ranged`, lines 195-248, and `stage_device_ms`, lines
259-288): each stage function of funky_tpu_torch runs under a
`record_function` range for the length of one frame, and each kernel,
copy and memset is charged to the stage ranges that were open on the host
when it was launched (matched by its launch call's correlation id). A
reader sums its stages' operations once each, so a stage whose range
opens inside another of the same reader is not counted twice.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import pathlib
import tempfile
from typing import Iterable, List, Tuple

import torch

RANGE = "stage: "
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def label(module: str, attr: str) -> str:
    return f"{module}.{attr}"


@contextlib.contextmanager
def wrapped(stages: Iterable[Tuple[str, str]]):
    """Each (module, function) of funky_tpu_torch under a record_function
    range named for it, for the length of the block. A listed function
    the module lacks raises: a stage renamed in the program must fail the
    run, not read as nothing."""
    saved = []
    for module, attr in sorted(set(stages)):
        mod = importlib.import_module(f"funky_tpu_torch.{module}")
        if not hasattr(mod, attr):
            raise AttributeError(f"funky_tpu_torch.{module} has no {attr}, "
                                 f"a stage a metric reads")
        fn = getattr(mod, attr)

        def ranged(*args, _fn=fn, _name=RANGE + label(module, attr),
                   **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)

        saved.append((mod, attr, fn))
        setattr(mod, attr, ranged)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def events(prof) -> list:
    """A finished profile's chrome-trace events."""
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def stage_charges(evs: list) -> Tuple[set, list]:
    """(the stage labels whose range ran, [(device ms, the frozenset of
    stage labels open at its launch)] of every device operation launched
    inside some stage range); profile_port.py:259-288's rule."""
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(RANGE):])
              for e in evs if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(RANGE)]
    launched = {e["args"]["correlation"]: e["ts"] for e in evs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    charges = []
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        open_ = frozenset(r[2] for r in ranges if r[0] <= ts <= r[1])
        if open_:
            charges.append((e.get("dur", 0) / 1e3, open_))
    return {r[2] for r in ranges}, charges


def stages_ms(ran: set, charges: list, labels) -> float | None:
    """Device ms of the operations launched inside any of `labels`' ranges,
    each counted once; None where none of those ranges ran."""
    labels = set(labels)
    if not labels & ran:
        return None
    return sum(ms for ms, open_ in charges if open_ & labels)


def device_ops(evs: list) -> List[Tuple[str, float, float, str]]:
    """(name, start us, duration us, category) of every device operation,
    by start."""
    return sorted(((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)),
                    e["cat"]) for e in evs if e.get("cat") in DEVICE_CATS),
                  key=lambda k: k[1])


def busy_and_span(ops) -> Tuple[float, float]:
    """Seconds some operation ran on the device (the union of their
    intervals), and the seconds from the first start to the last end."""
    if not ops:
        return 0.0, 0.0
    busy = 0.0
    cur_s, cur_e = ops[0][1], ops[0][1] + ops[0][2]
    for _, s, d, _ in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    span = max(o[1] + o[2] for o in ops) - ops[0][1]
    return busy / 1e6, span / 1e6


def top_ops(ops, n: int = 10) -> list:
    """The device operations that took most time, summed by name: [[name,
    seconds], ...]."""
    tot = collections.defaultdict(float)
    for name, _, d, _ in ops:
        tot[name] += d / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(ops, evs: list, n: int = 10) -> list:
    """The idle time between device operations, summed by what the host
    was doing in the middle of each gap (the innermost host event open
    then, or "host idle") and by the operation the gap waited for:
    [[label, seconds], ...], longest first."""
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("name", "")) for e in evs
                   if e.get("cat") in ("cuda_runtime", "cuda_driver",
                                       "cpu_op", "user_annotation")
                   and e.get("dur")), key=lambda h: h[0])
    tot = collections.defaultdict(float)
    end = ops[0][1] + ops[0][2] if ops else 0.0
    nxt, active = 0, []
    for name, s, d, _ in ops[1:]:
        if s > end:
            mid = 0.5 * (s + end)
            while nxt < len(host) and host[nxt][0] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] >= mid]
            doing = (min(active, key=lambda h: h[1] - h[0])[2] if active
                     else "host idle")
            tot[f"host {doing[:60]} / before {name[:60]}"] += (s - end) / 1e6
        end = max(end, s + d)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
