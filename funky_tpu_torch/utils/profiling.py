"""Tracing and profiling utilities (port of funky_tpu/utils/profiling.py).

- FpsCounter: FPS and frame time over 500 ms windows (main.rs:203-215),
  the debug panel's FPS line.
- span(): one layer of the glTF frame, by a name of FRAME_SPANS. Under
  torch.profiler it is a `record_function` range named "span: <name>".
  Inside a capture table (frame.GraphFrame opens one around the frame it
  records as a CUDA graph) it notes the node count of the graph under
  capture at its two edges, so that each replay's device operations can
  be cut into layers (GraphLayout, graph_layout()). Otherwise it costs a
  flag check: a replay runs none of it.
- count_drops(): the device-side counters of what a frame drops past its
  capacities (DROP_COUNTERS), added to inside the frame, so a replay adds
  to them too; drop_counts() reads them on the host.
- trace(): torch.profiler around a block, the trace written as Chrome
  JSON into `log_dir`.
- device_info(): the card's name and torch's version for the debug panel.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Layer spans
# ---------------------------------------------------------------------------

# The glTF frame's layers in frame order, each with the span it lies in
# (None: top level). The top-level spans tile a recorded frame: every
# device operation of its graph lies in exactly one of them. A frame opens
# a span even where the layer does nothing (light_maps without the
# light-space ground evaluation), and `window_plans` twice where the tap
# routes plan their windows after the light maps. `handoff` is
# GraphFrame's copy of the new state into the donated buffers. The two
# binning spans hold a raster's triangle setup, bin_triangles and, on the
# pre-gathered route, gather_bin_data (ops/raster.py::raster_corners): one
# range per cascade raster or occluder window, one in the main pass.
FRAME_SPANS: Tuple[Tuple[str, Optional[str]], ...] = (
    ("uniforms", None),
    ("vertices", None),
    ("window_plans", None),
    ("cascade_maps", None),
    ("cascade_binning", "cascade_maps"),
    ("class_maps", None),
    ("quad_pack", None),
    ("light_maps", None),
    ("main_raster", None),
    ("main_binning", "main_raster"),
    ("back_half", None),
    ("deferred", "back_half"),
    ("shadow_filter", "back_half"),
    ("taa", "back_half"),
    ("contact", "back_half"),
    ("shading", "back_half"),
    ("state", None),
    ("handoff", None),
)
PARENT: Dict[str, Optional[str]] = dict(FRAME_SPANS)
# The profiler range's prefix; the benchmark's own wrappers use "stage: ".
RANGE = "span: "

# CUgraphNodeType values whose node a device trace shows as one operation
# (kernel, memcpy, memset: one each in the H100's traces of the shipped
# frame); the other kinds (empty, event and semaphore nodes, host
# callbacks) run nothing on the device.
TRACE_OPS = frozenset((0, 1, 2))


@dataclasses.dataclass
class GraphLayout:
    """Where a recorded frame's layers lie in its graph. `ops` is the
    number of device operations one replay runs (G), `nodes` the graph's
    node count and `node_types` its nodes by CUgraphNodeType. Each span is
    (name, parent, first, end): the operations [first, end) of a replay,
    in the order they run (one capture stream: one chain of nodes).
    `before` and `after` count the device operations the last call
    enqueued around its replay (input copies, the RGBA clone)."""
    ops: int
    nodes: int
    node_types: Dict[int, int]
    spans: Tuple[Tuple[str, Optional[str], int, int], ...]
    before: int = 0
    after: int = 0


class CaptureTable:
    """The span edges of one capture: `count()` returns the graph's nodes
    so far by type (a Counter); each edge keeps the operations among
    them. `layout` is set at the capture's end."""

    def __init__(self, count: Callable[[], Dict[int, int]]):
        self.count = count
        self.spans: List[list] = []
        self.open_spans: List[list] = []
        self.layout: Optional[GraphLayout] = None

    def ops(self) -> int:
        return _ops(self.count())

    def enter(self, name: str) -> None:
        entry = [name, PARENT[name], self.ops(), None]
        self.spans.append(entry)
        self.open_spans.append(entry)

    def exit(self) -> None:
        self.open_spans.pop()[3] = self.ops()

    def end(self) -> None:
        if self.open_spans:
            raise RuntimeError(f"spans still open at the capture's end: "
                               f"{[s[0] for s in self.open_spans]}")
        types = dict(self.count())
        self.layout = GraphLayout(
            ops=_ops(types), nodes=sum(types.values()), node_types=types,
            spans=tuple(tuple(s) for s in self.spans))


def _ops(types: Dict[int, int]) -> int:
    return sum(n for t, n in types.items() if t in TRACE_OPS)


_TABLE: Optional[CaptureTable] = None


class _Span:
    __slots__ = ("name", "table", "range")

    def __init__(self, name: str, table: Optional[CaptureTable]):
        self.name = name
        self.table = table
        self.range = None

    def __enter__(self):
        if self.table is not None:
            self.table.enter(self.name)
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(RANGE + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.table is not None:
            self.table.exit()
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """The layer `name` of FRAME_SPANS around a block (module docstring);
    a name outside FRAME_SPANS raises KeyError."""
    if name not in PARENT:
        raise KeyError(f"{name!r} is not a span of FRAME_SPANS")
    if _TABLE is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, _TABLE)


@contextlib.contextmanager
def capture_table(count: Optional[Callable[[], Dict[int, int]]] = None):
    """Note the span edges of the block, which runs inside a CUDA graph
    capture on the current stream, and yield the CaptureTable, whose
    `layout` the block's end sets (the capture still running). `count`
    replaces the query of the graph under capture (the CPU tests count
    operations instead)."""
    global _TABLE
    if _TABLE is not None:
        raise RuntimeError("a capture table is already open")
    table = _TABLE = CaptureTable(count or _capture_node_types())
    try:
        yield table
        table.end()
    finally:
        _TABLE = None


def _capture_node_types() -> Callable[[], Dict[int, int]]:
    """count() for the graph that the current stream is capturing, through
    the CUDA driver (cuStreamGetCaptureInfo, cuGraphGetNodes,
    cuGraphNodeGetType), which allows these queries during a capture. A
    node's type is asked once."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.POINTER
    info = cu.cuStreamGetCaptureInfo_v2
    info.argtypes = [ctypes.c_void_p, ptr(ctypes.c_int), ptr(ctypes.c_uint64),
                     ptr(ctypes.c_void_p), ptr(ctypes.c_void_p),
                     ptr(ctypes.c_size_t)]
    get_nodes = cu.cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ptr(ctypes.c_size_t)]
    get_type = cu.cuGraphNodeGetType
    get_type.argtypes = [ctypes.c_void_p, ptr(ctypes.c_int)]
    for f in (info, get_nodes, get_type):
        f.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    known: Dict[int, int] = {}

    def check(what: str, err: int) -> None:
        if err:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    def count() -> Dict[int, int]:
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        check("cuStreamGetCaptureInfo", info(
            stream, ctypes.byref(status), ctypes.byref(ctypes.c_uint64()),
            ctypes.byref(graph), ctypes.byref(ctypes.c_void_p()),
            ctypes.byref(ctypes.c_size_t())))
        if status.value != 1:      # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError("the current stream is not capturing")
        n = ctypes.c_size_t()
        check("cuGraphGetNodes", get_nodes(graph, None, ctypes.byref(n)))
        types: Dict[int, int] = collections.Counter()
        if not n.value:            # an array of none is refused
            return types
        nodes = (ctypes.c_void_p * n.value)()
        check("cuGraphGetNodes", get_nodes(graph, nodes, ctypes.byref(n)))
        for h in nodes[:n.value]:
            t = known.get(h)
            if t is None:
                kind = ctypes.c_int()
                check("cuGraphNodeGetType",
                      get_type(ctypes.c_void_p(h), ctypes.byref(kind)))
                t = known[h] = kind.value
            types[t] += 1
        return types

    return count


# ---------------------------------------------------------------------------
# Drop counters
# ---------------------------------------------------------------------------

# What a committed frame drops past a capacity, each counter named for its
# GltfConfig field: near-clipped triangles past `clip_capacity`
# (ops/clipping.py), and bin entries past the main raster's and the
# cascade rasters' capacities (ops/binning.py). The frame adds its drops
# on the device, where its capacity can drop anything at all
# (frame.py::_drop_counters): a count that is 0 by construction adds no node
# to the graph.
DROP_COUNTERS = ("clip_capacity", "raster.capacity", "shadow_raster.capacity")
_DROPS: Dict[str, torch.Tensor] = {}


def _device_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def count_drops(name: str, n: torch.Tensor) -> None:
    """Add the 0-d device count `n` to the counter `name` of DROP_COUNTERS
    on n's device: one in-place add, which a CUDA graph records and each
    replay repeats. The counters of a device are made by its first call,
    which must be eager (GraphFrame's warm-up is): a capture cannot make
    them."""
    i = DROP_COUNTERS.index(name)
    key = _device_key(n.device)
    buf = _DROPS.get(key)
    if buf is None:
        if (n.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("the drop counters are made by an eager call, "
                               "not inside a capture")
        buf = _DROPS[key] = torch.zeros(len(DROP_COUNTERS),
                                        dtype=torch.int64, device=n.device)
    buf[i].add_(n)


def drop_counts(device) -> Dict[str, int]:
    """The counters of `device` on the host (a read that waits for the
    device): {name: entries dropped since the counters were made}."""
    buf = _DROPS.get(_device_key(device))
    if buf is None:
        return dict.fromkeys(DROP_COUNTERS, 0)
    return dict(zip(DROP_COUNTERS, (int(v) for v in buf.tolist())))


# The layouts of recorded frames, by the key their capture was published
# under (frame.compiled_gltf_frame: its GltfConfig). Dropping the compiled
# frames (frame._CACHE.clear()) keeps them.
_LAYOUTS: Dict[object, GraphLayout] = {}


def publish_layout(key, layout: GraphLayout) -> None:
    _LAYOUTS[key] = layout


def graph_layout(key) -> Optional[GraphLayout]:
    """The layout of the frame last recorded under `key`, or None."""
    return _LAYOUTS.get(key)


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
