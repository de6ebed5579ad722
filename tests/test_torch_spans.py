"""The glTF frame's layer spans (funky_tpu_torch/utils/profiling.py::span,
FRAME_SPANS; frame.py's spans and GraphFrame's capture table), on the CPU.

Under torch.profiler an eager frame emits each span as a record_function
range, nested as FRAME_SPANS declares, and every top-level operation of
the frame lies in one top-level span. Without a profiler or a capture
table a span opens no range. The capture table's bookkeeping runs here on
the frame GraphFrame records (frame._record), with the query of the graph
under capture replaced by a count of the operations dispatched so far: the
top-level spans tile the recorded operations, an empty layer (the light
maps, off in this configuration) is an empty range, the tap routes' window
plans are a second `window_plans` range, and the hand-off holds the
donated state's copies. The card half (tests/test_torch_compiled.py,
marker `cuda`) holds the layout against a profiled replay.
"""

import collections
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from funky_tpu_torch import frame
from funky_tpu_torch.utils import profiling

from .test_torch_compiled import SMALL, multimesh


def spans_config():
    """The shipped flags at a size the CPU holds, with a route window, so
    that every span but the light maps does work."""
    return frame.GltfConfig(
        flags=frame.GltfFrameFlags(committed=True, synth_shadow_maps=True),
        shadow_route_windows=(64, 0, 0, 0), shadow_route_caps=(32768, 0, 0, 0),
        **SMALL)


@pytest.fixture(scope="module")
def setup():
    scene, params = multimesh("cpu")
    cfg = spans_config()
    return scene, params, cfg, frame.init_frame_state(cfg, "cpu")


class _Counted(TorchDispatchMode):
    """Counts every operator dispatched: the CPU's stand-in for the graph's
    nodes (a view counts too, so nothing at all may fall between spans)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))

    def count(self):
        return {0: self.n}


def _record(setup):
    """frame._record on the committed frame's static inputs, counted."""
    scene, params, cfg, state = setup
    fn, inputs, donate = frame.compiled_gltf_frame(cfg).recordable(
        scene, params, state)
    static = [x.clone() for x in inputs]
    with _Counted() as mode:
        outputs, layout = frame._record(fn, static, donate, mode.count)
    return outputs, layout, mode.n, donate


def test_capture_table_tiles_the_recorded_frame(setup):
    _, layout, total, donate = _record(setup)
    assert layout.ops == layout.nodes == total > 0
    assert layout.node_types == {0: total}
    spans = layout.spans
    assert [s[0] for s in spans if s[1] is None] == [
        "uniforms", "vertices", "window_plans", "cascade_maps", "class_maps",
        "quad_pack", "light_maps", "window_plans", "main_raster",
        "back_half", "state", "handoff"]
    # the top-level spans cover [0, total) in order, with no gap or overlap
    edge = 0
    for name, parent, first, end in spans:
        if parent is None:
            assert first == edge and end >= first, name
            edge = end
    assert edge == total
    by = collections.defaultdict(list)
    for name, parent, first, end in spans:
        by[name].append((first, end))
        assert parent == profiling.PARENT[name]
    (bh,) = by["back_half"]
    for name in ("deferred", "shadow_filter", "taa", "contact", "shading"):
        ((first, end),) = by[name]
        assert bh[0] <= first < end <= bh[1], name
    nested = sorted(r for n in ("deferred", "shadow_filter", "taa",
                                "contact", "shading") for r in by[n])
    assert all(a[1] <= b[0] for a, b in zip(nested, nested[1:]))
    # light maps off: an empty range; every other layer does some work
    assert [f == e for f, e in by["light_maps"]] == [True]
    for name, ranges in by.items():
        if name != "light_maps":
            assert all(e > f for f, e in ranges), name
    # the hand-off is the donated state's copies, one operation each
    (handoff,) = by["handoff"]
    assert handoff[1] - handoff[0] == len(donate) == 5
    assert profiling._TABLE is None


def test_capture_table_edges_follow_the_count():
    """Each span notes the count at its two edges; nesting and repeats are
    kept in the order the spans opened; the count at the table's end is
    the layout's size, by the types the trace shows (kernel, memcpy,
    memset: one operation each; an empty node none)."""
    nodes = {0: 0, 5: 0}

    def add(kind, n=1):
        nodes[kind] += n

    with profiling.capture_table(lambda: dict(nodes)) as table:
        add(0)
        with profiling.span("back_half"):
            add(0, 2)
            with profiling.span("taa"):
                add(5)
                add(0)
            with profiling.span("contact"):
                pass
        with profiling.span("window_plans"):
            add(0)
        with profiling.span("window_plans"):
            pass
        add(0)
    lay = table.layout
    assert lay.spans == (("back_half", None, 1, 4), ("taa", "back_half", 3, 4),
                         ("contact", "back_half", 4, 4),
                         ("window_plans", None, 4, 5),
                         ("window_plans", None, 5, 5))
    assert (lay.ops, lay.nodes, lay.node_types) == (6, 7, {0: 6, 5: 1})
    assert (lay.before, lay.after) == (0, 0)


def test_capture_table_refuses_nesting_and_open_spans():
    with profiling.capture_table(lambda: {0: 0}):
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.capture_table(lambda: {0: 0}):
                pass
    with pytest.raises(RuntimeError, match="still open"):
        with profiling.capture_table(lambda: {0: 0}):
            profiling.span("uniforms").__enter__()
    assert profiling._TABLE is None


def test_unknown_span_raises():
    with pytest.raises(KeyError, match="not a span"):
        profiling.span("no_such_layer")


def test_span_off_opens_no_range(monkeypatch):
    """Without a profiler and a capture table a span is the shared no-op
    and calls no record_function; under the profiler it opens one."""
    opened = []

    class Fake:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Fake)
    for name, _ in profiling.FRAME_SPANS:
        with profiling.span(name):
            pass
    assert opened == []
    assert profiling.span("uniforms") is profiling.span("state")
    with torch.profiler.profile():
        with profiling.span("uniforms"):
            pass
    assert opened == ["span: uniforms"]


def test_layouts_outlive_the_frame_cache():
    """A layout published under a key stays after the compiled frames are
    dropped (frame._CACHE.clear(), the benchmark's release)."""
    key = ("test", spans_config())
    lay = profiling.GraphLayout(ops=3, nodes=3, node_types={0: 3},
                                spans=(("uniforms", None, 0, 3),))
    profiling.publish_layout(key, lay)
    frame._CACHE.clear()
    assert profiling.graph_layout(key) is lay
    assert profiling.graph_layout(("test", "other")) is None


def test_eager_frame_spans_under_the_profiler(setup, tmp_path):
    """An eager frame plus the hand-off, under torch.profiler: the ranges
    are exactly FRAME_SPANS's names, each inside the span FRAME_SPANS
    declares as its parent, and every operator the frame calls at top
    level runs inside exactly one top-level span."""
    scene, params, cfg, state = setup
    fn, inputs, donate = frame.compiled_gltf_frame(cfg).recordable(
        scene, params, state)
    static = [x.clone() for x in inputs]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outputs = fn(*static)
        with profiling.span("handoff"):
            for o, i in donate.items():
                static[i].copy_(outputs[o])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(profiling.RANGE):])
             for e in evs if e.get("cat") == "user_annotation"
             and e["name"].startswith(profiling.RANGE)]
    assert {s[2] for s in spans} == set(profiling.PARENT)

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1]

    for s in spans:
        around = [o for o in spans if o is not s and inside(s, o)]
        parent = min(around, key=lambda o: o[1] - o[0])[2] if around \
            else None
        assert parent == profiling.PARENT[s[2]], s[2]
    ops = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                  if e.get("cat") == "cpu_op"), key=lambda o: (o[0], -o[1]))
    tops = []
    for o in ops:
        if not (tops and inside(o, tops[-1])):
            tops.append(o)
    assert len(tops) > 100
    top_spans = [s for s in spans if profiling.PARENT[s[2]] is None]
    for o in tops:
        assert sum(inside(o, s) for s in top_spans) == 1, o[2]
