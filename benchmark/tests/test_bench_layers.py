"""The replay layer readers (metrics/_layers.py and the seven
*_replay_ms readers) on synthetic replays: the graph's operations cut by
the layout the program publishes, each span charged from the end of the
node before it, the seven tiling the graph's replay from its first node."""

import pytest

from bench_tiny import ROOT

READERS = ("cascade_maps_replay_ms", "class_maps_replay_ms",
           "shadow_filter_replay_ms", "contact_replay_ms",
           "back_half_replay_ms", "rest_replay_ms", "light_maps_replay_ms")

# One span a top-level layer, back_half with its five nested spans, in
# frame order; (name, parent, first, end) over a graph of 20 operations.
SPANS = (
    ("uniforms", None, 0, 1), ("vertices", None, 1, 2),
    ("window_plans", None, 2, 3), ("cascade_maps", None, 3, 5),
    ("class_maps", None, 5, 6), ("quad_pack", None, 6, 7),
    ("light_maps", None, 7, 8), ("window_plans", None, 8, 9),
    ("main_raster", None, 9, 10), ("back_half", None, 10, 17),
    ("deferred", "back_half", 11, 12), ("shadow_filter", "back_half", 12, 14),
    ("taa", "back_half", 14, 15), ("contact", "back_half", 15, 16),
    ("shading", "back_half", 16, 17), ("state", None, 17, 18),
    ("handoff", None, 18, 20))
G = 20
# A frame without the light-space mode: its light_maps span holds nothing.
NO_LIGHT = tuple((n, p, f - (f > 7), e - (e > 7)) for n, p, f, e in SPANS)


class Cfg:
    """A key of its own for each test's layout."""


def _ctx(before=2, after=1, replays=3, gap=None, spans=SPANS, extra=0,
         g=G):
    """Replays of `before` copies, the g graph operations and `after`
    clones, each operation 10 us long and 1 us after the one before,
    `gap` = {node: us} waits in front of graph nodes; `extra` operations
    appended."""
    from funky_tpu_torch.utils import profiling

    cfg = Cfg()
    profiling.publish_layout(cfg, profiling.GraphLayout(
        ops=g, nodes=g, node_types={0: g}, spans=spans, before=before,
        after=after))
    ops, t = [], 0.0
    for _ in range(replays):
        for k in range(before + g + after):
            node = k - before
            t += 1.0 + (gap or {}).get(node, 0.0) if 0 <= node < g else 1.0
            ops.append((f"op{k}", t, 10.0, "kernel"))
            t += 10.0
    for _ in range(extra):
        ops.append(("copy", t + 1.0, 10.0, "gpu_memcpy"))
        t += 11.0
    return {"replay_ops": ops, "replays": replays, "cfg": cfg}


def _read(name, ctx):
    from harness import manifest

    return manifest.reader(name).read(ctx)


def test_the_six_tile_the_graphs_replay():
    """Per frame the seven readers sum to the graph's replay, from the
    start of its first node to the end of its last: G operations of 10 us,
    each 1 us after the one before."""
    ctx = _ctx(gap={3: 50.0, 12: 7.0})
    got = {n: _read(n, ctx) for n in READERS}
    assert sum(got.values()) == pytest.approx((G * 11 - 1 + 57) / 1e3)
    assert got["class_maps_replay_ms"] == pytest.approx(11e-3)
    assert got["cascade_maps_replay_ms"] == pytest.approx((3 * 11 + 50)
                                                          / 1e3)
    assert got["shadow_filter_replay_ms"] == pytest.approx(29e-3)
    assert got["contact_replay_ms"] == pytest.approx(11e-3)
    # back_half's 7 operations less the filter's 2 and contact's 1
    assert got["back_half_replay_ms"] == pytest.approx(4 * 11e-3)
    assert got["light_maps_replay_ms"] == pytest.approx(11e-3)
    # uniforms (10 us: the replay starts at its node), vertices, two window
    # plans, main raster, state and the two hand-off copies
    assert got["rest_replay_ms"] == pytest.approx((8 * 11 - 1) / 1e3)


def test_a_frame_without_light_maps_reads_none_there():
    """Where the light_maps span holds no operation (the cells without the
    light-space mode) its reader returns None, the six others still tile
    the replay, and rest_replay_ms reads what it read with light_maps
    among its spans."""
    ctx = _ctx(gap={3: 50.0}, spans=NO_LIGHT, g=G - 1)
    got = {n: _read(n, ctx) for n in READERS}
    assert got.pop("light_maps_replay_ms") is None
    assert sum(got.values()) == pytest.approx(((G - 1) * 11 - 1 + 50) / 1e3)
    assert got["rest_replay_ms"] == pytest.approx((8 * 11 - 1) / 1e3)


def test_the_gap_in_front_of_a_layer_is_that_layers():
    """A wait before a layer's first node is charged to that layer, not
    to the one before it; its busy time holds no gap."""
    from metrics._layers import span_times

    quiet = span_times(_ctx())
    waited = span_times(_ctx(gap={5: 40.0}))
    assert waited["class_maps"][0] == pytest.approx(quiet["class_maps"][0]
                                                    + 40e-3)
    assert waited["class_maps"][1] == pytest.approx(quiet["class_maps"][1])
    assert waited["cascade_maps"] == pytest.approx(quiet["cascade_maps"])
    assert waited["(graph)"][0] == pytest.approx(quiet["(graph)"][0] + 40e-3)
    # the nested spans' gaps stay inside back_half
    inner = span_times(_ctx(gap={12: 20.0}))
    assert inner["shadow_filter"][0] == pytest.approx(
        quiet["shadow_filter"][0] + 20e-3)
    assert inner["back_half"][0] == pytest.approx(quiet["back_half"][0]
                                                  + 20e-3)


@pytest.mark.parametrize("before", [0, 2])
def test_the_wait_for_the_launch_is_left_out(before):
    """The replay starts at its first node: a wait between the input
    copies and it (the host's graph launch) is no layer's."""
    from metrics._layers import span_times

    t = span_times(_ctx(before=before, after=0, replays=1, gap={0: 500.0}))
    assert t["(graph)"][0] == pytest.approx((G * 11 - 1) / 1e3)
    assert t["uniforms"] == pytest.approx((10e-3, 10e-3))


@pytest.mark.parametrize("lost", [0, 1, 9, 2 + G])
def test_a_first_frame_cut_short_is_left_out(lost):
    """The profiler loses the first operations after it starts: the frames
    are cut from the end, and a first frame missing its start is left
    out; the others read as the whole profile would."""
    from metrics._layers import span_times

    whole = _ctx(gap={3: 50.0})
    ctx = dict(whole, replay_ops=whole["replay_ops"][lost:])
    assert span_times(ctx) == pytest.approx(span_times(whole))
    for name in READERS:
        assert _read(name, ctx) == pytest.approx(_read(name, whole)), name


def _kept(where):
    """A frame kept for the output check among the profiled ones: its
    state's 5 copies before the frame and 2 after it."""
    ctx = _ctx()
    ops, per = ctx["replay_ops"], 2 + G + 1
    at = where * per
    copies = [("Memcpy DtoD", ops[at][1] - 1.0, 0.5, "gpu_memcpy")] * 5
    after = [("Memcpy DtoD", ops[at + per - 1][1] + 11.0, 0.5,
              "gpu_memcpy")] * 2
    return dict(ctx, replay_ops=ops[:at] + copies + ops[at:at + per]
                + after + ops[at + per:])


@pytest.mark.parametrize("case", ["extra", "lost_inside", "lost_two",
                                  "kept_last", "kept_middle", "no_layout",
                                  "no_ops", "no_tiling"])
def test_nothing_to_read_returns_none(case):
    """Operations past the last frame, an operation lost inside the last
    frame, two frames lost, a kept frame's copies among the profiled
    frames (at the end or inside), a program that publishes no layout, no
    profile, or spans that leave part of the graph out: every reader
    returns None."""
    ctx = {"extra": lambda: _ctx(extra=2),
           "lost_inside": lambda: dict(_ctx(), replay_ops=(
               _ctx()["replay_ops"][:-9] + _ctx()["replay_ops"][-8:])),
           "lost_two": lambda: dict(_ctx(), replay_ops=_ctx()["replay_ops"][
               2 * (2 + G + 1):]),
           "kept_last": lambda: _kept(2),
           "kept_middle": lambda: _kept(1),
           "no_layout": lambda: dict(_ctx(), cfg=Cfg()),
           "no_ops": lambda: dict(_ctx(), replay_ops=None),
           "no_tiling": lambda: _ctx(spans=SPANS[:-1])}[case]()
    for name in READERS:
        assert _read(name, ctx) is None, name


def test_layout_tiling():
    from metrics._layers import tiles

    assert tiles(SPANS, G)
    assert not tiles(SPANS, G + 1)
    assert not tiles(SPANS[1:], G)
    overlap = SPANS[:2] + (("window_plans", None, 1, 3),) + SPANS[3:]
    assert not tiles(overlap, G)


def test_each_listed_metric_has_a_reader_and_every_span_exists():
    """Every per-layer metric BENCHMARK.json lists has a reader; the spans
    the replay readers use are in FRAME_SPANS, and the seven read each
    top-level span once (so they sum to the graph's replay)."""
    from harness import manifest
    from funky_tpu_torch.utils import profiling

    m = manifest.load(ROOT)
    names = [p["name"] for p in m["per_layer"]]
    assert set(READERS) <= set(names)
    for name in names:
        assert callable(manifest.reader(name).read), name
    read = []
    for name in READERS:
        r = manifest.reader(name)
        for s in r.SPANS + getattr(r, "LESS", ()):
            assert s in profiling.PARENT, (name, s)
        read += [s for s in r.SPANS if profiling.PARENT[s] is None]
    top = [s for s, parent in profiling.FRAME_SPANS if parent is None]
    assert sorted(read) == sorted(top)
    assert set(manifest.reader("back_half_replay_ms").LESS) == {
        "shadow_filter", "contact"}
