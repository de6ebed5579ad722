"""Shared by the replay layer readers: the profiled graph replays cut into
the layer spans of funky_tpu_torch's frame (utils/profiling.py::
FRAME_SPANS), by the layout that the graph's capture recorded
(`profiling.graph_layout(cfg)`, published by frame.GraphFrame).

A profiled frame is `before` device operations enqueued ahead of its
replay (the input copies), the graph's G operations in the order they
were recorded (one capture stream: one chain of nodes) and `after`
operations (the RGBA clone). The graph's replay runs from the start of its
first node to the end of its last. A span is charged the device time from
the end of the node before its first node (the replay's start for the
first) to the end of its last node: the gap in front of a layer goes to
the layer whose node waited, and the top-level spans tile the replay. The
wait before the first node is the host's: in the first profiled frame,
after the harness drains the queue, the device waits 2-9 ms for the
profiled process's first graph launch, which the unprofiled window, three
frames ahead, never shows.

The profiler loses the first operations after it starts: on the H100 the
first profiled frame's input copies and the first few of its graph's
operations were missing in 4 of 6 traced runs, the later frames whole.
So the frames are cut from the end of the profile, the first may be cut
short at its start and is then left out, and every frame read must show
the same operation names in the same order (the graph replays the same
nodes). Nothing is read where the program publishes no layout (a program
without spans), where the top-level spans do not tile the graph, where
fewer than all but one of the profiled frames are whole, or where the
frames read disagree (the profiler dropped events inside the window, or a
frame kept for the output check fell among the profiled frames and added
its copies). A loss at the very end of the profile would shift every
frame alike and pass that check; the harness drains the device before it
stops the profiler, and no traced run showed one."""

from __future__ import annotations

import collections


def layout(ctx):
    """The program's GraphLayout of the tuned config's frame, or None."""
    try:
        from funky_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "graph_layout", None)
    if get is None or ctx.get("cfg") is None:
        return None
    return get(ctx["cfg"])


def tiles(spans, g: int) -> bool:
    """The top-level spans' operation ranges cover [0, g) without overlap."""
    edge = 0
    for _, _, first, end in sorted((s for s in spans if s[1] is None),
                                   key=lambda s: (s[2], s[3])):
        if first != edge or end < first:
            return False
        edge = end
    return edge == g


def frames(ctx, per: int):
    """The profiled frames' operations, each a list of `per`, cut from the
    end of the profile (module docstring), or None."""
    ops = ctx.get("replay_ops")
    n = ctx["replays"]
    if not ops or per <= 0 or n <= 0:
        return None
    m = min(n, len(ops) // per)
    if m < max(n - 1, 1) or len(ops) - m * per >= per:
        return None
    tail = len(ops) - m * per
    cut = [ops[tail + r * per:tail + (r + 1) * per] for r in range(m)]
    names = [o[0] for o in cut[0]]
    if any([o[0] for o in f] != names for f in cut[1:]):
        return None
    return cut


def span_times(ctx):
    """{span name: (ms, busy ms)} per frame, averaged over the frames read,
    with "(graph)": the graph's whole replay (the top-level spans' sum); a
    span opened more than once sums its ranges. None where there is
    nothing to read (module docstring)."""
    lay = layout(ctx)
    if lay is None or not tiles(lay.spans, lay.ops):
        return None
    cut = frames(ctx, lay.before + lay.ops + lay.after)
    if cut is None:
        return None
    acc = collections.defaultdict(lambda: [0.0, 0.0])
    for f in cut:
        graph = f[lay.before:lay.before + lay.ops]
        # ends[k]: the end of node k - 1; ends[0]: the replay's start
        ends = [graph[0][1]] + [o[1] + o[2] for o in graph]
        for name, _, first, end in lay.spans:
            acc[name][0] += ends[end] - ends[first]
            acc[name][1] += sum(o[2] for o in graph[first:end])
        acc["(graph)"][0] += ends[-1] - ends[0]
        acc["(graph)"][1] += sum(o[2] for o in graph)
    # microseconds over the frames read -> ms per frame
    m = len(cut)
    return {k: (v[0] / m / 1e3, v[1] / m / 1e3) for k, v in acc.items()}


def replay_ms(ctx, spans, less=()):
    """Replay ms per frame of `spans`, less that of `less`, or None."""
    t = span_times(ctx)
    if t is None:
        return None

    def ms(names):
        return sum(t[s][0] for s in names if s in t)

    return ms(spans) - ms(less)
