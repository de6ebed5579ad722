"""rest_replay_ms: replay ms per frame of the frame's other top-level
spans, which no other metric reads: the uniforms, the vertex stage, the
window plans, the main raster (K1), the new state and the hand-off into
the donated buffers, from the profiled graph replays (metrics/_layers.py).
With the other six replay metrics it sums to the graph's replay."""

from metrics._layers import replay_ms

SPANS = ("uniforms", "vertices", "window_plans", "main_raster", "state",
         "handoff")


def read(ctx):
    return replay_ms(ctx, SPANS)
