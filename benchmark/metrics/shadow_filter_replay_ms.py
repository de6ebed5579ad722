"""shadow_filter_replay_ms: replay ms per frame of the shadow filter (the
program's `shadow_filter` span inside the back half: passes/
shadow_filter.py's classification, compactions, K6 and K7), from the
profiled graph replays (metrics/_layers.py)."""

from metrics._layers import replay_ms

SPANS = ("shadow_filter",)


def read(ctx):
    return replay_ms(ctx, SPANS)
