"""class_maps_replay_ms: replay ms per frame of the shadow class maps (the
program's `class_maps` span: passes/shadow_classify.py, K10 on the card),
from the profiled graph replays (metrics/_layers.py)."""

from metrics._layers import replay_ms

SPANS = ("class_maps",)


def read(ctx):
    return replay_ms(ctx, SPANS)
