"""back_half_replay_ms: replay ms per frame of the back half less its
shadow filter and contact (the program's `back_half` span without the
`shadow_filter` and `contact` spans inside it: the slab, deferred, TAA and
shading), from the profiled graph replays (metrics/_layers.py)."""

from metrics._layers import replay_ms

SPANS = ("back_half",)
LESS = ("shadow_filter", "contact")


def read(ctx):
    return replay_ms(ctx, SPANS, LESS)
