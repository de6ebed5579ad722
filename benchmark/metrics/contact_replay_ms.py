"""contact_replay_ms: replay ms per frame of the contact shadows (the
program's `contact` span inside the back half: passes/contact.py's plane
and sparse march, K8 and K9), from the profiled graph replays
(metrics/_layers.py)."""

from metrics._layers import replay_ms

SPANS = ("contact",)


def read(ctx):
    return replay_ms(ctx, SPANS)
