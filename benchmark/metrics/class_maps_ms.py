"""class_maps_ms: device ms per frame. The shadow class maps of passes/shadow_classify.py (K10 on the card)."""

from metrics._stages import stage_sum

STAGES = (
    ("frame", "build_class_maps"),
)


def read(ctx):
    return stage_sum(ctx, STAGES)
