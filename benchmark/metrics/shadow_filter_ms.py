"""shadow_filter_ms: device ms per frame. The sparse shadow filter of
passes/shadow_filter.py that the committed frame calls: its
classification, compactions, tap sets (K6) and histogram (K7)."""

from metrics._stages import stage_sum

STAGES = (
    ("passes.shadow_filter", "cascaded_shadow_sparse"),
)


def read(ctx):
    return stage_sum(ctx, STAGES)
