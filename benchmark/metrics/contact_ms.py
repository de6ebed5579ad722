"""contact_ms: device ms per frame. Contact shadows, passes/contact.py: the
reference plane and the sparse march (K8, K9 on the card), the two
functions the committed frame calls."""

from metrics._stages import stage_sum

STAGES = (
    ("passes.contact", "reference_plane"),
    ("passes.contact", "compute_contact_shadow_sparse"),
)


def read(ctx):
    return stage_sum(ctx, STAGES)
