"""cascade_maps_ms: device ms per frame. The cascade depth maps and their
quad packing (frame.py::_cascade_maps and quad_pack): the committed frame
synthesizes the maps on its footprint windows where the scene has
occluders (passes/shadow.py::synthesize_shadow_maps) and rasterizes them
in full where it has none (render_shadow_maps, the ground-only scene);
one frame calls one of the two."""

from metrics._stages import stage_sum

STAGES = (
    ("passes.shadow", "synthesize_shadow_maps"),
    ("passes.shadow", "render_shadow_maps"),
    ("frame", "quad_pack"),
)


def read(ctx):
    return stage_sum(ctx, STAGES)
