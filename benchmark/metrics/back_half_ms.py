"""back_half_ms: device ms per frame. The back half's other stages: the
deferred interpolation, shadow TAA and shading (passes/deferred.py,
taa.py, shading.py), each the one function the committed frame calls
(frame.py::_shade_slab_dense calls deferred.interpolate, which calls
interpolate_at inside it)."""

from metrics._stages import stage_sum

STAGES = (
    ("passes.deferred", "interpolate"),
    ("passes.taa", "apply_shadow_taa"),
    ("passes.shading", "shade_gltf"),
)


def read(ctx):
    return stage_sum(ctx, STAGES)
