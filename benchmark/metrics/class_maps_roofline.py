"""class_maps_roofline: K10's (csrc/class_maps.cu) share of its
roofline in the profiled replays: the least time the card could take, the
bytes the class maps need over the HBM peak, against K10's device time
per frame.

The bytes are worked out from the configuration alone, as chip_smoke.py::
stage_work counts them (lines 2524-2529): the four raw cascade maps read
once (4 bytes a texel), each coarse cell's row written once (8 f32: the
five rungs of the drop ladder, the rise and the two residual bounds), and
the four light planes read (16 bytes each). They are the same whatever
implements the class maps. The operations (under 60 a texel) are bound by
the bytes at the card's ratio of peaks, so the bytes set the roofline.
"""

from metrics._replays import kernel_seconds

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
CASCADES = 4
ROW_BYTES = 32
PLANE_BYTES = 16


def class_map_bytes(size: int, coarse: int) -> int:
    cells = CASCADES * (size // coarse) ** 2
    return CASCADES * size * size * 4 + cells * ROW_BYTES \
        + CASCADES * PLANE_BYTES


def read(ctx):
    s = kernel_seconds(ctx, "class_maps_kernel")
    if not s:
        return None
    cfg = ctx["cfg"]
    bound = class_map_bytes(cfg.shadow_map_size, cfg.class_coarse) \
        / HBM_BYTES_PER_S
    return 100.0 * bound / s
