"""light_maps_roofline: K5's (csrc/lightmap.cu) share of its byte
roofline in the profiled replays: the bytes the light maps need over the
HBM peak, against K5's device time per frame.

The bytes are worked out from the tuned configuration, as chip_smoke.py::
light_map_work counts them (lines 1887-1910): for each cascade with a
window of side wc, the haloed window of the raw map (wc + 2 halo texels a
side, 4 bytes each) read once, the packed parameters read once, and the
(wc^2, 4) f32 rows written. The operations depend on the data (how many
texels find a blocker, and which rungs their penumbra weights), so this
share is of the byte bound alone: the whole roofline's share is at least
as large.
"""

import math

from metrics._replays import kernel_seconds

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
TAPS = 16
PHASES = 4
FLOAT_HEAD = 6                # plane (3), bias, two per-mode constants


def halo_texels(max_softness: float) -> int:
    """The light maps' tap reach (shadow_lightspace.py:58-60)."""
    return math.ceil(4.0 * max_softness) + 2


def param_words(use_pcss: bool, rungs: int) -> int:
    """int32 and f32 words of a window's packed parameters
    (ops/lightmap_cuda.py::param_sizes)."""
    tp = TAPS * PHASES
    n_r = rungs if use_pcss else 1
    return (2 + (2 * tp if use_pcss else 0) + 2 * n_r * tp
            + FLOAT_HEAD + 2 * n_r * tp + n_r * PHASES)


def light_map_bytes(sizes, map_size: int, max_softness: float,
                    use_pcss: bool, rungs: int) -> int:
    total = 0
    for size in sizes:
        wc = min(int(size), map_size)
        if wc <= 0:
            continue
        wp = wc + 2 * halo_texels(max_softness)
        total += 4 * wp * wp + 4 * param_words(use_pcss, rungs) \
            + 16 * wc * wc
    return total


def read(ctx):
    s = kernel_seconds(ctx, "light_map_kernel")
    cfg = ctx["cfg"]
    if not s or not cfg.light_window_sizes:
        return None
    nbytes = light_map_bytes(cfg.light_window_sizes, cfg.shadow_map_size,
                             cfg.max_softness, cfg.flags.use_pcss,
                             cfg.light_pcf_rungs)
    return 100.0 * nbytes / HBM_BYTES_PER_S / s
