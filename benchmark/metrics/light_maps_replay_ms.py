"""light_maps_replay_ms: replay ms per frame of the light-space ground
evaluation (the program's `light_maps` span: frame.py::_light_maps, one
K5 launch per cascade window), from the profiled graph replays, charged
from the end of the operation before it (metrics/_layers.py). Nothing
where the span holds no device operation: a frame without the light-space
mode."""

from metrics._layers import span_times

SPANS = ("light_maps",)


def read(ctx):
    t = span_times(ctx)
    if t is None or t.get("light_maps", (0.0, 0.0))[1] <= 0.0:
        return None
    return t["light_maps"][0]
