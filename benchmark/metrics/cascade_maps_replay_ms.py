"""cascade_maps_replay_ms: replay ms per frame of the cascade depth maps
and their quad packing (the program's `cascade_maps` and `quad_pack`
spans: frame.py::_cascade_maps, synthesized or rasterized, and
quad_pack), from the profiled graph replays, each layer charged from the
end of the operation before it (metrics/_layers.py)."""

from metrics._layers import replay_ms

SPANS = ("cascade_maps", "quad_pack")


def read(ctx):
    return replay_ms(ctx, SPANS)
