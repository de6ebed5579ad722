"""binning_replay_ms: replay ms per frame of the rasters' binning (the
program's `cascade_binning` and `main_binning` spans, nested in
`cascade_maps` and `main_raster`: each raster's triangle setup,
ops/binning.py::bin_triangles and, on the pre-gathered route,
gather_bin_data), summed over the five rasters, from the profiled graph
replays, each range charged from the end of the operation before it
(metrics/_layers.py). Nothing where the program has no such span."""

from metrics._layers import span_times

SPANS = ("cascade_binning", "main_binning")


def read(ctx):
    t = span_times(ctx)
    if t is None or any(s not in t for s in SPANS):
        return None
    return sum(t[s][0] for s in SPANS)
