"""autotune_s: host seconds of funky_tpu_torch.entry.tune in set-up (the
raster bins, then the sparse capacities over every pose the window
renders, in its order)."""


def read(ctx):
    return ctx["autotune_s"]
