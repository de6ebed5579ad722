#!/usr/bin/env python3
"""Where the time of the port's dense glTF frame goes, on one NVIDIA GPU.

    python3 profile_port.py [trace.json]

Renders chip_smoke.py's configuration (multimesh scene, 1920x1080, 4 x
2048^2 cascades, dense path, kernel raster): 8 chained frames with a
synchronize around every stage (per-stage host-clock medians), 8 more
without (frame time), then one frame under torch.profiler (device time by
kernel, device busy and idle share). Writes the profiler's chrome trace to
the path given, if any. Needs a CUDA card; imports no jax.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from chip_smoke import (HEIGHT, SHADOW, WIDTH, dense_config, fail, gpu_line,
                        multimesh)

# (module, attribute, label) of each stage render_gltf_frame calls.
STAGES = (
    ("frame", "compute_frame_uniforms", "uniforms"),
    ("geometry", "transform_vertices", "geometry"),
    ("shadow", "render_shadow_maps", "shadow rasters x4"),
    ("frame", "quad_pack", "quad_pack"),
    ("frame", "_main_raster_inputs", "near clip"),
    ("frame", "raster_corners", "main raster"),
    ("deferred", "interpolate", "deferred"),
    ("shadow_filter", "cascaded_shadow", "shadow filter"),
    ("taa", "apply_shadow_taa", "taa"),
    ("contact", "compute_contact_shadow", "contact"),
    ("shading", "shade_gltf", "shading"),
)


def chain(scene, poses, cfg, dev):
    """Host-clock ms of each chained frame, each ended by a synchronize."""
    from funky_tpu_torch import frame

    state = frame.init_frame_state(cfg, dev)
    ms = []
    for p in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = frame.render_gltf_frame(scene, p, state, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, state


def stage_times(scene, poses, cfg, dev):
    """Per-stage ms: each stage function wrapped in synchronizes for the
    length of one chain, then restored."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.passes import (contact, deferred, geometry, shading,
                                        shadow, shadow_filter, taa)

    mods = dict(frame=frame, geometry=geometry, shadow=shadow,
                deferred=deferred, shadow_filter=shadow_filter, taa=taa,
                contact=contact, shading=shading)
    times = {label: [] for _, _, label in STAGES}
    saved = []

    def timed(fn, label):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for mod, attr, label in STAGES:
        fn = getattr(mods[mod], attr)
        saved.append((mods[mod], attr, fn))
        setattr(mods[mod], attr, timed(fn, label))
    try:
        chain(scene, poses, cfg, dev)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return times


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this profile needs an NVIDIA GPU")
    from funky_tpu_torch import frame
    from torch.profiler import ProfilerActivity, profile

    gpu = gpu_line()
    print(gpu, flush=True)
    dev = torch.device("cuda:0")
    gltf, scene = multimesh(dev)
    cfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=dev)
    poses = [params] * 2 + [frame.orbit_params(params, i) for i in range(1, 7)]

    times = stage_times(scene, poses, cfg, dev)
    total = sum(statistics.median(v[1:]) for v in times.values())
    for label, v in times.items():
        m = statistics.median(v[1:])
        print(f"stage {label:18s} {m:10.3f} ms  {m / total:6.1%}", flush=True)
    ms, state = chain(scene, poses, cfg, dev)
    frame_ms = statistics.median(ms[1:])
    print(f"frame {WIDTH}x{HEIGHT}: median {frame_ms:.3f} ms host clock "
          f"without stage syncs, stages summed {total:.3f} ms [{gpu}]",
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame.render_gltf_frame(scene, frame.orbit_params(params, 7), state,
                                cfg)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # Kernels and copies only: an aten op's row repeats its kernels' time.
    dev_rows = [e for e in ka
                if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e3
    print(f"profiled frame: {sum(e.count for e in dev_rows)} device "
          f"launches, device busy {busy:.3f} ms; idle share against the "
          f"unprofiled frame {1 - busy / frame_ms:.3f} [{gpu}]", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=25))
    if len(sys.argv) > 1:
        prof.export_chrome_trace(sys.argv[1])


if __name__ == "__main__":
    main()
