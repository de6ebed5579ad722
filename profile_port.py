#!/usr/bin/env python3
"""Where the time of the port's glTF frame goes, on one NVIDIA GPU.

    python3 profile_port.py [--config dense|default|shipped|half_res|
                                      lightspace]
                            [--scene multimesh|large] [--trace trace.json]
                            [--graph] [--occupancy]
                            [--override FIELD=VALUE ...] [--tree PATH]

Renders one of chip_smoke.py's configurations at 1920x1080 with 4 x
2048^2 cascades and kernel rasters: the exact dense path (`dense`, the
default), GltfConfig() (`default`: sparse shadows and contact,
valid-block back half, block-sparse texture sampling), bench.py's
shipped configuration (`shipped`: committed mode with synthesized
cascade maps, autotuned over frame.tuning_poses first), or the shipped
configuration with a perf mode on, autotuned on its own (`half_res`:
half-rate shadow evaluation, whose upsample `resize_linear` is a part;
`lightspace`: the light-space ground evaluation with the back-face skip,
whose light maps are the `light_maps` span and whose fetch split and
fetch groups are parts), on the multimesh or the large scene. 8 chained
frames (2 parked, 6 orbit poses) with a synchronize around every part
of the shadow filter and the contact stage (NESTED and MODE_PARTS:
per-part host-clock medians), 8 more without (frame time), then one frame under
torch.profiler (device time by kernel, device busy and idle share, the
device time of the row-gather kernel K3 and of torch indexing
`aten::index`, and the launch geometry of the frame's largest gather
kernels). In that frame each layer is the program's own span
(utils/profiling.py::FRAME_SPANS, a `record_function` range "span:
<name>" under the profiler) and each part a range of this script's
wrappers, and each kernel, copy and memset is charged to the ranges that
were open on the host when it was launched: each layer's and part's
device ms with the ranges nested in it and without them. The shadow
filter's parts: its tap sets (`_pcss_taps`, `_pcf_taps`), its per-group
pair histogram (`_group_counts`), its pair gathers and scatters
(`gather_rows`, `scatter_back`), and in the perf modes the upsample
(`resize_linear`) and the light-space fetch split and groups. The
contact stage's: its residual pyramid, front, stage-2 compaction,
certificate, stage-3 compaction, payload gathers and march. A checkout
given by `--tree` whose package has no spans shows the parts alone.
Writes the profiler's chrome trace to the path given, if any. With `--graph` (a committed configuration,
whose frame frame.compiled_gltf_frame records as a CUDA graph)
it then times 8 chained replays and profiles one: the device's own kernel
times with the host's launches out of the way, summed by kernel name from
the trace. `--override` replaces fields of the tuned configuration (each
value a Python literal, e.g. `taa_need_capacity=4096`), to time one
capacity's share of the frame. With `--occupancy` (a committed
configuration) it instead walks chip_smoke.py's chained trajectory (2
parked frames, then orbit poses 0..47) with the configuration tuned over
bench_poses alone, and prints each frame's poll (utils/diagnostics.
probe_occupancy) against its predecessor's state and against its own,
the overflows of those caps, and the caps the autotune gives over
frame.tuning_poses, which adds bench.py's motion run: which counts follow
the pose and which the carried state. `--tree PATH` profiles the package
(and chip_smoke.py) of another checkout, such as a parent commit unpacked
under local/, with this script. Needs a CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import ast
import collections
import contextlib
import dataclasses
import json
import pathlib
import statistics
import sys
import tempfile
import time

import torch

# --tree: the checkout whose package and chip_smoke.py are imported, read
# before the import below (argparse reads it again in main).
TREE = pathlib.Path(__file__).resolve().parent
if "--tree" in sys.argv[:-1]:
    TREE = pathlib.Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
sys.path.insert(0, str(TREE))

from chip_smoke import (HEIGHT, PERF_MODES, SHADOW, WIDTH, autotune_shipped,
                        chained_trajectory, default_config, dense_config,
                        fail, gpu_line, load_scene, poses_for, scene_params,
                        trace_kernels)

CONFIGS = ("dense", "default", "shipped", "half_res", "lightspace")
# The perf modes' own parts: resize_linear runs inside the shadow_filter
# and contact spans, the fetch split and groups inside the shadow filter.
MODE_PARTS = {
    "half_res": (("frame", "resize_linear", "resize_linear (upsample)"),),
    "lightspace": (("shadow_filter", "_fetchable", "fetch split"),
                   ("shadow_filter", "_fetch_rows", "fetch groups")),
}
# (module, attribute, label) of the parts of the shadow filter, timed and
# charged as ranges nested in its span:
# the tap sets (the dense filter's, or the sparse filter's pair groups'),
# the per-group pair histogram, and the filter's own compaction gathers and
# scatters (the pair groups' payload, the band's classification).
NESTED = (
    ("shadow_filter", "_pcss_taps", "filter taps (PCSS)"),
    ("shadow_filter", "_pcf_taps", "filter taps (PCF)"),
    ("shadow_filter", "_group_counts", "pair histogram"),
    ("shadow_filter", "gather_rows", "filter gather_rows"),
    ("shadow_filter", "scatter_back", "filter scatter_back"),
) + (
    # Parts of the contact stage: its residual pyramid, the front (the ray
    # setup, jitter and segment certificate: K8 where the package has
    # contact_front, else _ray_setup, _jitter_at and contact_classify),
    # the stage-2 and stage-3 compactions (compact_indices_blocked for a
    # blocked stage 2, compact_indices for stage 3 and an unblocked stage
    # 2), the certificate (K9's certify, with stage 3's compaction inside
    # it where the package has contact_certify_compact: its stage-3
    # compaction part then reads 0, its time in the certificate's; else
    # _stage2_certify), the payload gathers (without K9 the stage-2 and
    # stage-3 rows; with it, the march window's rows), and the march
    # (K9's march, else
    # quad_pack, _march, _soft_term and scatter_back; contact.quad_pack
    # also packs the pyramid's level-0 map inside build_residual_pyramid,
    # a few us, charged here in both). A part whose function the package
    # lacks is skipped, so one list serves a checkout with the kernels and
    # one without.
    ("contact", "build_residual_pyramid", "contact pyramid"),
    ("contact", "contact_front", "contact front"),
    ("contact", "_ray_setup", "contact front"),
    ("contact", "_jitter_at", "contact front"),
    ("contact", "contact_classify", "contact front"),
    ("contact", "compact_indices_blocked", "contact stage-2 compaction"),
    ("contact", "compact_indices", "contact stage-3 compaction"),
    ("contact", "contact_certify", "contact certify"),
    ("contact", "contact_certify_compact", "contact certify"),
    ("contact", "_stage2_certify", "contact certify"),
    ("contact", "gather_rows", "contact gather_rows"),
    ("contact", "contact_march", "contact march"),
    ("contact", "quad_pack", "contact march"),
    ("contact", "_march", "contact march"),
    ("contact", "_soft_term", "contact march"),
    ("contact", "scatter_back", "contact march"),
)
RANGE = "stage: "
SPAN = "span: "             # utils/profiling.py::RANGE


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


@contextlib.contextmanager
def wrapped_stages(stages, wrap):
    """Replace each stage function by wrap(fn, label) for the length of
    the block, then restore it."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.passes import (contact, deferred, geometry, shading,
                                        shadow, shadow_filter,
                                        shadow_lightspace, taa)

    mods = dict(frame=frame, geometry=geometry, shadow=shadow,
                deferred=deferred, shadow_filter=shadow_filter, taa=taa,
                contact=contact, shading=shading,
                shadow_lightspace=shadow_lightspace)
    saved = []
    for mod, attr, label in stages:
        if not hasattr(mods[mod], attr):
            continue
        fn = getattr(mods[mod], attr)
        saved.append((mods[mod], attr, fn))
        setattr(mods[mod], attr, wrap(fn, label))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def stage_times(scene, poses, cfg, dev, stages):
    """Per-part ms: each part's function wrapped in synchronizes for the
    length of one chain."""
    times = {label: [] for _, _, label in stages}

    def timed(fn, label):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    with wrapped_stages(stages, timed):
        chain(scene, poses, cfg, dev)
    return times


def ranged(fn, label):
    """fn under a record_function range named for its part."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(RANGE + label):
            return fn(*args, **kwargs)
    return run


def trace_events(prof, path=None) -> list:
    """The events of a profiled run's chrome trace, written to `path` if
    given (a profile's trace can be exported once)."""
    with tempfile.TemporaryDirectory() as td:
        out = pathlib.Path(path or pathlib.Path(td) / "trace.json")
        prof.export_chrome_trace(str(out))
        return json.loads(out.read_text())["traceEvents"]


def stage_device_ms(events):
    """{layer or part: (calls, device ms with the ranges nested in it,
    device ms without them)} of one profiled run's trace events, the
    layers under the program's spans and the parts under `ranged`: each
    kernel, copy and memset is charged to every range open on the host
    when it was launched (its launch call's correlation id), and its own
    share to the innermost one; "(no stage)" holds the rest."""
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0),
               e["name"].split(": ", 1)[1])
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith((RANGE, SPAN))]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    calls = collections.Counter(label for _, _, label in ranges)
    incl = collections.defaultdict(float)
    own = collections.defaultdict(float)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ms = e.get("dur", 0) / 1e3
        ts = launched.get(e.get("args", {}).get("correlation"))
        open_ = [r for r in ranges if ts is not None and r[0] <= ts <= r[1]]
        for label in {r[2] for r in open_}:
            incl[label] += ms
        inner = min(open_, key=lambda r: r[1] - r[0])[2] if open_ \
            else "(no stage)"
        own[inner] += ms
    return {label: (calls.get(label, 0), incl.get(label, own[label]),
                    own[label])
            for label in list(calls) + ["(no stage)"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=CONFIGS, default="dense")
    ap.add_argument("--scene", choices=("multimesh", "large"),
                    default="multimesh")
    ap.add_argument("--trace", help="write the profiler's chrome trace here")
    ap.add_argument("--graph", action="store_true",
                    help="also profile the compiled frame's graph replay "
                         "(--config shipped)")
    ap.add_argument("--occupancy", action="store_true",
                    help="walk the chained trajectory's occupancy instead "
                         "(--config shipped, half_res or lightspace)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="replace a field of the tuned configuration")
    ap.add_argument("--tree", default=str(TREE),
                    help="profile the package of this checkout")
    args = ap.parse_args()
    if (args.graph or args.occupancy) and args.config in ("dense",
                                                          "default"):
        fail("--graph and --occupancy need a committed configuration "
             "(shipped, half_res, lightspace)")
    if not torch.cuda.is_available():
        fail("no CUDA device: this profile needs an NVIDIA GPU")
    from funky_tpu_torch import frame
    from funky_tpu_torch.ops import compact
    from torch.profiler import ProfilerActivity, profile

    gpu = gpu_line()
    print(gpu, flush=True)
    dev = torch.device("cuda:0")
    gltf, scene = load_scene(dev, large=args.scene == "large")
    params = scene_params(gltf, dev)
    if args.occupancy:
        occupancy_walk(scene, params, dev, args.config, gpu)
        return
    if args.config == "dense":
        cfg = dense_config(WIDTH, HEIGHT, SHADOW, "auto")
    elif args.config == "default":
        cfg = default_config()
    else:
        _, cfg, _, tune_s = autotune_shipped(
            dev, scene, frame.tuning_poses(params, 24),
            **PERF_MODES.get(args.config, {}))
        print(f"autotune {tune_s:.3f} s: {cfg}", flush=True)
    for item in args.override:
        field, value = item.split("=", 1)
        cfg = dataclasses.replace(cfg, **{field: ast.literal_eval(value)})
        print(f"override {field} = {getattr(cfg, field)}", flush=True)
    poses = poses_for(params, 2, 6)
    print(f"{args.config} configuration, {args.scene} scene, package "
          f"{TREE}", flush=True)

    stages = NESTED + MODE_PARTS.get(args.config, ())
    times = stage_times(scene, poses, cfg, dev, stages)
    for label, v in times.items():
        if not v[1:]:
            print(f"part {label:24s} not run", flush=True)
            continue
        print(f"part {label:24s} {statistics.median(v[1:]):10.3f} ms  "
              f"({len(v)} calls, nested in the shadow filter or contact)",
              flush=True)
    compact.reset_host_syncs()
    ms, state = chain(scene, poses, cfg, dev)
    frame_ms = statistics.median(ms[1:])
    print(f"frame {WIDTH}x{HEIGHT}: median {frame_ms:.3f} ms host clock "
          f"without part syncs; host branches over {len(poses)} frames "
          f"{dict(compact.BRANCHES)} [{gpu}]", flush=True)

    with wrapped_stages(stages, ranged), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        frame.render_gltf_frame(scene, frame.orbit_params(params, 7), state,
                                cfg)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # Kernels and copies only: an aten op's row repeats its kernels' time.
    dev_rows = [e for e in ka
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith((RANGE, SPAN))]
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e3
    print(f"profiled frame: {sum(e.count for e in dev_rows)} device "
          f"launches, device busy {busy:.3f} ms; idle share against the "
          f"unprofiled frame {1 - busy / frame_ms:.3f} [{gpu}]", flush=True)
    # K3's kernel rows, and torch indexing with the kernels it launched
    k3 = [e for e in dev_rows if "row_gather" in e.key]
    index = [e for e in ka if e.key == "aten::index"]
    k3_ms = sum(e.self_device_time_total for e in k3) / 1e3
    index_ms = sum(e.device_time_total for e in index) / 1e3
    print(f"profiled frame: K3 row_gather {k3_ms:.3f} ms device time over "
          f"{sum(e.count for e in k3)} launches; aten::index {index_ms:.3f} "
          f"ms device time over {sum(e.count for e in index)} calls [{gpu}]",
          flush=True)
    for kernel, word in (("K6", "pair_taps"), ("K7", "group_counts"),
                         ("K8", "contact_front"), ("K9", "contact_certify"),
                         ("K9", "contact_march"), ("K10", "class_maps")):
        rows = [e for e in dev_rows if word in e.key]
        print(f"profiled frame: {kernel} {word} "
              f"{sum(e.self_device_time_total for e in rows) / 1e3:.4f} ms "
              f"device time over {sum(e.count for e in rows)} launches "
              f"[{gpu}]", flush=True)
    events = trace_events(prof, args.trace)
    by_stage = stage_device_ms(events)
    for label, (n_calls, incl, own) in by_stage.items():
        print(f"profiled frame device ms: {label:24s} {incl:9.3f} ms "
              f"{incl / busy:6.1%} of busy, without nested ranges "
              f"{own:9.3f} ms ({n_calls} calls) [{gpu}]", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=25))
    gathers = sorted(((e["name"], e.get("dur", 0) / 1e3,
                       e.get("args", {}).get("grid"),
                       e.get("args", {}).get("block")) for e in events
                      if e.get("cat") == "kernel"
                      and ("gather" in e["name"] or "index" in e["name"])),
                     key=lambda k: -k[1])
    for name, ms, grid, block in gathers[:8]:
        print(f"gather kernel {name[:90]}: {ms:.3f} ms, grid {grid}, block "
              f"{block}", flush=True)
    if args.graph:
        replay_profile(scene, params, poses, cfg, dev, gpu)


def occupancy_walk(scene, params, dev, config, gpu) -> None:
    """Each chained frame's poll against its predecessor's state and
    against its own, with the caps of the tune over bench_poses alone
    (module docstring)."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.utils.autotune import capacity_overflows
    from funky_tpu_torch.utils.diagnostics import probe_occupancy

    def caps(cfg):
        return (f"contact {cfg.contact_capacity} / march "
                f"{cfg.contact_march_capacity}, taa_need "
                f"{cfg.taa_need_capacity}, light fetches "
                f"{cfg.light_fetch_caps}, cascade taps "
                f"{cfg.shadow_pen_cascade_caps}, windows "
                f"{cfg.light_window_sizes}")

    tuned = {}
    for name, poses in (("bench_poses", frame.bench_poses(params, 24)),
                        ("tuning_poses", frame.tuning_poses(params, 24))):
        _, tuned[name], _, tune_s = autotune_shipped(
            dev, scene, poses, **PERF_MODES.get(config, {}))
        print(f"{config}, tuned over {name} in {tune_s:.3f} s: "
              f"{caps(tuned[name])} [{gpu}]", flush=True)
    cfg = tuned["bench_poses"]
    keys = ("light_fetch_per_cascade", "contact_stage2", "contact_march",
            "taa_need")
    state = frame.init_frame_state(cfg, dev)
    for i, p in enumerate(chained_trajectory(params)):
        chained = probe_occupancy(scene, p, state, cfg)
        _, state = frame.render_gltf_frame(scene, p, state, cfg)
        own = probe_occupancy(scene, p, state, cfg)
        print(f"frame {i}: " + "; ".join(
            f"{k} {chained[k]} chained / {own[k]} own" for k in keys)
            + f"; over the bench_poses caps "
            f"{capacity_overflows(cfg, chained)}", flush=True)


def replay_profile(scene, params, poses, cfg, dev, gpu) -> None:
    """Host-clock ms of chained replays of the compiled committed frame,
    then one replay under torch.profiler: its kernels by name from the
    trace (a graph's kernels carry no aten op), longest first."""
    from torch.profiler import ProfilerActivity, profile

    from funky_tpu_torch import frame

    fn = frame.compiled_gltf_frame(cfg)
    state = frame.init_frame_state(cfg, dev)
    ms = []
    for p in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = fn(scene, p, state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if fn.last is None:
        fail("the compiled frame recorded no graph")
    print(f"graph replay {WIDTH}x{HEIGHT}: median {statistics.median(ms[1:]):.3f}"
          f" ms host clock over {len(ms) - 1} replays after the capture; "
          f"launches at capture {fn.last.launches} [{gpu}]", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(scene, frame.orbit_params(params, 7), state)
        torch.cuda.synchronize()
    kernels = trace_kernels(prof, words=("",))
    busy = sum(k[1] for k in kernels)
    by_name: dict = {}
    for name, k_ms, _, _ in kernels:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + k_ms, n + 1)
    print(f"profiled replay: {len(kernels)} kernels, device busy "
          f"{busy:.3f} ms [{gpu}]", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"replay kernel {t:8.3f} ms {t / busy:6.1%} x{n:4d}  "
              f"{name[:110]}", flush=True)


if __name__ == "__main__":
    main()
