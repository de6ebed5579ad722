"""One run of one cell: set-up, the measured window, the output check, the
result line. See benchmark/run.py for the command."""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import statistics
import sys
import tempfile
import time

import torch

from . import compare, manifest, program, trace, traffic
from . import scene as scenes
from . import window as win

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "funky_tpu")
GIB = float(1 << 30)
# the window's frames profiled in a --trace 1 run
PROFILED = range(40, 45)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _p95(values) -> float:
    """The 95th percentile of the frame intervals; a window of one frame
    has one interval, which is its own percentile."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def sample_frames(seed: int, n_keep: int, est_frames: int) -> set:
    """Frame 0 (the start) and n_keep - 1 frames drawn from the seed among
    the first four fifths of the frames the window is expected to hold."""
    rng = random.Random(seed * 7919 + 17)
    hi = max(2, int(0.8 * est_frames))
    picks = {0}
    while len(picks) < min(n_keep, hi):
        picks.add(rng.randrange(1, hi))
    return picks


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace_on: bool,
             device, t_start: float, size: dict | None = None,
             frame_fn=None) -> dict:
    """Everything but the device check and the import check. `size`
    replaces the frame size and `frame_fn` wraps the compiled frame: the
    CPU tests use both, the benchmark neither."""
    from reference import scene as rs

    rr = cell.reference
    cuda = torch.device(device).type == "cuda"
    tr = cell.traffic
    frame_cfg = dict(cell.config["frame"], **(size or {}))
    if cuda:
        program.build_kernels()
        torch.cuda.reset_peak_memory_stats()
    opt = rr.options(cell.config, frame_cfg)
    spec = scenes.build(tr["scene"], cell.bench_dir)
    gltf_min_y = float(spec.bounds_min[1]) if spec is not None else 0.0
    base = traffic.base_pose(tr, gltf_min_y)
    poses = [traffic.orbit_pose(base, tr, i) for i in traffic.arc(tr)]
    with tempfile.TemporaryDirectory() as td:
        scene = program.load_scene(spec, pathlib.Path(td) / "scene.glb",
                                   device)
    params = [program.params(p, device) for p in poses]
    cfg = program.config(cell.config, frame_cfg)
    tune_order = traffic.tuning_positions(len(params))
    cfg, autotune_s = program.tune(scene, [params[i] for i in tune_order],
                                   cfg)
    overflows = (program.overflows(scene, [params[i] for i in tune_order],
                                   cfg) if trace_on else None)
    fn = program.compiled(cfg)
    if frame_fn is not None:
        fn = frame_fn(fn)

    start = traffic.phase(len(params), seed)

    def schedule(i):
        return traffic.position(len(params), start + i)

    # warm-up: the capture (first call) and replays of every pose, timed
    state = program.init_state(cfg, device)
    warm = 2 * (len(params) - 1)
    for i in range(2):
        rgba, state = fn(scene, params[schedule(i)], state)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, warm):
        rgba, state = fn(scene, params[schedule(i)], state)
    if cuda:
        torch.cuda.synchronize()
    est_frame_s = (time.perf_counter() - t0) / max(1, warm - 2)
    if trace_on:
        # the profiler's first start initialises the device tracer, which
        # takes seconds: done here, not inside the window
        with torch.profiler.profile(activities=_activities(cuda)):
            rgba, state = fn(scene, params[schedule(warm)], state)
            if cuda:
                torch.cuda.synchronize()
    del rgba, state
    keep = sample_frames(seed, int(tr["check_frames"]),
                   int(seconds / max(est_frame_s, 1e-6)))

    state = program.init_state(cfg, device)
    setup_s = time.perf_counter() - t_start
    w = win.run(fn, scene, params, schedule, state, seconds,
                int(cell.config["frames_in_flight"]), keep,
                PROFILED if trace_on else None, device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    ctx = {"cfg": cfg, "autotune_s": autotune_s, "stages": None,
           "replay_ops": None, "replays": len(PROFILED)}
    breakdown = busy = span = None
    if trace_on:
        readers = {m.name: manifest.reader(m.name) for m in cell.per_layer}
        if w.profile is not None:
            evs = trace.events(w.profile)
            ops = trace.device_ops(evs)
            busy, span = trace.busy_and_span(ops)
            ctx["replay_ops"] = ops
            breakdown = {"device_ops": trace.top_ops(ops),
                         "idle_gaps": trace.idle_gaps(ops, evs)}
        stages = [s for r in readers.values() for s in getattr(r, "STAGES",
                                                                ())]
        ctx["stages"] = _stages(scene, params[schedule(w.frames)], w.state,
                                cfg, stages, cuda)
    w = w._replace(state=None)
    del state, fn, scene
    program.release()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    ref_scene = rs.pack(spec, device)
    ref_poses = [compare.ref_pose(p, device, rr) for p in poses]
    t_check = time.perf_counter()
    worst, per = compare.check(w.kept, ref_scene, ref_poses, opt, device, rr)
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": worst[k], "limit": cell.limits[k]}
              for k in compare.NUMBERS}
    failed = sum(1 for got in per
                 if any(not got[k] <= cell.limits[k] for k in got))

    if trace_on:
        metrics = {}
        for m in cell.per_layer:
            v = readers[m.name].read(ctx)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        values = {
            "frames_per_s": w.frames / w.seconds,
            "frame_ms_p95": _p95(w.intervals_ms),
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        metrics = {m.name: {"value": values[m.name], "unit": m.unit}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace_on:
        dev["busy_s"] = busy
        dev["window_s"] = span
    out = {"correct": failed == 0, "attempted": w.frames,
           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    iv = sorted(w.intervals_ms)
    notes = [f"frames checked {sorted(k.frame for k in w.kept)} of "
             f"{w.frames} in {check_s:.3f} s; autotune {autotune_s} s; "
             f"tuned {cfg}",
             f"host per frame: {1e3 * w.submit_s / w.frames:.3f} ms in the "
             f"frame call, {1e3 * w.wait_s / w.frames:.3f} ms waiting; frame "
             f"intervals ms min {iv[0]:.3f} p10 {iv[len(iv) // 10]:.3f} "
             f"p50 {iv[len(iv) // 2]:.3f} p90 {iv[9 * len(iv) // 10]:.3f} "
             f"max {iv[-1]:.3f}"]
    if overflows is not None:
        notes.append(f"capacity_overflows over the window's poses: "
                     f"{overflows}")
    return {"result": out, "notes": notes}


def _activities(cuda: bool) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _stages(scene, params, state, cfg, stages, cuda) -> tuple:
    """trace.stage_charges of one eager frame of cfg with each listed stage
    wrapped, from a copy of the state, under the profiler."""
    from funky_tpu_torch import frame

    copy = type(state)(*(t.clone() for t in state))
    with trace.wrapped(stages), \
            torch.profiler.profile(activities=_activities(cuda)) as p:
        frame.render_gltf_frame(scene, params, copy, cfg)
        if cuda:
            torch.cuda.synchronize()
    return trace.stage_charges(trace.events(p))


def main(argv, t_start: float) -> int:
    args = parse(argv)
    root = BENCH_DIR.parent
    try:
        cell = manifest.cell(manifest.load(root), args.workload, root)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; this benchmark measures an NVIDIA "
              "GPU and does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} GPU(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    out = run["result"]
    for line in run["notes"]:
        print(line, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
