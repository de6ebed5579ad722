#!/usr/bin/env python3
"""The control of the output check: the cell's plain reference with every
buffer a stage hands on rounded to bfloat16 (its `store`), put in the
program's place. It has to come out as not correct.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
                                 [--frames 48]

For each seed it renders the cell's traffic with the control from the
initial state for `--frames` frames, in the window's order, keeps frame 0
and frames drawn from the seed as a run keeps them, and checks each
against the float32 reference started from the state the control carried
into it, at the cell's own size. Prints one JSON line per seed: each
number beside its limit, and whether a run would call it correct. The
benchmark's own runs do not run this.
"""

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from harness import compare, manifest, traffic  # noqa: E402
from harness import scene as scenes  # noqa: E402
from harness.main import sample_frames  # noqa: E402
from reference import scene as rs  # noqa: E402


def control_run(cell, seed: int, frames: int, device,
                size: dict | None = None) -> dict:
    """The numbers of the control on one seed."""
    tr = cell.traffic
    rr = cell.reference
    opt = rr.options(cell.config, dict(cell.config["frame"], **(size or {})))
    spec = scenes.build(tr["scene"], cell.bench_dir)
    base = traffic.base_pose(tr, float(spec.bounds_min[1]) if spec else 0.0)
    poses = [compare.ref_pose(traffic.orbit_pose(base, tr, i), device, rr)
             for i in traffic.arc(tr)]
    scene = rs.pack(spec, device)
    keep = sample_frames(seed, int(tr["check_frames"]), int(frames / 0.8))
    start = traffic.phase(len(poses), seed)
    state = rr.init_state(opt, device)
    kept = []
    with torch.no_grad():
        for f in range(frames):
            pose = traffic.position(len(poses), start + f)
            pre = tuple(t.clone() for t in state) if f else None
            rgba, state = rr.render(scene, poses[pose], state, opt,
                                    compare.bfloat16_store)
            if f in keep:
                kept.append(compare.Kept(f, pose, pre, rgba,
                                         state.shadow_history,
                                         state.prev_depth))
    worst, _ = compare.check(kept, scene, poses, opt, device, rr)
    return {"seed": seed, "frames_checked": sorted(k.frame for k in kept),
            "correct": all(worst[k] <= cell.limits[k] for k in worst),
            "checks": {k: {"value": worst[k], "limit": cell.limits[k]}
                       for k in compare.NUMBERS}}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=48)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    root = HERE.parent
    cell = manifest.cell(manifest.load(root), args.workload, root)
    for seed in args.seeds:
        print(json.dumps(control_run(cell, seed, args.frames, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
