"""raster_roofline: the frame's five rasters (four cascades and the main
pass) against their roofline in the profiled replays: the least time the
card could take over the device time of the raster kernels, K1 and K2
(csrc/raster.cu's raster_kernel), per frame.

The least time is the larger of two bounds, both of work any raster of
the frame does, whatever its binning or kernel:
- bytes over the HBM peak: each raster's setup table read once (16 f32 a
  row: the scene's padded triangles in a cascade, and the near clip's two
  slots per `clip_capacity` more in the main pass) and its tri_id and
  depth written (8 bytes a pixel);
- FP32 operations over the peak: 16 a (pixel, triangle) pair that passes
  the cover test (three edge planes and the depth plane, 4 a plane), the
  pairs counted by covered_pairs() of the cell's plain reference (its
  configuration's `reference`: reference/rastered.py's bounded raster) on
  the scene and poses of the profiled frames.
The constants are chip_smoke.py's (HBM_BPS, FP32_OPS). The profiled
frames' poses follow from the run's cell and seed, read from its command
line (run.py's --workload and --seed); nothing where they are absent, the
reference counts no pairs or no raster kernel ran.
"""

import argparse
import pathlib
import sys

import torch

from metrics._replays import kernel_seconds

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12
OPS_PER_PAIR = 16
ROW_BYTES = 64
PIXEL_BYTES = 8
CASCADES = 4


def run_args(argv=None):
    """(workload, seed) of the run's command line, or None."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    if args.workload is None or args.seed is None:
        return None
    return args.workload, args.seed


def profiled_pairs(cell, cfg, seed: int, device) -> tuple:
    """(covered pairs per frame of the five rasters over the profiled
    frames' poses, the scene's padded triangle rows)."""
    from harness import compare, main, traffic
    from harness import scene as scenes
    from reference import scene as rs

    ra = cell.reference
    tr = cell.traffic
    spec = scenes.build(tr["scene"], cell.bench_dir)
    base = traffic.base_pose(tr, float(spec.bounds_min[1])
                             if spec is not None else 0.0)
    poses = [traffic.orbit_pose(base, tr, i) for i in traffic.arc(tr)]
    n = len(poses)
    start = traffic.phase(n, seed)
    opt = ra.options(cell.config, {"width": cfg.width, "height": cfg.height,
                                   "shadow_map_size": cfg.shadow_map_size})
    scene = rs.pack(spec, device)
    total = 0
    for i in main.PROFILED:
        pose = compare.ref_pose(poses[traffic.position(n, start + i)],
                                device, ra)
        total += sum(ra.covered_pairs(scene, pose, opt))
    return total / len(main.PROFILED), int(scene.tri_indices.shape[0])


def least_seconds(cfg, pairs: float, rows: int) -> float:
    main_rows = rows + 2 * min(max(cfg.clip_capacity, 0), rows)
    nbytes = (ROW_BYTES * (CASCADES * rows + main_rows)
              + PIXEL_BYTES * (CASCADES * cfg.shadow_map_size ** 2
                               + cfg.width * cfg.height))
    return max(nbytes / HBM_BYTES_PER_S, OPS_PER_PAIR * pairs
               / FP32_OPS_PER_S)


def read(ctx):
    from harness import manifest

    s = kernel_seconds(ctx, "raster_kernel")
    got = run_args()
    if not s or got is None:
        return None
    root = pathlib.Path(__file__).resolve().parent.parent.parent
    cell = manifest.cell(manifest.load(root), got[0], root)
    if not hasattr(cell.reference, "covered_pairs"):
        return None
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    pairs, rows = profiled_pairs(cell, ctx["cfg"], got[1], dev)
    return 100.0 * least_seconds(ctx["cfg"], pairs, rows) / s
