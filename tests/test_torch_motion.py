"""The shipped configuration under chained motion (funky_tpu_torch's
utils/autotune.py and utils/diagnostics.py): bench.py's configuration,
committed mode with synthesized cascade maps, autotuned as chip_smoke.py
tunes it, over frame.tuning_poses(params, 24): bench_poses(params, 24),
then bench.py's motion run (orbit_params(params, i), i < 24) in order,
each read parked and against its predecessor's state. Then it is
rendered over a chained orbit that runs past the tuned one.

The multimesh scene at 480x272 with 1024^2 maps (at 256^2 the
classification closes nothing). The orbit is poses 18 to 29, chained from
a fresh state: 24 to 29 are poses the autotune never saw.

Gates and why:
- every frame's occupancy, polled against the state the frame carries
  (diagnostics.probe_occupancy), within the tuned capacities but for the
  band-block budget (capacity_overflows names nothing else): a committed
  frame truncates what overflows, and the band's truncation is
  conservative (a dropped block's pixels become pairs, whose exact taps
  give the closed forms' values, and which the poll counts as pairs);
- committed == cond'd, rgba, depth, history and tri_id, bit for bit: eager
  torch runs the same ops either way while no capacity overflows.

Nothing here is compared with the JAX package, whose tuner misses the
TAA need and the contact counts of this regime.
"""

import dataclasses

import pytest
import torch

from funky_tpu_torch import frame as tf
from funky_tpu_torch.ops import compact
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.utils import autotune as ta
from funky_tpu_torch.utils import diagnostics as td

from . import torch_parity  # noqa: F401  (torch's thread count)
from .torch_sharded_worker import multimesh

N_TUNE = 24
ORBIT = range(18, 30)
OWN = 3


@pytest.fixture(scope="module")
def tuned():
    scene, params = multimesh("cpu")
    base = tf.GltfConfig(
        width=480, height=272, shadow_map_size=1024,
        raster=RasterConfig(tile_h=32, tile_w=128),
        shadow_raster=RasterConfig(tile_h=128, tile_w=256),
        flags=tf.GltfFrameFlags(committed=True, synth_shadow_maps=True))
    poses = tf.tuning_poses(params, N_TUNE)
    cfg, occ = ta.tune_sparse_capacities(
        scene, poses, ta.tune_raster_capacities(scene, poses, base))
    return scene, params, cfg, occ


@pytest.fixture(scope="module")
def orbit(tuned):
    """The chained orbit, committed and cond'd: per frame the committed
    frame's (rgba, depth, history, tri_id) and host branches, the cond'd
    frame's, and the probe's occupancy before the committed frame, and for
    the first OWN frames after it too (the pose against its own state)."""
    scene, params, cfg, _ = tuned
    conded = dataclasses.replace(cfg, flags=dataclasses.replace(
        cfg.flags, committed=False))
    out = []
    states = [tf.init_frame_state(cfg, "cpu")] * 2
    for i in ORBIT:
        pose = tf.orbit_params(params, i)
        occ = td.probe_occupancy(scene, pose, states[0], cfg)
        frames = []
        for k, c in enumerate((cfg, conded)):
            compact.reset_host_syncs()
            rgba, states[k], tri_id = tf.render_gltf_frame_ids(
                scene, pose, states[k], c)
            frames.append(((rgba, states[k].prev_depth,
                            states[k].shadow_history, tri_id),
                           compact.HOST_SYNCS))
        own = (td.probe_occupancy(scene, pose, states[0], cfg)
               if len(out) < OWN else None)
        out.append(dict(pose=i, occ=occ, own=own, committed=frames[0],
                        conded=frames[1]))
    return out


def test_tuned_for_chained_motion(tuned):
    """The chained readings reach the tuned config: the TAA need of a
    moving frame is nearly every covered pixel, too many for the
    compacted read (which the tuned config turns off), and the footprint
    windows keep every occluder."""
    _, _, cfg, occ = tuned
    assert occ["taa_need"] > 0.9 * occ["pixels"]
    assert cfg.taa_need_capacity is None
    assert all(cfg.light_window_sizes)
    assert cfg.valid_slab_rows


def test_fetch_counts_follow_the_pose(orbit):
    """Why the tuner reads poses between its tuning poses: a moving
    frame's light-map fetch counts are the same against its predecessor's
    state and against its own, so they follow the pose alone, while its
    TAA need (nearly every covered pixel in motion, none on the row slab
    parked) follows the state."""
    for f in orbit[1:OWN]:
        assert (f["occ"]["light_fetch_per_cascade"]
                == f["own"]["light_fetch_per_cascade"]), f["pose"]
        assert f["occ"]["taa_need"] > 0.9 * f["occ"]["pixels"]
        assert f["own"]["taa_need"] == 0


def test_chained_orbit_within_the_tuned_capacities(tuned, orbit):
    _, _, cfg, _ = tuned
    assert max(f["pose"] for f in orbit) >= N_TUNE
    for f in orbit:
        over = ta.capacity_overflows(cfg, f["occ"])
        assert set(over) <= {"band_block_capacity"}, (f["pose"], over)
        assert f["occ"]["synth_window_overflow"] == 0


def test_chained_orbit_committed_equals_conded(orbit):
    for f in orbit:
        (got, syncs), (want, conded_syncs) = f["committed"], f["conded"]
        assert syncs == 0 and conded_syncs > 0, f["pose"]
        for name, a, b in zip(("rgba", "depth", "history", "tri_id"), got,
                              want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
                f["pose"], name)
