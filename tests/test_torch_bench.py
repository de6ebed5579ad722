"""bench_torch.py, the port of bench.py, on the CPU at a small size.

run_primary and run_secondaries at 256x144 with 256^2 maps on the
multimesh scene, n = 2 and r = 2 (the SDF frame at 64x36, the cube at
64x64); the timing loop and the motion run with counting fake frames.
What is held:
- the stdout contract: one JSON line with bench.py's keys
  (bench.py:180-190) and its rounding, `value` the median of the runs,
  vs_baseline == round(median / 60, 4) (bench.py:186);
- the secondary lines on stderr, each naming the device;
- half-res shadows tuned from the untuned config equal half-res tuned
  from the full-rate tune with bench.py:206-212's resets: no field the
  full-rate tune sets carries over;
- a failed tuning step raises out of run_primary (autotune_config would
  carry on with the defaults);
- timed_runs: n * r + 1 frame calls, the warm-up and each run drained
  once, the state chained from call to call;
- the motion run's poses equal bench.orbit_params's, carried across.
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import statistics
import subprocess
import sys

import pytest
import torch

import bench
import funky_tpu.frame as jf

import bench_torch
import funky_tpu_torch.frame as tf
from funky_tpu_torch import entry
from funky_tpu_torch.models.sdf import SdfConfig
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.utils import autotune

from .torch_parity import PARAM_FIELDS, port_params
from .torch_sharded_worker import multimesh

REPO = pathlib.Path(__file__).resolve().parent.parent
# bench.py:180-190 (motion_fps where the motion run succeeded; the port's
# raises where it fails)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "median_of", "min",
              "max", "motion_fps"}
N, R = 2, 2
SDF_SMALL = SdfConfig(width=64, height=36)
CUBE_SMALL = tf.FrameConfig(width=64, height=64)


def small_config():
    """bench.py's flags at 256x144 with 256^2 maps and 16x128 main tiles."""
    return tf.GltfConfig(width=256, height=144, shadow_map_size=256,
                         raster=RasterConfig(tile_h=16, tile_w=128),
                         flags=tf.GltfFrameFlags(committed=True,
                                                 synth_shadow_maps=True))


@pytest.fixture(scope="module")
def bench_run():
    scene, params = multimesh("cpu")
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_torch, "SDF_CONFIG", SDF_SMALL)
        mp.setattr(bench_torch, "CUBE_CONFIG", CUBE_SMALL)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            primary = bench_torch.run_primary(scene, params, small_config(),
                                              N, R, "cpu", "multimesh")
            second = bench_torch.run_secondaries(scene, params,
                                                 small_config(), N, R, "cpu")
    return dict(scene=scene, params=params, primary=primary, second=second,
                stdout=out.getvalue(), stderr=err.getvalue())


def test_stdout_contract(bench_run):
    lines = bench_run["stdout"].splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    p = bench_run["primary"]
    assert line == p.line
    assert set(line) == BENCH_KEYS
    assert len(p.fps) == len(p.motion_fps) == R
    med = statistics.median(p.fps)
    assert line["value"] == round(med, 3)
    assert line["min"] <= line["value"] <= line["max"]
    assert (line["min"], line["max"]) == (round(min(p.fps), 3),
                                          round(max(p.fps), 3))
    assert line["vs_baseline"] == round(med / 60.0, 4)
    assert line["motion_fps"] == round(statistics.median(p.motion_fps), 3)
    assert line["median_of"] == R and line["unit"] == "fps"
    assert line["metric"] == (
        "funky_tpu_torch: multimesh + 4-cascade PCSS shadows + TAA + "
        "contact shadows, 256x144")
    assert p.last.shape == (144, 256, 4) and bool(torch.isfinite(p.last).all())


def test_secondary_lines(bench_run):
    err = bench_run["stderr"]
    for prefix in ("# motion (orbit+slide): median", "# half-res shadows:",
                   "# sdf 64x36: median", "# cube 64x64: median"):
        got = [ln for ln in err.splitlines() if ln.startswith(prefix)]
        assert len(got) == 1 and got[0].endswith("[cpu]"), (prefix, err)
    assert "failed" not in err
    second = bench_run["second"]
    assert all(second[k] > 0 for k in ("half_res", "sdf", "cube"))


def test_half_res_tuned_from_scratch(bench_run):
    """bench.py:206-212 resets five capacities of the full-rate tune before
    tuning half-res; the port tunes half-res from the untuned config. On
    this scene both give the same config, so the port's tuner re-derives
    every other field it sets (slab rows, TAA need, windows, routes,
    block capacities)."""
    full = bench_run["primary"].cfg
    half = bench_run["second"]["half_cfg"]
    resets = dataclasses.replace(
        full, flags=dataclasses.replace(full.flags, half_res_shadows=True),
        shadow_pen_capacity=None, shadow_pen_cascade_caps=None,
        light_fetch_caps=None, contact_capacity=None,
        contact_march_capacity=None)
    poses = tf.tuning_poses(bench_run["params"], N)
    assert entry.tune(bench_run["scene"], poses, resets) == half
    assert half.flags.half_res_shadows
    assert half.shadow_pen_capacity < full.shadow_pen_capacity


class FakeFrame:
    """frame_fn(scene, params, state) -> (rgba, state + 1), recording the
    params and the state of each call."""

    last = None     # as a compiled frame that replayed no graph

    def __init__(self):
        self.params, self.states = [], []

    def __call__(self, scene, params, state):
        self.params.append(params)
        self.states.append(state)
        return torch.full((1,), float(len(self.states))), state + 1


@pytest.mark.parametrize("n,r", [(1, 1), (3, 2), (24, 3)])
def test_timed_runs(monkeypatch, n, r):
    drains = []
    monkeypatch.setattr(bench_torch, "drain", drains.append)
    made = []

    def make_state():
        made.append(1)
        return 0

    fake = FakeFrame()
    poses = list(range(n))
    fps, rgba = bench_torch.timed_runs(fake, make_state, "scene", poses, r,
                                       "cpu")
    assert len(fake.states) == n * r + 1
    assert fake.states == list(range(n * r + 1))      # chained
    assert fake.params == [0] + poses * r             # warm-up on poses[0]
    assert drains == ["cpu"] * (r + 1) and made == [1]
    assert len(fps) == r and all(f > 0 for f in fps)
    assert float(rgba[0]) == n * r + 1


def test_drain_on_the_cpu_is_a_no_op():
    bench_torch.drain("cpu")
    bench_torch.drain(torch.device("cpu"))


def test_motion_poses_are_bench_orbit(monkeypatch):
    """run_primary's parked run renders `params` and its motion run
    bench.py's orbit_params(params, i), i < n (bench.py:159-168), each
    warmed up on its first pose; the poses equal JAX's bit for bit."""
    n, r = 5, 2
    jparams = jf.default_gltf_params(gltf_min_y=-0.5, gltf_scale=1.0)
    params = port_params(jparams)
    fake = FakeFrame()
    monkeypatch.setattr(entry, "tune",
                        lambda scene, poses, cfg, verbose: cfg)
    monkeypatch.setattr(bench_torch.frame, "compiled_gltf_frame",
                        lambda cfg: fake)
    monkeypatch.setattr(bench_torch.frame, "init_frame_state",
                        lambda cfg, device: 0)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        bench_torch.run_primary(None, params, small_config(), n, r, "cpu",
                                "x")
    assert len(fake.params) == 2 * (n * r + 1)
    parked, motion = fake.params[:n * r + 1], fake.params[n * r + 1:]
    assert all(p is params for p in parked)
    want = [port_params(bench.orbit_params(jparams, i)) for i in range(n)]
    assert len(motion) == len(want) * r + 1
    for got, exp in zip(motion, want[:1] + want * r):
        for f in PARAM_FIELDS:
            assert torch.equal(getattr(got, f), getattr(exp, f)), f
    assert fake.states[n * r + 1] == 0    # the motion run starts afresh


@pytest.mark.parametrize("step", ["tune_raster_capacities",
                                  "tune_sparse_capacities"])
def test_a_failed_tuning_step_raises(monkeypatch, step):
    """autotune_config reports a failed step and carries on with its
    defaults; run_primary's tune raises, before any line is printed."""
    scene, params = multimesh("cpu")

    def broken(*args, **kw):
        raise RuntimeError("broken step")

    monkeypatch.setattr(autotune, step, broken)
    poses = [params]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        autotune.autotune_config(scene, poses, small_config(), verbose=True)
    assert "failed (RuntimeError('broken step'))" in err.getvalue()
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="broken step"), \
            contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        bench_torch.run_primary(scene, params, small_config(), 1, 1, "cpu",
                                "multimesh")
    assert out.getvalue() == ""


def test_main_exits_nonzero_without_a_card():
    """`python3 bench_torch.py` on a machine without a card prints no line
    and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == "", (out.returncode,
                                                      out.stdout)
    assert "no CUDA device" in out.stderr
