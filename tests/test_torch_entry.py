"""funky_tpu_torch/entry.py, the port of __graft_entry__.py, on the CPU.

- entry's frame: `_entry` (entry() for a given scene and untuned config)
  on the multimesh scene at 256x144 with 256^2 maps: the shipped flags
  autotuned over frame.tuning_poses(params, 24). Its config, carried to
  funky_tpu field by field, renders 3 chained frames in JAX; the port's
  frames of `fn` match them under tests/test_torch_frame.py::
  test_slice_matches_jax's gates: depth within DEPTH_TOL, tri_id equal
  but on at most 0.5% of pixels (the multimesh quad's z-fight), rgba and
  history within 3/255 on all but 0.2% of the pixels whose tri_id
  agrees.
- dryrun_multichip over gloo on 1, 2 and 4 spawned ranks: JAX's ok
  lines; rank 0's frame == the port's single-device render_gltf_frame of
  the toy config bit for bit (the sharded frame's contract,
  tests/test_parallel.py), the perf-mode frame == the composition of n
  slabs in one process (see the test for why); 4 gathers on the
  raster path, 3 per perf-mode frame (JAX's comment at
  __graft_entry__.py:100-104). One rank is the card's case, where JAX's
  8^2 toy maps fail the class maps' assert.
- at 2 ranks (4 in tests/test_torch_dryrun_jax.py, so that xdist's
  loadfile runs the two beside each other: each takes ~4 min, most of it
  XLA compiling JAX's sharded light-space frame), rank 0's toy frame and
  2-frame perf-mode frame against JAX's sharded_gltf_frame on an n-device
  mesh of the conftest's virtual CPU devices at the same config and
  scene: rgba within the golden tolerance (3/255) on all but 0.2% of the
  pixels (a sharded frame returns no tri_id, so the gate covers every
  pixel; measured: at most 2.5e-5 apart). And the divergence the gloo
  test works around, in both packages: JAX's single-device perf-mode
  frame differs from JAX's sharded one past the golden tolerance, as the
  port's do, and the port's single-device frame matches JAX's within the
  gate.
- device="cuda" with fewer cards than ranks raises; every entry point
  defaults to the card; neither module imports jax nor funky_tpu.
"""

import contextlib
import dataclasses
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec

import bench
import funky_tpu.frame as jf
from funky_tpu.models.scene import build_device_scene as jbuild_device_scene
from funky_tpu.ops.raster import RasterConfig as JRasterConfig
from funky_tpu.parallel import make_mesh as jmake_mesh
from funky_tpu.parallel import sharded_gltf_frame as jsharded_gltf_frame

import funky_tpu_torch.frame as tf
from funky_tpu_torch import entry
from funky_tpu_torch.ops.raster import RasterConfig

from .test_torch_frame import (DEPTH_TOL, GOLDEN_BAD_FRAC, GOLDEN_TOL,
                               MAX_ZFIGHT_FRAC, _jax_main_raster)
from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, t2n)
from .torch_sharded_worker import compose_frame

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_BACKENDS = {"auto": "jnp", "torch": "jnp", "cuda": "pallas"}


def jax_config(cfg):
    """The port's GltfConfig as funky_tpu's, field by field (the plain
    raster on both sides)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ("raster", "shadow_raster"):
        r = kw[name]
        kw[name] = JRasterConfig(tile_h=r.tile_h, tile_w=r.tile_w,
                                 capacity=r.capacity,
                                 backend=JAX_BACKENDS[r.backend])
    kw["flags"] = jf.GltfFrameFlags(**dataclasses.asdict(cfg.flags))
    return jf.GltfConfig(**kw)


@pytest.fixture(scope="module")
def entry_run():
    jscene, jparams = multimesh_jax_scene(), multimesh_params()
    cfg = tf.GltfConfig(width=256, height=144, shadow_map_size=256,
                        raster=RasterConfig(tile_h=16, tile_w=128),
                        flags=tf.GltfFrameFlags(committed=True,
                                                synth_shadow_maps=True))
    fn, (scene, params, state) = entry._entry(port_scene(jscene),
                                              port_params(jparams), cfg)
    return dict(fn=fn, scene=scene, params=params, state=state,
                jscene=jscene, jparams=jparams)


def test_entry_returns_a_tuned_shipped_frame(entry_run):
    cfg = entry_run["fn"].keywords["cfg"]
    assert entry_run["fn"].func is tf.render_gltf_frame
    assert cfg.flags == tf.GltfFrameFlags(committed=True,
                                          synth_shadow_maps=True)
    assert cfg.shadow_pen_capacity is not None      # tuned
    assert cfg.raster.capacity is not None
    state = entry_run["state"]
    assert int(state.frame_index) == 0 and not bool(state.has_prev)


def test_entry_frame_matches_jax(entry_run):
    """3 chained frames of entry's fn against JAX's frames of the same
    config (test_committed_synth_frames_match_jax's poses and gates; the
    port's tri_id from render_gltf_frame_ids on the same inputs, whose
    rgba equals fn's)."""
    fn, scene, state = entry_run["fn"], entry_run["scene"], entry_run["state"]
    cfg = fn.keywords["cfg"]
    jcfg = jax_config(cfg)
    jframe, jmain = jf.compiled_gltf_frame(jcfg), _jax_main_raster(jcfg)
    jstate = jf.init_frame_state(jcfg)
    jparams = entry_run["jparams"]
    for i, pose in enumerate([jparams, bench.orbit_params(jparams, 1),
                              bench.orbit_params(jparams, 2)]):
        p = port_params(pose)
        ids_rgba, _, tri_id = tf.render_gltf_frame_ids(scene, p, state, cfg)
        rgba, state = fn(scene, p, state)
        assert torch.equal(rgba, ids_rgba), i
        jtri = np.asarray(jmain(entry_run["jscene"], pose, jstate)[0])
        jrgba, jstate = jframe(entry_run["jscene"], pose, jstate)
        np.testing.assert_allclose(t2n(state.prev_depth),
                                   np.asarray(jstate.prev_depth), rtol=0,
                                   atol=DEPTH_TOL, err_msg=str(i))
        same = t2n(tri_id) == jtri
        assert (~same).mean() <= MAX_ZFIGHT_FRAC, (i, (~same).sum())
        for got, want in ((rgba, jrgba),
                          (state.shadow_history, jstate.shadow_history)):
            diff = np.abs(t2n(got) - np.asarray(want)).max(-1)[same]
            assert (diff > GOLDEN_TOL).mean() <= GOLDEN_BAD_FRAC, (
                i, (diff > GOLDEN_TOL).mean(), diff.max())
        assert (t2n(state.shadow_history)[..., 0] < 1.0).mean() > 0.01


def chained(fn, cfg, n_frames):
    """The last of n_frames chained frames of fn(scene, params, state, cfg)
    on the dry run's scene."""
    scene, params, _ = entry.flagship_scene("cpu")
    state = tf.init_frame_state(cfg, "cpu")
    for _ in range(n_frames):
        rgba, state = fn(scene, params, state, cfg)
    return rgba


@pytest.fixture(scope="module")
def dryruns():
    """dryrun_multichip(n, device="cpu"), once per n: (its result, the
    lines it printed)."""
    cache = {}

    def run(n):
        if n not in cache:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                out = entry.dryrun_multichip(n, device="cpu")
            cache[n] = out, text.getvalue().splitlines()
        return cache[n]

    return run


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_over_gloo(dryruns, n):
    out, lines = dryruns(n)
    h = 8 * n
    assert lines == [
        f"dryrun_multichip({n}): ok — ({h}, 256, 4) frame on "
        f"{{'rows': {n}}} mesh (gloo)",
        f"dryrun_multichip({n}): perf-mode ok — ({h}, 256, 4) frame, 2 "
        f"temporal frames, 3 all-gathers per frame (synth maps: no cascade "
        f"exchange)"]
    assert out["gathers"] == 4 and out["perf_gathers"] == 3
    cfg = entry.dryrun_config(n)
    assert (cfg.width, cfg.height) == (256, h)
    assert cfg.shadow_map_size == (16 if n == 1 else h)
    assert torch.equal(out["frame"], chained(tf.render_gltf_frame, cfg, 1))
    # The perf-mode frame against the stages of n slabs composed in one
    # process (== the gloo frame, tests/test_torch_parallel.py). Not
    # against the single-device frame: at this size the full frame's pairs
    # overflow their capacity (the dense filter, which reads no light map)
    # where a slab's do not (the sparse filter with light maps), and in
    # the light-space mode the two filters give different shadows, in JAX
    # as here.
    assert torch.equal(out["perf_frame"], chained(
        lambda *a: compose_frame(*a, n),
        entry.dryrun_config(n, entry.PERF_FLAGS), 2))
    assert out["launches"] == {"raster_table": 0, "row_gather": 0}


def gate_frac(got, want) -> float:
    """The share of pixels whose rgba differs by more than GOLDEN_TOL."""
    diff = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    return float((diff > GOLDEN_TOL).mean())


def check_dryrun_matches_jax(out, n: int) -> None:
    """The dry run's rank-0 frames (`out`) against JAX's sharded frame on
    n virtual devices at the same config and scene, and the single-device
    perf-mode frames of both packages against the sharded ones."""
    assert len(jax.devices()) >= n
    mesh = jmake_mesh(n)
    replicated = NamedSharding(mesh, PartitionSpec())

    def put(tree):
        return jax.device_put(tree, replicated)

    jscene = jbuild_device_scene(None)
    jparams = jf.default_gltf_params(gltf_min_y=0.0)
    for name, flags, n_frames, got in (
            ("toy", None, 1, out["frame"]),
            ("perf-mode", entry.PERF_FLAGS, 2, out["perf_frame"])):
        cfg = entry.dryrun_config(n, flags)
        jcfg = jax_config(cfg)
        assert jcfg.shadow_map_size == 8 * n    # JAX's own toy maps
        frame_n = jsharded_gltf_frame(mesh, jcfg)
        jstate = put(jf.init_frame_state(jcfg))
        for _ in range(n_frames):
            jrgba, jstate = frame_n(put(jscene), put(jparams), jstate)
        frac = gate_frac(t2n(got), jrgba)
        assert frac <= GOLDEN_BAD_FRAC, (name, frac)
    # the perf-mode divergence between one device and n, in both packages
    jframe1 = jf.compiled_gltf_frame(jcfg)
    jstate1 = jf.init_frame_state(jcfg)
    for _ in range(n_frames):
        jsingle, jstate1 = jframe1(jscene, jparams, jstate1)
    single = chained(tf.render_gltf_frame, cfg, n_frames)
    assert gate_frac(jsingle, jrgba) > 0, "JAX: one device == n devices"
    assert gate_frac(t2n(single), t2n(got)) > 0, "port: 1 == n devices"
    frac = gate_frac(t2n(single), jsingle)
    assert frac <= GOLDEN_BAD_FRAC, ("single device", frac)


def test_dryrun_matches_jax(dryruns):
    check_dryrun_matches_jax(dryruns(2)[0], 2)


def test_dryrun_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one per rank"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="one per rank"):
        entry.dryrun_multichip(2, device="cuda")


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (entry.entry, entry.dryrun_multichip, entry.flagship_scene):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__


IMPORT_SCRIPT = """
import sys
sys.modules["jax"] = None          # any import of jax raises
sys.modules["funky_tpu"] = None
import bench_torch
import funky_tpu_torch.entry
assert not any(m == "jax" or m.startswith(("jax.", "funky_tpu."))
               for m in sys.modules if sys.modules[m] is not None), \\
    [m for m in sys.modules if m.startswith(("jax", "funky_tpu."))]
print("ok")
"""


def test_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
