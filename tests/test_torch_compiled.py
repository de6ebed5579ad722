"""The port's compiled frames (funky_tpu_torch/frame.py::
compiled_cube_frame, compiled_gltf_frame, GraphFrame; models/sdf.py::
compiled_sdf_frame), the counterpart of the JAX package's jit cache
(frame.py:1030-1054).

On the CPU every callable is the eager function: its frames equal
render_* bit for bit, and no graph is recorded. On the card (marker
`cuda`, skipped without one) a committed glTF config, the cube and the SDF
frame are recorded once as CUDA graphs and replayed, and so is the
committed row-sharded frame on a one-rank NCCL group
(parallel/sharded_frame.py); their frames equal the eager frames bit for
bit (the same kernels on the same inputs), and a cond'd config runs
eagerly. The module imports no jax, so the card half
runs where jax is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_compiled.py
"""

import dataclasses
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from funky_tpu_torch import frame
from funky_tpu_torch import math3d as m3
from funky_tpu_torch.models import sdf
from funky_tpu_torch.models.gltf import GltfScene
from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
from funky_tpu_torch.models.scene import build_cube_scene, build_device_scene
from funky_tpu_torch.ops.raster import RasterConfig

SMALL = dict(width=256, height=144, shadow_map_size=256,
             raster=RasterConfig(tile_h=16, tile_w=128),
             shadow_raster=RasterConfig(tile_h=16, tile_w=128))


def multimesh(device):
    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(
            pathlib.Path(td) / "multi.glb", two_textures=True))
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=device)
    return build_device_scene(gltf, device=device), params


def committed_config():
    return frame.GltfConfig(flags=frame.GltfFrameFlags(
        committed=True, synth_shadow_maps=True), **SMALL)


def poses(params, n=3):
    return [params] + [frame.orbit_params(params, i) for i in range(1, n)]


def bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().reshape(-1).contiguous().view(
        torch.uint8).numpy()


def assert_bits_equal(a: torch.Tensor, b: torch.Tensor, what=""):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=what)


def chained(fn, scene, ps, cfg, device):
    """(rgba, FrameState) per pose through fn(scene, params, state)."""
    state = frame.init_frame_state(cfg, device)
    out = []
    for p in ps:
        rgba, state = fn(scene, p, state)
        out.append((rgba.clone(), frame.FrameState(*(x.clone()
                                                     for x in state))))
    return out


# ---------------------------------------------------------------------------
# CPU: the eager function and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("committed", [True, False])
def test_cpu_gltf_callable_is_the_eager_frame(committed):
    scene, params = multimesh("cpu")
    cfg = dataclasses.replace(committed_config(), flags=dataclasses.replace(
        committed_config().flags, committed=committed))
    fn = frame.compiled_gltf_frame(cfg)
    got = chained(fn, scene, poses(params), cfg, "cpu")
    want = chained(lambda s, p, st: frame.render_gltf_frame(s, p, st, cfg),
                   scene, poses(params), cfg, "cpu")
    for (ra, sa), (rb, sb) in zip(got, want):
        assert_bits_equal(ra, rb, "rgba")
        for name, a, b in zip(frame.FrameState._fields, sa, sb):
            assert_bits_equal(a, b, name)
    assert fn.last is None and not fn.captures
    assert fn.uses_graph("cuda") == committed and not fn.uses_graph("cpu")


def test_cpu_cube_callable_is_the_eager_frame():
    cfg = frame.FrameConfig(width=128, height=128, raster=RasterConfig(
        tile_h=16, tile_w=128, capacity=32))
    scene = build_cube_scene(device="cpu")
    fn = frame.compiled_cube_frame(cfg)
    for r in (0.0, 0.6):
        p = frame.default_cube_params(r, device="cpu")
        assert_bits_equal(fn(scene, p), frame.render_cube_frame(scene, p,
                                                                cfg))
    assert fn.last is None and not fn.captures and fn.uses_graph("cuda")


def test_cpu_sdf_callable_is_the_eager_frame():
    cfg = sdf.SdfConfig(width=64, height=40)
    cam = sdf.default_sdf_camera(device="cpu")
    fn = sdf.compiled_sdf_frame(cfg)
    assert_bits_equal(fn(1.3, *cam), sdf.render_sdf_frame(1.3, *cam, cfg))
    assert fn.last is None and not fn.captures


def test_cache_keys():
    """One cached callable per config (frame.py:1035-1054): equal configs
    share it, a changed field (a retune, a resize, a flag) makes another;
    the cube and glTF caches do not collide."""
    a = committed_config()
    assert frame.compiled_gltf_frame(a) is frame.compiled_gltf_frame(
        committed_config())
    for other in (dataclasses.replace(a, width=128),
                  dataclasses.replace(a, shadow_pen_capacity=4096),
                  dataclasses.replace(a, flags=dataclasses.replace(
                      a.flags, use_pcss=False))):
        assert frame.compiled_gltf_frame(other) is not \
            frame.compiled_gltf_frame(a)
    c = frame.FrameConfig(width=64, height=64)
    assert frame.compiled_cube_frame(c) is frame.compiled_cube_frame(
        frame.FrameConfig(width=64, height=64))
    assert ("cube", c) in frame._CACHE and ("gltf", a) in frame._CACHE
    s = sdf.SdfConfig(32, 16)
    assert sdf.compiled_sdf_frame(s) is sdf.compiled_sdf_frame(
        sdf.SdfConfig(32, 16))


def test_static_input_copy():
    """GraphFrame's input copy: a tensor is copied into its buffer, the
    buffer itself is left alone, a host number is filled in (each copy and
    fill one device operation, counted for the replay's layout), and a
    shape or dtype that does not match the recorded one raises."""
    buf = torch.zeros(3)
    assert frame._copy_in(buf, torch.tensor([1.0, 2.0, 3.0])) == 1
    assert buf.tolist() == [1.0, 2.0, 3.0]
    assert frame._copy_in(buf, buf) == 0
    assert buf.tolist() == [1.0, 2.0, 3.0]
    t = torch.zeros(())
    assert frame._copy_in(t, 1.5) == 1
    assert float(t) == 1.5
    with pytest.raises(ValueError, match="does not match"):
        frame._copy_in(buf, torch.zeros(4))
    with pytest.raises(ValueError, match="does not match"):
        frame._copy_in(buf, torch.zeros(3, dtype=torch.float64))


def test_kept_constants():
    """Inside kept_constants a host value is uploaded once per value,
    dtype and device and the same tensor is handed out again; outside,
    every call makes a new tensor."""
    store = {}
    with m3.kept_constants(store):
        a = m3.f32([1.0, 2.0], "cpu")
        b = m3.f32([1.0, 2.0], "cpu")
        c = m3.const([1, 2], torch.int32, "cpu")
        d = m3.f32([1.0, 2.5], "cpu")
    assert a is b and a is not d and c.dtype == torch.int32
    assert len(store) == 3
    assert m3.f32([1.0, 2.0], "cpu") is not a


# ---------------------------------------------------------------------------
# The card: graph == eager
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_card_cube_graph_equals_eager(dev):
    cfg = frame.FrameConfig(width=512, height=512)
    scene = build_cube_scene(device=dev)
    fn = frame.compiled_cube_frame(cfg)
    kept = []
    for r in (0.0, 0.3, 0.6):
        p = frame.default_cube_params(r, device=dev)
        got = fn(scene, p)
        kept.append(got)
        assert_bits_equal(got, frame.render_cube_frame(scene, p, cfg))
    g = fn.last
    assert g is not None and g.replays >= 3
    assert g.launches["raster_table"] == 1
    # a returned frame is a copy: later replays leave it alone
    assert_bits_equal(kept[0], frame.render_cube_frame(
        scene, frame.default_cube_params(0.0, device=dev), cfg))


@pytest.mark.cuda
def test_card_committed_gltf_graph_equals_eager(dev):
    """Chained committed frames: rgba and every FrameState field equal the
    eager frames; the state is donated (the returned FrameState is the
    graph's buffers, updated in place) and K1 and K3 are counted at
    capture."""
    scene, params = multimesh(dev)
    cfg = committed_config()
    fn = frame.compiled_gltf_frame(cfg)
    assert fn.uses_graph(dev)
    got = chained(fn, scene, poses(params, 4), cfg, dev)
    want = chained(lambda s, p, st: frame.render_gltf_frame(s, p, st, cfg),
                   scene, poses(params, 4), cfg, dev)
    for (ra, sa), (rb, sb) in zip(got, want):
        assert_bits_equal(ra, rb, "rgba")
        for name, a, b in zip(frame.FrameState._fields, sa, sb):
            assert_bits_equal(a, b, name)
    g = fn.last
    assert g.launches["raster_table"] > 0 and g.launches["row_gather"] > 0
    state = frame.init_frame_state(cfg, dev)
    _, s1 = fn(scene, params, state)
    _, s2 = fn(scene, params, s1)
    assert all(a is b for a, b in zip(s1, s2))     # donated, in place
    assert int(s2.frame_index) == 2


@pytest.mark.cuda
def test_card_graph_layout(dev, monkeypatch, tmp_path):
    """The committed frame's layout (utils/profiling.GraphLayout): its
    top-level spans tile the graph's operations; a profiled replay runs
    before + G + after device operations (the parameter copies, the graph,
    the RGBA clone); a graph recorded without spans has the same nodes; the
    layout is published under the config and outlives the frame cache."""
    import contextlib
    import functools
    import json

    from funky_tpu_torch.utils import profiling

    scene, params = multimesh(dev)
    cfg = committed_config()
    frame._CACHE.clear()
    fn = frame.compiled_gltf_frame(cfg)
    _, state = fn(scene, params, frame.init_frame_state(cfg, dev))
    _, state = fn(scene, params, state)          # the state handed back
    lay = fn.last.layout
    assert profiling.graph_layout(cfg) is lay
    assert (lay.before, lay.after) == (len(frame._PARAM_FIELDS), 1)
    edge = 0
    for name, parent, first, end in lay.spans:
        if parent is None:
            assert first == edge and end >= first, name
            edge = end
    assert edge == lay.ops > 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(scene, params, state)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    evs = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ops = [e for e in evs
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert len(ops) == lay.before + lay.ops + lay.after, lay.node_types
    monkeypatch.setattr(frame, "span", lambda name: contextlib.nullcontext())
    bare = frame._CompiledGltf(functools.partial(frame.render_gltf_frame,
                                                 cfg=cfg), True)
    bare(scene, params, frame.init_frame_state(cfg, dev))
    plain = bare.last.layout
    assert plain.spans == ()
    assert (plain.ops, plain.nodes, plain.node_types) == \
        (lay.ops, lay.nodes, lay.node_types)
    frame._CACHE.clear()
    assert profiling.graph_layout(cfg) is lay


@pytest.mark.cuda
def test_card_conded_config_runs_eagerly(dev):
    scene, params = multimesh(dev)
    cfg = dataclasses.replace(committed_config(), flags=dataclasses.replace(
        committed_config().flags, committed=False))
    fn = frame.compiled_gltf_frame(cfg)
    assert not fn.uses_graph(dev)
    rgba, _ = fn(scene, params, frame.init_frame_state(cfg, dev))
    assert fn.last is None and not fn.captures
    assert bool(torch.isfinite(rgba).all())


@pytest.mark.cuda
def test_card_sdf_graph_equals_eager(dev):
    cfg = sdf.SdfConfig(width=320, height=180)
    cam = sdf.default_sdf_camera(device=dev)
    fn = sdf.compiled_sdf_frame(cfg)
    for t in (1.0, 1.02, torch.tensor(1.5, device=dev)):
        assert_bits_equal(fn(t, *cam), sdf.render_sdf_frame(t, *cam, cfg))
    assert fn.last.replays == 3


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    dict(half_res_shadows=True), dict(shadow_eval_scale=4),
    dict(light_space_ground_shadows=True, skip_backfacing_shadows=True)],
    ids=["half_res", "quarter_res", "lightspace"])
def test_card_perf_mode_graph_equals_eager(dev, flags):
    """The committed config with each perf mode on is recorded as a graph
    (no host read on its path) and its chained frames equal the eager
    frames in rgba and every FrameState field."""
    scene, params = multimesh(dev)
    cfg = dataclasses.replace(committed_config(), flags=dataclasses.replace(
        committed_config().flags, **flags))
    fn = frame.compiled_gltf_frame(cfg)
    assert fn.uses_graph(dev)
    got = chained(fn, scene, poses(params, 3), cfg, dev)
    want = chained(lambda s, p, st: frame.render_gltf_frame(s, p, st, cfg),
                   scene, poses(params, 3), cfg, dev)
    assert fn.last is not None and fn.last.replays == 3
    for (ra, sa), (rb, sb) in zip(got, want):
        assert_bits_equal(ra, rb, "rgba")
        for name, a, b in zip(frame.FrameState._fields, sa, sb):
            assert_bits_equal(a, b, name)


@pytest.mark.cuda
def test_card_sharded_committed_graph(dev, tmp_path):
    """The committed sharded frame on a one-rank NCCL group is recorded as
    one CUDA graph, all-gathers included (3 per frame with synthesized
    maps, issued by the warm-up and the capture, none by a replay), and its
    chained frames equal the eager sharded frames and render_gltf_frame in
    rgba and every FrameState field; K1 and K3 are counted at capture."""
    import datetime

    import torch.distributed as dist

    from funky_tpu_torch.parallel import make_mesh, sharded_gltf_frame
    from tests.torch_sharded_worker import counted_gathers

    scene, params = multimesh(dev)
    cfg = committed_config()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        fn = sharded_gltf_frame(make_mesh(1, device="cuda"), cfg)
        assert fn.uses_graph(dev)
        with counted_gathers() as calls:
            got = chained(fn, scene, poses(params, 4), cfg, dev)
        eager = chained(fn.eager, scene, poses(params, 4), cfg, dev)
    finally:
        dist.destroy_process_group()
    want = chained(lambda s, p, st: frame.render_gltf_frame(s, p, st, cfg),
                   scene, poses(params, 4), cfg, dev)
    for (ra, sa), (rb, sb), (rc, sc) in zip(got, eager, want):
        for name, a, b, c in zip(("rgba",) + frame.FrameState._fields,
                                 (ra,) + tuple(sa), (rb,) + tuple(sb),
                                 (rc,) + tuple(sc)):
            assert_bits_equal(a, b, name)
            assert_bits_equal(a, c, name)
    assert len(calls) == 6 and fn.last.replays == 4
    assert fn.last.launches["raster_table"] > 0
    assert fn.last.launches["row_gather"] > 0
