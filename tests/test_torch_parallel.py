"""Port parity: the row-sharded frame (funky_tpu_torch/parallel) on the
CPU, over gloo across 2 and 4 spawned processes
(tests/torch_sharded_worker.py), at tests/test_parallel.py's size
(256x128, 128^2 maps, 8x128 tiles of capacity 256) on the multimesh scene.

Gates and why:
- sharded == the port's single-device frame, rgba, history and depth bit
  for bit, on every rank: the JAX package's own contract
  (tests/test_parallel.py:34-51, :62-96). Each pixel and texel is computed
  by the same operations on any slab; only the capacity branches see the
  slab, and each of their branches is exact.
- the one-process composition of the stages at n = 4 == the 4-rank gloo
  frame bit for bit, so chip_smoke.py may hold the card's frames to it.
- the committed sharded frame (bench.py's shipped flags, capacities that
  hold): no host branch and no host read, so the card can record it as a
  CUDA graph; == the cond'd sharded frame bit for bit where the window
  fit holds.
- the port's 4-rank frame against JAX's 4-device sharded_gltf_frame on
  the conftest's virtual CPU devices: tests/test_torch_frame.py::
  test_slice_matches_jax's gates, depth within DEPTH_TOL and rgba and
  history within the golden tolerance (3/255 on at most 0.2% of pixels).
  A sharded frame returns no tri_id, so the tolerance covers every pixel,
  the z-fight pixels included (measured: at most 0.03% over 3/255, depth
  within 3.1e-5).
- shade_slab at y0 = 64 of 128 against JAX's on the same inputs (JAX's
  raster, maps and state carried across), for each back half: the golden
  tolerance over every pixel; against rows [64, 128) of the port's own
  full-height call: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec
import pytest
import torch

import bench
import funky_tpu.frame as jf
from funky_tpu.ops.raster import RasterConfig as JRasterConfig
from funky_tpu.ops.raster import raster_corners as jraster_corners
from funky_tpu.ops.sampling import quad_pack as jquad_pack
from funky_tpu.parallel import make_mesh as jmake_mesh
from funky_tpu.parallel import sharded_gltf_frame as jsharded_gltf_frame
from funky_tpu.passes import geometry as jgeometry
from funky_tpu.passes import shadow as jshadow

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import compact
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.parallel import make_mesh, sharded_gltf_frame
from funky_tpu_torch.parallel import sharded_frame as sf

from . import torch_sharded_worker as w
from .test_torch_frame import DEPTH_TOL, GOLDEN_BAD_FRAC, GOLDEN_TOL
from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_scene, port_state, port_uniforms,
                           slice_configs, t2n)

FIELDS = ("rgba", "history", "depth")
GATHERS = {"default": 4, "trio": 3,   # raster path / synthesized maps
           "committed": 3}
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def scene_params():
    return w.multimesh("cpu")


@pytest.fixture(scope="module")
def single(scene_params):
    """The port's single-device frames of every case."""
    scene, params = scene_params
    out = {}
    for name, (flags, n) in w.CASES.items():
        cfg = w.small_config(**flags)
        out[name] = w.run_chain(
            lambda s, p, st, cfg=cfg: tf.render_gltf_frame(s, p, st, cfg),
            scene, w.poses(params, n), cfg, "cpu")
    return out


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """world -> each rank's frames of every case, over gloo."""
    return {world: w.spawn_ranks(world,
                                 tmp_path_factory.mktemp(f"gloo{world}"))
            for world in WORLDS}


def assert_frames_equal(got, want, label):
    assert len(got) == len(want), label
    for i, (a, b) in enumerate(zip(got, want)):
        for f in FIELDS:
            assert torch.equal(a[f], b[f]), (label, i, f)
        assert a["frame_index"] == b["frame_index"] == i + 1, (label, i)


@pytest.mark.parametrize("case", list(w.CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_single_device(gloo, single, world, case):
    for rank, out in enumerate(gloo[world]):
        assert_frames_equal(out[case], single[case], (world, rank, case))


@pytest.mark.parametrize("case", list(w.CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_gathers_per_frame(gloo, world, case):
    """4 gathers per frame on the raster path (cascade slabs, rgba,
    history, depth), 3 with synthesized maps (JAX's <= 3 all-gathers,
    tests/test_parallel.py:87-95)."""
    for out in gloo[world]:
        assert [f["gathers"] for f in out[case]] == (
            [GATHERS[case]] * len(out[case]))


@pytest.mark.parametrize("world", WORLDS)
def test_committed_frame_reads_nothing_on_the_host(gloo, world):
    """The committed sharded frame (bench.py's shipped flags) takes no host
    branch, not even the synthesized maps' window fit, and reads no device
    value on the host (tests/torch_host_reads.py): on the card it can be
    recorded as one CUDA graph. The cond'd frame of the same config
    branches on the host."""
    for out in gloo[world]:
        for f in out["committed"]:
            assert f["syncs"] == 0 and f["reads"] == [], (f["syncs"],
                                                          f["reads"])
        assert all(f["syncs"] > 0 for f in out["committed_conded"])


@pytest.mark.parametrize("world", WORLDS)
def test_committed_equals_conded(gloo, single, world):
    """Where the window fit holds (the cond'd frames took no full-raster
    fallback), the committed sharded frames equal the cond'd sharded
    frames and render_gltf_frame bit for bit, on every rank."""
    for rank, out in enumerate(gloo[world]):
        assert all(f["fallbacks"] == 0 for f in out["committed_conded"])
        assert_frames_equal(out["committed"], out["committed_conded"],
                            (world, rank))
        assert_frames_equal(out["committed"], single["committed"],
                            (world, rank))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_frame(gloo, world):
    first = gloo[world][0]
    for out in gloo[world][1:]:
        for case in w.CASES:
            assert_frames_equal(out[case], first[case], (world, case))
    rgba = first["default"][0]["rgba"]
    assert rgba.shape == (128, 256, 4) and bool(torch.isfinite(rgba).all())


@pytest.mark.parametrize("case", list(w.CASES))
def test_composition_equals_gloo(gloo, scene_params, case):
    """The stages composed for 4 ranks in one process (chip_smoke.py's
    four-slab oracle) == the 4-rank gloo frames."""
    scene, params = scene_params
    flags, n = w.CASES[case]
    cfg = w.small_config(**flags)
    got = w.run_chain(
        lambda s, p, st: w.compose_frame(s, p, st, cfg, 4), scene,
        w.poses(params, n), cfg, "cpu")
    assert all(f["gathers"] == 0 for f in got)
    assert_frames_equal(got, gloo[4][0][case], case)


def jax_small_config():
    tile = JRasterConfig(tile_h=8, tile_w=128, capacity=256, backend="jnp")
    return jf.GltfConfig(width=256, height=128, shadow_map_size=128,
                         raster=tile, shadow_raster=tile)


def assert_within_slice_gates(rgba, history, depth, jrgba, jhistory, jdepth,
                              label):
    if depth is not None:
        np.testing.assert_allclose(depth, jdepth, rtol=0, atol=DEPTH_TOL,
                                   err_msg=str(label))
    for got, want in ((rgba, jrgba), (history, jhistory)):
        diff = np.abs(got - np.asarray(want)).max(-1)
        assert (diff > GOLDEN_TOL).mean() <= GOLDEN_BAD_FRAC, (
            label, (diff > GOLDEN_TOL).mean(), diff.max())


def test_four_ranks_match_jax(gloo):
    """The 4-rank gloo frames against funky_tpu.parallel's 4-device frame
    (3 chained frames of GltfConfig()'s flags), the same inputs carried
    across by tests/torch_parity.py."""
    assert len(jax.devices()) >= 4
    jcfg = jax_small_config()
    mesh = jmake_mesh(4)
    # every input replicated on the mesh, as the frame returns its state,
    # so that one compiled program serves all three frames
    replicated = NamedSharding(mesh, PartitionSpec())

    def put(tree):
        return jax.device_put(tree, replicated)

    scene = put(multimesh_jax_scene())
    params = multimesh_params()
    frame4 = jsharded_gltf_frame(mesh, jcfg)
    state = put(jf.init_frame_state(jcfg))
    poses = [params, bench.orbit_params(params, 1),
             bench.orbit_params(params, 2)]
    ours = gloo[4][0]["default"]
    for i, pose in enumerate(poses):
        jrgba, state = frame4(scene, put(pose), state)
        f = ours[i]
        assert_within_slice_gates(
            t2n(f["rgba"]), t2n(f["history"]), t2n(f["depth"]),
            np.asarray(jrgba), np.asarray(state.shadow_history),
            np.asarray(state.prev_depth), i)


def test_missing_tap_routes_change_nothing(scene_params):
    """JAX's sharded frame passes no tap routes (sharded_frame.py:157-160),
    nor does the port's. With routed windows configured and the sparse
    pair groups in use (1024^2 maps, a pair capacity that holds), the 4-slab
    frame still equals the single-device frame, which routes its taps: the
    routing is exact. (JAX's own sharded and single-device frames differ
    by up to 2.4e-7 on this config with and without routes alike: XLA's
    divergence between programs, not the routes.)"""
    scene, params = scene_params
    cfg = tf.GltfConfig(
        width=256, height=128, shadow_map_size=1024,
        raster=w.small_config().raster,
        shadow_raster=RasterConfig(tile_h=128, tile_w=128),
        shadow_pen_capacity=256 * 128, shadow_route_windows=(256, 256, 0, 0),
        shadow_route_caps=(8192, 8192, 0, 0))
    state = tf.init_frame_state(cfg, "cpu")
    compact.BRANCHES.clear()
    want, wstate = tf.render_gltf_frame(scene, params, state, cfg)
    assert compact.BRANCHES[("shadow_pairs", True)] == 1
    got, gstate = w.compose_frame(scene, params, state, cfg, 4)
    assert torch.equal(got, want)
    assert torch.equal(gstate.shadow_history, wstate.shadow_history)


# shade_slab at a slab offset: the lower half of a 256x128 frame whose
# camera looks 0.05 rad up, so that the half holds sky (rows 64-90) as
# well as the ground and the cubes (rows 91-127): the row slab of 40 rows
# and the valid blocks each take their sparse branch.
Y0 = 64
PITCH = 0.05
BACK_HALVES = {"dense": dict(valid_block_capacity=0),
               "blocks": dict(valid_block_capacity=None),
               "rows": dict(valid_slab_rows=40)}
BRANCH = {"blocks": "valid_blocks", "rows": "valid_slab_rows"}


@pytest.fixture(scope="module")
def slab_ref():
    """The JAX frame's inputs to shade_slab at the pitched pose, after one
    frame at that pose (a real TAA history and previous depth)."""
    jcfg, _ = slice_configs(width=256, height=128, shadow=128, tile_h=8)
    scene = multimesh_jax_scene()
    params = dataclasses.replace(multimesh_params(),
                                 camera_pitch=jnp.float32(PITCH))
    state = jf.init_frame_state(jcfg)
    _, state = jf.compiled_gltf_frame(jcfg)(scene, params, state)

    @jax.jit
    def inputs(scene, p, st):
        uni = jf.compute_frame_uniforms(p, st, jcfg)
        world, clip, nrm = jgeometry.transform_vertices(
            scene, uni.models, uni.view_proj)
        blocks = jgeometry.build_shade_blocks(scene, world, clip, nrm)
        raw = jshadow.render_shadow_maps(
            world, scene.tri_indices, scene.num_triangles,
            uni.light_view_proj, jcfg.shadow_raster, jcfg.shadow_map_size)
        tri_clip, blocks_m, flags_m, valid = jf._main_raster_inputs(
            scene, clip, blocks, jcfg.clip_capacity)
        tri_id, depth, setup = jraster_corners(
            tri_clip, valid, jcfg.width, jcfg.height, jcfg.raster)
        return dict(uni=uni, maps=jax.vmap(jquad_pack)(raw), tri_id=tri_id,
                    depth=depth, setup=setup.data, blocks=blocks_m,
                    tri_flags=flags_m)

    return jcfg, scene, state, inputs(scene, params, state)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("half", list(BACK_HALVES))
def test_shade_slab_at_offset(slab_ref, half):
    jcfg, scene, state, ref = slab_ref
    jcfg = dataclasses.replace(jcfg, **BACK_HALVES[half])
    _, tcfg = slice_configs(width=256, height=128, shadow=128, tile_h=8)
    tcfg = dataclasses.replace(tcfg, **BACK_HALVES[half])

    def jslab(scene, uni, st, maps, tri_id, depth, setup, blocks, flags):
        return jf.shade_slab(scene, uni, st, maps, tri_id, depth, setup,
                             blocks, jcfg, Y0, tri_flags=flags)

    jrgba, jhist = jax.jit(jslab)(
        scene, ref["uni"], state, ref["maps"], ref["tri_id"][Y0:],
        ref["depth"][Y0:], ref["setup"], ref["blocks"], ref["tri_flags"])

    args = (port_scene(scene), port_uniforms(ref["uni"]), port_state(state),
            T(ref["maps"]))
    rest = (T(ref["setup"]), T(ref["blocks"]), tcfg)
    tri_id, depth = T(ref["tri_id"]), T(ref["depth"])
    compact.BRANCHES.clear()
    rgba, hist = tf.shade_slab(*args, tri_id[Y0:], depth[Y0:], *rest, Y0,
                               tri_flags=T(ref["tri_flags"]))
    if half in BRANCH:
        assert compact.BRANCHES == {(BRANCH[half], True): 1}
    assert rgba.shape == (128 - Y0, 256, 4)
    assert_within_slice_gates(t2n(rgba), t2n(hist), None, np.asarray(jrgba),
                              np.asarray(jhist), None, half)

    full_rgba, full_hist = tf.shade_slab(*args, tri_id, depth, *rest, 0,
                                         tri_flags=T(ref["tri_flags"]))
    assert torch.equal(rgba, full_rgba[Y0:])
    assert torch.equal(hist, full_hist[Y0:])


@pytest.mark.parametrize("what", ["height", "shadow"])
def test_misaligned_slabs_raise(what):
    """The two ValueErrors of sharded_frame.py:47-54: 128 rows do not split
    into 3 slabs, and 16-row slabs are not whole 32-row tiles."""
    cfg = w.small_config()
    if what == "height":
        bad, match = (cfg, 3), "height 128 must split into 3"
    else:
        tile = dataclasses.replace(cfg.shadow_raster, tile_h=32)
        bad, match = (dataclasses.replace(cfg, shadow_raster=tile), 8), \
            "shadow map size"
    with pytest.raises(ValueError, match=match):
        sf.slab_rows(*bad)


def test_one_rank_group(tmp_path, scene_params):
    """A one-rank gloo group in this process: make_mesh spans the world
    (and refuses another size), the frame equals the single-device frame,
    and a config whose rows are not whole tiles raises."""
    import torch.distributed as dist

    scene, params = scene_params
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("rows",)
        with pytest.raises(ValueError, match="whole world"):
            make_mesh(2, device="cpu")
        cfg = w.small_config()
        got = w.run_chain(sharded_gltf_frame(mesh, cfg), scene, [params],
                          cfg, "cpu")
        want = w.run_chain(
            lambda s, p, st: tf.render_gltf_frame(s, p, st, cfg), scene,
            [params], cfg, "cpu")
        assert got[0]["gathers"] == 4
        assert_frames_equal(got, want, "one rank")
        with pytest.raises(ValueError, match="height 132"):
            sharded_gltf_frame(mesh, dataclasses.replace(cfg, height=132))
    finally:
        dist.destroy_process_group()


def test_make_mesh_cuda_needs_a_card(monkeypatch):
    """A "cuda" mesh never carries on without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(device="cuda")


@pytest.mark.parametrize("stacked", [False, True])
def test_apply_rows_sums_in_order(stacked):
    """math3d.apply_rows, the per-pixel product of the back half: the K
    products summed in order k = 0, 1, ... in f32 (bit for bit against
    numpy doing the same), within 1e-6 of the matmul, and a slab's rows
    computed alone equal the same rows of the whole."""
    from funky_tpu_torch.math3d import apply_rows

    rng = np.random.default_rng(11)
    x = rng.normal(size=(37, 5, 4)).astype(np.float32)
    m = rng.normal(size=((2,) if stacked else ()) + (3, 4)).astype(np.float32)
    got = t2n(apply_rows(T(x), T(m)))
    mk = m.reshape(m.shape[:-2] + (1, 1) + m.shape[-2:])
    want = x[..., 0:1] * mk[..., 0]
    for k in range(1, 4):
        want = want + x[..., k:k + 1] * mk[..., k]
    np.testing.assert_array_equal(got, want)
    spec = "cij,...j->c...i" if stacked else "ij,...j->...i"
    np.testing.assert_allclose(got, np.einsum(spec, m, x), rtol=1e-6,
                               atol=1e-6)
    part = t2n(apply_rows(T(x[9:20]), T(m)))
    np.testing.assert_array_equal(part, got[:, 9:20] if stacked
                                  else got[9:20])
