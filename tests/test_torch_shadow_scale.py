"""Port parity: the perf-mode frame flags, the reduced-rate shadow
evaluation (`shadow_eval_scale` 2 and 4, `half_res_shadows`) and the
back-face skip (`skip_backfacing_shadows`), with `ops/sampling.py::
resize_linear`, the upsample they run through, against funky_tpu's.

Whole frames run on the multimesh scene at 480x272 with 1024^2 maps (at
256^2 the classification closes nothing), GltfConfig()'s defaults
otherwise, 2 chained frames (parked, orbit pose 1), under the slice gates
of tests/test_torch_frame.py::test_slice_matches_jax: depth within 4e-5,
tri_id flips on at most 0.5% of pixels, rgba and history within 3/255 on
all but 0.2% of the pixels whose triangle agrees.

Tolerances and why:
- resize_linear against jitted jax.image.resize: 4e-6 (measured 3.5e-6 at
  the shapes that are not multiples of the scale): XLA contracts the
  sample positions into FMAs and moves a weight by a few ulps. Against
  JAX run op by op: 1.2e-7 (one ulp of the largest value) on at most 0.2%
  of the pixels, from the order of the two products each output sums.
- the row slab against the full-height dense path, both in the port, on
  covered rows: 1e-5, JAX's own tolerance for the same test
  (tests/test_rowslab_backhalf.py): the upsample's two products may
  round in another order at another matrix size.
- occupancy counts: equal but for counts a float compare can flip (1% +
  4) and the contact certificate's counts, which jitted JAX contracts
  (tests/test_torch_shipped.py, FLIP_COUNTS and JIT_CONTACT_COUNTS).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import funky_tpu.frame as jf
from funky_tpu.ops.raster import RasterConfig as JRC
from funky_tpu.utils import autotune as ja
from funky_tpu.utils import diagnostics as jd

import funky_tpu_torch.frame as tf
from funky_tpu_torch import convert
from funky_tpu_torch.ops import compact as tcompact
from funky_tpu_torch.ops import sampling
from funky_tpu_torch.passes import shadow_filter as tsf
from funky_tpu_torch.utils import autotune as ta
from funky_tpu_torch.utils import diagnostics as td

from .test_torch_frame import (DEPTH_TOL, GOLDEN_BAD_FRAC, GOLDEN_TOL,
                               MAX_ZFIGHT_FRAC, _jax_main_raster)
from .test_torch_shipped import FLIP_COUNTS, JIT_CONTACT_COUNTS, run_port
from .torch_parity import (faceted_gltf, faceted_jax_scene,
                           multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, t2n)

W, H, S = 480, 272, 1024
SLAB_TOL = 1e-5


def jax_config(**flags):
    """GltfConfig() at the test size with the jnp raster and `flags`."""
    return jf.GltfConfig(
        width=W, height=H, shadow_map_size=S,
        raster=JRC(tile_h=32, tile_w=128, backend="jnp"),
        shadow_raster=JRC(tile_h=128, tile_w=256, backend="jnp"),
        flags=jf.GltfFrameFlags(**flags))


def roomy(jcfg):
    """jcfg with pair and contact capacities that hold every entry: the
    default pair capacity (n // 16) overflows on this scene, and the dense
    fallback it takes has no back-face skip and no light-map fetch."""
    return dataclasses.replace(jcfg, shadow_pen_capacity=2 * W * H,
                               contact_capacity=W * H,
                               contact_march_capacity=W * H)


def port_config(jcfg):
    return convert.config_from_jax_fields(dataclasses.asdict(jcfg))


def frame_poses(faceted=False):
    params = (jf.default_gltf_params(
        gltf_min_y=float(faceted_gltf().bounds_min[1]), gltf_scale=1.0)
        if faceted else multimesh_params())
    return [params, bench.orbit_params(params, 1)]


def assert_frames_match_jax(jcfg, monkeypatch, faceted=False):
    """Two chained frames of jcfg through JAX and the port under the slice
    gates, on the multimesh scene or its faceted twin (cubes with face
    normals, tests/torch_scenes.py::build_faceted_glb). Returns the shapes
    of the domains the port's sparse shadow filter ran on."""
    scene = faceted_jax_scene() if faceted else multimesh_jax_scene()
    tscene = port_scene(scene)
    cfg = port_config(jcfg)
    frame = jf.compiled_gltf_frame(jcfg)
    main = _jax_main_raster(jcfg)
    jstate = jf.init_frame_state(jcfg)
    tstate = tf.init_frame_state(cfg, "cpu")
    shapes = []
    sparse = tsf.cascaded_shadow_sparse

    def spy(uni, maps, cmaps, world, *args, **kwargs):
        shapes.append(tuple(world.shape[:-1]))
        return sparse(uni, maps, cmaps, world, *args, **kwargs)

    monkeypatch.setattr(tsf, "cascaded_shadow_sparse", spy)
    for i, pose in enumerate(frame_poses(faceted)):
        jid = np.asarray(main(scene, pose, jstate)[0])
        jrgba, jstate = frame(scene, pose, jstate)
        rgba, tstate, tid = tf.render_gltf_frame_ids(
            tscene, port_params(pose), tstate, cfg)
        np.testing.assert_allclose(t2n(tstate.prev_depth),
                                   np.asarray(jstate.prev_depth), rtol=0,
                                   atol=DEPTH_TOL)
        same = t2n(tid) == jid
        assert (~same).mean() <= MAX_ZFIGHT_FRAC, (i, (~same).sum())
        for got, want in ((t2n(rgba), np.asarray(jrgba)),
                          (t2n(tstate.shadow_history),
                           np.asarray(jstate.shadow_history))):
            diff = np.abs(got - want).max(-1)[same]
            assert (diff > GOLDEN_TOL).mean() <= GOLDEN_BAD_FRAC, (
                i, (diff > GOLDEN_TOL).mean(), diff.max())
        hist = t2n(tstate.shadow_history)
        assert (hist[..., 0] < 1.0).mean() > 0.004      # shadow in view
    return shapes


# ---------------------------------------------------------------------------
# resize_linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h, w, scale", [(136, 192, 2), (135, 193, 2),
                                         (135, 190, 4)])
def test_resize_linear_matches_jax(h, w, scale):
    """A numpy-seeded image subsampled by `scale` and enlarged back:
    resize_linear against jax.image.resize(..., "linear"), jitted (as the
    frame runs it) and op by op."""
    rng = np.random.default_rng(h * w + scale)
    sub = np.ascontiguousarray(
        rng.random((h, w), dtype=np.float32)[::scale, ::scale])
    got = t2n(sampling.resize_linear(torch.from_numpy(sub), h, w))
    jitted = np.asarray(jax.image.resize(jnp.asarray(sub), (h, w), "linear"))
    with jax.disable_jit():
        eager = np.asarray(jax.image.resize(jnp.asarray(sub), (h, w),
                                            "linear"))
    assert got.shape == (h, w)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=4e-6)
    diff = np.abs(got - eager)
    assert diff.max() <= 1.2e-7 and (diff > 0).mean() <= 2e-3, (
        diff.max(), (diff > 0).mean())
    # the edge rows and columns keep their nearest samples' values
    np.testing.assert_array_equal(got[0, 0], sub[0, 0])


def test_resize_linear_weights_are_kept_per_shape():
    """The weight matrices are built and uploaded once per shape: a second
    call reads the same tensors."""
    a = torch.rand((34, 48))
    sampling.resize_linear(a, 68, 96)
    kept = dict(sampling._WEIGHTS)
    sampling.resize_linear(a * 2.0, 68, 96)
    assert {k: id(v) for k, v in sampling._WEIGHTS.items()} == {
        k: id(v) for k, v in kept.items()}
    assert (48, 96, "cpu") in kept and (34, 68, "cpu") in kept


# ---------------------------------------------------------------------------
# Whole frames against JAX
# ---------------------------------------------------------------------------

SCALE_FLAGS = {
    "half_res": (dict(half_res_shadows=True), 2),
    "quarter_res": (dict(shadow_eval_scale=4), 4),
}


@pytest.mark.parametrize("name", sorted(SCALE_FLAGS))
def test_reduced_rate_frames_match_jax(name, monkeypatch):
    """half_res_shadows and shadow_eval_scale=4: the port's frames meet
    the slice gates against JAX's, and its sparse filter ran on the
    subsampled grid only."""
    flags, scale = SCALE_FLAGS[name]
    shapes = assert_frames_match_jax(jax_config(**flags), monkeypatch)
    want = (-(-H // scale), -(-W // scale))
    assert shapes and set(shapes) == {want}, shapes


def test_skip_backfacing_frames_match_jax(monkeypatch):
    """skip_backfacing_shadows on the faceted scene, whose back-facing
    pixels it skips: the port's frames meet the slice gates against JAX's
    (the filter runs on the valid-block back half's flat domain at full
    rate)."""
    tcompact.reset_host_syncs()
    shapes = assert_frames_match_jax(
        roomy(jax_config(skip_backfacing_shadows=True)), monkeypatch,
        faceted=True)
    assert tcompact.BRANCHES[("shadow_pairs", False)] == 0
    assert shapes and all(len(s) == 1 for s in shapes), shapes


def test_graft_trio_frames_match_jax(monkeypatch):
    """__graft_entry__'s perf-mode flags together
    (light_space_ground_shadows, skip_backfacing_shadows,
    synth_shadow_maps) on the faceted scene, with small light windows and
    two PCF rungs: at JAX's six rungs XLA takes ~30 s to compile each
    cascade's unrolled taps. The light maps are built for every window,
    and the synthesized maps hold their window-fit certificate."""
    from funky_tpu_torch.passes import shadow_lightspace as tlsm

    jcfg = dataclasses.replace(
        roomy(jax_config(light_space_ground_shadows=True,
                         skip_backfacing_shadows=True,
                         synth_shadow_maps=True)),
        light_window_sizes=(256, 256, 128, 128), light_pcf_rungs=2)
    built, fetched = [], []
    build = tlsm.build_light_shadow_map
    monkeypatch.setattr(tlsm, "build_light_shadow_map",
                        lambda *a, **k: built.append(a[5]) or build(*a, **k))
    fetchable = tsf._fetchable

    def count(*args):
        mask = fetchable(*args)
        fetched.append(int(mask.sum()))
        return mask

    monkeypatch.setattr(tsf, "_fetchable", count)
    tcompact.reset_host_syncs()
    assert_frames_match_jax(jcfg, monkeypatch, faceted=True)
    assert built == [256, 256, 128, 128] * 2
    assert tcompact.BRANCHES[("synth_window_fit", True)] == 2
    assert tcompact.BRANCHES[("shadow_pairs", False)] == 0
    assert sum(fetched) > 1000, fetched


# ---------------------------------------------------------------------------
# Port invariants (mirroring JAX's own tests)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_inputs():
    return (port_scene(multimesh_jax_scene()),
            [port_params(p) for p in frame_poses()])


@pytest.fixture(scope="module")
def faceted_inputs():
    return (port_scene(faceted_jax_scene()),
            [port_params(p) for p in frame_poses(faceted=True)])


@pytest.mark.parametrize("scale", [2, 4])
def test_rowslab_routes_shadow_eval_scale(port_inputs, scale):
    """The row slab at shadow_eval_scale 2 and 4 equals the full-height
    dense path on the covered rows (tests/test_rowslab_backhalf.py:77-85),
    rgba and history of two chained frames; the slab path was taken."""
    scene, poses = port_inputs
    base = dataclasses.replace(
        port_config(jax_config(shadow_eval_scale=scale)),
        valid_block_capacity=0)
    slab = dataclasses.replace(base, valid_slab_rows=200)
    dense = run_port(scene, base, poses)
    rows = run_port(scene, slab, poses)
    # run_port counts each frame's branches anew: the last took the slab
    assert tcompact.BRANCHES[("valid_slab_rows", True)] == 1
    for (rd, _, hd, tri, *_), (rs, _, hs, *_) in zip(dense, rows):
        covered = (tri >= 0).any(axis=1)
        np.testing.assert_allclose(rs[covered], rd[covered], rtol=0,
                                   atol=SLAB_TOL)
        np.testing.assert_allclose(hs[covered], hd[covered], rtol=0,
                                   atol=SLAB_TOL)


def test_skip_backfacing_changes_only_backfacing_history(faceted_inputs):
    """With skip_backfacing_shadows the first frame's rgba equals the
    frame without it bit for bit (a back-facing pixel's shadow multiplies
    max(n_dot_l, 0) = 0), and the history differs only where n_dot_l <= 0
    (the skipped pixels carry the lit placeholder), on the faceted scene."""
    scene, poses = faceted_inputs
    cfg = port_config(roomy(jax_config()))
    skip = dataclasses.replace(cfg, flags=dataclasses.replace(
        cfg.flags, skip_backfacing_shadows=True))
    (rgba, depth, hist, tri, *_), = run_port(scene, cfg, poses[:1])
    (rgba_s, _, hist_s, *_), = run_port(scene, skip, poses[:1])
    np.testing.assert_array_equal(rgba_s, rgba)
    state = tf.init_frame_state(cfg, "cpu")
    _, _, g, normal, n_dot_l, *_ = td._frame_intermediates(scene, poses[0],
                                                           state, cfg)
    back = t2n(g.valid & (n_dot_l <= 0.0))
    differs = (hist_s != hist).any(-1)
    assert differs.any() and not (differs & ~back).any()


@pytest.mark.parametrize("name", ["half_res", "quarter_res", "lightspace"])
def test_committed_frames_read_nothing_on_the_host(port_inputs, name):
    """Committed half-res, quarter-res and light-space frames take no host
    branch and read no tensor's value on the host (test_torch_shipped.py::
    HostReads): the card can record each as a CUDA graph."""
    scene, poses = port_inputs
    flags = {"half_res": dict(half_res_shadows=True),
             "quarter_res": dict(shadow_eval_scale=4),
             "lightspace": dict(light_space_ground_shadows=True,
                                skip_backfacing_shadows=True,
                                synth_shadow_maps=True)}[name]
    cfg = dataclasses.replace(
        port_config(jax_config(committed=True, **flags)),
        light_window_sizes=(256, 256, 128, 128), light_pcf_rungs=2,
        valid_slab_rows=200)
    for *_, syncs, reads in run_port(scene, cfg, poses, guard=True):
        assert syncs == 0 and reads == [], (syncs, reads)


# ---------------------------------------------------------------------------
# Autotune
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def half_res_occupancy(port_inputs):
    """The port's occupancy of a half-res GltfConfig() frame after one
    parked frame, and JAX's on the same pose and state."""
    scene, poses = port_inputs
    jcfg = jax_config(half_res_shadows=True)
    cfg = port_config(jcfg)
    state = tf.init_frame_state(cfg, "cpu")
    _, state = tf.render_gltf_frame(scene, poses[0], state, cfg)
    got = {k: np.asarray(t2n(v)).tolist()
           for k, v in td.sparse_occupancy(scene, poses[1], state,
                                           cfg).items()}
    jstate = jf.FrameState(*(jnp.asarray(t2n(x)) for x in state))
    occ = jax.jit(jd.sparse_occupancy, static_argnums=(3,))
    want = {k: np.asarray(v).tolist() for k, v in occ(
        multimesh_jax_scene(), frame_poses()[1], jstate, jcfg).items()}
    return got, want


def test_sparse_occupancy_at_scale_2_matches_jax(half_res_occupancy):
    """sparse_occupancy of a half-res frame counts on the subsampled grid
    as JAX's does: every count equal, or within 1% (+ 4) for the counts a
    float compare can flip; the contact stage counts aside (jitted JAX
    contracts their certificate)."""
    got, want = half_res_occupancy
    assert set(want) <= set(got)
    for key, w in want.items():
        if key in JIT_CONTACT_COUNTS:
            continue
        g = got[key]
        if key not in FLIP_COUNTS:
            assert g == w or np.allclose(g, w, rtol=1e-6), (key, g, w)
            continue
        for a, b in zip(np.atleast_1d(g), np.atleast_1d(w)):
            assert abs(a - b) <= 0.01 * abs(b) + 4, (key, g, w)
    # the counts are the subsampled grid's: a quarter of the pixels
    assert got["pixels"] <= (H // 2 + 1) * (W // 2 + 1)
    assert got["pairs"] > 0 and got["contact_march"] > 0


def test_derive_with_light_maps_matches_jax(half_res_occupancy):
    """Given one occupancy dict (a half-res frame's, with light-map fetch
    counts), derive_sparse_config of a light-space config equals JAX's in
    every field but the footprint windows: the port's fetch fold applies
    only without light maps, and a window with under 128 fetches is kept
    with a fetch cap of its own (the synthesized maps raster their
    occluders in it), where JAX drops it and returns its fetches to the
    cascade's tap cap."""
    occ = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in half_res_occupancy[0].items()}
    occ["light_window_sizes"] = (512, 512, 256, 0)
    occ["light_fetch_per_cascade"] = (20000, 9000, 100, 0)
    jcfg = jax_config(light_space_ground_shadows=True,
                      synth_shadow_maps=True, committed=True)
    want = port_config(ja.derive_sparse_config(jcfg, occ))
    got = ta.derive_sparse_config(port_config(jcfg), occ)
    assert want.light_window_sizes == (512, 512, 0, 0)
    assert want.light_fetch_caps == (25600, 11264, 0, 0)
    assert got.light_window_sizes == (512, 512, 256, 0)
    assert got.light_fetch_caps == (25600, 11264, 1024, 0)
    # JAX's cascade 2 taps its 100 fetches; the port's light map serves
    # them
    pairs2 = occ["pairs_per_cascade"][2] + occ["pairs_lit_per_cascade"][2] \
        + occ["pairs_route_per_cascade"][2]
    assert got.shadow_pen_cascade_caps[2] == ta._round_up(
        max(pairs2 * 1.15, 1024), 1024)
    assert want.shadow_pen_cascade_caps[2] == ta._round_up(
        max((pairs2 + 100) * 1.15, 1024), 1024)
    assert dataclasses.replace(
        got, light_window_sizes=want.light_window_sizes,
        light_fetch_caps=want.light_fetch_caps,
        shadow_pen_cascade_caps=want.shadow_pen_cascade_caps) == want
