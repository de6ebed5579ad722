"""Port parity: the configuration bench.py ships, committed mode with
synthesized cascade maps and the autotuned capacities
(GltfConfig(flags=GltfFrameFlags(committed=True, synth_shadow_maps=True))
through utils/autotune.py), against funky_tpu's.

The multimesh scene at 480x272 with 1024^2 maps, tuned over the parked
view and orbit pose 2: at this size the tuned config turns on the row
slab, the tap window of cascade 2, the two-level compactions, block
textures and the synthesized maps' occluder windows (three of them). The
classification certifies almost no pixel here (lit0 = 1, umbra0 = 2), so
nearly every covered pixel runs the exact taps: the knobs that only a
larger frame turns on are held against JAX directly, on the frame's own
inputs (the last section).

Tolerances and why:
- window origins, the synth window-fit certificate, raster capacities,
  occupancy counts and the derived config: equal, but for the counts a
  float compare can flip and the contact certificate's counts (see
  FLIP_COUNTS and JIT_CONTACT_COUNTS); the occupancy on the dense back
  half, whose domain is JAX's poll's, and as tuned, on the row slab, but
  for the slab's band budget. Given JAX's occupancy, the port's
  derived config differs in three fields, fixes of a synth-only frame
  (utils/autotune.py, ROADMAP's deliberate divergences):
  shadow_pen_cascade_caps, by the fetch fold, and light_window_sizes with
  light_fetch_caps, which keep every measured window.
- the synthesized maps within 1e-5 of JAX's (measured max 6.0e-8): XLA
  contracts the window raster's plane evaluation into FMAs, and
  jnp.linalg.inv and torch's inverse of the 2x2 uv fit may round apart.
- whole frames: the gates of tests/test_torch_frame.py::
  test_slice_matches_jax (depth 4e-5, tri_id except z-fight pixels, rgba
  and history within 3/255 on all but 0.2% of the agreeing pixels).
- port committed == port cond'd: bit for bit. Eager torch runs the same
  ops either way while no capacity overflows, and the one budget that
  overflows here (the band blocks, as in JAX) is conservative in
  committed mode: a dropped block's pixels become pairs whose exact taps
  give the closed forms' values.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import funky_tpu.frame as jf
from funky_tpu.ops.raster import RasterConfig as JRC
from funky_tpu.passes import contact as jcontact
from funky_tpu.passes import geometry as jgeometry
from funky_tpu.passes import shadow as jshadow
from funky_tpu.passes import shadow_classify as jcls
from funky_tpu.passes import shadow_filter as jsf
from funky_tpu.passes import shadow_lightspace as jlsm
from funky_tpu.passes import taa as jtaa
from funky_tpu.passes.uniforms import FrameUniforms as JUniforms
from funky_tpu.utils import autotune as ja
from funky_tpu.utils import diagnostics as jd

import funky_tpu_torch.frame as tf
from funky_tpu_torch import convert
from funky_tpu_torch.ops import compact as tcompact
from funky_tpu_torch.ops.sampling import quad_pack
from funky_tpu_torch.passes.deferred import pixel_centers
from funky_tpu_torch.passes import contact as tcontact
from funky_tpu_torch.passes import geometry as tgeometry
from funky_tpu_torch.passes import shadow as tshadow
from funky_tpu_torch.passes import shadow_filter as tsf
from funky_tpu_torch.passes import shadow_lightspace as tlsm
from funky_tpu_torch.passes import taa as ttaa
from funky_tpu_torch.utils import autotune as ta
from funky_tpu_torch.utils import diagnostics as td

from .test_torch_frame import (DEPTH_TOL, GOLDEN_BAD_FRAC, GOLDEN_TOL,
                               MAX_ZFIGHT_FRAC, _jax_main_raster)
from .torch_host_reads import host_reads
from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, port_uniforms, t2n)

W, H, S = 480, 272, 1024
SYNTH_TOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def jax_base_config():
    """bench.py's configuration at the test size, the jnp raster."""
    return jf.GltfConfig(
        width=W, height=H, shadow_map_size=S,
        raster=JRC(tile_h=32, tile_w=128, backend="jnp"),
        shadow_raster=JRC(tile_h=128, tile_w=256, backend="jnp"),
        flags=jf.GltfFrameFlags(committed=True, synth_shadow_maps=True))


def port_config(jcfg):
    return convert.config_from_jax_fields(dataclasses.asdict(jcfg))


def tune_poses(params):
    return [params, bench.orbit_params(params, 2)]


def frame_poses(params):
    return [params, bench.orbit_params(params, 1),
            bench.orbit_params(params, 2)]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's autotune over the tuning poses, and three chained frames of
    the tuned config with each frame's main-pass tri_id."""
    scene = multimesh_jax_scene()
    params = multimesh_params()
    base = jax_base_config()
    raster_cfg = ja.tune_raster_capacities(scene, tune_poses(params), base)
    occ = jd.measure_sparse_occupancy(scene, tune_poses(params), raster_cfg)
    cfg = ja.derive_sparse_config(raster_cfg, occ)
    frame = jf.compiled_gltf_frame(cfg)
    main = _jax_main_raster(cfg)
    state = jf.init_frame_state(cfg)
    frames = []
    for pose in frame_poses(params):
        tri_id = np.asarray(main(scene, pose, state)[0])
        rgba, state = frame(scene, pose, state)
        frames.append((np.asarray(rgba), np.asarray(state.prev_depth),
                       np.asarray(state.shadow_history), tri_id))
    return dict(scene=scene, params=params, base=base, raster_cfg=raster_cfg,
                occ=occ, cfg=cfg, frames=frames)


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's autotune from the same base config and poses."""
    scene = port_scene(jax_run["scene"])
    poses = [port_params(p) for p in tune_poses(jax_run["params"])]
    raster_cfg = ta.tune_raster_capacities(scene, poses,
                                           port_config(jax_run["base"]))
    cfg, occ = ta.tune_sparse_capacities(scene, poses, raster_cfg)
    return dict(scene=scene, raster_cfg=raster_cfg, occ=occ, cfg=cfg)


def run_port(scene, cfg, poses, guard=False):
    """Chained port frames: (rgba, depth, history, tri_id, host syncs,
    host reads: the value reads HostReads saw in the frame, with
    `guard`)."""
    state = tf.init_frame_state(cfg, "cpu")
    out = []
    for pose in poses:
        tcompact.reset_host_syncs()
        p = port_params(pose)
        with host_reads() if guard else contextlib.nullcontext() as reads:
            rgba, state, tri_id = tf.render_gltf_frame_ids(scene, p, state,
                                                           cfg)
        out.append((t2n(rgba), t2n(state.prev_depth),
                    t2n(state.shadow_history), t2n(tri_id),
                    tcompact.HOST_SYNCS, reads.reads if guard else []))
    return out


def assert_frames_equal(a, b):
    for fa, fb in zip(a, b):
        for x, y in zip(fa[:4], fb[:4]):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Footprint windows and synthesized maps
# ---------------------------------------------------------------------------

def _jax_front(scene, pose, cfg):
    """JAX uniforms and world vertices of a pose's first frame."""
    uni = jf.compute_frame_uniforms(pose, jf.init_frame_state(cfg), cfg)
    world_v, _, _ = jgeometry.transform_vertices(scene, uni.models,
                                                 uni.view_proj)
    return uni, world_v


@pytest.fixture(scope="module")
def synth_inputs(jax_run):
    """JAX's plan, certificate and synthesized maps at orbit pose 2 for
    the tuned window sizes, and the port's inputs."""
    cfg = jax_run["cfg"]
    scene = jax_run["scene"]
    pose = tune_poses(jax_run["params"])[1]
    uni, world_v = _jax_front(scene, pose, cfg)
    sizes = cfg.effective_light_windows()

    @jax.jit
    def run(uni, world_v):
        origins, _ = jlsm.plan_windows(uni, world_v, scene.vert_object,
                                       sizes, S, cfg.max_softness,
                                       cfg.class_coarse)
        maps, ok = jshadow.synthesize_shadow_maps(scene, world_v, uni, S,
                                                  sizes, origins)
        fit = jshadow.synth_windows_fit(world_v, scene.vert_object,
                                        uni.light_view_proj, S, sizes,
                                        origins)
        return origins, maps, ok, fit

    origins, maps, ok, fit = run(uni, world_v)
    tuni = port_uniforms(uni)
    tscene = port_scene(scene)
    tworld = tgeometry.transform_vertices(tscene, tuni.models,
                                          tuni.view_proj)[0]
    return dict(sizes=sizes, origins=origins, maps=np.asarray(maps),
                ok=bool(ok), fit=bool(fit), uni=tuni, scene=tscene,
                world=T(world_v), port_world=tworld)


def test_plan_windows_and_fit_match_jax(synth_inputs):
    """Window origins and the window-fit certificate equal JAX's, for the
    tuned sizes (the certificate holds) and for 16-texel windows (it
    fails)."""
    d = synth_inputs
    origins, _ = tlsm.plan_windows(d["uni"], d["world"],
                                   d["scene"].vert_object, d["sizes"], S,
                                   4.0, 16)
    for o, jo in zip(origins, d["origins"]):
        if jo is None:
            assert o is None
        else:
            assert (int(o[0]), int(o[1])) == (int(jo[0]), int(jo[1]))
    fit = tshadow.synth_windows_fit(d["world"], d["scene"].vert_object,
                                    d["uni"].light_view_proj, S, d["sizes"],
                                    origins)
    assert bool(fit) == d["fit"] is True
    tiny = (16, 16, 16, 16)
    torigins, _ = tlsm.plan_windows(d["uni"], d["world"],
                                    d["scene"].vert_object, tiny, S, 4.0, 16)
    assert not bool(tshadow.synth_windows_fit(
        d["world"], d["scene"].vert_object, d["uni"].light_view_proj, S,
        tiny, torigins))


def test_synthesize_shadow_maps_match_jax(synth_inputs):
    """The synthesized maps within SYNTH_TOL of JAX's on the same inputs,
    with the same certificate; and within SYNTH_TOL of the port's full
    raster wherever the window raster or the ground covers a texel (the
    documented ~1-ulp deviation)."""
    d = synth_inputs
    origins, _ = tlsm.plan_windows(d["uni"], d["world"],
                                   d["scene"].vert_object, d["sizes"], S,
                                   4.0, 16)
    maps, ok = tshadow.synthesize_shadow_maps(
        d["scene"], d["world"], d["uni"], S, d["sizes"], origins)
    assert bool(ok) == d["ok"] is True
    np.testing.assert_allclose(t2n(maps), d["maps"], rtol=0, atol=SYNTH_TOL)
    full = tshadow.render_shadow_maps(
        d["port_world"], d["scene"].tri_indices, d["scene"].num_triangles,
        d["uni"].light_view_proj, tf.GltfConfig().shadow_raster, S)
    near = np.abs(t2n(maps) - t2n(full)) <= SYNTH_TOL
    assert near.mean() > 0.999
    assert (t2n(maps) < 1.0).mean() > 0.05       # the ground is there


# ---------------------------------------------------------------------------
# Autotune: occupancy and the derived config
# ---------------------------------------------------------------------------

def test_raster_capacities_match_jax(jax_run, port_run):
    assert port_run["raster_cfg"] == port_config(jax_run["raster_cfg"])
    assert port_run["raster_cfg"].raster.capacity is not None


# Counts a float compare can flip between XLA and torch: classification
# and certificates compare receivers with stored depths that agree to a
# few ulps, so a handful of pixels may land the other way (measured: the
# light-map fetch split by 2 of 8,501).
FLIP_COUNTS = ("taa_need", "pairs", "pairs_per_cascade", "pair_blocks",
               "light_fetch_per_cascade", "pairs_route_per_cascade",
               "umbra0", "lit0", "blend_band")
# The contact certificate's stage counts: jitted JAX contracts the ground
# plane's evaluation in the depth raster and in the residual R = depth -
# plane differently, finds ground texels with R < -eps and grows its
# occluder box, so more rays reach stage 2 (measured 52,511 against the
# port's 12,879 on this frame). The port equals JAX run op by op
# (test_contact_occupancy_matches_unjitted_jax); the march extent agrees.
JIT_CONTACT_COUNTS = ("contact_stage2", "contact_march", "contact_blocks")


def test_occupancy_matches_jax(jax_run, port_run):
    """The port's occupancy equals JAX's in every count but the contact
    stage counts: equal, or for FLIP_COUNTS within 1% (+ 4). Both on the
    dense back half, whose domain is JAX's poll's (the full frame, with
    its aligned TAA fast path), and as tuned: on the row slab the derived
    config runs (utils/autotune.py), where the only count that differs is
    the deliberate divergence of the band budget, the slab's. The pairs
    of the band blocks past it would count as pairs, but at this size the
    classification closes none of them (lit0 = 1, umbra0 = 2)."""
    jocc, tocc = jax_run["occ"], port_run["occ"]
    scene = port_run["scene"]
    poses = [port_params(p) for p in tune_poses(jax_run["params"])]
    dense = td.measure_sparse_occupancy(scene, poses, dataclasses.replace(
        port_run["raster_cfg"], valid_block_capacity=0))
    for occ, skip in ((dense, ()), (tocc, ("band_bcap",))):
        assert set(jocc) <= set(occ)
        for key, want in jocc.items():
            got = occ[key]
            if key in JIT_CONTACT_COUNTS or key in skip:
                continue
            if key not in FLIP_COUNTS:
                assert got == want, key
                continue
            for g, w in zip(np.atleast_1d(got), np.atleast_1d(want)):
                assert abs(int(g) - int(w)) <= 0.01 * int(w) + 4, (
                    key, got, want)
    assert dense["contact_stage2"] > 0 and dense["contact_march"] > 0
    assert all(tocc[k] == dense[k] for k in JIT_CONTACT_COUNTS)
    # the tuned occupancy: the slab's band budget
    rows = port_run["cfg"].valid_slab_rows
    assert tocc["band_bcap"] == max(rows * W // 64 // 8, 128) < jocc[
        "band_bcap"] == dense["band_bcap"]
    assert tocc["band_blocks"] == dense["band_blocks"] > tocc["band_bcap"]


def expected_cascade_caps(occ):
    """JAX's per-cascade tap caps with the fetch entries folded in (no
    lit split, no adopted route at this size)."""
    return tuple(
        ta._round_up(max((c + f + lit + r) * 1.15, 1024), 1024)
        for c, f, lit, r in zip(occ["pairs_per_cascade"],
                                occ["light_fetch_per_cascade"],
                                occ["pairs_lit_per_cascade"],
                                occ["pairs_route_per_cascade"]))


def test_derive_matches_jax_but_the_cascade_caps(jax_run):
    """derive_sparse_config on JAX's occupancy dict returns JAX's config
    in every field except shadow_pen_cascade_caps, which adds the synth
    frame's fetch entries (the fold JAX's caps lack), and
    light_window_sizes with its light_fetch_caps, which keep the measured
    window JAX drops and give it a cap."""
    occ = jax_run["occ"]
    got = ta.derive_sparse_config(port_config(jax_run["raster_cfg"]), occ)
    want = port_config(jax_run["cfg"])
    assert got.shadow_pen_cascade_caps == expected_cascade_caps(occ)
    assert got.shadow_pen_cascade_caps != want.shadow_pen_cascade_caps
    assert got.light_window_sizes == occ["light_window_sizes"]
    assert got.light_window_sizes != want.light_window_sizes
    assert all(c for c, s in zip(got.light_fetch_caps,
                                 got.light_window_sizes) if s)
    assert got.light_fetch_caps != want.light_fetch_caps
    assert dataclasses.replace(
        got, shadow_pen_cascade_caps=want.shadow_pen_cascade_caps,
        light_window_sizes=want.light_window_sizes,
        light_fetch_caps=want.light_fetch_caps) == want
    assert want.valid_slab_rows and want.shadow_tap_windows is not None
    assert want.shadow_pen_block_capacity and want.contact_block_capacity
    assert sum(occ["light_fetch_per_cascade"]) > 0


def test_capacity_overflows_fold(jax_run, port_run):
    """JAX's own caps, polled the port's way, overflow on cascade 1,
    whose full group holds the fetch entries and the candidates of its
    unadopted route, which JAX's caps and JAX's poll leave out; the port's
    caps name only the band-block budget, as JAX's poll does."""
    occ = port_run["occ"]
    undersized = dataclasses.replace(
        port_run["cfg"],
        shadow_pen_cascade_caps=jax_run["cfg"].shadow_pen_cascade_caps)
    assert "shadow_pen_cascade_caps[1]" in ta.capacity_overflows(undersized,
                                                                 occ)
    assert ta.capacity_overflows(port_run["cfg"], occ) == [
        "band_block_capacity"]
    assert ja.capacity_overflows(jax_run["cfg"], jax_run["occ"]) == [
        "band_block_capacity"]


def test_light_windows_keep_every_occluder(jax_run, port_run):
    """JAX drops the footprint window of a cascade with under 128 fetch
    entries (a light map's budget), but the synthesized maps raster their
    occluders in the same windows: with JAX's sizes the window-fit
    certificate fails at a tuned pose (a cond'd frame takes the full
    raster, a committed one loses that cascade's occluders), while JAX's
    poll reports no overflow. The port keeps every measured window, and
    the certificate holds at every tuned pose.

    Here JAX's tuned config drops cascade 3's window, whose occluders
    fall off its map; at 1920x1080 it drops cascade 2's, whose occluders
    do not (chip_smoke.py's shipped phase). The test shows the second case
    on this frame: the occupancy with cascade 2's fetch count under 128."""
    scene, cfg = port_run["scene"], port_run["cfg"]
    assert cfg.light_window_sizes == port_run["occ"]["light_window_sizes"]
    assert any(s and not j for s, j in zip(cfg.light_window_sizes,
                                           jax_run["cfg"].light_window_sizes))
    assert jax_run["occ"]["synth_window_overflow"] == 0
    occ = dict(jax_run["occ"])
    fetch = list(occ["light_fetch_per_cascade"])
    fetch[2] = 93
    occ["light_fetch_per_cascade"] = tuple(fetch)
    jsizes = ja.derive_sparse_config(jax_run["raster_cfg"],
                                     occ).light_window_sizes
    tsizes = ta.derive_sparse_config(port_config(jax_run["raster_cfg"]),
                                     occ).light_window_sizes
    assert jsizes[2] == 0 and tsizes == occ["light_window_sizes"]
    fits = {"jax": [], "port": []}
    for pose in tune_poses(jax_run["params"]):
        uni = tf.compute_frame_uniforms(port_params(pose),
                                        tf.init_frame_state(cfg, "cpu"), cfg)
        world_v = tgeometry.transform_vertices(scene, uni.models,
                                               uni.view_proj)[0]
        for name, sizes in (("jax", jsizes), ("port", tsizes)):
            origins, _ = tlsm.plan_windows(uni, world_v, scene.vert_object,
                                           sizes, S, cfg.max_softness,
                                           cfg.class_coarse)
            fits[name].append(bool(tshadow.synth_windows_fit(
                world_v, scene.vert_object, uni.light_view_proj, S, sizes,
                origins)))
    assert all(fits["port"]) and not all(fits["jax"]), fits


# ---------------------------------------------------------------------------
# Whole frames
# ---------------------------------------------------------------------------

def test_committed_synth_frames_match_jax(jax_run):
    """Three chained committed + synth frames of JAX's tuned config,
    carried over by convert.config_from_jax_fields, match JAX's frames
    under the slice gates. No frame takes a host branch or reads any
    tensor's value on the host."""
    cfg = port_config(jax_run["cfg"])
    got = run_port(port_scene(jax_run["scene"]), cfg,
                   frame_poses(jax_run["params"]), guard=True)
    for i, ((rgba, depth, hist, tri_id, syncs, reads),
            (jrgba, jdepth, jhist, jtri)) in enumerate(
                zip(got, jax_run["frames"])):
        assert syncs == 0 and reads == [], (i, syncs, reads)
        np.testing.assert_allclose(depth, jdepth, rtol=0, atol=DEPTH_TOL)
        same = tri_id == jtri
        assert (~same).mean() <= MAX_ZFIGHT_FRAC, (i, (~same).sum())
        for a, b in ((rgba, jrgba), (hist, jhist)):
            diff = np.abs(a - b).max(-1)[same]
            assert (diff > GOLDEN_TOL).mean() <= GOLDEN_BAD_FRAC, (
                i, (diff > GOLDEN_TOL).mean(), diff.max())
        assert (hist[..., 0] < 1.0).mean() > 0.01     # shadow in view


@pytest.fixture(scope="module")
def port_frames(jax_run, port_run):
    """Three chained frames of the port's tuned config."""
    return run_port(port_run["scene"], port_run["cfg"],
                    frame_poses(jax_run["params"]))


def test_committed_equals_conded(jax_run, port_run, port_frames):
    """The port's tuned committed frames equal the same config's cond'd
    frames bit for bit (rgba, depth, history, tri_id); the cond'd frames
    took every sparse branch and the committed ones no host branch."""
    cfg = port_run["cfg"]
    conded = dataclasses.replace(
        cfg, flags=dataclasses.replace(cfg.flags, committed=False))
    tcompact.reset_host_syncs()
    got = run_port(port_run["scene"], conded, frame_poses(jax_run["params"]))
    assert_frames_equal(port_frames, got)
    assert all(f[4] == 0 for f in port_frames)
    assert all(f[4] > 0 for f in got)


def test_fetch_fold_fix_holds(jax_run, port_run, port_frames):
    """The port's tuned caps render the same frames as 4x caps, bit for
    bit; JAX's undersized cascade caps truncate cascade 1's taps in the
    same config, and the frame then differs (the fault the fold fixes)."""
    cfg = port_run["cfg"]
    poses = frame_poses(jax_run["params"])

    def with_caps(caps, scale=1):
        return dataclasses.replace(
            cfg, shadow_pen_capacity=cfg.shadow_pen_capacity * scale,
            shadow_pen_cascade_caps=tuple(c * scale for c in caps))

    roomy = run_port(port_run["scene"],
                     with_caps(cfg.shadow_pen_cascade_caps, 4), poses)
    assert_frames_equal(port_frames, roomy)
    short = run_port(port_run["scene"],
                     with_caps(jax_run["cfg"].shadow_pen_cascade_caps),
                     poses)
    assert any(not np.array_equal(a[2], b[2]) for a, b in zip(short, roomy))


def test_forced_overflow_is_detected(jax_run, port_run):
    """Capacities far below the counts (tests/test_committed.py:92-95) are
    named by capacity_overflows on the port's measured occupancy."""
    cfg = port_run["cfg"]
    tiny = dataclasses.replace(
        cfg, shadow_pen_capacity=64, shadow_pen_cascade_caps=(64,) * 4,
        contact_capacity=64, contact_march_capacity=64)
    occ = td.measure_sparse_occupancy(
        port_run["scene"], port_params(jax_run["params"]), tiny, frames=1)
    over = ta.capacity_overflows(tiny, occ)
    assert "shadow_pen_capacity" in over
    assert "contact_capacity" in over
    assert "shadow_pen_cascade_caps[0]" in over


# ---------------------------------------------------------------------------
# Reference faults the port's poll repairs (ROADMAP, deliberate
# divergences); JAX's poll still shows each
# ---------------------------------------------------------------------------

def test_band_bcap_sized_from_the_dense_domain(jax_run, port_run):
    """shadow_filter.py:1015: JAX sizes band_bcap from the poll's
    full-frame domain (480x272: 255 blocks), though the tuned frame
    classifies on its row slab (184 x 480: 172 blocks). The port's poll
    reports the slab's budget, so capacity_overflows compares the band's
    blocks with the budget the frame has."""
    cfg = port_run["cfg"]
    assert cfg.valid_slab_rows == 184
    occ = td.measure_sparse_occupancy(
        port_run["scene"], port_params(jax_run["params"]), cfg, frames=1)
    assert jax_run["occ"]["band_bcap"] == max(W * H // 64 // 8, 128) == 255
    assert occ["band_bcap"] == max(184 * W // 64 // 8, 128) == 172
    assert occ["band_blocks"] > occ["band_bcap"]
    assert "band_block_capacity" in ta.capacity_overflows(cfg, occ)


def test_committed_taa_truncation_is_undetected(jax_run, port_run):
    """taa.py:154: on the valid-block back half a committed sparse TAA
    read has no aligned fast path, so on a parked view its need set is
    nearly the whole covered domain and a small taa_need_capacity drops
    history rows: the history differs from the same frames without the
    capacity. JAX's poll reports taa_need 0 there; the port's reports the
    need, and capacity_overflows names taa_need_capacity at cap 1024."""
    params = jax_run["params"]
    cfg = dataclasses.replace(port_run["cfg"], valid_slab_rows=0,
                              valid_block_capacity=None)
    poses = [params, params]
    plain = run_port(port_run["scene"], cfg, poses)
    capped = dataclasses.replace(cfg, taa_need_capacity=1024)
    trunc = run_port(port_run["scene"], capped, poses)
    assert not np.array_equal(plain[1][2], trunc[1][2])
    assert all(f[4] == 0 for f in trunc)
    occ = td.measure_sparse_occupancy(port_run["scene"],
                                      port_params(params), capped, frames=1)
    assert occ["taa_need"] > 0.9 * occ["pixels"] > 1024
    assert "taa_need_capacity" in ta.capacity_overflows(capped, occ)
    # JAX's poll on the same pose and state: every needed pixel reads its
    # own texel, so it reports 0 whatever the back half
    state = tf.init_frame_state(capped, "cpu")
    _, state = tf.render_gltf_frame(port_run["scene"], port_params(params),
                                    state, capped)
    jcfg = dataclasses.replace(jax_run["cfg"], valid_slab_rows=0,
                               valid_block_capacity=None,
                               taa_need_capacity=1024)
    jocc = jax.jit(jd.sparse_occupancy, static_argnums=(3,))(
        jax_run["scene"], params,
        jf.FrameState(*(jnp.asarray(t2n(x)) for x in state)), jcfg)
    assert int(jocc["taa_need"]) == 0


# ---------------------------------------------------------------------------
# Knobs the small frame does not turn on, against JAX on the same inputs:
# the frame's back-half inputs, cut to rows [R0, R1), the band that holds
# the cubes' shadows (a quarter of the frame's work).
# ---------------------------------------------------------------------------

R0, R1 = 112, 176


@pytest.fixture(scope="module")
def filter_inputs(jax_run, port_run):
    """The port's back-half inputs at orbit pose 1 after a parked frame
    (the full cascade raster, the class maps, the G-buffer, the previous
    depth), whole and on the band, in both packages' types."""
    scene = port_run["scene"]
    cfg = port_run["cfg"]
    params = jax_run["params"]
    state = tf.init_frame_state(cfg, "cpu")
    _, state = tf.render_gltf_frame(scene, port_params(params), state, cfg)
    pose = port_params(bench.orbit_params(params, 1))
    uni, cmaps, g, normal, ndl, vdepth, _, world_v = \
        td._frame_intermediates(scene, pose, state, cfg)
    raw = tshadow.render_shadow_maps(
        world_v, scene.tri_indices, scene.num_triangles,
        uni.light_view_proj, cfg.shadow_raster, S)
    frag = torch.stack(pixel_centers(H, W, 0, "cpu"), dim=-1)
    port_args = (uni, quad_pack(raw), cmaps, g.world, normal, ndl, vdepth,
                 frag)
    juni = JUniforms(**{f: jnp.asarray(t2n(getattr(uni, f)))
                        for f in uni._fields})
    jcmaps = jcls.ShadowClassMaps(
        cell_rows=jnp.asarray(t2n(cmaps.cell_rows)),
        planes=jnp.asarray(t2n(cmaps.planes)), size=cmaps.size,
        coarse=cmaps.coarse, max_softness=cmaps.max_softness)

    def jax_of(args):
        return (juni, jnp.asarray(t2n(args[1])), jcmaps) + tuple(
            jnp.asarray(t2n(a)) for a in args[3:])

    band = port_args[:3] + tuple(a[R0:R1] for a in port_args[3:])
    plane = tcontact.reference_plane(scene.positions, scene.tri_indices,
                                     uni.prev_view_proj, W, H)
    return dict(port=port_args, jax=jax_of(port_args), band=band,
                jband=jax_of(band), valid=g.valid, vband=g.valid[R0:R1],
                uni=uni, juni=juni, world_v=world_v, scene=scene,
                prev_depth=state.prev_depth, plane=plane)


def band_routes(d, sizes):
    """Route windows at `sizes` for the band's frame, in both packages'
    types."""
    origins, _ = tlsm.plan_windows(d["uni"], d["world_v"],
                                   d["scene"].vert_object, sizes, S, 4.0, 16)
    return ((origins, sizes),
            (tuple(None if o is None else (jnp.int32(int(o[0])),
                                           jnp.int32(int(o[1])))
                   for o in origins), sizes))


# Tap windows that hold each cascade's taps (tap extents (877, 706, 227, 0)
# texels plus 2 x 12 of reach): the windowed reads equal the full-table
# reads.
KNOBS = {
    "routes": dict(route_sizes=(384, 256, 0, 0),
                   route_caps=(32768, 32768, 0, 0)),
    "tap_windows": dict(tap_windows=(1000, 768, 512, 512)),
    "all": dict(route_sizes=(384, 256, 0, 0),
                route_caps=(32768, 32768, 0, 0),
                lit_cascade_caps=(8192, 8192, 1024, 1024),
                tap_windows=(1000, 768, 512, 512), block_capacity=960),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_filter_knobs_match_jax_and_default(filter_inputs, knob):
    """cascaded_shadow_sparse on the band with explicit routes, with tap
    windows, and with both plus a radius-only split and a block budget:
    committed and cond'd runs equal the port's default-knob filter bit for
    bit (the groups are exact while their capacities and windows hold),
    and v, m1, m2 equal JAX's committed run on the same inputs on all but
    0.2% of covered pixels (5e-4)."""
    d = filter_inputs
    kw = dict(KNOBS[knob])
    routes = jroutes = None
    if "route_sizes" in kw:
        routes, jroutes = band_routes(d, kw.pop("route_sizes"))
    cap = 2 * (R1 - R0) * W
    valid = d["vband"]
    v = t2n(valid)
    base, *_ = tsf.cascaded_shadow_sparse(*d["band"], True, valid, cap)
    for committed in (True, False):
        tcompact.reset_host_syncs()
        got, *_ = tsf.cascaded_shadow_sparse(
            *d["band"], True, valid, cap, committed=committed,
            route_windows=routes, route_caps=kw.get("route_caps"),
            lit_cascade_caps=kw.get("lit_cascade_caps"),
            tap_windows=kw.get("tap_windows"),
            block_capacity=kw.get("block_capacity"))
        if committed:
            assert tcompact.HOST_SYNCS == 0
        else:
            assert tcompact.BRANCHES[("shadow_pairs", True)] == 1
        for name in ("v", "m1", "m2", "kernel_radius_texels"):
            np.testing.assert_array_equal(t2n(getattr(got, name))[v],
                                          t2n(getattr(base, name))[v], name)
    jres, *_ = jsf.cascaded_shadow_sparse(
        *d["jband"], True, jnp.asarray(v), cap, None,
        kw.get("block_capacity"), kw.get("tap_windows"), None, False, True,
        kw.get("lit_cascade_caps"), jroutes, kw.get("route_caps"))
    for name in ("v", "m1", "m2"):
        diff = np.abs(t2n(getattr(got, name))[v]
                      - np.asarray(getattr(jres, name))[v])
        assert (diff > 5e-4).mean() <= 0.002, (name, diff.max())
    assert (t2n(got.v)[v] < 1.0).mean() > 0.02


def test_filter_groups_are_populated(filter_inputs):
    """The knob test's groups hold entries on the band: routed entries and
    full-group entries in cascades 0 and 1. (At 1024^2 maps this scene's
    classification certifies almost no pixel LIT, so the radius-only
    groups are held against JAX at 2048^2, in tests/test_torch_sparse.py.)"""
    d = filter_inputs
    uni, maps, cmaps, world, normal, ndl, vdepth, frag = d["band"]
    routes, _ = band_routes(d, KNOBS["routes"]["route_sizes"])
    st = tsf.classify_stats(uni, cmaps, world, normal, ndl, vdepth, frag,
                            True, d["vband"], route_windows=routes)
    route = t2n(st["pairs_route_per_cascade"])
    full = t2n(st["pairs_per_cascade"])
    assert route[0] > 0 and route[1] > 0 and full[0] > 0 and full[1] > 0


def test_filter_truncation_matches_jax(filter_inputs):
    """A committed frame whose pairs overflow their caps keeps each
    group's first entries, as JAX does: with the tap groups cut below
    their counts on the band, v, m1, m2 equal JAX's on the same inputs
    under the knob test's tolerance, and differ from the untruncated
    filter."""
    d = filter_inputs
    caps = (2048, 1024, 1024, 1024)
    cap = 2 * (R1 - R0) * W
    valid = d["vband"]
    got, *_ = tsf.cascaded_shadow_sparse(*d["band"], True, valid, cap,
                                         cascade_caps=caps, committed=True)
    jres, *_ = jsf.cascaded_shadow_sparse(
        *d["jband"], True, jnp.asarray(t2n(valid)), cap, caps, None, None,
        None, False, True)
    base, *_ = tsf.cascaded_shadow_sparse(*d["band"], True, valid, cap)
    v = t2n(valid)
    for name in ("v", "m1", "m2"):
        diff = np.abs(t2n(getattr(got, name))[v]
                      - np.asarray(getattr(jres, name))[v])
        assert (diff > 5e-4).mean() <= 0.002, (name, diff.max())
    assert not np.array_equal(t2n(got.v)[v], t2n(base.v)[v])


def test_contact_occupancy_matches_unjitted_jax(filter_inputs):
    """contact_occupancy on the same inputs (a frame's G-buffer, its
    previous depth and reference plane): the stage-2 mask, its count and
    the march extent equal to JAX's run op by op, the march count within
    0.2% (+ 4)."""
    d = filter_inputs
    world, normal = d["port"][3], d["port"][4]
    got = tcontact.contact_occupancy(world, normal, d["uni"],
                                     d["prev_depth"], valid=d["valid"],
                                     plane=d["plane"])
    with jax.disable_jit():
        want = jcontact.contact_occupancy(
            d["jax"][3], d["jax"][4], d["juni"],
            jnp.asarray(t2n(d["prev_depth"])),
            valid=jnp.asarray(t2n(d["valid"])),
            plane=jnp.asarray(t2n(d["plane"])))
    np.testing.assert_array_equal(t2n(got["_stage2"]),
                                  np.asarray(want["_stage2"]))
    for key in ("contact_stage2", "contact_march_extent"):
        assert int(got[key]) == int(want[key]), key
    # stage 2 compares each probe's depth with a bound it meets within an
    # ulp: a few rays flip (measured 2 of 5,897)
    march, jmarch = int(got["contact_march"]), int(want["contact_march"])
    assert march > 0 and abs(march - jmarch) <= 0.002 * jmarch + 4


def test_contact_committed_knobs(filter_inputs):
    """compute_contact_shadow_sparse committed on the band (y0 = R0):
    with capacities that hold every ray and a block budget, equal to the
    port's dense march on covered pixels bit for bit; with tight
    capacities and a 192^2 march window (both packages march their first
    entries, leave the rest lit, and clamp probes past the window to its
    edge), equal to JAX's run op by op on the same inputs within 1e-6 on
    all but 1% of the band: the stage-2 certificate flips a few rays
    between the two (test_contact_occupancy_matches_unjitted_jax), which
    can shift the truncation and the window's origin."""
    d = filter_inputs
    world, normal = d["band"][3], d["band"][4]
    n = world.shape[0] * world.shape[1]
    v = t2n(d["vband"])

    def port(**kw):
        tcompact.reset_host_syncs()
        out = t2n(tcontact.compute_contact_shadow_sparse(
            world, normal, d["uni"], d["prev_depth"], R0, valid=d["vband"],
            plane=d["plane"], committed=True, **kw))
        assert tcompact.HOST_SYNCS == 0
        return out

    exact = port(capacity=n, march_capacity=n, block_capacity=n // 64)
    dense = t2n(tcontact.compute_contact_shadow(world, normal, d["uni"],
                                                d["prev_depth"], R0))
    np.testing.assert_array_equal(exact[v], dense[v])
    assert (exact[v] < 1.0).any()

    kw = dict(capacity=4096, march_capacity=512, block_capacity=96,
              march_window=192)
    got = port(**kw)
    with jax.disable_jit():
        want = np.asarray(jcontact.compute_contact_shadow_sparse(
            d["jband"][3], d["jband"][4], d["juni"],
            jnp.asarray(t2n(d["prev_depth"])), R0,
            valid=jnp.asarray(v), plane=jnp.asarray(t2n(d["plane"])),
            committed=True, **kw))
    off = np.abs(got - want) > 1e-6
    assert off.mean() <= 0.01, (off.mean(), np.abs(got - want).max())
    assert not np.array_equal(got[v], exact[v])


def _taa_inputs(d, parked, flat):
    """TAA inputs on the band: numpy-seeded moments and history, the
    frame's uniforms (parked: the previous view is this one), and the
    slab's rows or the same pixels as a flat domain with explicit pixel
    centres."""
    rng = np.random.default_rng(7)
    h = R1 - R0
    v = rng.random((h, W), dtype=np.float32)
    m2 = np.maximum(v * v, rng.random((h, W), dtype=np.float32))
    kern = rng.random((h, W), dtype=np.float32) * np.float32(8.0)
    hist = rng.random((H, W, 2), dtype=np.float32)
    uni = d["uni"]
    if parked:
        uni = uni._replace(prev_view_proj=uni.view_proj)
    world = t2n(d["band"][3])
    frag = t2n(d["band"][7])
    if flat:
        v, m2, kern = v.reshape(-1), m2.reshape(-1), kern.reshape(-1)
        world, frag = world.reshape(-1, 3), frag.reshape(-1, 2)
    juni = JUniforms(**{f: jnp.asarray(t2n(getattr(uni, f)))
                        for f in uni._fields})
    return (v, m2, kern, hist, world, frag), uni, juni


@pytest.mark.parametrize("committed", [True, False],
                         ids=["committed", "conded"])
@pytest.mark.parametrize("need_cap", [H * W, 1024], ids=["roomy", "tight"])
@pytest.mark.parametrize("flat", [False, True], ids=["slab", "flat"])
def test_taa_need_read_matches_jax(filter_inputs, flat, need_cap,
                                   committed):
    """apply_shadow_taa with taa_need_capacity against JAX's on the same
    inputs, parked (the slab's aligned fast path) and moving: equal
    within 1e-6. A tight capacity overflows: the cond'd read takes the
    gathered one, the committed read truncates (taa.py:154), in both
    packages alike."""
    for parked in (True, False):
        (v, m2, kern, hist, world, frag), uni, juni = _taa_inputs(
            filter_inputs, parked, flat)
        dom = dict(frag=T(frag), full_width=W) if flat else dict(y0=R0)
        jdom = (dict(frag=jnp.asarray(frag), full_width=W) if flat
                else dict(y0=R0))
        tcompact.reset_host_syncs()
        got = ttaa.apply_shadow_taa(
            tsf.ShadowResult(T(v), T(v), T(m2), T(kern)), T(world), uni,
            T(hist), True, full_height=H, need_capacity=need_cap,
            committed=committed, **dom)
        assert (tcompact.HOST_SYNCS == 0) == committed
        want = jtaa.apply_shadow_taa(
            jsf.ShadowResult(*(jnp.asarray(a) for a in (v, v, m2, kern))),
            jnp.asarray(world), juni, jnp.asarray(hist), True,
            full_height=H, need_capacity=need_cap, committed=committed,
            **jdom)
        for a, b in zip(got, want):
            np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=0,
                                       atol=1e-6)
