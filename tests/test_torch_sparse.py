"""Port parity: the default exact-sparse back half of the glTF frame
(funky_tpu_torch/passes/{shadow_classify,shadow_filter,contact}.py, the
block-sparse texture sampling and frame.py's valid-block back half)
against funky_tpu's, and against the port's own dense path.

Tolerances and why:
- class maps and classification: bit-equal to JAX run op by op
  (jax.disable_jit: no fusion, so no FMA contraction); jitted JAX
  contracts the plane evaluations, so there the cell rows agree to 4e-6
  (measured 1.0e-6).
- sparse == dense inside the port: bit for bit. Classification only
  decides which pixels run the exact taps (or march), the closed forms
  are exact, and the port sums the 16 taps in a fixed order on any batch
  shape. The kernel radius of a closed pixel is the one field that
  differs before TAA (0 instead of its unused penumbra); TAA's output and
  history, and the image, are equal.
- port vs JAX: the pass tolerances of tests/test_torch_passes.py and the
  frame gates of tests/test_torch_frame.py (FMA contraction and sin/cos
  rounding differ between XLA and torch).

Shadow maps are 2048^2, the GltfConfig() default: at 256^2 this scene's
ground slope per texel exceeds the depth bias, the classification closes
nothing, and every frame would take the dense fallback.
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
from funky_tpu.ops.raster import raster_corners as jraster_corners
from funky_tpu.ops.sampling import quad_pack as jquad_pack
from funky_tpu.passes import contact as jcontact
from funky_tpu.passes import deferred as jdeferred
from funky_tpu.passes import geometry as jgeometry
from funky_tpu.passes import shadow as jshadow
from funky_tpu.passes import shadow_classify as jcls
from funky_tpu.passes import shadow_filter as jsf

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import compact as tcompact
from funky_tpu_torch.ops.sampling import quad_pack as tquad_pack
from funky_tpu_torch.passes import contact as tcontact
from funky_tpu_torch.passes import shadow_classify as tcls
from funky_tpu_torch.passes import shadow_filter as tsf
from funky_tpu_torch.passes import taa as ttaa

from .test_torch_frame import (DEPTH_TOL, GOLDEN_BAD_FRAC, GOLDEN_TOL,
                               MAX_ZFIGHT_FRAC, _jax_main_raster)
from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, port_uniforms, t2n)

W, H = 256, 144


def T(x):
    return torch.from_numpy(np.array(x))


def frac_over(a, b, tol):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > tol).mean())


# ---------------------------------------------------------------------------
# Class maps and classification on synthetic sloped maps
# ---------------------------------------------------------------------------

def sloped_maps(seed, l=2, s=256, slope=1e-4):
    """Ground-like cascades whose depth slopes across uv, plus a nearer
    occluder blob (tests/test_sparse_shadow.py::_sloped_maps, in numpy),
    and the matching uv-space planes."""
    rng = np.random.default_rng(seed)
    x = np.arange(s, dtype=np.float32)
    base = 0.5 + slope * x[None, None, :] + slope * 0.3 * x[None, :, None]
    maps = np.broadcast_to(base, (l, s, s)).copy()
    maps[:, 60:180, 80:200] = 0.25
    maps = np.clip(maps + rng.random((l, s, s)).astype(np.float32) * 1e-5,
                   0.0, 1.0).astype(np.float32)
    planes = np.tile(np.asarray(
        [[slope * s, 0.3 * slope * s, 0.5 - 0.5 * slope - 0.15 * slope]],
        np.float32), (l, 1))
    return maps, planes


def class_queries(seed, maps, n=8192):
    """uv, layer, receivers on, deep below and around the stored
    surface, and Vogel rotations."""
    rng = np.random.default_rng(seed)
    l, s, _ = maps.shape
    uv = rng.uniform(0.02, 0.98, (n, 2)).astype(np.float32)
    layer = rng.integers(0, l, n).astype(np.int32)
    px = np.floor(uv * s).astype(np.int32)
    anchor = maps[layer, px[:, 1], px[:, 0]]
    k = np.arange(n) % 3
    delta = np.where(k == 0, -0.0012, np.where(
        k == 1, 0.15, (rng.random(n) - 0.5) * 0.02)).astype(np.float32)
    phi = (rng.random(n) * 6.2831853).astype(np.float32)
    return uv, layer, (anchor + delta).astype(np.float32), phi


@pytest.mark.parametrize("coarse", [8, 5], ids=["pooled", "full_res"])
def test_class_maps_and_classify_bit_equal(coarse):
    """build_class_maps and classify equal JAX's op-by-op results bit for
    bit: the 2x2-pooled path (even coarse) and the full-resolution one
    (odd coarse), PCSS and PCF certificates."""
    maps, planes = sloped_maps(0, s=250 if coarse == 5 else 256)
    uv, layer, recv, _ = class_queries(1, maps)
    soft = np.float32(2.5)
    with jax.disable_jit():
        jm = jcls.build_class_maps(jnp.asarray(maps), coarse, 4.0,
                                   jnp.asarray(planes))
        jout = [jcls.classify(jm, jnp.asarray(layer), jnp.asarray(uv),
                              jnp.asarray(recv), jnp.asarray(soft), pcss)
                for pcss in (True, False)]
    tm = tcls.build_class_maps(T(maps), coarse, 4.0, T(planes))
    np.testing.assert_array_equal(t2n(tm.cell_rows), np.asarray(jm.cell_rows))
    for pcss, (jlit, jum) in zip((True, False), jout):
        lit, um = tcls.classify(tm, T(layer), T(uv), T(recv), T(soft), pcss)
        np.testing.assert_array_equal(t2n(lit), np.asarray(jlit))
        np.testing.assert_array_equal(t2n(um), np.asarray(jum))
        assert t2n(lit).sum() > 500 and t2n(um).sum() > 500


def test_classification_sound_against_port_taps():
    """The port's LIT/UMBRA certificates hold against the port's own exact
    PCSS taps: LIT => m1 = m2 = 1, UMBRA => blockers and m1 = m2 = 0."""
    maps, planes = sloped_maps(2)
    uv, layer, recv, phi = class_queries(3, maps)
    s = maps.shape[1]
    uni = port_uniforms(jsf_test_uniforms(s, 2.5))
    tm = tcls.build_class_maps(T(maps), 8, 4.0, T(planes))
    lit, um = (t2n(x) for x in tcls.classify(tm, T(layer), T(uv), T(recv),
                                             uni.shadow_bias[0], True))
    m1, m2, _, hasb = (t2n(x) for x in tsf._pcss_taps(
        uni, tquad_pack(T(maps)), T(layer), T(uv), T(recv), T(phi)))
    assert (np.where(hasb, m1, 1.0)[lit] == 1.0).all()
    assert (np.where(hasb, m2, 1.0)[lit] == 1.0).all()
    assert hasb[um].all() and (m1[um] == 0.0).all() and (m2[um] == 0.0).all()
    assert lit.sum() > 500 and um.sum() > 500 and (~lit & ~um).sum() > 100


def jsf_test_uniforms(s, softness):
    from funky_tpu.passes.uniforms import FrameUniforms

    return FrameUniforms(
        view=jnp.eye(4), proj=jnp.eye(4), view_proj=jnp.eye(4),
        camera_pos=jnp.zeros(3), light_dir=jnp.asarray([0.0, 1.0, 0.0]),
        light_view_proj=jnp.zeros((4, 4, 4)), cascade_splits=jnp.zeros(4),
        shadow_map_size=jnp.asarray([s, s, 1 / s, 1 / s], jnp.float32),
        debug_flags=jnp.zeros(4),
        shadow_bias=jnp.asarray([softness, 0, 0, 0], jnp.float32),
        prev_view_proj=jnp.eye(4), models=jnp.zeros((2, 4, 4)))


# ---------------------------------------------------------------------------
# The multimesh frame's own intermediates at 2048^2 maps
# ---------------------------------------------------------------------------

def jax_config(**kw):
    tile = JRC(tile_h=32, tile_w=128, backend="jnp")
    stile = JRC(tile_h=128, tile_w=256, backend="jnp")
    return jf.GltfConfig(width=W, height=H, raster=tile, shadow_raster=stile,
                         **kw)


def port_config(**kw):
    return tf.GltfConfig(width=W, height=H, **kw)


def port_dense_config():
    return port_config(valid_block_capacity=0, texture_block_capacity=0,
                       flags=tf.GltfFrameFlags(sparse_shadows=False,
                                               sparse_contact=False))


@pytest.fixture(scope="module")
def ref():
    """JAX intermediates of orbit pose 1 after one parked GltfConfig()
    frame: inputs of the sparse filter and contact march, and JAX's own
    sparse results on them."""
    jcfg = jax_config()
    scene = multimesh_jax_scene()
    params = multimesh_params()
    state = jf.init_frame_state(jcfg)
    _, state = jf.compiled_gltf_frame(jcfg)(scene, params, state)
    pose = bench.orbit_params(params, 1)

    @jax.jit
    def intermediates(scene, p, st):
        uni = jf.compute_frame_uniforms(p, st, jcfg)
        world, clip, nrm = jgeometry.transform_vertices(
            scene, uni.models, uni.view_proj)
        blocks = jgeometry.build_shade_blocks(scene, world, clip, nrm)
        raw = jshadow.render_shadow_maps(
            world, scene.tri_indices, scene.num_triangles,
            uni.light_view_proj, jcfg.shadow_raster, jcfg.shadow_map_size)
        planes = jcls.light_ground_planes(uni.light_view_proj)
        cmaps = jcls.build_class_maps(raw, jcfg.class_coarse,
                                      jcfg.max_softness, planes)
        maps = jax.vmap(jquad_pack)(raw)
        tri_clip, blocks_m, flags_m, valid = jf._main_raster_inputs(
            scene, clip, blocks, jcfg.clip_capacity)
        tri_id, depth, setup = jraster_corners(tri_clip, valid, W, H,
                                               jcfg.raster)
        g = jdeferred.interpolate(tri_id, depth, setup.data, blocks_m,
                                  flags_m)
        normal = g.normal / jnp.maximum(
            jnp.linalg.norm(g.normal, axis=-1, keepdims=True), 1e-12)
        ndl = jnp.maximum(jnp.sum(normal * uni.light_dir, axis=-1), 0.0)
        vdepth = -((g.world @ uni.view[2, :3].T) + uni.view[2, 3])
        frag = jnp.stack([
            jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32)[None] + 0.5,
                             (H, W)),
            jnp.broadcast_to(jnp.arange(H, dtype=jnp.float32)[:, None]
                             + 0.5, (H, W))], axis=-1)
        sparse = jsf.cascaded_shadow_sparse(
            uni, maps, cmaps, g.world, normal, ndl, vdepth, frag, True,
            g.valid)
        plane = jcontact.reference_plane(scene.positions, scene.tri_indices,
                                         uni.prev_view_proj, W, H)
        ct = jcontact.compute_contact_shadow_sparse(
            g.world, normal, uni, st.prev_depth, valid=g.valid, plane=plane)
        return dict(uni=uni, raw=raw, planes=planes, cell_rows=cmaps.cell_rows,
                    maps=maps, gbuf=g, normal=normal, ndl=ndl, vdepth=vdepth,
                    frag=frag, sparse=sparse, plane=plane, contact=ct)

    out = intermediates(scene, pose, state)
    return dict(out, jcfg=jcfg, scene=scene, pose=pose, state=state)


def port_class_maps(ref):
    planes = tcls.light_ground_planes(port_uniforms(ref["uni"])
                                      .light_view_proj)
    return tcls.build_class_maps(T(ref["raw"]), 16, 4.0, planes), planes


def test_frame_class_maps_match_jax(ref):
    cmaps, planes = port_class_maps(ref)
    np.testing.assert_allclose(t2n(planes), np.asarray(ref["planes"]),
                               rtol=1e-5, atol=1e-6)
    # jitted JAX contracts the plane evaluation (measured up to 1.0e-6)
    np.testing.assert_allclose(t2n(cmaps.cell_rows),
                               np.asarray(ref["cell_rows"]), rtol=0,
                               atol=4e-6)


def sparse_inputs(ref):
    g = ref["gbuf"]
    return (port_uniforms(ref["uni"]), T(ref["maps"]), port_class_maps(ref)[0],
            T(g.world), T(ref["normal"]), T(ref["ndl"]), T(ref["vdepth"]),
            T(ref["frag"]))


@pytest.mark.parametrize("use_pcss", [True, False], ids=["pcss", "pcf"])
def test_sparse_filter_equals_dense(ref, use_pcss):
    """cascaded_shadow_sparse takes its sparse branch here and equals
    the port's dense filter: v, m1, m2 bit for bit on covered pixels, and
    TAA's output and history. PCSS closes most pixels at the default
    capacity; PCF's certificates close fewer on this frame, so its pair
    budget is raised to keep it on the sparse branch."""
    uni, maps, cmaps, world, normal, ndl, vdepth, frag = sparse_inputs(ref)
    valid = T(ref["gbuf"].valid)
    tcompact.reset_host_syncs()
    sp, c0, c1, t = tsf.cascaded_shadow_sparse(
        uni, maps, cmaps, world, normal, ndl, vdepth, frag, use_pcss, valid,
        capacity=None if use_pcss else 2 * H * W)
    assert tcompact.BRANCHES[("shadow_pairs", True)] == 1
    de, dc0, dc1, dt = tsf.cascaded_shadow(uni, maps, world, normal, ndl,
                                           vdepth, frag, use_pcss)
    v = t2n(valid)
    for name in ("v", "m1", "m2"):
        np.testing.assert_array_equal(t2n(getattr(sp, name))[v],
                                      t2n(getattr(de, name))[v], name)
    hist = torch.ones((H, W, 2))
    for a, b in zip(ttaa.apply_shadow_taa(sp, world, uni, hist, True),
                    ttaa.apply_shadow_taa(de, world, uni, hist, True)):
        np.testing.assert_array_equal(t2n(a)[v], t2n(b)[v])
    assert (t2n(sp.v)[v] < 1.0).mean() > 0.02        # real shadow present


def test_sparse_filter_matches_jax(ref):
    uni, maps, cmaps, world, normal, ndl, vdepth, frag = sparse_inputs(ref)
    g = ref["gbuf"]
    sp, c0, c1, t = tsf.cascaded_shadow_sparse(
        uni, maps, cmaps, world, normal, ndl, vdepth, frag, True, T(g.valid))
    jres, jc0, jc1, jt = ref["sparse"]
    v = np.asarray(g.valid)
    np.testing.assert_array_equal(t2n(c0)[v], np.asarray(jc0)[v])
    np.testing.assert_array_equal(t2n(c1)[v], np.asarray(jc1)[v])
    for name in ("v", "m1", "m2"):
        assert frac_over(t2n(getattr(sp, name))[v],
                         np.asarray(getattr(jres, name))[v], 5e-4) <= 0.002


def test_classify_stats_counts_dropped_band_blocks_as_pairs(ref):
    """classify_stats on a domain with a smaller band budget than its own
    (the frame's row slab or block budget): committed, the band blocks
    past the budget are dropped as the committed frame drops them, and
    every covered, in-map pixel of the blend band they hold counts as a
    pair; cond'd, the frame classifies an overflowing band densely, and
    the counts are the full budget's. Bit for bit (mask equality). The
    frame's inputs are stacked twice, so that the band outgrows the least
    budget (128 blocks)."""
    uni, _, cmaps, *pixel = sparse_inputs(ref)
    world, normal, ndl, vdepth, frag, valid = (
        torch.cat([a, a]) for a in pixel + [T(ref["gbuf"].valid)])
    args = (uni, cmaps, world, normal, ndl, vdepth, frag, True, valid)
    full = tsf.classify_stats(*args, committed=True)
    assert int(full["band_bcap"]) == tsf.band_budget(2 * H * W)
    small = tsf.classify_stats(*args, committed=True, domain=1)
    conded = tsf.classify_stats(*args, committed=False, domain=1)
    assert int(small["band_bcap"]) == int(conded["band_bcap"]) == 128
    assert int(small["band_blocks"]) > 128
    assert torch.equal(conded["_needs"], full["_needs"])
    added = small["_needs"] & ~full["_needs"]
    assert not (full["_needs"] & ~small["_needs"]).any()
    assert int(small["pairs"]) > int(full["pairs"])
    # the added pairs lie in the band's blocks past the first 128
    c0, c1, t = tsf.select_cascade_blend(vdepth, uni.cascade_splits)
    band = (t > 0.0) & valid
    blocks = band.reshape(2 * H // 8, 8, W // 8, 8).any(dim=3).any(dim=1)
    order = torch.cumsum(blocks.flatten().to(torch.int32), 0).reshape(
        blocks.shape)
    past = (blocks & (order > 128)).repeat_interleave(8, 0) \
        .repeat_interleave(8, 1)
    assert not (added.any(dim=0) & ~past).any()
    assert added.any(dim=0).any()


def test_sparse_filter_radius_only_groups(ref):
    """The radius-only split (lit_cascade_caps, PCSS): LIT-side pair
    entries run only the blocker search. Committed with tap windows on
    every cascade, and cond'd without: equal to the default-knob filter
    bit for bit on covered pixels, and the committed run equals JAX's on
    the same inputs within test_sparse_filter_matches_jax's tolerance."""
    args = sparse_inputs(ref)
    uni, maps, cmaps, world, normal, ndl, vdepth, frag = args
    valid = T(ref["gbuf"].valid)
    v = t2n(valid)
    st = tsf.classify_stats(uni, cmaps, world, normal, ndl, vdepth, frag,
                            True, valid)
    assert int(t2n(st["pairs_lit_per_cascade"]).sum()) > 0
    cap = 2 * H * W
    lit_caps = (H * W,) * 4
    # windows that hold each cascade's taps: the entries' extent, 2 x 12
    # texels of tap reach at softness 2.5, and the bilinear footprint
    windows = tuple(int(e) + 26 if 0 < int(e) + 26 < 2048 else 0
                    for e in t2n(st["need_extent_per_cascade"]))
    assert any(windows)
    base, *_ = tsf.cascaded_shadow_sparse(*args, True, valid, cap)
    for committed in (True, False):
        tcompact.reset_host_syncs()
        got, *_ = tsf.cascaded_shadow_sparse(
            *args, True, valid, cap, committed=committed,
            lit_cascade_caps=lit_caps,
            tap_windows=windows if committed else None)
        assert (tcompact.HOST_SYNCS == 0) == committed
        for name in ("v", "m1", "m2", "kernel_radius_texels"):
            np.testing.assert_array_equal(t2n(getattr(got, name))[v],
                                          t2n(getattr(base, name))[v], name)
    jcmaps = jcls.ShadowClassMaps(
        cell_rows=jnp.asarray(t2n(cmaps.cell_rows)),
        planes=jnp.asarray(t2n(cmaps.planes)), size=cmaps.size,
        coarse=cmaps.coarse, max_softness=cmaps.max_softness)
    jres, *_ = jsf.cascaded_shadow_sparse(
        ref["uni"], ref["maps"], jcmaps, *(jnp.asarray(t2n(a))
                                           for a in args[3:]),
        True, jnp.asarray(v), cap, None, None, windows, None, False, True,
        lit_caps)
    for name in ("v", "m1", "m2"):
        assert frac_over(t2n(getattr(got, name))[v],
                         np.asarray(getattr(jres, name))[v], 5e-4) <= 0.002


def test_sparse_filter_overflow_takes_dense(ref):
    """A capacity below the pair count takes the dense filter: every
    field, the kernel radius included, equals cascaded_shadow."""
    uni, maps, cmaps, world, normal, ndl, vdepth, frag = sparse_inputs(ref)
    valid = T(ref["gbuf"].valid)
    tcompact.reset_host_syncs()
    sp = tsf.cascaded_shadow_sparse(uni, maps, cmaps, world, normal, ndl,
                                    vdepth, frag, True, valid, capacity=64)
    assert tcompact.BRANCHES[("shadow_pairs", False)] == 1
    de = tsf.cascaded_shadow(uni, maps, world, normal, ndl, vdepth, frag,
                             True)
    for a, b in zip(sp[0], de[0]):
        np.testing.assert_array_equal(t2n(a), t2n(b))


def test_contact_sparse_frame_inputs(ref):
    """Sparse contact on the frame's inputs: the reference plane matches
    JAX's, the sparse march equals the port's dense march on covered
    pixels bit for bit and JAX's within the contact tolerance of
    tests/test_torch_passes.py."""
    uni = port_uniforms(ref["uni"])
    scene = port_scene(ref["scene"])
    g = ref["gbuf"]
    plane = tcontact.reference_plane(scene.positions, scene.tri_indices,
                                     uni.prev_view_proj, W, H)
    np.testing.assert_allclose(t2n(plane), np.asarray(ref["plane"]),
                               rtol=1e-5, atol=1e-9)
    prev = T(ref["state"].prev_depth)
    tcompact.reset_host_syncs()
    sp = tcontact.compute_contact_shadow_sparse(
        T(g.world), T(ref["normal"]), uni, prev, valid=T(g.valid),
        plane=plane)
    de = tcontact.compute_contact_shadow(T(g.world), T(ref["normal"]), uni,
                                         prev)
    v = np.asarray(g.valid)
    np.testing.assert_array_equal(t2n(sp)[v], t2n(de)[v])
    assert frac_over(t2n(sp)[v], np.asarray(ref["contact"])[v], 1e-2) <= 0.005
    assert sum(tcompact.BRANCHES.values()) == 1


def test_contact_sparse_matches_dense_with_hits():
    """The certificate never retires a ray whose exact march hits: sparse
    == dense on the near-wall scene of tests/test_taa_contact.py, where
    the occluder casts a real contact shadow."""
    from .test_taa_contact import _uniforms, _world_grid

    juni = _uniforms()
    n = 16
    world = np.asarray(_world_grid(juni, n))
    normal = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32), (n, n, 1))
    uni = port_uniforms(juni)
    hom = np.concatenate([world + 0.01 * normal, np.ones((n, n, 1))], -1)
    clip = hom @ (np.asarray(juni.proj) @ np.asarray(juni.view)).T
    z_surface = clip[..., 2] / clip[..., 3]
    near, far = 0.1, 100.0
    d_surface = near * far / (far - z_surface * (far - near))
    d_stored = d_surface.mean() - 0.03
    z_stored = far * (d_stored - near) / (d_stored * (far - near))
    depth = np.full((n, n), z_stored, np.float32)
    dense = tcontact.compute_contact_shadow(T(world), T(normal), uni,
                                            T(depth))
    sparse = tcontact.compute_contact_shadow_sparse(
        T(world), T(normal), uni, T(depth), capacity=n * n)
    np.testing.assert_array_equal(t2n(sparse), t2n(dense))
    assert (t2n(dense) < 1.0).any()
    jsparse = jcontact.compute_contact_shadow_sparse(
        jnp.asarray(world), jnp.asarray(normal), juni, jnp.asarray(depth),
        capacity=n * n)
    assert frac_over(t2n(sparse), np.asarray(jsparse), 1e-2) <= 0.005


# ---------------------------------------------------------------------------
# Whole frames
# ---------------------------------------------------------------------------

def run_port(cfg, poses, scene):
    state = tf.init_frame_state(cfg, "cpu")
    out = []
    for p in poses:
        tcompact.reset_host_syncs()
        rgba, state, tri_id = tf.render_gltf_frame_ids(
            scene, port_params(p), state, cfg)
        out.append((t2n(rgba), state, t2n(tri_id), dict(tcompact.BRANCHES)))
    return out


def test_default_frames_match_jax_and_dense():
    """3 chained GltfConfig() frames (parked, orbit poses 1 and 2) at
    256x144 with 2048^2 maps: the port matches JAX under the gates of
    test_slice_matches_jax, and equals the port's dense frame bit for
    bit (tri_id, depth, rgba, history)."""
    jcfg = jax_config()
    scene = multimesh_jax_scene()
    tscene = port_scene(scene)
    params = multimesh_params()
    poses = [params, bench.orbit_params(params, 1),
             bench.orbit_params(params, 2)]
    frame = jf.compiled_gltf_frame(jcfg)
    main = _jax_main_raster(jcfg)
    jstate = jf.init_frame_state(jcfg)
    sparse = run_port(port_config(), poses, tscene)
    dense = run_port(port_dense_config(), poses, tscene)
    for i, pose in enumerate(poses):
        jid = np.asarray(main(scene, pose, jstate)[0])
        jrgba, jstate = frame(scene, pose, jstate)
        rgba, state, tri_id, branches = sparse[i]
        d_rgba, d_state, d_tri_id, _ = dense[i]
        # every default site ran once: five host syncs, sparse shadow taps
        assert sum(branches.values()) == 5, branches
        assert branches.get(("valid_blocks", True)) == 1, branches
        assert branches.get(("shadow_pairs", True)) == 1, branches
        np.testing.assert_array_equal(tri_id, d_tri_id)
        np.testing.assert_array_equal(t2n(state.prev_depth),
                                      t2n(d_state.prev_depth))
        np.testing.assert_array_equal(rgba, d_rgba)
        np.testing.assert_array_equal(t2n(state.shadow_history),
                                      t2n(d_state.shadow_history))

        jdepth = np.asarray(jstate.prev_depth)
        np.testing.assert_allclose(t2n(state.prev_depth), jdepth, rtol=0,
                                   atol=DEPTH_TOL)
        same = tri_id == jid
        assert (~same).mean() <= MAX_ZFIGHT_FRAC
        for got, want in ((rgba, np.asarray(jrgba)),
                          (t2n(state.shadow_history),
                           np.asarray(jstate.shadow_history))):
            diff = np.abs(got - want).max(-1)[same]
            assert (diff > GOLDEN_TOL).mean() <= GOLDEN_BAD_FRAC, (i, diff.max())
        assert int(state.frame_index) == int(jstate.frame_index) == i + 1


def test_tiny_capacities_take_every_dense_branch():
    """Capacities too small for this frame send every site to its dense
    branch, and the frame still equals the dense one bit for bit; the
    blocked back half's own overflow (valid blocks) leads to the dense 2D
    path with its sparse passes."""
    scene = port_scene(multimesh_jax_scene())
    params = multimesh_params()
    poses = [params, bench.orbit_params(params, 1)]
    dense = run_port(port_dense_config(), poses, scene)
    for cfg in (port_config(valid_block_capacity=8),
                port_config(shadow_pen_capacity=64, contact_capacity=64,
                            texture_block_capacity=1)):
        for i, (rgba, state, tri_id, branches) in enumerate(
                run_port(cfg, poses, scene)):
            np.testing.assert_array_equal(rgba, dense[i][0])
            np.testing.assert_array_equal(t2n(state.shadow_history),
                                          t2n(dense[i][1].shadow_history))
            if cfg.valid_block_capacity == 8:
                assert branches[("valid_blocks", False)] == 1
                assert ("shadow_pairs", True) in branches
            else:
                for site in ("shadow_pairs", "contact", "texture_blocks"):
                    assert branches[(site, False)] == 1, (site, branches)


def test_check_supported_accepts_defaults():
    """The shipped configuration, with every knob the autotuner sets, now
    also runs with the light-space ground evaluation, which the port
    refused before: one frame of it at 256x144 with GltfConfig()'s 2048^2
    maps builds a light map for each window and renders finite pixels."""
    from funky_tpu_torch.passes import shadow_lightspace as tlsm

    shipped = dataclasses.replace(
        tf.GltfConfig(width=W, height=H), flags=tf.GltfFrameFlags(
            committed=True, synth_shadow_maps=True,
            light_space_ground_shadows=True),
        shadow_tap_windows=(384, 0, 0, 0), valid_slab_rows=64,
        taa_need_capacity=4096, shadow_route_windows=(256, 256, 0, 0),
        shadow_route_caps=(1024, 1024, 0, 0),
        shadow_lit_cascade_caps=(1024, 1024, 0, 0),
        shadow_pen_cascade_caps=(1024, 1024, 1024, 1024),
        shadow_pen_block_capacity=256, contact_block_capacity=256,
        contact_window=256, light_window_sizes=(256, 256, 128, 0),
        light_pcf_rungs=2)
    scene = port_scene(multimesh_jax_scene())
    built = []
    build = tlsm.build_light_shadow_map
    tlsm.build_light_shadow_map = (
        lambda *a, **k: built.append(a[5]) or build(*a, **k))
    try:
        rgba, _ = tf.render_gltf_frame(scene, port_params(multimesh_params()),
                                       tf.init_frame_state(shipped, "cpu"),
                                       shipped)
    finally:
        tlsm.build_light_shadow_map = build
    assert built == [256, 256, 128]
    assert rgba.shape == (H, W, 4) and np.isfinite(t2n(rgba)).all()
