"""Port parity: the frame passes (funky_tpu_torch/passes/*.py) against
funky_tpu's, each fed the SAME inputs — the JAX frame's own intermediates
at an orbit pose of the multimesh scene, carried across as numpy.

Tolerances and why:
- uniforms / geometry / deferred / shading: smooth float math, compared
  to 1e-5 (relative where values are large). The packages round
  differently only where XLA on the CPU contracts a*b + c into an FMA or
  sums in another order: a few ulps. Deferred attributes are compared on
  covered pixels: sky pixels extrapolate triangle 0's planes far outside
  it (large cancelling values) and every consumer masks them.
- shadow maps: depth 1e-5, as the raster (tests/test_torch_raster.py).
- shadow filter, TAA, contact: continuous in the tap positions between
  compare flips. An ulp in a light-space uv moves a bilinear compare
  weight by ulp x map size, and sin/cos of the Vogel angles round
  differently in XLA and torch. Measured on this frame: PCSS within
  2.6e-5, PCF within 2.5e-4, contact within 4.6e-3, TAA within 1e-5, with
  no compare flip. The checks allow those bounds with margin, and a
  small fraction of pixels beyond them for flips (one of 16 taps, or one
  march hit, changes the value by much more).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import funky_tpu.frame as jf
from funky_tpu.ops.sampling import quad_pack as jquad_pack
from funky_tpu.passes import contact as jcontact
from funky_tpu.passes import deferred as jdeferred
from funky_tpu.passes import geometry as jgeometry
from funky_tpu.passes import shading as jshading
from funky_tpu.passes import shadow as jshadow
from funky_tpu.passes import shadow_filter as jsf
from funky_tpu.passes import taa as jtaa

import funky_tpu_torch.frame as tf
from funky_tpu_torch.passes import contact as tcontact
from funky_tpu_torch.passes import deferred as tdeferred
from funky_tpu_torch.passes import geometry as tgeometry
from funky_tpu_torch.passes import shading as tshading
from funky_tpu_torch.passes import shadow as tshadow
from funky_tpu_torch.passes import shadow_filter as tsf
from funky_tpu_torch.passes import taa as ttaa

from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, port_state,
                           port_uniforms, slice_configs, t2n)


def frac_over(a, b, tol):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > tol).mean())


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def ref():
    """The JAX frame's intermediates at orbit pose 1, after one parked
    frame (so TAA and contact have a real history and previous depth)."""
    jcfg, tcfg = slice_configs()
    scene = multimesh_jax_scene()
    params = multimesh_params()
    state = jf.init_frame_state(jcfg)
    _, state = jf.compiled_gltf_frame(jcfg)(scene, params, state)
    pose = bench.orbit_params(params, 1)
    flags = jcfg.flags

    @jax.jit
    def intermediates(scene, p, st):
        uni = jf.compute_frame_uniforms(p, st, jcfg)
        world, clip, nrm = jgeometry.transform_vertices(
            scene, uni.models, uni.view_proj)
        blocks = jgeometry.build_shade_blocks(scene, world, clip, nrm)
        raw = jshadow.render_shadow_maps(
            world, scene.tri_indices, scene.num_triangles,
            uni.light_view_proj, jcfg.shadow_raster, jcfg.shadow_map_size)
        maps = jax.vmap(jquad_pack)(raw)
        tri_clip, blocks_m, flags_m, valid = jf._main_raster_inputs(
            scene, clip, blocks, jcfg.clip_capacity)
        from funky_tpu.ops.raster import raster_corners
        tri_id, depth, setup = raster_corners(tri_clip, valid, jcfg.width,
                                              jcfg.height, jcfg.raster)
        g = jdeferred.interpolate(tri_id, depth, setup.data, blocks_m,
                                  flags_m)
        normal = g.normal / jnp.maximum(
            jnp.linalg.norm(g.normal, axis=-1, keepdims=True), 1e-12)
        ndl = jnp.maximum(jnp.sum(normal * uni.light_dir, axis=-1), 0.0)
        vdepth = -((g.world @ uni.view[2, :3].T) + uni.view[2, 3])
        h, w = tri_id.shape
        frag = jnp.stack([
            jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None] + 0.5,
                             (h, w)),
            jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None]
                             + 0.5, (h, w))], axis=-1)
        pcss = jsf.cascaded_shadow(uni, maps, g.world, normal, ndl, vdepth,
                                   frag, True)
        pcf = jsf.cascaded_shadow(uni, maps, g.world, normal, ndl, vdepth,
                                  frag, False)
        shadow_term, hist = jtaa.apply_shadow_taa(
            pcss[0], g.world, uni, st.shadow_history, True, 0, jcfg.height)
        ct = jcontact.compute_contact_shadow(g.world, normal, uni,
                                             st.prev_depth)
        rgba = jshading.shade_gltf(
            g, scene.texture, scene.texture_sizes, uni.camera_pos,
            uni.light_dir, jnp.minimum(shadow_term, ct),
            jnp.asarray(jf.GLTF_CLEAR, jnp.float32))
        return dict(uni=uni, world=world, clip=clip, nrm=nrm, blocks=blocks,
                    raw=raw, maps=maps, tri_id=tri_id, depth=depth,
                    setup=setup.data, blocks_m=blocks_m, flags_m=flags_m,
                    gbuf=g, normal=normal, ndl=ndl, vdepth=vdepth, frag=frag,
                    pcss=pcss, pcf=pcf, shadow_term=shadow_term, hist=hist,
                    contact=ct, rgba=rgba)

    out = intermediates(scene, pose, state)
    assert flags.use_pcss
    return dict(out, jcfg=jcfg, tcfg=tcfg, scene=scene, pose=pose,
                state=state)


def T(x):
    return torch.from_numpy(np.array(x))


def port_gbuf(g):
    return tdeferred.GBuffer(*(T(x) for x in g))


def test_uniforms(ref):
    uni = tf.compute_frame_uniforms(port_params(ref["pose"]),
                                    port_state(ref["state"]), ref["tcfg"])
    for name in uni._fields:
        close(t2n(getattr(uni, name)), getattr(ref["uni"], name), 1e-5)


def test_geometry(ref):
    scene = port_scene(ref["scene"])
    uni = port_uniforms(ref["uni"])
    world, clip, nrm = tgeometry.transform_vertices(scene, uni.models,
                                                    uni.view_proj)
    close(t2n(world), ref["world"], 1e-5)
    close(t2n(clip), ref["clip"], 1e-5)
    close(t2n(nrm), ref["nrm"], 1e-5)
    blocks = tgeometry.build_shade_blocks(scene, T(ref["world"]),
                                          T(ref["clip"]), T(ref["nrm"]))
    close(t2n(blocks), ref["blocks"], 1e-5)


def test_shadow_maps(ref):
    scene = port_scene(ref["scene"])
    cfg = ref["tcfg"]
    raw = tshadow.render_shadow_maps(
        T(ref["world"]), scene.tri_indices, scene.num_triangles,
        T(ref["uni"].light_view_proj), cfg.shadow_raster,
        cfg.shadow_map_size)
    np.testing.assert_allclose(t2n(raw), np.asarray(ref["raw"]), rtol=0,
                               atol=1e-5)
    assert (t2n(raw) < 1.0).mean() > 0.1     # the maps hold geometry


def test_deferred(ref):
    g = tdeferred.interpolate(T(ref["tri_id"]), T(ref["depth"]),
                              T(ref["setup"]), T(ref["blocks_m"]),
                              T(ref["flags_m"]))
    jg = ref["gbuf"]
    for name in ("valid", "flags", "depth"):
        np.testing.assert_array_equal(t2n(getattr(g, name)),
                                      np.asarray(getattr(jg, name)))
    valid = np.asarray(jg.valid)
    assert valid.mean() > 0.3
    for name in ("world", "normal", "uv", "color"):
        close(t2n(getattr(g, name))[valid],
              np.asarray(getattr(jg, name))[valid], 1e-5)


@pytest.mark.parametrize("use_pcss", [True, False], ids=["pcss", "pcf"])
def test_shadow_filter(ref, use_pcss):
    res, c0, c1, t = tsf.cascaded_shadow(
        port_uniforms(ref["uni"]), T(ref["maps"]), T(ref["gbuf"].world),
        T(ref["normal"]), T(ref["ndl"]), T(ref["vdepth"]), T(ref["frag"]),
        use_pcss)
    jres, jc0, jc1, jt = ref["pcss" if use_pcss else "pcf"]
    valid = np.asarray(ref["gbuf"].valid)
    np.testing.assert_array_equal(t2n(c0)[valid], np.asarray(jc0)[valid])
    np.testing.assert_array_equal(t2n(c1)[valid], np.asarray(jc1)[valid])
    close(t2n(t)[valid], np.asarray(jt)[valid], 1e-5)
    for name in jres._fields:
        a = t2n(getattr(res, name))[valid]
        b = np.asarray(getattr(jres, name))[valid]
        assert frac_over(a, b, 5e-4) <= 0.002, name
    assert (t2n(res.v)[valid] < 1.0).mean() > 0.05   # real shadow present


def test_taa(ref):
    jres = ref["pcss"][0]
    out, hist = ttaa.apply_shadow_taa(
        tsf.ShadowResult(*(T(x) for x in jres)), T(ref["gbuf"].world),
        port_uniforms(ref["uni"]), T(ref["state"].shadow_history), True, 0,
        ref["tcfg"].height)
    assert frac_over(t2n(out), ref["shadow_term"], 1e-5) <= 0.002
    assert frac_over(t2n(hist), ref["hist"], 1e-5) <= 0.002


def test_contact(ref):
    ct = tcontact.compute_contact_shadow(
        T(ref["gbuf"].world), T(ref["normal"]), port_uniforms(ref["uni"]),
        T(ref["state"].prev_depth))
    valid = np.asarray(ref["gbuf"].valid)
    assert frac_over(t2n(ct)[valid], np.asarray(ref["contact"])[valid],
                     1e-2) <= 0.005
    assert (t2n(ct)[valid] < 1.0).any()      # some rays really hit


def test_shading(ref):
    uni = port_uniforms(ref["uni"])
    scene = port_scene(ref["scene"])
    shadow = torch.minimum(T(ref["shadow_term"]), T(ref["contact"]))
    rgba = tshading.shade_gltf(
        port_gbuf(ref["gbuf"]), scene.texture, scene.texture_sizes,
        uni.camera_pos, uni.light_dir, shadow,
        torch.tensor(tf.GLTF_CLEAR, dtype=torch.float32))
    close(t2n(rgba), ref["rgba"], 1e-5)


def test_cascade_debug_color(ref):
    jres, c0, c1, t = ref["pcss"]
    g = ref["gbuf"]
    bg = jnp.asarray(jf.GLTF_CLEAR, jnp.float32)
    want = jshading.cascade_debug_color(g, c0, c1, t, jres.v, bg)
    got = tshading.cascade_debug_color(port_gbuf(g), T(c0), T(c1), T(t),
                                       T(jres.v), T(bg))
    close(t2n(got), want, 1e-6)


def test_frame_flag_variants_match_jax():
    """The flag variants the port honours (PCF, no TAA, no shadows, no
    contact, cascade debug view) through whole chained frames: the image
    stays within the golden tolerance of JAX's (3/255 on at most 0.2% of
    pixels, tests/test_goldens.py)."""
    jcfg0, tcfg0 = slice_configs()
    scene = multimesh_jax_scene()
    tscene = port_scene(scene)
    params = multimesh_params()
    for variant in (dict(use_pcss=False), dict(use_shadow_taa=False),
                    dict(enable_shadows=False),
                    dict(enable_contact_shadows=False),
                    dict(debug_cascades=True)):
        jcfg = dataclasses.replace(
            jcfg0, flags=dataclasses.replace(jcfg0.flags, **variant))
        tcfg = dataclasses.replace(
            tcfg0, flags=dataclasses.replace(tcfg0.flags, **variant))
        jstate = jf.init_frame_state(jcfg)
        tstate = tf.init_frame_state(tcfg)
        frame = jf.compiled_gltf_frame(jcfg)
        for _ in range(2):
            jr, jstate = frame(scene, params, jstate)
            tr, tstate = tf.render_gltf_frame(tscene, port_params(params),
                                              tstate, tcfg)
        diff = np.abs(t2n(tr) - np.asarray(jr)).max(-1)
        assert (diff > 3 / 255).mean() <= 2e-3, variant
