"""Port parity: the light-space ground evaluation
(funky_tpu_torch/passes/shadow_lightspace.py: ground_constants,
biased_ground_planes, build_light_shadow_map) and the sparse filter's
light-map fetch groups and back-face skip (passes/shadow_filter.py), against
funky_tpu's.

Tolerances and why:
- build_light_shadow_map against JAX run op by op (as the JAX package's own
  tests/test_lightspace.py runs it) on that test's sloped plane and ramp
  blocker: within 2.4e-7 (measured 1.2e-7, one ulp of 1) on at most 2% of
  the texels (measured 0.7%), the kernel radius equal. torch and XLA round
  the Vogel angles' sin/cos, the rung radii's exp/log and the rotation's
  IGN apart by an ulp; a tap shift then flips only where an offset lands
  on an integer, which none does here.
- ground_constants: equal. biased_ground_planes: within 4e-6 per
  coefficient (measured 1.2e-6): torch's and XLA's LU solves of the 3x3
  fit round apart, and a light nearly along one uv axis leaves that
  coefficient near 1e-7. A receiver moves by at most the sum, against a
  depth bias of 8e-4.
- the sparse filter with light maps or the back-face skip against JAX's on
  the same inputs (a 480x272 frame with 1024^2 maps, the port's own light
  maps handed to both): v, m1, m2 within 5e-4 on all but 0.2% of covered
  pixels, the tap tolerance of tests/test_torch_shipped.py; fetched values
  are copies of the same rows.
- whole frames: the slice gates (tests/test_torch_shadow_scale.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.passes import shadow_classify as jcls
from funky_tpu.passes import shadow_filter as jsf
from funky_tpu.passes import shadow_lightspace as jlsm
from funky_tpu.passes.uniforms import FrameUniforms as JUniforms

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import compact as tcompact
from funky_tpu_torch.ops.sampling import quad_pack
from funky_tpu_torch.passes import shadow as tshadow
from funky_tpu_torch.passes import shadow_filter as tsf
from funky_tpu_torch.passes import shadow_lightspace as tlsm
from funky_tpu_torch.passes.deferred import pixel_centers
from funky_tpu_torch.utils import diagnostics as td

from .test_lightspace import BIAS, S as LS, _mk_uni, _scene
from .test_torch_shadow_scale import (H, S, W, assert_frames_match_jax,
                                      frame_poses, jax_config, port_config,
                                      roomy)
from .torch_parity import (faceted_jax_scene, port_params, port_scene,
                           port_uniforms, t2n)

LIGHT_SIZES = (256, 256, 128, 128)


def T(x):
    return torch.from_numpy(np.array(x))


def origin_of(oy, ox):
    return (torch.tensor(oy, dtype=torch.int32),
            torch.tensor(ox, dtype=torch.int32))


def port_map(raw, plane, uni, use_pcss, origin=(0, 0), wc=LS, phases=1):
    rows = tlsm.build_light_shadow_map(
        T(raw), origin_of(*origin), T(plane), port_uniforms(uni, "cpu"),
        use_pcss, wc, 4.0, torch.tensor(BIAS, dtype=torch.float32), 6,
        phases)
    assert rows.shape == (wc * wc, 4) and rows.is_contiguous()
    return t2n(rows).reshape(wc, wc, 4)


# ---------------------------------------------------------------------------
# build_light_shadow_map and its frame constants
# ---------------------------------------------------------------------------

CASES = {
    "pcf_vogel": (3.0, False, 1),     # radius 3 > 1.25: 16 Vogel taps
    "pcf_3x3": (1.0, False, 1),       # radius 1: the 3x3 kernel
    "pcss": (2.5, True, 1),
    "pcss_phases4": (2.5, True, 4),   # the frame's phase checkerboard
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_light_shadow_map_matches_jax(case):
    softness, use_pcss, phases = CASES[case]
    uni = _mk_uni(softness)
    plane, raw, _ = _scene()
    want = np.asarray(jlsm.build_light_shadow_map(
        raw, (jnp.int32(0), jnp.int32(0)), plane, uni, use_pcss, LS,
        max_softness=4.0, bias=jnp.float32(BIAS), rungs=6,
        phases=phases)).reshape(LS, LS, 4)
    got = port_map(raw, plane, uni, use_pcss, phases=phases)
    diff = np.abs(got - want).max(-1)
    assert diff.max() <= 2.4e-7 and (diff > 0).mean() <= 0.02, (
        diff.max(), (diff > 0).mean())
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_array_equal(got[..., 3], 1.0)
    # the ramp blocker casts: shadowed and lit texels both
    assert got[..., 0].min() < 0.2 and got[..., 0].max() == 1.0


def test_subwindow_matches_full():
    """A (64, 64) window at (24, 40) equals that region of the full
    window's map bit for bit with the four phases on: the checkerboard
    keys off global texel parity (tests/test_lightspace.py:141-150)."""
    uni = _mk_uni(2.5)
    plane, raw, _ = _scene()
    full = port_map(raw, plane, uni, True, phases=4)
    oy, ox, wc = 24, 40, 64
    sub = port_map(raw, plane, uni, True, origin=(oy, ox), wc=wc, phases=4)
    np.testing.assert_array_equal(sub, full[oy:oy + wc, ox:ox + wc])


@pytest.fixture(scope="module")
def frame_inputs():
    """A light-space frame's back-half inputs at orbit pose 1 on the
    faceted scene (480x272, 1024^2 maps, full cascade raster): the port's
    uniforms, maps, class maps, G-buffer and its light maps on LIGHT_SIZES
    windows, in both packages' types."""
    scene = port_scene(faceted_jax_scene())
    cfg = dataclasses.replace(
        port_config(roomy(jax_config(light_space_ground_shadows=True))),
        light_window_sizes=LIGHT_SIZES)
    pose = port_params(frame_poses(faceted=True)[1])
    state = tf.init_frame_state(cfg, "cpu")
    uni, cmaps, g, normal, ndl, vdepth, _, world_v = \
        td._frame_intermediates(scene, pose, state, cfg)
    raw = tshadow.render_shadow_maps(
        world_v, scene.tri_indices, scene.num_triangles,
        uni.light_view_proj, cfg.shadow_raster, S)
    origins, _ = tlsm.plan_windows(uni, world_v, scene.vert_object,
                                   LIGHT_SIZES, S, cfg.max_softness,
                                   cfg.class_coarse)
    rows, _, sizes, caps = tf._light_maps(raw, uni, cfg, origins)
    frag = torch.stack(pixel_centers(H, W, 0, "cpu"), dim=-1)
    port = (uni, quad_pack(raw), cmaps, g.world, normal, ndl, vdepth, frag)
    juni = JUniforms(**{f: jnp.asarray(t2n(getattr(uni, f)))
                        for f in uni._fields})
    jcmaps = jcls.ShadowClassMaps(
        cell_rows=jnp.asarray(t2n(cmaps.cell_rows)),
        planes=jnp.asarray(t2n(cmaps.planes)), size=cmaps.size,
        coarse=cmaps.coarse, max_softness=cmaps.max_softness)
    jax_args = (juni, jnp.asarray(t2n(port[1])), jcmaps) + tuple(
        jnp.asarray(t2n(a)) for a in port[3:])
    jlight = (tuple(jnp.asarray(t2n(r)) for r in rows),
              tuple((jnp.int32(int(o[0])), jnp.int32(int(o[1])))
                    for o in origins), sizes, caps)
    return dict(port=port, jax=jax_args, valid=g.valid, uni=uni,
                juni=juni, light=(rows, origins, sizes, caps),
                jlight=jlight, ndl=ndl, cap=2 * W * H)


def test_ground_constants_and_planes_match_jax(frame_inputs):
    """The frame's ground constants and biased planes against JAX's from
    the same uniforms."""
    uni, juni = frame_inputs["uni"], frame_inputs["juni"]
    got = tlsm.ground_constants(uni)
    want = jlsm.ground_constants(juni)
    for a, b in zip(got, want):
        assert t2n(a) == np.asarray(b)
    planes = tlsm.biased_ground_planes(uni.light_view_proj,
                                       tlsm.GROUND_Y + got[1])
    jplanes = jlsm.biased_ground_planes(juni.light_view_proj,
                                        jlsm.GROUND_Y + want[1])
    np.testing.assert_allclose(t2n(planes), np.asarray(jplanes), rtol=0,
                               atol=4e-6)
    # the biased plane lies below the classification plane of y = 0
    from funky_tpu_torch.passes.shadow_classify import light_ground_planes
    assert not np.array_equal(t2n(planes),
                              t2n(light_ground_planes(uni.light_view_proj)))


def filter_pair(d, **kw):
    """(port, JAX) cascaded_shadow_sparse on the frame inputs, cond'd,
    with the keyword arguments the port takes."""
    valid = d["valid"]
    tcompact.reset_host_syncs()
    got, *_ = tsf.cascaded_shadow_sparse(*d["port"], True, valid, d["cap"],
                                         **kw)
    assert tcompact.BRANCHES[("shadow_pairs", True)] == 1
    jkw = dict(kw)
    if "light_maps" in jkw:
        jkw["light_maps"] = d["jlight"]
    want, *_ = jsf.cascaded_shadow_sparse(
        *d["jax"], True, jnp.asarray(t2n(valid)), d["cap"], **jkw)
    return got, want


def assert_close_on_covered(got, want, valid):
    v = t2n(valid)
    for name in ("v", "m1", "m2"):
        diff = np.abs(t2n(getattr(got, name))[v]
                      - np.asarray(getattr(want, name))[v])
        assert (diff > 5e-4).mean() <= 0.002, (name, diff.max())


def test_filter_with_light_maps_matches_jax(frame_inputs):
    """With light maps the needed ground entries inside a window read one
    row of its map (the fetch groups, non-empty on every window of cascades
    0 and 1): the port's filter against JAX's on the same inputs and maps,
    and against its own filter without them, which differs only on the
    ground."""
    d = frame_inputs
    got, want = filter_pair(d, light_maps=d["light"])
    assert_close_on_covered(got, want, d["valid"])
    uni, _, cmaps, world, normal, ndl, vdepth, frag = d["port"]
    st = tsf.classify_stats(uni, cmaps, world, normal, ndl, vdepth, frag,
                            True, d["valid"],
                            light_windows=d["light"][1:3])
    fetch = t2n(st["light_fetch_per_cascade"])
    assert fetch[0] > 0 and fetch[1] > 0, fetch
    plain, *_ = tsf.cascaded_shadow_sparse(*d["port"], True, d["valid"],
                                           d["cap"])
    changed = t2n((got.v != plain.v) & d["valid"])
    ground = np.abs(t2n(world[..., 1])) < 1e-4
    assert changed.any() and not (changed & ~ground).any()


def test_filter_skip_backfacing_matches_jax(frame_inputs):
    """skip_backfacing: the port's filter against JAX's on the same inputs;
    the skipped back-facing entries keep the lit placeholder, and nothing
    else moves against the filter without the skip."""
    d = frame_inputs
    got, want = filter_pair(d, skip_backfacing=True)
    assert_close_on_covered(got, want, d["valid"])
    plain, *_ = tsf.cascaded_shadow_sparse(*d["port"], True, d["valid"],
                                           d["cap"])
    back = t2n(d["valid"] & (d["ndl"] <= 0.0))
    changed = t2n(got.v != plain.v)
    assert back.any() and changed.any() and not (changed & ~back).any()
    np.testing.assert_array_equal(t2n(got.v)[changed], 1.0)


def test_light_space_frames_match_jax(monkeypatch):
    """light_space_ground_shadows with synthesized maps on the faceted
    scene, small light windows and two PCF rungs (as the trio test in
    tests/test_torch_shadow_scale.py, for XLA's compile time): two chained
    frames meet the slice gates against JAX's, with the fetch groups
    engaged on the sparse path."""
    jcfg = dataclasses.replace(
        roomy(jax_config(light_space_ground_shadows=True,
                         synth_shadow_maps=True)),
        light_window_sizes=LIGHT_SIZES, light_pcf_rungs=2)
    fetched = []
    fetchable = tsf._fetchable

    def count(*args):
        mask = fetchable(*args)
        fetched.append(int(mask.sum()))
        return mask

    monkeypatch.setattr(tsf, "_fetchable", count)
    tcompact.reset_host_syncs()
    assert_frames_match_jax(jcfg, monkeypatch, faceted=True)
    assert tcompact.BRANCHES[("shadow_pairs", False)] == 0
    assert sum(fetched) > 1000, fetched


def test_biased_planes_take_a_device_height():
    """biased_ground_planes solves with the plane height as a tensor (the
    frame's ground offset) and equals the classification planes at y = 0
    for a zero offset."""
    from funky_tpu_torch.passes.shadow_classify import light_ground_planes

    uni = port_uniforms(bench_uniforms(), "cpu")
    got = tlsm.biased_ground_planes(uni.light_view_proj,
                                    torch.zeros((), dtype=torch.float32))
    np.testing.assert_array_equal(
        t2n(got), t2n(light_ground_planes(uni.light_view_proj)))


def bench_uniforms():
    """JAX's uniforms of the faceted scene's parked frame."""
    import funky_tpu.frame as jf

    jcfg = jax_config()
    return jf.compute_frame_uniforms(frame_poses(faceted=True)[0],
                                     jf.init_frame_state(jcfg), jcfg)

