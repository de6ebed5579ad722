"""Port parity: samplers, compaction and near-plane clipping
(funky_tpu_torch/ops/{sampling,compact,clipping}.py) against funky_tpu's.

Tolerance 1e-6 absolute: the samplers blend [0, 1]-range texels with
bilinear weights, and the only difference between the packages is XLA's
FMA contraction of `uv * size - 0.5`, an ulp in the weight. The uv sets
include out-of-range, NaN and infinite coordinates: JAX clamps gathers
and saturates float->int conversions, and the port must do the same
instead of raising or reading out of bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.ops import clipping as jclip
from funky_tpu.ops import compact as jcompact
from funky_tpu.ops import sampling as js
from funky_tpu.ops.raster import RasterConfig as JRC
from funky_tpu.ops.raster import raster_corners as jraster_corners

from funky_tpu_torch.ops import clipping as tclip
from funky_tpu_torch.ops import compact as tcompact
from funky_tpu_torch.ops import sampling as ts
from funky_tpu_torch.ops.raster import RasterConfig as TRC
from funky_tpu_torch.ops.raster import raster_corners as traster_corners

from .torch_parity import t2n

TOL = 1e-6


def rng(seed=0):
    return np.random.default_rng(seed)


def uvs(shape, seed=0):
    """uv in [-0.2, 1.2] plus a few NaN / inf / huge coordinates."""
    u = rng(seed).uniform(-0.2, 1.2, shape + (2,)).astype(np.float32)
    flat = u.reshape(-1, 2)
    flat[:4] = [[np.nan, 0.5], [0.5, np.inf], [-np.inf, 1e12], [3e9, -3e9]]
    return u


def T(a):
    return torch.from_numpy(np.array(a))


def check(t, j):
    np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=0, atol=TOL)


def test_to_i32_matches_xla_conversion():
    x = np.array([0.0, -0.5, 3.7, -3.7, 2.5e9, -2.5e9, np.nan, np.inf,
                  -np.inf, 2147483520.0, 2147483648.0], np.float32)
    np.testing.assert_array_equal(t2n(ts.to_i32(T(x))),
                                  np.asarray(jnp.asarray(x).astype(jnp.int32)))


def test_take_rows_clamps_like_jax_gather():
    table = rng().normal(size=(50, 4)).astype(np.float32)
    idx = np.array([[-5, 0, 49], [50, 1000, 7]], np.int32)
    check(ts.take_rows(T(table), T(idx)),
          js.take_rows(jnp.asarray(table), jnp.asarray(idx)))


def test_quad_packs_match():
    """quad_pack (a CPU tensor: its plain twin) and the twin by name, which
    is K11's oracle on the card, == JAX's, one map at a time."""
    img = rng().normal(size=(3, 9, 13)).astype(np.float32)
    want = np.stack([np.asarray(js.quad_pack(jnp.asarray(m))) for m in img])
    np.testing.assert_array_equal(t2n(ts.quad_pack(T(img))), want)
    np.testing.assert_array_equal(t2n(ts.quad_pack_plain(T(img))), want)
    tex = rng(1).normal(size=(2, 6, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        t2n(ts.quad_pack_nhwc(T(tex))),
        np.stack([np.asarray(js.quad_pack_nhwc(jnp.asarray(m)))
                  for m in tex]))


def test_shadow_compare_and_nearest_border_packed():
    maps = rng().uniform(0, 1, (4, 32, 32)).astype(np.float32)
    packed = np.stack([np.asarray(js.quad_pack(jnp.asarray(m)))
                       for m in maps])
    uv = uvs((16, 20, 24))
    layer = rng(2).integers(0, 4, (16, 20, 24)).astype(np.int32)
    ref = rng(3).uniform(0, 1, (16, 20, 24)).astype(np.float32)
    check(ts.sample_shadow_compare_packed(T(packed), T(layer), T(uv), T(ref)),
          js.sample_shadow_compare_packed(jnp.asarray(packed),
                                          jnp.asarray(layer),
                                          jnp.asarray(uv), jnp.asarray(ref)))
    check(ts.sample_nearest_border_packed(T(packed), T(layer), T(uv)),
          js.sample_nearest_border_packed(jnp.asarray(packed),
                                          jnp.asarray(layer),
                                          jnp.asarray(uv)))


def test_depth_dual_packed():
    depth = rng().uniform(0, 1, (24, 40)).astype(np.float32)
    packed = np.asarray(js.quad_pack(jnp.asarray(depth)))
    uv = uvs((8, 30, 20), seed=4)
    tb, tn = ts.sample_depth_dual_packed(T(packed), T(uv))
    jb, jn = js.sample_depth_dual_packed(jnp.asarray(packed), jnp.asarray(uv))
    check(tb, jb)
    check(tn, jn)


# (origin (oy, ox), window size): inside the map, against its far corner,
# and hanging off the map's edge, so that taps fall on both sides of the
# window and clamp to its edge.
WINDOWS = [((8, 4), 12), ((20, 20), 12), ((0, 24), 8)]


@pytest.mark.parametrize("origin,wc", WINDOWS)
def test_window_samplers(origin, wc):
    """The windowed shadow and depth samplers read a (wc, wc) window of
    the quad-packed map at a device-valued origin and equal JAX's for
    every tap, the ones clamped to the window's edge included."""
    maps = rng(5).uniform(0, 1, (32, 32)).astype(np.float32)
    packed = np.asarray(js.quad_pack(jnp.asarray(maps)))
    oy, ox = origin
    win = packed[oy:oy + wc, ox:ox + wc]
    uv = uvs((6, 20, 24), seed=6)
    ref = rng(7).uniform(0, 1, (6, 20, 24)).astype(np.float32)
    torg = (torch.tensor(oy, dtype=torch.int32),
            torch.tensor(ox, dtype=torch.int32))
    jorg = (jnp.int32(oy), jnp.int32(ox))
    check(ts.sample_shadow_compare_window(T(win), torg, 32, T(uv), T(ref)),
          js.sample_shadow_compare_window(jnp.asarray(win), jorg, 32,
                                          jnp.asarray(uv), jnp.asarray(ref)))
    check(ts.sample_nearest_border_window(T(win), torg, 32, T(uv)),
          js.sample_nearest_border_window(jnp.asarray(win), jorg, 32,
                                          jnp.asarray(uv)))
    for t, j in zip(ts.sample_depth_dual_window(T(win), torg, (32, 32),
                                                T(uv)),
                    js.sample_depth_dual_window(jnp.asarray(win), jorg,
                                                (32, 32), jnp.asarray(uv))):
        check(t, j)


@pytest.mark.parametrize("starts", [(3, 5), (-4, 2), (30, -40), (9, 9)])
@pytest.mark.parametrize("device_starts", [False, True],
                         ids=["host", "device"])
def test_dynamic_slices_clamp_like_jax(starts, device_starts):
    """dynamic_slice and dynamic_update_slice over the leading axes take
    JAX's start rule (negative counts from the end, then clamp to keep the
    slice in bounds), from Python ints and from 0-d device tensors."""
    x = rng(8).normal(size=(12, 10, 2)).astype(np.float32)
    upd = rng(9).normal(size=(4, 6, 2)).astype(np.float32)
    tstarts = tuple(torch.tensor(s, dtype=torch.int32) for s in starts) \
        if device_starts else starts
    jstarts = tuple(starts) + (0,)
    np.testing.assert_array_equal(
        t2n(ts.dynamic_slice(T(x), tstarts, (4, 6))),
        np.asarray(jax.lax.dynamic_slice(jnp.asarray(x), jstarts, (4, 6, 2))))
    np.testing.assert_array_equal(
        t2n(ts.dynamic_update_slice(T(x), T(upd), tstarts)),
        np.asarray(jax.lax.dynamic_update_slice(jnp.asarray(x),
                                                jnp.asarray(upd), jstarts)))


@pytest.mark.parametrize("channels", [None, 2])
def test_nearest_edge(channels):
    shape = (24, 40) if channels is None else (24, 40, channels)
    img = rng().normal(size=shape).astype(np.float32)
    uv = uvs((30, 20), seed=5)
    check(ts.sample_nearest_edge(T(img), T(uv)),
          js.sample_nearest_edge(jnp.asarray(img), jnp.asarray(uv)))


def test_bilinear_repeat_packed_layers():
    tex = rng().uniform(0, 1, (2, 4, 4, 4)).astype(np.float32)
    packed = np.stack([np.asarray(js.quad_pack_nhwc(jnp.asarray(m)))
                       for m in tex])
    sizes = np.array([[2.0, 2.0], [4.0, 4.0]], np.float32)
    uv = rng(6).uniform(-3, 3, (30, 20, 2)).astype(np.float32)
    uv.reshape(-1, 2)[:2] = [[np.nan, 0.5], [np.inf, -np.inf]]
    # layer 2 is out of range (zero size): both must survive it
    layer = rng(7).integers(0, 3, (30, 20)).astype(np.int32)
    check(ts.sample_bilinear_repeat_packed_layers(T(packed), T(sizes),
                                                  T(layer), T(uv)),
          js.sample_bilinear_repeat_packed_layers(
              jnp.asarray(packed), jnp.asarray(sizes), jnp.asarray(layer),
              jnp.asarray(uv)))


@pytest.mark.parametrize("capacity", [5, 64, 1000])
def test_compact_indices(capacity):
    mask = rng().uniform(size=(17, 23)) < 0.1
    t = tcompact.compact_indices(T(mask), capacity)
    j = jcompact.compact_indices(jnp.asarray(mask), capacity)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(t2n(a), np.asarray(b))


def near_crossing_scene(seed=0, n=48):
    """Random world triangles around a camera, many crossing its near
    plane, as (T, 3, 4) clip corners + (T, 3, 12) shade blocks."""
    r = rng(seed)
    world = r.uniform([-3, -2, -4], [3, 2, 1.5], (n, 3, 3)).astype(np.float32)
    f, near, far = 1.0 / np.tan(0.4), 0.1, 100.0
    proj = np.array([[f, 0, 0, 0], [0, -f, 0, 0],
                     [0, 0, far / (near - far), far * near / (near - far)],
                     [0, 0, -1, 0]], np.float32)
    hom = np.concatenate([world, np.ones((n, 3, 1), np.float32)], -1)
    clip = (hom @ proj.T).astype(np.float32)
    attrs = r.uniform(0, 1, (n, 3, 11)).astype(np.float32)
    inv_w = (1.0 / np.maximum(clip[..., 3:4], 1e-12)).astype(np.float32)
    blocks = np.concatenate([attrs, inv_w], -1)
    flags = r.integers(0, 3, n).astype(np.int32)
    return clip, blocks, flags


@pytest.mark.parametrize("capacity", [4, 64])
def test_expand_near_clipped(capacity):
    """Clipping on a scene that crosses the near plane (and overflows the
    small capacity): every output within 1e-6, and the rastered result of
    the clipped geometry identical."""
    clip, blocks, flags = near_crossing_scene()
    w_eps = 0.1 * 0.1
    j = jclip.expand_near_clipped(jnp.asarray(clip), jnp.asarray(blocks),
                                  jnp.asarray(flags), len(clip), capacity,
                                  w_eps)
    t = tclip.expand_near_clipped(T(clip), T(blocks), T(flags), len(clip),
                                  capacity, w_eps)
    w = clip[..., 3]
    assert ((w > w_eps).any(-1) & (w <= w_eps).any(-1)).sum() > 4
    for name in ("tri_flags", "valid", "overflow"):
        np.testing.assert_array_equal(t2n(getattr(t, name)),
                                      np.asarray(getattr(j, name)))
    check(t.tri_clip, j.tri_clip)
    check(t.blocks[..., :-1], j.blocks[..., :-1])
    # inv_w of a clipped corner is 1/w at w ~ w_eps = 0.01, where w is a
    # cancelling sum of the crossing edge's endpoints (|w| up to ~4): a few
    # ulps of those become a relative error of ~3e-6 in 1/w (measured).
    np.testing.assert_allclose(t2n(t.blocks[..., -1]),
                               np.asarray(j.blocks[..., -1]), rtol=1e-5,
                               atol=TOL)
    jid = jraster_corners(j.tri_clip, j.valid, 96, 64,
                          JRC(tile_h=16, tile_w=128, backend="jnp"))[0]
    tid = traster_corners(t.tri_clip, t.valid, 96, 64,
                          TRC(tile_h=16, tile_w=128))[0]
    np.testing.assert_array_equal(t2n(tid), np.asarray(jid))
