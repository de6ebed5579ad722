"""Port parity: the public helpers the JAX package exports beside the
frame path (funky_tpu/ops/__init__.py's `rasterize`, the samplers of
ops/sampling.py, math3d's vector, quaternion and matrix helpers, and
passes/shadow_filter.py::vogel_disk), on seeded numpy inputs, mirroring
tests/test_sampling.py, tests/test_math3d.py and tests/test_shadow_filter.py.

JAX runs op by op (jit disabled, or eager jnp calls): XLA then fuses
nothing and contracts no FMA, so arithmetic, compares and gathers are
bit for bit. Tolerances where they are not:
- sin, cos and sqrt: within 2 ulps of 1 (4.8e-7 absolute), XLA's and
  torch's CPU implementations round apart (vogel_disk, the quaternions
  from angles);
- `dot` and `transform_vector`: 3-term sums whose order (and FMA use)
  the two libraries choose (within 1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu import math3d as jm3
from funky_tpu.ops import binning as jbin
from funky_tpu.ops import rasterize as jrasterize
from funky_tpu.ops import sampling as js
from funky_tpu.ops.raster import RasterConfig as JRC
from funky_tpu.passes import shadow_filter as jsf

from funky_tpu_torch import math3d as tm3
from funky_tpu_torch.ops import rasterize as trasterize
from funky_tpu_torch.ops import sampling as ts
from funky_tpu_torch.ops.raster import RasterConfig as TRC
from funky_tpu_torch.passes import shadow_filter as tsf

from .torch_parity import t2n
from .torch_scenes import random_clip_scene

TRIG_TOL = 2 * np.finfo(np.float32).eps


def rng(seed):
    return np.random.default_rng(seed)


def uvs(shape, seed):
    """uv in [-0.2, 1.2] plus a few NaN / inf / huge coordinates."""
    u = rng(seed).uniform(-0.2, 1.2, shape + (2,)).astype(np.float32)
    flat = u.reshape(-1, 2)
    flat[:4] = [[np.nan, 0.5], [0.5, np.inf], [-np.inf, 1e12], [3e9, -3e9]]
    return u


def T(a):
    return torch.from_numpy(np.array(a))


def bits_equal(t, j):
    np.testing.assert_array_equal(t2n(t), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_matches_jax(seed):
    """ops.rasterize on one set of pre-gathered bins: tri_id and depth bit
    for bit against JAX's jnp raster run op by op, for the full frame and
    a row slab at y_offset 16."""
    clip, tris = random_clip_scene(seed=seed, n_tris=50)
    for y0, h in ((0, 64), (16, 32)):
        jcfg = JRC(tile_h=8, tile_w=128, backend="jnp")
        setup = jbin.triangle_setup(jnp.asarray(clip), jnp.asarray(tris),
                                    128, 64, len(tris))
        bins, counts = jbin.bin_triangles(setup, 128, h, 8, 128, len(tris),
                                          y0)
        data = jbin.gather_bin_data(setup, bins)
        with jax.disable_jit():
            jid, jz = jrasterize(data, bins, counts, 128, h, jcfg, y0)
        tid, tz = trasterize(T(data), T(bins), T(counts), 128, h,
                             TRC(tile_h=8, tile_w=128), y0)
        assert tid.shape == (h, 128) and (t2n(tid) >= 0).any()
        bits_equal(tid, jid)
        bits_equal(tz, jz)


SAMPLERS = ("bilinear_repeat", "shadow_compare", "bilinear_border",
            "bilinear_border_packed", "shadow_compare_array",
            "bilinear_border_array")


@pytest.mark.parametrize("name", SAMPLERS)
def test_samplers_match_jax(name):
    """Each sampler on seeded maps, layers, reference depths and uvs
    (out-of-range, NaN and infinite ones among them): bit for bit."""
    r = rng(7)
    uv = uvs((5, 33), seed=3)
    maps = r.uniform(0, 1, (3, 16, 16)).astype(np.float32)
    layer = r.integers(0, 3, (5, 33)).astype(np.int32)
    ref = r.uniform(0, 1, (5, 33)).astype(np.float32)
    tex = r.uniform(0, 1, (12, 20, 3)).astype(np.float32)
    args = {
        "bilinear_repeat": (tex, uv),
        "shadow_compare": (maps[1], uv, ref),
        "bilinear_border": (maps[2], uv, 0.25),
        "bilinear_border_packed": (np.asarray(jax.vmap(js.quad_pack)(
            jnp.asarray(maps))), layer, uv, 0.5),
        "shadow_compare_array": (maps, layer, uv, ref),
        "bilinear_border_array": (maps, layer, uv, 0.75),
    }[name]
    want = getattr(js, f"sample_{name}")(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    got = getattr(ts, f"sample_{name}")(
        *(T(a) if isinstance(a, np.ndarray) else a for a in args))
    assert got.shape == want.shape
    bits_equal(got, want)


def _angles(seed, n=6):
    return rng(seed).uniform(-4, 4, n).astype(np.float32)


def test_cross_and_dot_match_jax():
    a = rng(1).normal(size=(7, 3)).astype(np.float32)
    b = rng(2).normal(size=(7, 3)).astype(np.float32)
    bits_equal(tm3.cross(T(a), T(b)), jm3.cross(jnp.asarray(a),
                                                jnp.asarray(b)))
    np.testing.assert_allclose(t2n(tm3.dot(T(a), T(b))),
                               np.asarray(jm3.dot(jnp.asarray(a),
                                                  jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)


def test_quaternions_match_jax():
    """quat_identity and quat_mul bit for bit, quat_from_rotation_z and
    quat_from_euler_yxz (composed in glam's order) within TRIG_TOL."""
    bits_equal(tm3.quat_identity("cpu"), jm3.quat_identity())
    for angle in _angles(3):
        np.testing.assert_allclose(
            t2n(tm3.quat_from_rotation_z(T(np.float32(angle)))),
            np.asarray(jm3.quat_from_rotation_z(angle)), rtol=0,
            atol=TRIG_TOL)
    qa = rng(4).normal(size=(5, 4)).astype(np.float32)
    qb = rng(5).normal(size=(5, 4)).astype(np.float32)
    bits_equal(tm3.quat_mul(T(qa), T(qb)),
               jm3.quat_mul(jnp.asarray(qa), jnp.asarray(qb)))
    for y, x, z in _angles(6, 9).reshape(3, 3):
        got = tm3.quat_from_euler_yxz(*(T(np.float32(v)) for v in (y, x, z)))
        np.testing.assert_allclose(
            t2n(got), np.asarray(jm3.quat_from_euler_yxz(y, x, z)), rtol=0,
            atol=TRIG_TOL)


def test_transform_vector_and_mat4_inverse_match_jax():
    """transform_vector (a 3-term product per element, within 1e-6
    relative, as `dot`) and mat4_inverse (bit for bit) on a random matrix
    and on a perspective view-projection (the cascade fit's input, whose
    far corners an LU inverse collapses); M @ inv(M) within 1e-5 of the
    identity."""
    m = rng(8).normal(size=(4, 4)).astype(np.float32)
    v = rng(9).normal(size=(6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t2n(tm3.transform_vector(T(m), T(v))),
        np.asarray(jm3.transform_vector(jnp.asarray(m), v)), rtol=1e-6,
        atol=1e-7)
    proj = np.asarray(jm3.perspective_rh(jnp.float32(0.8), 16 / 9, 0.1,
                                         100.0))
    view = np.asarray(jm3.look_at_rh(jnp.asarray([1.0, 2.5, 10.0]),
                                     jnp.asarray([0.0, 0.6, 0.0]),
                                     jnp.asarray([0.0, 1.0, 0.0])))
    for mat in (m, (proj @ view).astype(np.float32)):
        got = tm3.mat4_inverse(T(mat))
        bits_equal(got, jm3.mat4_inverse(jnp.asarray(mat)))
        np.testing.assert_allclose(t2n(T(mat) @ got), np.eye(4), atol=1e-5)


@pytest.mark.parametrize("count", [16, 32])
def test_vogel_disk_matches_jax(count):
    """Each tap of vogel_disk on a seeded phi field: within TRIG_TOL of
    JAX's, at radius sqrt((i + 0.5) / count) (tests/test_shadow_filter.py::
    test_vogel_disk_radii), and tap i of vogel_disk_all."""
    phi = rng(count).uniform(0, 2 * np.pi, (4, 9)).astype(np.float32)
    all_dx, all_dy = tsf.vogel_disk_all(count, T(phi))
    for i in range(count):
        dx, dy = tsf.vogel_disk(i, count, T(phi))
        jdx, jdy = jsf.vogel_disk(i, count, jnp.asarray(phi))
        for a, b in ((dx, jdx), (dy, jdy)):
            np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=0,
                                       atol=TRIG_TOL)
        np.testing.assert_allclose(t2n(torch.hypot(dx, dy)),
                                   np.sqrt((i + 0.5) / count), atol=1e-6)
        np.testing.assert_allclose(t2n(dx), t2n(all_dx[i]), atol=TRIG_TOL)
        np.testing.assert_allclose(t2n(dy), t2n(all_dy[i]), atol=TRIG_TOL)
