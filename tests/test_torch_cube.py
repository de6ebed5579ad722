"""Port parity: the rotating-cube frame (funky_tpu_torch/frame.py::
render_cube_frame, passes/shading.py::shade_cube and the math3d matrices
it builds) against funky_tpu's.

Tolerances and why:
- the main raster's depth within 1e-5 of jitted JAX (measured up to
  6.3e-6) where the tri_id agrees: XLA contracts the triangle setup and
  plane evaluation into FMAs, torch never does, so 1e-6 is too tight
  (ROADMAP queue 3). The tri_id is equal at the golden's configuration;
  elsewhere a pixel centre on the edge between two faces can resolve the
  other way: measured 0-4 such pixels per 512x512 frame over 30
  rotations, 0-1 per 128x128 frame, each on a face edge or the
  silhouette (some at a sliver of a face seen edge-on). The gate allows 4.
- rgba within 1e-5 of JAX where the tri_id agrees (measured 2.4e-7).
- the image within the golden tolerance (3/255 on at most 0.2% of
  pixels, tests/test_goldens.py:14-15) of tests/goldens/cube_r06_128.png.
- math3d matrices and shade_cube within 1e-6 of JAX (f32 rounding of the
  same expressions; XLA may contract).
- the analytic checks of tests/test_cube_frame.py with its tolerances.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funky_tpu.frame as jf
from funky_tpu import math3d as jm3
from funky_tpu.models.scene import build_cube_scene as jcube
from funky_tpu.ops.raster import RasterConfig as JRC
from funky_tpu.passes import shading as jshading
from funky_tpu.passes.deferred import GBuffer as JGBuffer

import funky_tpu_torch.frame as tf
from funky_tpu_torch import math3d as tm3
from funky_tpu_torch.models.png_io import linear_to_srgb, read_png
from funky_tpu_torch.models.scene import build_cube_scene as tcube
from funky_tpu_torch.ops.raster import RasterConfig as TRC
from funky_tpu_torch.passes import shading as tshading
from funky_tpu_torch.passes.deferred import GBuffer as TGBuffer

from .test_torch_frame import GOLDEN_BAD_FRAC, GOLDEN_TOL
from .torch_parity import t2n

DEPTH_TOL = 1e-5
RGBA_TOL = 1e-5
MATH_TOL = 1e-6
MAX_EDGE_FLIPS = 4
GOLDEN = pathlib.Path(__file__).resolve().parent / "goldens" / "cube_r06_128.png"


def configs(size, tile_h=16, capacity=32):
    return (jf.FrameConfig(width=size, height=size, raster=JRC(
                tile_h=tile_h, tile_w=128, capacity=capacity,
                backend="jnp")),
            tf.FrameConfig(width=size, height=size, raster=TRC(
                tile_h=tile_h, tile_w=128, capacity=capacity)))


def jax_cube(cfg, rotation):
    """JAX's frame, jitted, with its main raster's tri_id and depth (its
    raster_corners recorded while the frame traces)."""
    box = {}
    raster = jf.raster_corners

    def record(*args, **kwargs):
        box["out"] = raster(*args, **kwargs)
        return box["out"]

    def run(scene, params):
        jf.raster_corners = record
        try:
            rgba = jf.render_cube_frame(scene, params, cfg)
        finally:
            jf.raster_corners = raster
        return rgba, box["out"][0], box["out"][1]

    out = jax.jit(run)(jcube(), jf.default_cube_params(rotation))
    return [np.asarray(x) for x in out]


def port_cube(cfg, rotation, monkeypatch):
    """The port's frame with its main raster's tri_id and depth."""
    box = {}
    raster = tf.raster_corners

    def record(*args, **kwargs):
        box["out"] = raster(*args, **kwargs)
        return box["out"]

    monkeypatch.setattr(tf, "raster_corners", record)
    rgba = tf.render_cube_frame(tcube(device="cpu"),
                                tf.default_cube_params(rotation,
                                                       device="cpu"), cfg)
    monkeypatch.undo()
    return t2n(rgba), t2n(box["out"][0]), t2n(box["out"][1])


def edge_flips(tri, jtri):
    """The count of pixels whose tri_id differs, each checked to lie on an
    edge: its 3x3 neighbourhood in JAX's buffer holds another id."""
    ys, xs = np.nonzero(tri != jtri)
    for y, x in zip(ys, xs):
        near = jtri[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
        assert (near != jtri[y, x]).any(), (y, x, tri[y, x], jtri[y, x])
    return len(ys)


@pytest.mark.parametrize("size,rotation", [(128, 0.0), (128, 0.6),
                                           (128, 2.0), (128, 4.2),
                                           (512, 0.0), (512, 0.3),
                                           (512, 1.2)])
def test_cube_frame_matches_jax(size, rotation, monkeypatch):
    """tri_id equal but for at most MAX_EDGE_FLIPS pixels on a face edge,
    depth and rgba within tolerance where it agrees."""
    jcfg, tcfg = configs(size)
    jrgba, jtri, jdepth = jax_cube(jcfg, rotation)
    rgba, tri, depth = port_cube(tcfg, rotation, monkeypatch)
    assert edge_flips(tri, jtri) <= MAX_EDGE_FLIPS
    same = tri == jtri
    np.testing.assert_allclose(depth[same], jdepth[same], rtol=0,
                               atol=DEPTH_TOL)
    np.testing.assert_allclose(rgba[same], jrgba[same], rtol=0,
                               atol=RGBA_TOL)
    assert (tri >= 0).mean() > 0.1


def test_cube_raster_equal_on_the_golden_config(monkeypatch):
    """At the golden's configuration (128x128, rotation 0.6) and at
    512x512, rotation 0, no pixel flips."""
    for size, rotation in ((128, 0.6), (512, 0.0)):
        jcfg, tcfg = configs(size)
        _, jtri, _ = jax_cube(jcfg, rotation)
        _, tri, _ = port_cube(tcfg, rotation, monkeypatch)
        np.testing.assert_array_equal(tri, jtri)


def test_cube_golden(monkeypatch):
    """The 128x128 frame at rotation 0.6 against the committed golden
    (tests/golden_utils.py::render_cube's configuration)."""
    _, tcfg = configs(128)
    rgba, _, _ = port_cube(tcfg, 0.6, monkeypatch)
    want = read_png(GOLDEN)[..., :3].astype(np.float32) / 255.0
    diff = np.abs(linear_to_srgb(rgba[..., :3]) - want).max(-1)
    assert (diff > GOLDEN_TOL).mean() <= GOLDEN_BAD_FRAC, diff.max()


def test_default_cube_params_match_jax():
    jp = jf.default_cube_params(0.37)
    tp = tf.default_cube_params(0.37, device="cpu")
    for name in ("rotation", "position", "camera_pos", "yaw", "pitch",
                 "fov", "scale"):
        np.testing.assert_array_equal(t2n(getattr(tp, name)),
                                      np.asarray(getattr(jp, name)))


@pytest.mark.parametrize("fn", ["translation", "rotation_y", "rotation_x",
                                "scale", "scale3"])
def test_cube_matrices_match_jax(fn):
    rng = np.random.default_rng(3)
    for _ in range(4):
        if fn == "translation":
            x = rng.normal(size=3).astype(np.float32)
            j, t = jm3.mat4_from_translation(x), tm3.mat4_from_translation(
                torch.from_numpy(x))
        elif fn in ("rotation_y", "rotation_x"):
            a = np.float32(rng.uniform(-7, 7))
            j = getattr(jm3, f"mat4_from_{fn}")(jnp.float32(a))
            t = getattr(tm3, f"mat4_from_{fn}")(torch.tensor(a))
        else:
            s = (np.float32(rng.uniform(0.1, 3)) if fn == "scale"
                 else rng.uniform(0.1, 3, 3).astype(np.float32))
            j, t = jm3.mat4_from_scale(s), tm3.mat4_from_scale(
                torch.tensor(s))
        np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=0,
                                   atol=MATH_TOL)


def test_shade_cube_matches_jax():
    """shade_cube on a numpy-seeded G-buffer: random normals (zero ones
    included), colours, a partial coverage mask."""
    rng = np.random.default_rng(4)
    h, w = 16, 24
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal[0, :4] = 0.0
    color = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    valid = rng.uniform(size=(h, w)) > 0.3
    zeros2 = np.zeros((h, w, 2), np.float32)
    zeros3 = np.zeros((h, w, 3), np.float32)
    flags = np.zeros((h, w), np.int32)
    depth = np.ones((h, w), np.float32)
    cam = np.asarray([0.3, -1.0, 3.0], np.float32)
    light = np.asarray([1.0, 1.0, 1.0], np.float32)
    bg = np.asarray(jf.CUBE_CLEAR, np.float32)
    want = jshading.shade_cube(
        JGBuffer(jnp.asarray(valid), jnp.asarray(zeros3), jnp.asarray(normal),
                 jnp.asarray(zeros2), jnp.asarray(color), jnp.asarray(flags),
                 jnp.asarray(depth)),
        jnp.asarray(cam), jnp.asarray(light), jnp.asarray(bg))
    T = torch.from_numpy
    got = tshading.shade_cube(
        TGBuffer(T(valid), T(zeros3), T(normal), T(zeros2), T(color),
                 T(flags), T(depth)), T(cam), T(light), T(bg))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0,
                               atol=MATH_TOL)


# The analytic checks of tests/test_cube_frame.py on the port's compiled
# cube frame (eager on the CPU) at 512x512.

CFG = tf.FrameConfig(width=512, height=512,
                     raster=TRC(tile_h=32, tile_w=128, capacity=32))


def render(rotation):
    frame = tf.compiled_cube_frame(CFG)
    return t2n(frame(tcube(device="cpu"),
                     tf.default_cube_params(rotation, device="cpu")))


@pytest.fixture(scope="module")
def cube_image():
    return render(0.0)


def test_shape_and_range(cube_image):
    assert cube_image.shape == (512, 512, 4)
    assert np.all(np.isfinite(cube_image))
    assert cube_image.min() >= 0.0


def test_background_color(cube_image):
    np.testing.assert_allclose(cube_image[0, 0, :3], tf.CUBE_CLEAR, atol=1e-6)
    np.testing.assert_allclose(cube_image[-1, -1, :3], tf.CUBE_CLEAR,
                               atol=1e-6)


def test_cube_is_centered_and_covered(cube_image):
    bg = np.asarray(tf.CUBE_CLEAR)
    is_cube = np.abs(cube_image[..., :3] - bg).sum(-1) > 1e-5
    assert is_cube[256, 256]
    assert not is_cube[256, 50]
    assert not is_cube[50, 256]
    assert 0.18 < is_cube.mean() < 0.30


def test_front_face_shading_value(cube_image):
    n = np.array([0.0, 0.0, 1.0])
    light = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    half = light + n
    half = half / np.linalg.norm(half)
    diff = max(n @ light, 0.0)
    spec = max(n @ half, 0.0) ** 64
    color = np.array([0.45, 0.70, 0.75])
    expected = 0.20 * color + 0.65 * diff * color + 0.4 * spec
    np.testing.assert_allclose(cube_image[256, 256, :3], expected, atol=1e-4)


def test_rotation_changes_image(cube_image):
    assert np.abs(render(0.7) - cube_image).max() > 0.05


def test_depth_order_with_rotation():
    img = render(np.pi / 4)
    is_cube = np.abs(img[..., :3] - np.asarray(tf.CUBE_CLEAR)).sum(-1) > 1e-5
    assert is_cube[256, 200] and is_cube[256, 312]
