"""Port parity: the raymarched SDF scene (funky_tpu_torch/models/sdf.py)
against funky_tpu's.

Tolerances and why:
- scene_sdf within 1e-5 of JAX (measured 4.8e-7 over 4,096 numpy-seeded
  points at three times) and the material ids equal: the same f32
  expressions; XLA fuses and may contract them.
- the 160x96 frame at t = 1: sphere tracing carries those ulps through 96
  march steps, 48 shadow steps and the fog, and a ray that grazes a
  silhouette can stop on the other side of HIT_EPS. The gate is the
  golden tolerance (3/255 on at most 0.2% of pixels,
  tests/test_goldens.py:14-15) against JAX's frame and against
  tests/goldens/sdf_t1_160x96.png; measured: max |diff| 1.3e-4 to JAX, no
  pixel over 3/255 to either.
- the camera and the analytic checks of tests/test_sdf_ui_driver.py.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.models import sdf as js

from funky_tpu_torch.models import sdf as ts
from funky_tpu_torch.models.png_io import linear_to_srgb, read_png

from .test_torch_frame import GOLDEN_BAD_FRAC, GOLDEN_TOL
from .torch_parity import t2n

SDF_TOL = 1e-5
GOLDEN = pathlib.Path(__file__).resolve().parent / "goldens" / \
    "sdf_t1_160x96.png"


def port_camera(cam):
    return [torch.from_numpy(np.array(x)) for x in cam]


@pytest.mark.parametrize("t", [0.0, 1.0, 2.7])
def test_scene_sdf_matches_jax(t):
    rng = np.random.default_rng(5)
    p = rng.uniform(-3, 3, (4096, 3)).astype(np.float32)
    p[:8, 1] = 0.0                      # on the ground plane
    jd, jm = js.scene_sdf(jnp.asarray(p), jnp.float32(t))
    td, tm = ts.scene_sdf(torch.from_numpy(p), torch.tensor(t))
    np.testing.assert_allclose(t2n(td), np.asarray(jd), rtol=0, atol=SDF_TOL)
    np.testing.assert_array_equal(t2n(tm), np.asarray(jm))
    assert set(np.unique(t2n(tm))) == {0, 1, 2}


@pytest.mark.parametrize("name", ["sd_sphere", "sd_round_box", "sd_torus",
                                  "smooth_min"])
def test_primitives_match_jax(name):
    rng = np.random.default_rng(6)
    p = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    a = rng.uniform(-1, 1, 512).astype(np.float32)
    b = rng.uniform(-1, 1, 512).astype(np.float32)
    args = {"sd_sphere": ((0.2, 1.0, -0.3), 0.45),
            "sd_round_box": ((0.0, 0.3, 0.0), (0.5, 0.3, 0.5), 0.05),
            "sd_torus": ((0.1, 0.2, 0.0), 1.0, 0.12)}
    if name == "smooth_min":
        want = js.smooth_min(jnp.asarray(a), jnp.asarray(b), 0.3)
        got = ts.smooth_min(torch.from_numpy(a), torch.from_numpy(b), 0.3)
    elif name == "sd_sphere":
        c, r = args[name]
        want = js.sd_sphere(jnp.asarray(p), c, r)
        got = ts.sd_sphere(torch.from_numpy(p), torch.tensor(c), r)
    else:
        want = getattr(js, name)(jnp.asarray(p), *args[name])
        got = getattr(ts, name)(torch.from_numpy(p), *args[name])
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0,
                               atol=SDF_TOL)


def test_default_camera_matches_jax():
    for a, b in zip(js.default_sdf_camera(),
                    ts.default_sdf_camera(device="cpu")):
        np.testing.assert_array_equal(t2n(b), np.asarray(a))


@pytest.fixture(scope="module")
def frames():
    """JAX's and the port's 160x96 frame at t = 1 on JAX's camera."""
    cam = js.default_sdf_camera()
    want = np.asarray(js.compiled_sdf_frame(js.SdfConfig(160, 96))(1.0,
                                                                   *cam))
    got = t2n(ts.render_sdf_frame(1.0, *port_camera(cam),
                                  ts.SdfConfig(160, 96)))
    return want, got


def bad_share(a, b) -> float:
    return float((np.abs(a - b).max(-1) > GOLDEN_TOL).mean())


def test_sdf_frame_matches_jax(frames):
    want, got = frames
    assert got.shape == want.shape == (96, 160, 4)
    assert bad_share(got, want) <= GOLDEN_BAD_FRAC
    np.testing.assert_array_equal(got[..., 3], 1.0)


def test_sdf_golden(frames):
    _, got = frames
    want = read_png(GOLDEN)[..., :3].astype(np.float32) / 255.0
    assert bad_share(linear_to_srgb(got[..., :3]), want) <= GOLDEN_BAD_FRAC


def test_sdf_render_analytic():
    """tests/test_sdf_ui_driver.py::test_sdf_render on the port."""
    cfg = ts.SdfConfig(width=160, height=96)
    cam = ts.default_sdf_camera(device="cpu")
    img = t2n(ts.compiled_sdf_frame(cfg)(0.7, *cam))
    assert img.shape == (96, 160, 4)
    assert np.isfinite(img).all()
    assert img[0, 80, 2] > img[0, 80, 0]          # bluish sky
    assert img[40:70, 60:110, :3].std() > 0.02
    img2 = t2n(ts.compiled_sdf_frame(cfg)(2.9, *cam))
    assert np.abs(img2 - img).max() > 0.05


def test_sdf_scene_distances():
    """tests/test_sdf_ui_driver.py::test_sdf_scene_distances on the port."""
    d, _ = ts.scene_sdf(torch.tensor([5.0, 2.0, 5.0]), torch.tensor(0.0))
    assert abs(float(d) - 2.0) < 0.2 or float(d) <= 2.0
    d, mat = ts.scene_sdf(torch.tensor([8.0, 0.0, 8.0]), torch.tensor(0.0))
    assert abs(float(d)) < 1e-5 and int(mat) == 0
