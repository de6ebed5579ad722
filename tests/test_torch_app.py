"""Port parity: the app layer of funky_tpu_torch (ecs.py, app/camera.py,
ops/sampling.py::sample_bilinear_edge, passes/overlay.py, app/ui.py,
app/driver.py, app/viewer.py, utils/sanitize.py, utils/profiling.py)
against funky_tpu's, and the reference's own app tests run on the port.

Tolerances and why:
- ECS, camera, panel layout and hit boxes: equal. They are numpy and
  Python copies; the ECS's quaternion product is numpy f32 where JAX's is
  XLA f32, within 1e-6.
- sample_bilinear_edge: within 1e-6 of JAX (the same f32 expressions).
- the overlay panel and what render_over composites: within 3e-5 of JAX
  (measured max 1.3e-5, on 78 of the full panel's 393,216 values, all at
  glyph edges): the same per-triangle arithmetic, which XLA fuses and
  contracts inside its scan. A glyph's atlas coordinate x = u * 160 - 0.5
  reaches 160, where one f32 ulp is 1.5e-5, and the bilinear weight
  x - floor(x) carries that ulp into the coverage. The composite alone,
  on equal inputs: within 1e-6.
- driver frames against the reference's driver: the golden tolerance
  (3/255 on at most 0.2% of pixels), the whole-frame gate of
  tests/test_torch_frame.py.
Everything runs on the CPU at small sizes; the drivers use the ground-only
scene or the multimesh GLB (the Duck the reference's driver tests load is
not in the repository).
"""

import dataclasses
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu import ecs as jecs
from funky_tpu.app import camera as jcam
from funky_tpu.app import ui as jui
from funky_tpu.ops import sampling as jsampling
from funky_tpu.passes import overlay as joverlay

from funky_tpu_torch import ecs as tecs
from funky_tpu_torch.app import camera as tcam
from funky_tpu_torch.app import ui as tui
from funky_tpu_torch.ops import sampling as tsampling
from funky_tpu_torch.passes import overlay as toverlay
from funky_tpu_torch.utils import profiling, sanitize

from .torch_parity import t2n

OVERLAY_TOL = 3e-5
COMPOSITE_TOL = 1e-6
SAMPLE_TOL = 1e-6


# ---------------------------------------------------------------------------
# ECS and camera (tests/test_ecs_camera.py, both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ecs", [jecs, tecs], ids=["jax", "port"])
def test_world_spawn_query_despawn(ecs):
    w = ecs.World()
    e1 = w.spawn(ecs.Transform(), ecs.Velocity())
    w.spawn(ecs.Transform())
    assert w.entity_count() == 2 and w.component_count() == 3
    pairs = list(w.query(ecs.Transform, ecs.Velocity))
    assert len(pairs) == 1 and pairs[0][0] == e1
    w.despawn(e1)
    assert w.entity_count() == 1
    assert list(w.query(ecs.Transform, ecs.Velocity)) == []


def run_rotation(ecs, angular, linear, dt, steps):
    w = ecs.World()
    w.insert_resource(ecs.FrameTiming(delta_time=dt))
    t = ecs.Transform()
    w.spawn(t, ecs.Velocity(linear=linear.copy(), angular=angular.copy()))
    for _ in range(steps):
        ecs.rotation_system(w)
    return t


def test_rotation_system_matches_jax():
    """Numpy-seeded YXZ euler rates and linear velocities, integrated over
    five frames by both packages' rotation_system."""
    rng = np.random.default_rng(7)
    for _ in range(6):
        ang = rng.normal(size=3).astype(np.float32)
        lin = rng.normal(size=3).astype(np.float32)
        j = run_rotation(jecs, ang, lin, 0.05, 5)
        t = run_rotation(tecs, ang, lin, 0.05, 5)
        np.testing.assert_allclose(t.rotation, j.rotation, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t.position, j.position)
        assert t.rotation.dtype == np.float32


def test_rotation_system_integrates_yaw():
    t = run_rotation(tecs, np.array([0.0, math.pi, 0.0], np.float32),
                     np.zeros(3, np.float32), 0.5, 1)
    np.testing.assert_allclose(
        t.rotation, [0, math.sin(math.pi / 4), 0, math.cos(math.pi / 4)],
        atol=1e-6)


def test_performance_stats_and_resources():
    for ecs in (jecs, tecs):
        w = ecs.World()
        w.insert_resource(ecs.PerformanceStats())
        ecs.update_performance_stats(w)
        ecs.update_performance_stats(w)
        assert w.resource(ecs.PerformanceStats).frame_count == 2
        assert w.has_resource(ecs.PerformanceStats)
        assert not w.has_resource(ecs.ShadowSettings)
    assert dataclasses.asdict(tecs.ShadowSettings()) == dataclasses.asdict(
        jecs.ShadowSettings())


def test_camera_matches_jax():
    """A numpy-seeded key sequence through both packages' update_camera
    and apply_scroll_zoom: every field equal."""
    rng = np.random.default_rng(8)
    keys = list(tcam.Keys)
    j, t = jcam.CameraController(), tcam.CameraController()
    for _ in range(60):
        pick = [k for k in keys if rng.uniform() < 0.3]
        dt = float(rng.uniform(0.005, 0.2))
        j = jcam.update_camera(j, [jcam.Keys(k.value) for k in pick], dt)
        t = tcam.update_camera(t, pick, dt)
        if rng.uniform() < 0.2:
            s = float(rng.normal())
            j, t = jcam.apply_scroll_zoom(j, s), tcam.apply_scroll_zoom(t, s)
        np.testing.assert_array_equal(t.position, j.position)
        assert (t.yaw, t.pitch, t.fov) == (j.yaw, j.pitch, j.fov)


def test_camera_rules():
    """The reference's camera checks (tests/test_ecs_camera.py) on the
    port: ground-projected forward, strafe, pitch clamp and yaw wrap, zoom
    clamp, Q/E."""
    c = tcam.CameraController()
    c2 = tcam.update_camera(c, [tcam.Keys.W], 1.0)
    assert abs(float(c2.position[1]) - float(c.position[1])) < 1e-6
    moved = np.linalg.norm(np.asarray(c2.position) - np.asarray(c.position))
    assert abs(moved - c.move_speed) < 1e-5
    fwd = np.asarray(tcam.update_camera(c, [tcam.Keys.W], 0.1).position) \
        - c.position
    left = np.asarray(tcam.update_camera(c, [tcam.Keys.A], 0.1).position) \
        - c.position
    assert abs(float(fwd @ left)) < 1e-6
    r = c
    for _ in range(100):
        r = tcam.update_camera(r, [tcam.Keys.UP, tcam.Keys.RIGHT], 0.5)
    assert abs(r.pitch - tcam.MAX_PITCH) < 1e-6 and 0 <= r.yaw < 2 * math.pi
    z = c
    for _ in range(100):
        z = tcam.update_camera(z, [tcam.Keys.Z], 1.0)
    assert abs(z.fov - math.radians(10.0)) < 1e-6
    assert float(tcam.update_camera(c, [tcam.Keys.E], 0.2).position[1]) > \
        float(c.position[1])


# ---------------------------------------------------------------------------
# sample_bilinear_edge (ops/sampling.py:168)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [None, 1, 4])
@pytest.mark.parametrize("where", ["inside", "edge", "outside"])
def test_sample_bilinear_edge_matches_jax(channels, where):
    rng = np.random.default_rng(9)
    shape = (13, 21) if channels is None else (13, 21, channels)
    img = rng.normal(size=shape).astype(np.float32)
    n = 257
    if where == "inside":
        uv = rng.uniform(0.05, 0.95, (n, 2))
    elif where == "edge":
        uv = rng.choice([0.0, 1.0, 0.5 / 21, 1 - 0.5 / 13, 0.5], (n, 2))
    else:
        uv = rng.uniform(-0.7, 1.7, (n, 2))
        uv[:8] = [[-1e6, 0.5], [2e6, 0.5], [0.5, -3.0], [0.5, 9.0],
                  [-0.01, -0.01], [1.01, 1.01], [-5, 7], [1.0, -0.0]]
    uv = uv.astype(np.float32).reshape(1, n, 2)
    want = jsampling.sample_bilinear_edge(jnp.asarray(img), jnp.asarray(uv))
    got = tsampling.sample_bilinear_edge(torch.from_numpy(img),
                                         torch.from_numpy(uv))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0,
                               atol=SAMPLE_TOL)


# ---------------------------------------------------------------------------
# Overlay and debug panel (tests/test_sdf_ui_driver.py:35-175)
# ---------------------------------------------------------------------------

def test_font_atlas_matches_jax():
    """The committed atlas (app/font_atlas.png) is the reference's PIL
    raster, and the glyph uv map is the same."""
    ja, juv, jgw, jgh = jui.build_font_atlas()
    ta, tuv, tgw, tgh = tui.build_font_atlas()
    np.testing.assert_array_equal(ta, ja)
    assert tuv == juv and (tgw, tgh) == (jgw, jgh)


def panel_arrays(data):
    """The reference's panel layout for `data`, as both packages build it:
    (jax arrays, port host arrays, n triangles)."""
    jt, tt = jui.build_panel(data), tui.build_panel(data)
    ja, ta = jt.arrays(), tt.arrays()
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a, b)
    assert jt.checkboxes == tt.checkboxes and jt.sliders == tt.sliders
    return ja, ta


UI_DATA = jui.UiData(fps=59.9, frame_time_ms=16.7, gltf_scale=0.0123,
                     use_pcss=True, use_shadow_taa=False,
                     debug_cascades=True, entity_count=3, component_count=7,
                     gpu_info="cpu, torch", last_error="frame 3: boom")


@pytest.fixture(scope="module")
def panels():
    """The full debug panel (the reference's rects, checkboxes, sliders
    and text) rasterized by both packages."""
    tdata = tui.UiData(**dataclasses.asdict(UI_DATA))
    (verts, uvs, cols, tris, n), host = panel_arrays(UI_DATA)
    atlas, _, _, _ = jui.build_font_atlas()
    want = joverlay.rasterize_overlay(
        jnp.asarray(verts), jnp.asarray(uvs), jnp.asarray(cols),
        jnp.asarray(tris), jnp.asarray(n), jnp.asarray(atlas),
        (tui.PANEL_H, tui.PANEL_W))
    got = toverlay.rasterize_overlay(*host[:4], int(host[4]),
                                     torch.from_numpy(atlas),
                                     (tui.PANEL_H, tui.PANEL_W))
    return np.asarray(want), got, tdata


def test_overlay_panel_matches_jax(panels):
    want, got, _ = panels
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=OVERLAY_TOL)
    assert (want[..., 3] > 0.5).mean() > 0.5           # the panel is drawn


def test_composite_matches_jax(panels):
    want, got, _ = panels
    rng = np.random.default_rng(10)
    image = rng.uniform(0, 1, (300, 420, 4)).astype(np.float32)
    for x, y in ((10, 10), (40, 30), (100, 90)):      # the last is clamped
        j = joverlay.composite_overlay(jnp.asarray(image), jnp.asarray(want),
                                       jnp.int32(x), jnp.int32(y))
        t = toverlay.composite_overlay(torch.from_numpy(image),
                                       torch.from_numpy(np.array(want)), x, y)
        np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=0,
                                   atol=COMPOSITE_TOL)


def test_render_over_matches_jax(panels):
    """DebugPanel.render_over over a frame smaller than the panel (the
    scissor): the port's against the reference's."""
    _, _, tdata = panels
    rng = np.random.default_rng(11)
    image = rng.uniform(0, 1, (200, 320, 4)).astype(np.float32)
    want = jui.DebugPanel(320, 200).render_over(jnp.asarray(image), UI_DATA)
    dp = tui.DebugPanel(320, 200, device="cpu")
    got = dp.render_over(torch.from_numpy(image), tdata)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0,
                               atol=OVERLAY_TOL)
    np.testing.assert_array_equal(t2n(got)[:10], image[:10])


def test_overlay_rasterize_and_blend():
    t = tui.Tessellator()
    t.rect(2, 2, 20, 10, (1.0, 0.0, 0.0, 0.5))      # half-transparent red
    verts, uvs, cols, tris, n = t.arrays()
    ov = t2n(toverlay.rasterize_overlay(verts, uvs, cols, tris, int(n),
                                        torch.from_numpy(t.atlas), (32, 64)))
    np.testing.assert_allclose(ov[6, 10], [0.5, 0, 0, 0.5], atol=1e-5)
    np.testing.assert_allclose(ov[20, 40], [0, 0, 0, 0], atol=1e-6)
    frame = torch.full((48, 80, 4), 0.2)
    out = t2n(toverlay.composite_overlay(frame, torch.from_numpy(ov), 8, 4))
    np.testing.assert_allclose(out[10, 18, 0], 0.6, atol=1e-5)
    np.testing.assert_allclose(out[10, 18, 1], 0.1, atol=1e-5)
    np.testing.assert_allclose(out[0, 0], 0.2, atol=1e-6)


def test_ui_text_renders_coverage():
    t = tui.Tessellator()
    t.text(2, 2, "FPS", (1, 1, 1, 1))
    verts, uvs, cols, tris, n = t.arrays()
    ov = t2n(toverlay.rasterize_overlay(verts, uvs, cols, tris, int(n),
                                        torch.from_numpy(t.atlas), (16, 32)))
    assert ov[..., 3].max() > 0.5
    assert (ov[..., 3] > 0.2).sum() > 10


def test_ui_panel_and_hits():
    data = tui.UiData(fps=59.9, frame_time_ms=16.7, gltf_scale=0.01,
                      use_pcss=True, use_shadow_taa=False)
    assert len(tui.build_panel(data).tris) > 50
    dp = tui.DebugPanel(320, 200, device="cpu")
    out = t2n(dp.render_over(torch.full((200, 320, 4), 0.3), data))
    assert out.shape == (200, 320, 4)
    assert abs(out[5, 5, 0] - 0.3) < 1e-5 and out[20, 40, 0] != 0.3
    ch = dp.hit(16, 100, data)
    assert len([v for v in (ch.use_pcss, ch.use_shadow_taa,
                            ch.debug_cascades) if v is not None]) <= 1


def test_ui_hits_match_jax(panels):
    """Clicks over a grid of the panel give the reference's UiChanges."""
    _, _, tdata = panels
    jp, tp = jui.DebugPanel(320, 200), tui.DebugPanel(320, 200,
                                                      device="cpu")
    image = np.zeros((200, 320, 4), np.float32)
    jp.render_over(jnp.asarray(image), UI_DATA)
    tp.render_over(torch.from_numpy(image), tdata)
    for x in range(0, 400, 7):
        for y in range(0, 270, 5):
            assert vars(tp.hit(x, y, tdata)) == vars(jp.hit(x, y, UI_DATA))


def test_ui_hit_state_is_per_instance():
    data = tui.UiData(use_pcss=True)
    a = tui.DebugPanel(320, 200, device="cpu")
    b = tui.DebugPanel(320, 200, device="cpu")
    assert all(v is None for v in vars(b.hit(16, 100, data)).values())
    a.render_over(torch.full((200, 320, 4), 0.3), data)
    assert a._checkboxes and a._sliders
    assert not b._checkboxes and not b._sliders


def test_ui_panel_shows_last_error():
    clean = tui.build_panel(tui.UiData())
    dirty = tui.build_panel(tui.UiData(last_error="frame 3: boom"))
    assert len(dirty.tris) > len(clean.tris)


# ---------------------------------------------------------------------------
# Sanitizers and profiling (tests/test_sanitize.py)
# ---------------------------------------------------------------------------

def test_checked_flags_nan_source():
    def bad(x):
        return torch.log(x - 2.0)          # log of negatives -> NaN

    with pytest.raises(FloatingPointError, match="nan") as exc:
        sanitize.checked(bad)(torch.tensor([1.0, 3.0]))
    assert "log" in str(exc.value)

    def good(x):
        return torch.sqrt(x * x + 1.0)

    np.testing.assert_allclose(t2n(sanitize.checked(good)(
        torch.tensor([1.0, 3.0]))), np.sqrt([2.0, 10.0]), rtol=1e-6)


def test_checked_names_the_first_op():
    """A division by zero makes the Inf; the ops after it only carry it."""
    def fn(x):
        y = x / torch.zeros_like(x)
        return torch.minimum(y, y + 1.0)

    with pytest.raises(FloatingPointError, match="div.*inf"):
        sanitize.checked(fn)(torch.ones(3))


def test_assert_finite():
    clean = {"a": torch.ones((4, 4)), "b": torch.zeros(3),
             "i": torch.arange(3)}
    sanitize.assert_finite(clean)
    dirty = torch.ones((4, 4))
    dirty[1, 2] = float("nan")
    with pytest.raises(FloatingPointError, match=r"\['a'\]: 1 non-finite"):
        sanitize.assert_finite({"a": dirty}, label="test")


def test_profiling(tmp_path):
    fps = profiling.FpsCounter(window_s=0.0)
    fps.tick()
    fps.tick()
    assert fps.fps > 0 and fps.frame_time_ms > 0
    timer = profiling.PassTimer()
    out = timer.time_fn("add", torch.add, torch.ones(3), torch.ones(3),
                        iters=2)
    with timer.measure("mul", result=out):
        out = out * 2
    assert set(timer.summary()) == {"add", "mul"}
    assert "add" in timer.report()
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").exists()
    assert profiling.device_info("cpu").startswith("cpu, torch ")


# ---------------------------------------------------------------------------
# The port's app layer imports no jax and defaults to the card
# ---------------------------------------------------------------------------

APP_IMPORTS = """
import sys
import chip_smoke, demo_torch
import funky_tpu_torch.app.driver, funky_tpu_torch.app.viewer
import funky_tpu_torch.ecs, funky_tpu_torch.models.sdf
import funky_tpu_torch.utils.sanitize, funky_tpu_torch.utils.profiling
import funky_tpu_torch.passes.overlay
import funky_tpu_torch.ops.overlay_cuda, funky_tpu_torch.ops.lightmap_cuda
assert "jax" not in sys.modules and "funky_tpu" not in sys.modules, [
    m for m in sys.modules if m.startswith(("jax", "funky_tpu."))]
print("ok")
"""


def test_app_imports_no_jax():
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", APP_IMPORTS], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_app_entry_points_default_to_the_card():
    import inspect

    import funky_tpu_torch.frame as tf
    from funky_tpu_torch.app.driver import FrameDriver
    from funky_tpu_torch.models import sdf

    for fn in (tf.default_cube_params, sdf.default_sdf_camera,
               FrameDriver.__init__, tui.DebugPanel.__init__):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__


@pytest.mark.parametrize("path", ["cube", "overlay"])
def test_app_gathers_pass_check_args(path, monkeypatch):
    """Every take_rows call of the cube frame and of the debug panel's
    plain raster passes the row-gather kernel's check_args (K3 takes them
    on the card, where the panel's plain twin is the overlay kernel's
    reference; tests/test_torch_gather.py does the same for the glTF
    frames)."""
    import funky_tpu_torch.frame as tf
    from funky_tpu_torch.models.scene import build_cube_scene
    from funky_tpu_torch.ops import gather_cuda

    calls = []
    plain = tsampling.take_rows_plain

    def record(flat, idx):
        calls.append((flat.dtype, tuple(flat.shape[1:]),
                      gather_cuda.check_args(flat, idx)))
        return plain(flat, idx)

    monkeypatch.setattr(tsampling, "take_rows_plain", record)
    if path == "cube":
        tf.render_cube_frame(build_cube_scene(device="cpu"),
                             tf.default_cube_params(0.6, device="cpu"),
                             tf.FrameConfig(width=128, height=128))
        want = {(torch.float32, (46,))}
    else:
        t = tui.Tessellator()
        t.rect(2, 2, 20, 10, (1.0, 0.0, 0.0, 0.5))
        t.text(2, 2, "FPS", (1, 1, 1, 1))
        toverlay.rasterize_overlay(*t.arrays()[:4], len(t.tris),
                                   torch.from_numpy(t.atlas), (32, 64))
        want = {(torch.float32, (4,))}
    assert calls and {(d, s) for d, s, _ in calls} == want
