"""Port parity: the app shell, funky_tpu_torch/app/driver.py::FrameDriver
and app/viewer.py::TerminalViewer, against funky_tpu's, and the
reference's driver and viewer tests (tests/test_sdf_ui_driver.py,
tests/test_viewer.py, tests/test_sanitize.py) run on the port.

The reference's driver tests load the Duck, which is not in the
repository; these use the multimesh GLB written to tmp_path
(models/sample_scenes.build_multimesh_glb) or the ground-only scene
(scene_path=None, as tests/test_viewer.py does). Everything runs on the
CPU at small sizes, where the compiled frame is the eager frame.

Tolerances and why:
- driver frames against the reference's driver on the same scene, config
  (256x144, 256^2 maps, the default sparse flags) and keys: within the
  golden tolerance, 3/255 on at most 0.2% of pixels (measured 0.13% on
  the third frame). Shadow compares and z-fight pixels flip on ulp
  differences of the light-space depth (tests/test_torch_frame.py); at
  128^2 maps the flips cover 0.8% of the frame, so the test uses 256^2.
- save/load, failure recovery and the retune: the port's own frames, bit
  for bit.

Two faults of the reference's runtime retune are repaired in the port,
whose probe measures the view's candidate windows
(utils/diagnostics.py::probe_occupancy), and tested here: a
synth_window_fit overflow re-derived the same light windows
(funky_tpu/utils/autotune.py:276), and a retune dropped the adopted
routes and the radius-only split (autotune.py:112).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from funky_tpu.app import driver as jdriver
from funky_tpu.app import ui as jui
import funky_tpu.frame as jf
from funky_tpu.ops.raster import RasterConfig as JRC

import funky_tpu_torch.frame as tf
from funky_tpu_torch.app.camera import Keys
from funky_tpu_torch.app.driver import FrameDriver
from funky_tpu_torch.app.ui import PANEL_X, PANEL_Y, UiChanges
from funky_tpu_torch.app.viewer import TerminalViewer
from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
from funky_tpu_torch.ops.raster import RasterConfig

from .test_torch_frame import GOLDEN_BAD_FRAC, GOLDEN_TOL
from . import torch_parity  # noqa: F401  (torch's thread count)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(width=256, height=144, shadow_map_size=256)


def port_cfg(**kw):
    tile = RasterConfig(tile_h=16, tile_w=128)
    return tf.GltfConfig(raster=tile, shadow_raster=tile,
                         **dict(SMALL, **kw))


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    return build_multimesh_glb(tmp_path_factory.mktemp("scene") / "m.glb",
                               two_textures=True)


def driver(glb, **kw):
    kw.setdefault("autotune", False)
    kw.setdefault("device", "cpu")
    cfg = kw.pop("cfg", None) or port_cfg()
    return FrameDriver(cfg, scene_path=glb, gltf_scale=1.0, **kw)


def test_driver_matches_jax_driver(glb):
    """The same scene, config and keys through both drivers: readback
    with the panel hidden (its FPS text differs by host clock), and the
    panel's layout over that frame with the same UiData."""
    jtile = JRC(tile_h=16, tile_w=128, backend="jnp")
    j = jdriver.FrameDriver(jf.GltfConfig(raster=jtile, shadow_raster=jtile,
                                          **SMALL),
                            scene_path=glb, autotune=False)
    j.apply_ui_changes(jui.UiChanges(gltf_scale=1.0))
    t = driver(glb)
    for keys in ([], [Keys.W], [Keys.LEFT, Keys.E]):
        j.step([jdriver.Keys(k.value) for k in keys])
        t.step(keys)
    np.testing.assert_array_equal(t.camera.position, j.camera.position)
    for d in (j, t):
        d.toggle_ui()
    want, got = j.readback(srgb=False), t.readback(srgb=False)
    assert got.shape == want.shape == (144, 256, 4)
    bad = (np.abs(got - want).max(-1) > GOLDEN_TOL).mean()
    assert bad <= GOLDEN_BAD_FRAC, bad
    assert float((got[..., :3] < 0.5).mean()) > 0.01      # shadowed ground


def test_driver_end_to_end(glb):
    """tests/test_sdf_ui_driver.py::test_driver_end_to_end on the port."""
    drv = driver(glb)
    drv.step()
    drv.step(keys=[Keys.W, Keys.LEFT])
    img = drv.readback()
    assert img.shape == (144, 256, 3) and np.isfinite(img).all()
    assert drv.frame_count == 2 and "FPS" in drv.title()
    drv.apply_ui_changes(UiChanges(use_pcss=False, gltf_scale=0.02))
    drv.step()
    ui = drv.ui_data()
    assert ui.use_pcss is False and abs(ui.gltf_scale - 0.02) < 1e-9
    assert drv.cfg.flags.use_pcss is False
    assert drv._frame_fn is tf.compiled_gltf_frame(drv.cfg)
    assert float(drv.camera.position[2]) != 10.0
    assert ui.gpu_info.startswith("cpu")


def test_driver_save_load_state(glb, tmp_path):
    """A saved session restores bit-exact frames."""
    a = driver(glb, enable_ui=False)
    a.step(keys=[Keys.W])
    a.step(keys=[Keys.LEFT])
    a.save_state(tmp_path / "session.ckpt")
    want = a.step()
    b = driver(glb, enable_ui=False)
    b.load_state(tmp_path / "session.ckpt")
    got = b.step()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert b.frame_count == a.frame_count


def test_driver_save_png(glb, tmp_path):
    from funky_tpu_torch.models.png_io import read_png

    drv = driver(glb)
    drv.step()
    drv.save_png(tmp_path / "f.png")
    img = read_png(tmp_path / "f.png")
    assert img.shape[:2] == (144, 256)


def test_driver_failure_escalation(glb):
    """One-off failures skip the frame and recover; the third in a row
    re-raises, and the error shows in UiData."""
    drv = driver(glb, enable_ui=False)
    drv.step()
    good = drv._frame_fn

    def bad(*a, **k):
        raise RuntimeError("injected device loss")

    drv._frame_fn = bad
    drv.step()
    drv.step()
    assert drv.consecutive_failures == 2
    assert "injected device loss" in drv.ui_data().last_error
    drv._frame_fn = good
    drv.step()
    assert drv.consecutive_failures == 0 and drv.ui_data().last_error == ""
    drv._frame_fn = bad
    drv.step()
    drv.step()
    with pytest.raises(RuntimeError, match="injected device loss"):
        drv.step()


class _FailingReplay:
    """A compiled frame whose graph fails during a replay (or before it)."""

    def __init__(self, replaying):
        self.last = type("G", (), {"replaying": replaying})()

    def __call__(self, *args):
        raise RuntimeError("injected replay failure")


@pytest.mark.parametrize("replaying", [False, True])
def test_failed_frame_state(glb, replaying, capsys):
    """A failed step keeps the previous FrameState (TAA history survives),
    unless the failure came during a graph replay, which updates the
    state in place: then the state is rebuilt. The driver says which."""
    drv = driver(glb, enable_ui=False)
    drv.step()
    before = drv.state
    good = drv._frame_fn
    drv._frame_fn = _FailingReplay(replaying)
    drv.step()
    out = capsys.readouterr().out
    assert drv.consecutive_failures == 1
    if replaying:
        assert drv.state is not before and int(drv.state.frame_index) == 0
        assert "rebuilt" in out
    else:
        assert drv.state is before and "kept" in out
    drv._frame_fn = good
    drv.step()
    assert drv.consecutive_failures == 0


def test_driver_sanitize_mode(glb):
    drv = driver(glb, enable_ui=False, sanitize=True)
    drv.step()
    hist = drv.state.shadow_history.clone()
    hist[0, 0, 0] = float("inf")
    drv.state = drv.state._replace(shadow_history=hist)
    with pytest.raises(FloatingPointError, match="shadow_history"):
        drv.step()


def test_driver_run_and_resize(glb):
    drv = driver(glb)
    assert drv.run(2) >= 0.0 and drv.frame_count == 2
    drv.resize(128, 64)
    drv.step()
    assert drv.readback().shape == (64, 128, 3)
    assert drv.state.prev_depth.shape == (64, 128)


# ---------------------------------------------------------------------------
# The runtime retune (driver.py:190-249)
# ---------------------------------------------------------------------------

def retuning(glb, cfg):
    drv = driver(glb, enable_ui=False, cfg=cfg)
    drv.step()          # prev_depth becomes real for the contact probe
    drv.autotune = True
    drv.retune_check_every = 1
    drv.retune_after = 2
    return drv


def test_driver_runtime_retune(glb):
    """An overflowing capacity is re-derived after two overflowing checks
    (tests/test_sdf_ui_driver.py::test_driver_runtime_retune)."""
    drv = retuning(glb, port_cfg())
    drv.cfg = dataclasses.replace(drv.cfg, shadow_pen_capacity=1)
    drv.step()
    assert drv.retune_count == 0 and drv._overflow_strikes == 1
    drv.step()
    assert drv.retune_count == 1 and drv.cfg.shadow_pen_capacity > 1
    assert np.isfinite(drv.step().numpy()).all()
    assert drv._overflow_strikes == 0


def test_driver_retune_tightens(glb):
    """A capacity at twice what the view needs is re-derived after two
    slack checks (test_sdf_ui_driver.py::test_driver_retune_tightens)."""
    drv = retuning(glb, port_cfg())
    inflated = 1024 * 64
    drv.cfg = dataclasses.replace(drv.cfg, shadow_pen_capacity=inflated)
    drv.step()
    assert drv.retune_count == 0 and drv._slack_strikes == 1
    drv.step()
    assert drv.retune_count == 1 and drv.cfg.shadow_pen_capacity < inflated
    assert np.isfinite(drv.step().numpy()).all()
    assert drv._slack_strikes == 0


def test_band_budget_overflow_alone_does_not_retune(glb, monkeypatch):
    """A probe whose only overflow is the blend band's block budget (the
    frame's domain's, which no re-derive changes; a committed frame's drop
    of the excess blocks is exact) strikes nothing, check after check."""
    from funky_tpu_torch.utils import autotune, diagnostics

    probe = diagnostics.probe_occupancy

    def band_over(*args, **kwargs):
        occ = probe(*args, **kwargs)
        occ["band_blocks"] = occ["band_bcap"] + 1
        return occ

    monkeypatch.setattr(diagnostics, "probe_occupancy", band_over)
    drv = retuning(glb, port_cfg())
    for _ in range(2 * drv.retune_after):
        drv.step()
        assert autotune.capacity_overflows(
            drv.cfg, drv.last_occupancy) == ["band_block_capacity"]
        assert drv._overflow_strikes == 0
    assert drv.retune_count == 0


def test_retune_keeps_overflowing_synth_windows(glb):
    """Reference fault (funky_tpu/utils/autotune.py:276), repaired: the
    probe reports synth_window_fit when an occluder outgrows its light
    window, and it also measures the view's candidate windows, so the
    retune widens the windows and the overflow stops within retune_after
    checks (the reference re-derives the same windows and retunes every
    retune_after checks)."""
    cfg = port_cfg(flags=tf.GltfFrameFlags(committed=True,
                                           synth_shadow_maps=True),
                   light_window_sizes=(16, 16, 16, 16))
    drv = retuning(glb, cfg)
    for _ in range(drv.retune_after):
        drv.step()
        assert drv.last_occupancy["synth_window_overflow"] > 0
    assert drv.retune_count == 1
    wide = drv.cfg.light_window_sizes
    assert wide == drv.last_occupancy["light_window_sizes"]
    assert all(w > 16 for w in wide)
    for _ in range(2 * drv.retune_after):
        drv.step()
        assert drv.last_occupancy["synth_window_overflow"] == 0
        assert "synth_window_fit" not in drv.last_error
    assert drv.retune_count == 1 and drv.cfg.light_window_sizes == wide


def test_retune_drops_routes_and_lit_split(glb, monkeypatch):
    """Reference fault (autotune.py:112), repaired: a config with an
    adopted route and a radius-only split keeps both through a slack
    retune while the view supports them. The probe carries the config's
    route windows (`route_window_sizes`), so derive_sparse_config adopts
    the route again, and the routes stay consistent for the split. At
    this size the view has fewer route and radius-only entries than the
    rule's thresholds (4,096 and 16,384, JAX's), so the probe's counts are
    scaled up to a view that has them."""
    from funky_tpu_torch.utils import diagnostics

    probe = diagnostics.sparse_occupancy

    def busy_view(*args, **kwargs):
        stats = probe(*args, **kwargs)
        for key in ("pairs_route_per_cascade", "pairs_lit_per_cascade"):
            stats[key] = stats[key].clone()
            stats[key][0] += 20000
        return stats

    monkeypatch.setattr(diagnostics, "sparse_occupancy", busy_view)
    cfg = port_cfg(shadow_route_windows=(64, 0, 0, 0),
                   shadow_route_caps=(32768, 0, 0, 0),
                   shadow_lit_cascade_caps=(32768, 1024, 1024, 1024),
                   shadow_pen_capacity=1024 * 64)
    drv = retuning(glb, cfg)
    drv.step()
    assert drv._slack_strikes == 1 and drv._overflow_strikes == 0
    drv.step()
    assert drv.retune_count == 1
    assert drv.cfg.shadow_pen_capacity < 1024 * 64
    assert drv.last_occupancy["route_window_sizes"] == (64, 0, 0, 0)
    assert drv.cfg.shadow_route_windows == (64, 0, 0, 0)
    assert drv.cfg.shadow_route_caps[0] >= 20000
    assert drv.cfg.shadow_lit_cascade_caps is not None
    assert np.isfinite(drv.step().numpy()).all()


# ---------------------------------------------------------------------------
# The terminal viewer (tests/test_viewer.py on the port)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def viewer():
    tile = RasterConfig(tile_h=16, tile_w=128)
    cfg = tf.GltfConfig(width=128, height=80, shadow_map_size=64,
                        raster=tile, shadow_raster=tile,
                        flags=tf.GltfFrameFlags(enable_shadows=False,
                                                enable_contact_shadows=False))
    drv = FrameDriver(cfg, autotune=False, device="cpu")   # ground only
    return TerminalViewer(drv, cols=32, fullscreen_size=(256, 160))


def test_esc_exits(viewer):
    viewer.state.running = True
    assert viewer.step(["\x1b"]) is None
    assert not viewer.state.running
    viewer.state.running = True


def test_minimize_skips_frames(viewer):
    viewer.state.running = True
    before = viewer.driver.frame_count
    assert viewer.step(["n"]) is None
    assert viewer.driver.frame_count == before
    viewer.step(["n"])
    assert viewer.driver.frame_count == before + 1


def test_camera_keys_move(viewer):
    viewer.state.running = True
    pos0 = np.array(viewer.driver.camera.position, copy=True)
    viewer.step(["w"], dt=0.1)
    assert not np.allclose(viewer.driver.camera.position, pos0)


def test_ui_focus_consumes_keys(viewer):
    viewer.state.running = True
    viewer.step([])
    viewer.feed(["\t"])
    pos0 = np.array(viewer.driver.camera.position, copy=True)
    soft0 = viewer.driver.ui_data().shadow_softness
    viewer.step(["j", "+", "w"], dt=0.1)
    assert np.allclose(viewer.driver.camera.position, pos0)
    assert viewer.driver.ui_data().shadow_softness > soft0
    viewer.feed(["j"])
    dc0 = viewer.driver.ui_data().debug_cascades
    viewer.feed([" "])
    assert viewer.driver.ui_data().debug_cascades != dc0
    viewer.feed([" "])
    viewer.feed(["\t"])
    viewer.step(["w"], dt=0.1)
    assert not np.allclose(viewer.driver.camera.position, pos0)


def test_f3_toggles_panel(viewer):
    vis = viewer.driver.ui_visible
    viewer.feed(["3"])
    assert viewer.driver.ui_visible != vis
    viewer.feed(["3"])


def test_fullscreen_toggle_resizes(viewer):
    viewer.state.running = True
    viewer.feed(["f"])
    assert (viewer.driver.cfg.width, viewer.driver.cfg.height) == (256, 160)
    viewer.step([])
    assert viewer.driver.readback().shape[:2] == (160, 256)
    viewer.feed(["f"])
    assert (viewer.driver.cfg.width, viewer.driver.cfg.height) == (128, 80)
    viewer.step([])


def test_render_ansi(viewer):
    viewer.state.running = True
    viewer.step([])
    s = viewer.render_ansi()
    assert all("▀" in ln for ln in s.split("\n"))
    assert "\x1b[38;2;" in s


def _cell_inside(viewer, fx0, fy0, fw, fh):
    w, h = viewer.driver.cfg.width, viewer.driver.cfg.height
    cols = min(viewer.cols, w)
    rows = max(2, int(cols * (h / w) * 0.5) * 2)
    for cy in range(1, rows + 1):
        for cx in range(1, cols + 1):
            px, py = viewer._cell_to_pixel(cx, cy)
            if fx0 <= px <= fx0 + fw and fy0 <= py <= fy0 + fh:
                return cx, cy
    return None


def test_mouse_click_toggles_checkbox(viewer):
    viewer.state.running = True
    viewer.state.minimized = False
    viewer.driver.ui_visible = True
    viewer.step([])
    viewer.driver.readback()                 # builds the panel hit boxes
    bx, by, bw, bh = viewer.driver.ui._checkboxes["debug_cascades"]
    cell = _cell_inside(viewer, bx + PANEL_X, by + PANEL_Y, bw, bh)
    assert cell is not None
    dc0 = viewer.driver.ui_data().debug_cascades
    viewer.feed([f"\x1b[<0;{cell[0]};{cell[1]}M"])
    assert viewer.driver.ui_data().debug_cascades != dc0
    viewer.feed([f"\x1b[<0;{cell[0]};{cell[1]}M"])


def test_mouse_scroll_zooms_fov(viewer):
    fov0 = viewer.driver.camera.fov
    viewer.feed(["\x1b[<64;4;4M"])
    assert viewer.driver.camera.fov == pytest.approx(fov0 - 0.1)
    viewer.feed(["\x1b[<64;4;4m"])
    assert viewer.driver.camera.fov == pytest.approx(fov0 - 0.1)
    viewer.feed(["\x1b[<65;4;4M"])
    assert viewer.driver.camera.fov == pytest.approx(fov0)


def test_viewer_failed_frame_preserves_taa_history(viewer):
    drv = viewer.driver
    viewer.state.running = True
    viewer.state.minimized = False
    viewer.step([])
    before = drv.state
    real = drv._frame_fn
    calls = {"n": 0}

    def failing(scene, params, state):
        calls["n"] += 1
        raise RuntimeError("injected transient failure")

    drv._frame_fn = failing
    drv.step([])
    drv._frame_fn = real
    assert calls["n"] == 1 and drv.consecutive_failures == 1
    assert drv.state is before
    drv.step([])
    assert drv.consecutive_failures == 0


# ---------------------------------------------------------------------------
# The demo
# ---------------------------------------------------------------------------

def test_demo_torch_writes_every_output(tmp_path):
    """demo_torch.py --cpu writes demo.py's five images."""
    out = subprocess.run(
        [sys.executable, str(REPO / "demo_torch.py"), "--cpu", "--scale",
         "0.1", "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=600, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    names = sorted(p.name for p in tmp_path.glob("*.png"))
    assert names == ["cube.png", "duck_shadows.png", "duck_shadows_ui.png",
                     "multimesh_pbr.png", "sdf.png"]
