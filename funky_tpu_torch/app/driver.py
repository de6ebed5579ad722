"""Headless frame driver, the app shell (port of funky_tpu/app/driver.py).

- The "swapchain" is framebuffer readback: frames are enqueued on the card
  and the host waits only in `readback()` / `save_png()` (and once at the
  end of `run`).
- Input is an explicit set of Keys fed to `step()`.
- ECS systems run per frame (rotation, perf stats); resources feed the
  per-frame params exactly like update_uniform_buffer's arguments.
- Resize, a flag change or a re-tune makes a new GltfConfig and so a new
  cached frame (frame.compiled_gltf_frame): on the card a committed config
  records one CUDA graph per config and replays it, updating the state in
  place; any other config runs eagerly.
- Frame failures are caught, the frame is skipped and the loop stays
  alive; the third failure in a row re-raises.

FrameDriver renders on `device` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from .. import ecs
from ..frame import (FrameState, GltfConfig, GltfParams, compiled_gltf_frame,
                     init_frame_state)
from ..math3d import f32
from ..models.gltf import GltfScene
from ..models.png_io import linear_to_srgb, write_png
from ..models.scene import DeviceScene, build_device_scene
from ..utils.profiling import FpsCounter, device_info
from .camera import CameraController, Keys, update_camera
from .ui import DebugPanel, UiChanges, UiData


class FrameDriver:
    """Owns world + scene + temporal state; steps frames (driver.py:41)."""

    def __init__(self, cfg: GltfConfig,
                 scene_path: Optional[str | Path] = None,
                 device_scene: Optional[DeviceScene] = None,
                 enable_ui: bool = True,
                 sanitize: bool = False,
                 autotune: bool = True,
                 retune_check_every: int = 240,
                 retune_after: int = 2,
                 device="cuda",
                 gltf_scale: float = 0.01) -> None:
        # sanitize: per-frame NaN/Inf guard over the outputs
        # (utils/sanitize.assert_finite; a host read per tensor, debug
        # only). autotune: measure this scene's occupancy at start-up and
        # tighten every sparse capacity (utils/autotune); while on, the
        # driver re-checks the occupancy every `retune_check_every` frames
        # and re-derives the config after `retune_after` consecutive
        # overflowing or slack checks (driver.py:52-62). gltf_scale: the
        # model's initial scale (SceneObjects; 0.01 is main.rs's, for the
        # Duck), set before the start-up tune measures the scene.
        self.device = torch.device(device)
        self.cfg = cfg
        self.sanitize = sanitize
        self.autotune = autotune
        self.retune_check_every = retune_check_every
        self.retune_after = retune_after
        self._overflow_strikes = 0
        self._slack_strikes = 0
        self.retune_count = 0
        self.last_occupancy: Optional[dict] = None   # the last probe's
        self.world = ecs.World()
        self.world.insert_resource(ecs.FrameTiming())
        self.world.insert_resource(ecs.PerformanceStats())
        self.world.insert_resource(ecs.SceneObjects(gltf_scale=gltf_scale))
        self.world.insert_resource(ecs.ShadowSettings())
        self.camera = CameraController()
        self.schedule = ecs.Schedule([ecs.rotation_system])
        ecs.setup_scene(self.world)

        if device_scene is not None:
            self.device_scene = device_scene
        else:
            gltf = None
            if scene_path is not None:
                # Model path search list (main.rs:388-393 degrades
                # gracefully to the ground plane).
                try:
                    gltf = GltfScene.load(scene_path)
                    self.world.resource(ecs.SceneObjects).gltf_min_y = float(
                        gltf.bounds_min[1])
                except (OSError, ValueError) as e:  # no-model fallback
                    print(f"glTF load failed ({e}); rendering ground only")
            self.device_scene = build_device_scene(gltf, device=self.device)

        if autotune:
            from ..utils.autotune import autotune_config

            self.cfg = cfg = autotune_config(self.device_scene,
                                             self._params(), cfg)

        self._frame_fn = compiled_gltf_frame(cfg)
        self.state: FrameState = init_frame_state(cfg, self.device)
        self.fps = FpsCounter()
        self._last_image = None
        self.last_params: Optional[GltfParams] = None
        self.ui = (DebugPanel(cfg.width, cfg.height, self.device)
                   if enable_ui else None)
        self.ui_visible = True
        self.frame_count = 0
        # One bad frame is skipped (the reference early-returns per error
        # branch, main.rs:601-667); persistent failure re-raises.
        self.consecutive_failures = 0
        self.max_consecutive_failures = 3
        self.last_error = ""

    # -- params assembly (main.rs:680-714) ------------------------------------
    def _params(self) -> GltfParams:
        objects = self.world.resource(ecs.SceneObjects)
        shadows = self.world.resource(ecs.ShadowSettings)
        duck_y = -objects.gltf_min_y * objects.gltf_scale + 0.001
        dev = self.device
        return GltfParams(
            camera_pos=f32(np.asarray(self.camera.position, np.float32), dev),
            camera_yaw=f32(self.camera.yaw, dev),
            camera_pitch=f32(self.camera.pitch, dev),
            camera_fov=f32(self.camera.fov, dev),
            duck_position=f32([0.0, duck_y, 0.0], dev),
            duck_scale=f32(objects.gltf_scale, dev),
            shadow_softness=f32(shadows.softness, dev),
        )

    def _sync_flags(self) -> None:
        """ShadowSettings -> static frame flags; a change selects another
        cached frame, like binding a different pipeline."""
        shadows = self.world.resource(ecs.ShadowSettings)
        flags = dataclasses.replace(
            self.cfg.flags,
            use_pcss=shadows.use_pcss,
            use_shadow_taa=shadows.use_shadow_taa,
            debug_cascades=shadows.debug_cascades)
        if flags != self.cfg.flags:
            self.cfg = dataclasses.replace(self.cfg, flags=flags)
            self._frame_fn = compiled_gltf_frame(self.cfg)

    # -- frame loop ------------------------------------------------------------
    def step(self, keys: Iterable[Keys] = (), dt: Optional[float] = None):
        """One frame: input -> ECS -> camera -> enqueue the frame."""
        timing = self.world.resource(ecs.FrameTiming)
        timing.delta_time = dt if dt is not None else 0.016
        self.schedule.run(self.world)
        ecs.update_performance_stats(self.world)
        self.camera = update_camera(self.camera, keys, timing.delta_time)
        self._sync_flags()

        params = self._params()
        try:
            image, self.state = self._frame_fn(
                self.device_scene, params, self.state)
        except Exception as e:  # keep the loop alive (main.rs:601-613)
            self.consecutive_failures += 1
            self.last_error = f"frame {self.frame_count}: {e}"
            print(f"frame {self.frame_count} failed "
                  f"({self.consecutive_failures} consecutive): {e}")
            if self.consecutive_failures >= self.max_consecutive_failures:
                raise
            # Keep the previous FrameState, so one transient failure does
            # not reset TAA history (the reference early-returns with its
            # GPU state intact). A graph replay updates the state in place:
            # a failure during one leaves it half written, and only then
            # is it rebuilt (the reference rebuilds when the donated
            # buffers were consumed, driver.py:171-173).
            graph = getattr(self._frame_fn, "last", None)
            if graph is not None and graph.replaying:
                self.state = init_frame_state(self.cfg, self.device)
                print("  the failure came during a graph replay: the "
                      "frame state was rebuilt")
            else:
                print("  the previous frame state was kept")
            return self._last_image
        if self.sanitize:
            from ..utils.sanitize import assert_finite

            assert_finite({"image": image, "state": self.state._asdict()},
                          label=f"frame {self.frame_count}")
        self.consecutive_failures = 0
        self.last_error = ""
        self._last_image = image
        self.last_params = params
        self.frame_count += 1
        self.fps.tick()
        if (self.autotune and self.retune_check_every
                and self.frame_count % self.retune_check_every == 0):
            self._maybe_retune(params)
        return image

    def _maybe_retune(self, params: GltfParams) -> None:
        """The runtime half of autotune (driver.py:190-249): probe the
        current view's occupancy and re-derive the sparse capacities after
        `retune_after` consecutive overflowing or slack checks.

        The probe is the reference's: utils/diagnostics.sparse_occupancy on
        this view with the config's own light windows. It measures no
        candidate windows, so the re-derived config keeps the config's
        light_window_sizes, which leaves a synth_window_fit overflow in
        place (autotune.py:276), and it adopts no route, which also turns
        off the radius-only split (autotune.py:112). Both are the
        reference's behaviour, kept on purpose (tests/test_torch_app.py)."""
        from ..utils.autotune import (capacity_overflows, capacity_slack,
                                      derive_sparse_config)
        from ..utils.diagnostics import sparse_occupancy

        try:
            stats = sparse_occupancy(self.device_scene, params, self.state,
                                     self.cfg,
                                     self.cfg.effective_light_windows())
            occ = {k: (int(v) if np.asarray(v.cpu()).size == 1
                       else tuple(int(x) for x in np.asarray(v.cpu()).ravel()))
                   for k, v in stats.items()}
            over = capacity_overflows(self.cfg, occ)
            slack = [] if over else capacity_slack(self.cfg, occ)
            self.last_occupancy = occ
        except Exception as e:  # diagnostics must never kill the loop
            print(f"occupancy probe failed ({e}); skipping retune check")
            return
        if not over and not slack:
            self._overflow_strikes = 0
            self._slack_strikes = 0
            return
        if over:
            self._slack_strikes = 0
            self._overflow_strikes += 1
            if self._overflow_strikes < self.retune_after:
                return
            reason = f"{', '.join(over)} overflowed"
        else:
            self._overflow_strikes = 0
            self._slack_strikes += 1
            if self._slack_strikes < self.retune_after:
                return
            reason = f"{', '.join(slack)} oversized >= 2x"
        self._overflow_strikes = 0
        self._slack_strikes = 0
        self.retune_count += 1
        print(f"re-autotune #{self.retune_count}: {reason}; "
              f"re-deriving capacities")
        self.cfg = derive_sparse_config(self.cfg, occ)
        self._frame_fn = compiled_gltf_frame(self.cfg)

    def resize(self, width: int, height: int) -> None:
        """Swapchain-recreation equivalent: a new config at the new extent
        and fresh extent-sized temporal state (driver.py:251-258)."""
        self.cfg = dataclasses.replace(self.cfg, width=width, height=height)
        self._frame_fn = compiled_gltf_frame(self.cfg)
        self.state = init_frame_state(self.cfg, self.device)
        if self.ui is not None:
            self.ui = DebugPanel(width, height, self.device)

    def toggle_ui(self) -> None:  # F3 (main.rs:505-512)
        self.ui_visible = not self.ui_visible

    # -- output ----------------------------------------------------------------
    def readback(self, srgb: bool = True) -> np.ndarray:
        """Wait for and fetch the last frame, the debug panel composited
        over it on the card when visible."""
        img = self._last_image
        if img is None:
            raise RuntimeError("no frame rendered yet")
        if self.ui is not None and self.ui_visible:
            img = self._composite_ui(img)
        img = img.cpu().numpy()
        if srgb:
            img = linear_to_srgb(img[..., :3])
        return np.asarray(img)

    def _composite_ui(self, image):
        data = self.ui_data()
        return self.ui.render_over(image, data)

    def ui_data(self) -> UiData:
        objects = self.world.resource(ecs.SceneObjects)
        shadows = self.world.resource(ecs.ShadowSettings)
        return UiData(
            fps=self.fps.fps,
            frame_time_ms=self.fps.frame_time_ms,
            gltf_scale=objects.gltf_scale,
            debug_cascades=shadows.debug_cascades,
            shadow_softness=shadows.softness,
            use_pcss=shadows.use_pcss,
            use_shadow_taa=shadows.use_shadow_taa,
            entity_count=self.world.entity_count(),
            component_count=self.world.component_count(),
            gpu_info=device_info(self.device),
            last_error=self.last_error,
        )

    def apply_ui_changes(self, changes: UiChanges) -> None:
        """UI mutations -> ECS resources (main.rs:779-790)."""
        objects = self.world.resource(ecs.SceneObjects)
        shadows = self.world.resource(ecs.ShadowSettings)
        if changes.gltf_scale is not None:
            objects.gltf_scale = changes.gltf_scale
        if changes.debug_cascades is not None:
            shadows.debug_cascades = changes.debug_cascades
        if changes.shadow_softness is not None:
            shadows.softness = changes.shadow_softness
        if changes.use_pcss is not None:
            shadows.use_pcss = changes.use_pcss
        if changes.use_shadow_taa is not None:
            shadows.use_shadow_taa = changes.use_shadow_taa

    def save_png(self, path: str | Path) -> None:
        write_png(path, self.readback())

    # -- checkpoint / resume ----------------------------------------------------
    # The session's whole state is plain dataclasses and tensors, so it
    # pickles with the tensors as numpy arrays (driver.py:314-342).
    def save_state(self, path: str | Path) -> None:
        import pickle

        data = {
            "camera": self.camera,
            "scene_objects": self.world.resource(ecs.SceneObjects),
            "shadow_settings": self.world.resource(ecs.ShadowSettings),
            "frame_state": [x.cpu().numpy() for x in self.state],
            "frame_count": self.frame_count,
            "ui_visible": self.ui_visible,
        }
        Path(path).write_bytes(pickle.dumps(data))

    def load_state(self, path: str | Path) -> None:
        import pickle

        data = pickle.loads(Path(path).read_bytes())
        self.camera = data["camera"]
        self.world.insert_resource(data["scene_objects"])
        self.world.insert_resource(data["shadow_settings"])
        self.state = FrameState(*(torch.from_numpy(x).to(self.device)
                                  for x in data["frame_state"]))
        self.frame_count = data["frame_count"]
        self.ui_visible = data["ui_visible"]
        self._sync_flags()

    def title(self) -> str:
        """Window-title string (main.rs:351-360)."""
        return (f"Funky Renderer | FPS: {self.fps.fps:.1f} | "
                f"Frame: {self.fps.frame_time_ms:.2f}ms | "
                f"ECS + PyTorch/{self.device.type.upper()}")

    def run(self, n_frames: int, keys: Iterable[Keys] = ()) -> float:
        """Headless loop; returns the steady-state FPS (frames enqueued
        ahead, one final synchronize: the frames-in-flight model)."""
        img = None
        for _ in range(n_frames):
            img = self.step(keys)
        if img is not None and img.device.type == "cuda":
            torch.cuda.synchronize(img.device)
        return self.fps.fps
