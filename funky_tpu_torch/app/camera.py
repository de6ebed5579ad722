"""Fly-camera controller — exact port of the reference input semantics (a
numpy copy of funky_tpu/app/camera.py).

Reference: `CameraController` resource (main.rs:107-137) and
`App::update_camera` (main.rs:274-349):

- WASD moves along the *yaw/pitch-consistent* forward (projected to the
  ground plane: forward.y forced to 0) and right = forward x up.
- Q/E move straight down/up.
- Arrow keys rotate; pitch clamped to +/-89 deg, yaw wrapped to [0, 2pi).
- Z/X (and scroll) zoom by changing FOV, clamped to [10 deg, 120 deg].
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterable, Set

import numpy as np


class Keys(enum.Enum):
    W = "w"
    A = "a"
    S = "s"
    D = "d"
    Q = "q"
    E = "e"
    Z = "z"
    X = "x"
    LEFT = "left"
    RIGHT = "right"
    UP = "up"
    DOWN = "down"


MAX_PITCH = math.radians(89.0)
TAU = 2.0 * math.pi


def _default_yaw_pitch() -> tuple[float, float]:
    # Spawn looking at the origin-placed duck (main.rs:119-127).
    position = np.array([0.0, 2.5, 10.0])
    target = np.array([0.0, 0.6, 0.0])
    d = target - position
    n = np.linalg.norm(d)
    d = d / n if n > 0 else np.array([0.0, 0.0, 1.0])
    yaw = math.atan2(d[2], d[0])
    pitch = max(-MAX_PITCH, min(MAX_PITCH, math.asin(d[1])))
    return yaw, pitch


@dataclasses.dataclass
class CameraController:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 2.5, 10.0], np.float32))
    yaw: float = dataclasses.field(default_factory=lambda: _default_yaw_pitch()[0])
    pitch: float = dataclasses.field(default_factory=lambda: _default_yaw_pitch()[1])
    fov: float = math.radians(45.0)
    move_speed: float = 5.0
    rotate_speed: float = 3.0
    zoom_speed: float = 0.5


def update_camera(camera: CameraController,
                  keys_pressed: Iterable[Keys],
                  delta_time: float) -> CameraController:
    """Advance the camera one frame (pure: returns a new controller).

    Matches main.rs:274-349 step for step, including the ground-projected
    forward vector and the clamping/wrapping rules.
    """
    keys: Set[Keys] = set(keys_pressed)
    speed = camera.move_speed * delta_time
    rot_speed = camera.rotate_speed * delta_time

    pos = np.asarray(camera.position, np.float64).copy()
    yaw, pitch, fov = camera.yaw, camera.pitch, camera.fov

    forward = np.array([
        math.cos(yaw) * math.cos(pitch),
        0.0,
        math.sin(yaw) * math.cos(pitch),
    ])
    if float(forward @ forward) < 1e-6:
        forward = np.array([0.0, 0.0, 1.0])
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)

    if Keys.W in keys:
        pos += forward * speed
    if Keys.S in keys:
        pos -= forward * speed
    if Keys.A in keys:
        pos -= right * speed
    if Keys.D in keys:
        pos += right * speed
    if Keys.Q in keys:
        pos[1] -= speed
    if Keys.E in keys:
        pos[1] += speed

    if Keys.LEFT in keys:
        yaw -= rot_speed
    if Keys.RIGHT in keys:
        yaw += rot_speed
    if Keys.UP in keys:
        pitch = max(-MAX_PITCH, min(MAX_PITCH, pitch + rot_speed))
    if Keys.DOWN in keys:
        pitch = max(-MAX_PITCH, min(MAX_PITCH, pitch - rot_speed))

    yaw = yaw % TAU  # rem_euclid

    if Keys.Z in keys:
        fov = max(math.radians(10.0),
                  min(math.radians(120.0), fov - camera.zoom_speed * delta_time))
    if Keys.X in keys:
        fov = max(math.radians(10.0),
                  min(math.radians(120.0), fov + camera.zoom_speed * delta_time))

    return dataclasses.replace(
        camera, position=pos.astype(np.float32), yaw=yaw, pitch=pitch, fov=fov)


def apply_scroll_zoom(camera: CameraController, scroll_lines: float) -> CameraController:
    """Mouse-wheel FOV zoom (main.rs:534-541): fov -= 0.1 rad per scroll
    line, clamped to [10 deg, 120 deg]."""
    fov = camera.fov - 0.1 * scroll_lines
    fov = max(math.radians(10.0), min(math.radians(120.0), fov))
    return dataclasses.replace(camera, fov=fov)
