"""The camera path a traffic mix describes, made from the seed.

A traffic file names a scene (scenes/<scene>.py) and an orbit:

    {"scene": "multimesh", "model_scale": 1.0, "shadow_softness": 2.5,
     "fov_deg": 45.0, "rad_per_frame": 0.02, "slide": 0.3,
     "slide_rate": 3.0, "first_pose": 0, "poses": 48, "check_frames": 9}

Pose i is bench.py's motion trajectory (bench.py:38-64), frozen here from
funky_tpu_torch/frame.py::orbit_params (lines 277-298) and
default_gltf_params (lines 254-275): the camera orbits the target at
`rad_per_frame` per frame while the model slides by `slide`·sin(rate·a).
The window renders the arc of poses first_pose .. first_pose + poses - 1
forward, then back, and so on (a ping-pong), starting at a point of that
cycle drawn from the seed. Every seed renders the same poses in the same
cycle, so the autotune and the work per cycle are the same whatever the
seed; the seed moves where the window starts, and which frames the output
check keeps (`check_frames` of them).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List

import numpy as np

TARGET = (0.0, 0.6, 0.0)
CAMERA = (0.0, 2.5, 10.0)


@dataclasses.dataclass(frozen=True)
class Pose:
    """One frame's inputs as f32 numbers, the fields of the program's
    GltfParams."""
    camera_pos: np.ndarray       # (3,) f32
    camera_yaw: np.float32
    camera_pitch: np.float32
    camera_fov: np.float32
    duck_position: np.ndarray    # (3,) f32
    duck_scale: np.float32
    shadow_softness: np.float32


def base_pose(traffic: dict, gltf_min_y: float) -> Pose:
    """frame.py:254-275: the camera at CAMERA looking at TARGET, yaw and
    pitch from the f32 direction."""
    position = np.asarray(CAMERA, np.float32)
    d = np.asarray(TARGET, np.float32) - position
    dn = d / np.linalg.norm(d)
    scale = float(traffic["model_scale"])
    return Pose(
        camera_pos=position,
        camera_yaw=np.float32(math.atan2(float(dn[2]), float(dn[0]))),
        camera_pitch=np.float32(math.asin(float(dn[1]))),
        camera_fov=np.float32(math.radians(float(traffic["fov_deg"]))),
        duck_position=np.asarray(
            [0.0, -gltf_min_y * scale + 0.001, 0.0], np.float32),
        duck_scale=np.float32(scale),
        shadow_softness=np.float32(traffic["shadow_softness"]))


def orbit_pose(base: Pose, traffic: dict, i: int) -> Pose:
    """frame.py:277-298 (bench.py:38-64), its numpy arithmetic in f32."""
    a = float(traffic["rad_per_frame"]) * i
    target = np.asarray(TARGET, np.float32)
    rel = np.asarray(CAMERA, np.float32) - target
    rot = np.asarray([[math.cos(a), 0, math.sin(a)],
                      [0, 1, 0],
                      [-math.sin(a), 0, math.cos(a)]], np.float32)
    pos = target + rot @ rel
    d = target - pos
    dn = d / np.linalg.norm(d)
    amp = float(traffic["slide"])
    rate = float(traffic["slide_rate"])
    slide = np.asarray([amp * math.sin(rate * a), 0.0,
                        amp * math.cos(rate * a) - amp], np.float32)
    return dataclasses.replace(
        base,
        camera_pos=np.asarray(pos, np.float32),
        camera_yaw=np.float32(math.atan2(float(dn[2]), float(dn[0]))),
        camera_pitch=np.float32(math.asin(float(dn[1]))),
        duck_position=(base.duck_position + slide).astype(np.float32))


def arc(traffic: dict) -> List[int]:
    """The orbit indices of the arc."""
    first = int(traffic["first_pose"])
    return list(range(first, first + int(traffic["poses"])))


def cycle(n_poses: int) -> int:
    """Frames in one ping-pong over n poses."""
    return max(1, 2 * (n_poses - 1))


def phase(n_poses: int, seed: int) -> int:
    """The point of the cycle at which the window starts, from the seed."""
    return random.Random(seed).randrange(cycle(n_poses))


def position(n_poses: int, frame: int) -> int:
    """The arc position of the cycle's frame: forward, then back without
    repeating the turning pose, and again."""
    p = frame % cycle(n_poses)
    return p if p < n_poses else cycle(n_poses) - p


def tuning_positions(n_poses: int) -> List[int]:
    """The arc positions the autotune walks: forward, then back to the
    start, so that each pose is read after both of its neighbours, the
    order the window renders them in."""
    return [position(n_poses, f) for f in range(cycle(n_poses) + 1)]
