"""ECS-lite: entities, components, resources, systems, schedules (a numpy
copy of funky_tpu/ecs.py; `rotation_system` carries numpy copies of the
quaternion helpers it took from math3d).

The reference embeds Bevy ECS (main.rs:35-215): components are plain structs
(Transform/Velocity/Camera/RenderObject), resources are singletons
(PerformanceStats, FrameTiming, CameraController, SceneObjects,
ShadowSettings), and a Schedule runs systems each frame (rotation_system,
update_performance_stats). This module provides the same model in ~150 lines
of Python — the render side only ever *reads* resources, so a simple dict
store keeps the hot path pure.

Host-side only: nothing here is traced. Per-frame numeric state that feeds
the jitted frame function is pulled out of resources into a params pytree by
the driver.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Tuple, Type, TypeVar

import numpy as np

T = TypeVar("T")


@dataclasses.dataclass
class Transform:
    """main.rs:35-56 — position + quaternion rotation (x,y,z,w) + scale."""
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))


@dataclasses.dataclass
class Velocity:
    """main.rs:58-66 — linear + angular (euler rates, rad/s)."""
    linear: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    angular: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))


@dataclasses.dataclass
class Camera:
    """main.rs:68-80 — marker + projection parameters."""
    fov: float = 45.0
    near: float = 0.1
    far: float = 100.0


class World:
    """Entity/component/resource store (Bevy-`World`-alike)."""

    def __init__(self) -> None:
        self._next_entity = 0
        # component type -> {entity_id: component}
        self._components: Dict[type, Dict[int, object]] = {}
        self._resources: Dict[type, object] = {}

    # -- entities / components ------------------------------------------------
    def spawn(self, *components: object) -> int:
        eid = self._next_entity
        self._next_entity += 1
        for c in components:
            self._components.setdefault(type(c), {})[eid] = c
        return eid

    def despawn(self, eid: int) -> None:
        for store in self._components.values():
            store.pop(eid, None)

    def get(self, eid: int, ctype: Type[T]) -> T:
        return self._components[ctype][eid]  # type: ignore[return-value]

    def query(self, *ctypes: type) -> Iterator[Tuple[int, tuple]]:
        """Iterate (entity, (components...)) over entities having all
        ctypes."""
        if not ctypes:
            return
        stores = [self._components.get(t, {}) for t in ctypes]
        ids = set(stores[0])
        for s in stores[1:]:
            ids &= set(s)
        for eid in sorted(ids):
            yield eid, tuple(s[eid] for s in stores)

    def entity_count(self) -> int:
        ids: set = set()
        for store in self._components.values():
            ids |= set(store)
        return len(ids)

    def component_count(self) -> int:
        return sum(len(s) for s in self._components.values())

    # -- resources ------------------------------------------------------------
    def insert_resource(self, resource: object) -> None:
        self._resources[type(resource)] = resource

    def resource(self, rtype: Type[T]) -> T:
        return self._resources[rtype]  # type: ignore[return-value]

    def has_resource(self, rtype: type) -> bool:
        return rtype in self._resources


class Schedule:
    """Ordered list of systems `fn(world) -> None` (Bevy `Schedule`)."""

    def __init__(self, systems: List[Callable[[World], None]] | None = None):
        self.systems: List[Callable[[World], None]] = list(systems or [])

    def add_system(self, system: Callable[[World], None]) -> "Schedule":
        self.systems.append(system)
        return self

    def run(self, world: World) -> None:
        for system in self.systems:
            system(world)


# ---------------------------------------------------------------------------
# Resources mirroring main.rs:86-174
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrameTiming:
    start_time: float = dataclasses.field(default_factory=time.monotonic)
    delta_time: float = 0.016


@dataclasses.dataclass
class PerformanceStats:
    fps: float = 0.0
    frame_time_ms: float = 0.0
    frame_count: int = 0
    last_fps_update: float | None = None


@dataclasses.dataclass
class SceneObjects:
    """main.rs:140-152."""
    gltf_scale: float = 0.01
    gltf_min_y: float = 0.0


@dataclasses.dataclass
class ShadowSettings:
    """main.rs:155-174 — runtime-tunable shadow config (debug-UI mutable)."""
    debug_cascades: bool = False
    softness: float = 2.5
    use_pcss: bool = True
    use_shadow_taa: bool = True


# ---------------------------------------------------------------------------
# Systems mirroring main.rs:180-215
# ---------------------------------------------------------------------------

def _quat_mul(a, b):
    """Hamilton product a*b in numpy f32 (math3d.py:146-155)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


def _quat_from_euler_yxz(y, x, z):
    """glam `Quat::from_euler(EulerRot::YXZ, y, x, z)` in numpy f32
    (math3d.py:131-143, 158-165)."""
    def axis_quat(angle, axis):
        h = np.float32(angle) * np.float32(0.5)
        q = np.zeros(4, np.float32)
        q[axis] = np.sin(h)
        q[3] = np.cos(h)
        return q

    return _quat_mul(_quat_mul(axis_quat(y, 1), axis_quat(x, 0)),
                     axis_quat(z, 2))


def rotation_system(world: World) -> None:
    """Integrate angular velocity into rotations (main.rs:188-200):
    rotation = Quat::from_euler(YXZ, ay*dt, ax*dt, az*dt) * rotation."""
    dt = world.resource(FrameTiming).delta_time
    for _, (transform, velocity) in world.query(Transform, Velocity):
        ang = velocity.angular
        if np.any(ang != 0.0):
            dq = _quat_from_euler_yxz(float(ang[1]) * dt,
                                      float(ang[0]) * dt,
                                      float(ang[2]) * dt)
            transform.rotation = _quat_mul(
                dq, np.asarray(transform.rotation, np.float32)).astype(
                    np.float32)
        transform.position = (
            transform.position + velocity.linear * dt).astype(np.float32)


def update_performance_stats(world: World) -> None:
    """FPS over 500 ms windows (main.rs:203-215)."""
    stats = world.resource(PerformanceStats)
    stats.frame_count += 1
    now = time.monotonic()
    if stats.last_fps_update is None:
        stats.last_fps_update = now
        return
    elapsed = now - stats.last_fps_update
    if elapsed >= 0.5:
        stats.fps = stats.frame_count / elapsed
        stats.frame_time_ms = 1000.0 / stats.fps if stats.fps > 0 else 0.0
        stats.frame_count = 0
        stats.last_fps_update = now


def setup_scene(world: World) -> None:
    """Startup system (main.rs:180-185): spawn the camera entity."""
    world.spawn(Camera(), Transform())
