"""Raymarched SDF demo scene (port of funky_tpu/models/sdf.py).

A rounded-box pedestal and an animated sphere blended into it, a tilted
spinning torus, and a ground plane, sphere-traced per pixel with SDF soft
shadows and Blinn-Phong shading. The JAX package's `fori_loop`s become
Python loops of the same count and order (MAX_STEPS march steps,
SHADOW_STEPS shadow steps), each step the same element-wise arithmetic.
The frame runs no TPU kernel and gets no hand-written one: every pixel is
dense arithmetic, no gather, no raster.

`compiled_sdf_frame` follows frame.py's rule: on the card the frame, which
has no host branch, is recorded once as a CUDA graph and replayed.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .. import math3d as m3
from ..frame import CompiledFrame

MAX_STEPS = 96
MAX_DIST = 40.0
HIT_EPS = 1e-3
SHADOW_STEPS = 48

SKY_TOP = (0.35, 0.55, 0.85)
SKY_HORIZON = (0.53, 0.81, 0.92)   # the glTF clear colour at the horizon
LIGHT_DIR = (0.5, 1.0, 0.3)        # the glTF scene's key light

_MAT_COLORS = (
    (0.35, 0.35, 0.35),   # ground
    (0.9, 0.6, 0.2),      # blob
    (0.3, 0.6, 0.9),      # torus
)


def _length(v):
    """sdf.py:37-38."""
    return torch.sqrt((v * v).sum(dim=-1) + 1e-20)


def sd_sphere(p, center, radius):
    """sdf.py:41-42; `center` a (3,) tensor on p's device."""
    return _length(p - center) - radius


def sd_round_box(p, center, half, round_r):
    """sdf.py:45-50."""
    q = torch.abs(p - m3.f32(center, p.device)) - m3.f32(half, p.device)
    outside = _length(torch.clamp(q, min=0.0))
    inside = torch.clamp(q.amax(dim=-1), max=0.0)
    return outside + inside - round_r


def sd_torus(p, center, major, minor):
    """sdf.py:53-56."""
    q = p - m3.f32(center, p.device)
    xz = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2 + 1e-20) - major
    return torch.sqrt(xz * xz + q[..., 1] ** 2 + 1e-20) - minor


def sd_plane_y(p, height=0.0):
    """sdf.py:59-60."""
    return p[..., 1] - height


def smooth_min(a, b, k=0.25):
    """sdf.py:63-65."""
    h = torch.clamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b + (a - b) * h - k * h * (1.0 - h)


def scene_sdf(p: torch.Tensor, t: torch.Tensor):
    """The animated scene (sdf.py:68-95): (distance, material id: 0 ground,
    1 sphere blob, 2 torus) at points p (..., 3), time t a 0-d tensor."""
    ground = sd_plane_y(p, 0.0)

    bob = 1.1 + 0.25 * torch.sin(t * 1.3)
    sphere = sd_sphere(p, torch.stack([0.9 * torch.cos(t * 0.7), bob,
                                       0.9 * torch.sin(t * 0.7)]), 0.45)
    pedestal = sd_round_box(p, (0.0, 0.3, 0.0), (0.5, 0.3, 0.5), 0.05)
    blob = smooth_min(sphere, pedestal, 0.3)

    # the torus spins about Y
    c, s = torch.cos(t * 0.5), torch.sin(t * 0.5)
    q = p - m3.f32([0.0, 1.1, 0.0], p.device)
    qr = torch.stack([c * q[..., 0] - s * q[..., 2],
                      q[..., 1],
                      s * q[..., 0] + c * q[..., 2]], dim=-1)
    # tilted by 0.5 rad about X; cos and sin of the constant in f32, as
    # jnp.cos(0.5) computes them
    half = m3.f32(0.5, p.device)
    ct, st = torch.cos(half), torch.sin(half)
    qt = torch.stack([qr[..., 0],
                      ct * qr[..., 1] - st * qr[..., 2],
                      st * qr[..., 1] + ct * qr[..., 2]], dim=-1)
    torus = sd_torus(qt, (0.0, 0.0, 0.0), 1.0, 0.12)

    d = torch.minimum(torch.minimum(ground, blob), torus)
    mat = torch.where(d == ground, 0,
                      torch.where(d == blob, 1, 2)).to(torch.int32)
    return d, mat


@dataclasses.dataclass(frozen=True)
class SdfConfig:
    """sdf.py:105-112."""
    width: int = 960
    height: int = 540

    @property
    def aspect(self) -> float:
        return self.width / self.height


def _normal(p, t):
    """Tetrahedron-offset SDF gradient (sdf.py:115-124)."""
    e = 5e-4
    k = m3.f32([[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], p.device)
    n = torch.zeros_like(p)
    for i in range(4):
        d, _ = scene_sdf(p + e * k[i], t)
        n = n + k[i] * d[..., None]
    return n / torch.clamp(_length(n)[..., None], min=1e-12)


def _soft_shadow(p, light_dir, t, k=12.0):
    """min over the march of k * d / dist (sdf.py:127-140)."""
    dist = torch.full(p.shape[:-1], 0.05, dtype=torch.float32,
                      device=p.device)
    res = torch.ones(p.shape[:-1], dtype=torch.float32, device=p.device)
    for _ in range(SHADOW_STEPS):
        q = p + light_dir * dist[..., None]
        d, _ = scene_sdf(q, t)
        res = torch.minimum(res, k * d / torch.clamp(dist, min=1e-3))
        dist = dist + torch.clamp(d, 0.02, 0.5)
    return torch.clamp(res, 0.0, 1.0)


def render_sdf_frame(time_s, camera_pos: torch.Tensor, yaw: torch.Tensor,
                     pitch: torch.Tensor, fov: torch.Tensor,
                     cfg: SdfConfig) -> torch.Tensor:
    """Sphere-trace the scene (sdf.py:143-215); returns linear RGBA
    (H, W, 4). `time_s` is a number or a 0-d tensor."""
    h, w = cfg.height, cfg.width
    dev = camera_pos.device
    t = m3.f32(time_s, dev)

    front = m3.camera_front(yaw, pitch)
    view = m3.look_at_rh(camera_pos, camera_pos + front,
                         m3.f32([0.0, 1.0, 0.0], dev))
    # camera basis from the view matrix rows (world space)
    right = view[0, :3]
    up = view[1, :3]
    fwd = -view[2, :3]

    tan_half = torch.tan(fov * 0.5)
    px = (torch.arange(w, dtype=torch.float32, device=dev)[None, :]
          + 0.5) / w * 2.0 - 1.0
    py = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
          + 0.5) / h * 2.0 - 1.0
    # +py is down on screen (Vulkan row order)
    dirs = (fwd[None, None]
            + right[None, None] * (px * tan_half * cfg.aspect)[..., None]
            - up[None, None] * (py * tan_half)[..., None])
    dirs = dirs / _length(dirs)[..., None]

    origin = camera_pos.expand(dirs.shape)
    dist = torch.zeros((h, w), dtype=torch.float32, device=dev)
    hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for _ in range(MAX_STEPS):
        p = origin + dirs * dist[..., None]
        d, _ = scene_sdf(p, t)
        hit = hit | (d < HIT_EPS)
        step = torch.where(hit, 0.0, d)
        dist = torch.clamp(dist + step, max=MAX_DIST)
    hit = hit & (dist < MAX_DIST)

    p = origin + dirs * dist[..., None]
    n = _normal(p, t)
    _, mat = scene_sdf(p, t)
    base = m3.f32(_MAT_COLORS, dev)[mat.clamp(0, 2).long()]

    light = m3.f32(LIGHT_DIR, dev)
    light = light / _length(light)
    diff = torch.clamp((n * light).sum(dim=-1), min=0.0)
    shadow = _soft_shadow(p + n * 2e-3, light, t)

    view_dir = -dirs
    half = light + view_dir
    half = half / _length(half)[..., None]
    spec = torch.pow(torch.clamp((n * half).sum(dim=-1), min=0.0), 32.0)

    ao = torch.clamp(0.5 + 0.5 * n[..., 1], 0.0, 1.0)  # cheap sky occlusion
    color = (0.22 * base * ao[..., None]
             + 0.75 * diff[..., None] * shadow[..., None] * base
             + 0.25 * spec[..., None] * shadow[..., None])

    # distance fog into the horizon colour
    fog = 1.0 - torch.exp(-0.02 * dist)
    horizon = m3.f32(SKY_HORIZON, dev)
    color = color * (1 - fog[..., None]) + horizon * fog[..., None]

    # zenith-dark gradient: SKY_TOP for up-facing rays, the horizon colour
    # at and below the horizon
    sky_t = torch.clamp(dirs[..., 1] * 2.0 + 0.5, 0.0, 1.0)
    sky = (m3.f32(SKY_TOP, dev) * sky_t[..., None]
           + horizon * (1 - sky_t[..., None]))

    rgb = torch.where(hit[..., None], color, sky)
    return torch.cat([rgb, torch.ones((h, w, 1), dtype=torch.float32,
                                      device=dev)], dim=-1)


class _CompiledSdf(CompiledFrame):
    """(time_s, camera_pos, yaw, pitch, fov) -> rgba; eager on the CPU, a
    replayed CUDA graph on the card. `time_s` may be a number: it is
    filled into the graph's input on the card."""

    def __init__(self, cfg: SdfConfig):
        super().__init__(functools.partial(render_sdf_frame, cfg=cfg), True)

    def __call__(self, time_s, camera_pos, yaw, pitch, fov):
        if not self.uses_graph(camera_pos.device):
            self.last = None
            return self.eager(time_s, camera_pos, yaw, pitch, fov)
        inputs = [time_s, camera_pos, yaw, pitch, fov]
        g = self._graph(None, camera_pos.device,
                        lambda *xs: (self.eager(*xs),), inputs)
        (rgba,) = g(inputs)
        return rgba.clone()


@functools.lru_cache(maxsize=8)
def compiled_sdf_frame(cfg: SdfConfig) -> _CompiledSdf:
    """The cached frame callable (sdf.py:218-220)."""
    return _CompiledSdf(cfg)


def default_sdf_camera(device="cuda"):
    """(camera_pos, yaw, pitch, fov) looking from (3.2, 2.2, 3.2) at
    (0, 0.9, 0) with a 50 degree fov (sdf.py:223-234)."""
    pos = torch.tensor([3.2, 2.2, 3.2], dtype=torch.float32)
    target = torch.tensor([0.0, 0.9, 0.0], dtype=torch.float32)
    d = target - pos
    dn = d / torch.linalg.vector_norm(d)
    yaw = math.atan2(float(dn[2]), float(dn[0]))
    pitch = math.asin(float(dn[1]))
    return (pos.to(device), m3.f32(yaw, "cpu").to(device),
            m3.f32(pitch, "cpu").to(device),
            m3.f32(math.radians(50.0), "cpu").to(device))
