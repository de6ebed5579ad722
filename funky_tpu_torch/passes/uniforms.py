"""Per-frame uniforms: view/proj, cascade splits, light matrices
(port of funky_tpu/passes/uniforms.py). Runs on the device of its inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import math3d as m3

SHADOW_CASCADE_COUNT = 4
SHADOW_MAP_SIZE = 2048
NEAR_PLANE = 0.1
FAR_PLANE = 100.0
CASCADE_LAMBDA = 0.6
LIGHT_DIR_WORLD = (0.5, 1.0, 0.3)


class FrameUniforms(NamedTuple):
    """uniforms.py:35-50."""
    view: torch.Tensor             # (4, 4)
    proj: torch.Tensor             # (4, 4) Y-flipped
    view_proj: torch.Tensor        # (4, 4)
    camera_pos: torch.Tensor       # (3,)
    light_dir: torch.Tensor        # (3,) normalized
    light_view_proj: torch.Tensor  # (4, 4, 4) per cascade
    cascade_splits: torch.Tensor   # (4,)
    shadow_map_size: torch.Tensor  # (4,) (w, h, 1/w, 1/h)
    debug_flags: torch.Tensor      # (4,) debug, pcss, taa, frame index
    shadow_bias: torch.Tensor      # (4,) x = softness
    prev_view_proj: torch.Tensor   # (4, 4)
    models: torch.Tensor           # (O, 4, 4)


def cascade_splits(device) -> torch.Tensor:
    """Practical split scheme (uniforms.py:53-59)."""
    i = torch.arange(1, SHADOW_CASCADE_COUNT + 1, dtype=torch.float32,
                     device=device)
    p = i / SHADOW_CASCADE_COUNT
    log_split = NEAR_PLANE * torch.pow(m3.f32(FAR_PLANE / NEAR_PLANE,
                                              device), p)
    uni_split = NEAR_PLANE + (FAR_PLANE - NEAR_PLANE) * p
    return CASCADE_LAMBDA * log_split + (1.0 - CASCADE_LAMBDA) * uni_split


def _light_dir(device) -> torch.Tensor:
    return m3.normalize(m3.f32(LIGHT_DIR_WORLD, device))


def fit_cascades(view: torch.Tensor, proj: torch.Tensor,
                 splits: torch.Tensor,
                 shadow_map_size: int = SHADOW_MAP_SIZE) -> torch.Tensor:
    """Stabilized ortho light frustum per cascade (uniforms.py:62-141).
    Returns (4, 4, 4) lightViewProj."""
    dev = view.device
    inv_view_proj = m3.view_proj_inverse(view, proj)
    ndc = m3.f32([
        [-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 0.0],
        [-1.0, -1.0, 1.0], [1.0, -1.0, 1.0], [1.0, 1.0, 1.0], [-1.0, 1.0, 1.0],
    ], dev)
    corners_h = m3.transform_homogeneous(inv_view_proj, ndc)
    frustum = corners_h[:, :3] / corners_h[:, 3:4]
    light_dir = _light_dir(dev)
    up = torch.where(torch.abs(light_dir[1]) > 0.9,
                     m3.f32([0.0, 0.0, 1.0], dev),
                     m3.f32([0.0, 1.0, 0.0], dev))
    near4 = frustum[:4]
    far4 = frustum[4:]
    prev_splits = torch.cat([m3.f32([NEAR_PLANE], dev), splits[:-1]])

    def fit_one(prev_split, split):
        t0 = torch.clamp((prev_split - NEAR_PLANE) / (FAR_PLANE - NEAR_PLANE),
                         0.0, 1.0)
        t1 = torch.clamp((split - NEAR_PLANE) / (FAR_PLANE - NEAR_PLANE),
                         0.0, 1.0)
        corners = torch.cat([
            near4 + (far4 - near4) * t0,
            near4 + (far4 - near4) * t1,
        ])
        center = corners.mean(dim=0)
        radius = torch.linalg.vector_norm(corners - center, dim=1).max()
        radius = torch.clamp(radius, min=1.0)
        light_pos = center + light_dir * (radius * 2.5)
        light_view = m3.look_at_rh(light_pos, center, up)

        ls = m3.transform_point(light_view, corners)
        mn = ls.min(dim=0).values
        mx = ls.max(dim=0).values

        pad_xy = radius * 0.05
        left = mn[0] - pad_xy
        right = mx[0] + pad_xy
        bottom = mn[1] - pad_xy
        top = mx[1] + pad_xy

        width = torch.clamp(right - left, min=0.001)
        height = torch.clamp(top - bottom, min=0.001)
        texel_x = width / shadow_map_size
        texel_y = height / shadow_map_size
        cx = 0.5 * (left + right)
        cy = 0.5 * (bottom + top)
        # jnp.round and torch.round both round half to even.
        dx = torch.round(cx / texel_x) * texel_x - cx
        dy = torch.round(cy / texel_y) * texel_y - cy
        left, right = left + dx, right + dx
        bottom, top = bottom + dy, top + dy

        pad_z = radius * 0.2
        near_dist = torch.clamp(-mx[2] - pad_z, min=0.1)
        far_dist = torch.maximum(-mn[2] + pad_z, near_dist + 0.1)

        light_proj = m3.orthographic_rh(left, right, bottom, top,
                                        near_dist, far_dist)
        return light_proj @ light_view

    return torch.stack([fit_one(prev_splits[c], splits[c])
                        for c in range(splits.shape[0])])


def compute_uniforms(camera_pos, camera_yaw, camera_pitch, camera_fov,
                     aspect_ratio, duck_position, duck_scale,
                     prev_view_proj, has_prev, frame_index,
                     debug_cascades, use_pcss, use_shadow_taa,
                     shadow_softness,
                     shadow_map_size: int = SHADOW_MAP_SIZE) -> FrameUniforms:
    """The UBO computation (uniforms.py:144-199). Tensor inputs are 0-d or
    small f32 tensors on one device; the flags are Python bools."""
    dev = camera_pos.device
    front = m3.camera_front(camera_yaw, camera_pitch)
    target = camera_pos + front
    view = m3.look_at_rh(camera_pos, target, m3.f32([0.0, 1.0, 0.0], dev))
    proj = m3.perspective_vk(camera_fov, aspect_ratio, NEAR_PLANE, FAR_PLANE)
    view_proj = proj @ view

    prev_vp = torch.where(has_prev, prev_view_proj, view_proj)

    splits = cascade_splits(dev)
    light_vp = fit_cascades(view, proj, splits, shadow_map_size)

    duck_rot = m3.quat_from_rotation_y(m3.f32(math.pi, dev))
    duck_model = m3.mat4_from_scale_rotation_translation(
        duck_scale, duck_rot, duck_position)
    models = torch.stack([torch.eye(4, dtype=torch.float32, device=dev),
                          duck_model])

    s = float(shadow_map_size)
    frame_f = torch.remainder(frame_index.to(torch.float32), 1024.0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    return FrameUniforms(
        view=view,
        proj=proj,
        view_proj=view_proj,
        camera_pos=camera_pos,
        light_dir=_light_dir(dev),
        light_view_proj=light_vp,
        cascade_splits=splits,
        shadow_map_size=m3.f32([s, s, 1.0 / s, 1.0 / s], dev),
        debug_flags=torch.stack([
            m3.f32(float(debug_cascades), dev),
            m3.f32(float(use_pcss), dev),
            m3.f32(float(use_shadow_taa), dev),
            frame_f,
        ]),
        shadow_bias=torch.stack([shadow_softness, zero, zero, zero]),
        prev_view_proj=prev_vp,
        models=models,
    )
