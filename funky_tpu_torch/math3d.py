"""glam-equivalent 3D math (port of funky_tpu/math3d.py).

Same conventions as the reference: column vectors (p' = M @ p), RH look-at,
0..1 clip depth, the Vulkan Y flip in `perspective_vk`, quaternions as
(x, y, z, w). Scalars that the JAX code turns into f32 arrays are turned
into f32 tensors here before any arithmetic, so every product rounds in
f32 exactly where XLA rounds.
"""

from __future__ import annotations

import contextlib

import torch

F32 = torch.float32

# The store of `kept_constants` while its block runs, else None.
_KEPT = None


@contextlib.contextmanager
def kept_constants(store: dict):
    """Inside the block, `const` returns the tensor `store` holds for the
    same host value, dtype and device, and uploads a value only the first
    time. frame.py's compiled frames run the eager warm-up and then the
    CUDA graph capture inside one such block: the warm-up uploads every
    constant the frame makes, the capture reads the same tensors (a copy
    from pageable host memory cannot be captured), and the store keeps
    them alive for the graph's replays. Nothing writes to a constant."""
    global _KEPT
    saved, _KEPT = _KEPT, store
    try:
        yield store
    finally:
        _KEPT = saved


def const(x, dtype, device) -> torch.Tensor:
    """A host value as a tensor of `dtype` on `device`, copied without
    blocking: the host does not wait for the card's queue to drain."""
    host = torch.tensor(x, dtype=dtype)
    if _KEPT is None:
        return host.to(device, non_blocking=True)
    key = (str(torch.device(device)), dtype, tuple(host.shape),
           host.numpy().tobytes())
    if key not in _KEPT:
        _KEPT[key] = host.to(device)
    return _KEPT[key]


def f32(x, device) -> torch.Tensor:
    """x as a float32 tensor on `device` (a tensor input keeps its data,
    a host value goes through `const`)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F32)
    return const(x, F32, device)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize the last axis (math3d.py:30-37, eps=0 form)."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def look_at_rh(eye, center, up) -> torch.Tensor:
    """glam `Mat4::look_at_rh` (math3d.py:48-65)."""
    f = normalize(center - eye)
    s = normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    zero = eye.new_zeros(())
    one = eye.new_ones(())
    return torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        torch.stack([zero, zero, zero, one]),
    ])


def perspective_rh(fovy: torch.Tensor, aspect, near, far) -> torch.Tensor:
    """glam `Mat4::perspective_rh`, depth in [0, 1] (math3d.py:68-87)."""
    dev = fovy.device
    f = 1.0 / torch.tan(fovy * 0.5)
    zero = torch.zeros((), dtype=F32, device=dev)
    one = torch.ones((), dtype=F32, device=dev)
    near = f32(near, dev)
    far = f32(far, dev)
    aspect = f32(aspect, dev)
    r = far / (near - far)
    return torch.stack([
        torch.stack([f / aspect, zero, zero, zero]),
        torch.stack([zero, f, zero, zero]),
        torch.stack([zero, zero, r, r * near]),
        torch.stack([zero, zero, -one, zero]),
    ])


def perspective_vk(fovy, aspect, near, far) -> torch.Tensor:
    """perspective_rh with the Vulkan Y flip (math3d.py:90-95)."""
    m = perspective_rh(fovy, aspect, near, far).clone()
    m[1, 1] = m[1, 1] * -1.0
    return m


def orthographic_rh(left, right, bottom, top, near, far) -> torch.Tensor:
    """glam `Mat4::orthographic_rh`, depth in [0, 1] (math3d.py:98-120).
    All arguments are 0-d f32 tensors on one device."""
    rw = 1.0 / (right - left)
    rh = 1.0 / (top - bottom)
    rd = 1.0 / (near - far)
    zero = torch.zeros_like(rw)
    one = torch.ones_like(rw)
    return torch.stack([
        torch.stack([2.0 * rw, zero, zero, -(right + left) * rw]),
        torch.stack([zero, 2.0 * rh, zero, -(top + bottom) * rh]),
        torch.stack([zero, zero, rd, near * rd]),
        torch.stack([zero, zero, zero, one]),
    ])


def quat_from_rotation_x(angle: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion (math3d.py:131-133)."""
    h = angle * 0.5
    z = torch.zeros_like(h)
    return torch.stack([torch.sin(h), z, z, torch.cos(h)])


def quat_from_rotation_y(angle: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion (math3d.py:136-138)."""
    h = angle * 0.5
    z = torch.zeros_like(h)
    return torch.stack([z, torch.sin(h), z, torch.cos(h)])


def mat3_from_quat(q: torch.Tensor) -> torch.Tensor:
    """math3d.py:168-178."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def mat4_from_scale_rotation_translation(scale, rotation,
                                         translation) -> torch.Tensor:
    """glam `Mat4::from_scale_rotation_translation` (math3d.py:181-192)."""
    if scale.ndim == 0:
        scale = scale.expand(3)
    r = mat3_from_quat(rotation) * scale[None, :]
    m = torch.eye(4, dtype=F32, device=rotation.device)
    m[:3, :3] = r
    m[:3, 3] = translation
    return m


def mat4_from_translation(t: torch.Tensor) -> torch.Tensor:
    """math3d.py:195-197."""
    m = torch.eye(4, dtype=F32, device=t.device)
    m[:3, 3] = t
    return m


def mat4_from_rotation_y(angle: torch.Tensor) -> torch.Tensor:
    """math3d.py:200-203."""
    return mat4_from_scale_rotation_translation(
        torch.ones(3, dtype=F32, device=angle.device),
        quat_from_rotation_y(angle),
        torch.zeros(3, dtype=F32, device=angle.device))


def mat4_from_rotation_x(angle: torch.Tensor) -> torch.Tensor:
    """math3d.py:206-209."""
    return mat4_from_scale_rotation_translation(
        torch.ones(3, dtype=F32, device=angle.device),
        quat_from_rotation_x(angle),
        torch.zeros(3, dtype=F32, device=angle.device))


def mat4_from_scale(s: torch.Tensor) -> torch.Tensor:
    """math3d.py:212-216."""
    if s.ndim == 0:
        s = s.expand(3)
    return torch.diag(torch.cat([s, torch.ones(1, dtype=F32,
                                               device=s.device)]))


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """4x4 applied to (..., 3) points with w = 1 (math3d.py:219-222)."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_homogeneous(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """4x4 applied to (..., 3) points -> (..., 4) (math3d.py:225-229)."""
    ones = torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    return torch.cat([p, ones], dim=-1) @ m.T


def rigid_inverse(view: torch.Tensor) -> torch.Tensor:
    """[R^T | -R^T t] (math3d.py:239-247)."""
    r = view[:3, :3]
    t = view[:3, 3]
    inv = torch.eye(4, dtype=F32, device=view.device)
    inv[:3, :3] = r.T
    inv[:3, 3] = -(r.T @ t)
    return inv


def perspective_inverse(proj: torch.Tensor) -> torch.Tensor:
    """Cancellation-free closed-form inverse of a perspective_rh matrix
    (math3d.py:250-277)."""
    a = proj[0, 0]
    b = proj[1, 1]
    c = proj[2, 2]
    d = proj[2, 3]
    near = d / c
    far = d / (c + 1.0)
    inv_near = 1.0 / near
    inv_far = 1.0 / far
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)
    return torch.stack([
        torch.stack([1.0 / a, zero, zero, zero]),
        torch.stack([zero, 1.0 / b, zero, zero]),
        torch.stack([zero, zero, zero, -one]),
        torch.stack([zero, zero, inv_far - inv_near, inv_near]),
    ])


def view_proj_inverse(view, proj) -> torch.Tensor:
    """math3d.py:280-283."""
    return rigid_inverse(view) @ perspective_inverse(proj)


def camera_front(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Forward from yaw/pitch, glTF renderer convention (math3d.py:350-361)."""
    f = torch.stack([
        torch.cos(yaw) * torch.cos(pitch),
        torch.sin(pitch),
        torch.sin(yaw) * torch.cos(pitch),
    ])
    return normalize(f)
