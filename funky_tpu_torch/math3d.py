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


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """math3d.py:40-41."""
    return torch.linalg.cross(a, b)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (math3d.py:44-45)."""
    return (a * b).sum(dim=-1)


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


def quat_identity(device="cuda") -> torch.Tensor:
    """(0, 0, 0, 1) (math3d.py:127-128)."""
    return const([0.0, 0.0, 0.0, 1.0], F32, device)


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


def quat_from_rotation_z(angle: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion (math3d.py:141-143)."""
    h = angle * 0.5
    z = torch.zeros_like(h)
    return torch.stack([z, z, torch.sin(h), torch.cos(h)])


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b, rotation b applied first (math3d.py:146-155,
    glam `Quat::mul`)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_from_euler_yxz(y: torch.Tensor, x: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
    """glam `Quat::from_euler(EulerRot::YXZ, y, x, z)`: intrinsic Y, then
    X, then Z (math3d.py:158-165)."""
    return quat_mul(quat_mul(quat_from_rotation_y(y), quat_from_rotation_x(x)),
                    quat_from_rotation_z(z))


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


def apply_rows(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m.T for (..., K) rows and an (R, K) matrix -> (..., R), or a
    (C, R, K) stack -> (C, ..., R): the K products summed in order k = 0,
    1, ... as separate elementwise ops. Per-pixel products take this
    rather than a matmul, so each output element rounds the same whatever
    the number of rows: cuBLAS picks its kernel, and with it the order of
    summation, by the problem's size, and on an H100 a pixel of a row slab
    then differed from the same pixel of the full frame by an ulp."""
    mk = m.reshape(m.shape[:-2] + (1,) * (x.dim() - 1) + m.shape[-2:])
    out = x[..., 0:1] * mk[..., 0]
    for k in range(1, m.shape[-1]):
        out = out + x[..., k:k + 1] * mk[..., k]
    return out


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """4x4 applied to (..., 3) points with w = 1 (math3d.py:219-222)."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_homogeneous(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """4x4 applied to (..., 3) points -> (..., 4) (math3d.py:225-229)."""
    ones = torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    return torch.cat([p, ones], dim=-1) @ m.T


def transform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A direction rotated by the upper-left 3x3 (math3d.py:232-236)."""
    return v @ m[:3, :3].T


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


def mat4_inverse(m: torch.Tensor) -> torch.Tensor:
    """Analytic 4x4 inverse by cofactor expansion, glam's adjugate
    construction (math3d.py:286-347): an LU inverse in f32 collapses the
    tiny w of inverse-projected far-plane corners to 0."""
    (a, b, c, d), (e, f, g, h), (i, j, k, l), (mm, n, o, p) = (
        tuple(m[r, col] for col in range(4)) for r in range(4))
    kp_lo = k * p - l * o
    jp_ln = j * p - l * n
    jo_kn = j * o - k * n
    ip_lm = i * p - l * mm
    io_km = i * o - k * mm
    in_jm = i * n - j * mm
    gp_ho = g * p - h * o
    fp_hn = f * p - h * n
    fo_gn = f * o - g * n
    ep_hm = e * p - h * mm
    eo_gm = e * o - g * mm
    en_fm = e * n - f * mm
    gl_hk = g * l - h * k
    fl_hj = f * l - h * j
    fk_gj = f * k - g * j
    el_hi = e * l - h * i
    ek_gi = e * k - g * i
    ej_fi = e * j - f * i

    c00 = f * kp_lo - g * jp_ln + h * jo_kn
    c01 = -(e * kp_lo - g * ip_lm + h * io_km)
    c02 = e * jp_ln - f * ip_lm + h * in_jm
    c03 = -(e * jo_kn - f * io_km + g * in_jm)
    inv_det = 1.0 / (a * c00 + b * c01 + c * c02 + d * c03)

    c10 = -(b * kp_lo - c * jp_ln + d * jo_kn)
    c11 = a * kp_lo - c * ip_lm + d * io_km
    c12 = -(a * jp_ln - b * ip_lm + d * in_jm)
    c13 = a * jo_kn - b * io_km + c * in_jm

    c20 = b * gp_ho - c * fp_hn + d * fo_gn
    c21 = -(a * gp_ho - c * ep_hm + d * eo_gm)
    c22 = a * fp_hn - b * ep_hm + d * en_fm
    c23 = -(a * fo_gn - b * eo_gm + c * en_fm)

    c30 = -(b * gl_hk - c * fl_hj + d * fk_gj)
    c31 = a * gl_hk - c * el_hi + d * ek_gi
    c32 = -(a * fl_hj - b * el_hi + d * ej_fi)
    c33 = a * fk_gj - b * ek_gi + c * ej_fi

    adj = torch.stack([
        torch.stack([c00, c10, c20, c30]),
        torch.stack([c01, c11, c21, c31]),
        torch.stack([c02, c12, c22, c32]),
        torch.stack([c03, c13, c23, c33]),
    ])
    return adj * inv_det


def camera_front(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Forward from yaw/pitch, glTF renderer convention (math3d.py:350-361)."""
    f = torch.stack([
        torch.cos(yaw) * torch.cos(pitch),
        torch.sin(pitch),
        torch.sin(yaw) * torch.cos(pitch),
    ])
    return normalize(f)
