"""The plain reference of one glTF frame: dense, in plain PyTorch.

What a frame is, as funky_tpu defines it (frame.py:895-1027 of the JAX
package, and the reference renderer gltf_renderer.rs it ports): per-frame
uniforms and four stabilised shadow cascades; each cascade's depth map
rastered from every triangle; the main visibility pass after near-plane
clipping; deferred attributes; PCSS (or PCF) on the cascade pair of each
pixel, blended; shadow TAA against the carried history; screen-space
contact shadows against the previous frame's depth; the glTF shading.
The frame returns the linear RGBA and the state the next frame reads.

Every pixel runs every stage here: no classification, compaction,
capacity, window, synthesized map, packed layout, kernel or graph. Those
are the program's ways of computing the same frame. The arithmetic of
each stage is frozen from the port's dense path, which follows the JAX
package op by op: funky_tpu_torch/passes/uniforms.py (lines 22-171),
geometry.py (15-48), ops/binning.py::triangle_setup_corners (41-101),
ops/clipping.py::expand_near_clipped (27-105), ops/raster.py::
_rasterize_torch (124-166, here over whole frames), passes/deferred.py
(15-92), passes/shadow_filter.py (53-347), passes/taa.py (35-133),
passes/contact.py (51-245, 325-358), passes/shading.py (60-125) and
math3d.py.

`store`, where given, is applied to every buffer a stage hands to the
next (the cascade maps, the depth, the G-buffer, the history, the colour):
identity for the reference, a rounding to a lower precision for the
control.

A configuration names its plain reference module (`"reference"` in its
file, this one by default). Each provides `Options`, `options(config_file,
frame)`, `Pose`, `State`, `init_state` and `render`. The frame is cut into
stages so that another module can import them and replace one: `front`
(uniforms, cascade maps, main raster, G-buffer), the shadow filter
(`cascaded_shadow`, from `project`, `filter_one`, `shadow_phi` and
`blend`), and `finish` (TAA, contact, shading, the next state).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .scene import FLAG_USE_TEXTURE, Scene

F32 = torch.float32
NEAR, FAR = 0.1, 100.0
CASCADES = 4
CASCADE_LAMBDA = 0.6
LIGHT_DIR = (0.5, 1.0, 0.3)
CLEAR = (0.53, 0.81, 0.92)
BLOCKER_SAMPLES = 16
PCF_SAMPLES = 16
GOLDEN_ANGLE = 2.4
CLIP_W_EPS = NEAR * 0.1
SETUP_W_EPS = 1e-6
LINEAR_STEPS = 8
BISECTION_STEPS = 4
TRACE_DISTANCE = 0.5
DEPTH_THICKNESS = 0.05
MAX_DARKNESS = 0.8
_FILL_DIR = (-0.5, 0.3, -0.8)


class Options(NamedTuple):
    width: int
    height: int
    shadow_map_size: int
    use_pcss: bool = True
    use_shadow_taa: bool = True
    enable_contact_shadows: bool = True


# Flags of a configuration that change the frame, with the value this
# reference follows: a configuration that sets another needs a reference
# of its own.
FOLLOWS = {"light_space_ground_shadows": False,
           "skip_backfacing_shadows": False, "half_res_shadows": False,
           "shadow_eval_scale": 1, "debug_cascades": False,
           "enable_shadows": True}


def check_flags(flags: dict, follows: dict) -> None:
    """Raise where the configuration's flags leave what `follows` holds."""
    off = {k: flags[k] for k, v in follows.items()
           if k in flags and flags[k] != v}
    if off:
        raise ValueError(f"the plain reference does not follow {off}")


def options(config_file: dict, frame: dict, follows: dict = FOLLOWS
            ) -> Options:
    """The Options of a configuration file's flags at the frame size
    `frame` (its "frame" entry, or a smaller one), refusing flags that
    leave `follows` (a reference module's FOLLOWS)."""
    flags = config_file["flags"]
    check_flags(flags, follows)
    return Options(frame["width"], frame["height"], frame["shadow_map_size"],
                   **{k: flags[k] for k in ("use_pcss", "use_shadow_taa",
                                            "enable_contact_shadows")})


class Pose(NamedTuple):
    camera_pos: torch.Tensor
    camera_yaw: torch.Tensor
    camera_pitch: torch.Tensor
    camera_fov: torch.Tensor
    duck_position: torch.Tensor
    duck_scale: torch.Tensor
    shadow_softness: torch.Tensor


class State(NamedTuple):
    shadow_history: torch.Tensor  # (H, W, 2)
    prev_depth: torch.Tensor      # (H, W)
    prev_view_proj: torch.Tensor  # (4, 4)
    has_prev: torch.Tensor        # () bool
    frame_index: torch.Tensor     # () int32


def init_state(opt: Options, device) -> State:
    return State(
        shadow_history=torch.ones((opt.height, opt.width, 2), dtype=F32,
                                  device=device),
        prev_depth=torch.ones((opt.height, opt.width), dtype=F32,
                              device=device),
        prev_view_proj=torch.eye(4, dtype=F32, device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
        frame_index=torch.zeros((), dtype=torch.int32, device=device))


def _t(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=F32).to(dev)


# --- math (math3d.py) ------------------------------------------------------

def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _look_at(eye, center, up):
    f = _normalize(center - eye)
    s = _normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    zero, one = eye.new_zeros(()), eye.new_ones(())
    return torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        torch.stack([zero, zero, zero, one])])


def _perspective_vk(fovy, aspect, near, far):
    dev = fovy.device
    f = 1.0 / torch.tan(fovy * 0.5)
    zero = torch.zeros((), dtype=F32, device=dev)
    one = torch.ones((), dtype=F32, device=dev)
    near, far, aspect = _t(near, dev), _t(far, dev), _t(aspect, dev)
    r = far / (near - far)
    m = torch.stack([
        torch.stack([f / aspect, zero, zero, zero]),
        torch.stack([zero, f, zero, zero]),
        torch.stack([zero, zero, r, r * near]),
        torch.stack([zero, zero, -one, zero])])
    m[1, 1] = m[1, 1] * -1.0
    return m


def _orthographic(left, right, bottom, top, near, far):
    rw = 1.0 / (right - left)
    rh = 1.0 / (top - bottom)
    rd = 1.0 / (near - far)
    zero, one = torch.zeros_like(rw), torch.ones_like(rw)
    return torch.stack([
        torch.stack([2.0 * rw, zero, zero, -(right + left) * rw]),
        torch.stack([zero, 2.0 * rh, zero, -(top + bottom) * rh]),
        torch.stack([zero, zero, rd, near * rd]),
        torch.stack([zero, zero, zero, one])])


def _view_proj_inverse(view, proj):
    r, tv = view[:3, :3], view[:3, 3]
    rinv = torch.eye(4, dtype=F32, device=view.device)
    rinv[:3, :3] = r.T
    rinv[:3, 3] = -(r.T @ tv)
    a, b, c, d = proj[0, 0], proj[1, 1], proj[2, 2], proj[2, 3]
    near = d / c
    far = d / (c + 1.0)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    pinv = torch.stack([
        torch.stack([1.0 / a, zero, zero, zero]),
        torch.stack([zero, 1.0 / b, zero, zero]),
        torch.stack([zero, zero, zero, -one]),
        torch.stack([zero, zero, 1.0 / far - 1.0 / near, 1.0 / near])])
    return rinv @ pinv


def _apply_rows(x, m):
    """x @ m.T with the K products summed in order as elementwise ops; a
    (C, R, K) stack gives (C, ..., R)."""
    mk = m.reshape(m.shape[:-2] + (1,) * (x.dim() - 1) + m.shape[-2:])
    out = x[..., 0:1] * mk[..., 0]
    for k in range(1, m.shape[-1]):
        out = out + x[..., k:k + 1] * mk[..., k]
    return out


def _model_matrix(scale, position):
    """Mat4::from_scale_rotation_translation with a half turn about y."""
    h = _t(math.pi, position.device) * 0.5
    z = torch.zeros_like(h)
    x, y, qz, w = z, torch.sin(h), z, torch.cos(h)
    x2, y2, z2 = x + x, y + y, qz + qz
    xx, yy, zz = x * x2, y * y2, qz * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    rot = torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1)], dim=-2)
    m = torch.eye(4, dtype=F32, device=position.device)
    m[:3, :3] = rot * scale.expand(3)[None, :]
    m[:3, 3] = position
    return m


# --- uniforms (uniforms.py) ------------------------------------------------

class Uniforms(NamedTuple):
    view: torch.Tensor
    proj: torch.Tensor
    view_proj: torch.Tensor
    camera_pos: torch.Tensor
    light_dir: torch.Tensor
    light_view_proj: torch.Tensor
    splits: torch.Tensor
    texel: torch.Tensor
    frame: torch.Tensor
    softness: torch.Tensor
    prev_view_proj: torch.Tensor
    models: torch.Tensor


def _fit_cascades(view, proj, splits, size):
    dev = view.device
    inv = _view_proj_inverse(view, proj)
    ndc = _t([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [1.0, 1.0, 0.0],
              [-1.0, 1.0, 0.0], [-1.0, -1.0, 1.0], [1.0, -1.0, 1.0],
              [1.0, 1.0, 1.0], [-1.0, 1.0, 1.0]], dev)
    ones = torch.ones((8, 1), dtype=F32, device=dev)
    corners_h = torch.cat([ndc, ones], dim=-1) @ inv.T
    frustum = corners_h[:, :3] / corners_h[:, 3:4]
    light_dir = _normalize(_t(LIGHT_DIR, dev))
    up = torch.where(torch.abs(light_dir[1]) > 0.9, _t([0.0, 0.0, 1.0], dev),
                     _t([0.0, 1.0, 0.0], dev))
    near4, far4 = frustum[:4], frustum[4:]
    prev = torch.cat([_t([NEAR], dev), splits[:-1]])
    out = []
    for c in range(splits.shape[0]):
        t0 = torch.clamp((prev[c] - NEAR) / (FAR - NEAR), 0.0, 1.0)
        t1 = torch.clamp((splits[c] - NEAR) / (FAR - NEAR), 0.0, 1.0)
        corners = torch.cat([near4 + (far4 - near4) * t0,
                             near4 + (far4 - near4) * t1])
        center = corners.mean(dim=0)
        radius = torch.clamp(torch.linalg.vector_norm(
            corners - center, dim=1).max(), min=1.0)
        light_view = _look_at(center + light_dir * (radius * 2.5), center, up)
        ls = corners @ light_view[:3, :3].T + light_view[:3, 3]
        mn, mx = ls.min(dim=0).values, ls.max(dim=0).values
        pad = radius * 0.05
        left, right = mn[0] - pad, mx[0] + pad
        bottom, top = mn[1] - pad, mx[1] + pad
        tx = torch.clamp(right - left, min=0.001) / size
        ty = torch.clamp(top - bottom, min=0.001) / size
        cx, cy = 0.5 * (left + right), 0.5 * (bottom + top)
        dx = torch.round(cx / tx) * tx - cx
        dy = torch.round(cy / ty) * ty - cy
        left, right, bottom, top = left + dx, right + dx, bottom + dy, top + dy
        pad_z = radius * 0.2
        near_d = torch.clamp(-mx[2] - pad_z, min=0.1)
        far_d = torch.maximum(-mn[2] + pad_z, near_d + 0.1)
        out.append(_orthographic(left, right, bottom, top, near_d, far_d)
                   @ light_view)
    return torch.stack(out)


def uniforms(pose: Pose, state: State, opt: Options) -> Uniforms:
    dev = pose.camera_pos.device
    yaw, pitch = pose.camera_yaw, pose.camera_pitch
    front = _normalize(torch.stack([torch.cos(yaw) * torch.cos(pitch),
                                    torch.sin(pitch),
                                    torch.sin(yaw) * torch.cos(pitch)]))
    view = _look_at(pose.camera_pos, pose.camera_pos + front,
                    _t([0.0, 1.0, 0.0], dev))
    proj = _perspective_vk(pose.camera_fov, opt.width / opt.height, NEAR,
                           FAR)
    view_proj = proj @ view
    i = torch.arange(1, CASCADES + 1, dtype=F32, device=dev)
    p = i / CASCADES
    log_split = NEAR * torch.pow(_t(FAR / NEAR, dev), p)
    splits = (CASCADE_LAMBDA * log_split
              + (1.0 - CASCADE_LAMBDA) * (NEAR + (FAR - NEAR) * p))
    s = float(opt.shadow_map_size)
    models = torch.stack([torch.eye(4, dtype=F32, device=dev),
                          _model_matrix(pose.duck_scale, pose.duck_position)])
    return Uniforms(
        view=view, proj=proj, view_proj=view_proj,
        camera_pos=pose.camera_pos,
        light_dir=_normalize(_t(LIGHT_DIR, dev)),
        light_view_proj=_fit_cascades(view, proj, splits, opt.shadow_map_size),
        splits=splits, texel=_t(1.0 / s, dev),
        frame=torch.remainder(state.frame_index.to(F32), 1024.0),
        softness=pose.shadow_softness,
        prev_view_proj=torch.where(state.has_prev, state.prev_view_proj,
                                   view_proj),
        models=models)


# --- geometry, setup, clipping, raster ---------------------------------------

def transform(scene: Scene, models, view_proj):
    """geometry.py:19-40."""
    onehot = (scene.vert_object[:, None] == torch.arange(
        models.shape[0], dtype=torch.int32, device=models.device)[None, :]
              ).to(F32)
    rot, trans = models[:, :3, :3], models[:, :3, 3]
    world = (torch.einsum("vo,voi->vi", onehot,
                          torch.einsum("vj,oij->voi", scene.positions, rot))
             + onehot @ trans)
    nrm = torch.einsum("vo,voi->vi", onehot,
                       torch.einsum("vj,oij->voi", scene.normals, rot))
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1,
                                                     keepdim=True), min=1e-12)
    ones = torch.ones((world.shape[0], 1), dtype=F32, device=world.device)
    clip = torch.cat([world, ones], dim=-1) @ view_proj.T
    return world, clip, nrm


def setup(tri_clip, width: int, height: int, valid):
    """Edge and depth planes of each triangle in pixel space
    (binning.py:37-104): (T, 12) planes and (T,) valid."""
    w = tri_clip[..., 3]
    w_ok = torch.all(w > SETUP_W_EPS, dim=-1)
    inv_w = 1.0 / torch.where(w > SETUP_W_EPS, w, 1.0)
    ndc = tri_clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)
    sy = (ndc[..., 1] + 1.0) * (0.5 * height)
    sz = ndc[..., 2]
    x0, y0, x1, y1 = sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1]
    x2, y2 = sx[:, 2], sy[:, 2]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    area_ok = torch.abs(area) > 1e-12
    inv_area = torch.where(area_ok, 1.0 / torch.where(area_ok, area, 1.0),
                           0.0)

    def edge(ax, ay, bx, by):
        return -(by - ay), bx - ax, (by - ay) * ax - (bx - ax) * ay

    e = [edge(x1, y1, x2, y2), edge(x2, y2, x0, y0), edge(x0, y0, x1, y1)]
    co = [k * inv_area for ed in e for k in ed]
    za = co[0] * sz[:, 0] + co[3] * sz[:, 1] + co[6] * sz[:, 2]
    zb = co[1] * sz[:, 0] + co[4] * sz[:, 1] + co[7] * sz[:, 2]
    zc = co[2] * sz[:, 0] + co[5] * sz[:, 1] + co[8] * sz[:, 2]
    bx0 = torch.minimum(torch.minimum(x0, x1), x2).clamp(0.0, float(width))
    by0 = torch.minimum(torch.minimum(y0, y1), y2).clamp(0.0, float(height))
    bx1 = torch.maximum(torch.maximum(x0, x1), x2).clamp(0.0, float(width))
    by1 = torch.maximum(torch.maximum(y0, y1), y2).clamp(0.0, float(height))
    ok = w_ok & area_ok & (bx1 > bx0) & (by1 > by0) & valid
    planes = torch.stack(co + [za, zb, zc], dim=-1)
    return torch.where(ok[:, None], planes, 0.0), ok


def raster(planes, ok, width: int, height: int):
    """Depth test LESS against 1.0, z in [0, 1), ties to the lower id: every
    triangle over the whole frame in id order. Returns (tri_id, depth)."""
    dev = planes.device
    px = torch.arange(width, dtype=F32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=F32, device=dev)[:, None] + 0.5
    zbuf = torch.ones((height, width), dtype=F32, device=dev)
    ids = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    for t in torch.nonzero(ok).flatten().tolist():
        d = planes[t]
        b0 = d[0] * px + d[1] * py + d[2]
        b1 = d[3] * px + d[4] * py + d[5]
        b2 = d[6] * px + d[7] * py + d[8]
        z = d[9] * px + d[10] * py + d[11]
        cover = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (z >= 0.0) & (z < zbuf)
        zbuf = torch.where(cover, z, zbuf)
        ids = torch.where(cover, t, ids)
    return ids, zbuf


def near_clip(tri_clip, blocks, tri_flags, num_triangles: int):
    """Triangles crossing w = CLIP_W_EPS split into up to two, appended
    after the originals, A halves then B halves, in id order
    (clipping.py:27-105)."""
    dev = tri_clip.device
    t = tri_clip.shape[0]
    inside = tri_clip[..., 3] > CLIP_W_EPS
    n_in = inside.sum(dim=-1)
    real = torch.arange(t, device=dev) < num_triangles
    sel = torch.nonzero((n_in > 0) & (n_in < 3) & real).flatten()
    c, b, f, ins = tri_clip[sel], blocks[sel], tri_flags[sel], inside[sel]
    cnt = ins.sum(dim=-1)
    idx_in = torch.argmax(ins.to(torch.uint8), dim=-1)
    idx_out = torch.argmax((~ins).to(torch.uint8), dim=-1)
    r = torch.where(cnt == 1, idx_in, (idx_out + 1) % 3)
    perm = ((r[:, None] + torch.arange(3, device=dev)[None, :]) % 3)[..., None]
    cr = torch.gather(c, 1, perm.expand(-1, -1, c.shape[-1]))
    br = torch.gather(b, 1, perm.expand(-1, -1, b.shape[-1]))
    wr = cr[..., 3]

    def isect(wa, wb):
        d = wb - wa
        tt = (CLIP_W_EPS - wa) / torch.where(torch.abs(d) > 1e-30, d, 1e-30)
        return tt.clamp(0.0, 1.0)[:, None]

    e = torch.eye(3, dtype=F32, device=dev)
    t01, t02, t12 = isect(wr[:, 0], wr[:, 1]), isect(wr[:, 0], wr[:, 2]), \
        isect(wr[:, 1], wr[:, 2])
    is1 = (cnt == 1)[:, None]
    q0 = e[0].expand(t01.shape[0], 3)
    q1 = torch.where(is1, e[0] * (1.0 - t01) + e[1] * t01, e[1])
    q2 = torch.where(is1, e[0] * (1.0 - t02) + e[2] * t02,
                     e[1] * (1.0 - t12) + e[2] * t12)
    q3 = e[0] * (1.0 - t02) + e[2] * t02
    quad = torch.stack([q0, q1, q2, q3], dim=1)
    quad_clip = torch.einsum("kqj,kjc->kqc", quad, cr)
    attr = torch.einsum("kqj,kjc->kqc", quad, br[..., :-1])
    inv_w = 1.0 / torch.clamp(quad_clip[..., 3], min=1e-12)
    quad_blocks = torch.cat([attr, inv_w[..., None]], dim=-1)

    def corners_b(q):
        return torch.cat([q[:, 0:1], q[:, 2:4]], dim=1)

    valid_orig = real & torch.all(inside, dim=-1)
    return (torch.cat([tri_clip, quad_clip[:, 0:3], corners_b(quad_clip)]),
            torch.cat([blocks, quad_blocks[:, 0:3], corners_b(quad_blocks)]),
            torch.cat([tri_flags, f, f]),
            torch.cat([valid_orig, torch.ones_like(cnt, dtype=torch.bool),
                       cnt == 2]))


def shadow_maps(world, scene: Scene, light_view_proj, size: int):
    """Each cascade's depth raster of every triangle: (C, S, S), 1.0 empty."""
    ones = torch.ones((world.shape[0], 1), dtype=F32, device=world.device)
    hom = torch.cat([world, ones], dim=-1)
    valid = (torch.arange(scene.tri_indices.shape[0], device=world.device)
             < scene.num_triangles)
    maps = []
    for c in range(light_view_proj.shape[0]):
        clip = hom @ light_view_proj[c].T
        planes, ok = setup(clip[scene.tri_indices], size, size, valid)
        maps.append(raster(planes, ok, size, size)[1])
    return torch.stack(maps)


# --- deferred (deferred.py) ----------------------------------------------------

class GBuffer(NamedTuple):
    valid: torch.Tensor
    world: torch.Tensor
    normal: torch.Tensor
    uv: torch.Tensor
    color: torch.Tensor
    flags: torch.Tensor


def interpolate(tri_id, planes, blocks, tri_flags) -> GBuffer:
    h, w = tri_id.shape
    dev = tri_id.device
    px = (torch.arange(w, dtype=F32, device=dev)[None, :] + 0.5).expand(h, w)
    py = (torch.arange(h, dtype=F32, device=dev)[:, None] + 0.5).expand(h, w)
    valid = tri_id >= 0
    safe = tri_id.clamp(min=0).long()
    p = planes[safe][..., :9]
    bl = blocks[safe]
    b = torch.stack([p[..., 0] * px + p[..., 1] * py + p[..., 2],
                     p[..., 3] * px + p[..., 4] * py + p[..., 5],
                     p[..., 6] * px + p[..., 7] * py + p[..., 8]], dim=-1)
    pw = b * bl[..., 11]
    denom = pw.sum(dim=-1, keepdim=True)
    wt = pw / torch.where(torch.abs(denom) > 1e-20, denom, 1.0)
    attrs = (wt[..., 0:1] * bl[..., 0, :11] + wt[..., 1:2] * bl[..., 1, :11]) \
        + wt[..., 2:3] * bl[..., 2, :11]
    return GBuffer(valid=valid, world=attrs[..., 0:3],
                   normal=attrs[..., 3:6], uv=attrs[..., 6:8],
                   color=attrs[..., 8:11],
                   flags=torch.where(valid, tri_flags[safe], 0))


# --- samplers ----------------------------------------------------------------

def _to_i32(x):
    """XLA's saturating f32 -> int32: NaN -> 0, out of range clamped."""
    x = torch.nan_to_num(x, nan=0.0)
    big = x >= 2147483648.0
    i = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(big, torch.full_like(i, 2147483647), i)


def _nearest_border(maps, layer, uv):
    """NEAREST + CLAMP_TO_BORDER (white) of (L, S, S) at per-entry layer."""
    s = maps.shape[1]
    ix = _to_i32(torch.floor(uv[..., 0] * s))
    iy = _to_i32(torch.floor(uv[..., 1] * s))
    inb = (ix >= 0) & (ix < s) & (iy >= 0) & (iy < s)
    d = maps[layer.long(), iy.clamp(0, s - 1).long(), ix.clamp(0, s - 1).long()]
    return torch.where(inb, d, 1.0)


def _compare(maps, layer, uv, ref):
    """Hardware 2x2 PCF, LESS_OR_EQUAL, a tap off the map lit."""
    s = maps.shape[1]
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = _to_i32(x0f), _to_i32(y0f)
    lay = layer.long()

    def tap(iy, ix):
        inb = (iy >= 0) & (iy < s) & (ix >= 0) & (ix < s)
        d = maps[lay, iy.clamp(0, s - 1).long(), ix.clamp(0, s - 1).long()]
        return torch.where(inb, (ref <= d).to(F32), 1.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _nearest_edge(img, uv):
    h, w = img.shape[0], img.shape[1]
    ix = _to_i32(torch.floor(uv[..., 0] * w)).clamp(0, w - 1)
    iy = _to_i32(torch.floor(uv[..., 1] * h)).clamp(0, h - 1)
    return img[iy.long(), ix.long()]


def _texture(tex, sizes, layer, uv):
    """Bilinear REPEAT of per-entry texture layers."""
    n = tex.shape[0]
    oh = layer[..., None] == torch.arange(n, dtype=torch.int32,
                                          device=layer.device)
    h = torch.where(oh, sizes[:, 0], 0.0).sum(-1)
    w = torch.where(oh, sizes[:, 1], 0.0).sum(-1)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    ix = _to_i32(torch.remainder(x0f, w))
    iy = _to_i32(torch.remainder(y0f, h))
    hp, wp = tex.shape[1], tex.shape[2]
    ix1 = torch.remainder(ix + 1, wp)
    iy1 = torch.remainder(iy + 1, hp)
    lay = layer.long()

    def at(yy, xx):
        return tex[lay, yy.long(), xx.long()]

    top = at(iy, ix) * (1 - fx) + at(iy, ix1) * fx
    bot = at(iy1, ix) * (1 - fx) + at(iy1, ix1) * fx
    return top * (1 - fy) + bot * fy


# --- shadow filter (shadow_filter.py:53-345) ---------------------------------

def _ign(p):
    d = p[..., 0] * 0.06711056 + p[..., 1] * 0.00583715
    return torch.remainder(52.9829189 * torch.remainder(d, 1.0), 1.0)


def _sum_taps(x):
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _vogel(count: int, phi):
    i = torch.arange(count, dtype=F32, device=phi.device).reshape(
        (count,) + (1,) * phi.ndim)
    r = torch.sqrt(i + 0.5) / torch.full((), float(count),
                                         device=phi.device).sqrt()
    theta = i * GOLDEN_ANGLE + phi[None]
    return r * torch.cos(theta), r * torch.sin(theta)


def cascade_blend(view_depth, splits):
    s0, s1, s2 = splits[0], splits[1], splits[2]
    f0 = torch.clamp(0.10 * s0, min=0.5)
    f1 = torch.clamp(0.10 * s1, min=0.5)
    f2 = torch.clamp(0.10 * s2, min=0.5)

    def smooth(e0, e1, x):
        t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    in0 = (view_depth > s0 - f0) & (view_depth < s0 + f0)
    in1 = (view_depth > s1 - f1) & (view_depth < s1 + f1)
    in2 = (view_depth > s2 - f2) & (view_depth < s2 + f2)
    base = ((view_depth >= s0).to(torch.int32)
            + (view_depth >= s1).to(torch.int32)
            + (view_depth >= s2).to(torch.int32))
    c0 = torch.where(in0, 0, torch.where(in1, 1, torch.where(in2, 2, base)))
    c1 = torch.where(in0, 1, torch.where(in1, 2, torch.where(in2, 3, base)))
    t = torch.where(in0, smooth(s0 - f0, s0 + f0, view_depth),
                    torch.where(in1, smooth(s1 - f1, s1 + f1, view_depth),
                                torch.where(in2, smooth(s2 - f2, s2 + f2,
                                                        view_depth), 0.0)))
    return c0.to(torch.int32), c1.to(torch.int32), t


def project(uni: Uniforms, cascade, world, normal, n_dot_l):
    """The normal-offset point in each pixel's cascade: (uv, receiver depth
    less the slope bias, uv inside the map)."""
    biased = world + normal * (0.02 * (1.0 - n_dot_l))[..., None]
    ones = torch.ones(biased.shape[:-1] + (1,), dtype=F32,
                      device=biased.device)
    clip_all = _apply_rows(torch.cat([biased, ones], dim=-1),
                           uni.light_view_proj)
    proj_all = clip_all[..., :3] / clip_all[..., 3:4]
    idx = cascade.long()[None, ..., None].expand((1,) + proj_all.shape[1:])
    proj = torch.gather(proj_all, 0, idx)[0]
    uv = proj[..., :2] * 0.5 + 0.5
    receiver = proj[..., 2] - (0.0008 + 0.0025 * (1.0 - n_dot_l))
    in_bounds = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
                 & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
    return uv, receiver, in_bounds


def filter_one(uni: Uniforms, maps, cascade, world, normal, n_dot_l, phi,
               use_pcss: bool):
    """One cascade's PCSS or PCF: (v, m1, m2, kernel radius)."""
    uv, receiver, in_bounds = project(uni, cascade, world, normal, n_dot_l)
    texel = uni.texel
    one = torch.ones_like(receiver)
    if use_pcss:
        light = uni.softness * 2.0
        dx, dy = _vogel(BLOCKER_SAMPLES, phi)
        off = torch.stack([dx, dy], dim=-1) * (light * texel)
        d = _nearest_border(maps, cascade[None], uv[None] + off)
        hit = d < receiver[None]
        bsum = _sum_taps(torch.where(hit, d, 0.0))
        bcnt = _sum_taps(hit.to(F32))
        has = bcnt > 0.0
        bdepth = bsum / torch.clamp(bcnt, min=1.0)
        pen = torch.clamp((receiver - bdepth) / torch.clamp(bdepth, min=1e-8)
                          * light, min=0.5)
        pen = torch.minimum(pen, light * 2.0)
        dx, dy = _vogel(PCF_SAMPLES, phi)
        off = torch.stack([dx, dy], dim=-1) * (pen * texel)[None, ..., None]
        s = _compare(maps, cascade[None], uv[None] + off, receiver[None])
        m1 = _sum_taps(s) / PCF_SAMPLES
        m2 = _sum_taps(s * s) / PCF_SAMPLES
        lit = ~has | ~in_bounds
        return (torch.where(lit, one, m1), torch.where(lit, one, m1),
                torch.where(lit, one, m2), torch.where(lit, 0.0, pen))
    radius = torch.clamp(uni.softness, min=0.5)
    offs = _t([[ox, oy] for oy in (-1, 0, 1) for ox in (-1, 0, 1)],
              uv.device) * texel
    s3 = _compare(maps, cascade[None],
                  uv[None] + offs.reshape((9,) + (1,) * receiver.ndim + (2,)),
                  receiver[None])
    dx, dy = _vogel(PCF_SAMPLES, phi)
    s = _compare(maps, cascade[None],
                 uv[None] + torch.stack([dx, dy], dim=-1) * (radius * texel),
                 receiver[None])
    small = radius <= 1.25
    m1 = torch.where(small, _sum_taps(s3) / 9.0, _sum_taps(s) / PCF_SAMPLES)
    m2 = torch.where(small, _sum_taps(s3 * s3) / 9.0,
                     _sum_taps(s * s) / PCF_SAMPLES)
    kernel = torch.where(small, 1.0, radius.expand_as(receiver))
    return (torch.where(in_bounds, m1, one), torch.where(in_bounds, m1, one),
            torch.where(in_bounds, m2, one),
            torch.where(in_bounds, kernel, 0.0))


def shadow_phi(uni: Uniforms, frag, use_taa: bool):
    """The Vogel rotation at screen points `frag`, animated with TAA."""
    offset = torch.stack([uni.frame * 13.37, uni.frame * 17.17])
    p = frag + offset if use_taa else frag
    return _ign(p) * 6.2831853


def blend(a, b, t):
    """The two cascades' results, blended by t."""
    return tuple(x + (y - x) * t for x, y in zip(a, b))


def cascaded_shadow(uni: Uniforms, maps, world, normal, n_dot_l, view_depth,
                    frag, use_pcss: bool, use_taa: bool):
    c0, c1, t = cascade_blend(view_depth, uni.splits)
    phi = shadow_phi(uni, frag, use_taa)
    a = filter_one(uni, maps, c0, world, normal, n_dot_l, phi, use_pcss)
    b = filter_one(uni, maps, c1, world, normal, n_dot_l, phi, use_pcss)
    return blend(a, b, t)


# --- shadow TAA (taa.py:30-133) ----------------------------------------------

def shadow_taa(cur, world, uni: Uniforms, history, use_taa: bool, fw: int,
               fh: int):
    v, m1, m2, kernel = cur
    h, w = v.shape
    dev = v.device
    frag_x = (torch.arange(w, dtype=F32, device=dev)[None, :] + 0.5).expand(h, w)
    frag_y = (torch.arange(h, dtype=F32, device=dev)[:, None] + 0.5).expand(h, w)
    ones = torch.ones(world.shape[:-1] + (1,), dtype=F32, device=dev)
    hom = torch.cat([world, ones], dim=-1)
    cur_clip = _apply_rows(hom, uni.view_proj)
    ndc_depth = torch.where(cur_clip[..., 3] != 0.0,
                            cur_clip[..., 2] / cur_clip[..., 3],
                            1.0).clamp(0.0, 1.0)
    if not use_taa:
        return v, torch.stack([v, ndc_depth], dim=-1)
    cur_uv = torch.stack([(frag_x + 0.5) / fw, (frag_y + 0.5) / fh], dim=-1)
    prev_clip = _apply_rows(hom, uni.prev_view_proj)
    w_ok = prev_clip[..., 3] > 0.0
    prev_ndc = prev_clip[..., :3] / torch.where(w_ok[..., None],
                                                prev_clip[..., 3:4], 1.0)
    prev_uv = prev_ndc[..., :2] * 0.5 + 0.5
    in_bounds = (w_ok & (prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0)
                 & (prev_ndc[..., 2] >= 0.0) & (prev_ndc[..., 2] <= 1.0))
    motion = torch.linalg.vector_norm(prev_uv - cur_uv, dim=-1)
    stdev = torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))
    soft = torch.clamp(kernel / 8.0, 0.0, 1.0)
    sigma = 2.5 + (0.9 - 2.5) * soft
    lo, hi = m1 - sigma * stdev, m1 + sigma * stdev
    weight = 0.55 + (0.85 - 0.55) * soft
    hist = _nearest_edge(history, prev_uv)
    delta = torch.abs(hist[..., 0] - v)
    depth_delta = torch.abs(hist[..., 1] - prev_ndc[..., 2])
    reject = (motion > 0.02) | (depth_delta > 0.02) | (delta > 0.35)
    clamped = torch.minimum(torch.maximum(hist[..., 0], lo), hi)
    out = torch.where(in_bounds & ~reject, v + (clamped - v) * weight, v)
    return out, torch.stack([out, ndc_depth], dim=-1)


# --- contact shadows (contact.py:51-200) -------------------------------------

def _linearize(z):
    return NEAR * FAR / torch.clamp(FAR - z * (FAR - NEAR), min=1e-3)


def _depth_dual(depth, uv):
    """Bilinear and nearest CLAMP_TO_EDGE reads of the previous depth."""
    h, w = depth.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = _to_i32(x0f), _to_i32(y0f)
    ix, iy = x0.clamp(0, w - 1), y0.clamp(0, h - 1)
    fx = (x - x0f).clamp(0.0, 1.0)
    fy = (y - y0f).clamp(0.0, 1.0)

    def at(yy, xx):
        return depth[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]

    # the 2x2 quad at the clamped base; a base clamped up from -1 repeats
    # its first row or column (edge clamping)
    xs = torch.where(x0 >= 0, ix + 1, ix)
    ys = torch.where(y0 >= 0, iy + 1, iy)
    c00, c10, c01, c11 = at(iy, ix), at(iy, xs), at(ys, ix), at(ys, xs)
    bil = (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx)
                                                    + c11 * fx) * fy
    nx = (_to_i32(torch.floor(uv[..., 0] * w)).clamp(0, w - 1) - ix).clamp(0, 1)
    ny = (_to_i32(torch.floor(uv[..., 1] * h)).clamp(0, h - 1) - iy).clamp(0, 1)
    nst = torch.where(ny == 0, torch.where(nx == 0, c00, c10),
                      torch.where(nx == 0, c01, c11))
    return bil, nst


def contact_shadow(world, normal, uni: Uniforms, prev_depth, valid):
    h, w = world.shape[:2]
    dev = world.device
    light = uni.light_dir
    facing = (normal * light).sum(dim=-1) > 0.0
    start = world + normal * 0.01
    end = start + light * TRACE_DISTANCE
    vp = uni.proj @ uni.view
    ones = torch.ones(world.shape[:-1] + (1,), dtype=F32, device=dev)

    def to_cs(p):
        c = _apply_rows(torch.cat([p, ones], dim=-1), vp)
        return c[..., :3] / torch.where(torch.abs(c[..., 3:4]) > 1e-12,
                                        c[..., 3:4], 1e-12)

    s_cs, e_cs = to_cs(start), to_cs(end)
    ray = e_cs - s_cs
    t_min = torch.zeros((h, w), dtype=F32, device=dev)
    t_max = torch.ones((h, w), dtype=F32, device=dev)
    for axis, lo, hi in ((0, -1.0, 1.0), (1, -1.0, 1.0), (2, 0.0, 1.0)):
        d, s = ray[..., axis], s_cs[..., axis]
        safe = torch.where(torch.abs(d) > 1e-4, d, 1.0)
        t1, t2 = (lo - s) / safe, (hi - s) / safe
        moving = torch.abs(d) > 1e-4
        t_min = torch.where(moving, torch.maximum(t_min, torch.minimum(t1, t2)),
                            t_min)
        t_max = torch.where(moving, torch.minimum(t_max, torch.maximum(t1, t2)),
                            t_max)
    cand = facing & (t_min < t_max) & valid
    m_start = s_cs + ray * t_min[..., None]
    m_dir = (s_cs + ray * t_max[..., None]) - m_start
    fx = torch.arange(w, dtype=F32, device=dev)[None, :] + 0.5
    fy = torch.arange(h, dtype=F32, device=dev)[:, None] + 0.5
    jitter = _ign(torch.stack([(fx + uni.frame * 13.37).expand(h, w),
                               (fy + uni.frame * 17.17).expand(h, w)], dim=-1))

    def probe(t):
        cs = m_start + m_dir * t[..., None]
        uv = cs[..., :2] * 0.5 + 0.5
        inb = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
               & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
        raw_l, raw_n = _depth_dual(prev_depth, uv)
        lin_l, lin_n = _linearize(raw_l), _linearize(raw_n)
        ray_depth = _linearize(cs[..., 2])
        pen = ray_depth - torch.minimum(lin_l, lin_n)
        hit = (torch.maximum(lin_l, lin_n) - ray_depth < 0.0) \
            & (pen < DEPTH_THICKNESS)
        return hit, pen, inb

    min_t = torch.zeros((h, w), dtype=F32, device=dev)
    max_t = torch.ones((h, w), dtype=F32, device=dev)
    inter = torch.zeros((h, w), dtype=torch.bool, device=dev)
    last = torch.zeros((h, w), dtype=F32, device=dev)
    for step in range(LINEAR_STEPS):
        t = (step + jitter) / LINEAR_STEPS
        hit, pen, inb = probe(t)
        active = ~inter & inb
        new = active & hit
        max_t = torch.where(new, t, max_t)
        last = torch.where(new, pen, last)
        min_t = torch.where(active & ~hit, t, min_t)
        inter = inter | new
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (min_t + max_t)
        hit, pen, _ = probe(mid)
        max_t = torch.where(inter & hit, mid, max_t)
        last = torch.where(inter & hit, pen, last)
        min_t = torch.where(inter & ~hit, mid, min_t)

    def smooth(e0, e1, x):
        t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    shade = 1.0 - (1.0 - smooth(0.0, 0.5, max_t)) \
        * (1.0 - smooth(0.0, DEPTH_THICKNESS, last)) * MAX_DARKNESS
    return torch.where(inter & cand, shade, 1.0)


# --- shading (shading.py:67-123) -------------------------------------------------

def shade(g: GBuffer, scene: Scene, uni: Uniforms, shadow):
    dev = g.valid.device
    use_tex = (g.flags & FLAG_USE_TEXTURE) != 0
    tex = _texture(scene.texture, scene.texture_sizes, g.flags >> 8, g.uv)
    tex = torch.where(use_tex[..., None], tex, 1.0)

    def norm(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True),
                               min=1e-12)

    normal, light, view = norm(g.normal), norm(uni.light_dir), \
        norm(uni.camera_pos)
    diff = torch.clamp((normal * light).sum(dim=-1, keepdim=True), min=0.0)
    fill = torch.clamp((normal * norm(_t(_FILL_DIR, dev))).sum(
        dim=-1, keepdim=True), min=0.0) * 0.3
    spec = torch.pow(torch.clamp((normal * norm(light + view)).sum(
        dim=-1, keepdim=True), min=0.0), 32.0)
    base = tex[..., :3] * g.color
    result = (0.25 * base + 0.65 * diff * base * shadow[..., None]
              + fill * base
              + 0.3 * spec * torch.where(use_tex[..., None], 1.0, 0.0))
    rgb = torch.where(g.valid[..., None], result, _t(CLEAR, dev))
    alpha = torch.where(g.valid[..., None], tex[..., 3:4], 1.0)
    return torch.cat([rgb, alpha], dim=-1)


# --- the frame ---------------------------------------------------------------------

class Front(NamedTuple):
    """What the shadow stages read: the uniforms, the cascade maps, the
    G-buffer and its per-pixel terms, and the main depth."""
    uni: Uniforms
    maps: torch.Tensor
    g: GBuffer
    depth: torch.Tensor
    normal: torch.Tensor
    n_dot_l: torch.Tensor
    view_depth: torch.Tensor
    frag: torch.Tensor


def front(scene: Scene, pose: Pose, state: State, opt: Options,
          q: Callable) -> Front:
    """Uniforms, cascade maps, near clipping, the main raster and the
    G-buffer, each buffer handed on through `q`."""
    # float32 products: no TF32 in the matrix products of the vertex stage
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    uni = uniforms(pose, state, opt)
    world_v, clip, normals_v = transform(scene, uni.models, uni.view_proj)
    inv_w = 1.0 / torch.clamp(clip[:, 3:4], min=1e-12)
    blocks = torch.cat([world_v, normals_v, scene.uvs, scene.colors, inv_w],
                       dim=-1)[scene.tri_indices]
    maps = q(shadow_maps(world_v, scene, uni.light_view_proj,
                         opt.shadow_map_size))
    tri_clip, blocks, tri_flags, valid = near_clip(
        clip[scene.tri_indices], blocks, scene.tri_flags, scene.num_triangles)
    planes, ok = setup(tri_clip, opt.width, opt.height, valid)
    tri_id, depth = raster(planes, ok, opt.width, opt.height)
    depth = q(depth)
    g = interpolate(tri_id, planes, blocks, tri_flags)
    g = g._replace(world=q(g.world), normal=q(g.normal), uv=q(g.uv))

    normal = g.normal / torch.clamp(torch.linalg.vector_norm(
        g.normal, dim=-1, keepdim=True), min=1e-12)
    n_dot_l = torch.clamp((normal * uni.light_dir).sum(dim=-1), min=0.0)
    view_depth = -(_apply_rows(g.world, uni.view[2:3, :3])[..., 0]
                   + uni.view[2, 3])
    h, w = tri_id.shape
    dev = tri_id.device
    frag = torch.stack([
        (torch.arange(w, dtype=F32, device=dev)[None, :] + 0.5).expand(h, w),
        (torch.arange(h, dtype=F32, device=dev)[:, None] + 0.5).expand(h, w)],
        dim=-1)
    return Front(uni, maps, g, depth, normal, n_dot_l, view_depth, frag)


def finish(scene: Scene, state: State, opt: Options, q: Callable, f: Front,
           cur, contact_valid):
    """TAA of the filter's result `cur`, the contact shadows of the pixels
    in `contact_valid`, the shading: (rgba, the next State)."""
    term, hist = shadow_taa(cur, f.g.world, f.uni, state.shadow_history,
                            opt.use_shadow_taa, opt.width, opt.height)
    if opt.enable_contact_shadows:
        term = torch.minimum(term, contact_shadow(f.g.world, f.normal, f.uni,
                                                  state.prev_depth,
                                                  contact_valid))
    hist = q(torch.where(f.g.valid[..., None], hist, state.shadow_history))
    rgba = q(shade(f.g, scene, f.uni, term))
    return rgba, State(
        shadow_history=hist, prev_depth=f.depth,
        prev_view_proj=f.uni.view_proj,
        has_prev=torch.ones((), dtype=torch.bool, device=f.depth.device),
        frame_index=state.frame_index + 1)


def identity(x):
    return x


def render(scene: Scene, pose: Pose, state: State, opt: Options,
           store: Optional[Callable] = None):
    """One frame: (rgba (H, W, 4), the next State)."""
    q = store or identity
    f = front(scene, pose, state, opt, q)
    cur = cascaded_shadow(f.uni, f.maps, f.g.world, f.normal, f.n_dot_l,
                          f.view_depth, f.frag, opt.use_pcss,
                          opt.use_shadow_taa)
    return finish(scene, state, opt, q, f, cur, f.g.valid)
