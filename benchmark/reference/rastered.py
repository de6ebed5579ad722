"""The plain reference of the rastered frame: reference/render.py's frame
with `front`'s two rasters, the cascade maps and the main pass, replaced
by a bounded exact raster. Plain PyTorch, importing nothing of the
program.

render.py::raster tests every triangle over every pixel of the frame, one
triangle after another: at the large scene's 73,754 triangles and
4 x 2048^2 + 1920x1080 pixels that is far too slow for the output check.
`raster` here tests each triangle only over the pixel centres of its own
screen box, with render.py::setup's planes and the same expressions for
the three edges and z, and keeps at each pixel the least (depth, id) pair
among the triangles that cover it with 0 <= z < 1. render.py's in-order
LESS test against 1.0 keeps the first triangle of least depth, which is
that pair: on any scene small enough for render.py the two agree bit for
bit (benchmark/tests/test_bench_rastered.py, tests/test_torch_rastered.py).

Where the raster departs from render.py's, none of which changes a pixel:
- the box: a triangle is tested over the pixel centres of its screen box
  (the corners' min and max, as setup computes them) widened by MARGIN
  pixels. A centre farther outside cannot pass the three edge tests: it
  would take a rounding of the edge expressions of a whole pixel, where
  they round by about 1e-4 of one at the cells' coordinates;
- the order: triangles are batched by box size (powers of two a side), at
  most BATCH_PAIRS pixel tests a batch, so that memory stays bounded. The
  winner is the minimum of the 64-bit key (z's bits, id), taken by a
  scatter-min, which does not depend on the order: z is at least 0 there,
  non-negative floats order as their bits, and -0.0 is keyed as +0.0, a
  tie that goes to the lower id, as it does under render.py's strict LESS;
- the depth: the winner's z, evaluated again at its pixel by the same
  expression, which gives the same bits.
Everything else is render.py's, in float32 with TF32 off.

`covered_pairs` counts the (pixel, triangle) pairs that pass the cover
test in each of a frame's five rasters: the least work any raster of the
frame does, which benchmark/metrics/raster_roofline.py reads.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import render as rr
# the interface, as render.py's
from .render import Options, Pose, State, init_state  # noqa: F401
from .scene import Scene

F32 = rr.F32
MARGIN = 2
BATCH_PAIRS = 1 << 24
_NONE = torch.iinfo(torch.int64).max


def options(config_file: dict, frame: dict) -> Options:
    """render.py's Options, refusing the flags it does not follow."""
    return rr.options(config_file, frame)


def boxes(tri_clip, width: int, height: int):
    """(x0, y0, x1, y1) int64: the pixel columns and rows whose centres lie
    within MARGIN pixels of each triangle's screen box, clipped to the
    frame (x1 < x0 or y1 < y0 where none does). The corners' screen
    coordinates are setup's (render.py:341-352)."""
    w = tri_clip[..., 3]
    inv_w = 1.0 / torch.where(w > rr.SETUP_W_EPS, w, 1.0)
    ndc = tri_clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)
    sy = (ndc[..., 1] + 1.0) * (0.5 * height)

    def span(s, n):
        lo = torch.nan_to_num(s.amin(dim=-1), nan=0.0).clamp(-1.0, n + 1.0)
        hi = torch.nan_to_num(s.amax(dim=-1), nan=0.0).clamp(-1.0, n + 1.0)
        first = torch.ceil(lo - MARGIN - 0.5).clamp(min=0)
        last = torch.floor(hi + MARGIN - 0.5).clamp(max=n - 1)
        return first.to(torch.int64), last.to(torch.int64)

    x0, x1 = span(sx, width)
    y0, y1 = span(sy, height)
    return x0, y0, x1, y1


def _pow2(n):
    """The least power of two at least n (n >= 1), as int64."""
    return torch.pow(2, torch.ceil(torch.log2(n.to(torch.float64)))
                     ).to(torch.int64)


def _batches(tri_clip, planes, ok, width: int, height: int):
    """The cover test of every triangle in `ok` over its box, a batch at a
    time: (ids (m,), flat pixel index (m, bh, bw), covered (m, bh, bw),
    z (m, bh, bw)) with bh x bw the batch's power-of-two box."""
    dev = planes.device
    x0, y0, x1, y1 = boxes(tri_clip, width, height)
    live = ok & (x1 >= x0) & (y1 >= y0)
    ids = torch.nonzero(live).flatten()
    if ids.numel() == 0:
        return
    bw = _pow2(x1[ids] - x0[ids] + 1)
    bh = _pow2(y1[ids] - y0[ids] + 1)
    for cls_w, cls_h in torch.unique(torch.stack([bw, bh], 1), dim=0
                                     ).tolist():
        cls = ids[(bw == cls_w) & (bh == cls_h)]
        step = max(1, BATCH_PAIRS // (cls_w * cls_h))
        ox = torch.arange(cls_w, device=dev)[None, None, :]
        oy = torch.arange(cls_h, device=dev)[None, :, None]
        for s in range(0, cls.numel(), step):
            t = cls[s:s + step]
            ix = x0[t][:, None, None] + ox                 # (m, 1, bw)
            iy = y0[t][:, None, None] + oy                 # (m, bh, 1)
            inside = (ix <= x1[t][:, None, None]) \
                & (iy <= y1[t][:, None, None])
            px = ix.to(F32) + 0.5
            py = iy.to(F32) + 0.5
            d = planes[t][:, :, None, None]                # (m, 12, 1, 1)
            # render.py:385-389, term by term
            b0 = d[:, 0] * px + d[:, 1] * py + d[:, 2]
            b1 = d[:, 3] * px + d[:, 4] * py + d[:, 5]
            b2 = d[:, 6] * px + d[:, 7] * py + d[:, 8]
            z = d[:, 9] * px + d[:, 10] * py + d[:, 11]
            cover = (inside & (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
                     & (z >= 0.0) & (z < 1.0))
            yield t, iy * width + ix, cover, z


def raster(tri_clip, planes, ok, width: int, height: int):
    """render.py::raster, bounded (module docstring): (tri_id, depth), -1
    and 1.0 where nothing covers a pixel."""
    dev = planes.device
    n = width * height
    best = torch.full((n + 1,), _NONE, dtype=torch.int64, device=dev)
    for t, flat, cover, z in _batches(tri_clip, planes, ok, width, height):
        key = ((z + 0.0).view(torch.int32).to(torch.int64) << 32) \
            | t[:, None, None]
        best.scatter_reduce_(0, torch.where(cover, flat, n).reshape(-1),
                             key.reshape(-1), reduce="amin")
    best = best[:n].reshape(height, width)
    hit = best != _NONE
    ids = torch.where(hit, best & 0xFFFFFFFF, 0)
    px = torch.arange(width, dtype=F32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=F32, device=dev)[:, None] + 0.5
    d = planes[ids]
    z = d[..., 9] * px + d[..., 10] * py + d[..., 11]
    return (torch.where(hit, ids, -1).to(torch.int32),
            torch.where(hit, z, 1.0))


def covered(tri_clip, planes, ok, width: int, height: int) -> int:
    """The (pixel, triangle) pairs that pass `raster`'s cover test."""
    return sum(int(c.sum()) for _, _, c, _ in
               _batches(tri_clip, planes, ok, width, height))


def _cascade_corners(world, scene: Scene, light_view_proj):
    """Each cascade's per-corner clip positions and valid mask, as
    render.py::shadow_maps makes them (render.py:446-457)."""
    ones = torch.ones((world.shape[0], 1), dtype=F32, device=world.device)
    hom = torch.cat([world, ones], dim=-1)
    valid = (torch.arange(scene.tri_indices.shape[0], device=world.device)
             < scene.num_triangles)
    for c in range(light_view_proj.shape[0]):
        yield (hom @ light_view_proj[c].T)[scene.tri_indices], valid


def shadow_maps(world, scene: Scene, light_view_proj, size: int):
    """render.py::shadow_maps with the bounded raster."""
    maps = []
    for tri_clip, valid in _cascade_corners(world, scene, light_view_proj):
        planes, ok = rr.setup(tri_clip, size, size, valid)
        maps.append(raster(tri_clip, planes, ok, size, size)[1])
    return torch.stack(maps)


def _main_corners(scene: Scene, uni):
    """The vertex stage and near clipping of render.py::front (lines
    905-913): (world_v, tri_clip, blocks, tri_flags, valid)."""
    world_v, clip, normals_v = rr.transform(scene, uni.models, uni.view_proj)
    inv_w = 1.0 / torch.clamp(clip[:, 3:4], min=1e-12)
    blocks = torch.cat([world_v, normals_v, scene.uvs, scene.colors, inv_w],
                       dim=-1)[scene.tri_indices]
    return (world_v,) + rr.near_clip(clip[scene.tri_indices], blocks,
                                     scene.tri_flags, scene.num_triangles)


def front(scene: Scene, pose: Pose, state: State, opt: Options,
          q: Callable) -> rr.Front:
    """render.py::front (lines 898-931) with the bounded raster."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    uni = rr.uniforms(pose, state, opt)
    world_v, tri_clip, blocks, tri_flags, valid = _main_corners(scene, uni)
    maps = q(shadow_maps(world_v, scene, uni.light_view_proj,
                         opt.shadow_map_size))
    planes, ok = rr.setup(tri_clip, opt.width, opt.height, valid)
    tri_id, depth = raster(tri_clip, planes, ok, opt.width, opt.height)
    depth = q(depth)
    g = rr.interpolate(tri_id, planes, blocks, tri_flags)
    g = g._replace(world=q(g.world), normal=q(g.normal), uv=q(g.uv))

    normal = g.normal / torch.clamp(torch.linalg.vector_norm(
        g.normal, dim=-1, keepdim=True), min=1e-12)
    n_dot_l = torch.clamp((normal * uni.light_dir).sum(dim=-1), min=0.0)
    view_depth = -(rr._apply_rows(g.world, uni.view[2:3, :3])[..., 0]
                   + uni.view[2, 3])
    h, w = tri_id.shape
    dev = tri_id.device
    frag = torch.stack([
        (torch.arange(w, dtype=F32, device=dev)[None, :] + 0.5).expand(h, w),
        (torch.arange(h, dtype=F32, device=dev)[:, None] + 0.5).expand(h, w)],
        dim=-1)
    return rr.Front(uni, maps, g, depth, normal, n_dot_l, view_depth, frag)


def render(scene: Scene, pose: Pose, state: State, opt: Options,
           store: Optional[Callable] = None):
    """One frame: (rgba (H, W, 4), the next State), render.py::render with
    this module's front."""
    q = store or rr.identity
    f = front(scene, pose, state, opt, q)
    cur = rr.cascaded_shadow(f.uni, f.maps, f.g.world, f.normal, f.n_dot_l,
                             f.view_depth, f.frag, opt.use_pcss,
                             opt.use_shadow_taa)
    return rr.finish(scene, state, opt, q, f, cur, f.g.valid)


def covered_pairs(scene: Scene, pose: Pose, opt: Options) -> list:
    """The covered (pixel, triangle) pairs of the frame's five rasters at
    `pose`: the four cascades, then the main pass. The rasters do not
    read the carried state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        uni = rr.uniforms(pose, init_state(opt, pose.camera_pos.device), opt)
        world_v, tri_clip, _, _, valid = _main_corners(scene, uni)
        s = opt.shadow_map_size
        out = []
        for c_clip, c_valid in _cascade_corners(world_v, scene,
                                                uni.light_view_proj):
            out.append(covered(c_clip, *rr.setup(c_clip, s, s, c_valid),
                               s, s))
        out.append(covered(tri_clip, *rr.setup(tri_clip, opt.width,
                                               opt.height, valid),
                           opt.width, opt.height))
    return out
