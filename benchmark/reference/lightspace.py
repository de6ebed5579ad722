"""The plain reference of the light-space frame: reference/render.py's
frame with the two deviations of the framework's fast mode,
`light_space_ground_shadows` and `skip_backfacing_shadows`
(funky_tpu/frame.py:174-190, the port's GltfFrameFlags). Dense, in plain
PyTorch, importing nothing of the program.

Ground pixels. Under the orthographic light a ground pixel's PCSS result
depends only on its light-space texel, and the mode evaluates it there
(funky_tpu_torch/passes/shadow_lightspace.py): at the texel centre, with
one of `PHASES` per-frame Vogel rotations chosen by the texel's global
parity, and the penumbra PCF at `RUNGS` log-spaced radii interpolated per
texel. This module evaluates that math at the texel of every pixel that
takes it, frozen from
- `ground_constants` and `biased_ground_planes` (lines 63-81, with
  shadow_classify.py::plane_through, lines 109-122): the receiver is the
  biased ground plane's depth at the texel centre, less the slope bias;
- `light_map_taps` (lines 173-209): the rotations (IGN at the screen
  points (p % 2, p // 2), animated with TAA), the 16 blocker taps as
  integer shifts, the rung radii and each rung's 16 bilinear taps;
- `build_light_shadow_map_plain` (lines 288-370, with `_compare_taps`,
  lines 212-228): the blocker search on the raw map (1.0 outside it), the
  penumbra, the rung weights, the compare taps and their sums in that
  order, the lit override; and `_fetch_rows` of shadow_filter.py (lines
  487-500): a pixel reads (v, v, m2, kernel) of its texel's row.
The pixels that take it are those of `ground_eligible` (lines 373-380):
on the ground plane, with a unit up normal and a receiver depth at most 1,
while the softness is within the light maps' reach (`MAX_SOFTNESS`, the
frame's `max_softness`); each pixel per cascade of its pair, as the
sparse filter's fetch groups take them (shadow_filter.py:467-484,
600-612). Every other pixel runs render.py's filter.

Where this differs from the program, and why that is not the frame: the
program evaluates a ground pixel in a light-space window of each cascade,
placed on its occluders' footprint, and runs the per-pixel filter outside
it; the windows and their fetch capacities are the program's way of
computing the frame. Outside the windows no occluder lies within a tap's
reach, and at the cells' 2048^2 maps both evaluations then agree: on the
card, over 12 poses of the multimesh orbit, every ground pixel at which
they differ lay 73 texels or more inside its window. At coarse maps
(512^2) the ground's own depth blocks the per-pixel filter's wider taps
and they part there, so the CPU tests hold this module against a program
whose windows cover the whole map.

Back-facing pixels (n_dot_l <= 0). The program runs neither shadow taps
nor the contact march for them (shadow_filter.py:433-436 and frame.py:
508-509 of the port): they keep the filter's closed form, which is 0 in
the umbra and the lit placeholder (1, 1, 1, 0) elsewhere, and their
contact term is 1. Their colour does not change, since the shadow
multiplies max(n_dot_l, 0); their shadow history does. Here a back-facing
pixel takes, in each cascade, 0 where render.py's filter leaves it no
light, and the lit placeholder where it leaves any; its contact term is 1.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import render as rr
# the interface, as render.py's
from .render import Options, Pose, State, init_state  # noqa: F401

F32 = rr.F32
PHASES = 4
RUNGS = 6
MAX_SOFTNESS = 4.0
GROUND_Y = 0.0
TAPS = 16

# What this reference follows: the light-space frame with the back-face
# skip, PCSS on; the other flags as render.py follows them.
FOLLOWS = dict(rr.FOLLOWS, light_space_ground_shadows=True,
               skip_backfacing_shadows=True, use_pcss=True)


def options(config_file: dict, frame: dict) -> Options:
    """render.py's Options, refusing flags that leave FOLLOWS."""
    return rr.options(config_file, frame, follows=FOLLOWS)


class Taps(NamedTuple):
    """The frame's light-map tap geometry for each phase p: the blocker
    shifts (sy, sx) (16, P) int32, the rung radii's bilinear corners
    (y0, x0) int32 and fractions (fy, fx) f32, each (RUNGS, 16, P)."""
    light_size: torch.Tensor
    span: torch.Tensor
    shifts: tuple
    corners: tuple
    fracs: tuple


def taps(uni: rr.Uniforms, use_taa: bool) -> Taps:
    """light_map_taps of shadow_lightspace.py:173-218, PCSS."""
    dev = uni.camera_pos.device
    offs = torch.tensor([[float(p % 2), float(p // 2)]
                         for p in range(PHASES)], dtype=F32, device=dev)
    phi = rr.shadow_phi(uni, offs, use_taa)
    light_size = uni.softness * 2.0
    dx, dy = rr._vogel(rr.BLOCKER_SAMPLES, phi)
    shifts = (rr._to_i32(torch.floor(0.5 + dy * light_size)),
              rr._to_i32(torch.floor(0.5 + dx * light_size)))
    span = torch.log(torch.clamp(light_size * 4.0, min=1.0 + 1e-6))
    radii = torch.stack([0.5 * torch.exp(span * (j / (RUNGS - 1)))
                         for j in range(RUNGS)])
    dx, dy = rr._vogel(rr.PCF_SAMPLES, phi)
    ox = dx[None] * radii[:, None, None]
    oy = dy[None] * radii[:, None, None]
    x0 = torch.floor(ox)
    y0 = torch.floor(oy)
    return Taps(light_size, span, shifts, (rr._to_i32(y0), rr._to_i32(x0)),
                (oy - y0, ox - x0))


def ground_planes(uni: rr.Uniforms):
    """(L, 3) uv-space NDC-depth planes of the biased ground and the depth
    bias (ground_constants, biased_ground_planes, plane_through)."""
    dev = uni.camera_pos.device
    ndl = torch.clamp(uni.light_dir[1], min=0.0)
    normal_off = 0.02 * (1.0 - ndl)
    bias = 0.0008 + 0.0025 * (1.0 - ndl)
    xz = torch.tensor([[0.0, 0.0], [7.0, 1.0], [3.0, -6.0]], dtype=F32,
                      device=dev)
    ys = (GROUND_Y + normal_off).to(F32).reshape(1).expand(3)
    pts = torch.stack([xz[:, 0], ys, xz[:, 1]], dim=-1)
    hom = torch.cat([pts, torch.ones((3, 1), dtype=F32, device=dev)], dim=-1)
    clip = torch.einsum("cij,nj->cni", uni.light_view_proj, hom)
    ndc = clip[..., :3] / clip[..., 3:4]
    uv = ndc[..., :2] * 0.5 + 0.5
    a_mat = torch.cat([uv, torch.ones(uv.shape[:-1] + (1,), dtype=F32,
                                      device=dev)], dim=-1)
    return torch.linalg.solve(a_mat, ndc[..., 2:3])[..., 0], bias


def ground_filter(depth_map, plane, bias, tp: Taps, tx, ty):
    """The light-space PCSS of texels (tx, ty) of one cascade's raw (S, S)
    depth: (v, m1, m2, kernel radius), each shaped like tx
    (build_light_shadow_map_plain, one texel at a time)."""
    s = depth_map.shape[0]
    txc = (tx.to(F32) + 0.5) / s
    tyc = (ty.to(F32) + 0.5) / s
    receiver = (plane[0] * txc + plane[1] * tyc + plane[2]) - bias
    phase = (((ty % 2) * 2 + (tx % 2)) % PHASES).long()

    def texel(dy, dx):
        y, x = ty + dy, tx + dx
        inb = (y >= 0) & (y < s) & (x >= 0) & (x < s)
        d = depth_map[y.clamp(0, s - 1).long(), x.clamp(0, s - 1).long()]
        return torch.where(inb, d, 1.0)

    def at(table):
        """(..., P) per phase -> (..., N): each texel's own phase."""
        return table[..., phase]

    sy, sx = at(tp.shifts[0]), at(tp.shifts[1])
    d = texel(sy, sx)                                   # (16, N)
    hit = d < receiver
    b_sum = rr._sum_taps(torch.where(hit, d, 0.0))
    b_cnt = rr._sum_taps(hit.to(F32))
    has_blockers = b_cnt > 0.0
    blocker_depth = b_sum / torch.clamp(b_cnt, min=1.0)
    ratio = (receiver - blocker_depth) / torch.clamp(blocker_depth, min=1e-8)
    light_size = tp.light_size
    penumbra = torch.minimum(torch.clamp(ratio * light_size, min=0.5),
                             light_size * 2.0)

    m1 = torch.zeros_like(penumbra)
    m2 = torch.zeros_like(penumbra)
    pos = (RUNGS - 1) * torch.log(penumbra / 0.5) / tp.span
    for j in range(RUNGS):
        w_j = torch.clamp(1.0 - torch.abs(pos - j), 0.0, 1.0)
        y0, x0 = at(tp.corners[0][j]), at(tp.corners[1][j])
        fy, fx = at(tp.fracs[0][j]), at(tp.fracs[1][j])

        def cmp(dy, dx):
            return (receiver <= texel(y0 + dy, x0 + dx)).to(F32)

        top = cmp(0, 0) * (1 - fx) + cmp(0, 1) * fx
        bot = cmp(1, 0) * (1 - fx) + cmp(1, 1) * fx
        tap = top * (1 - fy) + bot * fy
        m1 = m1 + w_j * (rr._sum_taps(tap) / TAPS)
        m2 = m2 + w_j * (rr._sum_taps(tap * tap) / TAPS)
    v = torch.where(has_blockers, m1, 1.0)
    return (v, v, torch.where(has_blockers, m2, 1.0),
            torch.where(has_blockers, penumbra, 0.0))


def _cascade(f: rr.Front, cascade, phi, planes, bias, tp: Taps, take):
    """One cascade of each pixel's pair: render.py's filter, the
    light-space PCSS on the ground pixels in `take`, the back-face rule."""
    out = list(rr.filter_one(f.uni, f.maps, cascade, f.g.world, f.normal,
                             f.n_dot_l, phi, True))
    uv, receiver, _ = rr.project(f.uni, cascade, f.g.world, f.normal,
                                 f.n_dot_l)
    ground = ((torch.abs(f.g.world[..., 1] - GROUND_Y) < 1e-4)
              & (f.normal[..., 1] > 0.9999) & (receiver <= 1.0)
              & (f.uni.softness <= MAX_SOFTNESS) & take)
    idx = torch.nonzero(ground.reshape(-1)).flatten()
    if idx.numel():
        s = f.maps.shape[1]
        flat_uv = uv.reshape(-1, 2)[idx]
        tx = rr._to_i32(torch.floor(flat_uv[:, 0] * s))
        ty = rr._to_i32(torch.floor(flat_uv[:, 1] * s))
        c = cascade.reshape(-1)[idx].long()
        vals = [torch.zeros_like(tx, dtype=F32) for _ in range(4)]
        for layer in range(f.maps.shape[0]):
            sel = c == layer
            if bool(sel.any()):
                got = ground_filter(f.maps[layer], planes[layer], bias, tp,
                                    tx[sel], ty[sel])
                for k in range(4):
                    vals[k][sel] = got[k]
        for k in range(4):
            out[k] = out[k].reshape(-1).index_put((idx,), vals[k]).reshape(
                out[k].shape)
    back = f.n_dot_l <= 0.0
    dark = out[1] == 0.0
    lit = (1.0, 1.0, 1.0, 0.0)
    return tuple(torch.where(back, torch.where(dark, 0.0, lit[k]), out[k])
                 for k in range(4))


def cascaded_shadow(f: rr.Front, opt: Options):
    """render.py's cascaded_shadow with the light-space ground pixels and
    the back-face rule in each cascade of the pair."""
    c0, c1, t = rr.cascade_blend(f.view_depth, f.uni.splits)
    phi = rr.shadow_phi(f.uni, f.frag, opt.use_shadow_taa)
    planes, bias = ground_planes(f.uni)
    tp = taps(f.uni, opt.use_shadow_taa)
    everywhere = torch.ones_like(t, dtype=torch.bool)
    a = _cascade(f, c0, phi, planes, bias, tp, everywhere)
    # the second cascade counts only where the pair blends
    b = _cascade(f, c1, phi, planes, bias, tp, t > 0.0)
    return rr.blend(a, b, t)


def render(scene, pose: Pose, state: State, opt: Options,
           store: Optional[Callable] = None):
    """One light-space frame: (rgba (H, W, 4), the next State)."""
    q = store or rr.identity
    f = rr.front(scene, pose, state, opt, q)
    cur = cascaded_shadow(f, opt)
    return rr.finish(scene, state, opt, q, f, cur,
                     f.g.valid & (f.n_dot_l > 0.0))
