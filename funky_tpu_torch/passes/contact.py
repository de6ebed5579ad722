"""Contact shadows: screen-space ray march toward the light (port of
funky_tpu/passes/contact.py). 8 jittered linear steps + 4 bisection steps
against the previous frame's depth, read through both the bilinear and
the nearest filter: densely (`compute_contact_shadow`) or sparsely
(`compute_contact_shadow_sparse`, the default), where an analytic-plane
residual certificate retires most rays and only a compacted set marches;
`contact_occupancy` counts those sets for the autotuner.

Three dispatchers hold the per-ray work: `contact_front` (ray setup,
jitter and the stage-1 segment certificate), `contact_certify` (the
stage-2 probe certificate over compacted slots) and `contact_march` (the
exact march and its soft term, over slots or every ray). CUDA tensors go
to the hand-written kernels K8 and K9 (ops/contact_cuda.py), CPU tensors
to the plain twins `_contact_front_plain`, `_contact_certify_plain` and
`_contact_march_plain`, which equal the kernels bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math3d import apply_rows, f32
from ..ops import contact_cuda
from ..ops.binning import triangle_setup_corners
from ..ops.clipping import expand_near_clipped
from ..ops.compact import (Compacted, compact_indices,
                           compact_indices_blocked, gather_rows, host_cond,
                           scatter_back)
from ..ops.sampling import (dynamic_slice, quad_pack,
                            sample_depth_dual_packed,
                            sample_depth_dual_window, take_rows, to_i32)
from .deferred import pixel_centers
from .shadow_filter import interleaved_gradient_noise
from .uniforms import FrameUniforms

LINEAR_STEPS = 8
BISECTION_STEPS = 4
TRACE_DISTANCE = 0.5
DEPTH_THICKNESS = 0.05
MAX_DARKNESS = 0.8
NEAR = 0.1
FAR = 100.0


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _linearize(ndc_z):
    """View-space depth from standard-Z NDC depth (contact.py:57-61)."""
    denom = torch.clamp(FAR - ndc_z * (FAR - NEAR), min=1e-3)
    return NEAR * FAR / denom


def _sample_depth_dual(depth_packed, uv):
    """contact.py:64-73: (max, min) of the two filtered linear depths."""
    raw_linear, raw_nearest = sample_depth_dual_packed(depth_packed, uv)
    d_lin = _linearize(raw_linear)
    d_nst = _linearize(raw_nearest)
    return torch.maximum(d_lin, d_nst), torch.minimum(d_lin, d_nst)


def _ray_setup(world, normal, uni: FrameUniforms):
    """World ray toward the light -> clipped NDC segment
    (contact.py:76-121)."""
    light_dir = uni.light_dir
    n_dot_l = (normal * light_dir).sum(dim=-1)
    facing = n_dot_l > 0.0

    start = world + normal * 0.01
    end = start + light_dir * TRACE_DISTANCE

    vp = uni.proj @ uni.view
    ones = torch.ones(world.shape[:-1] + (1,), dtype=torch.float32,
                      device=world.device)

    def to_cs(p):
        clip = apply_rows(torch.cat([p, ones], dim=-1), vp)
        return clip[..., :3] / torch.where(
            torch.abs(clip[..., 3:4]) > 1e-12, clip[..., 3:4], 1e-12)

    start_cs = to_cs(start)
    end_cs = to_cs(end)
    ray_dir = end_cs - start_cs

    t_min = torch.zeros(facing.shape, dtype=torch.float32,
                        device=world.device)
    t_max = torch.ones(facing.shape, dtype=torch.float32, device=world.device)
    for axis, lo, hi in ((0, -1.0, 1.0), (1, -1.0, 1.0), (2, 0.0, 1.0)):
        d = ray_dir[..., axis]
        s = start_cs[..., axis]
        safe_d = torch.where(torch.abs(d) > 1e-4, d, 1.0)
        t1 = (lo - s) / safe_d
        t2 = (hi - s) / safe_d
        t_lo = torch.minimum(t1, t2)
        t_hi = torch.maximum(t1, t2)
        moving = torch.abs(d) > 1e-4
        t_min = torch.where(moving, torch.maximum(t_min, t_lo), t_min)
        t_max = torch.where(moving, torch.minimum(t_max, t_hi), t_max)

    on_screen = t_min < t_max
    march_start = start_cs + ray_dir * t_min[..., None]
    march_dir = (start_cs + ray_dir * t_max[..., None]) - march_start
    return march_start, march_dir, on_screen, facing


def _march(depth_packed, march_start, march_dir, jitter, window=None):
    """8-linear + 4-bisection hybrid root find (contact.py:124-186).
    `window` = (win (cw, cw, 4), origin (oy, ox), (H, W)) reads the depth
    through a window of the packed buffer. Returns (intersected, max_t,
    last_pen)."""
    shape = jitter.shape
    dev = jitter.device
    min_t = torch.zeros(shape, dtype=torch.float32, device=dev)
    max_t = torch.ones(shape, dtype=torch.float32, device=dev)
    intersected = torch.zeros(shape, dtype=torch.bool, device=dev)
    last_pen = torch.zeros(shape, dtype=torch.float32, device=dev)

    def probe(t):
        cs = march_start + march_dir * t[..., None]
        uv = cs[..., :2] * 0.5 + 0.5
        inb = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
               & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
        if window is not None:
            raw_l, raw_n = sample_depth_dual_window(window[0], window[1],
                                                    window[2], uv)
            d_max = torch.maximum(_linearize(raw_l), _linearize(raw_n))
            d_min = torch.minimum(_linearize(raw_l), _linearize(raw_n))
        else:
            d_max, d_min = _sample_depth_dual(depth_packed, uv)
        ray_depth = _linearize(cs[..., 2])
        distance = d_max - ray_depth
        penetration = ray_depth - d_min
        valid = penetration < DEPTH_THICKNESS
        return (distance < 0.0) & valid, penetration, inb

    # The 8 linear probes are data-independent: one batched read.
    steps = torch.arange(LINEAR_STEPS, dtype=torch.float32,
                         device=dev).reshape((LINEAR_STEPS,)
                                             + (1,) * jitter.ndim)
    t_all = (steps + jitter[None]) / LINEAR_STEPS
    hit_all, pen_all, inb_all = probe(t_all)
    for step in range(LINEAR_STEPS):
        t = t_all[step]
        hit, pen, inb = hit_all[step], pen_all[step], inb_all[step]
        active = ~intersected & inb
        new_hit = active & hit
        max_t = torch.where(new_hit, t, max_t)
        last_pen = torch.where(new_hit, pen, last_pen)
        min_t = torch.where(active & ~hit, t, min_t)
        intersected = intersected | new_hit

    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (min_t + max_t)
        hit, pen, _ = probe(mid)
        go = intersected
        max_t = torch.where(go & hit, mid, max_t)
        last_pen = torch.where(go & hit, pen, last_pen)
        min_t = torch.where(go & ~hit, mid, min_t)
    return intersected, max_t, last_pen


def _soft_term(intersected, max_t, last_pen):
    """contact.py:189-194."""
    strength = 1.0 - _smoothstep(0.0, 0.5, max_t)
    pen_fade = 1.0 - _smoothstep(0.0, DEPTH_THICKNESS, last_pen)
    shadowed = 1.0 - strength * pen_fade * MAX_DARKNESS
    return torch.where(intersected, shadowed, 1.0)


def _jitter(h, w, y0, frame):
    """IGN of fragCoord + frame (contact.py:197-205)."""
    frag_x, frag_y = pixel_centers(h, w, y0, frame.device)
    return interleaved_gradient_noise(torch.stack(
        [frag_x + frame * 13.37, frag_y + frame * 17.17], dim=-1))


def _jitter_at(frag, frame):
    """_jitter on explicit pixel centres, any batch (contact.py:208-212)."""
    return interleaved_gradient_noise(torch.stack(
        [frag[..., 0] + frame * 13.37, frag[..., 1] + frame * 17.17],
        dim=-1))


def compute_contact_shadow(world: torch.Tensor, normal: torch.Tensor,
                           uni: FrameUniforms, prev_depth: torch.Tensor,
                           y0: int = 0, frag: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Shadow factor in [0, 1] for a row slab at global row y0
    (frag=None), or for any batch with explicit `frag` pixel centres
    (contact.py:215-236); prev_depth is the full previous frame."""
    cand, _, payload = contact_front(world, normal, uni, prev_depth.shape,
                                     y0=y0, frag=frag)
    return contact_march(prev_depth, payload,
                         mask=cand.reshape(-1)).reshape(cand.shape)


def contact_front(world: torch.Tensor, normal: torch.Tensor,
                  uni: FrameUniforms, depth_shape, valid=None, y0=0,
                  frag=None, pyr=None):
    """The per-pixel front of the contact march (contact.py:76-121,
    197-212 and 496-621): (cand, stage2, payload) with cand = facing & on
    screen (& valid) over world's batch, stage2 = cand & (intersects |
    ~cert) given the residual pyramid `pyr` (else None), and payload the
    (n, 7) rows [march start, march dir, jitter]. The jitter is of `frag`
    or, without it, of the slab's pixel centres at global row y0. CUDA
    tensors go to the front kernel K8 (ops/contact_cuda.py), which raises
    on what it does not take; CPU tensors to the plain twin."""
    if world.device.type == "cuda":
        return contact_cuda.contact_front(
            world, normal, uni.light_dir, uni.proj @ uni.view,
            uni.debug_flags[3], depth_shape, valid, y0, frag, pyr)
    return _contact_front_plain(world, normal, uni, depth_shape, valid, y0,
                                frag, pyr)


def _contact_front_plain(world, normal, uni: FrameUniforms, depth_shape,
                         valid=None, y0=0, frag=None, pyr=None):
    """contact_front as torch ops: the CPU path and K8's test oracle."""
    march_start, march_dir, on_screen, facing = _ray_setup(world, normal,
                                                           uni)
    if frag is None:
        h, w = world.shape[:2]
        jitter = _jitter(h, w, y0, uni.debug_flags[3])
    else:
        jitter = _jitter_at(frag, uni.debug_flags[3])
    cand = facing & on_screen
    if valid is not None:
        cand = cand & valid
    stage2 = (None if pyr is None else
              contact_classify(pyr, march_start, march_dir, cand,
                               depth_shape))
    payload = torch.cat([march_start, march_dir, jitter[..., None]],
                        dim=-1).reshape(cand.numel(), 7)
    return cand, stage2, payload


def _live(m: int, count, device) -> torch.Tensor:
    """(m,) bool: the slots before the live count (all without one)."""
    if count is None:
        return torch.ones((m,), dtype=torch.bool, device=device)
    return torch.arange(m, dtype=torch.int32, device=device) < count


def contact_certify(pyr, payload: torch.Tensor, depth_shape, idx=None,
                    count=None) -> torch.Tensor:
    """Stage-2 certificates (contact.py:590-608) of the rays whose payload
    rows `idx` (m,) names (every row without it): (m,) bool, true where
    each in-bounds probe of the 8 lies below the plane bound plus the
    level-0 box min, and at or past the live `count` (one int32 on the
    device). CUDA tensors go to K9's certify kernel (ops/contact_cuda.py),
    which raises on what it does not take; CPU tensors to the plain
    twin."""
    if payload.device.type == "cuda":
        return contact_cuda.contact_certify(pyr, payload, depth_shape, idx,
                                            count)
    return _contact_certify_plain(pyr, payload, depth_shape, idx, count)


def _contact_certify_plain(pyr, payload, depth_shape, idx=None,
                           count=None) -> torch.Tensor:
    """contact_certify as torch ops: the CPU path and K9's test oracle."""
    rows = payload if idx is None else take_rows(payload, idx.clamp(min=0))
    cert = _stage2_certify(pyr, rows[:, 0:3], rows[:, 3:6], rows[:, 6],
                           _size(depth_shape, payload.device))
    return cert | ~_live(cert.shape[0], count, payload.device)


def contact_march(prev_depth: torch.Tensor, payload: torch.Tensor, idx=None,
                  count=None, mask=None, window=None) -> torch.Tensor:
    """Contact terms (contact.py:124-194) of the (n, 7) payload's rays as
    (n,) f32. With `idx` (m,) the slots before the live `count` march the
    rows they name and write their terms at those pixels of a ones-filled
    output (scatter_back); without it every ray marches and is lit where
    `mask` is false. `window` = (origin (2,) int32 [oy, ox], cw) reads the
    probes through a (cw, cw) window of the depth at that origin. CUDA
    tensors go to K9's march kernel (ops/contact_cuda.py), which reads
    prev_depth directly and raises on what it does not take; CPU tensors
    to the plain twin."""
    if prev_depth.device.type == "cuda":
        return contact_cuda.contact_march(prev_depth, payload, idx, count,
                                          mask, window)
    return _contact_march_plain(prev_depth, payload, idx, count, mask,
                                window)


def _contact_march_plain(prev_depth, payload, idx=None, count=None,
                         mask=None, window=None) -> torch.Tensor:
    """contact_march through quad_pack and the row gathers: the CPU path
    and K9's test oracle."""
    depth_packed = quad_pack(prev_depth)
    rows = payload if idx is None else take_rows(payload, idx.clamp(min=0))
    win = None
    if window is not None:
        origin, cw = window
        oy, ox = origin[0], origin[1]
        win = (dynamic_slice(depth_packed, (oy, ox), (cw, cw)), (oy, ox),
               tuple(prev_depth.shape))
    inter, max_t, last_pen = _march(depth_packed, rows[:, 0:3], rows[:, 3:6],
                                    rows[:, 6], win)
    if idx is None:
        return _soft_term(inter if mask is None else inter & mask, max_t,
                          last_pen)
    live = _live(idx.shape[0], count, payload.device)
    term = _soft_term(inter & live, max_t, last_pen)
    ones = torch.ones((payload.shape[0],), dtype=torch.float32,
                      device=payload.device)
    return scatter_back(ones, Compacted(idx=idx, slot_valid=live,
                                        count=count), term)


# ---------------------------------------------------------------------------
# Sparse evaluation (contact.py:239-820): stage 1 certifies whole march
# segments outside the measured occluder bbox with dense arithmetic, stage 2
# re-certifies the candidates probe by probe against a level-0 min map,
# stage 3 marches the survivors exactly. The theory is in the JAX module.
# ---------------------------------------------------------------------------

FOOT = 2.0        # dual-sampler footprint half-width in texels
_PAD_BIG = 1e9    # min-reduce padding


class ResidualPyramid(NamedTuple):
    """contact.py:286-296."""
    rows: torch.Tensor         # (lh * lw, 4) quad-packed level-0 min-R
    lw: int
    lh: int
    base: int                  # level-0 cell size in pixels
    plane: torch.Tensor        # (3,) plane_ndc = a*px + b*py + c
    eps: torch.Tensor          # () f32 rounding slack
    occl_lo: torch.Tensor      # (2,) (x, y) pixel bbox of {R < -eps},
    occl_hi: torch.Tensor      # padded; lo > hi when empty


def _reduce_min(d: torch.Tensor, f: int) -> torch.Tensor:
    """f x f min pool with 1e9 padding (contact.py:302-312)."""
    h, w = d.shape
    d = torch.nn.functional.pad(d, (0, -w % f, 0, -h % f), value=_PAD_BIG)
    hp, wp = d.shape
    rows = d.reshape(hp // f, f, wp).amin(dim=1)
    return rows.reshape(hp // f, wp // f, f).amin(dim=-1)


def reference_plane(positions: torch.Tensor, tri_indices: torch.Tensor,
                    view_proj: torch.Tensor, width: int,
                    height: int) -> torch.Tensor:
    """The screen-space z-plane [a, b, c] the rasterizer uses for the
    ground (the scene's first two triangles, identity model), through the
    same near-clip expansion and triangle setup as the main raster, shifted
    down to the lowest of its valid pieces; [0, 0, 0] when none is valid
    (contact.py:315-376)."""
    dev = positions.device
    corners = positions[tri_indices[:2].long()]             # (2, 3, 3)
    ones = torch.ones((2, 3, 1), dtype=torch.float32, device=dev)
    tri_clip = torch.cat([corners, ones], dim=-1) @ view_proj.T
    g = expand_near_clipped(
        tri_clip, torch.zeros((2, 3, 1), dtype=torch.float32, device=dev),
        torch.zeros((2,), dtype=torch.int32, device=dev), 2, capacity=2,
        w_eps=NEAR * 0.1)
    setup = triangle_setup_corners(g.tri_clip, width, height, g.valid)
    zp = setup.data[:, 9:12]
    valid = setup.valid
    any_valid = valid.any()
    # a (1,) index gathers on the card; a 0-d one would be read on the host
    base_i = torch.argmax(valid.to(torch.uint8)).reshape(1)
    base = zp[base_i][0]
    corners_m = f32([[0.0, float(width), 0.0, float(width)],
                     [0.0, 0.0, float(height), float(height)],
                     [1.0, 1.0, 1.0, 1.0]], dev)
    vals = zp @ corners_m                                  # (T', 4)
    gaps = torch.where(valid[:, None], vals[base_i] - vals,
                       -float("inf"))
    shift = torch.clamp(gaps.max(), min=0.0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    plane = base - torch.stack([zero, zero, shift])
    return torch.where(any_valid, plane, 0.0)


def fit_ground_plane(view_proj: torch.Tensor, width: int, height: int,
                     camera_pos: torch.Tensor,
                     plane_y: float = 0.0) -> torch.Tensor:
    """Screen-space NDC-depth plane of y = plane_y fitted from 3 projected
    points near the camera, by Cramer's rule (contact.py:379-412). The
    frame passes reference_plane instead; this is the fallback when no
    plane is given."""
    dev = view_proj.device
    base = torch.stack([camera_pos[0], f32(plane_y, dev), camera_pos[2]])
    offs = f32([[0.0, 0.0, -4.0], [3.0, 0.0, -9.0], [-3.0, 0.0, -9.0]], dev)
    pts = base[None] + offs
    ones = torch.ones((3, 1), dtype=torch.float32, device=dev)
    clip = torch.cat([pts, ones], dim=-1) @ view_proj.T
    w = clip[:, 3]
    w = torch.where(torch.abs(w) > 1e-4, w, 1e-4)
    ndc = clip[:, :3] / w[:, None]
    px = (ndc[:, 0] + 1.0) * (0.5 * width)
    py = (ndc[:, 1] + 1.0) * (0.5 * height)
    a_mat = torch.stack([px, py, torch.ones(3, dtype=torch.float32,
                                            device=dev)], dim=-1)
    det = torch.linalg.det(a_mat)
    safe = torch.where(torch.abs(det) > 1e-6, det, 1e-6)
    sol = []
    for k in range(3):
        m = a_mat.clone()
        m[:, k] = ndc[:, 2]
        sol.append(torch.linalg.det(m) / safe)
    return torch.stack(sol)


def build_residual_pyramid(prev_depth: torch.Tensor, plane: torch.Tensor,
                           base: int = 8) -> ResidualPyramid:
    """Level-0 min map of R = stored - min(plane_ndc, 1), quad-packed, plus
    the padded pixel bbox of {R < -eps} (contact.py:415-463)."""
    h, w = prev_depth.shape
    dev = prev_depth.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    plane_tex = plane[0] * xs + plane[1] * ys + plane[2]
    resid = prev_depth - torch.clamp(plane_tex, max=1.0)

    eps = ((torch.abs(plane[0]) * w + torch.abs(plane[1]) * h
            + torch.abs(plane[2])) * 4e-7 + 2e-7)

    occ = resid < -eps
    col_any = occ.any(dim=0)
    row_any = occ.any(dim=1)
    any_occ = occ.any()

    def span(any_vec, n):
        a = any_vec.to(torch.uint8)
        lo = torch.argmax(a).to(torch.float32)
        hi = (n - torch.argmax(a.flip(0))).to(torch.float32) - 1.0
        return lo, hi

    x_lo, x_hi = span(col_any, w)
    y_lo, y_hi = span(row_any, h)
    pad = FOOT + 1.5
    big = float(w + h)
    occl_lo = torch.where(any_occ, torch.stack([x_lo, y_lo]) - pad, big)
    occl_hi = torch.where(any_occ, torch.stack([x_hi, y_hi]) + pad, -big)

    d0 = _reduce_min(resid, base)
    lh, lw = d0.shape
    return ResidualPyramid(rows=quad_pack(d0).reshape(lh * lw, 4),
                           lw=lw, lh=lh, base=base, plane=plane, eps=eps,
                           occl_lo=occl_lo, occl_hi=occl_hi)


def _point_min_l0(pyr: ResidualPyramid, p: torch.Tensor) -> torch.Tensor:
    """Lower bound of R over [p - FOOT, p + FOOT] (contact.py:466-475)."""
    lo = p - FOOT
    cx = to_i32(torch.floor(lo[..., 0] / pyr.base)).clamp(0, pyr.lw - 1)
    cy = to_i32(torch.floor(lo[..., 1] / pyr.base)).clamp(0, pyr.lh - 1)
    quad = take_rows(pyr.rows, cy * pyr.lw + cx)
    return quad.amin(dim=-1)


def _probe_bound(pyr: ResidualPyramid, q: torch.Tensor, size: torch.Tensor):
    """Analytic lower bound of the dual-sampled stored depth at screen
    point q before the box min-R (contact.py:478-493)."""
    a, b, c = pyr.plane[0], pyr.plane[1], pyr.plane[2]
    plane_q = a * q[..., 0] + b * q[..., 1] + c
    m = (torch.abs(a) + torch.abs(b)) * (FOOT + 0.5)
    bound = torch.where(
        plane_q + m <= 1.0, plane_q,
        torch.where(plane_q - m >= 1.0, 1.0,
                    torch.clamp(plane_q, max=1.0) - m))
    band = ((q[..., 0] < FOOT) | (q[..., 0] > size[0] - FOOT)
            | (q[..., 1] < FOOT) | (q[..., 1] > size[1] - FOOT))
    return bound - torch.where(band, m, 0.0)


def _segment_cert(pyr: ResidualPyramid, march_start, march_dir, size):
    """Whole-segment no-hit certificate outside the occluder bbox: the gap
    is checked at the 4 interval endpoints (contact.py:496-587). Returns
    (certified, intersects)."""
    dev = march_start.device
    p0 = (march_start[..., :2] * 0.5 + 0.5) * size
    p1 = ((march_start[..., :2] + march_dir[..., :2]) * 0.5 + 0.5) * size

    t_in = torch.zeros(p0.shape[:-1], dtype=torch.float32, device=dev)
    t_out = torch.ones(p0.shape[:-1], dtype=torch.float32, device=dev)
    for axis in range(2):
        d = p1[..., axis] - p0[..., axis]
        s = p0[..., axis]
        safe_d = torch.where(torch.abs(d) > 1e-6, d, 1e-6)
        t1 = (pyr.occl_lo[axis] - s) / safe_d
        t2 = (pyr.occl_hi[axis] - s) / safe_d
        lo_t = torch.minimum(t1, t2)
        hi_t = torch.maximum(t1, t2)
        moving = torch.abs(d) > 1e-6
        inside = (s >= pyr.occl_lo[axis]) & (s <= pyr.occl_hi[axis])
        t_in = torch.where(moving, torch.maximum(t_in, lo_t),
                           torch.where(inside, t_in, 2.0))
        t_out = torch.where(moving, torch.minimum(t_out, hi_t),
                            torch.where(inside, t_out, -1.0))
    nonempty = pyr.occl_lo[0] <= pyr.occl_hi[0]
    intersects = (nonempty & (t_in <= t_out) & (t_in <= 1.0)
                  & (t_out >= 0.0))
    a = torch.where(intersects, t_in.clamp(0.0, 1.0), 1.0)
    b = torch.where(intersects, t_out.clamp(0.0, 1.0), 1.0)

    aa, bb = pyr.plane[0], pyr.plane[1]
    m = (torch.abs(aa) + torch.abs(bb)) * (FOOT + 0.5)
    thresh = -pyr.eps - pyr.eps

    def endpoint(t):
        cs_z = march_start[..., 2] + march_dir[..., 2] * t
        q = p0 + (p1 - p0) * t[..., None]
        plane_q = aa * q[..., 0] + bb * q[..., 1] + pyr.plane[2]
        return cs_z, plane_q, q

    def interval_ok(ts, te):
        z_s, pl_s, q_s = endpoint(ts)
        z_e, pl_e, q_e = endpoint(te)
        touch = torch.zeros(ts.shape, dtype=torch.bool, device=dev)
        for k in range(2):
            cmin = torch.minimum(q_s[..., k], q_e[..., k])
            cmax = torch.maximum(q_s[..., k], q_e[..., k])
            touch = touch | (cmin < FOOT) | (cmax > size[k] - FOOT)
        pen = m + torch.where(touch, m, 0.0)
        okc = ((z_s - (torch.clamp(pl_s, max=1.0) - pen) <= thresh)
               & (z_e - (torch.clamp(pl_e, max=1.0) - pen) <= thresh))
        case_a = (torch.maximum(pl_s, pl_e) + m <= 1.0) & ~touch
        oka = case_a & (z_s - pl_s <= thresh) & (z_e - pl_e <= thresh)
        case_b = (torch.minimum(pl_s, pl_e) - m >= 1.0) & ~touch
        okb = case_b & (z_s <= 1.0 + thresh) & (z_e <= 1.0 + thresh)
        return okc | oka | okb

    zeros = torch.zeros_like(a)
    ones = torch.ones_like(a)
    cert = interval_ok(zeros, a) & interval_ok(b, ones)
    return cert, intersects


def _stage2_certify(pyr: ResidualPyramid, start, direction, jitter,
                    size) -> torch.Tensor:
    """Per-probe level-0 box re-certification (contact.py:590-608)."""
    steps = torch.arange(LINEAR_STEPS, dtype=torch.float32,
                         device=jitter.device).reshape(
                             (LINEAR_STEPS,) + (1,) * jitter.ndim)
    t_all = (steps + jitter[None]) / LINEAR_STEPS
    cs = start[None] + direction[None] * t_all[..., None]
    uv = cs[..., :2] * 0.5 + 0.5
    inb = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
           & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
    q = uv * size
    min_r = _point_min_l0(pyr, q)
    bound = _probe_bound(pyr, q, size)
    ok = cs[..., 2] <= bound + min_r - pyr.eps
    return (~inb | ok).all(dim=0)


def contact_classify(pyr: ResidualPyramid, march_start, march_dir, cand,
                     depth_shape):
    """Stage-1 mask of rays that may hit (contact.py:611-621)."""
    cert, intersects = _segment_cert(pyr, march_start, march_dir,
                                     _size(depth_shape, march_start.device))
    return cand & (intersects | ~cert)


def _size(depth_shape, device) -> torch.Tensor:
    """(W, H) of the depth buffer as f32, made on the device."""
    hd, wd = depth_shape
    return torch.stack([torch.full((), float(wd), device=device),
                        torch.full((), float(hd), device=device)])


def contact_occupancy(world: torch.Tensor, normal: torch.Tensor,
                      uni: FrameUniforms, prev_depth: torch.Tensor, y0=0,
                      valid: torch.Tensor | None = None,
                      plane: torch.Tensor | None = None):
    """Diagnostic (contact.py:624-668): dense per-stage counts that size
    contact_capacity / contact_march_capacity, and the stage-3 probe
    bbox extent that sizes the committed march window, as a dict of
    device tensors. Pass the frame's `plane` (reference_plane)."""
    size = _size(prev_depth.shape, world.device)
    if plane is None:
        plane = fit_ground_plane(uni.prev_view_proj, prev_depth.shape[1],
                                 prev_depth.shape[0], uni.camera_pos)
    pyr = build_residual_pyramid(prev_depth, plane)
    _, stage2, payload = contact_front(world, normal, uni, prev_depth.shape,
                                       valid, y0, pyr=pyr)
    cert2 = contact_certify(pyr, payload, prev_depth.shape).reshape(
        stage2.shape)
    st3 = stage2 & ~cert2
    march_start = payload[:, 0:3].reshape(stage2.shape + (3,))
    march_dir = payload[:, 3:6].reshape(stage2.shape + (3,))
    p0 = (march_start[..., :2] * 0.5 + 0.5) * size
    p1 = ((march_start[..., :2] + march_dir[..., :2]) * 0.5 + 0.5) * size
    big = float(1 << 28)
    m = st3[..., None]
    lo = torch.where(m, torch.minimum(p0, p1), big).reshape(-1, 2).amin(0)
    hi = torch.where(m, torch.maximum(p0, p1), -big).reshape(-1, 2).amax(0)
    ext = torch.where(st3.any(),
                      torch.ceil((hi - lo).amax() + 2.0 * (FOOT + 1.0)), 0.0)
    return {"_stage2": stage2,
            "contact_stage2": stage2.sum(dtype=torch.int32),
            "contact_march": st3.sum(dtype=torch.int32),
            "contact_march_extent": to_i32(ext)}


def compute_contact_shadow_sparse(world: torch.Tensor, normal: torch.Tensor,
                                  uni: FrameUniforms,
                                  prev_depth: torch.Tensor, y0=0,
                                  capacity: int | None = None,
                                  march_capacity: int | None = None,
                                  valid: torch.Tensor | None = None,
                                  block_capacity: int | None = None,
                                  frag: torch.Tensor | None = None,
                                  plane: torch.Tensor | None = None,
                                  committed: bool = False,
                                  march_window: int | None = None
                                  ) -> torch.Tensor:
    """Sparse-exact contact shadows (contact.py:671-820): equal to
    compute_contact_shadow wherever `valid` while the capacities hold.
    `capacity` (default max(n // 4, 256)) bounds the stage-2 set,
    `march_capacity` (default max(capacity // 4, 256)) the marched set;
    `block_capacity` compacts stage 2 two-level over 8x8 blocks (64-runs
    on a flat domain). Without `committed` an overflow takes the dense
    march (one host branch); with it the march runs on the first entries
    (the others stay lit), and `march_window` (committed only) reads the
    probes from a (cw, cw) window of the depth on the marched rays' bbox.
    Domain: a row slab at y0 (frag=None) or any batch with explicit
    `frag` pixel centres."""
    batch = world.shape[:-1]
    hd, wd = prev_depth.shape
    n = int(np.prod(batch))
    cap2 = capacity if capacity is not None else max(n // 4, 256)
    cap3 = march_capacity if march_capacity is not None else max(
        cap2 // 4, 256)
    dev = world.device
    size = _size(prev_depth.shape, dev)

    if plane is None:
        plane = fit_ground_plane(uni.prev_view_proj, wd, hd, uni.camera_pos)
    pyr = build_residual_pyramid(prev_depth, plane)
    cand, stage2, payload = contact_front(world, normal, uni,
                                          prev_depth.shape, valid, y0, frag,
                                          pyr)

    blocked = None
    if (block_capacity is not None and stage2.ndim == 2
            and batch[0] % 8 == 0 and batch[1] % 8 == 0):
        blocked = compact_indices_blocked(stage2, cap2, 8, 8, block_capacity)
    elif block_capacity is not None and stage2.ndim == 1 and n % 64 == 0:
        blocked = compact_indices_blocked(stage2.reshape(n // 64, 64), cap2,
                                          1, 64, block_capacity)
    comp2 = (blocked.comp if blocked is not None
             else compact_indices(stage2, cap2))
    cert2 = contact_certify(pyr, payload, prev_depth.shape, comp2.idx,
                            comp2.count)

    stage3 = comp2.slot_valid & ~cert2
    comp3_local = compact_indices(stage3, cap3)
    safe_slot = comp3_local.idx.clamp(min=0).long()
    comp3 = Compacted(
        idx=torch.where(comp3_local.slot_valid, comp2.idx[safe_slot], -1),
        slot_valid=comp3_local.slot_valid, count=comp3_local.count)

    fits = (comp2.count <= cap2) & (comp3.count <= cap3)
    occupancy = [(comp2.count, cap2), (comp3.count, cap3)]
    if blocked is not None:
        fits = fits & (blocked.block_count <= block_capacity)
        occupancy.append((blocked.block_count, block_capacity))
    if committed or host_cond(fits, "contact", occupancy):
        window = None
        if committed and march_window is not None \
                and march_window < min(hd, wd):
            cw = march_window
            rows = gather_rows(payload, comp3)
            p0 = (rows[:, 0:2] * 0.5 + 0.5) * size
            p1 = ((rows[:, 0:2] + rows[:, 3:5]) * 0.5 + 0.5) * size
            big = float(1 << 28)
            v = comp3.slot_valid[:, None]
            lo = torch.clamp(torch.where(v, torch.minimum(p0, p1), big)
                             .amin(0) - FOOT - 1.0, max=big)
            oy = to_i32(lo[1]).clamp(0, hd - cw)
            ox = to_i32(lo[0]).clamp(0, wd - cw)
            window = (torch.stack([oy, ox]), cw)
        return contact_march(prev_depth, payload, comp3.idx, comp3.count,
                             window=window).reshape(batch)
    return contact_march(prev_depth, payload,
                         mask=cand.reshape(-1)).reshape(batch)
