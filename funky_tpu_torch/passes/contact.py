"""Contact shadows: screen-space ray march toward the light (port of the
dense march of funky_tpu/passes/contact.py, lines 40-236). 8 jittered
linear steps + 4 bisection steps against the previous frame's depth,
read through both the bilinear and the nearest filter. The sparse
certificate path is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.sampling import quad_pack, sample_depth_dual_packed
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
        clip = torch.einsum("ij,...j->...i", vp, torch.cat([p, ones], dim=-1))
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


def _march(depth_packed, march_start, march_dir, jitter):
    """8-linear + 4-bisection hybrid root find (contact.py:124-186).
    Returns (intersected, max_t, last_pen)."""
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


def compute_contact_shadow(world: torch.Tensor, normal: torch.Tensor,
                           uni: FrameUniforms, prev_depth: torch.Tensor,
                           y0: int = 0) -> torch.Tensor:
    """Shadow factor in [0, 1] for a row slab at global row y0
    (contact.py:215-236); prev_depth is the full previous frame."""
    depth_packed = quad_pack(prev_depth)
    march_start, march_dir, on_screen, facing = _ray_setup(world, normal,
                                                           uni)
    h, w = world.shape[:2]
    jitter = _jitter(h, w, y0, uni.debug_flags[3])
    intersected, max_t, last_pen = _march(depth_packed, march_start,
                                          march_dir, jitter)
    return _soft_term(intersected & on_screen & facing, max_t, last_pen)
