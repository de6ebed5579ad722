"""Shadow filtering: cascade select/blend + PCF + PCSS (port of the dense
half of funky_tpu/passes/shadow_filter.py, lines 32-344). The sparse
evaluation (classify -> compact -> taps) is not ported yet.

Returns the reference's ShadowResult moments (v, m1, m2, kernel radius)
that feed the shadow TAA variance clamp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.sampling import (sample_nearest_border_packed,
                            sample_shadow_compare_packed)
from .uniforms import FrameUniforms

BLOCKER_SAMPLES = 16
PCF_SAMPLES = 16
GOLDEN_ANGLE = 2.4


class ShadowResult(NamedTuple):
    v: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    kernel_radius_texels: torch.Tensor


def interleaved_gradient_noise(screen_pos: torch.Tensor) -> torch.Tensor:
    """IGN (shadow_filter.py:39-43). jnp.mod on floats is torch.remainder."""
    d = screen_pos[..., 0] * 0.06711056 + screen_pos[..., 1] * 0.00583715
    return torch.remainder(52.9829189 * torch.remainder(d, 1.0), 1.0)


def shadow_frame_phi(screen_pos: torch.Tensor, frame: torch.Tensor,
                     taa_enabled: torch.Tensor) -> torch.Tensor:
    """Per-pixel rotation, animated only with shadow TAA on
    (shadow_filter.py:46-52)."""
    offset = torch.stack([frame * 13.37, frame * 17.17])
    p = torch.where(taa_enabled > 0.5, screen_pos + offset, screen_pos)
    return interleaved_gradient_noise(p) * 6.2831853


def vogel_disk_all(count: int, phi: torch.Tensor):
    """All `count` Vogel taps: (dx, dy) shaped (count, *phi.shape)
    (shadow_filter.py:63-73)."""
    i = torch.arange(count, dtype=torch.float32, device=phi.device).reshape(
        (count,) + (1,) * phi.ndim)
    r = torch.sqrt(i + 0.5) / torch.sqrt(
        torch.tensor(float(count), dtype=torch.float32, device=phi.device))
    theta = i * GOLDEN_ANGLE + phi[None]
    return r * torch.cos(theta), r * torch.sin(theta)


def select_cascade_blend(view_depth: torch.Tensor, splits: torch.Tensor):
    """Cascade pair + blend factor (shadow_filter.py:76-104)."""
    s0, s1, s2 = splits[0], splits[1], splits[2]
    f0 = torch.clamp(0.10 * s0, min=0.5)
    f1 = torch.clamp(0.10 * s1, min=0.5)
    f2 = torch.clamp(0.10 * s2, min=0.5)

    def smoothstep(e0, e1, x):
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
    t = torch.where(in0, smoothstep(s0 - f0, s0 + f0, view_depth),
                    torch.where(in1, smoothstep(s1 - f1, s1 + f1, view_depth),
                                torch.where(in2, smoothstep(s2 - f2, s2 + f2,
                                                            view_depth),
                                            0.0)))
    return c0.to(torch.int32), c1.to(torch.int32), t


def _project_all(uni: FrameUniforms, world, normal, n_dot_l):
    """Normal-offset bias + projection through every cascade
    (shadow_filter.py:107-126). Returns ((C, ..., 3) proj, bias)."""
    normal_bias = 0.02 * (1.0 - n_dot_l)
    biased = world + normal * normal_bias[..., None]
    ones = torch.ones(biased.shape[:-1] + (1,), dtype=torch.float32,
                      device=biased.device)
    hom = torch.cat([biased, ones], dim=-1)
    clip_all = torch.einsum("cij,...j->c...i", uni.light_view_proj, hom)
    proj_all = clip_all[..., :3] / clip_all[..., 3:4]
    bias = 0.0008 + 0.0025 * (1.0 - n_dot_l)
    return proj_all, bias


def _select_cascade(proj_all: torch.Tensor, cascade: torch.Tensor):
    """One cascade's projection per pixel (shadow_filter.py:129-141). The
    JAX one-hot sum adds zeros to one value, so a gather is exact."""
    idx = cascade.long()[None, ..., None].expand((1,) + proj_all.shape[1:])
    proj = torch.gather(proj_all, 0, idx)[0]
    uv = proj[..., :2] * 0.5 + 0.5
    receiver = proj[..., 2]
    in_bounds = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
                 & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
    return uv, receiver, in_bounds


def _light_project(uni, cascade, world, normal, n_dot_l):
    """shadow_filter.py:144-156."""
    proj_all, bias = _project_all(uni, world, normal, n_dot_l)
    uv, receiver, in_bounds = _select_cascade(proj_all, cascade)
    return uv, receiver, bias, in_bounds


def _pcss_taps(uni: FrameUniforms, shadow_maps, layer, uv, receiver, phi):
    """Blocker search + penumbra + penumbra-radius PCF
    (shadow_filter.py:159-219, full-table form). Returns
    (m1, m2, penumbra, has_blockers)."""
    texel = uni.shadow_map_size[2]
    light_size_texels = uni.shadow_bias[0] * 2.0

    dx, dy = vogel_disk_all(BLOCKER_SAMPLES, phi)
    off = torch.stack([dx, dy], dim=-1) * (light_size_texels * texel)
    d = sample_nearest_border_packed(shadow_maps, layer[None],
                                     uv[None] + off, border=1.0)
    hit = d < receiver[None]
    blocker_sum = torch.where(hit, d, 0.0).sum(dim=0)
    blocker_cnt = hit.to(torch.float32).sum(dim=0)

    has_blockers = blocker_cnt > 0.0
    blocker_depth = blocker_sum / torch.clamp(blocker_cnt, min=1.0)

    penumbra_ratio = (receiver - blocker_depth) / torch.clamp(
        blocker_depth, min=1e-8)
    penumbra = torch.clamp(penumbra_ratio * light_size_texels,
                           min=0.5)
    penumbra = torch.minimum(penumbra, light_size_texels * 2.0)

    dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
    off = torch.stack([dx, dy], dim=-1) * (penumbra * texel)[None, ..., None]
    s = sample_shadow_compare_packed(shadow_maps, layer[None],
                                     uv[None] + off, receiver[None])
    s_sum = s.sum(dim=0)
    s_sum2 = (s * s).sum(dim=0)
    return s_sum / PCF_SAMPLES, s_sum2 / PCF_SAMPLES, penumbra, has_blockers


def shadow_pcss(uni: FrameUniforms, shadow_maps: torch.Tensor,
                cascade: torch.Tensor, world, normal, n_dot_l,
                phi) -> ShadowResult:
    """PCSS with contact hardening (shadow_filter.py:222-245)."""
    uv, receiver, bias, in_bounds = _light_project(
        uni, cascade, world, normal, n_dot_l)
    receiver = receiver - bias
    m1, m2, penumbra, has_blockers = _pcss_taps(
        uni, shadow_maps, cascade, uv, receiver, phi)
    lit = ~has_blockers | ~in_bounds
    one = torch.ones_like(m1)
    return ShadowResult(
        v=torch.where(lit, one, m1),
        m1=torch.where(lit, one, m1),
        m2=torch.where(lit, one, m2),
        kernel_radius_texels=torch.where(lit, 0.0, penumbra),
    )


def _pcf_taps(uni: FrameUniforms, shadow_maps, layer, uv, ref, phi):
    """Fixed-radius PCF (shadow_filter.py:248-283). The frame-uniform
    lax.cond becomes a host branch on the radius."""
    texel = uni.shadow_map_size[2]
    radius = torch.clamp(uni.shadow_bias[0], min=0.5)

    def compare(off):
        return sample_shadow_compare_packed(shadow_maps, layer[None],
                                            uv[None] + off, ref[None])

    if float(radius) <= 1.25:
        offs = torch.tensor([[dx, dy] for dy in (-1, 0, 1)
                             for dx in (-1, 0, 1)], dtype=torch.float32,
                            device=uv.device) * texel
        s = compare(offs.reshape((9,) + (1,) * ref.ndim + (2,)))
        return (s.sum(dim=0) / 9.0, (s * s).sum(dim=0) / 9.0,
                torch.ones_like(ref))
    dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
    s = compare(torch.stack([dx, dy], dim=-1) * (radius * texel))
    return (s.sum(dim=0) / PCF_SAMPLES, (s * s).sum(dim=0) / PCF_SAMPLES,
            torch.full_like(ref, float(radius)))


def shadow_pcf(uni: FrameUniforms, shadow_maps: torch.Tensor,
               cascade: torch.Tensor, world, normal, n_dot_l,
               phi) -> ShadowResult:
    """Fixed-radius PCF (shadow_filter.py:293-310)."""
    uv, depth_ref, bias, in_bounds = _light_project(
        uni, cascade, world, normal, n_dot_l)
    ref = depth_ref - bias
    m1, m2, kernel = _pcf_taps(uni, shadow_maps, cascade, uv, ref, phi)
    one = torch.ones_like(m1)
    return ShadowResult(
        v=torch.where(in_bounds, m1, one),
        m1=torch.where(in_bounds, m1, one),
        m2=torch.where(in_bounds, m2, one),
        kernel_radius_texels=torch.where(in_bounds, kernel, 0.0),
    )


def mix_shadow(a: ShadowResult, b: ShadowResult,
               t: torch.Tensor) -> ShadowResult:
    """shadow_filter.py:313-323."""
    return ShadowResult(
        v=a.v + (b.v - a.v) * t,
        m1=a.m1 + (b.m1 - a.m1) * t,
        m2=a.m2 + (b.m2 - a.m2) * t,
        kernel_radius_texels=(a.kernel_radius_texels
                              + (b.kernel_radius_texels
                                 - a.kernel_radius_texels) * t),
    )


def cascaded_shadow(uni: FrameUniforms, shadow_maps: torch.Tensor,
                    world, normal, n_dot_l, view_depth, screen_pos,
                    use_pcss: bool):
    """Select the cascade pair, filter both, blend
    (shadow_filter.py:326-344). Returns (ShadowResult, c0, c1, t)."""
    c0, c1, t = select_cascade_blend(view_depth, uni.cascade_splits)
    phi = shadow_frame_phi(screen_pos, uni.debug_flags[3],
                           uni.debug_flags[2])
    fn = shadow_pcss if use_pcss else shadow_pcf
    s0 = fn(uni, shadow_maps, c0, world, normal, n_dot_l, phi)
    s1 = fn(uni, shadow_maps, c1, world, normal, n_dot_l, phi)
    return mix_shadow(s0, s1, t), c0, c1, t
