"""Shadow filtering: cascade select/blend + PCF + PCSS (port of
funky_tpu/passes/shadow_filter.py): the dense filter (lines 32-344) and
the sparse-exact one (`cascaded_shadow_sparse`, lines 359-890), which
classifies pixels, runs the exact taps on the compacted penumbra pairs
and writes closed forms elsewhere, and its diagnostic `classify_stats`
(lines 893-1037).

Returns the reference's ShadowResult moments (v, m1, m2, kernel radius)
that feed the shadow TAA variance clamp.

The 16 taps of each filter are summed in a fixed order (`_sum_taps`), not
by a reduction: a reduction kernel's order can depend on how many
outputs it has, and the sparse filter must equal the dense one bit for
bit on batches of any size.

On the card the tap sets (`_pcss_taps`, `_pcf_taps`) run as the kernel K6
(ops/pair_taps_cuda.py) and the pair groups' histogram (`_group_counts`)
as K7 (ops/group_counts_cuda.py), each equal to its plain twin bit for
bit; CPU tensors take the twins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math3d import apply_rows, const
from ..ops import group_counts_cuda, pair_taps_cuda
from ..ops.compact import (Compacted, compact_blocks_any, compact_indices,
                           compact_indices_blocked, gather_rows, host_cond,
                           scatter_back)
from ..ops.sampling import (dynamic_slice, sample_nearest_border_packed,
                            sample_nearest_border_window,
                            sample_shadow_compare_packed,
                            sample_shadow_compare_window, take_rows,
                            to_i32)
from .shadow_classify import classify
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


def _sum_taps(x: torch.Tensor) -> torch.Tensor:
    """x[0] + x[1] + ... in that order, for any batch shape."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def vogel_disk(i: int, count: int, phi: torch.Tensor):
    """Tap i of a Vogel disk rotated by per-pixel phi (shadow_filter.py:
    55-60, gltf.frag:107-112): (dx, dy) shaped like phi."""
    fi = const(float(i), torch.float32, phi.device)
    r = torch.sqrt(fi + 0.5) / torch.sqrt(const(float(count), torch.float32,
                                                phi.device))
    theta = fi * GOLDEN_ANGLE + phi
    return r * torch.cos(theta), r * torch.sin(theta)


def vogel_disk_all(count: int, phi: torch.Tensor):
    """All `count` Vogel taps: (dx, dy) shaped (count, *phi.shape)
    (shadow_filter.py:63-73)."""
    i = torch.arange(count, dtype=torch.float32, device=phi.device).reshape(
        (count,) + (1,) * phi.ndim)
    r = torch.sqrt(i + 0.5) / torch.full((), float(count),
                                         device=phi.device).sqrt()
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
    clip_all = apply_rows(hom, uni.light_view_proj)        # (C, ..., 4)
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


def _pcss_taps(uni: FrameUniforms, shadow_maps, layer, uv, receiver, phi,
               window=None, radius_only: bool = False, count=None):
    """Blocker search + penumbra + penumbra-radius PCF
    (shadow_filter.py:159-219). `window` = (rows (Wc, Wc, 4), origin
    (oy, ox), full map size) reads every tap from a window of one cascade
    (bit-identical values for in-window taps); radius_only skips the PCF
    phase and returns m1 = m2 = 1 (the LIT-certified radius-only groups).
    `count` (one int32, a pair group's live count): entries at or past it
    (flat order) get 0 (has_blockers False) and, on the card, no taps.
    Returns (m1, m2, penumbra, has_blockers). CUDA tensors go to the
    pair-tap kernel K6 (ops/pair_taps_cuda.py), which raises on what it
    does not take; CPU tensors to the plain twin."""
    if uv.device.type == "cuda":
        rows = pair_taps_cuda.pair_taps(
            shadow_maps, layer, uv, receiver, phi, uni.shadow_map_size,
            uni.shadow_bias, "radius_only" if radius_only else "pcss",
            window, count)
        return rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3] != 0.0
    return _pcss_taps_plain(uni, shadow_maps, layer, uv, receiver, phi,
                            window, radius_only, count)


def _live_rows(rows: torch.Tensor, count) -> torch.Tensor:
    """rows (..., k) with the rows of the flat entries at or past `count`
    zeroed: K6's count contract."""
    batch = rows.shape[:-1]
    slot = torch.arange(rows[..., 0].numel(), dtype=torch.int32,
                        device=rows.device).reshape(batch)
    return torch.where((slot < count.reshape(()))[..., None], rows, 0.0)


def _pcss_taps_plain(uni: FrameUniforms, shadow_maps, layer, uv, receiver,
                     phi, window=None, radius_only: bool = False,
                     count=None):
    """_pcss_taps in torch ops: the CPU path and K6's test oracle."""
    texel = uni.shadow_map_size[2]
    light_size_texels = uni.shadow_bias[0] * 2.0

    dx, dy = vogel_disk_all(BLOCKER_SAMPLES, phi)
    off = torch.stack([dx, dy], dim=-1) * (light_size_texels * texel)
    if window is not None:
        d = sample_nearest_border_window(window[0], window[1], window[2],
                                         uv[None] + off, border=1.0)
    else:
        d = sample_nearest_border_packed(shadow_maps, layer[None],
                                         uv[None] + off, border=1.0)
    hit = d < receiver[None]
    blocker_sum = _sum_taps(torch.where(hit, d, 0.0))
    blocker_cnt = _sum_taps(hit.to(torch.float32))

    has_blockers = blocker_cnt > 0.0
    blocker_depth = blocker_sum / torch.clamp(blocker_cnt, min=1.0)

    penumbra_ratio = (receiver - blocker_depth) / torch.clamp(
        blocker_depth, min=1e-8)
    penumbra = torch.clamp(penumbra_ratio * light_size_texels,
                           min=0.5)
    penumbra = torch.minimum(penumbra, light_size_texels * 2.0)
    if radius_only:
        one = torch.ones_like(penumbra)
        m1, m2 = one, one
    else:
        dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
        off = torch.stack([dx, dy], dim=-1) * (penumbra
                                               * texel)[None, ..., None]
        if window is not None:
            s = sample_shadow_compare_window(window[0], window[1], window[2],
                                             uv[None] + off, receiver[None])
        else:
            s = sample_shadow_compare_packed(shadow_maps, layer[None],
                                             uv[None] + off, receiver[None])
        m1, m2 = _sum_taps(s) / PCF_SAMPLES, _sum_taps(s * s) / PCF_SAMPLES
    if count is None:
        return m1, m2, penumbra, has_blockers
    rows = _live_rows(torch.stack([m1, m2, penumbra,
                                   has_blockers.to(torch.float32)], dim=-1),
                      count)
    return rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3] != 0.0


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


def _pcf_taps(uni: FrameUniforms, shadow_maps, layer, uv, ref, phi,
              window=None, count=None):
    """Fixed-radius PCF (shadow_filter.py:248-283), `window` and `count`
    as in _pcss_taps: (m1, m2, kernel). CUDA tensors go to K6, which
    selects the 3x3 or the Vogel kernel by the device-side radius per
    entry; CPU tensors to the plain twin."""
    if uv.device.type == "cuda":
        rows = pair_taps_cuda.pair_taps(shadow_maps, layer, uv, ref, phi,
                                        uni.shadow_map_size, uni.shadow_bias,
                                        "pcf", window, count)
        return rows[..., 0], rows[..., 1], rows[..., 2]
    return _pcf_taps_plain(uni, shadow_maps, layer, uv, ref, phi, window,
                           count)


def _pcf_taps_plain(uni: FrameUniforms, shadow_maps, layer, uv, ref, phi,
                    window=None, count=None):
    """_pcf_taps in torch ops: the CPU path and K6's test oracle. The
    frame-uniform lax.cond computes both kernels and selects by the
    device-side radius, so the host never reads it and a committed frame
    can be captured as a CUDA graph; each kernel's values are the
    branch's own."""
    texel = uni.shadow_map_size[2]
    radius = torch.clamp(uni.shadow_bias[0], min=0.5)

    def compare(off):
        if window is not None:
            return sample_shadow_compare_window(
                window[0], window[1], window[2], uv[None] + off, ref[None])
        return sample_shadow_compare_packed(shadow_maps, layer[None],
                                            uv[None] + off, ref[None])

    offs = const([[dx, dy] for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                 torch.float32, uv.device) * texel
    s3 = compare(offs.reshape((9,) + (1,) * ref.ndim + (2,)))
    dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
    s = compare(torch.stack([dx, dy], dim=-1) * (radius * texel))
    small = radius <= 1.25
    m1 = torch.where(small, _sum_taps(s3) / 9.0, _sum_taps(s) / PCF_SAMPLES)
    m2 = torch.where(small, _sum_taps(s3 * s3) / 9.0,
                     _sum_taps(s * s) / PCF_SAMPLES)
    kernel = torch.where(small, 1.0, radius.expand_as(ref))
    if count is None:
        return m1, m2, kernel
    rows = _live_rows(torch.stack([m1, m2, kernel], dim=-1), count)
    return rows[..., 0], rows[..., 1], rows[..., 2]


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


def pcf_frame_kernel(uni: FrameUniforms) -> torch.Tensor:
    """The frame-constant PCF kernel radius (shadow_filter.py:286-290)."""
    radius = torch.clamp(uni.shadow_bias[0], min=0.5)
    return torch.where(radius <= 1.25, 1.0, radius)


# ---------------------------------------------------------------------------
# Sparse evaluation: classify -> compact -> exact taps on penumbra pairs
# (shadow_filter.py:347-1037), with every knob the autotuner sets:
# per-cascade pair caps, two-level compaction, radius-only groups, routed
# window groups, light-map fetch groups, committed-mode tap windows, and
# committed mode itself.
# ---------------------------------------------------------------------------


def _classified_select(cmaps, proj_all, bias, cascade, softness, use_pcss):
    """shadow_filter.py:370-378."""
    uv, receiver, inb = _select_cascade(proj_all, cascade)
    receiver = receiver - bias
    lit, umbra = classify(cmaps, cascade, uv, receiver, softness, use_pcss)
    return uv, receiver, inb, lit, umbra


def band_budget(n: int) -> int:
    """The blend band's block budget on a domain of n elements
    (shadow_filter.py:417)."""
    return max((n // 64) // 8, 128)


def _pair_classification(uni: FrameUniforms, cmaps, c0, c1, blend, world,
                         normal, n_dot_l, softness, use_pcss: bool, valid,
                         committed: bool = False,
                         skip_backfacing: bool = False,
                         band_bcap: int | None = None):
    """Project once, classify both cascades and derive the pair masks
    that need exact taps (shadow_filter.py:381-471). c1 is classified only
    on the 8x8 blocks (64-runs on a flat domain) that touch a blend band;
    an overflow of that block budget (band_bcap, by default the domain's)
    takes the dense classification (one host branch), or in committed mode
    drops the excess blocks, whose pixels then become pairs.
    skip_backfacing drops the pairs of pixels with n_dot_l <= 0
    (shadow_filter.py:559-566, 919-922). Returns (uv0, r0, inb0, lit0,
    um0, uv1, r1, inb1, lit1, um1, needs0, needs1)."""
    n = blend.numel()
    proj_all, bias = _project_all(uni, world, normal, n_dot_l)
    uv0, r0, inb0, lit0, um0 = _classified_select(
        cmaps, proj_all, bias, c0, softness, use_pcss)

    uv1, recv1, inb1 = _select_cascade(proj_all, c1)
    r1 = recv1 - bias
    band_mask = blend & valid

    if band_bcap is None:
        band_bcap = band_budget(n)
    comp_band = compact_blocks_any(band_mask, band_bcap)
    if comp_band is not None and (committed or host_cond(
            comp_band.count <= band_bcap, "shadow_band",
            [(comp_band.count, band_bcap)])):
        uv_e = gather_rows(uv1.reshape(n, 2), comp_band)
        r_e = gather_rows(r1.reshape(n), comp_band)
        c_e = gather_rows(c1.reshape(n), comp_band)
        lit_e, um_e = classify(cmaps, c_e, uv_e, r_e, softness, use_pcss)
        none = torch.zeros((n,), dtype=torch.bool, device=blend.device)
        lit1 = scatter_back(none, comp_band, lit_e & comp_band.slot_valid)
        um1 = scatter_back(none, comp_band, um_e & comp_band.slot_valid)
        lit1, um1 = lit1.reshape(blend.shape), um1.reshape(blend.shape)
    else:
        lit1, um1 = classify(cmaps, c1, uv1, r1, softness, use_pcss)

    if use_pcss:
        # Inside a blend band the pair must close the same way on both
        # sides, else both cascades evaluate exactly (the kernel radius
        # feeds the TAA variance clamp); see the JAX comments.
        lit0e = lit0 | ~inb0
        lit1e = lit1 | ~inb1
        closed = torch.where(blend,
                             (lit0e & lit1e) | (um0 & um1 & inb0 & inb1),
                             lit0e | um0)
        needs0 = valid & inb0 & ~closed
        needs1 = valid & inb1 & blend & ~closed
    else:
        needs0 = valid & inb0 & ~lit0 & ~um0
        needs1 = valid & inb1 & blend & ~lit1 & ~um1
    if skip_backfacing:
        facing = n_dot_l > 0.0
        needs0 = needs0 & facing
        needs1 = needs1 & facing
    return (uv0, r0, inb0, lit0, um0, uv1, r1, inb1, lit1, um1, needs0,
            needs1)


def _tap_reach(softness: torch.Tensor) -> torch.Tensor:
    """The traced tap-reach margin in texels (shadow_filter.py:616-620)."""
    return to_i32(torch.ceil(4.0 * torch.clamp(softness, min=1.0))) + 2


def _base_texel(uv: torch.Tensor, s: int):
    """Each entry's bilinear base texel (x, y) in a size-s map."""
    return (to_i32(torch.floor(uv[..., 0] * s - 0.5)),
            to_i32(torch.floor(uv[..., 1] * s - 0.5)))


def _in_windows(cas, uv, origins, sizes, pad, s: int, use):
    """Entries of cascade c whose base texel lies inside its window minus
    the tap reach, for each cascade with use(c) (shadow_filter.py:643-656,
    961-974)."""
    bx, by = _base_texel(uv, s)
    inw = torch.zeros(cas.shape, dtype=torch.bool, device=cas.device)
    for c in range(len(sizes)):
        if use(c):
            oy, ox = origins[c]
            inw = inw | ((cas == c)
                         & (bx >= ox + pad) & (bx < ox + sizes[c] - pad - 1)
                         & (by >= oy + pad) & (by < oy + sizes[c] - pad - 1))
    return inw


def _fetchable(world, normal, cas, uv, recv, needs_h, origins, sizes,
               s: int, ok_soft):
    """Needed entries that fetch from a light map: ground-plane receivers
    whose texel lies inside their cascade's light-space window
    (shadow_filter.py:595-606, 934-945)."""
    from .shadow_lightspace import ground_eligible

    el = ground_eligible(world, normal, recv) & ok_soft
    tx = to_i32(torch.floor(uv[..., 0] * s))
    ty = to_i32(torch.floor(uv[..., 1] * s))
    inw = torch.zeros(needs_h.shape, dtype=torch.bool, device=needs_h.device)
    for c in range(len(sizes)):
        if sizes[c]:
            oy, ox = origins[c]
            inw = inw | ((cas == c)
                         & (tx >= ox) & (tx < ox + sizes[c])
                         & (ty >= oy) & (ty < oy + sizes[c]))
    return needs_h & el & inw


def _fetch_rows(rows, origin, wc: int, uv: torch.Tensor,
                s: int) -> torch.Tensor:
    """A fetch group's results: ONE row per entry of its cascade's
    (wc * wc, 4) light map at the entry's texel, clamped into the window
    (entries lie inside it by construction), as (v, m1, m2, kernel)
    (shadow_filter.py:774-788)."""
    oy, ox = origin
    tx = to_i32(torch.floor(uv[:, 0] * s))
    ty = to_i32(torch.floor(uv[:, 1] * s))
    loc = (torch.clamp(ty - oy, 0, wc - 1) * wc
           + torch.clamp(tx - ox, 0, wc - 1))
    r4 = take_rows(rows, loc)
    return torch.stack([r4[:, 0], r4[:, 0], r4[:, 1], r4[:, 2]], dim=-1)


def _group_counts(needs, group_key, n_groups: int) -> torch.Tensor:
    """(n_groups,) int32: how many needed entries each group key holds
    (shadow_filter.py:714-716). CUDA tensors go to the histogram kernel K7
    (ops/group_counts_cuda.py), which raises on what it does not take; CPU
    tensors to the plain twin."""
    if needs.device.type == "cuda":
        return group_counts_cuda.group_counts(needs, group_key, n_groups)
    return _group_counts_plain(needs, group_key, n_groups)


def _group_counts_plain(needs, group_key, n_groups: int) -> torch.Tensor:
    """_group_counts as one scatter_add_: the CPU path and K7's test
    oracle."""
    key = torch.where(needs, group_key, n_groups).reshape(-1).long()
    counts = torch.zeros(n_groups + 1, dtype=torch.int32,
                         device=needs.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    return counts[:n_groups]


def cascaded_shadow_sparse(uni: FrameUniforms, shadow_maps: torch.Tensor,
                           cmaps, world: torch.Tensor, normal: torch.Tensor,
                           n_dot_l: torch.Tensor, view_depth: torch.Tensor,
                           screen_pos: torch.Tensor, use_pcss: bool,
                           valid: torch.Tensor | None = None,
                           capacity: int | None = None,
                           cascade_caps: tuple | None = None,
                           block_capacity: int | None = None,
                           tap_windows: tuple | None = None,
                           light_maps=None,
                           skip_backfacing: bool = False,
                           committed: bool = False,
                           lit_cascade_caps: tuple | None = None,
                           route_windows=None,
                           route_caps: tuple | None = None):
    """Sparse-exact main shadow evaluation (shadow_filter.py:474-890):
    identical outputs to `cascaded_shadow` on every valid pixel while the
    capacities hold. The needed (pixel, cascade) pairs are compacted in
    groups, each group runs the exact taps and the results are scattered
    into the closed-form base. Groups, in order: the full tap core per
    cascade (`cascade_caps`, default `capacity` each), the radius-only
    LIT-side entries (`lit_cascade_caps`, PCSS only), the routed entries
    inside a pre-planned footprint window (`route_windows` = (origins,
    sizes), `route_caps`), which read their taps from that window, and
    the light-map fetches.

    light_maps: (rows, origins, sizes, fetch_caps) of the light-space
    ground evaluation (passes/shadow_lightspace.py): a needed ground-plane
    entry inside its cascade's window reads its result as ONE row of
    rows[c], a (sizes[c]**2, 4) map (the mode's documented deviation);
    fetch_caps default to `capacity` per window. skip_backfacing: pixels
    with n_dot_l <= 0 need no taps (their shadow multiplies 0; their TAA
    history carries the lit placeholder, a documented deviation).

    capacity: total pairs (default max(n // 16, 256)). block_capacity:
    compact two-level over 8x8 blocks (64-runs on a flat domain).
    tap_windows: committed mode reads each cascade's full and radius-only
    groups from a (Wc, Wc) window on the group's base-texel bbox; an entry
    outside it clamps to the edge. Without `committed`, any overflow takes
    the dense filter (one host branch), and the groups read the full tables:
    JAX's window-fit cond picks between two bit-identical reads, so the
    port reads the one that needs no branch. With `committed` nothing is
    read on the host and an overflow truncates each group to its first
    entries, as in JAX. Works on any domain shape. Returns (ShadowResult,
    c0, c1, t)."""
    c0, c1, t = select_cascade_blend(view_depth, uni.cascade_splits)
    phi = shadow_frame_phi(screen_pos, uni.debug_flags[3],
                           uni.debug_flags[2])
    softness = uni.shadow_bias[0]
    dev = c0.device

    n = c0.numel()
    cap = capacity if capacity is not None else max(n // 16, 256)
    if valid is None:
        valid = torch.ones(c0.shape, dtype=torch.bool, device=dev)
    blend = t > 0.0

    (uv0, r0, inb0, lit0, um0, uv1, r1, inb1, lit1, um1, needs0,
     needs1) = _pair_classification(uni, cmaps, c0, c1, blend, world,
                                    normal, n_dot_l, softness, use_pcss,
                                    valid, committed, skip_backfacing)

    def dense_base(inb, umbra):
        m = torch.where(umbra & inb, 0.0, 1.0)
        if use_pcss:
            r = torch.zeros(c0.shape, dtype=torch.float32, device=dev)
        else:
            r = torch.where(inb, pcf_frame_kernel(uni), 0.0)
        return torch.stack([m, m, m, r], dim=-1)

    needs = torch.stack([needs0, needs1])
    n_casc = shadow_maps.shape[0]
    s_full = shadow_maps.shape[1]
    pair_layer = torch.stack([c0, c1])
    pad = _tap_reach(softness)

    # Light-map fetches: a per-entry value test; precedence fetch > route
    # > radius-only (shadow_filter.py:589-614).
    if light_maps is not None:
        light_rows, light_origins, light_sizes, light_caps = light_maps
        ok_soft = softness <= cmaps.max_softness
        fetch = torch.stack([
            _fetchable(world, normal, c0, uv0, r0, needs0, light_origins,
                       light_sizes, s_full, ok_soft),
            _fetchable(world, normal, c1, uv1, r1, needs1, light_origins,
                       light_sizes, s_full, ok_soft)])
        caps_f = (tuple(light_caps) if light_caps is not None
                  else tuple(cap if light_sizes[c] else 0
                             for c in range(n_casc)))
    else:
        fetch = torch.zeros_like(needs)
        caps_f = ()

    rad_split = use_pcss and lit_cascade_caps is not None
    rad = (torch.stack([needs0 & lit0, needs1 & lit1]) & ~fetch if rad_split
           else torch.zeros_like(needs))
    caps_r = tuple(lit_cascade_caps) if rad_split else ()
    routable = (route_windows is not None and route_caps is not None
                and any(route_caps))
    caps_rt = tuple(route_caps) if routable else ()
    if routable:
        r_origins, r_sizes = route_windows

        def use_route(c):
            return r_sizes[c] and caps_rt[c] and r_sizes[c] < s_full

        route = torch.stack([
            _in_windows(c0, uv0, r_origins, r_sizes, pad, s_full, use_route),
            _in_windows(c1, uv1, r_origins, r_sizes, pad, s_full,
                        use_route)]) & needs & ~fetch
        rad = rad & ~route

    # Group keys: [full x n_casc][radius-only][route][fetch], each kind
    # present only when configured (shadow_filter.py:665-687).
    n_kinds, rad_k, route_k, fetch_k = 1, None, None, None
    if rad_split:
        rad_k, n_kinds = n_kinds, n_kinds + 1
    if routable:
        route_k, n_kinds = n_kinds, n_kinds + 1
    if caps_f:
        fetch_k, n_kinds = n_kinds, n_kinds + 1
    kind = torch.zeros(needs.shape, dtype=torch.int32, device=dev)
    if rad_split:
        kind = torch.where(rad, rad_k, kind)
    if routable:
        kind = torch.where(route, route_k, kind)
    if caps_f:
        kind = torch.where(fetch, fetch_k, kind)
    group_key = pair_layer + n_casc * kind
    n_groups = n_kinds * n_casc

    fits_blocks = torch.ones((), dtype=torch.bool, device=dev)
    blocked = None
    if block_capacity is not None and c0.ndim == 2 \
            and c0.shape[0] % 8 == 0 and c0.shape[1] % 8 == 0:
        blocked = compact_indices_blocked(needs, cap, 8, 8, block_capacity,
                                          group_key=group_key)
    elif block_capacity is not None and c0.ndim == 1 and n % 64 == 0:
        blocked = compact_indices_blocked(
            needs.reshape(2, n // 64, 64), cap, 1, 64, block_capacity,
            group_key=group_key.reshape(2, n // 64, 64))
    if blocked is not None:
        comp = blocked.comp
        fits_blocks = blocked.block_count <= block_capacity
    else:
        comp = compact_indices(needs, cap, group_key=group_key)
    counts_c = _group_counts(needs, group_key, n_groups)
    offs = torch.cumsum(counts_c, 0) - counts_c
    caps_c = tuple(cascade_caps) if cascade_caps is not None \
        else (cap,) * n_casc
    caps_all = caps_c + caps_r + caps_rt + caps_f
    caps_t = const(caps_all, torch.int32, dev)
    fits = (comp.count <= cap) & fits_blocks & (counts_c <= caps_t).all()

    occupancy = [(comp.count, cap)] + [(counts_c[g], caps_all[g])
                                       for g in range(n_groups)]
    if blocked is not None:
        occupancy.append((blocked.block_count, block_capacity))
    if committed or host_cond(fits, "shadow_pairs", occupancy):
        out = torch.stack([dense_base(inb0, um0),
                           dense_base(inb1, um1)]).reshape(2 * n, 4)
        phi2 = phi.reshape(1, n).expand(2, n)
        payload = torch.stack([
            torch.stack([uv0[..., 0], uv0[..., 1], r0], dim=-1),
            torch.stack([uv1[..., 0], uv1[..., 1], r1], dim=-1),
        ]).reshape(2 * n, 3)
        payload = torch.cat([payload, phi2.reshape(2 * n, 1)], dim=-1)
        idx_pad = torch.cat([comp.idx, torch.full((max(caps_all),), -1,
                                                  dtype=torch.int32,
                                                  device=dev)])
        for g, cc in enumerate(caps_all):
            if cc == 0:
                continue
            c = g % n_casc
            slot = torch.arange(cc, dtype=torch.int32, device=dev)
            # JAX's dynamic_slice: past the compaction (a committed
            # overflow) the start clamps and the slots read -1 padding.
            idx_c = dynamic_slice(idx_pad, (offs[g],), (cc,))
            valid_c = slot < counts_c[g]
            compc = Compacted(idx=torch.where(valid_c, idx_c, -1),
                              slot_valid=valid_c, count=counts_c[g])
            rows = gather_rows(payload, compc)
            uv_e, recv_e, phi_e = rows[:, :2], rows[:, 2], rows[:, 3]
            if caps_f and g // n_casc == fetch_k:
                out = scatter_back(out, compc, _fetch_rows(
                    light_rows[c], light_origins[c], light_sizes[c], uv_e,
                    s_full))
                continue
            window = None
            if routable and g // n_casc == route_k:
                wcr = int(r_sizes[c])
                if 0 < wcr < s_full:
                    oy, ox = r_origins[c]
                    window = (dynamic_slice(shadow_maps[c], (oy, ox),
                                            (wcr, wcr)), (oy, ox), s_full)
            elif committed and tap_windows is not None \
                    and 0 < int(tap_windows[c]) < s_full:
                # The full and the radius-only groups, each on its own
                # entries' bbox (shadow_filter.py:832-858).
                wc = int(tap_windows[c])
                big = 1 << 28
                bx_e, by_e = _base_texel(uv_e, s_full)
                lo_x = torch.where(valid_c, bx_e, big).amin() - pad
                lo_y = torch.where(valid_c, by_e, big).amin() - pad
                oy = torch.clamp(lo_y, 0, s_full - wc)
                ox = torch.clamp(lo_x, 0, s_full - wc)
                window = (dynamic_slice(shadow_maps[c], (oy, ox), (wc, wc)),
                          (oy, ox), s_full)
            maps_c = shadow_maps[c:c + 1]
            layer0 = torch.zeros((cc,), dtype=torch.int32, device=dev)
            if use_pcss:
                m1, m2, pen, hasb = _pcss_taps(
                    uni, maps_c, layer0, uv_e, recv_e, phi_e, window=window,
                    radius_only=rad_split and g // n_casc == rad_k,
                    count=counts_c[g])
                # Entries are in bounds by construction; the no-blocker
                # lit override still applies.
                vals = torch.stack([torch.where(hasb, m1, 1.0),
                                    torch.where(hasb, m1, 1.0),
                                    torch.where(hasb, m2, 1.0),
                                    torch.where(hasb, pen, 0.0)], dim=-1)
            else:
                m1, m2, kern = _pcf_taps(uni, maps_c, layer0, uv_e, recv_e,
                                         phi_e, window=window,
                                         count=counts_c[g])
                vals = torch.stack([m1, m1, m2, kern], dim=-1)
            out = scatter_back(out, compc, vals)
    else:
        fn = shadow_pcss if use_pcss else shadow_pcf
        sd0 = fn(uni, shadow_maps, c0, world, normal, n_dot_l, phi)
        sd1 = fn(uni, shadow_maps, c1, world, normal, n_dot_l, phi)
        out = torch.stack([torch.stack(sd0, dim=-1),
                           torch.stack(sd1, dim=-1)]).reshape(2 * n, 4)

    out = out.reshape((2,) + tuple(c0.shape) + (4,))
    s0 = ShadowResult(out[0, ..., 0], out[0, ..., 1], out[0, ..., 2],
                      out[0, ..., 3])
    s1 = ShadowResult(out[1, ..., 0], out[1, ..., 1], out[1, ..., 2],
                      out[1, ..., 3])
    return mix_shadow(s0, s1, t), c0, c1, t


def _sum(mask) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def classify_stats(uni: FrameUniforms, cmaps, world, normal, n_dot_l,
                   view_depth, screen_pos, use_pcss: bool,
                   valid: torch.Tensor | None = None, light_windows=None,
                   skip_backfacing: bool = False, committed: bool = False,
                   route_windows=None, domain: int | None = None):
    """Diagnostic (shadow_filter.py:893-1037): the classification
    histogram and the pair counts the sparse path compacts, split the way
    the frame groups them, as a dict of device tensors. light_windows /
    route_windows: (origins, sizes) of the light-space and route windows;
    skip_backfacing and committed as the frame's flags.

    Besides JAX's keys, `light_fetch_lit_per_cascade` and
    `light_fetch_route_per_cascade` count the fetch entries that a frame
    without light maps sends to its radius-only and routed groups, and
    `need_extent_per_cascade` is the tap extent with the fetch entries in
    it; the port's derive_sparse_config folds them back. `domain`: the
    element count of the domain the frame classifies on (its row slab or
    block budget, frame.py::back_half): the band is classified with that
    domain's budget, as the frame classifies it, so that in committed mode
    the pixels of the blocks past it count as the pairs they become, and
    `band_bcap` reports it, where JAX classifies with and reports this
    call's dense domain's (ROADMAP, deliberate divergences)."""
    c0, c1, t = select_cascade_blend(view_depth, uni.cascade_splits)
    softness = uni.shadow_bias[0]
    if valid is None:
        valid = torch.ones(c0.shape, dtype=torch.bool, device=c0.device)
    blend = t > 0.0
    band_bcap = band_budget(blend.numel() if domain is None else domain)
    (uv0, r0, _, lit0, um0, uv1, r1, _, lit1, _, needs0,
     needs1) = _pair_classification(uni, cmaps, c0, c1, blend, world,
                                    normal, n_dot_l, softness, use_pcss,
                                    valid, committed, skip_backfacing,
                                    band_bcap)
    needs = torch.stack([needs0, needs1])
    pair_layer = torch.stack([c0, c1])
    s_full = cmaps.size

    fetch = torch.zeros_like(needs)
    if light_windows is not None:
        origins, sizes = light_windows
        ok_soft = softness <= cmaps.max_softness
        fetch = torch.stack([
            _fetchable(world, normal, c0, uv0, r0, needs0, origins, sizes,
                       s_full, ok_soft),
            _fetchable(world, normal, c1, uv1, r1, needs1, origins, sizes,
                       s_full, ok_soft)])
    taps = needs & ~fetch

    in_route = torch.zeros_like(needs)
    if route_windows is not None:
        r_origins, r_sizes = route_windows
        pad = _tap_reach(softness)

        def use(c):
            return bool(r_sizes[c])

        in_route = torch.stack([
            _in_windows(c0, uv0, r_origins, r_sizes, pad, s_full, use),
            _in_windows(c1, uv1, r_origins, r_sizes, pad, s_full, use)])
    routem = taps & in_route
    lit_side = (torch.stack([lit0, lit1]) if use_pcss
                else torch.zeros_like(needs))
    radm = taps & lit_side & ~routem
    taps_full = taps & ~radm & ~routem

    # Per-cascade base-texel bbox extents of the needed taps.
    bx, by = _base_texel(torch.stack([uv0, uv1]), s_full)
    big = 1 << 28

    def extents(mask):
        out = []
        for c in range(4):
            m = mask & (pair_layer == c)
            ex = (torch.where(m, bx, -big).amax()
                  - torch.where(m, bx, big).amin() + 1)
            ey = (torch.where(m, by, -big).amax()
                  - torch.where(m, by, big).amin() + 1)
            out.append(torch.where(m.any(), torch.maximum(ex, ey), 0))
        return torch.stack(out)

    band_mask = blend & valid
    hh, ww = band_mask.shape
    bm = torch.nn.functional.pad(band_mask, (0, -ww % 8, 0, -hh % 8))
    band_blocks = bm.reshape(bm.shape[0] // 8, 8, bm.shape[1] // 8,
                             8).any(dim=3).any(dim=1).sum(dtype=torch.int32)

    def per_cascade(mask):
        return torch.stack([_sum(mask & (pair_layer == c))
                            for c in range(4)])

    return {
        "_needs": needs,
        "band_blocks": band_blocks,
        "band_bcap": torch.tensor(band_bcap, dtype=torch.int32),
        "pairs": _sum(needs),
        "pairs_per_cascade": per_cascade(taps_full),
        "pairs_lit_per_cascade": per_cascade(radm),
        "pairs_route_per_cascade": per_cascade(routem),
        "light_fetch_per_cascade": per_cascade(fetch),
        "light_fetch_lit_per_cascade": per_cascade(
            fetch & lit_side & ~in_route),
        "light_fetch_route_per_cascade": per_cascade(fetch & in_route),
        "tap_extent_per_cascade": extents(taps),
        "need_extent_per_cascade": extents(needs),
        "lit0": _sum(valid & lit0),
        "umbra0": _sum(valid & um0),
        "pixels": _sum(valid),
    }
