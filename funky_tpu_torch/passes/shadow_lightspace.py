"""Dense light-space shadow evaluation for planar (ground) receivers (port
of funky_tpu/passes/shadow_lightspace.py): the light-space footprint
windows that the synthesized cascade maps, the routed tap groups and this
mode share, and the mode itself (`light_space_ground_shadows`).

Under the orthographic light a ground pixel's PCSS/PCF result depends
only on its light-space texel, so `build_light_shadow_map` evaluates it
over a (wc, wc) window of each cascade as shifted-window reads, and the
sparse filter's ground pixels fetch their (v, m2, kernel) row from it
instead of running ~34 taps (passes/shadow_filter.py). The mode's
documented deviations from the per-pixel filter are the JAX module's:
the evaluation point snaps to the texel centre, the per-pixel rotation
becomes `phases` per-frame rotations chosen by global texel parity, and
PCSS's penumbra PCF runs at `rungs` log-spaced radii, interpolated per
texel.

The port keeps the JAX arithmetic and its summation order. On the card
each map is one launch of the light-map kernel K5 (ops/lightmap_cuda.py,
csrc/lightmap.cu): one thread per texel walks its own phase's taps over
its block's tile of the window, staged in shared memory with the tap
geometry that `kernel_params` packs. The
plain twin `build_light_shadow_map_plain` reads the 16 taps of a phase's
blocker search or of one PCF rung for the four phases at once, as one
row gather (`take_rows`) of the haloed window at device-valued shifts,
sums them in the JAX order (`_sum_taps`), and keeps each texel's own
phase at the end, as JAX does. Both read the tap
geometry of `light_map_taps`, which the frame builds once for all its
windows.

Window origins and tap shifts stay device tensors: the frame slices with
them by index arithmetic, never by reading them on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..math3d import const, f32 as to_f32
from ..ops import lightmap_cuda
from ..ops.sampling import dynamic_slice, quad_pack, take_rows, to_i32
from .shadow_classify import plane_through
from .shadow_filter import (BLOCKER_SAMPLES, PCF_SAMPLES, _sum_taps,
                            shadow_frame_phi, vogel_disk_all)
from .uniforms import FrameUniforms

# World height of the planar receiver: the ground quad lies at y = 0 with an
# identity model matrix (shadow_lightspace.py:58-60).
GROUND_Y = 0.0

# Per-frame rotations of the light maps' taps, chosen by global texel
# parity (shadow_lightspace.py:213).
PHASES = 4


def halo_texels(max_softness: float) -> int:
    """Tap reach in texels (shadow_lightspace.py:66-67)."""
    return math.ceil(4.0 * max_softness) + 2


def ground_constants(uni: FrameUniforms):
    """(n_dot_l, world-space normal offset, depth bias) of a y-up planar
    receiver (shadow_lightspace.py:70-77), 0-d device tensors."""
    ndl = torch.clamp(uni.light_dir[1], min=0.0)
    normal_off = 0.02 * (1.0 - ndl)
    bias = 0.0008 + 0.0025 * (1.0 - ndl)
    return ndl, normal_off, bias


def biased_ground_planes(light_view_proj: torch.Tensor,
                         plane_y: torch.Tensor) -> torch.Tensor:
    """(L, 3) uv-space NDC-depth planes of the world plane y = plane_y, a
    0-d device tensor (shadow_lightspace.py:80-97): the fit of
    shadow_classify.light_ground_planes, solved without a host read."""
    xz = const([[0.0, 0.0], [7.0, 1.0], [3.0, -6.0]], torch.float32,
               light_view_proj.device)
    ys = plane_y.to(torch.float32).reshape(1).expand(3)
    return plane_through(light_view_proj,
                         torch.stack([xz[:, 0], ys, xz[:, 1]], dim=-1))


def occluder_uv_bbox(world_v: torch.Tensor, vert_object: torch.Tensor,
                     light_view_proj: torch.Tensor):
    """Per-cascade uv bbox of every vertex off the ground (object slot 0):
    the scene's shadow footprint (shadow_lightspace.py:100-115). Returns
    (lo, hi), each (L, 2) in uv units."""
    mask = (vert_object != 0)[None, :, None]                 # (1, V, 1)
    ones = torch.ones((world_v.shape[0], 1), dtype=torch.float32,
                      device=world_v.device)
    hom = torch.cat([world_v, ones], dim=-1)
    clip = torch.einsum("cij,vj->cvi", light_view_proj, hom)  # (L, V, 4)
    uv = clip[..., :2] / clip[..., 3:4] * 0.5 + 0.5          # (L, V, 2)
    lo = torch.where(mask, uv, 1e30).amin(dim=1)
    hi = torch.where(mask, uv, -1e30).amax(dim=1)
    return lo, hi


def window_pad(max_softness: float, coarse: int) -> int:
    """Texels of margin around the footprint that can still hold unclosed
    ground pixels (shadow_lightspace.py:118-122)."""
    return halo_texels(max_softness) + 2 * coarse + 16


def window_size_for_extent(extent: int, pad: int,
                           fetch_count: int = 1 << 30) -> int:
    """Static window size for a measured footprint extent, host math
    (shadow_lightspace.py:125-134): footprint + 2 pad rounded up to 128,
    between 256 and 768; 0 when too few pixels fetch."""
    if fetch_count < 1024 or extent <= 0:
        return 0
    want = -(-(extent + 2 * pad) // 128) * 128
    return int(min(max(want, 256), 768))


def window_origin(lo_uv: torch.Tensor, hi_uv: torch.Tensor, size: int,
                  wc: int, pad: int):
    """Clamped, 8-aligned window origin (oy, ox) as 0-d int32 tensors,
    centred on the footprint bbox + pad texels (shadow_lightspace.py:
    156-167)."""
    lo_t = to_i32(torch.floor(lo_uv * size)) - pad
    hi_t = to_i32(torch.ceil(hi_uv * size)) + pad
    center = torch.div(lo_t + hi_t, 2, rounding_mode="floor")
    org = torch.clamp(center - wc // 2, 0, max(size - wc, 0))
    org = torch.div(org, 8, rounding_mode="floor") * 8
    return org[1], org[0]     # (oy, ox) from (u, v) = (x, y)


def plan_windows(uni: FrameUniforms, world_v: torch.Tensor,
                 vert_object: torch.Tensor, sizes, map_size: int,
                 max_softness: float, coarse: int):
    """Per-cascade window origins for the static `sizes` (None where a
    size is 0), on the shadow-footprint bbox (shadow_lightspace.py:
    137-153). Returns (origins, (lo, hi))."""
    lo, hi = occluder_uv_bbox(world_v, vert_object, uni.light_view_proj)
    pad = window_pad(max_softness, coarse)
    origins = tuple(window_origin(lo[c], hi[c], map_size, sizes[c], pad)
                    if sizes[c] else None for c in range(len(sizes)))
    return origins, (lo, hi)


def _shifted(halo: int, wc: int, wp: int, sy: torch.Tensor,
             sx: torch.Tensor) -> torch.Tensor:
    """Flat indices sy.shape + (wc, wc) into a haloed (wp, wp) window of
    the (wc, wc) views at integer shifts (sy, sx), each start clamped as
    lax.dynamic_slice clamps it (shadow_lightspace.py:170-173)."""
    ar = torch.arange(wc, dtype=torch.int32, device=sy.device)
    y = torch.clamp(halo + sy, 0, wp - wc)[..., None, None] + ar[:, None]
    x = torch.clamp(halo + sx, 0, wp - wc)[..., None, None] + ar[None, :]
    return y * wp + x


class LightMapTaps(NamedTuple):
    """The per-frame tap geometry of a light map, device tensors for P
    phases (light_map_taps). `light_size`, `span` and `shifts` are PCSS's,
    `radius` and `small` fixed-radius PCF's (None otherwise). `radii` (R,)
    are the PCF radii (PCSS's `rungs` log-spaced r_j, or the one radius);
    `corners` (y0, x0) int32 and `fracs` (fy, fx) f32, each (R, 16, P),
    the 16 PCF taps' integer texel offsets and bilinear weights at each
    radius; `shifts` (sy, sx) int32 (16, P), the nearest blocker taps."""
    phi: torch.Tensor
    radii: torch.Tensor
    corners: tuple
    fracs: tuple
    light_size: Optional[torch.Tensor] = None
    span: Optional[torch.Tensor] = None
    shifts: Optional[tuple] = None
    radius: Optional[torch.Tensor] = None
    small: Optional[torch.Tensor] = None


def light_map_taps(uni: FrameUniforms, use_pcss: bool, rungs: int,
                   phases: int, dev) -> LightMapTaps:
    """One Vogel rotation per phase (IGN at the phase's screen point) and
    the taps it puts at each radius (shadow_lightspace.py:262-322): the
    values both the plain light map and the kernel's parameters read. No
    value is read on the host."""
    softness = uni.shadow_bias[0]
    offs = const([[float(p % 2), float(p // 2)] for p in range(phases)],
                 torch.float32, dev)
    phi = shadow_frame_phi(offs, uni.debug_flags[3], uni.debug_flags[2])
    extra = {}
    if not use_pcss:
        # Fixed-radius PCF: the 3x3 kernel (radius <= 1.25) or 16 Vogel
        # taps at the radius.
        radius = torch.clamp(softness, min=0.5)
        radii = radius.reshape(1)
        extra = dict(radius=radius, small=radius <= 1.25)
    else:
        light_size = softness * 2.0
        # Blocker search: nearest taps are integer shifts
        # (floor(t + 0.5 + d) = t + floor(0.5 + d)).
        dx, dy = vogel_disk_all(BLOCKER_SAMPLES, phi)
        shifts = (to_i32(torch.floor(0.5 + dy * light_size)),
                  to_i32(torch.floor(0.5 + dx * light_size)))
        # PCF at `rungs` log-spaced radii.
        span = torch.log(torch.clamp(light_size * 4.0, min=1.0 + 1e-6))
        radii = torch.stack([0.5 * torch.exp(span * (j / (rungs - 1)))
                             for j in range(rungs)])
        extra = dict(light_size=light_size, span=span, shifts=shifts)
    dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
    ox = dx[None] * radii[:, None, None]
    oy = dy[None] * radii[:, None, None]
    x0 = torch.floor(ox)
    y0 = torch.floor(oy)
    return LightMapTaps(phi=phi, radii=radii,
                        corners=(to_i32(y0), to_i32(x0)),
                        fracs=(oy - y0, ox - x0), **extra)


def _compare_taps(qflat, halo: int, wc: int, wp: int, receiver,
                  taps: LightMapTaps, r: int, count: int):
    """Mean and mean square of `count` compare-bilinear taps at the
    spatially constant offsets of radius r of `taps`, (count, P) for P
    phases (shadow_lightspace.py:176-207). qflat: the quad-packed haloed
    window as (wp * wp, 4) rows; every tap of every phase is one row
    gather. Returns two (P, wc, wc) tensors."""
    y0, x0 = taps.corners[0][r], taps.corners[1][r]
    fy = taps.fracs[0][r][..., None, None]
    fx = taps.fracs[1][r][..., None, None]
    t = (receiver[..., None] <= take_rows(
        qflat, _shifted(halo, wc, wp, y0, x0))).to(
            torch.float32)                        # (count, P, wc, wc, 4)
    top = t[..., 0] * (1 - fx) + t[..., 1] * fx
    bot = t[..., 2] * (1 - fx) + t[..., 3] * fx
    tap = top * (1 - fy) + bot * fy
    return _sum_taps(tap) / count, _sum_taps(tap * tap) / count


def kernel_params(origin, plane: torch.Tensor, bias: torch.Tensor,
                  taps: LightMapTaps, use_pcss: bool, dev
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The light-map kernel's (ints, floats) parameters as device tensors,
    in the layout of ops/lightmap_cuda.py::param_sizes. `finite` flags
    each radius and phase whose 16 bilinear weights are finite (the
    kernel skips a zero-weight rung only then)."""
    i32, f32 = torch.int32, torch.float32
    org = torch.stack([o.to(device=dev, dtype=i32).reshape(())
                       if isinstance(o, torch.Tensor)
                       else const(int(o), i32, dev) for o in origin])
    ints = [org] + [t.reshape(-1) for t in
                    ((taps.shifts if use_pcss else ()) + taps.corners)]
    a, b = ((taps.light_size, taps.span) if use_pcss
            else (taps.radius, taps.small.to(f32)))
    fy, fx = taps.fracs
    finite = (torch.isfinite(fy) & torch.isfinite(fx)).all(dim=1)
    floats = [to_f32(plane, dev).reshape(3), to_f32(bias, dev).reshape(1),
              a.reshape(1), b.reshape(1), fy.reshape(-1), fx.reshape(-1),
              finite.to(f32).reshape(-1)]
    return (torch.cat(ints).to(i32).contiguous(),
            torch.cat(floats).to(f32).contiguous())


def build_light_shadow_map(raw_map: torch.Tensor, origin,
                           plane: torch.Tensor, uni: FrameUniforms,
                           use_pcss: bool, wc: int, max_softness: float,
                           bias: torch.Tensor, rungs: int = 6,
                           phases: int = PHASES,
                           taps: Optional[LightMapTaps] = None
                           ) -> torch.Tensor:
    """Dense PCSS/PCF over the (wc, wc) light-space window at `origin`
    (oy, ox) of one cascade's raw (S, S) depth, for a planar receiver at
    `plane` (the biased ground's NDC-depth plane)
    (shadow_lightspace.py:210-331). Returns (wc * wc, 4) contiguous rows
    [v, m2, kernel radius, 1], the lit and no-blocker overrides applied;
    the sparse filter's fetch groups read them with one row gather.
    `taps` is light_map_taps(uni, use_pcss, rungs, phases), built here
    when not given.

    A CPU map goes to the plain twin, build_light_shadow_map_plain; any
    other to the light-map kernel K5 (ops/lightmap_cuda.py::light_map,
    csrc/lightmap.cu), one thread per texel evaluating its own phase,
    which launches or raises."""
    dev = raw_map.device
    if taps is None:
        taps = light_map_taps(uni, use_pcss, rungs, phases, dev)
    if dev.type == "cpu":
        return build_light_shadow_map_plain(raw_map, origin, plane, uni,
                                            use_pcss, wc, max_softness, bias,
                                            rungs, phases, taps)
    ints, floats = kernel_params(origin, plane, bias, taps, use_pcss, dev)
    return lightmap_cuda.light_map(raw_map, ints, floats, wc,
                                   halo_texels(max_softness), phases, rungs,
                                   use_pcss)


def build_light_shadow_map_plain(raw_map: torch.Tensor, origin,
                                 plane: torch.Tensor, uni: FrameUniforms,
                                 use_pcss: bool, wc: int,
                                 max_softness: float, bias: torch.Tensor,
                                 rungs: int = 6, phases: int = PHASES,
                                 taps: Optional[LightMapTaps] = None
                                 ) -> torch.Tensor:
    """build_light_shadow_map as torch ops: every phase over the whole
    window, then each texel keeps its own phase's result, as in JAX (the
    CPU path and the kernel's test oracle)."""
    s = raw_map.shape[0]
    dev = raw_map.device
    halo = halo_texels(max_softness)
    wp = wc + 2 * halo
    padded = torch.nn.functional.pad(raw_map, (halo, halo, halo, halo),
                                     value=1.0)
    window = dynamic_slice(padded, (origin[0], origin[1]), (wp, wp))
    wflat = window.reshape(wp * wp)
    # One quad-packed copy serves every compare tap: one row per tap.
    qflat = quad_pack(window).reshape(wp * wp, 4)

    # The receiver: the biased plane's depth at the texel centres.
    ar = torch.arange(wc, dtype=torch.float32, device=dev)
    tx = (origin[1].to(torch.float32) + ar + 0.5) / s
    ty = (origin[0].to(torch.float32) + ar + 0.5) / s
    receiver = (plane[0] * tx[None, :] + plane[1] * ty[:, None]
                + plane[2]) - bias

    if taps is None:
        taps = light_map_taps(uni, use_pcss, rungs, phases, dev)
    if not use_pcss:
        # JAX's lax.cond becomes both kernels, selected on the card.
        s3 = []
        for oy in (-1, 0, 1):
            for ox in (-1, 0, 1):
                d = window[halo + oy:halo + oy + wc, halo + ox:halo + ox + wc]
                s3.append((receiver <= d).to(torch.float32))
        s3 = torch.stack(s3)
        m1, m2 = _compare_taps(qflat, halo, wc, wp, receiver, taps, 0,
                               PCF_SAMPLES)
        small = taps.small
        m1 = torch.where(small, _sum_taps(s3) / 9.0, m1)
        m2 = torch.where(small, _sum_taps(s3 * s3) / 9.0, m2)
        kern = torch.where(small, 1.0, taps.radius).expand_as(m1)
        one = torch.ones_like(m1)
        out = torch.stack([m1, m2, kern, one], dim=-1)
    else:
        light_size = taps.light_size
        d = take_rows(wflat, _shifted(halo, wc, wp, *taps.shifts))
        hit = d < receiver                                    # (16, P, ...)
        b_sum = _sum_taps(torch.where(hit, d, 0.0))
        b_cnt = _sum_taps(hit.to(torch.float32))
        has_blockers = b_cnt > 0.0
        blocker_depth = b_sum / torch.clamp(b_cnt, min=1.0)

        ratio = (receiver - blocker_depth) / torch.clamp(blocker_depth,
                                                         min=1e-8)
        penumbra = torch.minimum(torch.clamp(ratio * light_size, min=0.5),
                                 light_size * 2.0)

        # PCF at `rungs` log-spaced radii, log-linearly interpolated.
        m1 = torch.zeros_like(penumbra)
        m2 = torch.zeros_like(penumbra)
        pos = (rungs - 1) * torch.log(penumbra / 0.5) / taps.span
        for j in range(rungs):
            w_j = torch.clamp(1.0 - torch.abs(pos - j), 0.0, 1.0)
            m1_j, m2_j = _compare_taps(qflat, halo, wc, wp, receiver, taps, j,
                                       PCF_SAMPLES)
            m1 = m1 + w_j * m1_j
            m2 = m2 + w_j * m2_j
        one = torch.ones_like(m1)
        out = torch.stack([torch.where(has_blockers, m1, one),
                           torch.where(has_blockers, m2, one),
                           torch.where(has_blockers, penumbra, 0.0), one],
                          dim=-1)                     # (P, wc, wc, 4)

    # Each texel keeps the phase of its global texel parity (a 2x2
    # checkerboard), stable as the window moves.
    ai = torch.arange(wc, device=dev)
    grid = (((origin[0] + ai) % 2)[:, None] * 2
            + ((origin[1] + ai) % 2)[None, :]) % phases
    pick = grid.to(torch.int64)[None, :, :, None].expand(1, wc, wc, 4)
    return torch.gather(out, 0, pick)[0].reshape(wc * wc, 4)


def ground_eligible(world: torch.Tensor, normal: torch.Tensor,
                    receiver: torch.Tensor) -> torch.Tensor:
    """Pixels whose shadow evaluation is exactly the planar-receiver math:
    on the plane, unit up normal, receiver <= 1 (shadow_lightspace.py:
    334-342)."""
    return ((torch.abs(world[..., 1] - GROUND_Y) < 1e-4)
            & (normal[..., 1] > 0.9999)
            & (receiver <= 1.0))
