"""Shadow-map LIT/UMBRA/PENUMBRA classification for the sparse shadow
filter (port of funky_tpu/passes/shadow_classify.py).

Per coarse cell of each cascade the class maps hold the map's local
relief (the drop to the windowed minimum at a ladder of window sizes, the
rise to the windowed maximum) and the residual range of the stored depth
against an analytic per-cascade ground plane. `classify` turns these
into two conservative certificates per pixel: LIT (every tap of the exact
filter passes, m1 = m2 = 1) and UMBRA (every tap is shadowed, m1 = m2 =
0). The soundness argument is in the JAX module's docstring; the port
keeps its arithmetic and association op for op.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..math3d import f32
from ..ops.sampling import take_rows, to_i32

BORDER_DEPTH = 1.0
DROP_LADDER = (3, 6, 12, 20, 34)
FOOT_MARGIN = 2.0


class ShadowClassMaps(NamedTuple):
    """shadow_classify.py:83-93."""
    cell_rows: torch.Tensor  # (L * Sc * Sc, K+3) [drop_ladder..., rise_U,
    #                          min_resid, max_resid] per cell
    planes: torch.Tensor     # (L, 3) uv-space ndc-depth plane per cascade
    size: int                # S
    coarse: int              # fine texels per cell
    max_softness: float


def _dilate_exact(x: torch.Tensor, reach: int, reduce_fn, pad_value: float,
                  collect_at: Sequence[int] = ()):
    """Exact-reach square dilation of (L, H, W) by composable shifts
    (shadow_classify.py:96-130). Returns {reach: tensor} for every
    requested reach."""
    want = sorted(set(collect_at) | {reach})
    out = {}
    done = 0
    while True:
        if done in want:
            out[done] = x
        if done >= reach:
            break
        nxt = min(w for w in want if w > done)
        step = min(max(done, 1), nxt - done)
        for axis in (1, 2):
            n = x.shape[axis]
            s = min(step, n)
            pad_shape = list(x.shape)
            pad_shape[axis] = s
            pad = torch.full(pad_shape, pad_value, dtype=x.dtype,
                             device=x.device)
            fwd = torch.cat([x.narrow(axis, s, n - s), pad], dim=axis)
            bwd = torch.cat([pad, x.narrow(axis, 0, n - s)], dim=axis)
            x = reduce_fn(reduce_fn(x, fwd), bwd)
        done += step
    return out


def _cell_max(x: torch.Tensor, coarse: int) -> torch.Tensor:
    """Per-cell max over (coarse, coarse) tiles (shadow_classify.py:133-146)."""
    l, s, _ = x.shape
    sc = s // coarse
    rows = x.reshape(l, sc, coarse, s).amax(dim=2)
    return rows.reshape(l, sc, sc, coarse).amax(dim=-1)


def _pool2(x: torch.Tensor):
    """2x2 max/min pools (shadow_classify.py:149-157)."""
    hi = torch.maximum(x[:, 0::2, :], x[:, 1::2, :])
    hi = torch.maximum(hi[:, :, 0::2], hi[:, :, 1::2])
    lo = torch.minimum(x[:, 0::2, :], x[:, 1::2, :])
    lo = torch.minimum(lo[:, :, 0::2], lo[:, :, 1::2])
    return hi, lo


def blocker_window(max_softness: float) -> int:
    return math.ceil(2.0 * max_softness + FOOT_MARGIN)


def rise_window(max_softness: float) -> int:
    return math.ceil(4.0 * max_softness + FOOT_MARGIN)


def light_ground_planes(light_view_proj: torch.Tensor,
                        plane_y: float = 0.0) -> torch.Tensor:
    """(L, 3) per-cascade uv-space NDC-depth plane of the world plane
    y = plane_y (shadow_classify.py:171-188). `solve_ex` does not check
    for singular systems, so no host synchronisation; a degenerate light
    gives inf/nan coefficients, which only stop the closed forms from
    firing."""
    dev = light_view_proj.device
    return plane_through(light_view_proj, f32(
        [[0.0, plane_y, 0.0], [7.0, plane_y, 1.0], [3.0, plane_y, -6.0]],
        dev))


def plane_through(light_view_proj: torch.Tensor,
                  pts: torch.Tensor) -> torch.Tensor:
    """(L, 3) uv-space NDC-depth plane of each cascade through the three
    world points `pts` (3, 3)."""
    dev = light_view_proj.device
    hom = torch.cat([pts, torch.ones((3, 1), dtype=torch.float32,
                                     device=dev)], dim=-1)
    clip = torch.einsum("cij,nj->cni", light_view_proj, hom)   # (L, 3, 4)
    ndc = clip[..., :3] / clip[..., 3:4]
    uv = ndc[..., :2] * 0.5 + 0.5
    a_mat = torch.cat([uv, torch.ones(uv.shape[:-1] + (1,),
                                      dtype=torch.float32, device=dev)],
                      dim=-1)
    return torch.linalg.solve_ex(a_mat, ndc[..., 2:3])[0][..., 0]


def _plane_at_texels(planes: torch.Tensor, s: int) -> torch.Tensor:
    """Each cascade's plane at every texel centre: (L, S, S)
    (shadow_classify.py:191-196)."""
    u = (torch.arange(s, dtype=torch.float32, device=planes.device)
         + 0.5) / s
    return (planes[:, 0, None, None] * u[None, None, :]
            + planes[:, 1, None, None] * u[None, :, None]
            + planes[:, 2, None, None])


def _lw_rung(max_softness: float) -> int:
    """Index of the smallest ladder rung covering the blocker window."""
    lw = blocker_window(max_softness)
    for i, r in enumerate(DROP_LADDER):
        if r >= lw:
            return i
    return len(DROP_LADDER) - 1


def build_class_maps(shadow_maps: torch.Tensor, coarse: int = 8,
                     max_softness: float = 4.0,
                     planes: torch.Tensor | None = None) -> ShadowClassMaps:
    """Class maps from raw cascade depth (L, S, S)
    (shadow_classify.py:199-275). `planes` None = zero planes."""
    l, s, _ = shadow_maps.shape
    assert (s // coarse) * coarse == s
    uw = rise_window(max_softness)
    assert DROP_LADDER[-1] >= math.ceil(4.0 * max_softness + FOOT_MARGIN), \
        "drop ladder must cover the max PCSS penumbra"
    assert DROP_LADDER[_lw_rung(max_softness)] >= blocker_window(
        max_softness)

    # Smallest rung: exact full-resolution dilation.
    r0 = DROP_LADDER[0]
    mins0 = _dilate_exact(shadow_maps, r0, torch.minimum, BORDER_DEPTH)
    drops = {r0: _cell_max(shadow_maps - mins0[r0], coarse)}

    if coarse % 2 == 0 and s % 2 == 0:
        # Larger rungs and the rise window on 2x2-pooled hi/lo maps:
        # conservative (bounds only loosen), never unsound.
        d_hi, d_lo = _pool2(shadow_maps)
        ch = coarse // 2
        half_rungs = [(r, (r + 1) // 2) for r in DROP_LADDER[1:]]
        min2 = _dilate_exact(d_lo, half_rungs[-1][1], torch.minimum,
                             BORDER_DEPTH,
                             collect_at=[hr for _, hr in half_rungs])
        for r, hr in half_rungs:
            drops[r] = _cell_max(d_hi - min2[hr], ch)
        ru = (uw + 1) // 2
        max2 = _dilate_exact(d_hi, ru, torch.maximum, BORDER_DEPTH)
        rise = _cell_max(max2[ru] - d_lo, ch)
    else:
        mins = _dilate_exact(shadow_maps, DROP_LADDER[-1], torch.minimum,
                             BORDER_DEPTH, collect_at=DROP_LADDER)
        drops = {r: _cell_max(shadow_maps - mins[r], coarse)
                 for r in DROP_LADDER}
        maxs = _dilate_exact(shadow_maps, uw, torch.maximum, BORDER_DEPTH)
        rise = _cell_max(maxs[uw] - shadow_maps, coarse)

    if planes is None:
        planes = torch.zeros((l, 3), dtype=torch.float32,
                             device=shadow_maps.device)
    resid = shadow_maps - _plane_at_texels(planes, s)
    # f32 slack for the plane evaluation here and in classify()
    eps = (planes.abs().sum(dim=-1) * 4e-7 + 2e-7)[:, None, None]
    min_resid = -_cell_max(-(resid - eps), coarse)
    max_resid = _cell_max(resid + eps, coarse)

    cell = torch.stack([drops[r] for r in DROP_LADDER]
                       + [rise, min_resid, max_resid], dim=-1)
    sc = s // coarse
    return ShadowClassMaps(
        cell_rows=cell.reshape(l * sc * sc, len(DROP_LADDER) + 3),
        planes=planes, size=s, coarse=coarse, max_softness=max_softness)


def classify(cmaps: ShadowClassMaps, layer: torch.Tensor, uv: torch.Tensor,
             receiver: torch.Tensor, softness: torch.Tensor,
             use_pcss: bool):
    """Per-pixel (lit, umbra) bool masks for one cascade
    (shadow_classify.py:287-357). `receiver` is the biased compare value;
    one gathered cell row per element."""
    s = cmaps.size
    sc = s // cmaps.coarse
    px = to_i32(torch.floor(uv[..., 0] * s)).clamp(0, s - 1)
    py = to_i32(torch.floor(uv[..., 1] * s)).clamp(0, s - 1)

    # px, py >= 0 after the clamp, so floor and truncating division agree.
    cx = px // cmaps.coarse
    cy = py // cmaps.coarse
    cell = take_rows(cmaps.cell_rows, (layer * sc + cy) * sc + cx)
    n_ladder = len(DROP_LADDER)
    drop_lw = cell[..., _lw_rung(cmaps.max_softness)]
    rise_u = cell[..., n_ladder]
    min_resid = cell[..., n_ladder + 1]
    max_resid = cell[..., n_ladder + 2]

    n_planes = cmaps.planes.shape[0]
    oh_l = layer[..., None] == torch.arange(n_planes, dtype=torch.int32,
                                            device=layer.device)

    def psel(k):  # one-hot cascade plane select, as the JAX code sums it
        return torch.where(oh_l, cmaps.planes[:, k], 0.0).sum(dim=-1)

    plane_a = (psel(0) * (px.to(torch.float32) + 0.5) / s
               + psel(1) * (py.to(torch.float32) + 0.5) / s + psel(2))
    anchor_lb = plane_a + min_resid
    anchor_ub = plane_a + max_resid

    excess_ub = receiver - anchor_lb
    excess_lb = receiver - anchor_ub

    if use_pcss:
        light_size = softness * 2.0
        bd_low = anchor_lb - drop_lw
        ratio_bound = (receiver - bd_low) / torch.clamp(bd_low, min=1e-8)
        pen_bound = torch.minimum(
            torch.clamp(ratio_bound * light_size, min=0.5), light_size * 2.0)
        need_r = pen_bound + FOOT_MARGIN
    else:
        radius = torch.clamp(softness, min=0.5)
        need_r = (radius + FOOT_MARGIN).expand(excess_ub.shape)

    # smallest ladder drop window covering the taps
    drop_sel = cell[..., n_ladder - 1]
    for i in range(n_ladder - 2, -1, -1):
        drop_sel = torch.where(need_r <= DROP_LADDER[i], cell[..., i],
                               drop_sel)

    ok = softness <= cmaps.max_softness
    lit = (excess_ub <= -drop_sel) & (need_r <= DROP_LADDER[-1]) & ok
    umbra = (excess_lb > rise_u) & (receiver <= BORDER_DEPTH) & ok
    return lit, umbra
