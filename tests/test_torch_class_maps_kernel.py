"""Port parity: the shadow class maps and the algorithm of their kernel.

passes/shadow_classify.py::_class_rows sends CUDA maps to the kernel K10
(funky_tpu_torch/ops/class_maps_cuda.py::class_rows) and CPU maps to the
plain twin _class_rows_plain. Here a numpy model of K10's algorithm (per
tile of cells a haloed window with BORDER_DEPTH outside the map, the 2x2
pools made in the window, the ladder as one chain of 1-D passes
alternating between columns and rows, each finishing one rung with a
3-tap step and starting the next, in runs of RUN outputs over the part of
the window the later passes need, the rise's max likewise, cell maxima
down texel columns then across, the residuals against the plane) is held
against the twin's composed shifts (`_dilate_exact`,
`_cell_max`, `_ladder_pooled`, `_ladder_full`); the twin against the JAX
package's build_class_maps; `check_args` against the calls the kernel
takes and refuses; and every class-map build of a default and a tuned
shipped frame is passed through `check_args`, so that no frame call
raises on the card. The kernel itself runs on the card only
(tests/test_torch_class_maps_cuda.py, chip_smoke.py).

Tolerance: none. Min and max are exact, and with the map taken plus 0.0
(no -0 in any reduction) every tie is between equal bits, so the model
and the twin agree bit for bit whatever their order; the twin equals JAX
run op by op (jax.disable_jit) bit for bit on maps without -0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funky_tpu_torch.frame as tf
from funky_tpu.passes import shadow_classify as jcls
from funky_tpu_torch.ops import class_maps_cuda as k10
from funky_tpu_torch.passes import shadow_classify as tcls

from .test_torch_gather import _shipped_config
from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, t2n)
from .torch_scenes import random_planes, relief_maps, special_maps

F32 = np.float32
BORDER = F32(tcls.BORDER_DEPTH)


# ---------------------------------------------------------------------------
# The numpy model of csrc/class_maps.cu
# ---------------------------------------------------------------------------

def model_pass(src, dst, a_rng, b_rng, steps, fn, after=(), core=None,
               vert=True):
    """One pass of the kernel: src read as [a][b], the window along a
    composed of the 3-tap `steps` (out[a] = fn(in[a - s], in[a], in[a +
    s])); that window at the core is returned as [y][x] (`core`: its
    window index range on both axes, the pass walking y where `vert`);
    then the steps `after`, whose window is stored transposed, dst[b][a],
    for a in a_rng and b in b_rng. Runs of RUN outputs: the last one reads
    up to RUN - 1 rows past a_rng, which the buffers' padding rows (NaN
    here, unwritten shared memory there) hold; only a in a_rng is
    stored."""
    (a_lo, a_hi), (b_lo, b_hi) = a_rng, b_rng
    reach = sum(steps) + sum(after)
    a_end = a_lo + -(-(a_hi - a_lo) // k10.RUN) * k10.RUN
    assert a_lo - reach >= 0 and a_end + reach <= src.shape[0]
    assert 0 <= b_lo and b_hi <= src.shape[1]
    v = src[a_lo - reach:a_end + reach, b_lo:b_hi]
    for st in steps:
        v = fn(fn(v[:-2 * st], v[2 * st:]), v[st:-st])
    emitted = None
    if core is not None:     # v's rows are a from a_lo - sum(after)
        c0, c1 = core
        lo = a_lo - sum(after)
        emitted = v[c0 - lo:c1 - lo, c0 - b_lo:c1 - b_lo]
        emitted = emitted if vert else emitted.T
    for st in after:
        v = fn(fn(v[:-2 * st], v[2 * st:]), v[st:-st])
    if dst is not None:
        dst[b_lo:b_hi, a_lo:a_hi] = v[:a_hi - a_lo].T
    return emitted


def rise_steps(reach):
    """The rise's steps on each axis: its base reach min(reach, 3) as
    steps (1), (1, 1) or (1, 2), then one step to reach, at most 10."""
    base = {1: (1,), 2: (1, 1), 3: (1, 2)}[min(reach, 3)]
    return base + ((min(reach, 10) - 3,) if reach > 3 else ())


def model_stage(lo_src, hi_src, cell, reaches, rise, tc, halo,
                rise_first=False):
    """One stage of one tile. lo_src and hi_src are the window as the
    kernel reads it: (side + RUN, side), window index i = texel t0 - halo
    + i. The min ladder takes NK + 1 passes, down the columns and along
    the rows in turn: pass j applies the last step of rung j - 2 (the base
    reach 3 as steps 1, 2), emits that rung's square at the core, then
    applies the first step of rung j - 1, each pass over the window
    widened by what the passes after it need. The rise: one pass each
    way to reach min(rise, 10), then (past 10) passes of single steps of
    min(2r + 1, rise - r); before the ladder where `rise_first` (the
    pooled stage), after it elsewhere. The two pass buffers start as NaN
    and are shared by the ladder and the rise, so a read of a value no
    pass of the chain wrote shows. Returns ([centre hi - min per rung] +
    [max - centre lo], centre lo), each (P, P)."""
    p = tc * cell
    side = p + 2 * halo
    bufs = [np.full((side + k10.RUN, side), np.nan, F32) for _ in range(2)]
    x_buf, y_buf = bufs
    core = (slice(halo, halo + p), slice(halo, halo + p))
    span = (halo, halo + p)

    def rng(e):
        return (halo - e, halo + p + e)

    def ladder():
        top, nk, drops = reaches[-1], len(reaches), []
        for j in range(nk + 1):
            r_after = reaches[j] if j < nk else top
            r_other = reaches[j - 1] if j >= 1 else 0
            steps = ((1, 2) if j <= 1
                     else (reaches[j - 1] - reaches[j - 2],))
            after = (() if j == 0 or j >= nk
                     else (reaches[j] - reaches[j - 1],))
            src = lo_src if j == 0 else (x_buf if j % 2 else y_buf)
            dst = None if j >= nk else (y_buf if j % 2 else x_buf)
            sq = model_pass(src, dst, rng(top - r_after), rng(top - r_other),
                            steps, np.minimum, after,
                            core=span if j >= 1 else None,
                            vert=j % 2 == 0)
            if j >= 1:
                drops.append(hi_src[core] - sq)
        return drops

    def rise_window():
        steps = rise_steps(rise)
        r0 = min(rise, 10)
        model_pass(hi_src, x_buf, rng(rise - r0), rng(rise), steps,
                   np.maximum)
        if rise <= 10:
            sq = model_pass(x_buf, None, rng(0), rng(0), steps, np.maximum,
                            core=span, vert=False)
            return [sq - lo_src[core]]
        model_pass(x_buf, y_buf, rng(rise - r0), rng(rise - r0), steps,
                   np.maximum)
        r = r0
        while r < rise:
            st = min(2 * r + 1, rise - r)
            r += st
            model_pass(y_buf, x_buf, rng(rise - r), rng(rise - r + st),
                       (st,), np.maximum)
            model_pass(x_buf, y_buf, rng(rise - r), rng(rise - r), (st,),
                       np.maximum)
        return [y_buf[core] - lo_src[core]]

    if not rise:
        return ladder(), lo_src[core].copy()
    if rise_first:      # the pooled stage: the rise, then the ladder
        rises = rise_window()
        return ladder() + rises, lo_src[core].copy()
    return ladder() + rise_window(), lo_src[core].copy()


def _cell_max(v, tc, cell):
    """Down each texel column of a cell row, then across the cell's
    columns."""
    return v.reshape(tc, cell, tc, cell).max(axis=1).max(axis=2)


def _pools(x):
    """2x2 (min, max) pools, rows first."""
    hi = np.maximum(x[0::2], x[1::2])
    lo = np.minimum(x[0::2], x[1::2])
    return (np.minimum(lo[:, 0::2], lo[:, 1::2]),
            np.maximum(hi[:, 0::2], hi[:, 1::2]))


def fine_window(x, tc, cell, halo, ty, tx):
    """The fine map as the kernel's passes read it for tile (ty, tx):
    (side + RUN, side) from texel (ty * P - halo, tx * P - halo),
    BORDER_DEPTH outside the map (the rows past the window are the map's
    own, as the kernel's reads there are)."""
    p = tc * cell
    side = p + 2 * halo
    pad = halo + p + k10.RUN
    big = np.pad(x, pad, constant_values=BORDER)
    y0, x0 = pad + ty * p - halo, pad + tx * p - halo
    return big[y0:y0 + side + k10.RUN, x0:x0 + side]


def pooled_window(plo, phi, tc, cell, halo, ty, tx):
    """The pooled stage's staged lo and hi windows: side x side from the
    pooled maps (BORDER_DEPTH outside), then RUN rows of NaN (the kernel
    never stages them)."""
    p = tc * cell
    side = p + 2 * halo
    out = []
    for m in (plo, phi):
        w = np.full((side + k10.RUN, side), np.nan, F32)
        w[:side] = fine_window(m, tc, cell, halo, ty, tx)[:side]
        out.append(w)
    return out


def tile_columns(x, plo, phi, coarse, rise, pooled, tc, ty, tx):
    """The tile's six ladder columns (each (tc, tc)) and its fine centre
    (P, P), by the model."""
    if pooled:
        xw = fine_window(x, tc, coarse, k10.LADDER[0], ty, tx)
        (v0,), centre = model_stage(xw, xw, coarse, [3], 0, tc,
                                    k10.LADDER[0])
        halo = max(k10.HALF_REACHES[-1], rise)
        lo, hi = pooled_window(plo, phi, tc, coarse // 2, halo, ty, tx)
        half, _ = model_stage(lo, hi, coarse // 2, list(k10.HALF_REACHES),
                              rise, tc, halo, rise_first=True)
        cols = [_cell_max(v0, tc, coarse)] + [
            _cell_max(v, tc, coarse // 2) for v in half]
    else:
        halo = max(k10.LADDER[-1], rise)
        xw = fine_window(x, tc, coarse, halo, ty, tx)
        full, centre = model_stage(xw, xw, coarse, list(k10.LADDER), rise,
                                   tc, halo)
        cols = [_cell_max(v, tc, coarse) for v in full]
    return cols, centre


def model_rows(maps, coarse, max_softness, planes, eps, tc=None,
               divide=False):
    """K10's cell rows (L * Sc * Sc, 8) by the model. `tc` defaults to the
    wrapper's tile_cells; `divide` takes the texel centres' u as (j + 0.5)
    / S, as torch on the CPU does, where the kernel multiplies by the
    reciprocal, as torch on the card does (the same for S a power of
    two)."""
    x_all = maps.astype(F32) + F32(0.0)
    l, s, _ = x_all.shape
    sc = s // coarse
    uw = tcls.rise_window(max_softness)
    pooled = k10.pooled_branch(s, coarse)
    rise = k10.rise_reach(s, coarse, uw)
    tc = tc or k10.tile_cells(s, coarse, pooled, rise)
    tiles = -(-sc // tc)
    out = np.full((l, sc, sc, 8), np.nan, F32)
    inv_s = F32(1.0) / F32(s)
    with np.errstate(invalid="ignore"):
        for li in range(l):
            x = x_all[li]
            a, b, c = (F32(v) for v in planes[li])
            e = F32(eps[li])
            plo, phi = _pools(x) if pooled else (None, None)
            for ty in range(tiles):
                for tx in range(tiles):
                    cols, centre = tile_columns(x, plo, phi, coarse, rise,
                                                pooled, tc, ty, tx)
                    p = tc * coarse
                    jj = (np.arange(p) + tx * p).astype(F32) + F32(0.5)
                    ii = (np.arange(p) + ty * p).astype(F32) + F32(0.5)
                    u = jj / F32(s) if divide else jj * inv_s
                    v = ii / F32(s) if divide else ii * inv_s
                    plane = (a * u[None, :] + b * v[:, None]) + c
                    res = centre - plane
                    min_r = -_cell_max(-(res - e), tc, coarse)
                    max_r = _cell_max(res + e, tc, coarse)
                    block = np.stack(cols + [min_r, max_r], axis=-1)
                    ny = min(tc, sc - ty * tc)
                    nx = min(tc, sc - tx * tc)
                    out[li, ty * tc:ty * tc + ny, tx * tc:tx * tc + nx] = \
                        block[:ny, :nx]
    return out.reshape(l * sc * sc, 8)


# ---------------------------------------------------------------------------
# Maps
# ---------------------------------------------------------------------------

def eps_of(planes):
    """build_class_maps' eps, computed in torch as it is."""
    return t2n(torch.from_numpy(planes).abs().sum(dim=-1) * 4e-7 + 2e-7)


def bits(a):
    return np.asarray(a, F32).view(np.int32)


# ---------------------------------------------------------------------------
# Model == twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [64, 256, 512])
@pytest.mark.parametrize("coarse", [8, 16])
@pytest.mark.parametrize("tiles", ["wrapper", "ragged"])
def test_model_rows_match_twin(s, coarse, tiles):
    """The model's rows == _class_rows_plain's bit for bit on relief maps
    (BORDER_DEPTH blocks, +/-0, equal runs, a step) with sloped planes,
    at the wrapper's tile and at tiles of 3 cells, whose last tile runs
    past the map."""
    maps = relief_maps(s + coarse, 2, s)
    planes = random_planes(s, 2)
    eps = eps_of(planes)
    want = tcls._class_rows_plain(torch.from_numpy(maps), coarse, 4.0,
                                  torch.from_numpy(planes),
                                  torch.from_numpy(eps))
    tc = None if tiles == "wrapper" else 3
    got = model_rows(maps, coarse, 4.0, planes, eps, tc=tc)
    np.testing.assert_array_equal(bits(got), bits(t2n(want)))


def model_ladders(x, coarse, uw, branch, tc):
    """The six ladder columns (Sc, Sc) of one map by the model's tiles."""
    s = x.shape[0]
    sc = s // coarse
    pooled = branch == "pooled"
    rise = (uw + 1) // 2 if pooled else uw
    plo, phi = _pools(x) if pooled else (None, None)
    got = [np.zeros((sc, sc), F32) for _ in range(6)]
    with np.errstate(invalid="ignore"):
        for ty in range(-(-sc // tc)):
            for tx in range(-(-sc // tc)):
                cols, _ = tile_columns(x, plo, phi, coarse, rise, pooled, tc,
                                       ty, tx)
                ny, nx = min(tc, sc - ty * tc), min(tc, sc - tx * tc)
                for k, block in enumerate(cols):
                    got[k][ty * tc:ty * tc + ny, tx * tc:tx * tc + nx] = \
                        block[:ny, :nx]
    return got


def twin_ladders(x, coarse, uw, branch):
    ladder = {"pooled": tcls._ladder_pooled, "full": tcls._ladder_full}
    return [t2n(c)[0] for c in ladder[branch](torch.from_numpy(x[None]),
                                              coarse, uw)]


@pytest.mark.parametrize("s", [64, 256, 512])
@pytest.mark.parametrize("coarse", [8, 16])
@pytest.mark.parametrize("branch", ["pooled", "full"])
@pytest.mark.parametrize("max_softness", [4.0, 2.0])
def test_model_ladders_match_dilations(s, coarse, branch, max_softness):
    """Each ladder column of the model's composed, haloed, tiled passes ==
    the twin's composed shifts (_dilate_exact) and cell maxima (_cell_max)
    bit for bit, in both branches at coarse 8 and 16 (the full-resolution
    branch, which build_class_maps takes for an odd coarse or S, called
    directly), reaches past the map's edge at every border tile, rise
    windows 18 and 10."""
    x = relief_maps(s * 3 + coarse, 1, s)[0] + F32(0.0)
    uw = tcls.rise_window(max_softness)
    pooled = branch == "pooled"
    tc = k10.tile_cells(s, coarse, pooled, (uw + 1) // 2 if pooled else uw)
    want = twin_ladders(x, coarse, uw, branch)
    got = model_ladders(x, coarse, uw, branch, tc)
    for k in range(6):
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]),
                                      err_msg=f"ladder column {k}")


# Tile cores that end exactly at a reach: the pooled maps at coarse 2 (one
# pooled texel a cell) with a core of each half reach, the full-resolution
# ladder at coarse 1 with a core of each rung, each with rise windows of
# the ladder's top, one step past the base and the base itself.
EDGE_CASES = ([("pooled", 2, r, uw) for r in (3, 6, 10, 17)
               for uw in (34, 8)]
              + [("full", 1, r, uw) for r in (3, 6, 12, 20, 34)
                 for uw in (34, 5)])


@pytest.mark.parametrize("branch,coarse,tc,uw", EDGE_CASES,
                         ids=[f"{b}_c{c}_tc{t}_uw{u}"
                              for b, c, t, u in EDGE_CASES])
def test_model_tile_edge_at_each_reach(branch, coarse, tc, uw):
    """Tiles whose core is as wide as a rung's reach (so a window of that
    rung ends exactly at the next tile's edge) and a last tile that runs
    past the map: the model's ladder columns == the twin's bit for bit."""
    s = 72 if branch == "full" else 68
    x = relief_maps(tc + uw, 1, s)[0] + F32(0.0)
    want = twin_ladders(x, coarse, uw, branch)
    got = model_ladders(x, coarse, uw, branch, tc)
    for k in range(6):
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]),
                                      err_msg=f"ladder column {k}")


@pytest.mark.parametrize("s,coarse,tc", [(16, 8, 4), (32, 16, 3),
                                         (24, 3, 16)],
                         ids=["pooled_16", "pooled_32", "full_24"])
def test_model_map_shorter_than_a_tile(s, coarse, tc):
    """A tile of more cells than the map has (the whole map inside one
    tile's core, the rest of it BORDER_DEPTH): the model == the twin."""
    maps = relief_maps(s + tc, 2, s)
    planes = random_planes(s, 2)
    eps = eps_of(planes)
    want = tcls._class_rows_plain(torch.from_numpy(maps), coarse, 4.0,
                                  torch.from_numpy(planes),
                                  torch.from_numpy(eps))
    got = model_rows(maps, coarse, 4.0, planes, eps, tc=tc, divide=True)
    np.testing.assert_array_equal(bits(got), bits(t2n(want)))


@pytest.mark.parametrize("s,coarse,tc", [(128, 16, None), (128, 8, 3),
                                         (99, 3, None)],
                         ids=["pooled_c16", "pooled_c8_ragged", "full_c3"])
def test_model_nan_inf_and_border_runs(s, coarse, tc):
    """Maps holding NaN, +/-inf (single texels and runs) and long
    BORDER_DEPTH runs: the model == the twin, NaN where the twin has NaN
    and the other values bit for bit."""
    maps = special_maps(s + coarse, 2, s)
    planes = random_planes(s, 2)
    eps = eps_of(planes)
    with np.errstate(invalid="ignore"):
        want = t2n(tcls._class_rows_plain(
            torch.from_numpy(maps), coarse, 4.0, torch.from_numpy(planes),
            torch.from_numpy(eps)))
    got = model_rows(maps, coarse, 4.0, planes, eps, tc=tc, divide=True)
    assert np.isnan(want).any() and np.isinf(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(bits(got[ok]), bits(want[ok]))


@pytest.mark.parametrize("s,coarse", [(250, 5), (129, 3), (16, 8)],
                         ids=["250_5", "129_3", "16_8"])
def test_model_rows_odd_and_tiny(s, coarse):
    """The unpooled branch build_class_maps takes for an odd coarse or S,
    and a map of 2 x 2 cells whose every window runs past the edge: the
    model == the twin bit for bit (texel centres divided, as torch on the
    CPU divides)."""
    maps = relief_maps(s, 2, s)
    planes = random_planes(s + 1, 2)
    eps = eps_of(planes)
    want = tcls._class_rows_plain(torch.from_numpy(maps), coarse, 4.0,
                                  torch.from_numpy(planes),
                                  torch.from_numpy(eps))
    got = model_rows(maps, coarse, 4.0, planes, eps, divide=True)
    np.testing.assert_array_equal(bits(got), bits(t2n(want)))


def test_signed_zero_does_not_change_rows():
    """-0 and +0 in the map give the same rows bit for bit: the twin adds
    0.0 first, so no tie between the two zeros reaches a reduction."""
    maps = relief_maps(7, 2, 128)
    flipped = np.where(maps == 0.0, -maps, maps).astype(F32)
    assert (np.signbit(flipped) != np.signbit(maps)).any()
    planes = random_planes(7, 2)
    rows = [t2n(tcls.build_class_maps(torch.from_numpy(m), 16, 4.0,
                                      torch.from_numpy(planes)).cell_rows)
            for m in (maps, flipped)]
    np.testing.assert_array_equal(bits(rows[0]), bits(rows[1]))


# ---------------------------------------------------------------------------
# Twin == JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coarse", [16, 8, 5])
def test_twin_matches_jax(coarse):
    """build_class_maps on CPU maps (the twin, no launch) == JAX's run op
    by op, bit for bit: relief maps without -0 at the shipped frame's
    coarse 16, the default 8, and the full-resolution branch at 5."""
    s = 250 if coarse == 5 else 256
    maps = np.abs(relief_maps(coarse, 2, s)).astype(F32)
    planes = random_planes(coarse, 2)
    before = k10.LAUNCHES
    got = tcls.build_class_maps(torch.from_numpy(maps), coarse, 4.0,
                                torch.from_numpy(planes))
    assert k10.LAUNCHES == before
    with jax.disable_jit():
        want = jcls.build_class_maps(jnp.asarray(maps), coarse, 4.0,
                                     jnp.asarray(planes))
    np.testing.assert_array_equal(bits(t2n(got.cell_rows)),
                                  bits(np.asarray(want.cell_rows)))


# ---------------------------------------------------------------------------
# check_args
# ---------------------------------------------------------------------------

def _refused():
    """(argument named in the error, maps, coarse, rise_window, planes,
    eps) of calls the kernel does not take. The meta device stands in for
    a second device."""
    maps = torch.zeros((2, 64, 64))
    planes = torch.zeros((2, 3))
    eps = torch.zeros((2,))
    return {
        "f64 maps": ("maps", maps.double(), 8, 18, planes, eps),
        "maps not a tensor": ("maps", [[0.0]], 8, 18, planes, eps),
        "2-D maps": ("maps", maps[0], 8, 18, planes, eps),
        "non-square maps": ("maps", maps[:, :32], 8, 18, planes, eps),
        "non-contiguous maps": ("maps", maps.transpose(1, 2), 8, 18, planes,
                                eps),
        "coarse not dividing": ("coarse", maps, 7, 18, planes, eps),
        "coarse not an int": ("coarse", maps, 8.0, 18, planes, eps),
        "rise past the ladder": ("rise_window", maps, 8, 35, planes, eps),
        "no rise": ("rise_window", maps, 8, 0, planes, eps),
        "planes of another cascade count": ("planes", maps, 8, 18,
                                            planes[:1], eps),
        "strided planes": ("planes", maps, 8, 18,
                           torch.zeros((2, 6))[:, ::2], eps),
        "f64 planes": ("planes", maps, 8, 18, planes.double(), eps),
        "eps of another shape": ("eps", maps, 8, 18, planes, eps[:, None]),
        "eps on another device": ("eps", maps, 8, 18, planes,
                                  eps.to("meta")),
        "a block past shared memory": ("coarse", torch.zeros((1, 256, 256)),
                                       256, 18, planes[:1], eps[:1]),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_check_args_refuses(case):
    """Each call the kernel cannot take raises, naming the argument."""
    name, *args = _refused()[case]
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        k10.check_args(*args)


@pytest.mark.parametrize("s,coarse", [(2048, 16), (2048, 8), (1024, 16),
                                      (250, 5), (16, 8), (64, 1)])
def test_check_args_takes_and_tiles(s, coarse):
    """The frames' shapes pass, and the chosen tile fits three blocks per
    SM (the shipped frame's 4 x 2048^2 at coarse 16: 4 x 4 cells)."""
    maps = torch.zeros((4, s, s))
    k10.check_args(maps, coarse, 18, torch.zeros((4, 3)), torch.zeros((4,)))
    pooled = k10.pooled_branch(s, coarse)
    rise = k10.rise_reach(s, coarse, 18)
    tc = k10.tile_cells(s, coarse, pooled, rise)
    assert 1 <= tc <= s // coarse
    assert k10.smem_bytes(coarse, pooled, rise, tc) <= k10.TARGET_SMEM
    if (s, coarse) == (2048, 16):
        assert tc == 4


def test_wrapper_refuses_cpu_tensors():
    """class_rows launches the kernel or raises: a CPU map is refused by
    name (the pass above takes the twin for it)."""
    with pytest.raises(ValueError, match="^maps:"):
        k10.class_rows(torch.zeros((1, 64, 64)), 8, 18, torch.zeros((1, 3)),
                       torch.zeros((1,)))


@pytest.mark.parametrize("path", ["default", "shipped"])
def test_frame_class_maps_pass_check_args(path, monkeypatch):
    """Every class-map build of two chained frames (parked, orbit pose 1)
    on the multimesh scene passes check_args: GltfConfig() at 256x144 with
    its 2048^2 maps, and the tuned shipped configuration at 480x272 with
    1024^2 maps. One build per frame."""
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    cfg = {"default": lambda: tf.GltfConfig(width=256, height=144),
           "shipped": lambda: _shipped_config(scene, params)}[path]()
    calls = []
    plain = tcls._class_rows_plain

    def record(maps, coarse, max_softness, planes, eps):
        k10.check_args(maps, coarse, tcls.rise_window(max_softness), planes,
                       eps)
        calls.append(tuple(maps.shape))
        return plain(maps, coarse, max_softness, planes, eps)

    monkeypatch.setattr(tcls, "_class_rows_plain", record)
    state = tf.init_frame_state(cfg, "cpu")
    for pose in (params, tf.orbit_params(params, 1)):
        _, state = tf.render_gltf_frame(scene, pose, state, cfg)
    s = cfg.shadow_map_size
    assert calls == [(4, s, s)] * 2
