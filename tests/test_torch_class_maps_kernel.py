"""Port parity: the shadow class maps and the algorithm of their kernel.

passes/shadow_classify.py::_class_rows sends CUDA maps to the kernel K10
(funky_tpu_torch/ops/class_maps_cuda.py::class_rows) and CPU maps to the
plain twin _class_rows_plain. Here a numpy model of K10's algorithm (per
tile of cells a haloed window with BORDER_DEPTH outside the map, the 2x2
pools made in the window, every reach's min and the rise's max as row then
column passes, cell maxima down texel columns then across, the residuals
against the plane) is held against the twin's composed shifts (`_dilate_exact`,
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
from .torch_scenes import random_planes, relief_maps

F32 = np.float32
BORDER = F32(tcls.BORDER_DEPTH)


# ---------------------------------------------------------------------------
# The numpy model of csrc/class_maps.cu
# ---------------------------------------------------------------------------

def _window(padded, pad, y0, x0, side):
    return padded[pad + y0:pad + y0 + side, pad + x0:pad + x0 + side]


def model_stage(lo_map, hi_map, cell, reaches, rise, tc, ty, tx):
    """One stage of one tile (tile row ty, column tx of tc x tc cells):
    the haloed windows of the stage's lo and hi maps (BORDER_DEPTH outside),
    every reach's min along rows in one walk outward, then along columns,
    the rise's max the same way. Returns ([centre hi - min per reach] +
    [max - centre lo], centre lo), each (P, P)."""
    p = tc * cell
    halo = max(max(reaches), rise)
    side = p + 2 * halo
    pad = halo + p
    y0, x0 = ty * p - halo, tx * p - halo
    lo = _window(np.pad(lo_map, pad, constant_values=BORDER), pad, y0, x0,
                 side)
    hi = _window(np.pad(hi_map, pad, constant_values=BORDER), pad, y0, x0,
                 side)
    rowmin, m = {}, lo[:, halo:halo + p]
    for d in range(1, max(reaches) + 1):
        m = np.minimum(np.minimum(m, lo[:, halo - d:halo - d + p]),
                       lo[:, halo + d:halo + d + p])
        if d in reaches:
            rowmin[d] = m
    vals = []
    centre_hi = hi[halo:halo + p, halo:halo + p]
    centre_lo = lo[halo:halo + p, halo:halo + p]
    for r in reaches:
        rows = rowmin[r]
        m = rows[halo:halo + p]
        for d in range(1, r + 1):
            m = np.minimum(np.minimum(m, rows[halo - d:halo - d + p]),
                           rows[halo + d:halo + d + p])
        vals.append(centre_hi - m)
    if rise:
        rows = hi[:, halo:halo + p]
        for d in range(1, rise + 1):
            rows = np.maximum(np.maximum(rows, hi[:, halo - d:halo - d + p]),
                              hi[:, halo + d:halo + d + p])
        m = rows[halo:halo + p]
        for d in range(1, rise + 1):
            m = np.maximum(np.maximum(m, rows[halo - d:halo - d + p]),
                           rows[halo + d:halo + d + p])
        vals.append(m - centre_lo)
    return vals, centre_lo


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
    for li in range(l):
        x = x_all[li]
        a, b, c = (F32(v) for v in planes[li])
        e = F32(eps[li])
        if pooled:
            plo, phi = _pools(x)
        for ty in range(tiles):
            for tx in range(tiles):
                cols = [None] * 6
                if pooled:
                    (v0,), centre = model_stage(x, x, coarse, [3], 0, tc, ty,
                                                tx)
                    cols[0] = _cell_max(v0, tc, coarse)
                    half, _ = model_stage(plo, phi, coarse // 2,
                                          list(k10.HALF_REACHES), rise, tc,
                                          ty, tx)
                    for k, v in enumerate(half):
                        cols[1 + k] = _cell_max(v, tc, coarse // 2)
                else:
                    full, centre = model_stage(x, x, coarse,
                                               list(k10.LADDER), rise, tc,
                                               ty, tx)
                    for k, v in enumerate(full):
                        cols[k] = _cell_max(v, tc, coarse)
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


@pytest.mark.parametrize("s", [64, 256, 512])
@pytest.mark.parametrize("coarse", [8, 16])
@pytest.mark.parametrize("branch", ["pooled", "full"])
@pytest.mark.parametrize("max_softness", [4.0, 2.0])
def test_model_ladders_match_dilations(s, coarse, branch, max_softness):
    """Each ladder column of the model's separable, haloed, tiled stages ==
    the twin's composed shifts (_dilate_exact) and cell maxima (_cell_max)
    bit for bit, in both branches at coarse 8 and 16 (the full-resolution
    branch, which build_class_maps takes for an odd coarse or S, called
    directly), reaches past the map's edge at every border tile, rise
    windows 18 and 10."""
    maps = relief_maps(s * 3 + coarse, 1, s)
    x = maps + F32(0.0)
    uw = tcls.rise_window(max_softness)
    ladder = {"pooled": tcls._ladder_pooled, "full": tcls._ladder_full}
    want = [t2n(c)[0] for c in ladder[branch](torch.from_numpy(x), coarse,
                                              uw)]
    sc = s // coarse
    tc = k10.tile_cells(s, coarse, branch == "pooled",
                        (uw + 1) // 2 if branch == "pooled" else uw)
    got = [np.zeros((sc, sc), F32) for _ in range(6)]
    for ty in range(-(-sc // tc)):
        for tx in range(-(-sc // tc)):
            if branch == "pooled":
                plo, phi = _pools(x[0])
                vals = model_stage(x[0], x[0], coarse, [3], 0, tc, ty, tx)[0]
                vals += model_stage(plo, phi, coarse // 2,
                                    list(k10.HALF_REACHES), (uw + 1) // 2,
                                    tc, ty, tx)[0]
                cells = [coarse] + [coarse // 2] * 5
            else:
                vals = model_stage(x[0], x[0], coarse, list(k10.LADDER), uw,
                                   tc, ty, tx)[0]
                cells = [coarse] * 6
            for k, (v, cell) in enumerate(zip(vals, cells)):
                block = _cell_max(v, tc, cell)
                ny, nx = min(tc, sc - ty * tc), min(tc, sc - tx * tc)
                got[k][ty * tc:ty * tc + ny, tx * tc:tx * tc + nx] = \
                    block[:ny, :nx]
    for k in range(6):
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]),
                                      err_msg=f"ladder column {k}")


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
                                       128, 18, planes[:1], eps[:1]),
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
    """The frames' shapes pass, and the chosen tile fits two blocks per SM
    (the shipped frame's 4 x 2048^2 at coarse 16: 4 x 4 cells)."""
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
