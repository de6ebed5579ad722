"""The debug panel's overlay kernel K4 on the CPU: its triangle table
(funky_tpu_torch/passes/overlay.py::overlay_table), its plain twin
(rasterize_overlay_plain) against the JAX package's rasterize_overlay, and
the kernel's wrapper (ops/overlay_cuda.py): the arguments it refuses, and
the plain twin the pass takes for CPU tensors, and a model of the
kernel's per-tile triangle lists drawn by the plain twin. The kernel
itself runs only on the card (tests/test_torch_overlay_cuda.py).

Tolerances and why:
- the table: equal, bit for bit, to the per-triangle f32 scalars of the
  host loop it replaced (numpy f32 vector operations round as its scalar
  operations did), dropping exactly the padded, degenerate and empty-crop
  triangles;
- the plain twin against JAX on the debug window's triangles and on tiny
  triangles: within 3e-5, the panel tolerance of tests/test_torch_app.py
  (XLA fuses and contracts the scan's arithmetic; an atlas coordinate near
  160 carries one f32 ulp, 1.5e-5, into a bilinear weight);
- the tile-list model against the plain twin's whole panel: equal, bit for
  bit (the same operations on the same pixels in the same order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.passes import overlay as joverlay

from funky_tpu_torch.app import ui as tui
from funky_tpu_torch.ops import overlay_cuda
from funky_tpu_torch.passes import overlay as toverlay

from .torch_scenes import OVERLAY_CASES, overlay_case

OVERLAY_TOL = 3e-5
SMALL_PANEL = (96, 128)


def loop_scalars(verts, tris, n_tris, panel_hw):
    """The host loop's per-triangle values (the port's rasterize_overlay
    before the table), kept here as the table's oracle: [(triangle index,
    f32 scalars, crop box)] of the triangles it drew."""
    ph, pw = panel_hw
    verts = np.asarray(verts, np.float32)
    out = []
    for i in range(int(n_tris)):
        t0, t1, t2 = (int(k) for k in tris[i])
        if t0 < 0:
            continue
        (x0, y0), (x1, y1), (x2, y2) = verts[t0], verts[t1], verts[t2]
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        if not abs(area) > 1e-12:
            continue
        xs, ys = (x0, x1, x2), (y0, y1, y2)
        if abs(area) >= 16.0:
            cx0 = max(int(math.floor(min(xs) - 0.5)) - 1, 0)
            cx1 = min(int(math.ceil(max(xs) - 0.5)) + 2, pw)
            cy0 = max(int(math.floor(min(ys) - 0.5)) - 1, 0)
            cy1 = min(int(math.ceil(max(ys) - 0.5)) + 2, ph)
        else:
            cx0, cx1, cy0, cy1 = 0, pw, 0, ph
        if cx0 >= cx1 or cy0 >= cy1:
            continue
        scalars = np.array([np.float32(1.0) / area, x2 - x1, y2 - y1,
                            x0 - x2, y0 - y2, x1, y1, x2, y2], np.float32)
        out.append((i, scalars, (cx0, cx1, cy0, cy1)))
    return out


def arrays_of(case, panel_hw):
    if case == "panel":
        return tui.build_panel(tui.UiData(
            fps=59.9, gltf_scale=0.0123, debug_cascades=True,
            use_pcss=False, gpu_info="cpu", last_error="boom")).arrays()
    return overlay_case(case, panel_hw)


@pytest.mark.parametrize("case", ["panel"] + sorted(OVERLAY_CASES))
def test_table_equals_loop_scalars(case):
    """Row k of the table holds the k-th drawn triangle's scalars, crop
    box, uvs and colours, bit for bit; nothing else is drawn."""
    panel_hw = (tui.PANEL_H, tui.PANEL_W)
    verts, uvs, cols, tris, n = arrays_of(case, panel_hw)
    table = toverlay.overlay_table(verts, uvs, cols, tris, int(n), panel_hw)
    want = loop_scalars(verts, tris, n, panel_hw)
    assert table.dtype == np.float32
    assert table.shape == (len(want), toverlay.TABLE_COLS)
    for row, (i, scalars, crop) in zip(table, want):
        np.testing.assert_array_equal(
            row[:toverlay.TABLE_SCALARS].view(np.int32),
            scalars.view(np.int32))
        assert tuple(row[toverlay.TABLE_CROP:toverlay.TABLE_CROP + 4]) == crop
        for k in range(3):
            v = tris[i, k]
            np.testing.assert_array_equal(
                row[toverlay.TABLE_UV + 2 * k:toverlay.TABLE_UV + 2 * k + 2],
                uvs[v])
            np.testing.assert_array_equal(
                row[toverlay.TABLE_COLOR + 4 * k:
                    toverlay.TABLE_COLOR + 4 * k + 4], cols[v])
        assert row[-1] == 0.0
    real = int(n) - int((tris[:int(n), 0] < 0).sum())
    if case == "slivers":
        assert len(want) < real                # degenerate ones dropped
    if case == "tiny":                         # the full-panel crop
        assert any(c == (0, panel_hw[1], 0, panel_hw[0])
                   for _, _, c in want)


def test_table_drops_empty_crops_and_padding():
    """A triangle wholly outside the panel (an empty crop box), a padded row
    and one past n_tris are not drawn; the rest keep their order."""
    verts = np.array([[10, 10], [60, 12], [20, 50],           # drawn
                      [-90, -90], [-40, -88], [-80, -30],     # outside
                      [30, 30], [30, 30], [30, 30],           # zero area
                      [5, 5], [70, 5], [5, 60]], np.float32)  # drawn
    uvs = np.zeros((12, 2), np.float32)
    cols = np.ones((12, 4), np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5], [-1, -1, -1], [6, 7, 8],
                     [9, 10, 11], [0, 1, 2]], np.int32)
    table = toverlay.overlay_table(verts, uvs, cols, tris, 5, (64, 96))
    assert table.shape == (2, toverlay.TABLE_COLS)
    np.testing.assert_array_equal(table[:, toverlay.TABLE_SCALARS - 4],
                                  [60.0, 70.0])          # x1 of rows 0, 4


@pytest.mark.parametrize("case", ["panel", "tiny"])
def test_plain_twin_matches_jax(case):
    """rasterize_overlay_plain on the table against JAX's scan over the
    same slots, on a small panel: the debug window's own triangles (the
    panel cut to its top-left 96 x 128 pixels, so triangles cross its
    edges or lie past them), and tiny triangles. Slivers are held to the
    twin on the card only: their huge 1/area amplifies XLA's contraction
    past the panel tolerance."""
    if case == "panel":
        verts, uvs, cols, tris, n = arrays_of("panel", SMALL_PANEL)
        tris = tris[:int(n) + 8]
    else:
        verts, uvs, cols, tris, n = overlay_case(case, SMALL_PANEL,
                                                 n_tris=48)
    atlas = tui.build_font_atlas()[0]
    want = np.asarray(joverlay.rasterize_overlay(
        jnp.asarray(verts), jnp.asarray(uvs), jnp.asarray(cols),
        jnp.asarray(tris), jnp.int32(n), jnp.asarray(atlas), SMALL_PANEL))
    table = toverlay.overlay_table(verts, uvs, cols, tris, int(n),
                                   SMALL_PANEL)
    got = toverlay.rasterize_overlay_plain(
        torch.from_numpy(table), torch.from_numpy(atlas), SMALL_PANEL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OVERLAY_TOL)
    assert want[..., 3].max() > 0


def test_cpu_tensors_take_the_plain_twin():
    """rasterize_overlay on CPU tensors: the plain twin's panel, no kernel
    launch. The kernel's wrapper itself refuses a CPU atlas by name."""
    verts, uvs, cols, tris, n = overlay_case("edges", SMALL_PANEL, n_tris=24)
    atlas = torch.from_numpy(tui.build_font_atlas()[0])
    table = torch.from_numpy(toverlay.overlay_table(
        verts, uvs, cols, tris, n, SMALL_PANEL))
    before = overlay_cuda.LAUNCHES
    got = toverlay.rasterize_overlay(verts, uvs, cols, tris, n, atlas,
                                     SMALL_PANEL)
    with pytest.raises(ValueError, match="^atlas:"):
        overlay_cuda.overlay_raster(table, atlas, SMALL_PANEL)
    assert overlay_cuda.LAUNCHES == before
    want = toverlay.rasterize_overlay_plain(table, atlas, SMALL_PANEL)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _refused():
    """(argument named in the error, table, atlas) of calls the kernel
    does not take. The meta device stands in for the card."""
    table = torch.zeros((4, toverlay.TABLE_COLS))
    atlas = torch.zeros((16, 32, 4))
    return {
        "f64 table": ("table", table.double(), atlas),
        "non-contiguous table": ("table", torch.zeros(
            (toverlay.TABLE_COLS, 4)).T, atlas),
        "narrow table": ("table", torch.zeros((4, 16)), atlas),
        "f16 atlas": ("atlas", table, atlas.half()),
        "non-contiguous atlas": ("atlas", table, atlas[:, ::2]),
        "rgb atlas": ("atlas", table, torch.zeros((16, 32, 3))),
        "table on another device": ("table", table.to("meta"), atlas),
        "atlas on another device": ("table", table, atlas.to("meta")),
        "table not a tensor": ("table", table.numpy(), atlas),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_check_args_refuses(case):
    """Each call the kernel cannot take raises, naming the argument."""
    name, table, atlas = _refused()[case]
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        overlay_cuda.check_args(table, atlas, SMALL_PANEL)


def test_check_args_takes_the_panel():
    """The debug panel's own table and atlas pass, and a non-CPU pair is
    checked, never drawn by the twin."""
    verts, uvs, cols, tris, n = tui.build_panel(tui.UiData()).arrays()
    panel_hw = (tui.PANEL_H, tui.PANEL_W)
    table = torch.from_numpy(toverlay.overlay_table(
        verts, uvs, cols, tris, int(n), panel_hw))
    atlas = torch.from_numpy(tui.build_font_atlas()[0])
    overlay_cuda.check_args(table, atlas, panel_hw)
    with pytest.raises(ValueError, match="^atlas:"):
        overlay_cuda.overlay_raster(table.to("meta"), atlas.to("meta"),
                                    panel_hw)


TOGGLED = tui.UiData(fps=59.9, frame_time_ms=16.7, gltf_scale=0.0123,
                     debug_cascades=True, use_pcss=False,
                     use_shadow_taa=False, entity_count=3,
                     component_count=7, gpu_info="NVIDIA H100",
                     last_error="frame 3: boom")
RAGGED_PANEL = (100, 130)     # sides the tile does not divide


def tile_lists(table, panel_hw, tile):
    """The kernel's tile lists: for each tile of `tile` (width, height)
    over the panel, row-major, its rectangle [x0, x1) x [y0, y1) within
    the panel and the indices, in table order, of the rows whose crop box
    meets it (csrc/overlay.cu's test on columns 9-12)."""
    ph, pw = panel_hw
    tw, th = tile
    cx0, cx1, cy0, cy1 = table[:, toverlay.TABLE_CROP:
                               toverlay.TABLE_CROP + 4].T
    out = []
    for y0 in range(0, ph, th):
        for x0 in range(0, pw, tw):
            x1, y1 = min(x0 + tw, pw), min(y0 + th, ph)
            meets = (cx0 < x1) & (cx1 > x0) & (cy0 < y1) & (cy1 > y0)
            out.append(((x0, x1, y0, y1), np.flatnonzero(meets)))
    return out


def tile_model(table, atlas, panel_hw, tile):
    """Each tile drawn by the plain twin from its list alone, the list's
    crop boxes clipped to the tile (no pixel of the tile leaves its box,
    and the twin then works on the tile's pixels only), and the tiles
    pasted together. Returns (panel, list lengths)."""
    out = torch.zeros(panel_hw + (4,))
    lengths = []
    for (x0, x1, y0, y1), rows in tile_lists(table, panel_hw, tile):
        sub = table[rows].copy()
        c = toverlay.TABLE_CROP
        sub[:, c] = np.maximum(sub[:, c], x0)
        sub[:, c + 1] = np.minimum(sub[:, c + 1], x1)
        sub[:, c + 2] = np.maximum(sub[:, c + 2], y0)
        sub[:, c + 3] = np.minimum(sub[:, c + 3], y1)
        drawn = toverlay.rasterize_overlay_plain(torch.from_numpy(sub),
                                                 atlas, panel_hw)
        out[y0:y1, x0:x1] = drawn[y0:y1, x0:x1]
        lengths.append(len(rows))
    return out, lengths


def model_case(case):
    """(arrays, panel_hw) of a tile-model case."""
    if case == "debug window":
        return tui.build_panel(tui.UiData()).arrays(), (tui.PANEL_H,
                                                        tui.PANEL_W)
    if case == "toggled":
        return tui.build_panel(TOGGLED).arrays(), (tui.PANEL_H, tui.PANEL_W)
    if case == "ragged":
        return overlay_case("edges", RAGGED_PANEL, n_tris=48), RAGGED_PANEL
    return overlay_case(case, SMALL_PANEL, n_tris=48), SMALL_PANEL


@pytest.mark.parametrize("case", ["debug window", "toggled", "ragged"]
                         + sorted(OVERLAY_CASES))
def test_tile_lists_skip_no_value(case):
    """The kernel's per-tile lists (overlay_cuda.TILE) change no value:
    drawing each tile from only the rows whose crop box meets it, in
    table order, and pasting the tiles equals the plain twin's panel bit
    for bit. On the debug panels the lists are a small part of the
    table, so the test is not vacuous."""
    (verts, uvs, cols, tris, n), panel_hw = model_case(case)
    table = toverlay.overlay_table(verts, uvs, cols, tris, int(n), panel_hw)
    atlas = torch.from_numpy(tui.build_font_atlas()[0])
    tw, th, _ = overlay_cuda.TILE
    got, lengths = tile_model(table, atlas, panel_hw, (tw, th))
    want = toverlay.rasterize_overlay_plain(torch.from_numpy(table), atlas,
                                            panel_hw)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    assert want[..., 3].max() > 0
    if case in ("debug window", "toggled"):
        assert max(lengths) < len(table) / 4


def test_tile_lists_hold_every_box_pixel():
    """At every tile shape of the kernel's sweep, on the ragged panel, a
    tile lists a row exactly when some pixel of the tile lies in the
    row's crop box: the interval test on columns 9-12 against the
    pixels themselves."""
    verts, uvs, cols, tris, n = overlay_case("edges", RAGGED_PANEL,
                                             n_tris=48)
    table = toverlay.overlay_table(verts, uvs, cols, tris, int(n),
                                   RAGGED_PANEL)
    c = toverlay.TABLE_CROP
    boxes = np.zeros((len(table),) + RAGGED_PANEL, bool)
    for k, row in enumerate(table):
        cx0, cx1, cy0, cy1 = (int(v) for v in row[c:c + 4])
        boxes[k, cy0:cy1, cx0:cx1] = True
    for tile in ((16, 16), (32, 8), (16, 8), (8, 8), (64, 4)):
        for (x0, x1, y0, y1), rows in tile_lists(table, RAGGED_PANEL, tile):
            want = np.flatnonzero(boxes[:, y0:y1, x0:x1].any(axis=(1, 2)))
            np.testing.assert_array_equal(rows, want)
