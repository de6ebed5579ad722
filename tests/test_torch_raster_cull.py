"""The raster kernels' exact per-rectangle cull (csrc/raster.cu::culled),
held on the CPU through its plain twin ops/raster.py::subtile_keep.

A kernel block rasters one rectangle of one tile and drops every bin
entry that, at the pixel-centre corner where each plane is largest (z:
also smallest), fails an edge (< 0) or the depth range (z_max < 0,
z_min >= 1). The core check rasters, for every rectangle, the bins
filtered by subtile_keep with the plain raster `_rasterize_torch`, and
requires the result to equal the unculled raster bit for bit.

Tolerance: none. The corner values are the raster's own f32 arithmetic
((a*px + b*py) + c op by op), and culling must change no pixel.
"""

import numpy as np
import pytest
import torch

from funky_tpu_torch.ops import binning, raster, raster_cuda
from funky_tpu_torch.ops.raster import RasterConfig, subtile_corners, \
    subtile_keep

from .torch_scenes import (random_clip_scene, screen_clip,
                           small_triangles_scene, with_coplanar_duplicates)

W, H = 256, 128
TILES = [(8, 128), (32, 128), (128, 256)]
# The kernel's rectangle of each tile (raster_cuda.rect_shape), a wide
# one, a warp's 8x16 footprint, and one taller than every tile (cut to
# the tile's rows).
RECTS = ["kernel", (16, 64), (8, 16), (256, 16)]


def pipeline_bins(clip, tris, tile, capacity=None, y_offset=0,
                  slice_height=None):
    """(setup table, bin_data, bins, counts, y_offset, rows) as
    raster_corners makes them."""
    sh = H if slice_height is None else slice_height
    setup = binning.triangle_setup(torch.from_numpy(clip),
                                   torch.from_numpy(tris), W, H, len(tris))
    cap = len(tris) if capacity is None else capacity
    bins, counts = binning.bin_triangles(setup, W, sh, *tile, cap, y_offset)
    return binning.gather_bin_data(setup, bins), bins, counts, y_offset, sh


def everywhere_bins(table, tile, y_offset=0, slice_height=None):
    """Every row of `table` binned into every tile, in id order: the cull
    alone decides what each rectangle rasters."""
    sh = H if slice_height is None else slice_height
    tiles_y, tiles_x = -(-sh // tile[0]), -(-W // tile[1])
    n = table.shape[0]
    bins = torch.arange(n, dtype=torch.int32).expand(tiles_y * tiles_x,
                                                     n).contiguous()
    counts = torch.full((tiles_y * tiles_x,), n, dtype=torch.int32)
    setup = binning.TriangleSetup(data=table, valid=None)
    return binning.gather_bin_data(setup, bins), bins, counts, y_offset, sh


def rect_bounds(tile, rect, width, height, y_offset):
    """Per tile and rectangle position (ry, rx): the rectangle's inclusive
    pixel bounds (x0, x1, y0, y1 in global rows), clipped to its tile and
    the framebuffer, as the kernel computes them."""
    th, tw = tile
    rh, rw = raster_cuda.rect_shape(th, tw) if rect == "kernel" else \
        (min(rect[0], th), min(rect[1], tw))
    tiles_y, tiles_x = -(-height // th), -(-width // tw)
    t = torch.arange(tiles_y * tiles_x)
    ty, tx = t // tiles_x, t % tiles_x
    for ry in range(-(-th // rh)):
        for rx in range(-(-tw // rw)):
            x0 = tx * tw + rx * rw
            y0 = ty * th + ry * rh
            x1 = torch.minimum(x0 + rw, (tx + 1) * tw).clamp(max=width) - 1
            y1 = torch.minimum(y0 + rh, (ty + 1) * th).clamp(max=height) - 1
            yield (ry, rx, rh, rw), (x0, x1, y0 + y_offset, y1 + y_offset)


def cull_bins(bin_data, bins, counts, keep):
    """The bin lists with the entries `keep` drops removed, in bin order."""
    c = bins.shape[1]
    keep = keep & (torch.arange(c)[None, :] < counts[:, None])
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    new_counts = keep.sum(1).to(torch.int32)
    new_bins = torch.where(torch.arange(c)[None, :] < new_counts[:, None],
                           torch.gather(bins, 1, order), -1)
    new_data = torch.gather(bin_data, 1,
                            order[..., None].expand(-1, -1, 16))
    return new_data, new_bins, new_counts


def check_culled_equals_unculled(case, tile, rect):
    """Raster every rectangle from its culled bins; all pixels must equal
    the unculled raster bit for bit. Returns (kept, binned) entry x
    rectangle pairs."""
    bin_data, bins, counts, y0, sh = case
    cfg = RasterConfig(tile_h=tile[0], tile_w=tile[1], backend="torch")
    want_id, want_z = raster._rasterize_torch(bin_data, bins, counts, y0, W,
                                              sh, cfg)
    got_id, got_z = torch.full_like(want_id, -2), torch.full_like(want_z, 2.0)
    yy = torch.arange(sh)[:, None] % tile[0]
    xx = torch.arange(W)[None, :] % tile[1]
    kept = binned = 0
    for (ry, rx, rh, rw), (x0, x1, ya, yb) in rect_bounds(tile, rect, W, sh,
                                                          y0):
        live = (x0 <= x1) & (ya <= yb)
        keep = subtile_keep(bin_data, x0[:, None], x1[:, None], ya[:, None],
                            yb[:, None])
        cdata, cbins, ccounts = cull_bins(bin_data, bins, counts, keep)
        kept += int(ccounts[live].sum())
        binned += int(counts[live].sum())
        tri_id, depth = raster._rasterize_torch(cdata, cbins, ccounts, y0, W,
                                                sh, cfg)
        mine = (yy // rh == ry) & (xx // rw == rx)
        got_id = torch.where(mine, tri_id, got_id)
        got_z = torch.where(mine, depth, got_z)
    np.testing.assert_array_equal(got_id.numpy(), want_id.numpy())
    np.testing.assert_array_equal(got_z.numpy().view(np.int32),
                                  want_z.numpy().view(np.int32))
    return kept, binned


def hand_rows(planes):
    """(n, 16) setup rows from (b0, b1, b2, z) planes of (a, b, c) each;
    the AABB columns stay 0 (the cull does not read them)."""
    table = torch.zeros((len(planes), 16), dtype=torch.float32)
    table[:, :12] = torch.tensor([[v for p in row for v in p]
                                  for row in planes], dtype=torch.float32)
    return table


ONE = (0.0, 0.0, 1.0)   # a plane that is 1 everywhere


def edge_rows():
    """Edges exactly through pixel centres on rectangle boundaries (b == 0
    on a whole row or column of centres), both orientations."""
    planes = []
    for i, k in enumerate([7, 8, 15, 16, 31, 32, 63, 64, 127]):
        c = k + 0.5
        z = (0.0, 0.0, 0.2 + 0.005 * i)
        planes += [[(0.0, 1.0, -c), ONE, ONE, z],      # rows >= k
                   [(0.0, -1.0, c), ONE, ONE, z],     # rows <= k
                   [ONE, (1.0, 0.0, -c), ONE, z],     # columns >= k
                   [ONE, ONE, (-1.0, 0.0, c), z]]     # columns <= k
    return hand_rows(planes)


def z_cross_rows():
    """Full-screen planes whose z crosses 0 and 1 inside rectangles."""
    return hand_rows([
        [ONE, ONE, ONE, (1.0 / 64, 0.0, -0.3)],       # 0 at x 19.2, 1 at 83.2
        [ONE, ONE, ONE, (0.0, -1.0 / 48, 1.7)],       # 1 at y 33.6, 0 at 81.6
        [ONE, ONE, ONE, (0.01, 0.013, -0.9)],
        [ONE, ONE, ONE, (-0.0, 0.0, 0.5)],
    ])


def zero_rows():
    """The all-zero rows of invalid triangles: every plane is 0 at every
    pixel, so they cover everything at depth 0 and must be kept."""
    return torch.zeros((3, 16), dtype=torch.float32)


NONFINITE_KEPT = [True, False, True, True, False, False, True, True]


def nonfinite_rows():
    """Rows with inf and NaN coefficients; which of them the cull keeps
    is NONFINITE_KEPT (NaN corners are kept, a -inf maximum dropped)."""
    inf, nan = float("inf"), float("nan")
    return hand_rows([
        [(inf, 0.0, 0.0), ONE, ONE, (0.0, 0.0, 0.4)],
        [(-inf, 0.0, 0.0), ONE, ONE, (0.0, 0.0, 0.3)],
        [(nan, 1.0, 0.0), ONE, ONE, (0.0, 0.0, 0.2)],
        [ONE, ONE, ONE, (0.0, 0.0, nan)],
        [ONE, (0.0, 0.0, inf), ONE, (0.01, -0.0, -inf)],
        [ONE, ONE, (1.0, -inf, 5.0), (0.0, 0.0, 0.1)],
        [(1.0, inf, -5.0), ONE, ONE, (0.0, 0.0, 0.35)],
        [(inf, -inf, 0.0), ONE, ONE, (0.0, 0.0, 0.15)],
    ])


def sliver_clip():
    """Thin triangles (fractions of a pixel across) at several angles."""
    rng = np.random.default_rng(7)
    base = rng.uniform([0, 0], [W, H], (40, 1, 2))
    d = rng.uniform(-60, 60, (40, 1, 2))
    across = rng.uniform(0.01, 0.4, (40, 1, 1)) * \
        np.stack([-d[..., 1], d[..., 0]], -1) / np.linalg.norm(d, axis=-1,
                                                                keepdims=True)
    pts = np.concatenate([base, base + d, base + d + across], 1)
    return screen_clip(pts, rng.uniform(0.05, 0.95, (40, 3)), W, H)


def mixed(extra, tile, y_offset=0, slice_height=None):
    """Random triangles (which the cull drops from most rectangles)
    followed by hand-made rows, all binned everywhere."""
    clip, tris = random_clip_scene(5, 60, W, H)
    setup = binning.triangle_setup(torch.from_numpy(clip),
                                   torch.from_numpy(tris), W, H, len(tris))
    return everywhere_bins(torch.cat([setup.data, extra]), tile, y_offset,
                           slice_height)


SCENES = {
    "seed0": lambda t: pipeline_bins(*random_clip_scene(0, 200, W, H), t),
    "seed1": lambda t: pipeline_bins(*random_clip_scene(1, 200, W, H), t),
    "ties": lambda t: pipeline_bins(*with_coplanar_duplicates(
        random_clip_scene(2, 150, W, H)[0]), t),
    "tight": lambda t: pipeline_bins(*random_clip_scene(3, 200, W, H), t,
                                     capacity=4),
    "slab": lambda t: pipeline_bins(*random_clip_scene(4, 200, W, H), t,
                                    y_offset=64, slice_height=32),
    "long_bin": lambda t: pipeline_bins(*small_triangles_scene(
        6, 2000, (0, 0, 128, 12), 2.0, W, H), t),
    "edges": lambda t: mixed(edge_rows(), t),
    "edges_slab": lambda t: mixed(edge_rows(), t, y_offset=24,
                                  slice_height=40),
    "slivers": lambda t: pipeline_bins(*sliver_clip(), t),
    "z_cross": lambda t: mixed(z_cross_rows(), t),
    "zero_rows": lambda t: mixed(zero_rows(), t),
    "nonfinite": lambda t: mixed(nonfinite_rows(), t),
}


@pytest.mark.parametrize("rect", RECTS,
                         ids=["kernel", "16x64", "warp_8x16", "tall"])
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_culled_raster_equals_unculled(scene, tile, rect):
    """Culling every rectangle's bins changes no pixel, and it does drop
    entries (so the test cannot pass by keeping everything)."""
    kept, binned = check_culled_equals_unculled(SCENES[scene](tile), tile,
                                                rect)
    assert 0 < kept < binned


def brute_planes(rows, x0, x1, y0, y1):
    """Every plane of `rows` (n, 16) at every pixel centre of one
    rectangle: (n, 4, pixels), in the raster's association."""
    py, px = torch.meshgrid(torch.arange(y0, y1 + 1, dtype=torch.float32)
                            + 0.5,
                            torch.arange(x0, x1 + 1, dtype=torch.float32)
                            + 0.5, indexing="ij")
    d = rows[:, :12].reshape(-1, 4, 3, 1)
    return d[:, :, 0] * px.reshape(1, 1, -1) + d[:, :, 1] * py.reshape(
        1, 1, -1) + d[:, :, 2]


def random_rows(seed, n=4000):
    """Setup-like rows with coefficients over many magnitudes and signs,
    exact zeros and negative zeros among them."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-6, 2, (n, 12))
    rows = np.zeros((n, 16), np.float32)
    rows[:, :12] = rng.choice([-1.0, 1.0], (n, 12)) * mag
    rows[:, 2::3][:, :4] *= rng.uniform(0, 300, (n, 4))   # offsets
    rows[:, :12][rng.random((n, 12)) < 0.05] = 0.0
    rows[:, :12][rng.random((n, 12)) < 0.02] = -0.0
    return torch.from_numpy(rows)


@pytest.mark.parametrize("rect", [(0, 31, 0, 31), (5, 6, 100, 100),
                                  (200, 255, 64, 71), (17, 17, 3, 40),
                                  (96, 127, 1000, 1031)],
                         ids=["32x32", "2x1", "56x8", "column", "high_rows"])
@pytest.mark.parametrize("seed", [0, 1])
def test_corners_are_the_plane_extremes_bit_for_bit(seed, rect):
    """The corner value of each plane equals its maximum over all the
    rectangle's pixel centres bit for bit (z: also its minimum), the
    property that makes the cull exact with no margin."""
    rows = random_rows(seed)
    b_max, z_max, z_min = subtile_corners(rows, *rect)
    planes = brute_planes(rows, *rect)
    want_max, want_min = planes.amax(-1), planes[:, 3].amin(-1)
    got_max = torch.cat([b_max, z_max[:, None]], 1)
    # equal values (+0 and -0 compare equal: both pass `>= 0` alike)
    np.testing.assert_array_equal(got_max.numpy(), want_max.numpy())
    np.testing.assert_array_equal(z_min.numpy(), want_min.numpy())
    # and the corner is attained, not just bounded
    assert (planes == got_max[..., None]).any(-1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dropped_entries_cover_no_pixel(seed):
    """Brute force over every pixel centre: an entry subtile_keep drops
    passes the raster's test (all edges >= 0, 0 <= z < 1) at none of
    them; a kept NaN corner is decided per pixel."""
    rng = np.random.default_rng(seed)
    clip, tris = random_clip_scene(seed, 300, W, H)
    table = binning.triangle_setup(torch.from_numpy(clip),
                                   torch.from_numpy(tris), W, H).data
    table = torch.cat([table, nonfinite_rows(), zero_rows(), edge_rows()])
    dropped = 0
    for _ in range(6):
        x0, y0 = int(rng.integers(0, W - 32)), int(rng.integers(0, H - 32))
        x1, y1 = x0 + int(rng.integers(0, 32)), y0 + int(rng.integers(0, 32))
        keep = subtile_keep(table, x0, x1, y0, y1)
        p = brute_planes(table, x0, x1, y0, y1)
        cover = ((p[:, :3] >= 0).all(1) & (p[:, 3] >= 0)
                 & (p[:, 3] < 1)).any(-1)
        assert not (cover & ~keep).any()
        dropped += int((~keep).sum())
    assert dropped > 0
    # NaN and zero rows are kept; a -inf edge is dropped
    keep = subtile_keep(nonfinite_rows(), 0, 31, 0, 31)
    assert keep.tolist() == NONFINITE_KEPT
    assert subtile_keep(zero_rows(), 0, 31, 0, 31).all()


def test_kernel_rectangles_fill_the_block():
    """rect_shape gives at most 256 threads of 1x4 pixels and never
    straddles a tile, for the repository's tiles and smaller ones."""
    for tile in [(8, 128), (16, 128), (32, 128), (128, 256), (8, 16),
                 (3, 5), (1, 2048)]:
        rh, rw = raster_cuda.rect_shape(*tile)
        assert 0 < rh <= tile[0] and 0 < rw <= tile[1]
        assert rh * -(-rw // 4) <= raster_cuda.THREADS
    assert raster_cuda.rect_shape(32, 128) == (32, 32)
    assert raster_cuda.rect_shape(128, 256) == (32, 32)
    assert raster_cuda.rect_shape(16, 128) == (16, 64)
    assert raster_cuda.rect_shape(8, 128) == (8, 128)
