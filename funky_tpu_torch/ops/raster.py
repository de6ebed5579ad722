"""Tile raster: depth-tested visibility buffer (port of funky_tpu/ops/raster.py).

Output per pixel: the winning triangle id (-1 empty) and its NDC depth
(1.0 empty). Depth test LESS against 1.0; fragments with z outside [0, 1)
are clipped; ties keep the first-drawn (lowest) id.

Two interchangeable implementations, picked by `RasterConfig.backend`:
- "cuda": the hand-written Hopper kernels (ops/raster_cuda.py). As in the
  JAX package (raster.py:126-139), a setup table of at most
  TABLE_LIMIT_BYTES takes K1, the port of raster_pallas.py::
  _rasterize_pallas_table, which reads rows from the table by id; a larger
  one is pre-gathered per tile (binning.gather_bin_data) and takes K2, the
  port of _rasterize_pallas_padded;
- "torch": `_rasterize_torch`, the kernels' plain twin — a Python loop over
  bin entries of `_rasterize_jnp`'s body with all tiles batched;
- "auto": the kernels for CUDA tensors, the plain twin for CPU tensors.

`subtile_keep` is the plain twin of the kernels' exact per-rectangle cull;
the frame path never calls it (tests and chip_smoke.py do).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch

from .binning import bin_triangles, gather_bin_data, triangle_setup_corners

BACKENDS = ("auto", "torch", "cuda")
# The JAX package's VMEM budget for the table-resident kernel
# (raster_pallas.py:158): a (T, 16) f32 table of more than 4 MiB
# (T > 65,536 rows) takes the pre-gathered route.
TABLE_LIMIT_BYTES = 4 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """raster.py:35-53. capacity=None sizes every bin to the full padded
    triangle count; a tight capacity drops the excess ids of a full bin."""
    tile_h: int = 32
    tile_w: int = 128
    capacity: int | None = None
    backend: str = "auto"   # "auto" | "torch" | "cuda"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"RasterConfig.backend={self.backend!r}, "
                             f"expected one of {BACKENDS}")

    def tiles(self, width: int, height: int) -> Tuple[int, int]:
        return -(-height // self.tile_h), -(-width // self.tile_w)

    def resolve_capacity(self, padded_tris: int) -> int:
        return padded_tris if self.capacity is None else self.capacity


def use_kernel(cfg: RasterConfig, device: torch.device) -> bool:
    """"auto" takes the kernel exactly when the tensors live on a card."""
    if cfg.backend == "auto":
        return device.type == "cuda"
    return cfg.backend == "cuda"


def raster_scene(clip: torch.Tensor, tri_indices: torch.Tensor,
                 width: int, height: int, num_triangles: int | None,
                 cfg: RasterConfig, y_offset: int = 0,
                 slice_height: int | None = None, binning=None,
                 drops: str | None = None):
    """setup -> bin -> rasterize from vertex clip positions
    (raster.py:91-107). Returns (tri_id, depth, TriangleSetup)."""
    tri_clip = clip[tri_indices.long()]
    valid_mask = None
    if num_triangles is not None:
        valid_mask = torch.arange(tri_indices.shape[0],
                                  device=clip.device) < num_triangles
    return raster_corners(tri_clip, valid_mask, width, height, cfg,
                          y_offset, slice_height, binning, drops)


def raster_corners(tri_clip: torch.Tensor, valid_mask: torch.Tensor | None,
                   width: int, height: int, cfg: RasterConfig,
                   y_offset: int = 0, slice_height: int | None = None,
                   binning=None, drops: str | None = None):
    """raster_scene from per-corner clip positions (T, 3, 4)
    (raster.py:110-139). `width`/`height` are the full framebuffer;
    `y_offset` + `slice_height` select the row slab rastered. A frame's
    raster passes the span (utils/profiling.span) that holds its binning,
    the setup, bin_triangles and the pre-gather, as `binning`, and names
    the counter its dropped bin entries add to in `drops`."""
    sh = height if slice_height is None else slice_height
    capacity = cfg.resolve_capacity(tri_clip.shape[0])
    table = (use_kernel(cfg, tri_clip.device)
             and tri_clip.shape[0] * 64 <= TABLE_LIMIT_BYTES)
    with binning or contextlib.nullcontext():
        setup = triangle_setup_corners(tri_clip, width, height, valid_mask)
        bins, counts = bin_triangles(setup, width, sh, cfg.tile_h,
                                     cfg.tile_w, capacity, y_offset, drops)
        bin_data = None if table else gather_bin_data(setup, bins)
    if table:
        from .raster_cuda import raster_table_cuda

        tri_id, depth = raster_table_cuda(setup.data, bins, counts, width,
                                          sh, cfg.tile_h, cfg.tile_w,
                                          y_offset)
        return tri_id, depth, setup
    tri_id, depth = rasterize(bin_data, bins, counts, width, sh, cfg,
                              y_offset)
    return tri_id, depth, setup


def rasterize(bin_data: torch.Tensor, bins: torch.Tensor,
              counts: torch.Tensor, width: int, height: int,
              cfg: RasterConfig, y_offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize binned triangles from pre-gathered rows (raster.py:62-88):
    bin_data (n_tiles, C, 16) from binning.gather_bin_data, bins (n_tiles,
    C) ids with -1 padding, counts (n_tiles,) real entries, for the
    `height`-row slab at global row y_offset of a `width`-wide frame.
    Returns tri_id (H, W) int32 (-1 empty) and depth (H, W) f32 (1.0
    empty). K2 where use_kernel picks the kernel, else the plain twin."""
    if use_kernel(cfg, bin_data.device):
        from .raster_cuda import raster_padded_cuda

        return raster_padded_cuda(bin_data, counts, width, height,
                                  cfg.tile_h, cfg.tile_w, y_offset)
    return _rasterize_torch(bin_data, bins, counts, y_offset, width, height,
                            cfg)


def _rasterize_torch(bin_data: torch.Tensor, bins: torch.Tensor,
                     counts: torch.Tensor, y_offset: int, width: int,
                     height: int, cfg: RasterConfig):
    """Plain twin of the raster kernel (raster.py:142-184): the scan body
    of `_rasterize_jnp` as a Python loop over bin entries, every tile at
    once. The loop stops at the fullest bin: later entries are -1 padding
    in every tile and could not cover anything."""
    dev = bin_data.device
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_y, tiles_x = cfg.tiles(width, height)
    n_tiles = tiles_y * tiles_x

    oy = torch.arange(th, dtype=torch.float32, device=dev)[:, None] + 0.5
    ox = torch.arange(tw, dtype=torch.float32, device=dev)[None, :] + 0.5
    tile_idx = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    ty = ((tile_idx // tiles_x).to(torch.float32) * th
          + float(y_offset))[:, None, None]
    tx = ((tile_idx % tiles_x).to(torch.float32) * tw)[:, None, None]
    py = oy[None] + ty                                  # (n, th, 1)
    px = ox[None] + tx                                  # (n, 1, tw)

    zbuf = torch.full((n_tiles, th, tw), 1.0, dtype=torch.float32,
                      device=dev)
    idbuf = torch.full((n_tiles, th, tw), -1, dtype=torch.int32, device=dev)
    steps = int(counts.max()) if n_tiles and bins.shape[1] else 0
    for i in range(steps):
        d = bin_data[:, i, :, None, None]               # (n, 16, 1, 1)
        tid = bins[:, i, None, None]
        b0 = d[:, 0] * px + d[:, 1] * py + d[:, 2]
        b1 = d[:, 3] * px + d[:, 4] * py + d[:, 5]
        b2 = d[:, 6] * px + d[:, 7] * py + d[:, 8]
        z = d[:, 9] * px + d[:, 10] * py + d[:, 11]
        cover = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0)
                 & (z >= 0.0) & (z < zbuf) & (tid >= 0))
        zbuf = torch.where(cover, z, zbuf)
        idbuf = torch.where(cover, tid, idbuf)

    def untile(a):
        return (a.reshape(tiles_y, tiles_x, th, tw).permute(0, 2, 1, 3)
                .reshape(tiles_y * th, tiles_x * tw)[:height, :width]
                .contiguous())

    return untile(idbuf), untile(zbuf)


def subtile_corners(rows: torch.Tensor, x0, x1, y0, y1):
    """Each setup plane of `rows` (..., >= 12) f32 at the pixel centre of
    the rectangle [x0, x1] x [y0, y1] (inclusive pixel columns and global
    rows, broadcast against rows[..., 0]) where it is largest: (b_max
    (..., 3), z_max, z_min), z_min at the corner where z is smallest.

    The planes are evaluated as the raster evaluates them, (a*px + b*py) + c
    op by op in f32. Each rounding is monotone, so the value at that corner
    is the plane's maximum (minimum) over all the rectangle's pixel
    centres bit for bit; a NaN corner stays NaN."""
    def centre(v):
        return torch.as_tensor(v, device=rows.device).to(torch.float32) + 0.5

    cx0, cx1, cy0, cy1 = centre(x0), centre(x1), centre(y0), centre(y1)

    def at(a, b, c, high):
        px = torch.where((a >= 0) == high, cx1, cx0)
        py = torch.where((b >= 0) == high, cy1, cy0)
        return a * px + b * py + c

    d = rows[..., :12]
    b_max = torch.stack([at(d[..., 3 * i], d[..., 3 * i + 1],
                            d[..., 3 * i + 2], True) for i in range(3)], -1)
    return (b_max, at(d[..., 9], d[..., 10], d[..., 11], True),
            at(d[..., 9], d[..., 10], d[..., 11], False))


def subtile_keep(rows: torch.Tensor, x0, x1, y0, y1) -> torch.Tensor:
    """The kernels' cull (csrc/raster.cu::culled) as a bool mask over
    rows[..., 0]: False exactly where no pixel centre of the rectangle
    can pass the raster's test (some edge plane below 0 everywhere, or z
    below 0 or at least 1 everywhere). Dropping those entries from a bin
    list changes no pixel of the rectangle."""
    b_max, z_max, z_min = subtile_corners(rows, x0, x1, y0, y1)
    return ~((b_max < 0).any(-1) | (z_max < 0) | (z_min >= 1.0))
