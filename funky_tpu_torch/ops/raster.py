"""Tile raster: depth-tested visibility buffer (port of funky_tpu/ops/raster.py).

Output per pixel: the winning triangle id (-1 empty) and its NDC depth
(1.0 empty). Depth test LESS against 1.0; fragments with z outside [0, 1)
are clipped; ties keep the first-drawn (lowest) id.

Two interchangeable implementations, picked by `RasterConfig.backend`:
- "cuda": the hand-written Hopper kernel (ops/raster_cuda.py), the port
  of the Pallas kernel raster_pallas.py::_rasterize_pallas_table;
- "torch": `_rasterize_torch`, the kernel's plain twin — a Python loop over
  bin entries of `_rasterize_jnp`'s body with all tiles batched;
- "auto": the kernel for CUDA tensors, the plain twin for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .binning import bin_triangles, gather_bin_data, triangle_setup_corners

BACKENDS = ("auto", "torch", "cuda")


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
                 slice_height: int | None = None):
    """setup -> bin -> rasterize from vertex clip positions
    (raster.py:91-107). Returns (tri_id, depth, TriangleSetup)."""
    tri_clip = clip[tri_indices.long()]
    valid_mask = None
    if num_triangles is not None:
        valid_mask = torch.arange(tri_indices.shape[0],
                                  device=clip.device) < num_triangles
    return raster_corners(tri_clip, valid_mask, width, height, cfg,
                          y_offset, slice_height)


def raster_corners(tri_clip: torch.Tensor, valid_mask: torch.Tensor | None,
                   width: int, height: int, cfg: RasterConfig,
                   y_offset: int = 0, slice_height: int | None = None):
    """raster_scene from per-corner clip positions (T, 3, 4)
    (raster.py:110-139). `width`/`height` are the full framebuffer;
    `y_offset` + `slice_height` select the row slab rastered."""
    sh = height if slice_height is None else slice_height
    capacity = cfg.resolve_capacity(tri_clip.shape[0])
    setup = triangle_setup_corners(tri_clip, width, height, valid_mask)
    bins, counts = bin_triangles(setup, width, sh, cfg.tile_h, cfg.tile_w,
                                 capacity, y_offset)
    if use_kernel(cfg, tri_clip.device):
        from .raster_cuda import raster_table_cuda

        tri_id, depth = raster_table_cuda(setup.data, bins, counts, width,
                                          sh, cfg.tile_h, cfg.tile_w,
                                          y_offset)
    else:
        tri_id, depth = _rasterize_torch(gather_bin_data(setup, bins), bins,
                                         counts, y_offset, width, sh, cfg)
    return tri_id, depth, setup


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
