"""Wrappers of the hand-written Hopper tile-raster kernels (csrc/raster.cu).

- raster_table_cuda (K1) replaces funky_tpu/ops/raster_pallas.py::
  _rasterize_pallas_table (raster_pallas.py:208-251): rows read from the
  setup table by id;
- raster_padded_cuda (K2) replaces _rasterize_pallas_padded
  (raster_pallas.py:90-127): rows read from the pre-gathered per-tile
  stream of binning.gather_bin_data.

Both launch one block per rectangle of every tile (`rect_shape`): the
block culls the tile's bin list exactly against its rectangle and rasters
the survivors, four pixels per thread.

The source is built with nvcc at first use (ops/cuda_build.py) and bound
with ctypes through plain C entry points. The plain twin of both is
ops/raster.py::_rasterize_torch (of the cull: ops/raster.py::
subtile_keep). These wrappers never fall back to it: they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build

# Kernel launches since the last reset: K1 (raster_table_cuda) and K2
# (raster_padded_cuda).
LAUNCHES = 0
PADDED_LAUNCHES = 0

# A block has 256 threads of 1x4 pixels: its rectangle holds at most 1024
# pixels, RECT_H rows of the tile (fewer in a shorter tile) by as many
# columns as fill the block (fewer in a narrower tile).
THREADS, PIXELS_PER_THREAD = 256, 4
RECT_H = 32

_FNS = {}


def rect_shape(tile_h: int, tile_w: int) -> Tuple[int, int]:
    """(rows, columns) of the rectangle one block rasters in a tile of
    tile_h x tile_w: 32 x 32 in the 32x128 and 128x256 tiles, 16 x 64 in
    a 16-row tile, 8 x 128 in an 8-row one. Rectangles tile the tile; the
    last row and column of them may be cut short."""
    rh = min(tile_h, RECT_H)
    rw = min(tile_w, PIXELS_PER_THREAD * (THREADS // rh))
    return rh, rw


def reset_launches() -> None:
    global LAUNCHES, PADDED_LAUNCHES
    LAUNCHES = 0
    PADDED_LAUNCHES = 0


def _launcher(name: str, n_args: int, pointer_slots):
    if name not in _FNS:
        fn = getattr(cuda_build.load("raster"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p if k in pointer_slots else i for k in range(n_args)]
        fn.restype = i
        _FNS[name] = fn
    return _FNS[name]


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the raster kernel takes CUDA tensors, "
                         f"got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: {t.ndim}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_tiles(n_tiles_given, tile_h, tile_w, width, height):
    """(tiles_x, n_tiles) of the framebuffer; raises unless every count in
    n_tiles_given equals n_tiles."""
    if tile_h <= 0 or tile_w <= 0 or height <= 0 or width <= 0:
        raise ValueError("tile and framebuffer sizes must be positive")
    tiles_y, tiles_x = -(-height // tile_h), -(-width // tile_w)
    for n in n_tiles_given:
        if n != tiles_y * tiles_x:
            raise ValueError(f"{n} bin rows do not match {tiles_y * tiles_x} "
                             f"tiles of {tile_h}x{tile_w} over "
                             f"{height}x{width}")
    return tiles_x, tiles_y * tiles_x


def raster_table_cuda(setup_data: torch.Tensor, bins: torch.Tensor,
                      counts: torch.Tensor, width: int, height: int,
                      tile_h: int, tile_w: int, y_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as raster_pallas.rasterize_pallas_table: setup_data
    (T, 16) f32, bins (n_tiles, C) int32 ascending and -1 padded, counts
    (n_tiles,) int32. Returns tri_id (H, W) int32 and depth (H, W) f32 of
    the `height`-row slab starting at global row y_offset."""
    global LAUNCHES
    _check(setup_data, "setup_data", torch.float32, 2, None)
    dev = setup_data.device
    _check(bins, "bins", torch.int32, 2, dev)
    _check(counts, "counts", torch.int32, 1, dev)
    if setup_data.shape[1] != 16:
        raise ValueError(f"setup_data: {tuple(setup_data.shape)}, "
                         f"expected (T, 16)")
    tiles_x, n_tiles = _check_tiles((bins.shape[0], counts.shape[0]),
                                    tile_h, tile_w, width, height)
    if setup_data.shape[0] == 0 and bins.shape[1] > 0:
        raise ValueError("empty setup table with a non-empty bin list")

    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    fn = _launcher("raster_table_launch", 17, (0, 2, 3, 14, 15, 16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(setup_data.data_ptr(), setup_data.shape[0],
                    bins.data_ptr(), counts.data_ptr(), n_tiles,
                    bins.shape[1], int(y_offset), tile_h, tile_w, tiles_x,
                    *rect_shape(tile_h, tile_w), height, width,
                    tri_id.data_ptr(), depth.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error "
                           f"{status}")
    LAUNCHES += 1
    return tri_id, depth


def raster_padded_cuda(bin_data: torch.Tensor, counts: torch.Tensor,
                       width: int, height: int, tile_h: int, tile_w: int,
                       y_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as raster_pallas.rasterize_pallas (K2): bin_data
    (n_tiles, C, 16) f32 pre-gathered rows with each triangle id bitcast
    into column 12 (binning.gather_bin_data), counts (n_tiles,) int32.
    Returns tri_id (H, W) int32 and depth (H, W) f32 of the `height`-row
    slab starting at global row y_offset."""
    global PADDED_LAUNCHES
    _check(bin_data, "bin_data", torch.float32, 3, None)
    dev = bin_data.device
    _check(counts, "counts", torch.int32, 1, dev)
    if bin_data.shape[2] != 16:
        raise ValueError(f"bin_data: {tuple(bin_data.shape)}, expected "
                         f"(n_tiles, C, 16)")
    if bin_data.data_ptr() % 16:
        raise ValueError("bin_data: rows must be 16-byte aligned")
    tiles_x, n_tiles = _check_tiles((bin_data.shape[0], counts.shape[0]),
                                    tile_h, tile_w, width, height)

    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    fn = _launcher("raster_padded_launch", 15, (0, 1, 12, 13, 14))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(bin_data.data_ptr(), counts.data_ptr(), n_tiles,
                    bin_data.shape[1], int(y_offset), tile_h, tile_w,
                    tiles_x, *rect_shape(tile_h, tile_w), height, width,
                    tri_id.data_ptr(), depth.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"padded raster kernel launch failed: CUDA error "
                           f"{status}")
    PADDED_LAUNCHES += 1
    return tri_id, depth
