"""Tile binning as a hand-written Hopper kernel, K12 (csrc/binning.cu), the
card's path of ops/binning.py::bin_triangles.

K12 replaces the JAX package's bin_triangles (funky_tpu/ops/binning.py:
150-200), a dense (T, n_tiles) mask and a sort of T keys per tile, which
the plain twin (`binning.bin_triangles`) repeats in torch. The kernel
needs neither: a warp takes 128 consecutive ids, counts them per tile of
the union of their tile rectangles, a scan turns the counts into each
chunk's offsets, and a second walk stores every id at its offset plus its
rank among the chunk's ids (ballots, so the lists stay in id order
without an atomic), then fills the rest of each list with -1. Integer
work throughout: bins and counts equal the twin's bit for bit, and the
dropped entries are added on the device to the named drop counter
(utils/profiling.drop_slot) inside the kernel, with no node of their own.
`bin_triangles` launches the kernel or raises (`check_args` names the
argument); ops/raster.py::raster_corners takes it, and
ops/raster.py::bin_occupancy (the tune's occupancy) takes `bin_counts`,
where `use_kernel` picks the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils import profiling
from . import cuda_build

# Kernel calls made since the last reset (each launches the count and scan
# kernels, and the scatter unless it counts alone).
LAUNCHES = 0

# Ids a warp owns (csrc/binning.cu's CHUNK): the scratch table has a row
# of n_tiles counts per chunk.
CHUNK = 128

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        lib = cuda_build.load("binning")
        if lib.bin_chunk_ids() != CHUNK:
            raise RuntimeError(f"csrc/binning.cu's chunk is "
                               f"{lib.bin_chunk_ids()} ids, not {CHUNK}")
        fn = lib.bin_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, p, p, p, p, p]
        fn.restype = i
        _FN = fn
    return _FN


def check_args(setup, width: int, height: int, tile_h: int, tile_w: int,
               capacity: int) -> Tuple[int, int]:
    """(tiles_x, tiles_y) of a binning the kernel takes; raises naming the
    argument otherwise. Reads only types, shapes, strides and devices,
    never a value, so the frame's calls can be checked on the CPU as
    well."""
    data, valid = setup.data, setup.valid
    for name, t in (("setup.data", data), ("setup.valid", valid)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if data.dtype != torch.float32:
        raise TypeError(f"setup.data: {data.dtype}, expected torch.float32")
    if data.ndim != 2 or data.shape[1] != 16:
        raise ValueError(f"setup.data: shape {tuple(data.shape)}, expected "
                         f"(T, 16)")
    if valid.dtype != torch.bool or tuple(valid.shape) != (data.shape[0],):
        raise ValueError(f"setup.valid: {valid.dtype} {tuple(valid.shape)}, "
                         f"expected torch.bool ({data.shape[0]},)")
    if valid.device != data.device:
        raise ValueError(f"setup.valid: on {valid.device}, expected "
                         f"{data.device}")
    if min(width, height, tile_h, tile_w) < 1:
        raise ValueError("tile and framebuffer sizes must be positive")
    if capacity < 0:
        raise ValueError(f"capacity: {capacity}, expected >= 0")
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    if data.shape[0] >= 2**31 or tiles_x * tiles_y >= 2**31:
        raise ValueError(f"{data.shape[0]} rows over {tiles_x * tiles_y} "
                         f"tiles: the kernel counts both in 32 bits")
    return tiles_x, tiles_y


def _launch(setup, width, height, tile_h, tile_w, capacity, y_offset,
            lists: bool, drops) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bins or None, counts) of one kernel call."""
    global LAUNCHES
    tiles_x, tiles_y = check_args(setup, width, height, tile_h, tile_w,
                                  capacity)
    dev = setup.data.device
    if dev.type != "cuda":
        raise ValueError(f"setup.data: the binning kernel takes CUDA "
                         f"tensors, got one on {dev}")
    t = setup.data.shape[0]
    n_tiles = tiles_x * tiles_y
    table = torch.empty((-(-t // CHUNK), n_tiles), dtype=torch.int32,
                        device=dev)
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    bins = (torch.empty((n_tiles, capacity), dtype=torch.int32, device=dev)
            if lists else None)
    with torch.cuda.device(dev):
        slot = profiling.drop_slot(drops, dev) if drops is not None else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launcher()(
            setup.data.data_ptr(), setup.valid.data_ptr(), t, tiles_x,
            tiles_y, int(y_offset) // tile_h, tile_h, tile_w, capacity,
            int(lists), table.data_ptr(), counts.data_ptr(),
            bins.data_ptr() if lists else None,
            None if slot is None else slot.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"binning kernel launch failed: CUDA error "
                           f"{status}")
    LAUNCHES += 1
    return bins, counts


def bin_triangles(setup, width: int, height: int, tile_h: int, tile_w: int,
                  capacity: int, y_offset: int = 0, drops: str | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """binning.bin_triangles' contract: bins (n_tiles, capacity) int32,
    ascending ids, -1 padded, and counts (n_tiles,) int32 clamped to
    `capacity` (a full tile keeps its lowest ids), for the `height`-row
    slab at global row y_offset; the dropped entries are added to the
    drop counter named by `drops` on the device."""
    return _launch(setup, width, height, tile_h, tile_w, capacity, y_offset,
                   True, drops)


def bin_counts(setup, width: int, height: int, tile_h: int,
               tile_w: int) -> torch.Tensor:
    """The counts of bin_triangles at a capacity of every row (nothing is
    dropped): the count and scan kernels alone, no list written."""
    return _launch(setup, width, height, tile_h, tile_w,
                   setup.data.shape[0], 0, False, None)[1]
