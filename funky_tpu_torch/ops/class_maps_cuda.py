"""The shadow class maps as a hand-written Hopper kernel, K10
(csrc/class_maps.cu), the card's path of passes/shadow_classify.py::
_class_rows.

K10 replaces the JAX package's jnp pass funky_tpu/passes/
shadow_classify.py::build_class_maps (:199-275), which XLA fuses on the
TPU: one block per tile of `tile_cells` x `tile_cells` cells of one
cascade stages the tile's haloed window in shared memory (BORDER_DEPTH
outside the map, the 2x2 pools made on the fly), takes every rung's
square min and the rise window's max as separable row and column passes,
and writes the cells' rows of [drop ladder (5), rise, min_resid,
max_resid]. The cascade planes and the residual slack `eps` are read from
device memory, so no value is read on the host and a committed frame
still records as a CUDA graph. `class_rows` launches the kernel or raises
(`check_args` names the argument); the pass above it takes the plain
twin for a CPU map.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build

# Kernel launches made by class_rows since the last reset.
LAUNCHES = 0

# csrc/class_maps.cu's ladder: the full-resolution rungs and the pooled
# half reaches (r + 1) // 2 of the rungs after the first.
LADDER = (3, 6, 12, 20, 34)
HALF_REACHES = (3, 6, 10, 17)
ROW = 8   # floats per cell row

# Shared memory a block may hold on sm_90 (227 KB), and the most a tile
# choice aims at: two blocks per SM.
MAX_SMEM = 232448
TARGET_SMEM = 113 * 1024
# Fine texels per tile side the tile choice starts from.
TILE_TEXELS = 64

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        lib = cuda_build.load("class_maps")
        fn = lib.class_maps_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, i, i, i, i, i, p, ll, p, ll, ctypes.c_float, p,
                       p]
        fn.restype = i
        _FN = fn
    return _FN


def _stage_floats(tc: int, cell: int, halo: int, nk: int, rise: int,
                  pooled: bool, resid: bool) -> int:
    """csrc/class_maps.cu's Layout(...).total for one stage."""
    p = tc * cell
    side = p + 2 * halo
    nv = nk + (1 if rise else 0) + (2 if resid else 0)
    return (side * side * (2 if pooled else 1) + nk * side * p
            + (side * p if rise else 0) + nv * p * p + nv * tc * tc * cell)


def smem_bytes(coarse: int, pooled: bool, rise: int, tc: int) -> int:
    """Shared memory of one block (csrc/class_maps.cu's class_maps_smem)."""
    if pooled:
        fine = _stage_floats(tc, coarse, LADDER[0], 1, 0, False, True)
        half = _stage_floats(tc, coarse // 2, max(HALF_REACHES[-1], rise),
                             len(HALF_REACHES), rise, True, False)
        return 4 * max(fine, half)
    return 4 * _stage_floats(tc, coarse, max(LADDER[-1], rise), len(LADDER),
                             rise, False, True)


def tile_cells(s: int, coarse: int, pooled: bool, rise: int) -> int:
    """Cells per tile side: TILE_TEXELS fine texels' worth (at least one
    cell, at most the map's cells), halved until a block fits in
    TARGET_SMEM (two blocks per SM; 4 on the shipped frame's coarse 16, 8
    at coarse 8)."""
    tc = max(1, min(TILE_TEXELS // coarse, s // coarse))
    while tc > 1 and smem_bytes(coarse, pooled, rise, tc) > TARGET_SMEM:
        tc //= 2
    return tc


def pooled_branch(s: int, coarse: int) -> bool:
    """build_class_maps' branch: the 2x2-pooled ladder (coarse and S
    even) or the full-resolution one."""
    return coarse % 2 == 0 and s % 2 == 0


def rise_reach(s: int, coarse: int, rise_window: int) -> int:
    """The rise's max reach the kernel takes: the window's half reach on
    the pooled maps, the window itself at full resolution."""
    return (rise_window + 1) // 2 if pooled_branch(s, coarse) else rise_window


def check_args(maps: torch.Tensor, coarse: int, rise_window: int,
               planes: torch.Tensor, eps: torch.Tensor) -> None:
    """Raises, naming the argument, on a call the kernel does not take.
    Reads only types, shapes, strides and devices, never a value, so it
    runs on the CPU as well. maps (L, S, S) f32 contiguous; coarse an int
    dividing S; rise_window an int in [1, 34] (build_class_maps asserts
    the ladder covers it); planes (L, 3) and eps (L,) f32 beside maps,
    planes with unit stride along its last axis."""
    for name, t in (("maps", maps), ("planes", planes), ("eps", eps)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype}, expected torch.float32")
        if t.device != maps.device:
            raise ValueError(f"{name}: on {t.device}, maps on {maps.device}")
    if maps.ndim != 3 or maps.shape[1] != maps.shape[2] or 0 in maps.shape:
        raise ValueError(f"maps: shape {tuple(maps.shape)}, expected "
                         f"(L, S, S)")
    if not maps.is_contiguous():
        raise ValueError("maps: must be contiguous")
    l, s, _ = maps.shape
    if l > 65535:
        raise ValueError(f"maps: {l} cascades, at most 65535")
    if s >= 46341:
        raise ValueError(f"maps: side {s}, at most 46340 (int32 texels)")
    if not isinstance(coarse, int) or coarse < 1 or s % coarse:
        raise ValueError(f"coarse: {coarse!r}, expected an int dividing "
                         f"S = {s}")
    if not isinstance(rise_window, int) or not 1 <= rise_window <= LADDER[-1]:
        raise ValueError(f"rise_window: {rise_window!r}, expected an int in "
                         f"[1, {LADDER[-1]}]")
    if tuple(planes.shape) != (l, 3) or planes.stride(1) != 1:
        raise ValueError(f"planes: shape {tuple(planes.shape)} strides "
                         f"{planes.stride()}, expected ({l}, 3) with unit "
                         f"stride along the last axis")
    if tuple(eps.shape) != (l,):
        raise ValueError(f"eps: shape {tuple(eps.shape)}, expected ({l},)")
    pooled = pooled_branch(s, coarse)
    rise = rise_reach(s, coarse, rise_window)
    need = smem_bytes(coarse, pooled, rise, tile_cells(s, coarse, pooled,
                                                       rise))
    if need > MAX_SMEM:
        raise ValueError(f"coarse: {coarse} needs {need} B of shared memory "
                         f"a block, at most {MAX_SMEM}")


def class_rows(maps: torch.Tensor, coarse: int, rise_window: int,
               planes: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """(L * Sc * Sc, 8) f32 cell rows [drop ladder, rise, min_resid,
    max_resid] of the raw cascades `maps`: _class_rows' contract."""
    global LAUNCHES
    check_args(maps, coarse, rise_window, planes, eps)
    dev = maps.device
    if dev.type != "cuda":
        raise ValueError(f"maps: the class-map kernel takes CUDA tensors, got "
                         f"one on {dev}")
    l, s, _ = maps.shape
    sc = s // coarse
    pooled = pooled_branch(s, coarse)
    rise = rise_reach(s, coarse, rise_window)
    tc = tile_cells(s, coarse, pooled, rise)
    out = torch.empty((l * sc * sc, ROW), dtype=torch.float32, device=dev)
    inv_s = float(np.float32(1.0) / np.float32(s))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launcher()(
            maps.data_ptr(), l, s, coarse, int(pooled), rise, tc,
            planes.data_ptr(), planes.stride(0), eps.data_ptr(),
            eps.stride(0), inv_s, out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"class-map launch failed: CUDA error {status}")
    LAUNCHES += 1
    return out
