"""The debug panel's raster as a hand-written Hopper kernel, K4
(csrc/overlay.cu), the card's path of passes/overlay.py::
rasterize_overlay.

K4 replaces the JAX package's jnp pass funky_tpu/passes/overlay.py::
rasterize_overlay (:26-82), a lax.scan over the triangle slots that XLA
runs as one program: one block per panel tile (TILE) builds, chunk by
chunk on the card, the list of the rows of passes/overlay.py::
overlay_table whose crop box meets the tile, in draw order, and each
pixel walks only that list, blending each triangle that covers it.
`overlay_raster` launches the kernel or raises (`check_args` names the
argument); the pass above it takes the plain twin, passes/overlay.py::
rasterize_overlay_plain, for a CPU atlas.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# The triangle table's row, as csrc/overlay.cu reads it: the f32 scalars
# of its barycentrics, its crop box [cx0, cx1) x [cy0, cy1) (integers as
# floats), its vertices' uv and premultiplied colour, and a zero to 32
# columns.
TABLE_COLS = 32
TABLE_SCALARS = 9     # inv_area, x2-x1, y2-y1, x0-x2, y0-y2, x1, y1, x2, y2
TABLE_CROP = 9        # cx0, cx1, cy0, cy1
TABLE_UV = 13         # uv of vertex k at TABLE_UV + 2k
TABLE_COLOR = 19      # colour of vertex k at TABLE_COLOR + 4k

# The kernel's tile: (width, height, warp width) in pixels, a whole number
# of warps up to 256 threads, each warp on warp width x 32 / warp width
# pixels. 16 x 16 with warps on 8 x 4 was the fastest of time_passes.py's
# sweep (its TILES) on both debug panels on an H100 (PERF.md).
TILE = (16, 16, 8)

# Kernel launches made by overlay_raster since the last reset.
LAUNCHES = 0

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = cuda_build.load("overlay").overlay_raster_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, i, i, i, i, i, i, p, p]
        fn.restype = i
        _FN = fn
    return _FN


def check_args(table: torch.Tensor, atlas: torch.Tensor,
               panel_hw: tuple) -> None:
    """Raises, naming the argument, on a call the kernel does not take.
    Reads only types, shapes, strides and devices, never a value, so it
    runs on the CPU as well."""
    for name, t in (("table", table), ("atlas", atlas)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype}, expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    if table.ndim != 2 or table.shape[1] != TABLE_COLS:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected "
                         f"(T, {TABLE_COLS})")
    if atlas.ndim != 3 or atlas.shape[2] != 4 or atlas.numel() == 0:
        raise ValueError(f"atlas: shape {tuple(atlas.shape)}, expected "
                         f"(Ah, Aw, 4)")
    if table.device != atlas.device:
        raise ValueError(f"table: on {table.device}, atlas on "
                         f"{atlas.device}")
    ph, pw = panel_hw
    if ph <= 0 or pw <= 0:
        raise ValueError(f"panel_hw: {panel_hw} is empty")


def overlay_raster(table: torch.Tensor, atlas: torch.Tensor,
                   panel_hw: tuple) -> torch.Tensor:
    """The (H, W, 4) premultiplied panel of a (T, TABLE_COLS) f32 triangle
    table (passes/overlay.py::overlay_table) over the (Ah, Aw, 4) atlas,
    on the atlas's device."""
    global LAUNCHES
    check_args(table, atlas, panel_hw)
    if atlas.device.type != "cuda":
        raise ValueError(f"atlas: the overlay kernel takes CUDA tensors, "
                         f"got one on {atlas.device}")
    ph, pw = panel_hw
    out = torch.empty((ph, pw, 4), dtype=torch.float32, device=atlas.device)
    with torch.cuda.device(atlas.device):
        stream = torch.cuda.current_stream(atlas.device).cuda_stream
        status = _launcher()(table.data_ptr(), table.shape[0],
                             atlas.data_ptr(), atlas.shape[0],
                             atlas.shape[1], ph, pw, *TILE, out.data_ptr(),
                             stream)
    if status != 0:
        raise RuntimeError(f"overlay raster launch failed: CUDA error "
                           f"{status}")
    LAUNCHES += 1
    return out
