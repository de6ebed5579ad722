"""Wrapper of the hand-written Hopper tile-raster kernel (csrc/raster.cu).

Replaces funky_tpu/ops/raster_pallas.py::_rasterize_pallas_table (the
table-resident Pallas kernel, raster_pallas.py:208-251). The kernel is
compiled with nvcc at first use, from the repository's own source, into
`funky_tpu_torch/build/`; a hash of the source and flags keys the library,
so a changed source rebuilds and an unchanged one is reused. It is bound
with ctypes through a plain C entry point (no PyTorch headers, so the
build takes seconds).

The plain twin is ops/raster.py::_rasterize_torch. This wrapper never
falls back to it: it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Tuple

import torch

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "csrc" / "raster.cu"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches made by raster_table_cuda since the last reset.
LAUNCHES = 0

_FN = None
BUILD_LOG = ""


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    candidates.append(os.path.join(home or "/usr/local/cuda", "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the raster kernel is built from "
                       "csrc/raster.cu with the CUDA toolkit")


def build() -> pathlib.Path:
    """Compile csrc/raster.cu into build/raster_<hash>.so (once per source
    version) and return its path. The compiler's log (with -Xptxas -v:
    registers, shared memory, spills) is kept in BUILD_LOG."""
    global BUILD_LOG
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"raster_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"raster_{key}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def _launcher():
    global _FN
    if _FN is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.raster_table_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, i, i, i, i, i, i, p, p, p]
        fn.restype = i
        _FN = fn
    return _FN


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
    tiles_y, tiles_x = -(-height // tile_h), -(-width // tile_w)
    n_tiles = tiles_y * tiles_x
    if bins.shape[0] != n_tiles or counts.shape[0] != n_tiles:
        raise ValueError(f"bins {tuple(bins.shape)} / counts "
                         f"{tuple(counts.shape)} do not match {n_tiles} "
                         f"tiles of {tile_h}x{tile_w} over {height}x{width}")
    if setup_data.shape[0] == 0 and bins.shape[1] > 0:
        raise ValueError("empty setup table with a non-empty bin list")
    if tile_h <= 0 or tile_w <= 0 or height <= 0 or width <= 0:
        raise ValueError("tile and framebuffer sizes must be positive")

    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(setup_data.data_ptr(), setup_data.shape[0],
                    bins.data_ptr(), counts.data_ptr(), n_tiles,
                    bins.shape[1], int(y_offset), tile_h, tile_w, tiles_x,
                    height, width, tri_id.data_ptr(), depth.data_ptr(),
                    stream)
    if status != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error "
                           f"{status}")
    LAUNCHES += 1
    return tri_id, depth
