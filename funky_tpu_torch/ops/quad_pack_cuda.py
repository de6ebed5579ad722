"""Edge-clamped 2x2 quads of depth maps as a hand-written Hopper kernel,
K11 (csrc/quad_pack.cu), the card's path of ops/sampling.py::quad_pack.

K11 replaces the JAX package's quad_pack (funky_tpu/ops/sampling.py:
192-199), which XLA fuses into one copy on the TPU and the plain twin
(`sampling.quad_pack_plain`) writes as three cats and a stack: each thread
walks a column strip of a map, carries the row below in registers as the
next step's row, and stores one 16-byte quad a texel. It takes any
contiguous float32 (..., H, W) as prod(...) maps. A copy of 32-bit words:
the output equals the twin's bit for bit, NaN payloads and -0.0 included.
`quad_pack` launches the kernel or raises (`check_args` names the
argument); `sampling.quad_pack` takes the plain twin for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import cuda_build

# Kernel launches made by quad_pack since the last reset.
LAUNCHES = 0

# Rows of a thread's column strip (each strip reads the row below its last
# twice): at 4 x 2048^2, 4 rows (16,384 blocks of 256 threads) ran in
# 0.119 ms, 8 in 0.123, 16 in 0.127, 64 in 0.136 on an H100 (PERF.md §6).
ROWS = 4

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = cuda_build.load("quad_pack").quad_pack_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, ll, i, i, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def check_args(img: torch.Tensor) -> Tuple[int, int, int]:
    """(maps, H, W) of a packing the kernel takes; raises naming the
    argument otherwise. Reads only types, shapes, strides and devices,
    never a value, so the frame's calls can be checked on the CPU as
    well."""
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"img: expected a tensor, got {type(img).__name__}")
    if img.dtype != torch.float32:
        raise TypeError(f"img: {img.dtype}, expected torch.float32")
    if img.ndim < 2 or img.numel() == 0:
        raise ValueError(f"img: shape {tuple(img.shape)}, expected a "
                         f"non-empty (..., H, W)")
    if not img.is_contiguous():
        raise ValueError("img: must be contiguous")
    h, w = img.shape[-2:]
    if h >= 2**31 or w >= 2**31:
        raise ValueError(f"img: shape {tuple(img.shape)}, H and W must be "
                         f"below 2^31")
    return math.prod(img.shape[:-2]), h, w


def quad_pack(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) float32 -> (..., H, W, 4): [d(y, x), d(y, x + 1),
    d(y + 1, x), d(y + 1, x + 1)], the +1 neighbours clamped to the last
    column and row; sampling.quad_pack's contract."""
    global LAUNCHES
    maps, h, w = check_args(img)
    if img.device.type != "cuda":
        raise ValueError(f"img: the quad-packing kernel takes CUDA tensors, "
                         f"got one on {img.device}")
    out = torch.empty(tuple(img.shape) + (4,), dtype=img.dtype,
                      device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        status = _launcher()(img.data_ptr(), out.data_ptr(), maps, h, w,
                             ROWS, stream)
    if status != 0:
        raise RuntimeError(f"quad pack launch failed: CUDA error {status}")
    LAUNCHES += 1
    return out
