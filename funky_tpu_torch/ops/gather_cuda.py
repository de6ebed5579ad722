"""Row gather out[i] = table[idx[i]] as a hand-written Hopper kernel, K3
(csrc/gather.cu), with its plain twin `take_rows_plain` (ops/sampling.py).

The port of the TPU row-gather probes in experiments/ (bench_gather.py
vmem_gather/dma_gather and the pallas_gather_* bisect/retest variants),
redesigned as the frame's row gather: `ops/sampling.py::take_rows` calls
`row_gather` for every CUDA table, so each sampler, compaction and the
deferred pass's fused rows gather through it. It takes any contiguous
table of 1-, 2-, 4- or 8-byte elements and any row shape, with int32
indices of any shape. For a CUDA tensor `row_gather` launches the kernel
or raises (`check_args` names the argument); for a CPU tensor it takes the
plain twin.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import cuda_build
from .sampling import take_rows_plain

# Kernel launches made by row_gather since the last reset.
LAUNCHES = 0

# The longest leading index axis the kernel walks as taps (tap_slices).
MAX_SLICES = 32

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = cuda_build.load("gather").row_gather_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, p, ll, i, p, p]
        fn.restype = i
        _FN = fn
    return _FN


def check_args(table: torch.Tensor, idx: torch.Tensor) -> Tuple[int, int]:
    """(rows, bytes per row) of a gather the kernel takes; raises naming
    the argument otherwise. Reads only types, shapes, strides and devices,
    never a value, so the frame's calls can be checked on the CPU as
    well."""
    for name, t in (("table", table), ("idx", idx)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if table.ndim == 0 or table.shape[0] == 0:
        raise ValueError(f"table: shape {tuple(table.shape)} has no rows")
    if table.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"table: {table.dtype} elements of "
                        f"{table.element_size()} bytes, expected 1, 2, 4 or 8")
    row_bytes = table.element_size() * math.prod(table.shape[1:])
    if row_bytes == 0:
        raise ValueError(f"table: shape {tuple(table.shape)} has empty rows")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx: {idx.dtype}, expected torch.int32")
    if idx.device != table.device:
        raise ValueError(f"idx: on {idx.device}, table on {table.device}")
    return table.shape[0], row_bytes


def tap_slices(idx: torch.Tensor) -> int:
    """The index's leading axis when it holds a few taps of the same
    pixels ((16, H, W) and (16, N) tap sets, (8, N) probes): 2 to
    MAX_SLICES long over a longer rest. One thread then gathers a pixel's
    taps, whose texels overlap, through one SM's L1. 0 otherwise: the
    kernel cuts the rows into slices of its own."""
    if idx.ndim < 2 or not 2 <= idx.shape[0] <= MAX_SLICES:
        return 0
    return idx.shape[0] if idx.numel() // idx.shape[0] > idx.shape[0] else 0


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (N, ...), idx (...) int32 -> idx.shape + table.shape[1:]: rows
    of `table` at `idx` with take_rows' semantics (negative counts from the
    end, then clamped into range)."""
    if table.device.type != "cuda":
        return take_rows_plain(table, idx)
    global LAUNCHES
    n, row_bytes = check_args(table, idx)
    out = torch.empty(tuple(idx.shape) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=table.device)
    if idx.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        status = _launcher()(table.data_ptr(), n, row_bytes, idx.data_ptr(),
                             idx.numel(), tap_slices(idx), out.data_ptr(),
                             stream)
    if status != 0:
        raise RuntimeError(f"row gather launch failed: CUDA error {status}")
    LAUNCHES += 1
    return out
