"""Row gather out[i] = table[idx[i]] as a hand-written Hopper kernel
(csrc/gather.cu), with its plain twin `take_rows` (ops/sampling.py).

The port of the TPU row-gather probes in experiments/ (bench_gather.py
vmem_gather/dma_gather and the pallas_gather_* bisect/retest variants),
which all compute this function on an (N, w) f32 table. It lies on no
frame path: the frame gathers with torch indexing, as the JAX frame does
with jnp.take. chip_smoke.py measures it at the shape of the dense shadow
filter's tap gathers. For a CUDA tensor `row_gather` launches the kernel
or raises; for a CPU tensor it takes the plain twin.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .sampling import take_rows

# Kernel launches made by row_gather since the last reset.
LAUNCHES = 0

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = cuda_build.load("gather").row_gather_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, i, p, ll, p, p]
        fn.restype = i
        _FN = fn
    return _FN


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (N, w) f32, idx (...) int32 -> (..., w): rows of `table` at
    `idx` with take_rows' semantics (negative counts from the end, then
    clamped into range)."""
    if table.device.type != "cuda":
        return take_rows(table, idx)
    global LAUNCHES
    if table.dtype != torch.float32 or table.ndim != 2:
        raise TypeError(f"table: {table.dtype} {table.ndim}-d, expected a "
                        f"2-d float32 tensor")
    if idx.dtype != torch.int32 or idx.device != table.device:
        raise TypeError(f"idx: {idx.dtype} on {idx.device}, expected int32 "
                        f"on {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.shape[0] == 0:
        raise ValueError("empty table")
    n, w = table.shape
    out = torch.empty(tuple(idx.shape) + (w,), dtype=torch.float32,
                      device=table.device)
    if w == 4 and table.data_ptr() % 16:
        raise ValueError("table: rows of 4 must be 16-byte aligned")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        status = _launcher()(table.data_ptr(), n, w, idx.data_ptr(),
                             idx.numel(), out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"row gather launch failed: CUDA error {status}")
    LAUNCHES += 1
    return out
