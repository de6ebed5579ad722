"""The light-space ground light map as a hand-written Hopper kernel, K5
(csrc/lightmap.cu), the card's path of passes/shadow_lightspace.py::
build_light_shadow_map.

K5 replaces the JAX package's jnp pass funky_tpu/passes/
shadow_lightspace.py::build_light_shadow_map (:210-331), which XLA fuses
on the TPU: one thread per texel of the (wc, wc) window evaluates the
PCSS or fixed-radius PCF of its own rotation phase and writes its
[v, m2, kernel, 1] row. It reads the per-frame tap geometry from two
small device buffers (the layout of `param_sizes`, packed by
shadow_lightspace.py::kernel_params), so no value is read on the host
and the light-space frame still records as a CUDA graph. `light_map`
launches the kernel or raises (`check_args` names the argument); the pass
above it takes the plain twin for a CPU map.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import cuda_build

# Kernel launches made by light_map since the last reset.
LAUNCHES = 0

# Taps per blocker search and per PCF radius (csrc/lightmap.cu's TAPS).
TAPS = 16

# Scalar slots at the head of the float parameters: the receiver plane
# (3), the depth bias, then (light_size, span) for PCSS or (radius,
# radius <= 1.25) for fixed-radius PCF.
FLOAT_HEAD = 6

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = cuda_build.load("lightmap").light_map_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, i, i, i, ctypes.c_float, p, p]
        fn.restype = i
        _FN = fn
    return _FN


def param_sizes(use_pcss: bool, rungs: int, phases: int) -> Tuple[int, int]:
    """(int32, f32) lengths of the packed parameters:
      ints   [oy, ox, (PCSS) sy (16, P), sx (16, P), y0 (R, 16, P),
              x0 (R, 16, P)]
      floats [plane (3), bias, light_size | radius, span | small,
              fy (R, 16, P), fx (R, 16, P), finite (R, P)]
    for P phases and R radii (PCSS's rungs, else one)."""
    tp = TAPS * phases
    n_r = rungs if use_pcss else 1
    return (2 + (2 * tp if use_pcss else 0) + 2 * n_r * tp,
            FLOAT_HEAD + 2 * n_r * tp + n_r * phases)


def check_args(raw_map: torch.Tensor, ints: torch.Tensor,
               floats: torch.Tensor, wc: int, halo: int, phases: int,
               rungs: int, use_pcss: bool) -> None:
    """Raises, naming the argument, on a call the kernel does not take.
    Reads only types, shapes, strides and devices, never a value, so it
    runs on the CPU as well."""
    for name, t, dtype in (("raw_map", raw_map, torch.float32),
                           ("ints", ints, torch.int32),
                           ("floats", floats, torch.float32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.device != raw_map.device:
            raise ValueError(f"{name}: on {t.device}, raw_map on "
                             f"{raw_map.device}")
    if raw_map.ndim != 2 or raw_map.shape[0] != raw_map.shape[1]:
        raise ValueError(f"raw_map: shape {tuple(raw_map.shape)}, expected "
                         f"(S, S)")
    if not 0 < wc <= raw_map.shape[0]:
        raise ValueError(f"wc: {wc} outside (0, {raw_map.shape[0]}]")
    if halo < 1:
        raise ValueError(f"halo: {halo}, expected at least 1")
    if not 1 <= phases <= 4:
        raise ValueError(f"phases: {phases}, expected 1 to 4")
    if use_pcss and rungs < 2:
        raise ValueError(f"rungs: {rungs}, expected at least 2")
    n_int, n_float = param_sizes(use_pcss, rungs, phases)
    for name, t, n in (("ints", ints, n_int), ("floats", floats, n_float)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"({n},)")


def light_map(raw_map: torch.Tensor, ints: torch.Tensor,
              floats: torch.Tensor, wc: int, halo: int, phases: int,
              rungs: int, use_pcss: bool) -> torch.Tensor:
    """The (wc * wc, 4) rows of the (wc, wc) window of the (S, S) raw map
    that `ints` and `floats` (param_sizes' layout) describe, for halo
    texels of tap reach; build_light_shadow_map's contract."""
    global LAUNCHES
    check_args(raw_map, ints, floats, wc, halo, phases, rungs, use_pcss)
    dev = raw_map.device
    if dev.type != "cuda":
        raise ValueError(f"raw_map: the light-map kernel takes CUDA "
                         f"tensors, got one on {dev}")
    s = raw_map.shape[0]
    # torch on the card divides by a host number as a multiply by its f32
    # reciprocal: the texel centres' (ox + j + 0.5) / S
    inv_s = float(np.float32(1.0) / np.float32(s))
    out = torch.empty((wc * wc, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launcher()(raw_map.data_ptr(), s, ints.data_ptr(),
                             floats.data_ptr(), wc, halo, phases, rungs,
                             int(use_pcss), inv_s, out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"light map launch failed: CUDA error {status}")
    LAUNCHES += 1
    return out
