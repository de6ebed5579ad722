"""The shadow filter's tap sets as a hand-written Hopper kernel, K6
(csrc/pair_taps.cu), the card's path of passes/shadow_filter.py::
_pcss_taps and _pcf_taps.

K6 replaces the JAX package's jnp tap cores funky_tpu/passes/
shadow_filter.py::_pcss_taps (:159-219) and _pcf_taps (:248-283), which
XLA fuses on the TPU: a group of lanes per entry (`lanes_for`: 8, two
Vogel taps each, on the frame's pair groups) evaluates its 16 blocker taps,
its penumbra and its 16 compare taps (or the fixed-radius PCF) and writes
one [m1, m2, penumbra | kernel, has_blockers] row. It reads the quad rows
from the packed maps at a per-entry layer, or from a window of one
cascade at an origin that may be a device value, the two uniforms it
needs (shadow_map_size[2], shadow_bias[0]) and an optional live count
(slots at or past it get the row 0 and no taps) from device memory, so no
value is read on the host and a committed frame still records as a CUDA
graph. `pair_taps` launches the kernel or raises (`check_args` names the
argument); the pass above it takes the plain twins for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

# Kernel launches made by pair_taps since the last reset.
LAUNCHES = 0

# The kernel's modes (csrc/pair_taps.cu's Mode).
MODES = {"pcss": 0, "radius_only": 1, "pcf": 2}

# Lanes per entry the kernel takes (lanes_for picks one).
LANES = (1, 8)

# Launches of at most this many entries take 8 lanes per entry, larger
# ones 1. On an H100 80GB HBM3 (700 W, time_passes.py), on entries drawn
# from a pair group and from the dense frame alike, 8 lanes ran 1.4-2.2x
# faster up to 32 K entries, the two about equal at 64 K, and from 128 K
# entries on 1 lane ran up to 1.4x faster (but for a tie on the dense
# frame's entries at 256 K). The frames' pair groups hold at most ~98 K
# slots (fewer live), their dense filters at least ~393 K entries.
LANES_8_MAX = 1 << 17

_I32 = (-2 ** 31, 2 ** 31 - 1)
_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = cuda_build.load("pair_taps").pair_taps_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, i, i, i, i, ll, p, i, i, p, ll, p, ll, p, ll,
                       p, ll, p, p, p, i, i, i, p, p]
        fn.restype = i
        _FN = fn
    return _FN


def _tensor(name: str, t, dtype, device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, expected {dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, uv on {device}")


def lanes_for(n: int) -> int:
    """Lanes per entry for a launch of n entries: 8 (two taps each) up to
    LANES_8_MAX, where more threads hide the taps' latency, else 1."""
    return 8 if n <= LANES_8_MAX else 1


def check_args(maps, layer, uv: torch.Tensor, receiver: torch.Tensor,
               phi: torch.Tensor, shadow_map_size: torch.Tensor,
               shadow_bias: torch.Tensor, mode: str, window=None,
               count=None) -> None:
    """Raises, naming the argument, on a call the kernel does not take.
    Reads only types, shapes, strides and devices, never a value, so it
    runs on the CPU as well. uv (..., 2) f32; receiver, phi (...) f32;
    packed: maps (L, S, S, 4) f32 and layer (...) int32; window: (rows
    (Wh, Ww, 4) f32 with unit strides along its last two axes, origin
    (oy, ox) of ints or integer 0-d tensors, full map size S); count: None
    or one int32 (shape () or (1,)) beside uv."""
    _tensor("uv", uv, torch.float32)
    dev = uv.device
    if uv.ndim < 1 or uv.shape[-1] != 2:
        raise ValueError(f"uv: shape {tuple(uv.shape)}, expected (..., 2)")
    batch = tuple(uv.shape[:-1])
    for name, t in (("receiver", receiver), ("phi", phi)):
        _tensor(name, t, torch.float32, dev)
        if tuple(t.shape) != batch:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{batch}")
    for name, t, i in (("shadow_map_size", shadow_map_size, 2),
                       ("shadow_bias", shadow_bias, 0)):
        _tensor(name, t, torch.float32, dev)
        if t.ndim != 1 or t.shape[0] <= i:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"({i + 1} or more,)")
    if mode not in MODES:
        raise ValueError(f"mode: {mode!r}, expected one of {sorted(MODES)}")
    if math.prod(batch) >= 2 ** 31:
        raise ValueError(f"uv: {math.prod(batch)} entries, at most 2^31 - 1")
    if count is not None:
        _tensor("count", count, torch.int32, dev)
        if tuple(count.shape) not in ((), (1,)):
            raise ValueError(f"count: shape {tuple(count.shape)}, expected "
                             f"() or (1,)")
    if window is None:
        _tensor("maps", maps, torch.float32, dev)
        if maps.ndim != 4 or maps.shape[1] != maps.shape[2] \
                or maps.shape[3] != 4 or maps.shape[0] == 0:
            raise ValueError(f"maps: shape {tuple(maps.shape)}, expected "
                             f"(L, S, S, 4)")
        if not maps.is_contiguous():
            raise ValueError("maps: must be contiguous")
        _tensor("layer", layer, torch.int32, dev)
        if tuple(layer.shape) != batch:
            raise ValueError(f"layer: shape {tuple(layer.shape)}, expected "
                             f"{batch}")
        return
    if not isinstance(window, tuple) or len(window) != 3:
        raise TypeError("window: expected (rows, origin, full size)")
    rows, origin, full = window
    _tensor("window rows", rows, torch.float32, dev)
    if rows.ndim != 3 or rows.shape[2] != 4 or 0 in rows.shape:
        raise ValueError(f"window rows: shape {tuple(rows.shape)}, expected "
                         f"(Wh, Ww, 4)")
    if rows.stride(2) != 1 or rows.stride(1) != 4 \
            or rows.stride(0) < 4 * rows.shape[1]:
        raise ValueError(f"window rows: strides {rows.stride()}, expected "
                         f"(>= 4 Ww, 4, 1)")
    if not isinstance(full, int) or full <= 0:
        raise ValueError(f"window full size: {full!r}, expected an int > 0")
    if not isinstance(origin, tuple) or len(origin) != 2:
        raise TypeError("window origin: expected (oy, ox)")
    for name, o in zip(("oy", "ox"), origin):
        if isinstance(o, torch.Tensor):
            if o.numel() != 1 or o.is_floating_point() or o.is_complex() \
                    or o.dtype == torch.bool:
                raise TypeError(f"window origin {name}: {o.dtype} of shape "
                                f"{tuple(o.shape)}, expected one integer")
            if o.device != dev:
                raise ValueError(f"window origin {name}: on {o.device}, uv "
                                 f"on {dev}")
        elif not isinstance(o, int) or not _I32[0] <= o <= _I32[1]:
            raise ValueError(f"window origin {name}: {o!r}, expected an "
                             f"int32 or a tensor")


def _origin(origin, dev):
    """(device tensor of the two origins or None, host oy, host ox)."""
    if not any(isinstance(o, torch.Tensor) for o in origin):
        return None, origin[0], origin[1]
    parts = [o.reshape(()).to(torch.int32) if isinstance(o, torch.Tensor)
             else torch.full((), o, dtype=torch.int32, device=dev)
             for o in origin]
    return torch.stack(parts), 0, 0


def pair_taps(maps, layer, uv: torch.Tensor, receiver: torch.Tensor,
              phi: torch.Tensor, shadow_map_size: torch.Tensor,
              shadow_bias: torch.Tensor, mode: str, window=None,
              count=None) -> torch.Tensor:
    """receiver.shape + (4,) f32 rows [m1, m2, penumbra, has_blockers]
    (mode "pcss"; "radius_only": m1 = m2 = 1) or [m1, m2, kernel, 0]
    ("pcf") of each entry's taps: _pcss_taps' and _pcf_taps' contract,
    reading the packed `maps` at `layer` or, given one, the `window`. With
    a `count` (one int32 on the card), the rows of the flat entries at or
    past it are 0. The lanes per entry are lanes_for(N)."""
    global LAUNCHES
    check_args(maps, layer, uv, receiver, phi, shadow_map_size, shadow_bias,
               mode, window, count)
    dev = uv.device
    if dev.type != "cuda":
        raise ValueError(f"uv: the pair-tap kernel takes CUDA tensors, got "
                         f"one on {dev}")
    batch = tuple(receiver.shape)
    uv2 = uv.reshape(-1, 2)
    if uv2.stride(1) != 1:
        uv2 = uv2.contiguous()
    recv, ph = receiver.reshape(-1), phi.reshape(-1)
    n = recv.shape[0]
    out = torch.empty(batch + (4,), dtype=torch.float32, device=dev)
    if window is None:
        lay = layer.reshape(-1)
        table, n_rows, s = maps, maps.shape[0] * maps.shape[1] ** 2, \
            maps.shape[1]
        geometry = (0, 0, 0, 0, None, 0, 0)
        lay_ptr, lay_stride = lay.data_ptr(), lay.stride(0)
    else:
        rows, origin, s = window
        table, n_rows = rows, 0
        org, oy, ox = _origin(origin, dev)
        geometry = (1, rows.shape[0], rows.shape[1], rows.stride(0),
                    None if org is None else org.data_ptr(), oy, ox)
        lay_ptr, lay_stride = None, 0
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launcher()(
            table.data_ptr(), n_rows, s, *geometry, lay_ptr, lay_stride,
            uv2.data_ptr(), uv2.stride(0), recv.data_ptr(), recv.stride(0),
            ph.data_ptr(), ph.stride(0), shadow_map_size[2:3].data_ptr(),
            shadow_bias[0:1].data_ptr(),
            None if count is None else count.data_ptr(), n, MODES[mode],
            lanes_for(n), out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"pair-tap launch failed: CUDA error {status}")
    LAUNCHES += 1
    return out
