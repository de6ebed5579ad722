"""The contact shadows' front and back as hand-written Hopper kernels, K8
and K9 (csrc/contact.cu), the card's path of passes/contact.py::
contact_front, contact_certify and contact_march.

K8 (`contact_front`) replaces the JAX package's jnp stages funky_tpu/
passes/contact.py::_ray_setup (:76-121), _jitter / _jitter_at
(:197-212) and _segment_cert (:496-587): one thread per pixel of the
domain writes its candidate mask, its stage-2 mask (with the residual
pyramid) and its [march start, march dir, jitter] payload row. K9
replaces _stage2_certify (:590-608, `contact_certify`) and _march /
_soft_term (:124-194, `contact_march`): one thread per compacted slot
reads its payload row through the slot's index and stops at the live
count, both read on the card; the march reads prev_depth directly (the
quad of quad_pack, edge-clamped) or through a window at a device origin,
and writes each term into a ones-filled output at its pixel. Uniforms,
counts and origins stay in device memory, so no value is read on the host
and a committed frame still records as a CUDA graph. Each wrapper
launches its kernel or raises (its `check_*` names the argument); the
pass above takes the plain twins for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build

# Kernel launches made by each wrapper since the last reset.
FRONT_LAUNCHES = 0
CERTIFY_LAUNCHES = 0
MARCH_LAUNCHES = 0

ROW = 7   # payload floats per ray: march start (3), march dir (3), jitter

_FNS: dict = {}


def reset_launches() -> None:
    global FRONT_LAUNCHES, CERTIFY_LAUNCHES, MARCH_LAUNCHES
    FRONT_LAUNCHES = CERTIFY_LAUNCHES = MARCH_LAUNCHES = 0


def _launcher(name: str):
    if name not in _FNS:
        fn = getattr(cuda_build.load("contact"), f"contact_{name}_launch")
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = {
            "front": [p, ll, p, ll, p, ll, p, p, p, ll, p, f, i, p, p, p, p,
                      p, f, f, ll, p, p, p, p],
            "certify": [p, ll, p, ll, p, p, i, i, f, p, p, f, f, p, p],
            "march": [p, i, i, p, ll, p, ll, p, p, p, i, p, p],
        }[name]
        fn.restype = i
        _FNS[name] = fn
    return _FNS[name]


def _tensor(name: str, t, dtype, device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, expected {dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _rows(t: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) as (n, k) with unit stride along the last axis (a view
    where one exists)."""
    t = t.reshape(-1, k)
    return t if t.stride(1) == 1 else t.contiguous()


def _depth_shape(depth_shape) -> tuple:
    if (not isinstance(depth_shape, (tuple, list, torch.Size))
            or len(depth_shape) != 2
            or not all(isinstance(d, int) and d > 0 for d in depth_shape)):
        raise ValueError(f"depth_shape: {depth_shape!r}, expected (H, W) of "
                         f"positive ints")
    return tuple(depth_shape)


def _pyramid(pyr, dev) -> None:
    for name, shape in (("occl_lo", (2,)), ("occl_hi", (2,)),
                        ("plane", (3,)), ("eps", ())):
        t = getattr(pyr, name)
        _tensor(f"pyr.{name}", t, torch.float32, dev)
        _shape(f"pyr.{name}", t, shape)


def check_front(world, normal, light_dir, vp, frame, depth_shape,
                valid=None, y0=0, frag=None, pyr=None) -> None:
    """Raises, naming the argument, on a front call the kernel does not
    take. Reads only types, shapes, strides and devices, never a value,
    so it runs on the CPU as well. world and normal (..., 3) f32 of one
    batch; light_dir (3,), vp (4, 4) contiguous, frame () f32; valid
    (batch) bool; frag (batch + (2,)) f32, else a 2-D batch (the slab's
    rows) and y0 an int or a 0-d number tensor; pyr: the residual
    pyramid (occl_lo, occl_hi (2,), plane (3,), eps () f32)."""
    _tensor("world", world, torch.float32)
    dev = world.device
    if world.ndim < 1 or world.shape[-1] != 3:
        raise ValueError(f"world: shape {tuple(world.shape)}, expected "
                         f"(..., 3)")
    batch = tuple(world.shape[:-1])
    _tensor("normal", normal, torch.float32, dev)
    _shape("normal", normal, batch + (3,))
    _tensor("light_dir", light_dir, torch.float32, dev)
    _shape("light_dir", light_dir, (3,))
    _tensor("vp", vp, torch.float32, dev)
    _shape("vp", vp, (4, 4))
    if not vp.is_contiguous():
        raise ValueError("vp: must be contiguous")
    _tensor("frame", frame, torch.float32, dev)
    _shape("frame", frame, ())
    _depth_shape(depth_shape)
    n = int(np.prod(batch))
    if n >= 2 ** 31:
        raise ValueError(f"world: {n} pixels, at most 2^31 - 1")
    if valid is not None:
        _tensor("valid", valid, torch.bool, dev)
        _shape("valid", valid, batch)
    if frag is not None:
        _tensor("frag", frag, torch.float32, dev)
        _shape("frag", frag, batch + (2,))
    else:
        if len(batch) != 2:
            raise ValueError(f"world: batch {batch}; without frag the "
                             f"domain is a (rows, width) slab")
        if isinstance(y0, torch.Tensor):
            if y0.numel() != 1 or y0.dtype == torch.bool \
                    or y0.is_complex():
                raise TypeError(f"y0: {y0.dtype} of shape "
                                f"{tuple(y0.shape)}, expected one number")
            if y0.device != dev:
                raise ValueError(f"y0: on {y0.device}, world on {dev}")
        elif not isinstance(y0, int):
            raise TypeError(f"y0: {y0!r}, expected an int or a tensor")
    if pyr is not None:
        _pyramid(pyr, dev)


def contact_front(world, normal, light_dir, vp, frame, depth_shape,
                  valid=None, y0=0, frag=None, pyr=None):
    """(cand, stage2, payload): cand = facing & on screen (& valid) of
    the batch, stage2 = cand & (intersects | ~cert) given the pyramid
    (else None), payload (n, 7) f32 [march start, march dir, jitter]:
    contact.py::contact_front's contract, with vp = proj @ view and frame
    = debug_flags[3] taken by the caller."""
    global FRONT_LAUNCHES
    check_front(world, normal, light_dir, vp, frame, depth_shape, valid, y0,
                frag, pyr)
    dev = world.device
    if dev.type != "cuda":
        raise ValueError(f"world: the contact kernels take CUDA tensors, got "
                         f"one on {dev}")
    batch = tuple(world.shape[:-1])
    n = int(np.prod(batch))
    hd, wd = depth_shape
    cand = torch.empty(batch, dtype=torch.bool, device=dev)
    stage2 = (torch.empty(batch, dtype=torch.bool, device=dev)
              if pyr is not None else None)
    payload = torch.empty((n, ROW), dtype=torch.float32, device=dev)
    if n == 0:
        return cand, stage2, payload
    w3, n3 = _rows(world, 3), _rows(normal, 3)
    f2 = None if frag is None else _rows(frag, 2)
    y0_t, y0_host, width = None, 0.0, 0
    if frag is None:
        width = batch[1]
        if isinstance(y0, torch.Tensor):
            y0_t = y0.reshape(1).to(torch.float32)
        else:
            y0_host = float(np.float32(y0))
    vm = None if valid is None else valid.reshape(-1).contiguous()
    ptrs = ((pyr.occl_lo.data_ptr(), pyr.occl_hi.data_ptr(),
             pyr.plane.data_ptr(), pyr.eps.data_ptr())
            if pyr is not None else (None,) * 4)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launcher("front")(
            w3.data_ptr(), w3.stride(0), n3.data_ptr(), n3.stride(0),
            light_dir.data_ptr(), light_dir.stride(0), vp.data_ptr(),
            frame.data_ptr(), None if f2 is None else f2.data_ptr(),
            0 if f2 is None else f2.stride(0),
            None if y0_t is None else y0_t.data_ptr(), y0_host, width,
            None if vm is None else vm.data_ptr(), *ptrs, float(wd),
            float(hd), n, cand.data_ptr(),
            None if stage2 is None else stage2.data_ptr(),
            payload.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"contact front launch failed: CUDA error "
                           f"{status}")
    FRONT_LAUNCHES += 1
    return cand, stage2, payload


def _slots(payload, idx, count, dev) -> int:
    """Checks the payload, index and count of a K9 call; returns the
    slots."""
    _tensor("payload", payload, torch.float32, dev)
    if payload.ndim != 2 or payload.shape[1] != ROW:
        raise ValueError(f"payload: shape {tuple(payload.shape)}, expected "
                         f"(n, {ROW})")
    if not payload.is_contiguous():
        raise ValueError("payload: must be contiguous")
    n = payload.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"payload: {n} rows, at most 2^31 - 1")
    if idx is not None:
        _tensor("idx", idx, torch.int32, dev)
        if idx.ndim != 1 or not idx.is_contiguous():
            raise ValueError(f"idx: shape {tuple(idx.shape)} strides "
                             f"{idx.stride()}, expected a contiguous (m,)")
        m = idx.shape[0]
    else:
        m = n
    if count is not None:
        _tensor("count", count, torch.int32, dev)
        if tuple(count.shape) not in ((), (1,)):
            raise ValueError(f"count: shape {tuple(count.shape)}, expected "
                             f"() or (1,)")
    return m


def check_certify(pyr, payload, depth_shape, idx=None, count=None) -> None:
    """Raises, naming the argument, on a certify call the kernel does not
    take (never reads a value). payload (n, 7) f32 contiguous; idx None
    or a contiguous (m,) int32; count None or one int32; the pyramid's
    rows (lh * lw, 4) f32 contiguous, base an int >= 1, its plane (3,)
    and eps () f32."""
    _tensor("payload", payload, torch.float32)
    dev = payload.device
    _slots(payload, idx, count, dev)
    _depth_shape(depth_shape)
    _tensor("pyr.rows", pyr.rows, torch.float32, dev)
    _shape("pyr.rows", pyr.rows, (pyr.lh * pyr.lw, 4))
    if not pyr.rows.is_contiguous() or pyr.lh < 1 or pyr.lw < 1:
        raise ValueError("pyr.rows: must be contiguous and not empty")
    if not isinstance(pyr.base, int) or pyr.base < 1:
        raise ValueError(f"pyr.base: {pyr.base!r}, expected an int >= 1")
    for name, shape in (("plane", (3,)), ("eps", ())):
        t = getattr(pyr, name)
        _tensor(f"pyr.{name}", t, torch.float32, dev)
        _shape(f"pyr.{name}", t, shape)


def contact_certify(pyr, payload, depth_shape, idx=None, count=None):
    """(m,) bool: each slot's 8-probe level-0 certificate, true at or past
    the live count: contact.py::contact_certify's contract."""
    global CERTIFY_LAUNCHES
    check_certify(pyr, payload, depth_shape, idx, count)
    dev = payload.device
    if dev.type != "cuda":
        raise ValueError(f"payload: the contact kernels take CUDA tensors, "
                         f"got one on {dev}")
    n = payload.shape[0]
    m = n if idx is None else idx.shape[0]
    out = torch.empty((m,), dtype=torch.bool, device=dev)
    if m == 0:
        return out
    hd, wd = depth_shape
    inv_base = float(np.float32(1.0) / np.float32(pyr.base))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launcher("certify")(
            payload.data_ptr(), n, None if idx is None else idx.data_ptr(),
            m, None if count is None else count.data_ptr(),
            pyr.rows.data_ptr(), pyr.lw, pyr.lh, inv_base,
            pyr.plane.data_ptr(), pyr.eps.data_ptr(), float(wd), float(hd),
            out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"contact certify launch failed: CUDA error "
                           f"{status}")
    CERTIFY_LAUNCHES += 1
    return out


def check_march(prev_depth, payload, idx=None, count=None, mask=None,
                window=None) -> None:
    """Raises, naming the argument, on a march call the kernel does not
    take (never reads a value). prev_depth (H, W) f32 contiguous; payload,
    idx and count as contact_certify's; mask None or (n,) bool, only
    without an index; window None or (origin (2,) int32 [oy, ox], cw an
    int in [1, min(H, W)])."""
    _tensor("prev_depth", prev_depth, torch.float32)
    dev = prev_depth.device
    if prev_depth.ndim != 2 or 0 in prev_depth.shape:
        raise ValueError(f"prev_depth: shape {tuple(prev_depth.shape)}, "
                         f"expected (H, W)")
    if not prev_depth.is_contiguous():
        raise ValueError("prev_depth: must be contiguous")
    if prev_depth.numel() >= 2 ** 31:
        raise ValueError("prev_depth: at most 2^31 - 1 texels")
    _slots(payload, idx, count, dev)
    if mask is not None:
        if idx is not None:
            raise ValueError("mask: taken only without an index")
        _tensor("mask", mask, torch.bool, dev)
        _shape("mask", mask, (payload.shape[0],))
        if not mask.is_contiguous():
            raise ValueError("mask: must be contiguous")
    if window is not None:
        if not isinstance(window, tuple) or len(window) != 2:
            raise TypeError("window: expected (origin, cw)")
        origin, cw = window
        _tensor("window origin", origin, torch.int32, dev)
        _shape("window origin", origin, (2,))
        if not origin.is_contiguous():
            raise ValueError("window origin: must be contiguous")
        if not isinstance(cw, int) or not 1 <= cw <= min(prev_depth.shape):
            raise ValueError(f"window cw: {cw!r}, expected an int in [1, "
                             f"{min(prev_depth.shape)}]")


def contact_march(prev_depth, payload, idx=None, count=None, mask=None,
                  window=None):
    """(n,) f32 contact terms: contact.py::contact_march's contract."""
    global MARCH_LAUNCHES
    check_march(prev_depth, payload, idx, count, mask, window)
    dev = prev_depth.device
    if dev.type != "cuda":
        raise ValueError(f"prev_depth: the contact kernels take CUDA "
                         f"tensors, got one on {dev}")
    n = payload.shape[0]
    m = n if idx is None else idx.shape[0]
    out = (torch.empty((n,), dtype=torch.float32, device=dev) if idx is None
           else torch.ones((n,), dtype=torch.float32, device=dev))
    if m == 0:
        return out
    hd, wd = prev_depth.shape
    origin, cw = (None, 0) if window is None else window
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launcher("march")(
            prev_depth.data_ptr(), hd, wd, payload.data_ptr(), n,
            None if idx is None else idx.data_ptr(), m,
            None if count is None else count.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if origin is None else origin.data_ptr(), cw,
            out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"contact march launch failed: CUDA error "
                           f"{status}")
    MARCH_LAUNCHES += 1
    return out
