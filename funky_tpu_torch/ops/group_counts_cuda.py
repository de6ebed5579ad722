"""The sparse shadow filter's per-group pair histogram as a hand-written
Hopper kernel, K7 (csrc/group_counts.cu), the card's path of
passes/shadow_filter.py::_group_counts.

K7 replaces the JAX package's per-group masked sums in funky_tpu/passes/
shadow_filter.py::cascaded_shadow_sparse (:714-716, `counts_c`), which
XLA fuses into one reduction on the TPU: each block counts the needed
entries of its share into a shared-memory histogram and adds it to the
output with one atomic per bin. Integer counts do not depend on the
order, so the result equals the plain twin's scatter_add_ exactly. No
value is read on the host, so a committed frame still records as a CUDA
graph. `group_counts` launches the kernel or raises (`check_args` names
the argument); the pass above it takes the plain twin for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# Kernel launches made by group_counts since the last reset.
LAUNCHES = 0

# The most groups the kernel's shared histogram holds.
MAX_GROUPS = 64

_FN = None
_SMS: dict = {}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = cuda_build.load("group_counts").group_counts_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, ll, i, p, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def check_args(needs: torch.Tensor, group_key: torch.Tensor,
               n_groups: int) -> None:
    """Raises, naming the argument, on a call the kernel does not take.
    Reads only types, shapes, strides and devices, never a value, so it
    runs on the CPU as well."""
    for name, t, dtype in (("needs", needs, torch.bool),
                           ("group_key", group_key, torch.int32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if group_key.device != needs.device:
        raise ValueError(f"group_key: on {group_key.device}, needs on "
                         f"{needs.device}")
    if group_key.shape != needs.shape:
        raise ValueError(f"group_key: shape {tuple(group_key.shape)}, needs "
                         f"{tuple(needs.shape)}")
    if not isinstance(n_groups, int) or not 1 <= n_groups <= MAX_GROUPS:
        raise ValueError(f"n_groups: {n_groups!r}, expected an int in "
                         f"[1, {MAX_GROUPS}]")


def group_counts(needs: torch.Tensor, group_key: torch.Tensor,
                 n_groups: int) -> torch.Tensor:
    """(n_groups,) int32: how many entries with `needs` set each key in
    [0, n_groups) holds; _group_counts' contract."""
    global LAUNCHES
    check_args(needs, group_key, n_groups)
    dev = needs.device
    if dev.type != "cuda":
        raise ValueError(f"needs: the histogram kernel takes CUDA tensors, "
                         f"got one on {dev}")
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty((n_groups,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launcher()(needs.data_ptr(), group_key.data_ptr(),
                             needs.numel(), n_groups, out.data_ptr(),
                             _SMS[dev], stream)
    if status != 0:
        raise RuntimeError(f"group histogram launch failed: CUDA error "
                           f"{status}")
    LAUNCHES += 1
    return out
