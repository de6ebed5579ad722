"""HostReads, the guard of the port's tests that a committed frame reads
no device value on the host (so a card can record it as a CUDA graph).
Imports no jax, so the gloo ranks of tests/torch_sharded_worker.py use it
too. Not a test module itself.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch
from torch.overrides import TorchFunctionMode

from funky_tpu_torch.ops import raster as traster


class HostReads(TorchFunctionMode):
    """Records every torch call that copies a tensor's value to the host:
    on a card each of them waits for the device (a host synchronisation).
    Boolean-mask indexing and nonzero need the count of True elements, so
    they wait too, and so does indexing with a Python list, whose indices
    are copied to the card, or with a 0-d integer tensor, which is read
    like a Python int. The plain raster, which stands in for the
    raster kernel on the CPU only, reads its longest bin and is not
    recorded."""

    READS = {"__bool__", "__int__", "__float__", "__index__", "item",
             "tolist", "numpy", "cpu", "nonzero", "argwhere",
             "masked_select", "unique", "unique_consecutive"}

    def __init__(self):
        super().__init__()
        self.reads = []
        self.paused = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if self.paused:
            pass
        elif name in self.READS:
            self.reads.append(name)
        elif name == "where" and len(args) == 1:
            self.reads.append("where(mask)")
        elif name in ("__getitem__", "__setitem__"):
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in index):
                self.reads.append(name + "[mask]")
            # a list index is copied to the card and waited for; a 0-d
            # integer tensor index is read on the host like an int
            if any(isinstance(i, list) for i in index):
                self.reads.append(name + "[list]")
            if any(isinstance(i, torch.Tensor) and i.ndim == 0
                   and not i.dtype.is_floating_point
                   and i.dtype != torch.bool for i in index):
                self.reads.append(name + "[0-d]")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def host_reads():
    """A HostReads guard over the block, with the plain raster's own reads
    left out. Yields the guard; its `reads` list fills as the block runs."""
    reads = HostReads()
    plain = traster._rasterize_torch

    def unrecorded(*args, **kwargs):
        reads.paused = True
        try:
            return plain(*args, **kwargs)
        finally:
            reads.paused = False

    with reads, mock.patch.object(traster, "_rasterize_torch", unrecorded):
        yield reads
