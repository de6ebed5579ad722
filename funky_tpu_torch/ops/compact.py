"""Sparse compaction (port of funky_tpu/ops/compact.py::compact_indices;
the block and grouped variants belong to the sparse path, not ported yet).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Compacted(NamedTuple):
    idx: torch.Tensor         # (capacity,) int32 flat indices, -1 padding
    slot_valid: torch.Tensor  # (capacity,) bool
    count: torch.Tensor       # () int32 true number of masked elements


def compact_indices(mask: torch.Tensor, capacity: int) -> Compacted:
    """First `capacity` True positions of `mask` (flattened) in raster
    order, padded with -1 (compact.py:45-83, group_key=None)."""
    flat = mask.reshape(-1)
    n = flat.shape[0]
    capacity = min(capacity, n)
    count = flat.sum(dtype=torch.int32)
    # Stable argsort of (not mask) on an integer tensor: True sorts first
    # and keeps raster order, as jnp.argsort(~flat, stable=True) does.
    order = torch.argsort((~flat).to(torch.int32), stable=True)
    order = order[:capacity].to(torch.int32)
    slot_valid = torch.arange(capacity, dtype=torch.int32,
                              device=mask.device) < torch.clamp(
                                  count, max=capacity)
    return Compacted(idx=torch.where(slot_valid, order, -1),
                     slot_valid=slot_valid, count=count)
