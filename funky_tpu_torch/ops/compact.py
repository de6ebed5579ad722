"""Sparse compaction (port of funky_tpu/ops/compact.py): evaluate an
expensive per-element function on only the elements that need it.

    mask -> compact_indices -> gather payload rows -> evaluate on the
    (capacity,)-shaped batch -> scatter_back into the dense result.

Capacities are static, as in JAX: `count` may exceed the capacity, and
every caller then takes its exact dense fallback. The JAX package picks
between the two with `lax.cond`; eager PyTorch reads the overflow test on
the host (`host_cond`), one synchronisation per such branch, counted in
HOST_SYNCS.

Scatters write padding slots to one extra row past the end and drop it,
which is what JAX's `.at[idx].set(mode="drop")` does with an
out-of-range index, without a data-dependent shape (no host sync).
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from .sampling import take_rows

_INT32_MAX = 2147483647

# Host synchronisations taken by host_cond since the last reset; how often
# each site took each branch, {(site, took_sparse): count}; and the
# occupancy each site read with its branch, {site: [((count, capacity),
# ...) per call]}.
HOST_SYNCS = 0
BRANCHES: collections.Counter = collections.Counter()
OCCUPANCY: dict = collections.defaultdict(list)


def reset_host_syncs() -> None:
    global HOST_SYNCS
    HOST_SYNCS = 0
    BRANCHES.clear()
    OCCUPANCY.clear()


def host_cond(ok: torch.Tensor, site: str, occupancy=()) -> bool:
    """The JAX package's `lax.cond(ok, sparse, dense)` as a host branch:
    reads one device bool (a synchronisation) and counts it under `site`.
    `occupancy` pairs (count tensor, static capacity) ride the same read
    into OCCUPANCY. An algorithmic fallback, not an error path."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    vals = torch.stack([ok.reshape(()).to(torch.int64)]
                       + [c.reshape(()).to(torch.int64)
                          for c, _ in occupancy]).tolist()
    taken = bool(vals[0])
    BRANCHES[(site, taken)] += 1
    OCCUPANCY[site].append(tuple(
        (n, cap) for n, (_, cap) in zip(vals[1:], occupancy)))
    return taken


class Compacted(NamedTuple):
    idx: torch.Tensor         # (capacity,) int32 flat indices, -1 padding
    slot_valid: torch.Tensor  # (capacity,) bool
    count: torch.Tensor       # () int32 true number of masked elements


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _finish(order: torch.Tensor, count: torch.Tensor, capacity: int,
            device) -> Compacted:
    slot_valid = _arange(capacity, device) < torch.clamp(count, max=capacity)
    return Compacted(idx=torch.where(slot_valid, order, -1),
                     slot_valid=slot_valid, count=count)


def compact_indices(mask: torch.Tensor, capacity: int,
                    group_key: torch.Tensor | None = None) -> Compacted:
    """First `capacity` True positions of `mask` (flattened) in raster
    order, or grouped by `group_key` then raster order, padded with -1
    (compact.py:45-83). A selected element whose key is INT32_MAX (the
    padding key) forces `count` to INT32_MAX, past any capacity, so the
    caller takes its dense fallback."""
    flat = mask.reshape(-1)
    n = flat.shape[0]
    capacity = min(capacity, n)
    count = flat.sum(dtype=torch.int32)
    if group_key is None:
        # Stable argsort of (not mask): True sorts first in raster order.
        order = torch.argsort((~flat).to(torch.int32), stable=True)
    else:
        gk = group_key.reshape(-1).to(torch.int32)
        key = torch.where(flat, gk, _INT32_MAX)
        order = torch.argsort(key, stable=True)
        count = torch.where((flat & (gk == _INT32_MAX)).any(),
                            _INT32_MAX, count).to(torch.int32)
    order = order[:capacity].to(torch.int32)
    return _finish(order, count, capacity, mask.device)


def compact_blocks(mask: torch.Tensor, bh: int, bw: int,
                   capacity_blocks: int) -> Compacted:
    """Whole-block compaction of a 2D mask (compact.py:86-110): every
    (bh, bw) block with any True pixel expands to all its pixel indices.
    `count` is the true BLOCK count."""
    h, w = mask.shape
    assert h % bh == 0 and w % bw == 0
    gh, gw = h // bh, w // bw
    bm = mask.reshape(gh, bh, gw, bw).any(dim=3).any(dim=1)
    comp_b = compact_indices(bm, capacity_blocks)
    safe = comp_b.idx.clamp(min=0)
    by = safe // gw
    bx = safe % gw
    dev = mask.device
    py = by[:, None, None] * bh + _arange(bh, dev)[None, :, None]
    px = bx[:, None, None] * bw + _arange(bw, dev)[None, None, :]
    idx = (py * w + px).reshape(-1)
    slot_valid = torch.repeat_interleave(comp_b.slot_valid, bh * bw)
    return Compacted(idx=torch.where(slot_valid, idx, -1),
                     slot_valid=slot_valid, count=comp_b.count)


class BlockedCompacted(NamedTuple):
    comp: Compacted           # element-level result (original flat domain)
    block_count: torch.Tensor  # () int32 true candidate-block count


def compact_indices_blocked(mask: torch.Tensor, capacity: int,
                            bh: int, bw: int, block_capacity: int,
                            group_key: torch.Tensor | None = None
                            ) -> BlockedCompacted:
    """Two-level compaction (compact.py:120-170): compact the
    (bh, bw)-block-any grid first, then the elements inside the candidate
    blocks. Selects the same element set as compact_indices (block-major
    order); blocks past block_capacity are dropped, so callers treat
    `block_count > block_capacity` as overflow."""
    *lead, h, w = mask.shape
    assert h % bh == 0 and w % bw == 0
    gh, gw = h // bh, w // bw
    bm = mask.reshape(*lead, gh, bh, gw, bw).any(dim=-1).any(dim=-2)
    comp_b = compact_indices(bm, block_capacity)
    dev = mask.device

    safe = comp_b.idx.clamp(min=0)
    li = safe // (gh * gw)
    bi = safe % (gh * gw)
    by = bi // gw
    bx = bi % gw
    base = (li * h + by * bh) * w + bx * bw
    within = (_arange(bh, dev)[:, None] * w + _arange(bw, dev)[None, :])
    cand = (base[:, None, None] + within[None]).reshape(-1)
    cand_valid = torch.repeat_interleave(comp_b.slot_valid, bh * bw)
    cand_safe = cand.clamp(min=0)

    flat = mask.reshape(-1)
    m = take_rows(flat, cand_safe) & cand_valid
    capacity = min(capacity, cand.shape[0])
    count = flat.sum(dtype=torch.int32)
    if group_key is None:
        order = torch.argsort((~m).to(torch.int32), stable=True)
    else:
        gk = take_rows(group_key.reshape(-1).to(torch.int32), cand_safe)
        key = torch.where(m, gk, _INT32_MAX)
        order = torch.argsort(key, stable=True)
        count = torch.where((m & (gk == _INT32_MAX)).any(), _INT32_MAX,
                            count).to(torch.int32)
    order = order[:capacity]
    comp = _finish(cand[order], count, capacity, dev)
    return BlockedCompacted(comp=comp, block_count=comp_b.count)


class BlockCompaction(NamedTuple):
    """Block-level compaction of a 2D domain into contiguous block-major
    runs (compact.py:173-208): the flat compacted domain has shape
    (capacity_blocks * bh * bw,), each block's pixels contiguous."""
    comp_b: Compacted        # block-level indices into the (gh*gw) grid
    gh: int
    gw: int
    bh: int
    bw: int

    @property
    def block_len(self) -> int:
        return self.bh * self.bw

    @property
    def capacity_blocks(self) -> int:
        return self.comp_b.idx.shape[0]

    @property
    def fits(self) -> torch.Tensor:
        return self.comp_b.count <= self.capacity_blocks

    def pixel_xy(self):
        """Per-slot pixel coords (x, y) in the source 2D domain and the
        slot-valid mask, each (capacity_blocks * bh * bw,)."""
        safe = self.comp_b.idx.clamp(min=0)
        by = safe // self.gw
        bx = safe % self.gw
        j = _arange(self.block_len, safe.device)
        px = (bx[:, None] * self.bw + j[None] % self.bw).reshape(-1)
        py = (by[:, None] * self.bh + j[None] // self.bw).reshape(-1)
        valid = torch.repeat_interleave(self.comp_b.slot_valid,
                                        self.block_len)
        return px, py, valid


def compact_valid_blocks(mask: torch.Tensor, bh: int, bw: int,
                         capacity_blocks: int) -> BlockCompaction:
    """Every (bh, bw) block of the 2D `mask` with any True pixel gets a
    slot, in block-raster order (compact.py:211-221)."""
    h, w = mask.shape
    assert h % bh == 0 and w % bw == 0
    gh, gw = h // bh, w // bw
    bm = mask.reshape(gh, bh, gw, bw).any(dim=3).any(dim=1)
    comp_b = compact_indices(bm, capacity_blocks)
    return BlockCompaction(comp_b=comp_b, gh=gh, gw=gw, bh=bh, bw=bw)


def _to_block_rows(a: torch.Tensor, bc: BlockCompaction) -> torch.Tensor:
    """(h, w, ...) -> (gh*gw, bh*bw*C) block-major row table."""
    cc = int(np.prod(a.shape[2:])) if a.ndim > 2 else 1
    t = a.reshape(bc.gh, bc.bh, bc.gw, bc.bw, cc)
    return t.permute(0, 2, 1, 3, 4).reshape(bc.gh * bc.gw,
                                            bc.block_len * cc)


def gather_blocks(a: torch.Tensor, bc: BlockCompaction) -> torch.Tensor:
    """The compacted blocks of a (h, w, ...) array as a flat block-major
    (capacity_blocks * bh * bw, ...) array, one gathered row per block
    (compact.py:232-238)."""
    rows = take_rows(_to_block_rows(a, bc), bc.comp_b.idx.clamp(min=0))
    return rows.reshape((bc.capacity_blocks * bc.block_len,)
                        + tuple(a.shape[2:]))


def _set_rows_drop(table: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """table.at[idx].set(values, mode="drop") for idx in [-n, n]: row n is
    a scratch row that padding slots write to, cut off afterwards. As in
    JAX, a negative index counts from the end: a committed frame whose
    group segment runs past its compaction writes its -1 slots to the last
    row, and the port reproduces that artifact."""
    n = table.shape[0]
    out = torch.cat([table, table[:1]])
    idx = idx.long()
    out[torch.where(idx < 0, idx + n, idx)] = values.to(out.dtype)
    return out[:n]


def scatter_blocks(base: torch.Tensor, bc: BlockCompaction,
                   values: torch.Tensor) -> torch.Tensor:
    """Scatter flat block-major `values` into the dense (h, w, ...) `base`
    at the compacted blocks; padding slots are dropped
    (compact.py:241-253)."""
    t = _to_block_rows(base, bc)
    vals = values.reshape(bc.capacity_blocks, -1)
    nb = bc.gh * bc.gw
    idx = torch.where(bc.comp_b.slot_valid, bc.comp_b.idx, nb)
    t = _set_rows_drop(t, idx, vals)
    cc = int(np.prod(base.shape[2:])) if base.ndim > 2 else 1
    out = t.reshape(bc.gh, bc.gw, bc.bh, bc.bw, cc).permute(0, 2, 1, 3, 4)
    return out.reshape(base.shape)


def compact_flat_blocks(mask: torch.Tensor, block: int,
                        capacity_blocks: int) -> Compacted:
    """1D analogue of compact_blocks for block-major flat domains
    (compact.py:256-270): every `block`-run with any True element expands
    to all its indices. `count` is the true block count."""
    n = mask.shape[0]
    assert n % block == 0
    bm = mask.reshape(n // block, block).any(dim=1)
    comp_b = compact_indices(bm, capacity_blocks)
    safe = comp_b.idx.clamp(min=0)
    idx = (safe[:, None] * block
           + _arange(block, mask.device)[None]).reshape(-1)
    slot_valid = torch.repeat_interleave(comp_b.slot_valid, block)
    return Compacted(idx=torch.where(slot_valid, idx, -1),
                     slot_valid=slot_valid, count=comp_b.count)


def compact_blocks_any(mask: torch.Tensor,
                       capacity_blocks: int) -> Compacted | None:
    """8x8 spatial blocks on 2D masks, 64-runs on flat block-major masks,
    None when the shape has neither (compact.py:273-284)."""
    if (mask.ndim == 2 and mask.shape[0] % 8 == 0
            and mask.shape[1] % 8 == 0):
        return compact_blocks(mask, 8, 8, capacity_blocks)
    if mask.ndim == 1 and mask.shape[0] % 64 == 0:
        return compact_flat_blocks(mask, 64, capacity_blocks)
    return None


def gather_rows(table: torch.Tensor, comp: Compacted) -> torch.Tensor:
    """Payload rows of the compacted elements; padding slots fetch row 0
    (compact.py:287-291)."""
    return take_rows(table, comp.idx.clamp(min=0))


def scatter_back(dense: torch.Tensor, comp: Compacted,
                 values: torch.Tensor) -> torch.Tensor:
    """Write per-slot `values` (capacity, ...) into flat-first-dim `dense`
    at the compacted indices, dropping padding slots; returns a new tensor
    of dense's shape (compact.py:294-304)."""
    flat = dense.reshape((-1,) + tuple(values.shape[1:]))
    idx = torch.where(comp.slot_valid, comp.idx, flat.shape[0])
    return _set_rows_drop(flat, idx, values).reshape(dense.shape)
