"""Port parity: sparse compaction (funky_tpu_torch/ops/compact.py) against
funky_tpu/ops/compact.py on the same numpy masks.

Tolerance: none. Compaction moves integers and copies values, so indices,
counts, gathered rows and scattered arrays are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.ops import compact as jc

from funky_tpu_torch.ops import compact as tc

from .torch_parity import t2n

I32_MAX = np.iinfo(np.int32).max


def clustered_mask(seed, shape):
    """Blobs plus isolated pixels, like penumbra and contact masks."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    h, w = shape[-2:]
    for _ in range(4):
        y, x = rng.integers(0, h - 6), rng.integers(0, w - 10)
        m[..., y:y + 5, x:x + 9] = rng.random((5, 9)) > 0.3
    m[..., rng.integers(0, h, 6), rng.integers(0, w, 6)] = True
    return m


def same(comp_t, comp_j):
    for name in ("idx", "slot_valid", "count"):
        np.testing.assert_array_equal(t2n(getattr(comp_t, name)),
                                      np.asarray(getattr(comp_j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("capacity", [8, 64, 4096])
@pytest.mark.parametrize("grouped", [False, True])
def test_compact_indices_matches_jax(capacity, grouped):
    """Raster or grouped order, padding and true count, including a
    capacity that overflows; then the gather/scatter round trip."""
    mask = clustered_mask(0, (2, 32, 64))
    gk = np.random.default_rng(1).integers(0, 4, mask.shape).astype(np.int32)
    key_j = jnp.asarray(gk) if grouped else None
    key_t = torch.from_numpy(gk) if grouped else None
    comp_j = jc.compact_indices(jnp.asarray(mask), capacity, group_key=key_j)
    comp_t = tc.compact_indices(torch.from_numpy(mask), capacity,
                                group_key=key_t)
    same(comp_t, comp_j)
    assert int(comp_t.count) == mask.sum()
    if capacity < mask.sum():
        assert int(comp_t.slot_valid.sum()) == capacity

    table = np.random.default_rng(2).random((mask.size, 3)).astype(np.float32)
    rows_j = jc.gather_rows(jnp.asarray(table), comp_j)
    rows_t = tc.gather_rows(torch.from_numpy(table), comp_t)
    np.testing.assert_array_equal(t2n(rows_t), np.asarray(rows_j))
    dense = np.full((mask.size, 3), -1.0, np.float32)
    out_j = jc.scatter_back(jnp.asarray(dense), comp_j, rows_j * 2.0)
    out_t = tc.scatter_back(torch.from_numpy(dense), comp_t, rows_t * 2.0)
    np.testing.assert_array_equal(t2n(out_t), np.asarray(out_j))


def test_group_key_collision_forces_overflow():
    """A selected element keyed INT32_MAX (the padding key) forces the
    count past every capacity, in both packages and both compactions;
    INT32_MAX - 1 stays exact."""
    mask = np.zeros(256, bool)
    mask[7] = mask[100] = True
    key = np.zeros(256, np.int32)
    key[100] = I32_MAX
    comp = tc.compact_indices(torch.from_numpy(mask), 64,
                              group_key=torch.from_numpy(key))
    assert int(comp.count) == I32_MAX
    blocked = tc.compact_indices_blocked(
        torch.from_numpy(mask).reshape(16, 16), 64, 8, 8, 8,
        group_key=torch.from_numpy(key).reshape(16, 16))
    assert int(blocked.comp.count) == I32_MAX
    key[100] = I32_MAX - 1
    comp_t = tc.compact_indices(torch.from_numpy(mask), 64,
                                group_key=torch.from_numpy(key))
    comp_j = jc.compact_indices(jnp.asarray(mask), 64,
                                group_key=jnp.asarray(key))
    same(comp_t, comp_j)
    assert int(comp_t.count) == 2


@pytest.mark.parametrize("block_capacity", [2, 64])
def test_blocked_compaction_same_set(block_capacity):
    """compact_indices_blocked equals JAX's (order included) and selects
    the same element set as compact_indices; a block budget that
    overflows shows in block_count."""
    mask = clustered_mask(3, (2, 32, 64))
    gk = np.random.default_rng(4).integers(0, 4, mask.shape).astype(np.int32)
    bj = jc.compact_indices_blocked(jnp.asarray(mask), 4096, 8, 8,
                                    block_capacity, group_key=jnp.asarray(gk))
    bt = tc.compact_indices_blocked(torch.from_numpy(mask), 4096, 8, 8,
                                    block_capacity,
                                    group_key=torch.from_numpy(gk))
    same(bt.comp, bj.comp)
    np.testing.assert_array_equal(t2n(bt.block_count),
                                  np.asarray(bj.block_count))
    plain = tc.compact_indices(torch.from_numpy(mask), 4096,
                               group_key=torch.from_numpy(gk))
    if block_capacity >= int(bt.block_count):
        got = np.sort(t2n(bt.comp.idx)[t2n(bt.comp.slot_valid)])
        want = np.sort(t2n(plain.idx)[t2n(plain.slot_valid)])
        np.testing.assert_array_equal(got, want)
        keys = gk.ravel()[t2n(bt.comp.idx)[t2n(bt.comp.slot_valid)]]
        assert (np.diff(keys) >= 0).all()
    else:
        assert int(bt.block_count) > block_capacity


@pytest.mark.parametrize("shape", [(32, 64), (2048,), (30, 64)])
@pytest.mark.parametrize("capacity_blocks", [3, 256])
def test_block_compactions_match_jax(shape, capacity_blocks):
    """compact_blocks_any: 8x8 blocks on 2D masks, 64-runs on flat ones,
    None on shapes with neither; overflow counts blocks."""
    mask = clustered_mask(5, (32, 64)).reshape(-1)[:int(np.prod(shape))]
    mask = mask.reshape(shape)
    comp_j = jc.compact_blocks_any(jnp.asarray(mask), capacity_blocks)
    comp_t = tc.compact_blocks_any(torch.from_numpy(mask), capacity_blocks)
    if comp_j is None:
        assert comp_t is None
        return
    same(comp_t, comp_j)


@pytest.mark.parametrize("capacity_blocks", [4, 32])
def test_valid_blocks_gather_scatter_match_jax(capacity_blocks):
    """compact_valid_blocks, pixel_xy, gather_blocks and scatter_blocks:
    the blocked back half's moves, value for value."""
    mask = clustered_mask(6, (32, 64))
    vals = np.random.default_rng(7).random((32, 64, 3)).astype(np.float32)
    bj = jc.compact_valid_blocks(jnp.asarray(mask), 8, 8, capacity_blocks)
    bt = tc.compact_valid_blocks(torch.from_numpy(mask), 8, 8,
                                 capacity_blocks)
    same(bt.comp_b, bj.comp_b)
    assert bool(bt.fits) == bool(bj.fits)
    for a, b in zip(bt.pixel_xy(), bj.pixel_xy()):
        np.testing.assert_array_equal(t2n(a), np.asarray(b))
    gj = jc.gather_blocks(jnp.asarray(vals), bj)
    gt = tc.gather_blocks(torch.from_numpy(vals), bt)
    np.testing.assert_array_equal(t2n(gt), np.asarray(gj))
    base = np.zeros_like(vals)
    sj = jc.scatter_blocks(jnp.asarray(base), bj, gj + 1.0)
    st = tc.scatter_blocks(torch.from_numpy(base), bt, gt + 1.0)
    np.testing.assert_array_equal(t2n(st), np.asarray(sj))


def test_host_cond_counts_branches():
    tc.reset_host_syncs()
    assert tc.host_cond(torch.tensor(True), "a")
    assert not tc.host_cond(torch.tensor(False), "a")
    assert tc.HOST_SYNCS == 2
    assert tc.BRANCHES == {("a", True): 1, ("a", False): 1}
    tc.reset_host_syncs()
    assert tc.HOST_SYNCS == 0 and not tc.BRANCHES
