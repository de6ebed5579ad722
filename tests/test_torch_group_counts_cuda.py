"""The pair histogram kernel K7 (funky_tpu_torch/csrc/group_counts.cu
through ops/group_counts_cuda.py::group_counts) against its plain twin
(passes/shadow_filter.py::_group_counts_plain), on the card. Every test
here needs an NVIDIA GPU and skips without one (the shipped frame's graph
with K7 inside is tests/test_torch_pair_taps_cuda.py's). The module
imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_group_counts_cuda.py

Tolerance: none; the counts are integers, and integer sums do not depend
on the order of the atomics.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from funky_tpu_torch.ops import group_counts_cuda
from funky_tpu_torch.passes import shadow_filter as tsf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def case(rng, shape, n_groups, p_need, dev):
    needs = torch.from_numpy(rng.random(shape) < p_need).to(dev)
    key = torch.from_numpy(rng.integers(0, n_groups, shape)
                           .astype(np.int32)).to(dev)
    return needs, key


@pytest.mark.parametrize("shape", [(2, 1080, 1920), (2, 4097), (2, 1),
                                   (2, 0)], ids=str)
@pytest.mark.parametrize("n_groups", [4, 16, 64])
@pytest.mark.parametrize("p_need", [0.0, 0.03, 1.0])
def test_kernel_equal_to_plain(dev, shape, n_groups, p_need):
    """Random keys and needs at the 1080p frame's shape, a ragged length
    (the kernel's 16-entry loads and its tail), one entry and none; no, a
    few and all entries needed."""
    needs, key = case(np.random.default_rng(n_groups), shape, n_groups,
                      p_need, dev)
    before = group_counts_cuda.LAUNCHES
    got = tsf._group_counts(needs, key, n_groups)
    torch.cuda.synchronize()
    assert group_counts_cuda.LAUNCHES - before == 1
    want = tsf._group_counts_plain(needs, key, n_groups)
    assert got.dtype == torch.int32 and got.shape == (n_groups,)
    assert torch.equal(got, want)


def test_unaligned_needs(dev):
    """A needs view one byte past an aligned start: the kernel's scalar
    head up to the 16-byte boundary, then 16-entry loads."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.random(2 * 5001) < 0.5).to(dev)
    needs = base[1:2 * 5000 + 1].reshape(2, 5000)
    key = torch.from_numpy(rng.integers(0, 12, (2, 5000)).astype(np.int32)
                           ).to(dev)
    assert torch.equal(tsf._group_counts(needs, key, 12),
                       tsf._group_counts_plain(needs, key, 12))


@pytest.mark.parametrize("offset", [1, 7, 15])
@pytest.mark.parametrize("n", [1, 5, 16, 17, 31, 4097])
def test_unaligned_and_short(dev, offset, n):
    """Views 1, 7 and 15 bytes past a 16-byte boundary, from one entry to
    a ragged length: lengths within the head, a head and a tail with no
    16-entry load between, and both around whole loads."""
    rng = np.random.default_rng(offset * 10_000 + n)
    base = torch.from_numpy(rng.random(n + 16) < 0.6).to(dev)
    needs = base[offset:offset + n]
    assert needs.data_ptr() % 16 == offset
    key = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)).to(dev)
    assert torch.equal(tsf._group_counts(needs, key, 9),
                       tsf._group_counts_plain(needs, key, 9))


def test_calls_in_a_row(dev):
    """Three calls one after another with other group counts and lengths:
    each equals the twin, so the last block of each launch left the
    accumulators and the ticket at zero for the next."""
    rng = np.random.default_rng(3)
    for shape, n_groups in (((2, 1080, 1920), 8), ((2, 4097), 64),
                            ((2, 33), 3)):
        needs, key = case(rng, shape, n_groups, 0.3, dev)
        before = group_counts_cuda.LAUNCHES
        got = group_counts_cuda.group_counts(needs, key, n_groups)
        assert group_counts_cuda.LAUNCHES - before == 1
        assert torch.equal(got, tsf._group_counts_plain(needs, key,
                                                        n_groups))


def test_one_kernel_node(dev):
    """A call records as one kernel node in a CUDA graph: no memset."""
    needs, key = case(np.random.default_rng(4), (2, 4096), 8, 0.5, dev)
    assert chip_smoke.graph_node_kinds(
        lambda: group_counts_cuda.group_counts(needs, key, 8)) == {
            "kernel": 1}


def test_first_call_in_capture_raises(dev, monkeypatch):
    """The device's accumulators are made at its first call, eagerly: a
    first call inside a capture raises, naming the warm-up it needs."""
    monkeypatch.setattr(group_counts_cuda, "_ACC", {})
    needs = torch.zeros((2, 64), dtype=torch.bool, device=dev)
    key = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="eagerly before the capture"):
        with torch.cuda.graph(graph):
            group_counts_cuda.group_counts(needs, key, 8)
    assert group_counts_cuda._ACC == {}
    assert torch.equal(group_counts_cuda.group_counts(needs, key, 8),
                       torch.zeros(8, dtype=torch.int32, device=dev))


def test_in_graph(dev):
    """The launch records into a CUDA graph (after the eager first call
    that makes the accumulators) and counts the buffers' current values
    on each of three replays, with an eager call between replays."""
    needs = torch.zeros((2, 4096), dtype=torch.bool, device=dev)
    key = torch.zeros((2, 4096), dtype=torch.int32, device=dev)
    group_counts_cuda.group_counts(needs, key, 8)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = group_counts_cuda.group_counts(needs, key, 8)
    rng = np.random.default_rng(1)
    for p in (0.1, 0.7, 1.0):
        needs.copy_(torch.from_numpy(rng.random((2, 4096)) < p))
        key.copy_(torch.from_numpy(rng.integers(0, 8, (2, 4096))
                                   .astype(np.int32)))
        graph.replay()
        assert torch.equal(out, tsf._group_counts_plain(needs, key, 8))
        e_needs, e_key = case(rng, (3, 1001), 5, p, dev)
        assert torch.equal(group_counts_cuda.group_counts(e_needs, e_key, 5),
                           tsf._group_counts_plain(e_needs, e_key, 5))


def test_wrong_arguments_raise(dev):
    """A CUDA call the kernel cannot take raises; it never falls back."""
    needs = torch.zeros((2, 64), dtype=torch.bool, device=dev)
    key = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="^group_key:"):
        tsf._group_counts(needs, key.long(), 8)
    with pytest.raises(ValueError, match="^n_groups:"):
        tsf._group_counts(needs, key, 65)
    with pytest.raises(ValueError, match="^group_key:"):
        tsf._group_counts(needs, key.cpu(), 8)
