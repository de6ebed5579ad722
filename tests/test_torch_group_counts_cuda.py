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

from funky_tpu_torch.ops import group_counts_cuda
from funky_tpu_torch.passes import shadow_filter as tsf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


@pytest.mark.parametrize("shape", [(2, 1080, 1920), (2, 4097), (2, 1),
                                   (2, 0)], ids=str)
@pytest.mark.parametrize("n_groups", [4, 16, 64])
@pytest.mark.parametrize("p_need", [0.0, 0.03, 1.0])
def test_kernel_equal_to_plain(dev, shape, n_groups, p_need):
    """Random keys and needs at the 1080p frame's shape, a ragged length
    (the kernel's 4-entry loads and its tail), one entry and none; no, a
    few and all entries needed."""
    rng = np.random.default_rng(n_groups)
    needs = torch.from_numpy(rng.random(shape) < p_need).to(dev)
    key = torch.from_numpy(rng.integers(0, n_groups, shape)
                           .astype(np.int32)).to(dev)
    before = group_counts_cuda.LAUNCHES
    got = tsf._group_counts(needs, key, n_groups)
    torch.cuda.synchronize()
    assert group_counts_cuda.LAUNCHES - before == 1
    want = tsf._group_counts_plain(needs, key, n_groups)
    assert got.dtype == torch.int32 and got.shape == (n_groups,)
    assert torch.equal(got, want)


def test_unaligned_needs(dev):
    """A needs view one byte past an aligned start takes the kernel's
    byte-wise path."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.random(2 * 5001) < 0.5).to(dev)
    needs = base[1:2 * 5000 + 1].reshape(2, 5000)
    key = torch.from_numpy(rng.integers(0, 12, (2, 5000)).astype(np.int32)
                           ).to(dev)
    assert torch.equal(tsf._group_counts(needs, key, 12),
                       tsf._group_counts_plain(needs, key, 12))


def test_in_graph(dev):
    """The launch (its memset and kernel) records into a CUDA graph and
    counts the buffers' current values on each replay."""
    needs = torch.zeros((2, 4096), dtype=torch.bool, device=dev)
    key = torch.zeros((2, 4096), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = group_counts_cuda.group_counts(needs, key, 8)
    rng = np.random.default_rng(1)
    for p in (0.1, 0.7):
        needs.copy_(torch.from_numpy(rng.random((2, 4096)) < p))
        key.copy_(torch.from_numpy(rng.integers(0, 8, (2, 4096))
                                   .astype(np.int32)))
        graph.replay()
        assert torch.equal(out, tsf._group_counts_plain(needs, key, 8))


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
