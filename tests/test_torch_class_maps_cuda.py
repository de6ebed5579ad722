"""The class-map kernel K10 (funky_tpu_torch/csrc/class_maps.cu through
ops/class_maps_cuda.py::class_rows) against its plain twin
(passes/shadow_classify.py::_class_rows_plain), on the card. Every test
here needs an NVIDIA GPU and skips without one. The module imports no
jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_class_maps_cuda.py

Tolerance: none; the rows are compared bit for bit (min and max are
exact, the map is taken plus 0.0 by both, the subtractions and the plane
are the same rounded operations).
"""

import pytest
import torch

from funky_tpu_torch.ops import class_maps_cuda
from funky_tpu_torch.passes import shadow_classify as tcls
from tests.torch_scenes import random_planes, relief_maps

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def rows_equal(a, b) -> bool:
    ok = torch.equal(a.view(torch.int32), b.view(torch.int32))
    if not ok:
        bad = (a.view(torch.int32) != b.view(torch.int32)).nonzero()[:8]
        ai, bi = a.view(torch.int32), b.view(torch.int32)
        for r, c in bad.tolist():
            print(f"row {r} column {c}: kernel {a[r, c].item()!r} "
                  f"{ai[r, c].item():#010x}, twin {b[r, c].item()!r} "
                  f"{bi[r, c].item():#010x}")
    return ok


@pytest.mark.parametrize("l,s,coarse", [
    (4, 2048, 16),      # the shipped frame (pooled, 4 x 4 cells a tile)
    (4, 2048, 8),       # GltfConfig()'s default coarse
    (2, 1024, 16),      # the CPU tests' frames
    (2, 256, 8),        # a ragged tile grid is not reachable here: 32 / 8
    (2, 250, 5),        # full-resolution branch, odd coarse
    (2, 129, 3),        # full-resolution branch, odd S: u by the reciprocal
    (1, 16, 8),         # the dry run's 16^2 maps: every window past the edge
    (3, 96, 16),        # 6 cells a side: the last tile of 4 runs past
], ids=str)
@pytest.mark.parametrize("softness", [4.0, 2.0])
def test_kernel_equal_to_plain(dev, l, s, coarse, softness):
    """Relief maps (BORDER_DEPTH blocks on the edges, +/-0, equal runs, a
    step) with sloped planes: K10 == the twin bit for bit in both
    branches, rise windows 18 and 10, one launch a call."""
    maps = torch.from_numpy(relief_maps(s + coarse, l, s)).to(dev)
    planes = torch.from_numpy(random_planes(s, l)).to(dev)
    before = class_maps_cuda.LAUNCHES
    got = tcls.build_class_maps(maps, coarse, softness, planes).cell_rows
    torch.cuda.synchronize()
    assert class_maps_cuda.LAUNCHES - before == 1
    eps = planes.abs().sum(dim=-1) * 4e-7 + 2e-7
    want = tcls._class_rows_plain(maps, coarse, softness, planes, eps)
    assert got.shape == want.shape == (l * (s // coarse) ** 2, 8)
    assert rows_equal(got, want)


@pytest.mark.parametrize("planes", ["zero", "none", "degenerate"])
def test_planes(dev, planes):
    """Zero planes, planes=None (made inside) and a degenerate light's
    non-finite planes (NaN residual columns): equal bit for bit."""
    maps = torch.from_numpy(relief_maps(3, 4, 512)).to(dev)
    p = {"zero": torch.zeros((4, 3), device=dev), "none": None,
         "degenerate": torch.tensor([[float("inf"), 0.0, 0.5],
                                     [float("nan"), 0.1, 0.5],
                                     [0.0, 0.0, 0.5], [0.01, -0.02, 0.4]],
                                    device=dev)}[planes]
    got = tcls.build_class_maps(maps, 16, 4.0, p)
    eps = got.planes.abs().sum(dim=-1) * 4e-7 + 2e-7
    want = tcls._class_rows_plain(maps, 16, 4.0, got.planes, eps)
    assert rows_equal(got.cell_rows, want)


def test_strided_planes_and_offset_maps(dev):
    """Planes as a strided view (the frame's solve_ex result) and maps
    that are a contiguous slice of a larger buffer."""
    big = torch.from_numpy(relief_maps(5, 6, 256)).to(dev)
    maps = big[1:5]
    planes = torch.from_numpy(random_planes(5, 8)).to(dev).reshape(4, 6)[
        :, :3]
    assert not planes.is_contiguous() and planes.stride(1) == 1
    got = tcls.build_class_maps(maps, 8, 4.0, planes).cell_rows
    eps = planes.abs().sum(dim=-1) * 4e-7 + 2e-7
    assert rows_equal(got, tcls._class_rows_plain(maps, 8, 4.0, planes, eps))


@pytest.mark.parametrize("coarse,tc", [(16, 1), (16, 2), (16, 3), (8, 8),
                                       (8, 5)])
def test_every_tile_size(dev, coarse, tc, monkeypatch):
    """K10 at tiles of 1, 2, 3 and 8 cells, and 5 (a ragged last tile),
    forced by replacing tile_cells: the rows do not depend on the tile."""
    maps = torch.from_numpy(relief_maps(9, 2, 512)).to(dev)
    planes = torch.from_numpy(random_planes(9, 2)).to(dev)
    eps = planes.abs().sum(dim=-1) * 4e-7 + 2e-7
    want = tcls._class_rows_plain(maps, coarse, 4.0, planes, eps)
    monkeypatch.setattr(class_maps_cuda, "tile_cells", lambda *a: tc)
    got = class_maps_cuda.class_rows(maps, coarse, 18, planes, eps)
    assert rows_equal(got, want)


def test_graph_replay(dev):
    """One call recorded as a CUDA graph and replayed on new maps copied
    into its input: == the twin on the new maps."""
    maps = torch.from_numpy(relief_maps(1, 4, 1024)).to(dev)
    planes = torch.from_numpy(random_planes(1, 4)).to(dev)
    eps = planes.abs().sum(dim=-1) * 4e-7 + 2e-7
    class_maps_cuda.class_rows(maps, 16, 18, planes, eps)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = class_maps_cuda.class_rows(maps, 16, 18, planes, eps)
    maps.copy_(torch.from_numpy(relief_maps(2, 4, 1024)).to(dev))
    graph.replay()
    torch.cuda.synchronize()
    assert rows_equal(out, tcls._class_rows_plain(maps, 16, 4.0, planes,
                                                  eps))
