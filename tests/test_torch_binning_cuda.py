"""The binning kernel K12 (funky_tpu_torch/csrc/binning.cu) against its
plain twin ops/binning.py::bin_triangles on the card, and the rastered
frame's route through it: K1 on K12's bins, with the pre-gather and K2
only past ops/raster.py's TABLE_LIMIT_BYTES. Every test here needs an
NVIDIA GPU and skips without one. The module imports no jax, so it runs
where jax is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_binning_cuda.py

Tolerance: none. Bins, counts and drops are integers; the tile ranges are
computed with the twin's f32 operations, and the frames run the same
raster kernels on the same lists. The twin on the card divides by a tile
size as a product with its reciprocal, which equals the division for the
power-of-two tiles the frames use; the 5x6 tiles are held against the
twin on the CPU, which divides.
"""

import pathlib
import tempfile

import numpy as np
import pytest
import torch

from funky_tpu_torch import frame
from funky_tpu_torch.models.gltf import GltfScene
from funky_tpu_torch.models.scene import build_device_scene
from funky_tpu_torch.ops import binning, binning_cuda, raster, raster_cuda
from funky_tpu_torch.ops.binning import TriangleSetup
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.utils import profiling

from .torch_scenes import (BINNING_CASES, binning_case, build_large_glb,
                           random_clip_scene)

pytestmark = pytest.mark.cuda

COUNTER = "raster.capacity"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def dropped(fn, device):
    """(fn()'s result, what it added to the COUNTER drop counter)."""
    before = profiling.drop_counts(device)[COUNTER]
    out = fn()
    return out, profiling.drop_counts(device)[COUNTER] - before


def assert_same_bins(setup, args, dev):
    """K12 on the card == the twin (on the card for power-of-two tiles,
    on the CPU always): bins, counts and drops; one launch."""
    before = binning_cuda.LAUNCHES
    (bins, counts), drops = dropped(
        lambda: binning_cuda.bin_triangles(setup, *args, drops=COUNTER), dev)
    assert binning_cuda.LAUNCHES - before == 1
    twins = [TriangleSetup(setup.data.cpu(), setup.valid.cpu())]
    th, tw = args[2], args[3]
    if th & (th - 1) == 0 and tw & (tw - 1) == 0:
        twins.append(setup)
    for twin_setup in twins:
        device = twin_setup.data.device
        (t_bins, t_counts), t_drops = dropped(
            lambda: binning.bin_triangles(twin_setup, *args, drops=COUNTER),
            device)
        assert torch.equal(bins.cpu(), t_bins.cpu())
        assert torch.equal(counts.cpu(), t_counts.cpu())
        assert drops == t_drops
    return bins, counts, drops


@pytest.mark.parametrize("name", sorted(BINNING_CASES))
def test_kernel_equals_twin(dev, name):
    """The cases of tests/torch_scenes.BINNING_CASES: the main pass's
    32x128 tiles over 1920x1080, the cascades' 128x256 over 2048^2, slabs
    at a y_offset, capacities below the fullest tile, fewer rows than the
    capacity, none, a capacity of 0, 8-row tiles, a ragged last chunk and
    5x6 tiles; AABBs on tile edges and on the right and bottom edges,
    invalid rows with an AABB, NaN, +/-inf and out-of-range corners."""
    width, sh, th, tw, t, cap, y0 = BINNING_CASES[name]
    data, valid = binning_case(name, seed=11)
    setup = TriangleSetup(torch.from_numpy(data).to(dev),
                          torch.from_numpy(valid).to(dev))
    _, counts, drops = assert_same_bins(
        setup, (width, sh, th, tw, t if cap is None else cap, y0), dev)
    if name.startswith("tight"):
        assert drops > 0 and int(counts.max()) == cap


@pytest.mark.parametrize("shape", [(1920, 1080, 32, 128), (2048, 2048, 128,
                                                           256),
                                   (256, 128, 8, 128)], ids=str)
@pytest.mark.parametrize("capacity", [None, 16])
def test_kernel_on_triangle_setups(dev, shape, capacity):
    """Setups made by triangle_setup_corners on the card: random
    triangles with a zero-area one, a w <= eps one and NaN corners (all
    invalid), at the main pass's, the cascades' and 8-row tiles, with
    every row's capacity and one below the fullest tile."""
    width, height, th, tw = shape
    clip, tris = random_clip_scene(seed=5, n_tris=3000, width=width,
                                   height=height)
    clip[30:33, 0] = np.nan
    tri_clip = torch.from_numpy(clip).to(dev)[torch.from_numpy(tris).to(
        dev).long()]
    setup = binning.triangle_setup_corners(tri_clip, width, height)
    assert not setup.valid[[1, 3, 10]].any()
    cap = len(tris) if capacity is None else capacity
    _, counts, drops = assert_same_bins(setup, (width, height, th, tw, cap,
                                                0), dev)
    assert (drops > 0) == (capacity is not None)


@pytest.mark.parametrize("name", ["main", "cascade", "rows8", "no_rows"])
def test_counts_alone_equal_stats(dev, name):
    """bin_counts (the count and scan kernels alone) == the twin's counts
    at a capacity of every row, and raster.bin_occupancy on the card
    (which takes it under "auto") == binning._stats on the CPU (the
    twin); one launch each, and none under the "torch" backend."""
    width, sh, th, tw, _, _, y0 = BINNING_CASES[name]
    data, valid = binning_case(name, seed=12)
    cpu = TriangleSetup(torch.from_numpy(data), torch.from_numpy(valid))
    setup = TriangleSetup(cpu.data.to(dev), cpu.valid.to(dev))
    before = binning_cuda.LAUNCHES
    counts = binning_cuda.bin_counts(setup, width, sh, th, tw)
    got = raster.bin_occupancy(setup, width, sh, RasterConfig(tile_h=th,
                                                             tile_w=tw))
    assert binning_cuda.LAUNCHES - before == 2
    plain = raster.bin_occupancy(setup, width, sh, RasterConfig(
        tile_h=th, tile_w=tw, backend="torch"))
    assert binning_cuda.LAUNCHES - before == 2
    assert int(plain["max"]) == int(got["max"])
    _, want = binning.bin_triangles(cpu, width, sh, th, tw, len(data))
    assert torch.equal(counts.cpu(), want)
    ref = binning._stats(cpu, width, sh, th, tw)
    for key in ("max", "total"):
        assert int(got[key]) == int(ref[key]), key
    assert got["n_tiles"] == ref["n_tiles"]
    assert float(got["mean"]) == float(counts.to(torch.float32).mean())


def test_graph_replays_add_drops(dev):
    """K12 captured in a CUDA graph after an eager call: every replay
    writes the same lists and adds its drops again, with no node of its
    own for them."""
    width, sh, th, tw, t, cap, y0 = BINNING_CASES["tight"]
    data, valid = binning_case("tight", seed=13)
    setup = TriangleSetup(torch.from_numpy(data).to(dev),
                          torch.from_numpy(valid).to(dev))
    args = (setup, width, sh, th, tw, cap, y0)
    (want, want_counts), eager = dropped(
        lambda: binning_cuda.bin_triangles(*args, drops=COUNTER), dev)
    assert eager > 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bins, counts = binning_cuda.bin_triangles(*args, drops=COUNTER)
    for _ in range(2):
        bins.fill_(7)
        _, added = dropped(graph.replay, dev)
        torch.cuda.synchronize(dev)
        assert added == eager
        assert torch.equal(bins, want) and torch.equal(counts, want_counts)


def test_wrapper_rejects_bad_inputs(dev):
    data, valid = binning_case("few_rows")
    setup = TriangleSetup(torch.from_numpy(data).to(dev),
                          torch.from_numpy(valid).to(dev))
    with pytest.raises(ValueError, match="CUDA tensors"):
        binning_cuda.bin_triangles(
            TriangleSetup(setup.data.cpu(), setup.valid.cpu()), 1920, 1080,
            32, 128, 64)
    with pytest.raises(ValueError, match="setup.valid"):
        binning_cuda.bin_triangles(TriangleSetup(setup.data,
                                                 setup.valid.cpu()),
                                   1920, 1080, 32, 128, 64)
    with pytest.raises(ValueError, match="capacity"):
        binning_cuda.bin_triangles(setup, 1920, 1080, 32, 128, -1)


@pytest.fixture(scope="module")
def large():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    device = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_large_glb(pathlib.Path(td) / "l.glb"))
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=device)
    return build_device_scene(gltf, device=device), params


def rastered_frames(scene, params, cfg, dev, compiled: bool):
    """Three chained frames (rgba and every FrameState field on the host)
    and the launches of K12, K1 and K2 they made (at capture where
    compiled: the counters do not move on replay)."""
    frame._CACHE.clear()
    fn = (frame.compiled_gltf_frame(cfg) if compiled else
          lambda s, p, st: frame.render_gltf_frame(s, p, st, cfg))
    state = frame.init_frame_state(cfg, dev)
    before = frame._launch_counts()
    out = []
    for p in [params] + [frame.orbit_params(params, i) for i in (1, 2)]:
        rgba, state = fn(scene, p, state)
        out.append([x.cpu() for x in (rgba,) + tuple(state)])
    after = frame._launch_counts()
    counts = fn.last.launches if compiled else {
        k: after[k] - before[k] for k in after}
    frame._CACHE.clear()
    return out, tuple(counts[k] for k in ("binning", "raster_table",
                                          "raster_padded"))


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "replayed"])
def test_rastered_frame_takes_k1_on_k12_bins(dev, large, compiled,
                                             monkeypatch):
    """The rastered deployment (committed, cascades rastered in full) on
    the 73,754-triangle scene at 256x144 with 512^2 maps: 5 K12 and 5 K1
    launches a frame and no K2 (its 4.6 MiB setup tables are within the
    32 MiB limit), and the frames equal bit for bit those of the same
    config with the limit at 0 (K12's bins pre-gathered for K2), eager and
    replayed."""
    scene, params = large
    cfg = frame.GltfConfig(
        width=256, height=144, shadow_map_size=512,
        raster=RasterConfig(tile_h=32, tile_w=128),
        shadow_raster=RasterConfig(tile_h=128, tile_w=256),
        flags=frame.GltfFrameFlags(committed=True))
    got, launches = rastered_frames(scene, params, cfg, dev, compiled)
    per_frame = 1 if compiled else 3
    assert launches == (5 * per_frame, 5 * per_frame, 0)
    monkeypatch.setattr(raster, "TABLE_LIMIT_BYTES", 0)
    want, launches = rastered_frames(scene, params, cfg, dev, compiled)
    assert launches == (5 * per_frame, 0, 5 * per_frame)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(
                x.reshape(-1).view(torch.uint8),
                y.reshape(-1).view(torch.uint8))
    assert raster_cuda.LAUNCHES > 0
