"""The hand-written kernels (funky_tpu_torch/csrc/raster.cu: K1 and K2;
csrc/gather.cu: K3) against their plain twins, on the card. Every test
here needs an NVIDIA GPU and skips without one. The module imports no
jax, so it runs where jax is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_raster_cuda.py

Tolerance: none. The raster kernels evaluate every plane as
(a*px + b*py) + c with round-to-nearest and no FMA contraction, which is
what eager torch computes op by op, so tri_id and depth are bit-equal; a
gather copies values.
"""

import pathlib
import tempfile

import numpy as np
import pytest
import torch

from funky_tpu_torch import frame
from funky_tpu_torch.models.gltf import GltfScene
from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
from funky_tpu_torch.models.scene import build_device_scene
from funky_tpu_torch.ops import (binning, compact, gather_cuda, raster,
                                  raster_cuda)
from funky_tpu_torch.ops.raster import RasterConfig

from .torch_scenes import (random_clip_scene, small_triangles_scene,
                           with_coplanar_duplicates)

pytestmark = pytest.mark.cuda

W, H = 256, 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def both(clip, tris, dev, y_offset=0, slice_height=None, **kw):
    """(kernel, plain) rasters of one scene on the card, as numpy."""
    out = []
    for backend in ("cuda", "torch"):
        before = raster_cuda.LAUNCHES
        tri_id, depth, _ = raster.raster_scene(
            torch.from_numpy(clip).to(dev), torch.from_numpy(tris).to(dev),
            W, H, len(tris), RasterConfig(backend=backend, **kw), y_offset,
            slice_height)
        torch.cuda.synchronize()
        assert raster_cuda.LAUNCHES - before == (backend == "cuda")
        out.append((tri_id.cpu().numpy(), depth.cpu().numpy()))
    return out


@pytest.mark.parametrize("tiles", [(8, 128), (32, 128), (128, 256)])
@pytest.mark.parametrize("case", ["full", "tight", "slab", "ties"])
def test_kernel_bit_equal_to_plain(dev, case, tiles):
    clip, tris = random_clip_scene(seed=3, n_tris=200, width=W, height=H)
    kw = dict(tile_h=tiles[0], tile_w=tiles[1])
    if case == "tight":
        kw["capacity"] = 4
    if case == "ties":
        clip, tris = with_coplanar_duplicates(clip)
    y0, sh = (64, 32) if case == "slab" else (0, None)
    (ik, zk), (ip, zp) = both(clip, tris, dev, y0, sh, **kw)
    np.testing.assert_array_equal(ik, ip)
    np.testing.assert_array_equal(zk.view(np.int32), zp.view(np.int32))
    assert (ik >= 0).any()


def test_wrapper_rejects_bad_inputs(dev):
    table = torch.zeros((128, 16), dtype=torch.float32, device=dev)
    bins = torch.full((2, 8), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int32, device=dev)
    run = raster_cuda.raster_table_cuda
    with pytest.raises(TypeError, match="dtype"):
        run(table.double(), bins, counts, 256, 8, 8, 128)
    with pytest.raises(ValueError, match="contiguous"):
        run(torch.zeros((16, 128), device=dev).T, bins, counts, 256, 8, 8,
            128)
    with pytest.raises(ValueError, match="tiles"):
        run(table, bins, counts, 512, 8, 8, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run(table.cpu(), bins, counts, 256, 8, 8, 128)


def test_frame_runs_the_kernel_five_times(dev):
    """The dense frame through the kernel equals the frame through the
    plain raster, and launches the kernel once per raster: four cascades
    and the main pass."""
    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(
            pathlib.Path(td) / "m.glb", two_textures=True))
    scene = build_device_scene(gltf, device=dev)
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=dev)
    out = {}
    for backend in ("auto", "torch"):
        tile = RasterConfig(tile_h=16, tile_w=128, backend=backend)
        cfg = frame.GltfConfig(
            width=256, height=144, shadow_map_size=256, raster=tile,
            shadow_raster=tile, valid_block_capacity=0,
            texture_block_capacity=0,
            flags=frame.GltfFrameFlags(sparse_shadows=False,
                                       sparse_contact=False))
        state = frame.init_frame_state(cfg, dev)
        before = raster_cuda.LAUNCHES
        for p in (params, frame.orbit_params(params, 1)):
            rgba, state = frame.render_gltf_frame(scene, p, state, cfg)
        torch.cuda.synchronize()
        assert raster_cuda.LAUNCHES - before == (10 if backend == "auto"
                                                 else 0)
        out[backend] = (rgba.cpu().numpy(), state.prev_depth.cpu().numpy(),
                        state.shadow_history.cpu().numpy())
    for a, b in zip(out["auto"], out["torch"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tiles", [(8, 128), (32, 128), (128, 256)])
@pytest.mark.parametrize("case", ["full", "tight", "slab", "ties"])
def test_padded_kernel_bit_equal_to_plain(dev, case, tiles, monkeypatch):
    """K2 (the table limit patched to 0 sends every raster to it) against
    the plain twin on the same pre-gathered rows."""
    monkeypatch.setattr(raster, "TABLE_LIMIT_BYTES", 0)
    clip, tris = random_clip_scene(seed=4, n_tris=200, width=W, height=H)
    kw = dict(tile_h=tiles[0], tile_w=tiles[1])
    if case == "tight":
        kw["capacity"] = 4
    if case == "ties":
        clip, tris = with_coplanar_duplicates(clip)
    y0, sh = (64, 32) if case == "slab" else (0, None)
    out = []
    for backend in ("cuda", "torch"):
        before = (raster_cuda.LAUNCHES, raster_cuda.PADDED_LAUNCHES)
        tri_id, depth, _ = raster.raster_scene(
            torch.from_numpy(clip).to(dev), torch.from_numpy(tris).to(dev),
            W, H, len(tris), RasterConfig(backend=backend, **kw), y0, sh)
        torch.cuda.synchronize()
        assert raster_cuda.LAUNCHES == before[0]
        assert (raster_cuda.PADDED_LAUNCHES - before[1]
                == (backend == "cuda"))
        out.append((tri_id.cpu().numpy(), depth.cpu().numpy()))
    (ik, zk), (ip, zp) = out
    np.testing.assert_array_equal(ik, ip)
    np.testing.assert_array_equal(zk.view(np.int32), zp.view(np.int32))
    assert (ik >= 0).any()


# Cases of the per-rectangle kernels: (scene, width, height, tiles).
RECT_CASES = {
    # thousands of small triangles in one tile: many chunks of 256 rows,
    # most culled from each rectangle
    "long_bin": (lambda: small_triangles_scene(5, 3000, (0, 0, 256, 128),
                                               2.0, 256, 256),
                 256, 256, [(128, 256), (32, 128)]),
    # width not a multiple of 4 or of the rectangle: scalar stores, cut
    # rectangles, tiles hanging over the edge
    "ragged_250x130": (lambda: random_clip_scene(6, 300, 250, 130),
                       250, 130, [(32, 128), (128, 256), (8, 128)]),
    # tiles smaller than the rectangle, one of them not 4-aligned
    "tiny_tiles": (lambda: random_clip_scene(7, 300, 256, 128),
                   256, 128, [(8, 16), (5, 6), (16, 8)]),
}


@pytest.mark.parametrize("padded", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("case", sorted(RECT_CASES))
def test_kernels_on_long_bins_ragged_and_tiny_tiles(dev, case, padded,
                                                    monkeypatch):
    """K1 and K2 (the table limit patched to 0) against the plain twin,
    bit for bit, on the cases that stress the rectangles and the cull."""
    if padded:
        monkeypatch.setattr(raster, "TABLE_LIMIT_BYTES", 0)
    make, w, h, tiles = RECT_CASES[case]
    clip, tris = make()
    for th, tw in tiles:
        out = []
        for backend in ("cuda", "torch"):
            before = (raster_cuda.LAUNCHES, raster_cuda.PADDED_LAUNCHES)
            tri_id, depth, _ = raster.raster_scene(
                torch.from_numpy(clip).to(dev),
                torch.from_numpy(tris).to(dev), w, h, len(tris),
                RasterConfig(tile_h=th, tile_w=tw, backend=backend))
            torch.cuda.synchronize()
            launched = (raster_cuda.LAUNCHES - before[0],
                        raster_cuda.PADDED_LAUNCHES - before[1])
            want = int(backend == "cuda")
            assert launched == ((0, want) if padded else (want, 0))
            out.append((tri_id.cpu().numpy(), depth.cpu().numpy()))
        (ik, zk), (ip, zp) = out
        np.testing.assert_array_equal(ik, ip, err_msg=f"tiles {th}x{tw}")
        np.testing.assert_array_equal(zk.view(np.int32), zp.view(np.int32),
                                      err_msg=f"tiles {th}x{tw}")
        assert (ik >= 0).any()


def test_table_kernel_on_an_unaligned_table(dev):
    """A contiguous setup table starting 4 bytes past a 16-byte boundary
    takes K1's 4-byte row copies: still bit-equal to the plain twin."""
    clip, tris = random_clip_scene(seed=8, n_tris=300, width=W, height=H)
    setup = binning.triangle_setup(torch.from_numpy(clip).to(dev),
                                   torch.from_numpy(tris).to(dev), W, H,
                                   len(tris))
    bins, counts = binning.bin_triangles(setup, W, H, 32, 128, len(tris))
    flat = torch.empty(setup.data.numel() + 1, device=dev)
    table = flat[1:].view(setup.data.shape)
    table.copy_(setup.data)
    assert table.data_ptr() % 16 == 4
    ik, zk = raster_cuda.raster_table_cuda(table, bins, counts, W, H, 32, 128)
    ip, zp = raster._rasterize_torch(
        binning.gather_bin_data(setup, bins), bins, counts, 0, W, H,
        RasterConfig(tile_h=32, tile_w=128, backend="torch"))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(ik.cpu().numpy(), ip.cpu().numpy())
    np.testing.assert_array_equal(zk.cpu().numpy().view(np.int32),
                                  zp.cpu().numpy().view(np.int32))
    assert (ik >= 0).any()


def test_padded_wrapper_rejects_bad_inputs(dev):
    rows = torch.zeros((2, 8, 16), dtype=torch.float32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int32, device=dev)
    run = raster_cuda.raster_padded_cuda
    with pytest.raises(ValueError, match="expected"):
        run(rows[..., :12].contiguous(), counts, 256, 8, 8, 128)
    with pytest.raises(ValueError, match="tiles"):
        run(rows, counts, 512, 8, 8, 128)
    with pytest.raises(TypeError, match="dtype"):
        run(rows, counts.long(), 256, 8, 8, 128)


@pytest.mark.parametrize("width", [1, 4, 7])
def test_row_gather_bit_equal_to_plain(dev, width):
    rng = np.random.default_rng(width)
    n = 100_000
    table = torch.from_numpy(rng.random((n, width)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2 * n, 2 * n, (3, 50_000))
                           .astype(np.int32))
    before = gather_cuda.LAUNCHES
    got = gather_cuda.row_gather(table.to(dev), idx.to(dev))
    torch.cuda.synchronize()
    assert gather_cuda.LAUNCHES == before + 1
    want = gather_cuda.row_gather(table, idx)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_default_frame_sparse_equals_dense_on_the_card(dev):
    """GltfConfig() at 256x144 with 2048^2 maps equals the dense
    configuration bit for bit on the card, over a parked and a moving
    frame, with five host syncs per frame."""
    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(
            pathlib.Path(td) / "m.glb", two_textures=True))
    scene = build_device_scene(gltf, device=dev)
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=dev)
    dense_flags = frame.GltfFrameFlags(sparse_shadows=False,
                                       sparse_contact=False)
    out = []
    for cfg in (frame.GltfConfig(width=256, height=144),
                frame.GltfConfig(width=256, height=144,
                                 valid_block_capacity=0,
                                 texture_block_capacity=0,
                                 flags=dense_flags)):
        state = frame.init_frame_state(cfg, dev)
        for p in (params, frame.orbit_params(params, 1)):
            compact.reset_host_syncs()
            rgba, state = frame.render_gltf_frame(scene, p, state, cfg)
        out.append((compact.HOST_SYNCS, rgba.cpu().numpy(),
                    state.shadow_history.cpu().numpy()))
    assert out[0][0] == 5 and out[1][0] == 0
    for a, b in zip(out[0][1:], out[1][1:]):
        np.testing.assert_array_equal(a, b)
