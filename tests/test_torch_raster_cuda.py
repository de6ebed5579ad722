"""The hand-written raster kernel (funky_tpu_torch/csrc/raster.cu) against
its plain twin, on the card. Every test here needs an NVIDIA GPU and skips
without one. The module imports no jax, so it runs where jax is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_raster_cuda.py

Tolerance: none. The kernel evaluates every plane as
(a*px + b*py) + c with round-to-nearest and no FMA contraction, which is
what eager torch computes op by op, so tri_id and depth are bit-equal.
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
from funky_tpu_torch.ops import raster, raster_cuda
from funky_tpu_torch.ops.raster import RasterConfig

from .torch_scenes import random_clip_scene, with_coplanar_duplicates

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
