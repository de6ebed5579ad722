"""The row-gather kernel K3 (funky_tpu_torch/csrc/gather.cu through
ops/gather_cuda.py::row_gather) against its plain twin
(ops/sampling.py::take_rows_plain), on the card. Every test here needs an
NVIDIA GPU and skips without one. The module imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_gather_cuda.py

Tolerance: none; a gather copies values, so the kernel's output equals the
twin's bit for bit.
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
from funky_tpu_torch.ops import gather_cuda, sampling
from funky_tpu_torch.ops.raster import RasterConfig

from .torch_scenes import GATHER_INDICES, GATHER_ROWS, gather_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def bits(x: torch.Tensor) -> np.ndarray:
    """The bytes of a tensor, for a bit-for-bit comparison."""
    return x.cpu().contiguous().numpy().view(np.uint8)


def kernel_and_plain(table: torch.Tensor, idx: torch.Tensor):
    """(kernel, plain twin) outputs on the same card tensors; the kernel
    launches once unless the index is empty."""
    before = gather_cuda.LAUNCHES
    got = gather_cuda.row_gather(table, idx)
    torch.cuda.synchronize()
    assert gather_cuda.LAUNCHES - before == (idx.numel() > 0)
    return got, sampling.take_rows_plain(table, idx)


@pytest.mark.parametrize("indices", sorted(GATHER_INDICES))
@pytest.mark.parametrize("rows", sorted(GATHER_ROWS))
def test_kernel_bit_equal_to_plain(dev, rows, indices):
    """Every row type the frame gathers (and f16 / f64 rows: 2- and 8-byte
    copy units), negative and out-of-range indices, 1-D, 3-D, empty and
    large index batches, a 1-row table."""
    table, idx = gather_case(rows, indices)
    got, want = kernel_and_plain(torch.from_numpy(table).to(dev),
                                 torch.from_numpy(idx).to(dev))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("offset", [4, 8, 2, 1])
@pytest.mark.parametrize("rows", ["f32x4", "f32x46"])
def test_kernel_on_offset_views(dev, rows, offset):
    """A contiguous table starting `offset` bytes past a 16-byte boundary
    (a view into a byte buffer) takes a smaller copy unit and is still
    bit-equal: the 16-byte quads and the deferred pass's 184-byte rows."""
    table, idx = gather_case(rows, "large")
    raw = torch.from_numpy(table).to(dev)
    buf = torch.empty(raw.numel() * 4 + offset, dtype=torch.uint8,
                      device=dev)
    view = buf[offset:].view(torch.float32) if offset % 4 == 0 else None
    if view is None:
        # a float32 view must be 4-byte aligned: gather the bytes instead
        shaped = buf[offset:].view(raw.shape[0], -1)
        shaped.copy_(raw.view(torch.uint8).view(raw.shape[0], -1))
        table_t = shaped
    else:
        table_t = view.view(raw.shape)
        table_t.copy_(raw)
    assert table_t.data_ptr() % 16 == offset and table_t.is_contiguous()
    got, want = kernel_and_plain(table_t, torch.from_numpy(idx).to(dev))
    np.testing.assert_array_equal(bits(got), bits(want))


def test_kernel_refuses_what_it_cannot_take(dev):
    """An int64 index, a non-contiguous table and an index on the CPU
    raise, and nothing launches."""
    table = torch.rand((1000, 4), device=dev)
    idx = torch.randint(0, 1000, (4096,), dtype=torch.int32, device=dev)
    before = gather_cuda.LAUNCHES
    with pytest.raises(TypeError, match="^idx:"):
        gather_cuda.row_gather(table, idx.long())
    with pytest.raises(ValueError, match="^table: must be contiguous"):
        gather_cuda.row_gather(torch.rand((4, 1000), device=dev).T, idx)
    with pytest.raises(ValueError, match="^idx: on cpu"):
        gather_cuda.row_gather(table, idx.cpu())
    with pytest.raises(ValueError, match="^table:"):
        sampling.take_rows(table[:0], idx)
    assert gather_cuda.LAUNCHES == before


def test_take_rows_launches_the_kernel_once(dev):
    """take_rows on a CUDA table is one K3 launch, equal to the plain
    twin."""
    table, idx = gather_case("f32x4", "3d")
    t, i = torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)
    before = gather_cuda.LAUNCHES
    got = sampling.take_rows(t, i)
    torch.cuda.synchronize()
    assert gather_cuda.LAUNCHES == before + 1
    np.testing.assert_array_equal(bits(got),
                                  bits(sampling.take_rows_plain(t, i)))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "default"])
def test_frame_gathers_through_the_kernel(dev, sparse, monkeypatch):
    """Two chained frames on the multimesh scene at 256x144 launch K3 on
    every frame and equal the same frames with the plain twin in its place
    bit for bit (rgba, depth, history): the dense path, and GltfConfig()."""
    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(
            pathlib.Path(td) / "m.glb", two_textures=True))
    scene = build_device_scene(gltf, device=dev)
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=dev)
    if sparse:
        cfg = frame.GltfConfig(width=256, height=144)
    else:
        tile = RasterConfig(tile_h=16, tile_w=128)
        cfg = frame.GltfConfig(
            width=256, height=144, shadow_map_size=256, raster=tile,
            shadow_raster=tile, valid_block_capacity=0,
            texture_block_capacity=0,
            flags=frame.GltfFrameFlags(sparse_shadows=False,
                                       sparse_contact=False))

    def run():
        state = frame.init_frame_state(cfg, dev)
        out, launches = [], []
        for p in (params, frame.orbit_params(params, 1)):
            before = gather_cuda.LAUNCHES
            rgba, state = frame.render_gltf_frame(scene, p, state, cfg)
            torch.cuda.synchronize()
            launches.append(gather_cuda.LAUNCHES - before)
            out.append([bits(x) for x in (rgba, state.prev_depth,
                                          state.shadow_history)])
        return out, launches

    kernel, k_launches = run()
    monkeypatch.setattr(gather_cuda, "row_gather", sampling.take_rows_plain)
    plain, p_launches = run()
    assert all(n > 0 for n in k_launches) and p_launches == [0, 0]
    for a, b in zip(kernel, plain):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
