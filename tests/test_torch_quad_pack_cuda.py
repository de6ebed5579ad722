"""The quad-packing kernel K11 (funky_tpu_torch/csrc/quad_pack.cu through
ops/quad_pack_cuda.py::quad_pack) against its plain twin
(ops/sampling.py::quad_pack_plain), on the card. Every test here needs an
NVIDIA GPU and skips without one. The module imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_quad_pack_cuda.py

Tolerance: none; the packing copies 32-bit words, so the outputs are
compared as int32, NaN payloads and -0.0 included.
"""

import pathlib
import tempfile

import pytest
import torch

from funky_tpu_torch import frame
from funky_tpu_torch.models.gltf import GltfScene
from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
from funky_tpu_torch.models.scene import build_device_scene
from funky_tpu_torch.ops import quad_pack_cuda, sampling
from funky_tpu_torch.ops.raster import RasterConfig

from .torch_scenes import quad_pack_maps

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def maps(shape, seed, dev, offset=0):
    """torch_scenes.quad_pack_maps on the card, `offset` words into a
    larger buffer (a contiguous view off a 16-byte boundary)."""
    img = torch.from_numpy(quad_pack_maps(seed, shape).reshape(-1))
    flat = torch.zeros(offset + img.numel(), dtype=torch.float32, device=dev)
    flat[offset:] = img.to(dev)
    return flat[offset:].view(shape)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def packed(img):
    """K11 through the dispatcher: one launch, then == the twin."""
    before = quad_pack_cuda.LAUNCHES
    got = sampling.quad_pack(img)
    torch.cuda.synchronize()
    assert quad_pack_cuda.LAUNCHES - before == 1
    assert got.shape == img.shape + (4,) and got.dtype == torch.float32
    assert torch.equal(bits(got), bits(sampling.quad_pack_plain(img)))
    return got


@pytest.mark.parametrize("shape", [
    (4, 2048, 2048), (135, 240), (3, 17, 7), (2, 5, 1), (1, 1, 9), (1, 1),
    (33, 300), (2, 2, 40, 257), (1, 64, 256)], ids=str)
def test_kernel_equal_to_plain(dev, shape):
    """The frame's cascade maps and contact pyramid, a width that is not a
    multiple of 4, one column, one row, one texel, two column blocks with
    a ragged second, a 4-D batch and one block exactly; 2-D and 3-D
    inputs."""
    packed(maps(shape, sum(shape), dev))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_unaligned_input(dev, offset):
    """Maps that start 4, 8 and 12 bytes past a 16-byte boundary."""
    packed(maps((2, 33, 70), offset, dev, offset))


@pytest.mark.parametrize("rows", [1, 3, 16, 64, 1000])
def test_every_strip_height(dev, rows, monkeypatch):
    """A strip per row, strips that end inside the map, one strip for
    the whole map."""
    monkeypatch.setattr(quad_pack_cuda, "ROWS", rows)
    packed(maps((3, 67, 300), rows, dev))


def test_never_the_torch_path(dev, monkeypatch):
    """A CUDA tensor takes the kernel: the twin is never called."""
    def refuse(img):
        raise AssertionError("the plain twin ran on a CUDA tensor")

    img = maps((2, 16, 16), 0, dev)
    want = sampling.quad_pack_plain(img)
    monkeypatch.setattr(sampling, "quad_pack_plain", refuse)
    assert torch.equal(bits(sampling.quad_pack(img)), bits(want))


def test_refusals(dev):
    """What the kernel does not take raises, naming the argument."""
    img = maps((2, 16, 16), 0, dev)
    with pytest.raises(ValueError, match="^img:"):
        sampling.quad_pack(img.transpose(1, 2))
    with pytest.raises(TypeError, match="^img:"):
        sampling.quad_pack(img.double())
    with pytest.raises(ValueError, match="^img:"):
        sampling.quad_pack(img[:, :0])


def test_graph_replay_equals_eager(dev):
    """One call recorded in a CUDA graph, replayed on new maps copied into
    its input (twice), == the eager call on those maps; the capture counts
    one launch, the replays none."""
    static = maps((4, 256, 256), 1, dev).clone()
    sampling.quad_pack(static)                 # loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = quad_pack_cuda.LAUNCHES
    with torch.cuda.graph(graph):
        out = sampling.quad_pack(static)
    assert quad_pack_cuda.LAUNCHES - before == 1
    for seed in (2, 3):
        new = maps((4, 256, 256), seed, dev)
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(bits(out), bits(packed(new)))
    assert quad_pack_cuda.LAUNCHES - before == 3


def test_shipped_frame_graph_launches(dev, monkeypatch):
    """The committed flags with synthesized maps on the multimesh scene at
    256x144, recorded as a CUDA graph: K11 counted twice at capture (the
    cascade maps and the contact pyramid's level 0), the replayed frames
    == the eager frames == the frames with every packing by the twin,
    rgba and every FrameState field."""
    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(
            pathlib.Path(td) / "multi.glb", two_textures=True))
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=dev)
    scene = build_device_scene(gltf, device=dev)
    cfg = frame.GltfConfig(
        width=256, height=144, shadow_map_size=256,
        raster=RasterConfig(tile_h=32, tile_w=128),
        shadow_raster=RasterConfig(tile_h=128, tile_w=256),
        flags=frame.GltfFrameFlags(committed=True, synth_shadow_maps=True))
    poses = [params] + [frame.orbit_params(params, i) for i in (1, 2)]

    def run(f):
        state = frame.init_frame_state(cfg, dev)
        out = []
        for p in poses:
            rgba, state = f(scene, p, state)
            out.append([x.cpu().reshape(-1).view(torch.uint8)
                        for x in (rgba, *state)])
        return out

    fn = frame.compiled_gltf_frame(cfg)
    assert fn.uses_graph(dev)
    eager = lambda s, p, st: frame.render_gltf_frame(s, p, st, cfg)  # noqa
    runs = [run(fn), run(eager)]
    assert fn.last.launches["quad_pack"] == 2
    monkeypatch.setattr(quad_pack_cuda, "quad_pack", sampling.quad_pack_plain)
    runs.append(run(eager))
    names = ("rgba",) + frame.FrameState._fields
    for frames in zip(*runs):
        for name, a, b, c in zip(names, *frames):
            assert torch.equal(a, b) and torch.equal(a, c), name
