"""The quad-packing kernel K11 on the CPU: `ops/sampling.py::quad_pack`
sends a CUDA tensor to K11 (ops/quad_pack_cuda.py::quad_pack) and a CPU
tensor to the plain twin `quad_pack_plain` (held against the JAX package
in tests/test_torch_sampling.py::test_quad_packs_match). Here `check_args`
is held to the maps the kernel takes and refuses, a numpy model of the
kernel's strip walk (csrc/quad_pack.cu: blocks of 256 columns, the right
neighbour by a warp shuffle, the row below carried) equals the twin bit
for bit, and every `quad_pack` call of a small committed frame with
synthesized maps passes `check_args`, so no frame call raises on the card.

Tolerance: none; the packing copies 32-bit words.
"""

import numpy as np
import pytest
import torch

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import quad_pack_cuda, sampling
from funky_tpu_torch.ops.raster import RasterConfig

from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene)
from .torch_scenes import quad_pack_maps

THREADS = 256     # csrc/quad_pack.cu's block: columns of one strip


@pytest.mark.parametrize("shape", [(4, 2048, 2048), (135, 240), (4, 256, 256),
                                   (1, 1), (3, 1, 7), (2, 2, 5, 3)], ids=str)
def test_check_args_takes_frame_shapes(shape):
    """The cascade maps, the contact pyramid's level 0 at 1080p, small maps,
    one texel, a single row and a 4-D batch: (maps, H, W)."""
    img = torch.empty(shape, dtype=torch.float32)
    assert quad_pack_cuda.check_args(img) == (
        int(np.prod(shape[:-2])), shape[-2], shape[-1])


@pytest.mark.parametrize("case,exc", [
    ("float64", TypeError), ("int32", TypeError), ("transposed", ValueError),
    ("strided", ValueError), ("empty_rows", ValueError),
    ("empty_maps", ValueError), ("one_axis", ValueError),
    ("not_a_tensor", TypeError)])
def test_check_args_refuses(case, exc):
    """A wrong dtype, a non-contiguous view, an empty or 1-D shape and a
    non-tensor raise, naming the argument."""
    base = torch.zeros((4, 8, 8), dtype=torch.float32)
    img = {"float64": base.double(), "int32": base.int(),
           "transposed": base.transpose(1, 2), "strided": base[:, :, ::2],
           "empty_rows": torch.zeros((4, 0, 8)),
           "empty_maps": torch.zeros((0, 8, 8)), "one_axis": torch.zeros(8),
           "not_a_tensor": base.numpy()}[case]
    with pytest.raises(exc, match="^img:"):
        quad_pack_cuda.check_args(img)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: a CPU tensor is the dispatcher's to
    send to the twin, and no launch is counted."""
    before = quad_pack_cuda.LAUNCHES
    with pytest.raises(ValueError, match="^img:"):
        quad_pack_cuda.quad_pack(torch.zeros((2, 3)))
    got = sampling.quad_pack(torch.zeros((2, 3)))
    assert got.shape == (2, 3, 4) and quad_pack_cuda.LAUNCHES == before


def model_kernel(words: np.ndarray, rows: int) -> np.ndarray:
    """csrc/quad_pack.cu's grid on (L, H, W) uint32 words, one block at a
    time, its 256 threads as a vector: each step loads the row below,
    shuffles the right neighbour down by one lane (lane 31 keeps its own
    word, then loads it; the row's last texel clamps), stores the quad of
    the row above and carries the row below. Words no thread stores stay
    0xdeadbeef."""
    n_maps, h, w = words.shape
    out = np.full((n_maps, h, w, 4), 0xDEADBEEF, np.uint32)
    col_blocks, strips = -(-w // THREADS), -(-h // rows)
    lane = np.arange(THREADS) % 32
    for block in range(n_maps * col_blocks * strips):
        cb, strip_image = block % col_blocks, block // col_blocks
        strip, image = strip_image % strips, strip_image // strips
        x = cb * THREADS + np.arange(THREADS)
        live = x < w

        def load_pair(y):
            row = words[image, y]
            d = np.where(live, row[np.minimum(x, w - 1)], 0).astype(np.uint32)
            r = np.where(lane == 31, d, np.roll(d, -1))
            last = x + 1 >= w
            r = np.where(last, d, np.where(lane == 31,
                                           row[np.minimum(x + 1, w - 1)], r))
            return d, r

        y0, y1 = strip * rows, min(strip * rows + rows, h)
        above = load_pair(y0)
        for y in range(y0, y1):
            below = load_pair(min(y + 1, h - 1))
            quad = np.stack([above[0], above[1], below[0], below[1]], -1)
            out[image, y, x[live]] = quad[live]
            above = below
    return out


@pytest.mark.parametrize("shape,rows", [
    ((2, 35, 300), 16), ((1, 5, 1), 16), ((1, 1, 9), 16), ((3, 9, 33), 4),
    ((1, 40, 257), 3), ((1, 16, 512), 16), ((1, 18, 32), 1)], ids=str)
def test_kernel_model_equals_twin(shape, rows):
    """The model of K11 == quad_pack_plain bit for bit on words with NaN
    payloads, +/-inf and -0.0 (the last row and column too): two column
    blocks with a ragged second, one column, one row, strips that end
    inside the map and at its end, a strip per row, and widths at and one
    past a block."""
    img = quad_pack_maps(sum(shape) + rows, shape)
    want = sampling.quad_pack_plain(torch.from_numpy(img)).numpy()
    got = model_kernel(img.view(np.uint32), rows)
    np.testing.assert_array_equal(got, want.view(np.uint32))


def test_frame_quad_packs_pass_check_args(monkeypatch):
    """Every quad_pack call of a committed frame with synthesized maps
    (the shipped flags, untuned) on the multimesh scene at 256x144 with
    256^2 maps passes check_args: the four cascade maps, the contact
    pyramid's level 0 and, on the CPU only, the march twin's depth (on the
    card K9 reads the depth itself)."""
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    cfg = tf.GltfConfig(
        width=256, height=144, shadow_map_size=256,
        raster=RasterConfig(tile_h=32, tile_w=128),
        shadow_raster=RasterConfig(tile_h=128, tile_w=256),
        flags=tf.GltfFrameFlags(committed=True, synth_shadow_maps=True))
    calls = []
    plain = sampling.quad_pack_plain

    def record(img):
        calls.append(quad_pack_cuda.check_args(img))
        return plain(img)

    monkeypatch.setattr(sampling, "quad_pack_plain", record)
    tf.render_gltf_frame(scene, params, tf.init_frame_state(cfg, "cpu"), cfg)
    assert calls == [(4, 256, 256), (1, 18, 32), (1, 144, 256)], calls
