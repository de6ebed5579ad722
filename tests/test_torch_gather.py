"""Port parity: the frame's row gather. `ops/sampling.py::take_rows` sends
a CUDA table to the kernel K3 (funky_tpu_torch/ops/gather_cuda.py::
row_gather) and a CPU table to the plain twin `take_rows_plain`; here the
twin is held against numpy and against the JAX package's take_rows
(funky_tpu/ops/sampling.py:31-61) on every row type the frame gathers,
`check_args` is held to the calls the kernel takes and refuses, and every
`take_rows` call of a dense, a default and a shipped frame is shown to pass
`check_args`, so that no frame call raises on the card.

Tolerance: none; a gather copies values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.ops.sampling import take_rows as jtake_rows

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import gather_cuda, sampling
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.utils import autotune as ta

from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, t2n)
from .torch_scenes import GATHER_INDICES, GATHER_ROWS, gather_case


@pytest.mark.parametrize("width", [1, 2, 4, 7])
def test_row_gather_matches_numpy_and_jax(width):
    """Random rows, out-of-range and negative indices (counted from the
    end, then clamped), a 2-D index batch."""
    rng = np.random.default_rng(width)
    n = 1000
    table = rng.random((n, width)).astype(np.float32)
    idx = rng.integers(-2 * n, 2 * n, (37, 11)).astype(np.int32)
    before = gather_cuda.LAUNCHES
    got = t2n(gather_cuda.row_gather(torch.from_numpy(table),
                                     torch.from_numpy(idx)))
    assert gather_cuda.LAUNCHES == before     # the CPU takes the plain twin
    want = table[np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jtake_rows(jnp.asarray(table), jnp.asarray(idx))))
    assert got.shape == idx.shape + (width,)


@pytest.mark.parametrize("indices", sorted(GATHER_INDICES))
@pytest.mark.parametrize("rows", sorted(GATHER_ROWS))
def test_take_rows_matches_numpy_and_jax(rows, indices):
    """take_rows on CPU tensors (the plain twin, no launch) == numpy's
    normalised gather == JAX's take_rows, for every row type the frame
    gathers and 1-D, 3-D, empty, large and tap-major (16, 3, 4099)
    index batches and a 1-row table; check_args takes every case. JAX holds no 64-bit values
    without x64, so the f64 rows skip the JAX comparison."""
    table, idx = gather_case(rows, indices)
    n = table.shape[0]
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    assert gather_cuda.check_args(t, i) == (n, table[0].nbytes)
    before = gather_cuda.LAUNCHES
    got = t2n(sampling.take_rows(t, i))
    assert gather_cuda.LAUNCHES == before
    want = table[np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)]
    assert got.dtype == table.dtype and got.shape == idx.shape + table.shape[1:]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t2n(sampling.take_rows_plain(t, i)), want)
    jt = jnp.asarray(table)
    if jt.dtype == table.dtype:
        np.testing.assert_array_equal(
            got, np.asarray(jtake_rows(jt, jnp.asarray(idx))))


@pytest.mark.parametrize("shape, slices", [
    ((16, 1080, 1920), 16), ((16, 7168), 16), ((8, 272, 480), 8),
    ((1080, 1920), 0), ((184, 480), 0), ((4099,), 0), ((16, 12), 0),
    ((1, 4099), 0), ((), 0)])
def test_tap_slices(shape, slices):
    """The kernel walks a short leading tap axis as its slices: the tap
    sets and probes, not image rows or short batches."""
    assert gather_cuda.tap_slices(torch.zeros(shape, dtype=torch.int32)) \
        == slices


def _refused():
    """(argument named in the error, table, idx) of calls the kernel does
    not take. The meta device stands in for a second device."""
    table = torch.zeros((64, 4))
    idx = torch.zeros((8,), dtype=torch.int32)
    return {
        "int64 index": ("idx", table, idx.long()),
        "non-contiguous table": ("table", torch.zeros((4, 64)).T, idx),
        "non-contiguous index": ("idx", table, torch.zeros(
            (8, 2), dtype=torch.int32)[:, 0]),
        "empty table": ("table", torch.zeros((0, 4)), idx),
        "0-d table": ("table", torch.zeros(()), idx),
        "empty rows": ("table", torch.zeros((64, 0)), idx),
        "16-byte elements": ("table", torch.zeros((64,),
                                                  dtype=torch.complex128),
                             idx),
        "index on another device": ("idx", table, idx.to("meta")),
        "index not a tensor": ("idx", table, [0, 1]),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_check_args_refuses(case):
    """Each call the kernel cannot take raises, naming the argument."""
    name, table, idx = _refused()[case]
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        gather_cuda.check_args(table, idx)


def _dense_config():
    return tf.GltfConfig(
        width=256, height=144, shadow_map_size=256,
        raster=RasterConfig(tile_h=16, tile_w=128),
        shadow_raster=RasterConfig(tile_h=16, tile_w=128),
        valid_block_capacity=0, texture_block_capacity=0,
        flags=tf.GltfFrameFlags(sparse_shadows=False, sparse_contact=False))


def _shipped_config(scene, params):
    """bench.py's configuration at tests/test_torch_shipped.py's size
    (480x272, 1024^2 maps), tuned by the port's autotune over the parked
    view and orbit pose 2."""
    base = tf.GltfConfig(
        width=480, height=272, shadow_map_size=1024,
        raster=RasterConfig(tile_h=32, tile_w=128),
        shadow_raster=RasterConfig(tile_h=128, tile_w=256),
        flags=tf.GltfFrameFlags(committed=True, synth_shadow_maps=True))
    poses = [params, tf.orbit_params(params, 2)]
    cfg, _ = ta.tune_sparse_capacities(
        scene, poses, ta.tune_raster_capacities(scene, poses, base))
    return cfg


def _perf_config(**flags):
    """GltfConfig() at 480x272 with 1024^2 maps, pair and contact
    capacities that hold every entry (so the sparse paths run, not their
    dense fallbacks), small light windows and `flags`."""
    return tf.GltfConfig(
        width=480, height=272, shadow_map_size=1024,
        raster=RasterConfig(tile_h=32, tile_w=128),
        shadow_raster=RasterConfig(tile_h=128, tile_w=256),
        shadow_pen_capacity=2 * 480 * 272, contact_capacity=480 * 272,
        contact_march_capacity=480 * 272,
        light_window_sizes=(256, 256, 128, 128), light_pcf_rungs=2,
        flags=tf.GltfFrameFlags(**flags))


@pytest.mark.parametrize("path", ["dense", "default", "shipped", "half_res",
                                  "lightspace"])
def test_frame_gathers_pass_check_args(path, monkeypatch):
    """Every take_rows call of two chained frames (parked, orbit pose 1)
    on the multimesh scene passes check_args: dense at 256x144, GltfConfig()
    at 256x144 with its 2048^2 maps, the tuned shipped configuration, and
    at 480x272 the half-res frame and the light-space one (with the
    back-face skip and synthesized maps), whose light maps add the window
    reads of build_light_shadow_map (4-byte and 16-byte rows) and the
    fetch groups' one row per entry of a (wc^2, 4) map. The calls include
    the row types the kernel must take: 16-byte quads, the deferred pass's
    184-byte rows, int32 payloads on the sparse paths and the two-level
    compaction's bool mask on the shipped one."""
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    cfg = {"dense": _dense_config,
           "default": lambda: tf.GltfConfig(width=256, height=144),
           "shipped": lambda: _shipped_config(scene, params),
           "half_res": lambda: _perf_config(half_res_shadows=True),
           "lightspace": lambda: _perf_config(
               light_space_ground_shadows=True,
               skip_backfacing_shadows=True, synth_shadow_maps=True)}[path]()
    calls = []
    plain = sampling.take_rows_plain

    def record(flat, idx):
        calls.append((flat.dtype, tuple(flat.shape[1:]),
                      gather_cuda.check_args(flat, idx)))
        return plain(flat, idx)

    monkeypatch.setattr(sampling, "take_rows_plain", record)
    state = tf.init_frame_state(cfg, "cpu")
    for pose in (params, tf.orbit_params(params, 1)):
        _, state = tf.render_gltf_frame(scene, pose, state, cfg)
    kinds = {(dtype, shape) for dtype, shape, _ in calls}
    want = {(torch.float32, (4,)), (torch.float32, (46,))}
    if path != "dense":
        want.add((torch.int32, ()))
    if path == "shipped":
        want.add((torch.bool, ()))
    if path == "lightspace":
        want.add((torch.float32, ()))
        # the fetch groups: one row of a (256^2, 4) light map per entry
        assert any(shape == (4,) and rows == 256 * 256
                   for _, shape, (rows, _) in calls), calls
    assert len(calls) >= 20 and want <= kinds, kinds
