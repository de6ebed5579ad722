"""The binning kernel K12 on the CPU: ops/raster.py::raster_corners bins
with K12 (ops/binning_cuda.py::bin_triangles) where it takes the raster
kernels and with the plain twin ops/binning.py::bin_triangles (held
against the JAX package in tests/test_torch_raster.py) elsewhere. Here
`check_args` is held to the setups the kernel takes and refuses, a torch
model of the kernel's three passes (csrc/binning.cu: tile rectangles,
chunks of 128 ids counted per tile, an exclusive scan over the chunks,
ranks in id order within a chunk, the -1 fill) equals the twin bit for
bit, the twin equals the JAX package's bin_triangles on the same cases
(so the kernel is tied to JAX at the shapes it runs), and every binning
of a small rastered committed frame passes `check_args`, while "auto"
takes the twin on the CPU. Tolerance: none; bins, counts and drops are
integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.ops import binning as jbin

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import binning, binning_cuda, raster
from funky_tpu_torch.ops.binning import TriangleSetup
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.ops.sampling import to_i32
from funky_tpu_torch.utils import profiling

from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene)
from .torch_scenes import BINNING_CASES, binning_case

CHUNK = 128       # csrc/binning.cu: ids a warp owns


def case_setup(name, seed=0):
    data, valid = binning_case(name, seed)
    return TriangleSetup(torch.from_numpy(data), torch.from_numpy(valid))


def case_args(name):
    """(width, slab height, tile_h, tile_w, capacity, y_offset)."""
    width, sh, th, tw, t, cap, y0 = BINNING_CASES[name]
    return width, sh, th, tw, t if cap is None else cap, y0


@pytest.mark.parametrize("name", sorted(BINNING_CASES))
def test_check_args_takes_cases(name):
    width, sh, th, tw, cap, _ = case_args(name)
    assert binning_cuda.check_args(case_setup(name), width, sh, th, tw,
                                   cap) == (-(-width // tw), -(-sh // th))


@pytest.mark.parametrize("case,exc,arg", [
    ("float64", TypeError, "setup.data"),
    ("columns", ValueError, "setup.data"),
    ("transposed", ValueError, "setup.data"),
    ("valid_int", ValueError, "setup.valid"),
    ("valid_short", ValueError, "setup.valid"),
    ("valid_strided", ValueError, "setup.valid"),
    ("no_valid", TypeError, "setup.valid"),
    ("tile", ValueError, "tile"),
    ("capacity", ValueError, "capacity")])
def test_check_args_refuses(case, exc, arg):
    """A wrong dtype, width or layout of the rows or the mask, a missing
    mask, a non-positive tile and a negative capacity raise, naming the
    argument."""
    data = torch.zeros((64, 16))
    valid = torch.ones(64, dtype=torch.bool)
    args = [256, 128, 8, 128, 64]
    if case == "float64":
        data = data.double()
    elif case == "columns":
        data = torch.zeros((64, 12))
    elif case == "transposed":
        data = torch.zeros((16, 64)).T
    elif case == "valid_int":
        valid = valid.int()
    elif case == "valid_short":
        valid = valid[:10]
    elif case == "valid_strided":
        valid = torch.ones(128, dtype=torch.bool)[::2]
    elif case == "no_valid":
        valid = None
    elif case == "tile":
        args[2] = 0
    else:
        args[4] = -1
    with pytest.raises(exc, match=arg):
        binning_cuda.check_args(TriangleSetup(data, valid), *args)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: CPU tensors are raster_corners' to
    send to the twin, and no launch is counted."""
    before = binning_cuda.LAUNCHES
    setup = case_setup("few_rows")
    with pytest.raises(ValueError, match="CUDA tensors"):
        binning_cuda.bin_triangles(setup, 1920, 1080, 32, 128, 512)
    with pytest.raises(ValueError, match="CUDA tensors"):
        binning_cuda.bin_counts(setup, 1920, 1080, 32, 128)
    assert binning_cuda.LAUNCHES == before


def model_kernel(setup, width, height, tile_h, tile_w, capacity, y_offset):
    """csrc/binning.cu's three passes in torch: each row's rectangle of
    slab tiles (the kernel's f32 divisions and 64-bit clamps), a
    (chunks, tiles) table of counts per chunk of CHUNK ids, its exclusive
    scan over the chunks, and each id stored at its chunk's offset plus
    its rank among the chunk's ids in the tile; slots no id reaches hold
    -1. Returns (bins, counts, drops)."""
    data, valid = setup.data, setup.valid
    t = data.shape[0]
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    n_tiles, ty_off = tiles_x * tiles_y, y_offset // tile_h
    a = data[:, 12:16]
    tx0 = to_i32(torch.floor(a[:, 0] / tile_w)).long()
    ty0 = to_i32(torch.floor(a[:, 1] / tile_h)).long()
    tx1 = to_i32(torch.floor((a[:, 2] - 1e-6) / tile_w)).long()
    ty1 = to_i32(torch.floor((a[:, 3] - 1e-6) / tile_h)).long()
    x0, x1 = tx0.clamp(min=0), tx1.clamp(max=tiles_x - 1)
    y0 = (ty0 - ty_off).clamp(0, tiles_y)
    y1 = (ty1 - ty_off).clamp(-1, tiles_y - 1)
    tx = torch.arange(n_tiles) % tiles_x
    ty = torch.arange(n_tiles) // tiles_x
    cover = (valid[:, None] & (x0[:, None] <= tx) & (tx <= x1[:, None])
             & (y0[:, None] <= ty) & (ty <= y1[:, None]))    # (T, tiles)
    n_chunks = -(-t // CHUNK)
    padded = torch.zeros((n_chunks * CHUNK, n_tiles), dtype=torch.long)
    padded[:t] = cover.long()
    per_chunk = padded.view(n_chunks, CHUNK, n_tiles)
    table = per_chunk.sum(1)                                 # count pass
    offsets = table.cumsum(0) - table                        # scan pass
    total = table.sum(0)
    counts = total.clamp(max=capacity).int()
    drops = int((total - capacity).clamp(min=0).sum())
    rank = (per_chunk.cumsum(1) - per_chunk).view(-1, n_tiles)[:t]
    ids, tiles = cover.nonzero(as_tuple=True)                # scatter pass
    slot = offsets[ids // CHUNK, tiles] + rank[ids, tiles]
    keep = slot < capacity
    bins = torch.full((n_tiles, capacity), -1, dtype=torch.int32)
    bins[tiles[keep], slot[keep]] = ids[keep].int()
    return bins, counts, drops


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(BINNING_CASES))
def test_kernel_model_equals_twin(name, seed):
    """The model of K12 == bin_triangles bit for bit, bins, counts and
    the drops it adds to its counter: the main pass's and the cascades'
    tiles, slabs below y_offset, capacities below the fullest tile, fewer
    rows than the capacity, none, a capacity of 0, 8-row tiles, a ragged
    last chunk and 5x6 tiles; AABBs on tile edges and on the frame's
    right and bottom edges, invalid rows with an AABB, NaN, +/-inf and
    out-of-range corners."""
    setup = case_setup(name, seed)
    width, sh, th, tw, cap, y0 = case_args(name)
    before = profiling.drop_counts("cpu")["raster.capacity"]
    bins, counts = binning.bin_triangles(setup, width, sh, th, tw, cap, y0,
                                         drops="raster.capacity")
    drops = profiling.drop_counts("cpu")["raster.capacity"] - before
    m_bins, m_counts, m_drops = model_kernel(setup, width, sh, th, tw, cap,
                                             y0)
    assert torch.equal(m_bins, bins) and torch.equal(m_counts, counts)
    assert m_drops == drops
    if name.startswith("tight"):
        assert drops > 0 and int(counts.max()) == cap
    if name not in ("no_rows", "zero_capacity"):
        assert int(counts.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(BINNING_CASES))
def test_twin_equals_jax(name, seed):
    """The twin == the JAX package's bin_triangles bit for bit on every
    case and seed: bins and counts, and the drops the twin adds to its
    counter == the entries past the capacity in JAX's counts at a capacity
    of every row. The cases reach XLA's f32 -> s32 conversion with NaN,
    +/-inf and 3e9 corners, which the twin's to_i32 and the kernel's
    clamps reproduce."""
    data, valid = binning_case(name, seed)
    width, sh, th, tw, cap, y0 = case_args(name)
    before = profiling.drop_counts("cpu")["raster.capacity"]
    bins, counts = binning.bin_triangles(
        TriangleSetup(torch.from_numpy(data), torch.from_numpy(valid)),
        width, sh, th, tw, cap, y0, drops="raster.capacity")
    drops = profiling.drop_counts("cpu")["raster.capacity"] - before
    jsetup = jbin.TriangleSetup(data=jnp.asarray(data),
                                valid=jnp.asarray(valid))
    j_bins, j_counts = jbin.bin_triangles(jsetup, width, sh, th, tw, cap, y0)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(j_bins))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    _, j_total = jbin.bin_triangles(jsetup, width, sh, th, tw,
                                    max(len(data), 1), y0)
    j_total = np.asarray(j_total).astype(np.int64)
    assert drops == int(np.maximum(j_total - cap, 0).sum())


def rastered_config(**raster):
    """The rastered deployment's flags (committed, cascades rastered in
    full) at 256x144 with 256^2 maps."""
    return tf.GltfConfig(
        width=256, height=144, shadow_map_size=256,
        raster=RasterConfig(tile_h=32, tile_w=128, **raster),
        shadow_raster=RasterConfig(tile_h=128, tile_w=256, **raster),
        flags=tf.GltfFrameFlags(committed=True))


def test_frame_binnings_pass_check_args(monkeypatch):
    """Every binning of a rastered committed frame on the multimesh scene
    at 256x144 with 256^2 maps (four cascades and the main pass) passes
    check_args, and "auto" bins CPU tensors with the twin: no K12 call."""
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    cfg = rastered_config()
    calls = []
    plain = raster.bin_triangles

    def record(setup, width, height, tile_h, tile_w, capacity, y_offset=0,
               drops=None):
        calls.append(binning_cuda.check_args(setup, width, height, tile_h,
                                             tile_w, capacity))
        return plain(setup, width, height, tile_h, tile_w, capacity,
                     y_offset, drops)

    monkeypatch.setattr(raster, "bin_triangles", record)
    before = binning_cuda.LAUNCHES
    tf.render_gltf_frame(scene, params, tf.init_frame_state(cfg, "cpu"), cfg)
    assert binning_cuda.LAUNCHES == before
    assert calls == [(1, 2)] * 4 + [(2, 5)], calls


def test_kernel_route_bins_with_k12(monkeypatch):
    """backend "cuda" bins with K12 and "torch" with the twin: the kernel
    wrappers are replaced by recorders that run the plain twins, on the
    rastered frame's five rasters."""
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    calls = []
    plain_bin, plain_raster = raster.bin_triangles, raster._rasterize_torch

    def k12(*args, **kw):
        calls.append("K12")
        return plain_bin(*args, **kw)

    def k1(setup_data, bins, counts, w, h, th, tw, y0):
        calls.append("K1")
        rows = binning.gather_bin_data(TriangleSetup(setup_data, None), bins)
        return plain_raster(rows, bins, counts, y0, w, h,
                            RasterConfig(tile_h=th, tile_w=tw))

    from funky_tpu_torch.ops import raster_cuda

    monkeypatch.setattr(binning_cuda, "bin_triangles", k12)
    monkeypatch.setattr(raster_cuda, "raster_table_cuda", k1)
    out = {}
    for backend in ("cuda", "torch"):
        cfg = rastered_config(backend=backend)
        rgba, state = tf.render_gltf_frame(
            scene, params, tf.init_frame_state(cfg, "cpu"), cfg)
        out[backend] = (rgba, state.prev_depth)
    assert calls == ["K12", "K1"] * 5
    for a, b in zip(out["cuda"], out["torch"]):
        assert torch.equal(a, b)


def test_table_limit_is_the_cards():
    """The route's one switch: a (T, 16) f32 table of up to 32 MiB takes
    K1, so the 74,880-row rastered frame's tables (4.6 MiB) take it and
    the pre-gather goes."""
    assert raster.TABLE_LIMIT_BYTES == 32 * 1024 * 1024
    assert 74_880 * 64 <= raster.TABLE_LIMIT_BYTES < 524_289 * 64


@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
def test_occupancy_follows_the_backend(monkeypatch, backend):
    """raster.bin_occupancy (the tune's occupancy) counts with K12's
    counts-only call exactly where use_kernel picks the kernels (backend
    "cuda"; "auto" on a card), as raster_corners bins, and with the twin
    elsewhere; the wrapper is replaced by a recorder running the twin's
    counts. Both give binning._stats' dict."""
    setup = case_setup("main")
    calls = []

    def counts_only(setup, width, height, tile_h, tile_w):
        calls.append((width, height, tile_h, tile_w))
        return binning.bin_triangles(setup, width, height, tile_h, tile_w,
                                     setup.data.shape[0])[1]

    monkeypatch.setattr(binning_cuda, "bin_counts", counts_only)
    got = raster.bin_occupancy(setup, 1920, 1080, RasterConfig(
        tile_h=32, tile_w=128, backend=backend))
    assert calls == ([(1920, 1080, 32, 128)] if backend == "cuda" else [])
    want = binning._stats(setup, 1920, 1080, 32, 128)
    assert set(got) == set(want)
    for key in ("max", "total", "n_tiles"):
        assert int(got[key]) == int(want[key]), key


def test_stats_counts_match_the_bins():
    """binning._stats (the tune's occupancy) on the CPU: the twin's
    counts at a capacity of every row, max, mean, total and tile count."""
    setup = case_setup("main")
    _, counts = binning.bin_triangles(setup, 1920, 1080, 32, 128, 6000)
    got = binning._stats(setup, 1920, 1080, 32, 128)
    assert int(got["max"]) == int(counts.max())
    assert int(got["total"]) == int(counts.sum())
    assert got["n_tiles"] == counts.shape[0] == 510
    np.testing.assert_allclose(float(got["mean"]),
                               float(counts.float().mean()))
