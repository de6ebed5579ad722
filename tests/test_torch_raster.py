"""Port parity: the tile raster (funky_tpu_torch/ops/{binning,raster}.py)
against funky_tpu's, the route between the table kernel (K1) and the
pre-gathered one (K2), and the Hopper kernels' wrappers on the CPU.

Tolerances:
- tri_id, bins and counts are compared exactly.
- depth against jitted JAX: 1e-5. XLA on the CPU contracts the setup and
  plane expressions (a*x + b*y + c) into FMAs, torch eager never does, so
  depths differ by a few ulps scaled by the plane's cancellation
  (measured up to 1.9e-6 on these scenes). Against JAX with jit disabled
  (no fusion, so no contraction) the port is bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funky_tpu.ops import binning as jbin
from funky_tpu.ops import raster_pallas as jpallas
from funky_tpu.ops.raster import RasterConfig as JRC
from funky_tpu.ops.raster import raster_scene as jraster_scene

from funky_tpu_torch.ops import binning as tbin
from funky_tpu_torch.ops import raster as traster
from funky_tpu_torch.ops import raster_cuda
from funky_tpu_torch.ops.raster import RasterConfig as TRC

from .torch_parity import t2n
from .torch_scenes import random_clip_scene

WIDTH, HEIGHT = 128, 64
DEPTH_TOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    return random_clip_scene(seed=0)


def jax_raster(clip, tris, cfg, y_offset=0, slice_height=None):
    def go():
        tri_id, depth, setup = jraster_scene(
            jnp.asarray(clip), jnp.asarray(tris), WIDTH, HEIGHT, len(tris),
            cfg, y_offset=y_offset, slice_height=slice_height)
        return np.asarray(tri_id), np.asarray(depth), setup
    if cfg.backend == "pallas":
        with pltpu.force_tpu_interpret_mode():
            return go()
    return go()


def port_raster(clip, tris, cfg, y_offset=0, slice_height=None):
    tri_id, depth, setup = traster.raster_scene(
        torch.from_numpy(clip), torch.from_numpy(tris), WIDTH, HEIGHT,
        len(tris), cfg, y_offset=y_offset, slice_height=slice_height)
    return t2n(tri_id), t2n(depth), setup


CASES = {
    "full": dict(capacity=None, y_offset=0, slice_height=None),
    "tight": dict(capacity=4, y_offset=0, slice_height=None),
    "slab": dict(capacity=None, y_offset=32, slice_height=16),
}


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_raster_matches_jax(scene, backend, case):
    """Plain torch raster vs JAX's jnp path and its Pallas table kernel
    (interpret mode): full capacity, an overflowing tight capacity and a
    row slab."""
    clip, tris = scene
    c = CASES[case]
    jcfg = JRC(tile_h=8, tile_w=128, capacity=c["capacity"], backend=backend)
    tcfg = TRC(tile_h=8, tile_w=128, capacity=c["capacity"], backend="torch")
    id_j, z_j, _ = jax_raster(clip, tris, jcfg, c["y_offset"],
                              c["slice_height"])
    id_t, z_t, _ = port_raster(clip, tris, tcfg, c["y_offset"],
                               c["slice_height"])
    np.testing.assert_array_equal(id_t, id_j)
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=DEPTH_TOL)
    if case == "tight":   # the capacity really drops triangles somewhere
        full_id, _, _ = port_raster(clip, tris, TRC(tile_h=8, tile_w=128))
        assert (full_id != id_t).any()


@pytest.mark.parametrize("capacity", [None, 4])
def test_setup_and_bins_match_jax(scene, capacity):
    clip, tris = scene
    jsetup = jbin.triangle_setup(jnp.asarray(clip), jnp.asarray(tris),
                                 WIDTH, HEIGHT, len(tris))
    tsetup = tbin.triangle_setup(torch.from_numpy(clip),
                                 torch.from_numpy(tris), WIDTH, HEIGHT,
                                 len(tris))
    np.testing.assert_array_equal(t2n(tsetup.valid), np.asarray(jsetup.valid))
    np.testing.assert_allclose(t2n(tsetup.data), np.asarray(jsetup.data),
                               rtol=1e-5, atol=1e-5)
    cap = len(tris) if capacity is None else capacity
    jb, jc = jbin.bin_triangles(jsetup, WIDTH, HEIGHT, 8, 128, cap)
    tb, tc = tbin.bin_triangles(tsetup, WIDTH, HEIGHT, 8, 128, cap)
    np.testing.assert_array_equal(t2n(tb), np.asarray(jb))
    np.testing.assert_array_equal(t2n(tc), np.asarray(jc))
    jg = np.asarray(jbin.gather_bin_data(jsetup, jb))
    tg = t2n(tbin.gather_bin_data(tsetup, tb))
    np.testing.assert_array_equal(tg[..., 12].view(np.int32),
                                  jg[..., 12].view(np.int32))
    np.testing.assert_allclose(tg[..., :12], jg[..., :12], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_raster_bit_exact_against_unfused_jax(seed):
    """With jit disabled XLA fuses nothing, so no FMA contraction: the
    port then reproduces JAX's raster bit for bit."""
    clip, tris = random_clip_scene(seed=seed, n_tris=60)
    cfg = JRC(tile_h=8, tile_w=128, capacity=None, backend="jnp")
    with jax.disable_jit():
        id_j, z_j, s_j = jax_raster(clip, tris, cfg)
    id_t, z_t, s_t = port_raster(clip, tris, TRC(tile_h=8, tile_w=128))
    np.testing.assert_array_equal(t2n(s_t.data), np.asarray(s_j.data))
    np.testing.assert_array_equal(id_t, id_j)
    np.testing.assert_array_equal(z_t, z_j)


def test_coplanar_ties_keep_first_drawn():
    """Two identical triangles at equal depth: the lower id wins (LESS),
    in both packages."""
    clip, _ = random_clip_scene(seed=2, n_tris=4)
    clip = np.concatenate([clip[:3], clip[:3], clip[3:6]])
    tris = np.arange(9, dtype=np.int32).reshape(3, 3)
    id_j, z_j, _ = jax_raster(clip, tris, JRC(tile_h=8, tile_w=128,
                                              backend="jnp"))
    id_t, z_t, _ = port_raster(clip, tris, TRC(tile_h=8, tile_w=128))
    np.testing.assert_array_equal(id_t, id_j)
    assert (id_t == 0).any() and not (id_t == 1).any()


def test_auto_backend_takes_the_plain_twin_on_cpu(scene):
    """backend="auto" rasters CPU tensors with the plain twin (no kernel
    launch); backend="cuda" on CPU tensors raises instead of falling
    back."""
    clip, tris = scene
    before = raster_cuda.LAUNCHES
    id_a, z_a, _ = port_raster(clip, tris, TRC(tile_h=8, tile_w=128))
    id_p, z_p, _ = port_raster(clip, tris, TRC(tile_h=8, tile_w=128,
                                               backend="torch"))
    assert raster_cuda.LAUNCHES == before
    np.testing.assert_array_equal(id_a, id_p)
    np.testing.assert_array_equal(z_a, z_p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_raster(clip, tris, TRC(tile_h=8, tile_w=128, backend="cuda"))
    with pytest.raises(ValueError, match="backend"):
        TRC(backend="pallas")


@pytest.mark.parametrize("case", sorted(CASES))
def test_pregather_route_matches_pallas_padded(scene, case, monkeypatch):
    """With the table limit patched to 0 every raster takes the
    pre-gather route: gather_bin_data, then (on the CPU) the plain twin.
    It matches JAX's _rasterize_pallas_padded run in interpret mode on
    JAX's own pre-gathered rows: tri_id equal, depth within DEPTH_TOL
    (the interpreted kernel body is jitted, so XLA contracts its planes)."""
    monkeypatch.setattr(traster, "TABLE_LIMIT_BYTES", 0)
    clip, tris = scene
    c = CASES[case]
    sh = HEIGHT if c["slice_height"] is None else c["slice_height"]
    jcfg = JRC(tile_h=8, tile_w=128, capacity=c["capacity"], backend="jnp")
    jsetup = jbin.triangle_setup(jnp.asarray(clip), jnp.asarray(tris),
                                 WIDTH, HEIGHT, len(tris))
    cap = jcfg.resolve_capacity(len(tris))
    jb, jc = jbin.bin_triangles(jsetup, WIDTH, sh, 8, 128, cap,
                                c["y_offset"])
    with pltpu.force_tpu_interpret_mode():
        id_j, z_j = jpallas.rasterize_pallas(
            jbin.gather_bin_data(jsetup, jb), jb, jc, WIDTH, sh, jcfg,
            c["y_offset"])
    tcfg = TRC(tile_h=8, tile_w=128, capacity=c["capacity"])
    id_t, z_t, _ = port_raster(clip, tris, tcfg, c["y_offset"],
                               c["slice_height"])
    np.testing.assert_array_equal(id_t, np.asarray(id_j))
    np.testing.assert_allclose(z_t, np.asarray(z_j), rtol=0, atol=DEPTH_TOL)


@pytest.mark.parametrize("over", [0, 1], ids=["at_limit", "past_limit"])
def test_route_selection_at_the_table_limit(scene, monkeypatch, over):
    """On a card, raster_corners takes K1 exactly when T * 64 bytes fit
    TABLE_LIMIT_BYTES and K2, on pre-gathered rows, past it. The kernel
    wrappers are replaced by recorders that run the plain twin."""
    from funky_tpu_torch.ops.binning import TriangleSetup

    clip, tris = scene
    t_rows = len(tris)
    monkeypatch.setattr(traster, "TABLE_LIMIT_BYTES", t_rows * 64 - over)
    calls = []
    cfg = TRC(tile_h=8, tile_w=128, backend="cuda")
    plain = TRC(tile_h=8, tile_w=128, backend="torch")

    def table(setup_data, bins, counts, w, h, th, tw, y0):
        calls.append("K1")
        rows = tbin.gather_bin_data(TriangleSetup(setup_data, None), bins)
        return traster._rasterize_torch(rows, bins, counts, y0, w, h, plain)

    def padded(bin_data, counts, w, h, th, tw, y0):
        calls.append("K2")
        bins = bin_data[..., 12].contiguous().view(torch.int32)
        return traster._rasterize_torch(bin_data, bins, counts, y0, w, h,
                                        plain)

    monkeypatch.setattr(raster_cuda, "raster_table_cuda", table)
    monkeypatch.setattr(raster_cuda, "raster_padded_cuda", padded)
    id_k, z_k, _ = port_raster(clip, tris, cfg)
    id_p, z_p, _ = port_raster(clip, tris, plain)
    assert calls == (["K2"] if over else ["K1"])
    np.testing.assert_array_equal(id_k, id_p)
    np.testing.assert_array_equal(z_k, z_p)


def test_padded_wrapper_refuses_cpu_tensors():
    rows = torch.zeros((2, 8, 16))
    counts = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        raster_cuda.raster_padded_cuda(rows, counts, 256, 8, 8, 128)
