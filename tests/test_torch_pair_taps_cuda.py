"""The pair-tap kernel K6 (funky_tpu_torch/csrc/pair_taps.cu through
ops/pair_taps_cuda.py::pair_taps) against its plain twins (passes/
shadow_filter.py::_pcss_taps_plain, _pcf_taps_plain), on the card, at
every lane width the kernel takes, at launch sizes that leave the last
warp partial, with live counts (none, an odd split, all, past the slots),
and the committed shipped frame that launches it (with K7) recorded as a
CUDA graph. Every test here needs an NVIDIA GPU and skips without one. The
module imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_pair_taps_cuda.py

Tolerance: none. The kernel repeats the twins' f32 operations in their
order without contraction (torch's division by a host number as its
multiply by the reciprocal, cosf / sinf / sqrt as torch's), so the rows
are equal bit for bit.
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
from funky_tpu_torch.ops import pair_taps_cuda, sampling
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.passes import shadow_filter as tsf
from funky_tpu_torch.passes.uniforms import FrameUniforms

from .torch_scenes import light_uniform_fields, pair_taps_case

pytestmark = pytest.mark.cuda

S = 1024
N = 50_000
# name -> (softness, use_pcss, radius_only), as in
# tests/test_torch_pair_taps_kernel.py
MODES = {"pcss": (2.5, True, False), "radius_only": (2.5, True, True),
         "pcf_vogel": (2.5, False, False), "pcf_3x3": (1.0, False, False)}
# (cascade, origin (oy, ox), window side): inside, at S - Wc, past S - Wc
WINDOWS = {"inside": (1, (300, 517), 256), "at_end": (2, (768, 768), 256),
           "past_end": (3, (900, 811), 256)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().reshape(-1).contiguous().view(
        torch.uint8).numpy()


def uniforms(dev, softness):
    return FrameUniforms(**{k: torch.from_numpy(v).to(dev) for k, v in
                            light_uniform_fields(softness, S).items()})


def taps(mode, uni, maps, layer, uv, recv, phi, window=None, plain=False):
    _, use_pcss, radius_only = MODES[mode]
    if use_pcss:
        fn = tsf._pcss_taps_plain if plain else tsf._pcss_taps
        return fn(uni, maps, layer, uv, recv, phi, window, radius_only)
    fn = tsf._pcf_taps_plain if plain else tsf._pcf_taps
    return fn(uni, maps, layer, uv, recv, phi, window)


def check_bits(mode, args, window=None):
    before = pair_taps_cuda.LAUNCHES
    got = taps(mode, *args, window=window)
    torch.cuda.synchronize()
    assert pair_taps_cuda.LAUNCHES - before == 1
    want = taps(mode, *args, window=window, plain=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_array_equal(bits(g), bits(w), err_msg=str(i))


def packed_args(dev, mode, seed=0, n=N, edges=True):
    depth, uv, layer, recv, phi = pair_taps_case(seed, n, S, edges=edges)
    maps = sampling.quad_pack(torch.from_numpy(depth).to(dev))
    return (uniforms(dev, MODES[mode][0]), maps,
            *(torch.from_numpy(a).to(dev) for a in (layer, uv, recv, phi)))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_packed_bit_equal_to_plain(dev, mode):
    """Random entries over the packed maps, each at its own layer, with the
    edge entries (NaN, infinite and far-off uv, texel boundaries, a NaN
    receiver)."""
    check_bits(mode, packed_args(dev, mode))


@pytest.mark.parametrize("mode", ["pcss", "pcf_vogel"])
def test_strided_and_batched_inputs(dev, mode):
    """The pair groups' inputs are column views of one (N, 4) payload; the
    dense filter's are (H, W) batches: both read in place, equal to the
    twin."""
    uni, maps, layer, uv, recv, phi = packed_args(dev, mode, seed=1)
    payload = torch.cat([uv, recv[:, None], phi[:, None]], dim=-1)
    check_bits(mode, (uni, maps, layer, payload[:, :2], payload[:, 2],
                      payload[:, 3]))
    hw = (100, N // 100)
    check_bits(mode, (uni, maps, layer.reshape(hw), uv.reshape(hw + (2,)),
                      recv.reshape(hw), phi.reshape(hw)))


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("origin_kind", ["ints", "tensors"])
def test_window_bit_equal_to_plain(dev, mode, window, origin_kind):
    """Entries around a (Wc, Wc) window of one cascade, its rows sliced as
    the frame slices them and the origin passed as it is (host ints: the
    routed groups; int32 0-d tensors: the committed tap windows)."""
    c, (oy, ox), wc = WINDOWS[window]
    uni, maps, _, _, recv, phi = packed_args(dev, mode, seed=2, edges=False)
    rng = np.random.default_rng(3)
    lo = (np.array([ox, oy]) - 8) / S
    uv = torch.from_numpy((lo + rng.random((N, 2)) * (wc + 16) / S)
                          .astype(np.float32)).to(dev)
    origin = (oy, ox) if origin_kind == "ints" else tuple(
        torch.tensor(o, dtype=torch.int32, device=dev) for o in (oy, ox))
    rows = sampling.dynamic_slice(maps[c], origin, (wc, wc))
    layer0 = torch.zeros(N, dtype=torch.int32, device=dev)
    check_bits(mode, (uni, maps[c:c + 1], layer0, uv, recv, phi),
               window=(rows, origin, S))


def force_lanes(monkeypatch, lanes) -> None:
    """Make the wrapper launch `lanes` lanes per entry (None: its own
    choice, lanes_for)."""
    if lanes is not None:
        monkeypatch.setattr(pair_taps_cuda, "lanes_for", lambda n: lanes)


def kernel_rows(mode, args, window=None, count=None):
    """K6's rows through its wrapper."""
    uni, maps, layer, uv, recv, phi = args
    _, use_pcss, radius_only = MODES[mode]
    kmode = ("radius_only" if radius_only else "pcss") if use_pcss \
        else "pcf"
    before = pair_taps_cuda.LAUNCHES
    rows = pair_taps_cuda.pair_taps(maps, layer, uv, recv, phi,
                                    uni.shadow_map_size, uni.shadow_bias,
                                    kmode, window, count)
    torch.cuda.synchronize()
    assert pair_taps_cuda.LAUNCHES - before == (1 if uv.numel() else 0)
    return rows


def twin_rows(mode, args, window=None, count=None):
    """The plain twin's outputs as K6's rows."""
    uni, maps, layer, uv, recv, phi = args
    _, use_pcss, radius_only = MODES[mode]
    if use_pcss:
        m1, m2, pen, hasb = tsf._pcss_taps_plain(
            uni, maps, layer, uv, recv, phi, window, radius_only, count)
        return torch.stack([m1, m2, pen, hasb.to(torch.float32)], dim=-1)
    m1, m2, kern = tsf._pcf_taps_plain(uni, maps, layer, uv, recv, phi,
                                       window, count)
    return torch.stack([m1, m2, kern, torch.zeros_like(m1)], dim=-1)


def window_args(dev, mode, n=N, window="past_end"):
    """Entries around a window of one cascade (WINDOWS), an int32 origin
    on the card."""
    c, (oy, ox), wc = WINDOWS[window]
    uni, maps, _, _, recv, phi = packed_args(dev, mode, seed=2, n=n,
                                             edges=False)
    rng = np.random.default_rng(3)
    lo = (np.array([ox, oy]) - 8) / S
    uv = torch.from_numpy((lo + rng.random((n, 2)) * (wc + 16) / S)
                          .astype(np.float32)).to(dev)
    origin = tuple(torch.tensor(o, dtype=torch.int32, device=dev)
                   for o in (oy, ox))
    rows = sampling.dynamic_slice(maps[c], origin, (wc, wc))
    layer0 = torch.zeros(n, dtype=torch.int32, device=dev)
    return ((uni, maps[c:c + 1], layer0, uv, recv, phi),
            (rows, origin, S))


# Launch sizes: one entry, a partial last warp at 8 lanes (31 and 33
# entries: a last warp of three groups and of one), several waves at 8
# lanes and at 1.
SIZES = (1, 31, 33, 4099, 300_001)


@pytest.mark.parametrize("lanes", pair_taps_cuda.LANES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_lanes_and_sizes_bit_equal_to_plain(dev, mode, n, lanes,
                                            monkeypatch):
    """Every lane width the kernel takes, at group sizes that leave the
    last warp partial and at several waves: the rows equal the twin's."""
    args = packed_args(dev, mode, seed=5, n=n, edges=n > 40)
    force_lanes(monkeypatch, lanes)
    got = kernel_rows(mode, args)
    np.testing.assert_array_equal(bits(got), bits(twin_rows(mode, args)))


# count -> the live slots of an N-entry call: none, an odd split (a warp
# whose lane groups are partly live), all, and a committed overflow (the
# group's count past its capacity).
COUNTS = {"zero": 0, "partial": N // 2 + 1, "full": N, "over": N + 500}


@pytest.mark.parametrize("lanes", (None,) + pair_taps_cuda.LANES)
@pytest.mark.parametrize("count", sorted(COUNTS))
@pytest.mark.parametrize("source", ["packed", "window"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_count_bit_equal_to_plain(dev, mode, source, count, lanes,
                                  monkeypatch):
    """The live count on the card: slots at or past it are the row 0, the
    others the rows without a count, bit for bit, as the twin with the
    same count."""
    if source == "packed":
        args, window = packed_args(dev, mode, seed=6), None
    else:
        args, window = window_args(dev, mode)
    cnt = torch.tensor(COUNTS[count], dtype=torch.int32, device=dev)
    force_lanes(monkeypatch, lanes)
    got = kernel_rows(mode, args, window, cnt)
    np.testing.assert_array_equal(bits(got),
                                  bits(twin_rows(mode, args, window, cnt)))
    live = min(COUNTS[count], N)
    np.testing.assert_array_equal(
        bits(got[:live]), bits(kernel_rows(mode, args, window)[:live]))
    assert not bool(got[live:].any())


def test_count_through_the_dispatcher(dev):
    """_pcss_taps hands its count to K6: equal to the twin with it."""
    args = packed_args(dev, "pcss", seed=7)
    cnt = torch.full((1,), 777, dtype=torch.int32, device=dev)
    got = tsf._pcss_taps(*args, count=cnt)
    want = tsf._pcss_taps_plain(*args, count=cnt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))
    assert not bool(got[3][777:].any()) and bool(got[3][:777].any())


def test_wrong_arguments_raise(dev):
    """A CUDA call the kernel cannot take raises; it never falls back."""
    uni, maps, layer, uv, recv, phi = packed_args(dev, "pcss", n=64)
    with pytest.raises(TypeError, match="^uv:"):
        tsf._pcss_taps(uni, maps, layer, uv.double(), recv, phi)
    with pytest.raises(ValueError, match="^maps:"):
        tsf._pcss_taps(uni, maps[:, :, :512], layer, uv, recv, phi)
    with pytest.raises(TypeError, match="^layer:"):
        tsf._pcf_taps(uni, maps, layer.long(), uv, recv, phi)
    with pytest.raises(ValueError, match="^window rows:"):
        tsf._pcss_taps(uni, maps[:1], layer, uv, recv, phi,
                       window=(maps[0, :64, :64].transpose(0, 1), (0, 0), S))
    with pytest.raises(ValueError, match="^count:"):
        tsf._pcss_taps(uni, maps, layer, uv, recv, phi,
                       count=torch.tensor(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="^count:"):
        tsf._pcf_taps(uni, maps, layer, uv, recv, phi,
                      count=torch.tensor(3, device=dev))


def test_shipped_frame_graph_equals_eager(dev):
    """The committed shipped flags (synthesized maps) on the multimesh
    scene at 480x272 with every pair in the sparse groups, recorded as a
    CUDA graph: K6 and K7 counted at capture (K7 once, K6 once per group
    with a capacity), and three chained frames equal the eager frames in
    rgba and every FrameState field."""
    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(
            pathlib.Path(td) / "multi.glb", two_textures=True))
    params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                       gltf_scale=1.0, device=dev)
    scene = build_device_scene(gltf, device=dev)
    cfg = frame.GltfConfig(
        width=480, height=272, shadow_map_size=1024,
        raster=RasterConfig(tile_h=32, tile_w=128),
        shadow_raster=RasterConfig(tile_h=128, tile_w=256),
        shadow_pen_capacity=2 * 480 * 272, contact_capacity=480 * 272,
        contact_march_capacity=480 * 272,
        flags=frame.GltfFrameFlags(committed=True, synth_shadow_maps=True))
    fn = frame.compiled_gltf_frame(cfg)
    assert fn.uses_graph(dev)
    poses = [params] + [frame.orbit_params(params, i) for i in (1, 2)]
    runs = []
    for f in (fn, lambda s, p, st: frame.render_gltf_frame(s, p, st, cfg)):
        state = frame.init_frame_state(cfg, dev)
        run = []
        for p in poses:
            rgba, state = f(scene, p, state)
            run.append([rgba.cpu()] + [x.cpu() for x in state])
        runs.append(run)
    assert fn.last.launches["group_counts"] == 1
    assert fn.last.launches["pair_taps"] >= 4
    names = ("rgba",) + frame.FrameState._fields
    for got, want in zip(*runs):
        for name, a, b in zip(names, got, want):
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
