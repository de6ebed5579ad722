"""The light-map kernel K5 (funky_tpu_torch/csrc/lightmap.cu through
ops/lightmap_cuda.py::light_map) against its plain twin
(passes/shadow_lightspace.py::build_light_shadow_map_plain), on the card,
on windows of 256^2, 512^2 and 768^2 at the map's interior, edges and
corners, past S - wc and at negative origins, at every tile height the
kernel takes, and the light-space frame that launches it recorded as a
CUDA graph. Every
test here needs an NVIDIA GPU and skips without one. The module imports no
jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_lightmap_cuda.py

Tolerance: none. The kernel repeats the twin's f32 operations in the
twin's order without contraction (torch's division by a host number as
its multiply by the reciprocal), so the rows are equal bit for bit.
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
from funky_tpu_torch.ops import lightmap_cuda
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.passes import shadow_lightspace
from funky_tpu_torch.passes.uniforms import FrameUniforms

from .torch_scenes import light_map_case, light_uniform_fields

pytestmark = pytest.mark.cuda

S = 1024
MAX_SOFTNESS = 4.0
BIAS = 0.003
# name -> (softness, use_pcss): PCSS, 16 Vogel taps (radius 3 > 1.25) and
# the 3x3 kernel (radius 1).
MODES = {"pcss": (2.5, True), "pcf_vogel": (3.0, False),
         "pcf_3x3": (1.0, False)}
# (oy, ox) per window size: at 0, at S - wc, odd in y, odd in x, odd in both
ORIGINS = ((0, 0), "end", (333, 256), (128, 517), (101, 77))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def bits(x: torch.Tensor) -> np.ndarray:
    return x.cpu().reshape(-1).contiguous().numpy().view(np.uint8)


def map_args(dev, mode, wc, origin, phases=4, rungs=6):
    softness, use_pcss = MODES[mode]
    plane, raw = light_map_case(S)
    uni = FrameUniforms(**{k: torch.from_numpy(v).to(dev) for k, v in
                           light_uniform_fields(softness, S).items()})
    if origin == "end":
        origin = (S - wc, S - wc)
    org = tuple(torch.tensor(o, dtype=torch.int32, device=dev)
                for o in origin)
    return (torch.from_numpy(raw).to(dev), org,
            torch.from_numpy(plane).to(dev), uni, use_pcss, wc,
            MAX_SOFTNESS, torch.tensor(BIAS, device=dev), rungs, phases)


@pytest.mark.parametrize("origin", ORIGINS, ids=str)
@pytest.mark.parametrize("wc", [256, 768])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_kernel_bit_equal_to_plain(dev, mode, wc, origin):
    args = map_args(dev, mode, wc, origin)
    before = lightmap_cuda.LAUNCHES
    got = shadow_lightspace.build_light_shadow_map(*args)
    torch.cuda.synchronize()
    assert lightmap_cuda.LAUNCHES - before == 1
    want = shadow_lightspace.build_light_shadow_map_plain(*args)
    assert got.shape == (wc * wc, 4) and got.is_contiguous()
    np.testing.assert_array_equal(bits(got), bits(want))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("phases, rungs", [(1, 6), (2, 2), (3, 4)])
def test_phases_and_rungs_bit_equal_to_plain(dev, phases, rungs):
    args = map_args(dev, "pcss", 256, (101, 77), phases=phases, rungs=rungs)
    got = shadow_lightspace.build_light_shadow_map(*args)
    want = shadow_lightspace.build_light_shadow_map_plain(*args)
    np.testing.assert_array_equal(bits(got), bits(want))


def origins(wc):
    """name -> (oy, ox): the interior, every edge and corner of the map,
    past S - wc (the slice's start clamps) and negative (it counts from
    the padded map's end)."""
    e = S - wc
    return {"interior": (301, 419 % (e + 1)), "top": (0, e // 2 + 1),
            "bottom": (e, e // 3), "left": (e // 2 + 3, 0),
            "right": (e // 4, e), "top_left": (0, 0), "top_right": (0, e),
            "bottom_left": (e, 0), "bottom_right": (e, e),
            "past_end": (e + 37, e + 101), "negative": (-5, -17),
            "negative_far": (-300, 41)}


@pytest.mark.parametrize("where", sorted(origins(256)))
@pytest.mark.parametrize("wc", [256, 512, 768])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_edges_and_corners_bit_equal_to_plain(dev, mode, wc, where):
    """Windows of every size the frame uses, at every edge and corner of
    the map, past S - wc and negative: the staged tile's border, the
    slice's clamped start and the window's last-row and last-column clamp
    (tiles at the window's right and bottom edges) equal the twin's."""
    args = map_args(dev, mode, wc, origins(wc)[where])
    got = shadow_lightspace.build_light_shadow_map(*args)
    want = shadow_lightspace.build_light_shadow_map_plain(*args)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("where", ["bottom_right", "negative"])
@pytest.mark.parametrize("wc", [512, 768])
@pytest.mark.parametrize("phases, rungs", [(1, 6), (2, 2), (3, 4)])
def test_phases_and_rungs_on_large_windows(dev, phases, rungs, wc, where):
    args = map_args(dev, "pcss", wc, origins(wc)[where], phases=phases,
                    rungs=rungs)
    got = shadow_lightspace.build_light_shadow_map(*args)
    want = shadow_lightspace.build_light_shadow_map_plain(*args)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("rows", lightmap_cuda.ROWS)
@pytest.mark.parametrize("wc", [256, 333])
def test_tile_rows_bit_equal_to_plain(dev, monkeypatch, wc, rows):
    """Every tile height the kernel takes, on a window that no tile size
    divides (333) and on the frame's smallest: equal to the twin."""
    monkeypatch.setattr(lightmap_cuda, "tile_rows", lambda _: rows)
    args = map_args(dev, "pcss", wc, (101, 77))
    got = shadow_lightspace.build_light_shadow_map(*args)
    want = shadow_lightspace.build_light_shadow_map_plain(*args)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_wrong_arguments_raise(dev):
    """A CUDA call the kernel cannot take raises; it never falls back."""
    args = list(map_args(dev, "pcss", 256, (0, 0)))
    raw = args[0]
    args[0] = raw.t()                                  # not contiguous
    with pytest.raises(ValueError, match="^raw_map:"):
        shadow_lightspace.build_light_shadow_map(*args)
    args[0] = raw.double()
    with pytest.raises(TypeError, match="^raw_map:"):
        shadow_lightspace.build_light_shadow_map(*args)
    args[0], args[5] = raw, S + 8                      # window past the map
    with pytest.raises(ValueError, match="^wc:"):
        shadow_lightspace.build_light_shadow_map(*args)


def test_lightspace_frame_graph_equals_eager(dev):
    """The committed light-space frame (synthesized maps, the back-face
    skip) on the multimesh scene, recorded as a CUDA graph: K5 counted at
    capture once per light window, and three chained frames equal the
    eager frames in rgba and every FrameState field."""
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
        light_window_sizes=(256, 256, 256, 256),
        flags=frame.GltfFrameFlags(
            committed=True, synth_shadow_maps=True,
            light_space_ground_shadows=True, skip_backfacing_shadows=True))
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
    windows = sum(1 for s in cfg.effective_light_windows() if s)
    assert fn.last.launches["light_map"] == windows > 0
    names = ("rgba",) + frame.FrameState._fields
    for got, want in zip(*runs):
        for name, a, b in zip(names, got, want):
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
