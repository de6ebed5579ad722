"""Port parity: the shadow filter's tap sets. passes/shadow_filter.py::
_pcss_taps and _pcf_taps send CUDA tensors to the kernel K6 (funky_tpu_torch/
ops/pair_taps_cuda.py::pair_taps) and CPU tensors to the plain twins
_pcss_taps_plain and _pcf_taps_plain; here the twins are held against the
JAX package's _pcss_taps and _pcf_taps (funky_tpu/passes/shadow_filter.py:
159-283) on the quad-packed maps, through a window of one cascade (origins
inside the map and past S - Wc, as host ints and as tensors), in
radius-only mode and for both fixed-radius PCF kernels; `check_args` is
held to the calls the kernel takes and refuses; and every tap call of a
dense, a default and a tuned shipped frame is shown to pass `check_args`,
so that no frame call raises on the card. The kernel itself runs on the
card only (tests/test_torch_pair_taps_cuda.py, chip_smoke.py).

Tolerance: tests/test_torch_passes.py's for the shadow filter. XLA and
torch round sin and cos of the Vogel angles differently, which moves a
tap by ulps: a bilinear weight moves by ulps times the map size, and a
nearest pick or a compare can flip. Every output within 5e-4 of JAX's on
all but 0.2% of the entries, has_blockers equal on the same share, and
NaN where JAX has NaN. On the CPU the dispatcher's result is the twin's,
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.ops.sampling import quad_pack as jquad_pack
from funky_tpu.passes import shadow_filter as jsf
from funky_tpu.passes.uniforms import FrameUniforms as JUniforms

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import pair_taps_cuda, sampling
from funky_tpu_torch.passes import shadow_filter as tsf
from funky_tpu_torch.passes.uniforms import FrameUniforms

from .test_torch_gather import _dense_config, _shipped_config
from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, t2n)
from .torch_scenes import light_uniform_fields, pair_taps_case

S = 64
N = 3000
TOL, FLIP_FRAC = 5e-4, 0.002
# name -> (softness, use_pcss, radius_only): PCSS, its radius-only mode,
# fixed-radius PCF with 16 Vogel taps (radius 2.5 > 1.25) and the 3x3
# kernel (radius 1).
MODES = {"pcss": (2.5, True, False), "radius_only": (2.5, True, True),
         "pcf_vogel": (2.5, False, False), "pcf_3x3": (1.0, False, False)}
# (cascade, origin (oy, ox), window side): inside the map, at S - Wc, and
# past S - Wc (the window's rows start clamped, the index uses the origin
# as passed).
WINDOWS = {"inside": (1, (9, 30), 24), "at_end": (2, (40, 40), 24),
           "past_end": (3, (50, 47), 24)}


def T(x):
    return torch.from_numpy(np.array(x))


def uniforms(softness):
    fields = light_uniform_fields(softness, S)
    return (JUniforms(**{k: jnp.asarray(v) for k, v in fields.items()}),
            FrameUniforms(**{k: T(v) for k, v in fields.items()}))


def close_to_jax(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), name)
    ok = ~np.isnan(want)
    over = float((np.abs(got[ok] - want[ok]) > TOL).mean())
    assert over <= FLIP_FRAC, (name, over)


def port_call(mode, uni, maps, layer, uv, recv, phi, window=None,
              fn_pcss=tsf._pcss_taps, fn_pcf=tsf._pcf_taps):
    _, use_pcss, radius_only = MODES[mode]
    if use_pcss:
        return fn_pcss(uni, maps, layer, uv, recv, phi, window=window,
                       radius_only=radius_only)
    return fn_pcf(uni, maps, layer, uv, recv, phi, window=window)


def jax_call(mode, uni, maps, layer, uv, recv, phi, window=None):
    _, use_pcss, radius_only = MODES[mode]
    if use_pcss:
        return jsf._pcss_taps(uni, maps, layer, uv, recv, phi,
                              window=window, radius_only=radius_only)
    return jsf._pcf_taps(uni, maps, layer, uv, recv, phi, window=window)


def compare(mode, got, want):
    names = ("m1", "m2", "penumbra", "has_blockers") if MODES[mode][1] \
        else ("m1", "m2", "kernel")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        close_to_jax(t2n(g).astype(np.float32), np.asarray(w, np.float32),
                     f"{mode} {name}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_packed_twin_matches_jax(mode):
    """The twins on the packed maps, every entry's own layer, random and
    edge entries (NaN, infinite and far-off uv, texel boundaries, a NaN
    receiver), against JAX's tap cores; and the dispatcher takes the twin
    for CPU tensors without a launch."""
    depth, uv, layer, recv, phi = pair_taps_case(0, N, S)
    juni, uni = uniforms(MODES[mode][0])
    jmaps = jquad_pack(jnp.asarray(depth))
    maps = T(np.asarray(jmaps))
    args = (T(layer), T(uv), T(recv), T(phi))
    before = pair_taps_cuda.LAUNCHES
    got = port_call(mode, uni, maps, *args)
    assert pair_taps_cuda.LAUNCHES == before
    plain = port_call(mode, uni, maps, *args, fn_pcss=tsf._pcss_taps_plain,
                      fn_pcf=tsf._pcf_taps_plain)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(t2n(g), t2n(p))
    want = jax_call(mode, juni, jmaps, *(jnp.asarray(a) for a in
                                         (layer, uv, recv, phi)))
    compare(mode, got, want)
    if MODES[mode][1]:
        hasb = t2n(got[3])
        assert 0.05 < hasb.mean() < 0.95      # some entries see blockers
    if MODES[mode][2]:
        assert (t2n(got[0]) == 1.0).all() and (t2n(got[1]) == 1.0).all()


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("origin_kind", ["ints", "tensors"])
def test_window_twin_matches_jax(mode, window, origin_kind):
    """The twins reading a (Wc, Wc) window of one cascade, the rows sliced
    as the frame slices them (dynamic_slice: the start clamped into the
    map) and the origin passed as it is, entries around the window so that
    taps fall inside it and clamp to its edge; origins as host ints (the
    routed groups) and as int32 0-d tensors (the committed tap windows)."""
    c, (oy, ox), wc = WINDOWS[window]
    depth, uv, layer, recv, phi = pair_taps_case(1, N, S, edges=False)
    # entries around the window, a few texels past its edge
    rng = np.random.default_rng(2)
    lo = (np.array([ox, oy]) - 3) / S
    uv = (lo + rng.random((N, 2)) * (wc + 6) / S).astype(np.float32)
    juni, uni = uniforms(MODES[mode][0])
    jmaps = jquad_pack(jnp.asarray(depth))
    maps = T(np.asarray(jmaps))
    sy, sx = min(oy, S - wc), min(ox, S - wc)      # dynamic_slice's clamp
    jrows = jnp.asarray(np.asarray(jmaps)[c, sy:sy + wc, sx:sx + wc])
    if origin_kind == "ints":
        origin = (oy, ox)
    else:
        origin = (torch.tensor(oy, dtype=torch.int32),
                  torch.tensor(ox, dtype=torch.int32))
    rows = sampling.dynamic_slice(maps[c], origin, (wc, wc))
    np.testing.assert_array_equal(t2n(rows), np.asarray(jrows))
    zeros = np.zeros(N, np.int32)
    got = port_call(mode, uni, maps[c:c + 1], T(zeros), T(uv), T(recv),
                    T(phi), window=(rows, origin, S))
    want = jax_call(mode, juni, jmaps[c:c + 1], jnp.asarray(zeros),
                    jnp.asarray(uv), jnp.asarray(recv), jnp.asarray(phi),
                    window=(jrows, (jnp.int32(oy), jnp.int32(ox)), S))
    compare(mode, got, want)
    pair_taps_cuda.check_args(maps[c:c + 1], T(zeros), T(uv), T(recv),
                              T(phi), uni.shadow_map_size, uni.shadow_bias,
                              "pcss", (rows, origin, S))


def _refused():
    """(argument named in the error, check_args keyword overrides) of
    calls the kernel does not take. The meta device stands in for a second
    device."""
    return {
        "f64 uv": ("uv", dict(uv=torch.zeros((8, 2), dtype=torch.float64))),
        "uv of 3 columns": ("uv", dict(uv=torch.zeros((8, 3)))),
        "uv not a tensor": ("uv", dict(uv=[[0.5, 0.5]] * 8)),
        "receiver of another shape": ("receiver",
                                      dict(receiver=torch.zeros(9))),
        "phi on another device": ("phi", dict(phi=torch.zeros(8,
                                                             device="meta"))),
        "int64 layer": ("layer", dict(layer=torch.zeros(8,
                                                        dtype=torch.int64))),
        "non-contiguous maps": ("maps", dict(maps=torch.zeros(
            (2, 16, 16, 8))[..., :4])),
        "maps not square": ("maps", dict(maps=torch.zeros((2, 16, 8, 4)))),
        "maps of 2 channels": ("maps", dict(maps=torch.zeros((2, 16, 16,
                                                              2)))),
        "short uniforms": ("shadow_map_size",
                           dict(shadow_map_size=torch.zeros(2))),
        "f64 uniforms": ("shadow_bias",
                         dict(shadow_bias=torch.zeros(4,
                                                      dtype=torch.float64))),
        "unknown mode": ("mode", dict(mode="pcf3")),
        "window rows transposed": ("window rows", dict(window=(
            torch.zeros((8, 8, 4)).transpose(0, 1), (0, 0), 16))),
        "window rows of 2 channels": ("window rows", dict(window=(
            torch.zeros((8, 8, 2)), (0, 0), 16))),
        "float origin": ("window origin oy", dict(window=(
            torch.zeros((8, 8, 4)), (torch.tensor(1.0), 0), 16))),
        "origin past int32": ("window origin ox", dict(window=(
            torch.zeros((8, 8, 4)), (0, 2 ** 31), 16))),
        "full size not an int": ("window full size", dict(window=(
            torch.zeros((8, 8, 4)), (0, 0), 16.0))),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_check_args_refuses(case):
    """Each call the kernel cannot take raises, naming the argument."""
    name, over = _refused()[case]
    uni = uniforms(2.5)[1]
    kw = dict(maps=torch.zeros((2, 16, 16, 4)),
              layer=torch.zeros(8, dtype=torch.int32),
              uv=torch.zeros((8, 2)), receiver=torch.zeros(8),
              phi=torch.zeros(8), shadow_map_size=uni.shadow_map_size,
              shadow_bias=uni.shadow_bias, mode="pcss", window=None)
    pair_taps_cuda.check_args(**kw)           # the base call is taken
    kw.update(over)
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        pair_taps_cuda.check_args(**kw)


def test_wrapper_refuses_cpu_tensors():
    """pair_taps launches the kernel or raises: a CPU tensor is refused by
    name (the pass above takes the twin for it)."""
    uni = uniforms(2.5)[1]
    with pytest.raises(ValueError, match="^uv:"):
        pair_taps_cuda.pair_taps(
            torch.zeros((2, 16, 16, 4)), torch.zeros(8, dtype=torch.int32),
            torch.zeros((8, 2)), torch.zeros(8), torch.zeros(8),
            uni.shadow_map_size, uni.shadow_bias, "pcss")


@pytest.mark.parametrize("path", ["dense", "default", "shipped"])
def test_frame_taps_pass_check_args(path, monkeypatch):
    """Every tap set of two chained frames (parked, orbit pose 1) on the
    multimesh scene passes check_args with the arguments the dispatcher
    hands the kernel: the dense filter at 256x144 (per pixel, the packed
    maps at each pixel's cascade), GltfConfig() at 256x144 with its 2048^2
    maps (the pair groups on the packed maps), and the tuned shipped
    configuration at 480x272 (committed tap windows at a device-valued
    origin, routed windows at host origins)."""
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    cfg = {"dense": _dense_config,
           "default": lambda: tf.GltfConfig(width=256, height=144),
           "shipped": lambda: _shipped_config(scene, params)}[path]()
    calls = []
    plain_pcss, plain_pcf = tsf._pcss_taps_plain, tsf._pcf_taps_plain

    def pcss(uni, maps, layer, uv, recv, phi, window=None,
             radius_only=False):
        mode = "radius_only" if radius_only else "pcss"
        pair_taps_cuda.check_args(maps, layer, uv, recv, phi,
                                  uni.shadow_map_size, uni.shadow_bias, mode,
                                  window)
        calls.append((mode, tuple(uv.shape), window))
        return plain_pcss(uni, maps, layer, uv, recv, phi, window,
                          radius_only)

    def pcf(uni, maps, layer, uv, recv, phi, window=None):
        pair_taps_cuda.check_args(maps, layer, uv, recv, phi,
                                  uni.shadow_map_size, uni.shadow_bias,
                                  "pcf", window)
        calls.append(("pcf", tuple(uv.shape), window))
        return plain_pcf(uni, maps, layer, uv, recv, phi, window)

    monkeypatch.setattr(tsf, "_pcss_taps_plain", pcss)
    monkeypatch.setattr(tsf, "_pcf_taps_plain", pcf)
    state = tf.init_frame_state(cfg, "cpu")
    for pose in (params, tf.orbit_params(params, 1)):
        _, state = tf.render_gltf_frame(scene, pose, state, cfg)
    assert len(calls) >= 4 and all(m == "pcss" for m, _, _ in calls)
    if path != "shipped":
        assert all(w is None for _, _, w in calls)
    else:
        windows = [w for _, _, w in calls if w is not None]
        assert windows, "the shipped frame read no tap window"
        assert any(isinstance(w[1][0], torch.Tensor) for w in windows)
