"""The light-map kernel K5 on the CPU: the tap geometry both it and its
plain twin read (funky_tpu_torch/passes/shadow_lightspace.py::
light_map_taps) against the values the JAX package's build_light_shadow_map
builds, the packed parameters (shadow_lightspace.py::kernel_params), the
arguments the kernel's wrapper (ops/lightmap_cuda.py) refuses, the plain
twin the pass takes for CPU tensors, and every light map of a light-space
frame, its tap geometry built once, passed through the kernel's argument
check. The kernel itself runs only on the card
(tests/test_torch_lightmap_cuda.py).

Tolerances and why:
- phi, the blocker shifts and the PCSS radii r_j against JAX's: phi within
  1e-6 (values up to 2 pi; torch and XLA round the rotation's IGN apart by
  an ulp, 4.8e-7 at 2 pi), r_j within a relative 1e-6 (exp of the same f32
  span), the shifts equal;
- the pass on CPU tensors, with its taps built inside or given: equal, bit
  for bit, to the plain twin (it is the plain twin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.passes import shadow_filter as jsf

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import lightmap_cuda
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.passes import shadow_lightspace as tlsm
from funky_tpu_torch.passes.uniforms import FrameUniforms

from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene)
from .torch_scenes import light_map_case, light_uniform_fields

S = 128
BIAS = 0.003


def uniforms(softness, taa=1.0, frame=3.0):
    return FrameUniforms(**{k: torch.from_numpy(v) for k, v in
                            light_uniform_fields(softness, S, taa,
                                                 frame).items()})


def jax_taps(softness, taa, frame, phases, rungs):
    """phi per phase, the blocker shifts (sy, sx) (16, P) and the radii
    r_j, as funky_tpu's build_light_shadow_map builds them
    (shadow_lightspace.py:290-322), by its own functions."""
    flags = jnp.asarray([0.0, 1.0, taa, frame], jnp.float32)
    phis, sy, sx = [], [], []
    light_size = jnp.float32(softness) * 2.0
    for p in range(phases):
        off = jnp.asarray([float(p % 2), float(p // 2)], jnp.float32)
        phi = jsf.shadow_frame_phi(off, flags[3], flags[2])
        dx, dy = jsf.vogel_disk_all(jsf.BLOCKER_SAMPLES, phi)
        phis.append(float(phi))
        sx.append(np.asarray(jnp.floor(0.5 + dx * light_size)
                             .astype(jnp.int32)))
        sy.append(np.asarray(jnp.floor(0.5 + dy * light_size)
                             .astype(jnp.int32)))
    span = jnp.log(jnp.maximum(light_size * 4.0, 1.0 + 1e-6))
    radii = [float(0.5 * jnp.exp(span * (j / (rungs - 1))))
             for j in range(rungs)]
    return (np.array(phis, np.float32), np.stack(sy, -1), np.stack(sx, -1),
            np.array(radii, np.float32))


@pytest.mark.parametrize("softness, taa, frame", [
    (2.5, 1.0, 3.0), (0.8, 0.0, 0.0), (6.0, 1.0, 17.0)])
def test_taps_match_jax(softness, taa, frame):
    phases, rungs = 4, 6
    taps = tlsm.light_map_taps(uniforms(softness, taa, frame), True, rungs,
                               phases, "cpu")
    phi, sy, sx, radii = jax_taps(softness, taa, frame, phases, rungs)
    np.testing.assert_allclose(taps.phi.numpy(), phi, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(taps.shifts[0].numpy(), sy)
    np.testing.assert_array_equal(taps.shifts[1].numpy(), sx)
    np.testing.assert_allclose(taps.radii.numpy(), radii, rtol=1e-6, atol=0)
    assert taps.corners[0].shape == (rungs, 16, phases)
    assert taps.corners[0].dtype == torch.int32
    # corners and weights: floor and remainder of the offsets at each radius
    dx, dy = tlsm.vogel_disk_all(tlsm.PCF_SAMPLES, taps.phi)
    ox = (dx[None] * taps.radii[:, None, None]).numpy()
    np.testing.assert_array_equal(taps.corners[1].numpy(), np.floor(ox))
    np.testing.assert_array_equal(taps.fracs[1].numpy(), ox - np.floor(ox))


@pytest.mark.parametrize("softness, small", [(1.0, True), (3.0, False),
                                             (0.2, True)])
def test_fixed_radius_taps(softness, small):
    """Fixed-radius PCF: one radius max(softness, 0.5), the 3x3 selector
    radius <= 1.25, no blocker shifts."""
    taps = tlsm.light_map_taps(uniforms(softness), False, 6, 4, "cpu")
    assert taps.shifts is None and taps.light_size is None
    assert float(taps.radius) == max(softness, 0.5)
    assert bool(taps.small) == small
    assert taps.radii.shape == (1,) and taps.corners[0].shape == (1, 16, 4)


@pytest.mark.parametrize("use_pcss", [True, False])
@pytest.mark.parametrize("phases, rungs", [(4, 6), (1, 2), (3, 4)])
def test_kernel_params_layout(use_pcss, phases, rungs):
    """The packed parameters hold each value where csrc/lightmap.cu reads
    it, with the lengths check_args expects."""
    taps = tlsm.light_map_taps(uniforms(2.5), use_pcss, rungs, phases, "cpu")
    origin = (torch.tensor(24, dtype=torch.int32), 40)
    plane = torch.tensor([0.0004, -0.0006, 0.55])
    ints, floats = tlsm.kernel_params(origin, plane,
                                               torch.tensor(BIAS), taps,
                                               use_pcss, "cpu")
    assert (ints.dtype, floats.dtype) == (torch.int32, torch.float32)
    assert (ints.numel(), floats.numel()) == lightmap_cuda.param_sizes(
        use_pcss, rungs, phases)
    tp, n_r = 16 * phases, taps.radii.numel()
    assert ints[:2].tolist() == [24, 40]
    corners = ints[2 + (2 * tp if use_pcss else 0):]
    if use_pcss:
        assert torch.equal(ints[2:2 + tp], taps.shifts[0].reshape(-1))
        assert torch.equal(ints[2 + tp:2 + 2 * tp], taps.shifts[1].reshape(-1))
    assert torch.equal(corners[:n_r * tp], taps.corners[0].reshape(-1))
    assert torch.equal(corners[n_r * tp:], taps.corners[1].reshape(-1))
    head = lightmap_cuda.FLOAT_HEAD
    assert torch.equal(floats[:3], plane)
    assert floats[3] == torch.tensor(BIAS)
    a, b = ((taps.light_size, taps.span) if use_pcss
            else (taps.radius, taps.small.float()))
    assert floats[4] == a and floats[5] == b
    fracs = floats[head:head + 2 * n_r * tp]
    assert torch.equal(fracs[:n_r * tp], taps.fracs[0].reshape(-1))
    assert torch.equal(fracs[n_r * tp:], taps.fracs[1].reshape(-1))
    assert floats[head + 2 * n_r * tp:].tolist() == [1.0] * (n_r * phases)
    lightmap_cuda.check_args(torch.zeros((S, S)), ints, floats, 64, 18,
                             phases, rungs, use_pcss)


def _map_args(use_pcss, softness=2.5, wc=64, origin=(24, 40)):
    plane, raw = light_map_case(S)
    return (torch.from_numpy(raw), tuple(torch.tensor(o, dtype=torch.int32)
                                         for o in origin),
            torch.from_numpy(plane), uniforms(softness), use_pcss, wc, 4.0,
            torch.tensor(BIAS), 6, 4)


@pytest.mark.parametrize("use_pcss, softness", [(True, 2.5), (False, 3.0),
                                                (False, 1.0)])
def test_cpu_maps_take_the_plain_twin(use_pcss, softness):
    """build_light_shadow_map on CPU tensors, its taps built inside or
    given: the plain twin's rows, no kernel launch. The kernel's wrapper
    itself refuses a CPU map by name."""
    args = _map_args(use_pcss, softness)
    taps = tlsm.light_map_taps(args[3], use_pcss, 6, 4, "cpu")
    before = lightmap_cuda.LAUNCHES
    got = tlsm.build_light_shadow_map(*args)
    given = tlsm.build_light_shadow_map(*args, taps=taps)
    assert lightmap_cuda.LAUNCHES == before
    want = tlsm.build_light_shadow_map_plain(*args)
    assert got.shape == (64 * 64, 4) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(given.numpy(), want.numpy())
    ints, floats = tlsm.kernel_params(args[1], args[2], args[7], taps,
                                      use_pcss, "cpu")
    with pytest.raises(ValueError, match="^raw_map:"):
        lightmap_cuda.light_map(args[0], ints, floats, 64,
                                tlsm.halo_texels(4.0), 4, 6, use_pcss)
    assert lightmap_cuda.LAUNCHES == before


def _refused():
    """(argument named in the error, raw_map, ints, floats, wc, halo,
    phases, rungs, use_pcss) of calls the kernel does not take. The meta
    device stands in for the card."""
    taps = tlsm.light_map_taps(uniforms(2.5), True, 6, 4, "cpu")
    ints, floats = tlsm.kernel_params(
        (0, 0), torch.zeros(3), torch.tensor(BIAS), taps, True, "cpu")
    raw = torch.zeros((S, S))
    ok = (raw, ints, floats, 64, 18, 4, 6, True)

    def but(**kw):
        names = ("raw_map", "ints", "floats", "wc", "halo", "phases",
                 "rungs", "use_pcss")
        return tuple(kw.get(n, v) for n, v in zip(names, ok))

    return {
        "f64 map": ("raw_map", *but(raw_map=raw.double())),
        "non-contiguous map": ("raw_map", *but(raw_map=torch.zeros(
            (S, 2 * S))[:, ::2])),
        "non-square map": ("raw_map", *but(raw_map=torch.zeros((S, S + 1)))),
        "int64 ints": ("ints", *but(ints=ints.long())),
        "f64 floats": ("floats", *but(floats=floats.double())),
        "non-contiguous floats": ("floats", *but(floats=torch.zeros(
            2 * floats.numel())[::2])),
        "short ints": ("ints", *but(ints=ints[:-1].clone())),
        "ints on another device": ("ints", *but(ints=ints.to("meta"))),
        "map on another device": ("ints", *but(raw_map=raw.to("meta"))),
        "window past the map": ("wc", *but(wc=S + 8)),
        "five phases": ("phases", *but(phases=5)),
        "one rung": ("rungs", *but(rungs=1)),
        "no halo": ("halo", *but(halo=0)),
        "map not a tensor": ("raw_map", *but(raw_map=raw.numpy())),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_check_args_refuses(case):
    """Each call the kernel cannot take raises, naming the argument."""
    name, *args = _refused()[case]
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        lightmap_cuda.check_args(*args)


def test_frame_light_maps_pass_check_args(monkeypatch):
    """Every build_light_shadow_map call of a light-space frame (the
    multimesh scene at 256x144, 512^2 maps, synthesized maps and the
    back-face skip, windows of 128) packs into parameters that pass the
    kernel's check_args, so no frame call raises on the card; the frame
    builds the tap geometry once and hands it to every window."""
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    cfg = tf.GltfConfig(
        width=256, height=144, shadow_map_size=512,
        raster=RasterConfig(tile_h=16, tile_w=128),
        shadow_raster=RasterConfig(tile_h=128, tile_w=128),
        shadow_pen_capacity=2 * 256 * 144, contact_capacity=256 * 144,
        contact_march_capacity=256 * 144,
        light_window_sizes=(128, 128, 128, 128), light_pcf_rungs=2,
        flags=tf.GltfFrameFlags(light_space_ground_shadows=True,
                                skip_backfacing_shadows=True,
                                synth_shadow_maps=True))
    calls, given = [], []
    build = tlsm.build_light_shadow_map

    def record(raw_map, origin, plane, uni, use_pcss, wc, max_softness, bias,
               rungs=6, phases=4, taps=None):
        assert taps is not None
        given.append(taps)
        ints, floats = tlsm.kernel_params(origin, plane, bias, taps,
                                                   use_pcss, "cpu")
        lightmap_cuda.check_args(raw_map, ints, floats, wc,
                                 tlsm.halo_texels(max_softness), phases,
                                 rungs, use_pcss)
        calls.append(wc)
        return build(raw_map, origin, plane, uni, use_pcss, wc, max_softness,
                     bias, rungs, phases, taps)

    monkeypatch.setattr(tlsm, "build_light_shadow_map", record)
    state = tf.init_frame_state(cfg, "cpu")
    rgba, _ = tf.render_gltf_frame(scene, params, state, cfg)
    assert calls == [128] * 4, calls
    assert all(t is given[0] for t in given)
    assert bool(torch.isfinite(rgba).all())
