"""Port parity: the whole dense glTF frame (funky_tpu_torch/frame.py)
against funky_tpu's, the scene loader, the golden image, and the port's
independence from jax.

Slice tolerances (3 chained frames: parked, then bench.py's orbit poses
1 and 2, multimesh scene at 256x144, 256^2 maps, 16x128 tiles):
- main depth within 4e-5. XLA on the CPU contracts the triangle setup
  and plane evaluation into FMAs; torch never does. On this scene the
  near-clipped 20x20 ground gives planes with large cancelling
  coefficients, and the same-input raster differs by up to 1.4e-5, the
  whole frame by up to 2.3e-5 (measured). Unfused JAX (jit disabled)
  equals the port's raster bit for bit (tests/test_torch_raster.py).
- main tri_id equal except at z-fight pixels, at most 0.5% of the frame.
  The textured quad lies 1 mm above the ground plane; at orbit pose 2 the
  two surfaces' NDC depths are closer than XLA's contracted rounding
  error, and 135 pixels (0.37%) resolve the fight the other way (jitted
  vs unfused JAX disagree on the same pixels). Cube edges shared by two
  faces flip a pixel or two the same way. Depth still agrees there.
- rgba and TAA history within the golden tolerance (3/255 on at most
  0.2% of pixels, tests/test_goldens.py:14-15) on the pixels whose
  visible triangle agrees.
"""

import dataclasses
import pathlib
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

import bench
import funky_tpu.frame as jf
from funky_tpu.models.scene import build_cube_scene as jcube
from funky_tpu.models.scene import build_device_scene as jbuild
from funky_tpu.ops.raster import raster_corners as jraster_corners
from funky_tpu.passes import geometry as jgeometry

import funky_tpu_torch.frame as tf
from funky_tpu_torch.models.gltf import GltfScene as TGltfScene
from funky_tpu_torch.models.png_io import linear_to_srgb, read_png
from funky_tpu_torch.models.sample_scenes import (build_multimesh_glb,
                                                   build_textured_quad_glb)
from funky_tpu_torch.models.scene import build_cube_scene as tcube
from funky_tpu_torch.models.scene import build_device_scene as tbuild

from .torch_parity import (SCENE_FIELDS, multimesh_gltf, multimesh_jax_scene,
                           multimesh_params, port_params, port_scene,
                           slice_configs, t2n)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "goldens" / "multimesh_pbr_256x144.png"
GOLDEN_TOL, GOLDEN_BAD_FRAC = 3.0 / 255.0, 2e-3
DEPTH_TOL = 4e-5
MAX_ZFIGHT_FRAC = 5e-3


def port_multimesh_scene():
    with tempfile.TemporaryDirectory() as td:
        glb = build_multimesh_glb(pathlib.Path(td) / "multi.glb",
                                  two_textures=True)
        return TGltfScene.load(glb)


def assert_scene_equal(port, jax_scene):
    for name in SCENE_FIELDS:
        want = np.asarray(getattr(jax_scene, name))
        got = getattr(port, name)
        got = t2n(got) if not isinstance(got, int) else np.asarray(got)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("which", ["multimesh", "ground_only", "cube"])
def test_loader_matches_jax(which):
    """The port's own loader + packing equals the JAX package's, array
    for array (dtypes included)."""
    if which == "multimesh":
        port = tbuild(port_multimesh_scene(), device="cpu")
        ref = jbuild(multimesh_gltf())
    elif which == "ground_only":
        port, ref = tbuild(None, device="cpu"), jbuild(None)
    else:
        port, ref = tcube(device="cpu"), jcube()
    assert_scene_equal(port, ref)


def test_params_and_orbit_poses_match():
    jp = multimesh_params()
    tp = tf.default_gltf_params(
        gltf_min_y=float(multimesh_gltf().bounds_min[1]), gltf_scale=1.0,
        device="cpu")
    pairs = [(bench.orbit_params(jp, i), tf.orbit_params(tp, i))
             for i in (0, 1, 2, 5)]
    pairs += list(zip(bench.bench_poses(jp, 24), tf.bench_poses(tp, 24)))
    for jo, to in pairs:
        for name in tf.GltfParams.__dataclass_fields__:
            np.testing.assert_allclose(t2n(getattr(to, name)),
                                       np.asarray(getattr(jo, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def _jax_main_raster(jcfg):
    """The JAX frame's main pass (uniforms -> vertices -> near clip ->
    raster) as its own program, to read the frame's tri_id."""
    def run(scene, params, state):
        uni = jf.compute_frame_uniforms(params, state, jcfg)
        _, clip, _ = jgeometry.transform_vertices(scene, uni.models,
                                                  uni.view_proj)
        blocks = jnp_zero_blocks(scene)
        tri_clip, _, _, valid = jf._main_raster_inputs(
            scene, clip, blocks, jcfg.clip_capacity)
        tri_id, depth, _ = jraster_corners(tri_clip, valid, jcfg.width,
                                           jcfg.height, jcfg.raster)
        return tri_id, depth
    return jax.jit(run)


def jnp_zero_blocks(scene):
    import jax.numpy as jnp
    return jnp.zeros(scene.tri_indices.shape + (12,), jnp.float32)


def test_slice_matches_jax():
    jcfg, tcfg = slice_configs()
    scene = multimesh_jax_scene()
    tscene = port_scene(scene)
    params = multimesh_params()
    poses = [params, bench.orbit_params(params, 1),
             bench.orbit_params(params, 2)]
    frame = jf.compiled_gltf_frame(jcfg)
    main = _jax_main_raster(jcfg)
    jstate = jf.init_frame_state(jcfg)
    tstate = tf.init_frame_state(tcfg, "cpu")
    n_px = jcfg.width * jcfg.height
    for i, pose in enumerate(poses):
        jid, jdepth = main(scene, pose, jstate)
        jrgba, jstate = frame(scene, pose, jstate)
        trgba, tstate, tid = tf.render_gltf_frame_ids(
            tscene, port_params(pose), tstate, tcfg)
        jid, jdepth = np.asarray(jid), np.asarray(jdepth)
        # the helper program reproduces the frame's own main pass
        np.testing.assert_array_equal(jdepth, np.asarray(jstate.prev_depth))

        tdepth = t2n(tstate.prev_depth)
        np.testing.assert_allclose(tdepth, jdepth, rtol=0, atol=DEPTH_TOL)
        same = t2n(tid) == jid
        assert (~same).sum() <= MAX_ZFIGHT_FRAC * n_px, (i, (~same).sum())

        for got, want in ((t2n(trgba), np.asarray(jrgba)),
                          (t2n(tstate.shadow_history),
                           np.asarray(jstate.shadow_history))):
            diff = np.abs(got - want).max(-1)[same]
            assert (diff > GOLDEN_TOL).mean() <= GOLDEN_BAD_FRAC, (
                i, (diff > GOLDEN_TOL).mean(), diff.max())
        assert int(tstate.frame_index) == int(jstate.frame_index) == i + 1


def jpeg_quad_case():
    """The JPEG-textured quad (tests/golden_utils.py::render_jpeg_quad): the
    port's own GLB writer, JPEG decoder and loader, 192x112, 64^2 maps."""
    jpg = (REPO / "tests" / "assets" / "quad_tex_420p.jpg").read_bytes()
    with tempfile.TemporaryDirectory() as td:
        gltf = TGltfScene.load(build_textured_quad_glb(
            pathlib.Path(td) / "quad.glb", jpg))
    _, cfg = slice_configs(width=192, height=112, shadow=64)
    tile = dataclasses.replace(cfg.raster, capacity=64)
    cfg = dataclasses.replace(cfg, raster=tile, shadow_raster=tile)
    params = tf.default_gltf_params(gltf_min_y=0.0, gltf_scale=1.0,
                                    device="cpu")
    return tbuild(gltf, device="cpu"), params, cfg, "jpeg_quad_192x112.png"


def multimesh_case():
    _, cfg = slice_configs()
    gltf = port_multimesh_scene()
    params = tf.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                    gltf_scale=1.0, device="cpu")
    return tbuild(gltf, device="cpu"), params, cfg, "multimesh_pbr_256x144.png"


@pytest.mark.parametrize("case", [multimesh_case, jpeg_quad_case],
                         ids=["multimesh", "jpeg_quad"])
def test_slice_matches_golden(case):
    """Two parked frames of the port match the committed golden image
    (rendered by the JAX package) under the golden tolerance."""
    scene, params, cfg, golden = case()
    state = tf.init_frame_state(cfg, "cpu")
    for _ in range(2):
        rgba, state = tf.render_gltf_frame(scene, params, state, cfg)
    got = linear_to_srgb(t2n(rgba)[..., :3])
    want = read_png(GOLDEN.parent / golden)[..., :3].astype(np.float32) / 255.0
    assert got.shape == want.shape
    diff = np.abs(got - want).max(-1)
    assert (diff > GOLDEN_TOL).mean() <= GOLDEN_BAD_FRAC, diff.max()
    history = t2n(state.shadow_history)
    assert (history[..., 0] < 1.0).mean() > 0.05    # shadows are present


IMPORT_SCRIPT = """
import pathlib, sys, tempfile
import torch
from funky_tpu_torch import frame
from funky_tpu_torch.models.gltf import GltfScene
from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
from funky_tpu_torch.models.scene import build_device_scene
from funky_tpu_torch.ops.raster import RasterConfig
from funky_tpu_torch.parallel import make_mesh, sharded_gltf_frame
from funky_tpu_torch.utils import native
with tempfile.TemporaryDirectory() as td:
    gltf = GltfScene.load(build_multimesh_glb(pathlib.Path(td) / "m.glb",
                                              two_textures=True))
scene = build_device_scene(gltf, device="cpu")
tile = RasterConfig(tile_h=16, tile_w=128)
cfg = frame.GltfConfig(width=64, height=32, shadow_map_size=32, raster=tile,
                       shadow_raster=tile, valid_block_capacity=0,
                       texture_block_capacity=0,
                       flags=frame.GltfFrameFlags(sparse_shadows=False,
                                                  sparse_contact=False))
params = frame.default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                   gltf_scale=1.0, device="cpu")
rgba, state = frame.render_gltf_frame(scene, params,
                                      frame.init_frame_state(cfg, "cpu"),
                                      cfg)
assert rgba.shape == (32, 64, 4) and bool(torch.isfinite(rgba).all())
assert "jax" not in sys.modules and "funky_tpu" not in sys.modules
assert not torch.backends.cuda.matmul.allow_tf32
print("ok")
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


# Every knob of GltfConfig and GltfFrameFlags: the port refused the last
# four flag cases until the reduced-rate shadow evaluation, the light-space
# ground evaluation and the back-face skip were ported, and now renders
# them all (tests/test_torch_shadow_scale.py and test_torch_lightspace.py
# hold those against JAX).
@pytest.mark.parametrize("override", [
    dict(flags=dict(sparse_shadows=True)),
    dict(flags=dict(sparse_contact=True)),
    dict(flags=dict(synth_shadow_maps=True)),
    dict(flags=dict(committed=True)),
    dict(flags=dict(light_space_ground_shadows=True)),
    dict(flags=dict(skip_backfacing_shadows=True)),
    dict(flags=dict(shadow_eval_scale=2)),
    dict(flags=dict(half_res_shadows=True)),
    dict(valid_block_capacity=None),
    dict(texture_block_capacity=64),
    dict(valid_slab_rows=64),
    dict(taa_need_capacity=1024),
    dict(shadow_tap_windows=(384, 0, 0, 0)),
    dict(shadow_route_windows=(256, 256, 0, 0)),
    dict(shadow_route_caps=(1024, 1024, 0, 0)),
    dict(shadow_lit_cascade_caps=(1024, 1024, 0, 0)),
    dict(shadow_pen_cascade_caps=(1024, 1024, 0, 0)),
    dict(shadow_pen_block_capacity=256),
    dict(contact_block_capacity=256),
], ids=lambda o: ",".join(
    f"{k}" if k != "flags" else ",".join(o["flags"]) for k in o))
def test_unsupported_knobs_raise(override):
    """No knob is refused any more: the dense slice configuration with each
    knob set renders a finite frame of the right shape on the CPU."""
    import dataclasses

    override = dict(override)
    _, cfg = slice_configs(width=128, height=64, shadow=64)
    flags = dataclasses.replace(cfg.flags, **override.pop("flags", {}))
    cfg = dataclasses.replace(cfg, flags=flags, **override)
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    rgba, state = tf.render_gltf_frame(scene, params,
                                       tf.init_frame_state(cfg, "cpu"), cfg)
    assert rgba.shape == (64, 128, 4) and np.isfinite(t2n(rgba)).all()
    assert int(state.frame_index) == 1
    assert not hasattr(tf, "check_supported")


def test_entry_points_default_to_the_card():
    """Every entry point that makes tensors puts them on the card unless
    the caller asks for the CPU."""
    import inspect

    from funky_tpu_torch import convert
    from funky_tpu_torch.models import scene
    from funky_tpu_torch.parallel import make_mesh

    for fn in (scene.build_device_scene, scene.build_cube_scene,
               tf.default_gltf_params, tf.init_frame_state,
               convert.scene_from_numpy, convert.params_from_numpy,
               convert.state_from_numpy, convert.uniforms_from_numpy,
               make_mesh):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__
