"""The benchmark's poses and scene are those of the program's own copies of
bench.py's orbit (funky_tpu_torch/frame.py::orbit_params) and of
models/sample_scenes.py, bit for bit."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from bench_tiny import SEED


@pytest.mark.parametrize("scene,scale,min_y", [("multimesh", 1.0, 0.0),
                                              ("none", 0.01, 0.0)])
def test_orbit_poses_match_orbit_params(scene, scale, min_y):
    from funky_tpu_torch import frame
    from harness import traffic

    tr = {"scene": scene, "model_scale": scale, "shadow_softness": 2.5,
          "fov_deg": 45.0, "rad_per_frame": 0.02, "slide": 0.3,
          "slide_rate": 3.0, "first_pose": 0, "poses": 48}
    base = traffic.base_pose(tr, min_y)
    ref = frame.default_gltf_params(gltf_min_y=min_y, gltf_scale=scale,
                                    device="cpu")
    for f in ("camera_fov", "duck_position", "duck_scale", "shadow_softness"):
        assert np.array_equal(getattr(base, f),
                              getattr(ref, f).numpy()), f
    for i in traffic.arc(tr):
        mine = traffic.orbit_pose(base, tr, i)
        theirs = frame.orbit_params(ref, i)
        for f in dataclasses.fields(frame.GltfParams):
            assert np.array_equal(np.asarray(getattr(mine, f.name),
                                             np.float32),
                                  getattr(theirs, f.name).numpy()), (i, f)


def test_orbit_formula():
    """bench.py:38-64: the camera orbits the target at 0.02 rad a frame
    and the model slides by 0.3 sin 3a."""
    from harness import traffic

    tr = {"model_scale": 1.0, "shadow_softness": 2.5, "fov_deg": 45.0,
          "rad_per_frame": 0.02, "slide": 0.3, "slide_rate": 3.0}
    base = traffic.base_pose(tr, 0.0)
    p = traffic.orbit_pose(base, tr, 25)
    a = 0.5
    want = np.array([10.0 * math.sin(a), 2.5, 10.0 * math.cos(a)])
    assert np.allclose(p.camera_pos, want, atol=1e-5)
    assert np.allclose(p.duck_position, [0.3 * math.sin(3 * a), 0.001,
                                         0.3 * math.cos(3 * a) - 0.3],
                       atol=1e-6)


def test_seeds_move_the_start_not_the_poses():
    """Every seed renders the same poses over the same cycle; the seed
    picks where in the cycle the window starts."""
    from harness import traffic

    tr = {"first_pose": 0, "poses": 48}
    assert traffic.arc(tr) == list(range(48))
    seeds = (1, 2, 3, SEED, 2**31 + 5)
    starts = {traffic.phase(48, s) for s in seeds}
    assert all(0 <= p < 94 for p in starts) and len(starts) > 1
    assert traffic.phase(48, SEED) == traffic.phase(48, SEED)
    for s in seeds:
        p = traffic.phase(48, s)
        cyc = sorted(traffic.position(48, p + f) for f in range(94))
        assert cyc == sorted(traffic.tuning_positions(48)[:-1])


def test_ping_pong_schedule_and_tuning_order():
    from harness import traffic

    assert [traffic.position(4, f) for f in range(10)] == \
        [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
    assert traffic.tuning_positions(4) == [0, 1, 2, 3, 2, 1, 0]
    assert traffic.position(1, 5) == 0


def test_scene_glb_loads_as_the_sample_scene(tmp_path):
    from funky_tpu_torch.models.gltf import GltfScene
    from funky_tpu_torch.models.sample_scenes import build_multimesh_glb
    from funky_tpu_torch.models.scene import build_device_scene
    from harness import scene

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    mine = build_device_scene(GltfScene.load(scene.write_glb(
        scene.build("multimesh"), tmp_path / "a" / "s.glb")), device="cpu")
    theirs = build_device_scene(GltfScene.load(build_multimesh_glb(
        tmp_path / "b" / "s.glb", two_textures=True)), device="cpu")
    for f in ("positions", "normals", "uvs", "colors", "vert_object",
              "tri_indices", "tri_object", "tri_flags", "texture",
              "texture_sizes"):
        assert torch.equal(getattr(mine, f), getattr(theirs, f)), f
