"""The multimesh scene: a frozen copy of funky_tpu_torch/models/
sample_scenes.py::build_multimesh_glb (lines 23-155, with two_textures):
two PBR cubes and a textured ground quad, the first cube with a 4x4
checker of its own."""

from __future__ import annotations

import numpy as np

from harness.scene import Material, Mesh, SceneSpec


def _cube(offset, size=1.0):
    """sample_scenes.py:31-40."""
    s = size / 2
    verts = np.array([
        [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
        [-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s],
    ], np.float32) + np.asarray(offset, np.float32)
    idx = np.array([0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4,
                    3, 2, 6, 6, 5, 3, 0, 4, 7, 7, 1, 0,
                    1, 7, 6, 6, 2, 1, 0, 3, 5, 5, 4, 0], np.uint16)
    return verts, idx


def build() -> SceneSpec:
    """build_multimesh_glb(path, two_textures=True) as data
    (sample_scenes.py:42-155)."""
    v0, i0 = _cube((-1.5, 0.5, 0.0))
    v1, i1 = _cube((1.5, 0.5, 0.0))
    cube_uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2],
                        [0, 0], [0, 2], [2, 2], [2, 0]], np.float32)
    quad = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                    np.float32)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    quad_idx = np.array([0, 1, 2, 2, 3, 0], np.uint16)
    tex = np.array([[[255, 0, 0, 255], [0, 255, 0, 255]],
                    [[0, 0, 255, 255], [255, 255, 0, 255]]], np.uint8)
    checker = np.zeros((4, 4, 4), np.uint8)
    checker[..., 3] = 255
    parity = (np.arange(4)[:, None] + np.arange(4)[None, :]) % 2
    checker[parity == 0] = [255, 255, 255, 255]
    checker[..., :3][parity == 1] = [40, 40, 40]
    return SceneSpec(
        meshes=[Mesh(v0, i0, cube_uv, 0), Mesh(v1, i1, None, 1),
                Mesh(quad, quad_idx, quad_uv, 2)],
        materials=[Material((0.8, 0.1, 0.1, 1.0), 0.9, 0.2, 1),
                   Material((0.1, 0.1, 0.8, 1.0), 0.0, 0.9, None),
                   Material((1.0, 1.0, 1.0, 1.0), 0.5, 0.5, 0)],
        textures=[tex, checker])
