"""The large scene: a frozen copy of tests/torch_scenes.py::build_large_glb
(lines 110-240) as data: the multimesh scene's two cubes over a gently
displaced, textured `quads` x `quads` terrain patch 40 units on a side
(2 * quads**2 triangles: 73,728 at the default, 73,754 with the cubes and
the ground quad the loader adds). The terrain is a smooth height field, so
it casts and receives shadows and spreads its triangles over the screen
and the shadow maps.

The GLB that function writes gives the terrain a NORMAL attribute; a
SceneSpec carries no normals, so here the terrain, like the cubes, takes
the loaders' (0, 1, 0). Its positions, indices, uvs, materials and texture
are the function's, byte for byte."""

from __future__ import annotations

import numpy as np

from harness.scene import Material, Mesh, SceneSpec

SIZE = 40.0
AMPLITUDE = 0.12


def _cube(offset, s=0.5):
    """torch_scenes.py:125-133."""
    verts = np.array([
        [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
        [-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s],
    ], np.float32) + np.asarray(offset, np.float32)
    idx = np.array([0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4,
                    3, 2, 6, 6, 5, 3, 0, 4, 7, 7, 1, 0,
                    1, 7, 6, 6, 2, 1, 0, 3, 5, 5, 4, 0], np.uint16)
    return verts, idx


def build(quads: int = 192) -> SceneSpec:
    """build_large_glb(path, quads) as data (torch_scenes.py:135-167)."""
    n = quads + 1
    g = np.linspace(-SIZE / 2, SIZE / 2, n, dtype=np.float64)
    x, z = np.meshgrid(g, g)
    k1, k2 = 2 * np.pi / 5.0, 2 * np.pi / 3.1
    y = AMPLITUDE * (1.0 + np.sin(k1 * x) * np.cos(k1 * z)
                     + 0.5 * np.sin(k2 * (x + z)))
    tv = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    tuv = (np.stack([x, z], -1).reshape(-1, 2) / SIZE * 4.0).astype(
        np.float32)
    i = np.arange(quads)
    a = (i[:, None] * n + i[None, :]).ravel()          # quad corners
    quad_tris = np.stack([a, a + n, a + 1, a + 1, a + n, a + n + 1], -1)
    ti = quad_tris.reshape(-1).astype(np.uint16)

    top = float(y.max())
    v0, i0 = _cube((-1.5, top + 0.45, 0.0))
    v1, i1 = _cube((1.5, top + 0.45, 0.0))

    tex = np.zeros((8, 8, 4), np.uint8)
    tex[..., 3] = 255
    tex[..., :3] = [90, 140, 70]
    tex[(np.arange(8)[:, None] + np.arange(8)[None, :]) % 2 == 0, :3] = \
        [150, 170, 90]
    return SceneSpec(
        meshes=[Mesh(v0, i0, None, 0), Mesh(v1, i1, None, 1),
                Mesh(tv, ti, tuv, 2)],
        materials=[Material((0.8, 0.1, 0.1, 1.0), 0.9, 0.2, None),
                   Material((0.1, 0.1, 0.8, 1.0), 0.0, 0.9, None),
                   Material((1.0, 1.0, 1.0, 1.0), 0.0, 0.8, 0)],
        textures=[tex])
