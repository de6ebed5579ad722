"""The reference's scene tables, packed from the benchmark's SceneSpec.

The packing follows the glTF renderer's loader as funky_tpu documents it
(models/scene.py:89-194 and models/gltf.py of the JAX package): the
20 x 20 grey ground quad first (object slot 0, untextured), then every
mesh of the glTF in slot 1, its colour the material's base colour, its
normals (0, 1, 0) where the file has none, its uv 0 where it has none,
and its texture flag set where the material has a base-colour texture.
Textures are converted from sRGB to linear and wrap-tiled to the largest
layer. Rows are padded to multiples of 128, the JAX package's table
layout (scene.py:35-41), so that the matrix products of the vertex stage
see the same row counts on both sides.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LANE = 128
FLAG_USE_TEXTURE = 1
GROUND_SIZE = 20.0


@dataclasses.dataclass
class Scene:
    positions: torch.Tensor     # (V, 3) f32
    normals: torch.Tensor       # (V, 3)
    uvs: torch.Tensor           # (V, 2)
    colors: torch.Tensor        # (V, 3)
    vert_object: torch.Tensor   # (V,) int32
    tri_indices: torch.Tensor   # (T, 3) int64
    tri_flags: torch.Tensor     # (T,) int32
    texture: torch.Tensor       # (N, Th, Tw, 4) linear RGBA
    texture_sizes: torch.Tensor  # (N, 2) (h, w)
    num_triangles: int


def _pad(a: np.ndarray) -> np.ndarray:
    pad = (-a.shape[0]) % LANE
    if not pad:
        return a
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def srgb_to_linear(s: np.ndarray) -> np.ndarray:
    """The exact sRGB EOTF in f32."""
    s = np.asarray(s, np.float32)
    return np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)


def _ground():
    h = GROUND_SIZE * 0.5
    p = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32)
    n = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (4, 1))
    uv = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float32)
    c = np.tile(np.array([0.35, 0.35, 0.35], np.float32), (4, 1))
    return p, n, uv, c, np.array([0, 1, 2, 2, 3, 0], np.int64)


def pack(spec, device) -> Scene:
    """spec: harness.scene.SceneSpec or None (the ground alone)."""
    parts = [(*_ground(), 0, 0)]
    texture = np.ones((1, 8, 128, 4), np.float32)
    sizes = np.asarray([[8.0, 128.0]], np.float32)
    if spec is not None:
        textured = len(spec.textures) > 0
        for m in spec.meshes:
            n = len(m.positions)
            mat = spec.materials[m.material]
            col = np.tile(np.asarray(mat.base_color[:3], np.float32), (n, 1))
            nrm = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n, 1))
            uv = (m.uvs if m.uvs is not None
                  else np.zeros((n, 2), np.float32))
            flags = 0
            if textured and mat.texture is not None:
                flags = FLAG_USE_TEXTURE | (min(mat.texture,
                                                len(spec.textures) - 1) << 8)
            parts.append((m.positions.astype(np.float32), nrm,
                          uv.astype(np.float32), col,
                          m.indices.astype(np.int64), 1, flags))
        if textured:
            hmax = max(t.shape[0] for t in spec.textures)
            wmax = max(t.shape[1] for t in spec.textures)
            layers = []
            for t in spec.textures:
                lin = np.concatenate(
                    [srgb_to_linear(t[..., :3].astype(np.float32) / 255.0),
                     t[..., 3:].astype(np.float32) / 255.0],
                    axis=-1).astype(np.float32)
                reps = (-(-hmax // t.shape[0]), -(-wmax // t.shape[1]), 1)
                layers.append(np.tile(lin, reps)[:hmax, :wmax])
            texture = np.stack(layers).astype(np.float32)
            sizes = np.asarray([[float(t.shape[0]), float(t.shape[1])]
                                for t in spec.textures], np.float32)
    pos, nrm, uvs, cols, objs, tris, tflags = [], [], [], [], [], [], []
    base = 0
    for p, n, uv, c, idx, obj, flags in parts:
        pos.append(p)
        nrm.append(n)
        uvs.append(uv)
        cols.append(c)
        objs.append(np.full(len(p), obj, np.int32))
        tri = idx.reshape(-1, 3) + base
        tris.append(tri)
        tflags.append(np.full(len(tri), flags, np.int32))
        base += len(p)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return Scene(
        positions=t(_pad(np.concatenate(pos))),
        normals=t(_pad(np.concatenate(nrm))),
        uvs=t(_pad(np.concatenate(uvs))),
        colors=t(_pad(np.concatenate(cols))),
        vert_object=t(_pad(np.concatenate(objs))),
        tri_indices=t(_pad(np.concatenate(tris))),
        tri_flags=t(_pad(np.concatenate(tflags))),
        texture=t(texture), texture_sizes=t(sizes),
        num_triangles=sum(len(x) for x in tris))
