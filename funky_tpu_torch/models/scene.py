"""Device scene packing (port of funky_tpu/models/scene.py).

The host-side packing is the same numpy code as the JAX package; only the
container differs: `DeviceScene` is a dataclass of tensors on one device
plus static counts, instead of a pytree of jnp arrays. Rows are padded to
multiples of 128 exactly as the JAX package pads them, so triangle ids and
table shapes agree between the two packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .gltf import GltfScene
from .png_io import srgb_to_linear
from .primitives import cube_geometry, ground_plane_geometry

LANE = 128
FLAG_USE_TEXTURE = 1
OBJ_GROUND = 0
OBJ_MODEL = 1

TENSOR_FIELDS = ("positions", "normals", "uvs", "colors", "vert_object",
                 "tri_indices", "tri_object", "tri_flags", "texture",
                 "texture_sizes")


def _pad_rows(arr: np.ndarray, multiple: int = LANE) -> np.ndarray:
    """scene.py:35-41."""
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)


@dataclasses.dataclass
class DeviceScene:
    """Scene tensors (scene.py:44-77), all on one device."""
    positions: torch.Tensor     # (V, 3) f32 object space
    normals: torch.Tensor       # (V, 3) f32
    uvs: torch.Tensor           # (V, 2) f32
    colors: torch.Tensor        # (V, 3) f32, material base color baked
    vert_object: torch.Tensor   # (V,) i32 object slot per vertex
    tri_indices: torch.Tensor   # (T, 3) i32
    tri_object: torch.Tensor    # (T,) i32
    tri_flags: torch.Tensor     # (T,) i32: bit 0 useTexture, bits 8+ layer
    texture: torch.Tensor       # (N, Th, Tw, 4) f32 linear RGBA layers
    texture_sizes: torch.Tensor  # (N, 2) f32 true (h, w) per layer
    num_vertices: int
    num_triangles: int
    num_objects: int

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def to(self, device) -> "DeviceScene":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in TENSOR_FIELDS})


def _from_numpy(arrays: dict, counts: tuple, device) -> DeviceScene:
    return DeviceScene(
        **{f: torch.as_tensor(np.ascontiguousarray(arrays[f]),
                              device=device) for f in TENSOR_FIELDS},
        num_vertices=counts[0], num_triangles=counts[1],
        num_objects=counts[2])


def build_device_scene(scene: Optional[GltfScene],
                       include_ground: bool = True,
                       ground_size: float = 20.0,
                       device="cuda") -> DeviceScene:
    """Ground plane + glTF meshes (scene.py:89-171). Object slots: 0 =
    ground, 1 = the glTF model."""
    pos_l, nrm_l, uv_l, col_l, obj_l = [], [], [], [], []
    tri_l, tobj_l, tflag_l = [], [], []
    base = 0

    def add_mesh(p, n, uv, c, idx, obj, flags):
        nonlocal base
        pos_l.append(p)
        nrm_l.append(n)
        uv_l.append(uv)
        col_l.append(c)
        obj_l.append(np.full(len(p), obj, np.int32))
        tri = idx.reshape(-1, 3).astype(np.int64) + base
        tri_l.append(tri)
        tobj_l.append(np.full(len(tri), obj, np.int32))
        tflag_l.append(np.full(len(tri), flags, np.int32))
        base += len(p)

    if include_ground:
        gp, gn, guv, gc, gi = ground_plane_geometry(ground_size)
        add_mesh(gp, gn, guv, gc, gi, OBJ_GROUND, 0)

    texture = None
    texture_sizes = None
    if scene is not None:
        has_texture = len(scene.textures) > 0
        for mesh in scene.meshes:
            v = mesh.vertices
            color = v.colors
            tex_idx = 0 if has_texture else None
            if mesh.material_index is not None and mesh.material_index < len(
                    scene.materials):
                mat = scene.materials[mesh.material_index]
                color = np.tile(mat.base_color[:3].astype(np.float32),
                                (len(v.positions), 1))
                tex_idx = mat.base_color_texture_index
            flags = 0
            if has_texture and tex_idx is not None:
                flags = FLAG_USE_TEXTURE | (min(
                    tex_idx, len(scene.textures) - 1) << 8)
            add_mesh(v.positions, v.normals, v.tex_coords, color,
                     mesh.indices, OBJ_MODEL, flags)
        if has_texture:
            texture, texture_sizes = _pack_texture_layers(scene.textures)

    if texture is None:
        texture = np.ones((1, 8, 128, 4), np.float32)
        texture_sizes = np.asarray([[8.0, 128.0]], np.float32)

    arrays = {
        "positions": _pad_rows(np.concatenate(pos_l).astype(np.float32)),
        "normals": _pad_rows(np.concatenate(nrm_l).astype(np.float32)),
        "uvs": _pad_rows(np.concatenate(uv_l).astype(np.float32)),
        "colors": _pad_rows(np.concatenate(col_l).astype(np.float32)),
        "vert_object": _pad_rows(np.concatenate(obj_l)),
        "tri_indices": _pad_rows(np.concatenate(tri_l).astype(np.int32)),
        "tri_object": _pad_rows(np.concatenate(tobj_l)),
        "tri_flags": _pad_rows(np.concatenate(tflag_l)),
        "texture": texture,
        "texture_sizes": texture_sizes,
    }
    return _from_numpy(arrays, (base, sum(len(t) for t in tri_l), 2), device)


def _pack_texture_layers(textures):
    """sRGB->linear, wrap-pad to a common size, stack (scene.py:174-194)."""
    max_h = max(t.height for t in textures)
    max_w = max(t.width for t in textures)
    layers = []
    sizes = []
    for t in textures:
        tex8 = t.data
        lin = np.concatenate([
            srgb_to_linear(tex8[..., :3].astype(np.float32) / 255.0),
            tex8[..., 3:].astype(np.float32) / 255.0,
        ], axis=-1).astype(np.float32)
        reps = (-(-max_h // t.height), -(-max_w // t.width), 1)
        layers.append(np.tile(lin, reps)[:max_h, :max_w])
        sizes.append([float(t.height), float(t.width)])
    return (np.stack(layers).astype(np.float32),
            np.asarray(sizes, np.float32))


def build_cube_scene(device="cuda") -> DeviceScene:
    """The rotating-cube demo scene (scene.py:197-219)."""
    p, n, c, idx = cube_geometry()
    uv = np.zeros((len(p), 2), np.float32)
    tri = idx.reshape(-1, 3).astype(np.int32)
    arrays = {
        "positions": _pad_rows(p),
        "normals": _pad_rows(n),
        "uvs": _pad_rows(uv),
        "colors": _pad_rows(c),
        "vert_object": _pad_rows(np.zeros(len(p), np.int32)),
        "tri_indices": _pad_rows(tri),
        "tri_object": _pad_rows(np.zeros(len(tri), np.int32)),
        "tri_flags": _pad_rows(np.zeros(len(tri), np.int32)),
        "texture": np.ones((1, 8, 128, 4), np.float32),
        "texture_sizes": np.asarray([[8.0, 128.0]], np.float32),
    }
    return _from_numpy(arrays, (len(p), len(tri), 1), device)
