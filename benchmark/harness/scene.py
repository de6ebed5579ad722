"""The scenes a traffic mix names, made by the benchmark itself.

`multimesh` is a frozen copy of funky_tpu_torch/models/sample_scenes.py::
build_multimesh_glb (lines 23-155, with two_textures): two PBR cubes and a
textured ground quad, the first cube with a 4x4 checker of its own. It is
kept here as data (`SceneSpec`) and written as a GLB (`write_glb`) for the
program, whose loader reads the file; the plain reference packs the same
`SceneSpec` itself. `none` is no glTF at all: the program renders
build_device_scene(None), the ground plane alone.

The PNG writer is a frozen copy of funky_tpu_torch/models/png_io.py::
write_png (lines 48-70), filter 0, zlib level 6.
"""

from __future__ import annotations

import dataclasses
import io
import json
import pathlib
import struct
import zlib
from typing import List, Optional

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray            # (N, 3) f32
    indices: np.ndarray              # (M,) u16
    uvs: Optional[np.ndarray]        # (N, 2) f32 or None (no TEXCOORD_0)
    material: int


@dataclasses.dataclass
class Material:
    base_color: tuple                # RGBA factor
    metallic: float
    roughness: float
    texture: Optional[int]           # index into SceneSpec.textures


@dataclasses.dataclass
class SceneSpec:
    meshes: List[Mesh]
    materials: List[Material]
    textures: List[np.ndarray]       # (H, W, 4) u8 RGBA each

    @property
    def bounds_min(self) -> np.ndarray:
        return np.min(np.concatenate([m.positions for m in self.meshes]),
                      axis=0)


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


def multimesh() -> SceneSpec:
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


SCENES = {"multimesh": multimesh, "none": lambda: None}


def build(name: str) -> Optional[SceneSpec]:
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}; known: {sorted(SCENES)}")
    return SCENES[name]()


def png_bytes(rgba: np.ndarray) -> bytes:
    """png_io.py:48-70 for (H, W, 4) uint8."""
    h, w, c = rgba.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgba.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_glb(spec: SceneSpec, path: pathlib.Path) -> pathlib.Path:
    """The GLB of sample_scenes.py:61-155: one buffer, accessors in the
    sample scene's order, the PNGs embedded after the geometry."""
    blobs, views, accessors = [], [], []

    def add(data, count, ctype, atype, vmin=None, vmax=None):
        offset = sum(len(b) for b in blobs)
        blobs.append(data + b"\0" * ((-len(data)) % 4))
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(data)})
        acc = {"bufferView": len(views) - 1, "componentType": ctype,
               "count": count, "type": atype}
        if vmin is not None:
            acc["min"] = vmin
            acc["max"] = vmax
        accessors.append(acc)
        return len(accessors) - 1

    prims = []
    for m in spec.meshes:
        attrs = {"POSITION": add(m.positions.tobytes(), len(m.positions),
                                 5126, "VEC3", m.positions.min(0).tolist(),
                                 m.positions.max(0).tolist())}
        ind = add(m.indices.tobytes(), len(m.indices), 5123, "SCALAR")
        if m.uvs is not None:
            attrs["TEXCOORD_0"] = add(m.uvs.tobytes(), len(m.uvs), 5126,
                                      "VEC2")
        prims.append({"attributes": attrs, "indices": ind,
                      "material": m.material})
    image_views = []
    for t in spec.textures:
        blob = png_bytes(t)
        off = sum(len(b) for b in blobs)
        blobs.append(blob + b"\0" * ((-len(blob)) % 4))
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(blob)})
        image_views.append(len(views) - 1)
    materials = []
    for mat in spec.materials:
        pbr = {"baseColorFactor": list(mat.base_color),
               "metallicFactor": mat.metallic,
               "roughnessFactor": mat.roughness}
        if mat.texture is not None:
            pbr["baseColorTexture"] = {"index": mat.texture}
        materials.append({"pbrMetallicRoughness": pbr})
    n = len(spec.meshes)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(n))}],
        "nodes": [{"mesh": i} for i in range(n)],
        "meshes": [{"primitives": [p]} for p in prims],
        "materials": materials,
        "textures": [{"source": i} for i in range(len(spec.textures))],
        "images": [{"bufferView": v, "mimeType": "image/png"}
                   for v in image_views],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": sum(len(b) for b in blobs)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    binv = b"".join(blobs)
    glb = io.BytesIO()
    glb.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8
                          + len(binv)))
    glb.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
    glb.write(struct.pack("<II", len(binv), 0x004E4942) + binv)
    path.write_bytes(glb.getvalue())
    return path
