"""What a scene is to the benchmark, and how the program is handed one.

A traffic mix names its scene; `scenes/<name>.py` makes it, from nothing
but its own code, with `build() -> SceneSpec | None` (None: no glTF at
all, the program renders build_device_scene(None), the ground plane
alone). A scene is kept as data (`SceneSpec`) and written as a GLB
(`write_glb`) for the program, whose loader reads the file; the plain
reference packs the same `SceneSpec` itself (reference/scene.py).

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

from .manifest import BENCH_DIR, load_module

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


def build(name: str, bench_dir: pathlib.Path = BENCH_DIR
          ) -> Optional[SceneSpec]:
    """The scene that scenes/<name>.py builds."""
    return load_module("scenes", name, bench_dir).build()


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
