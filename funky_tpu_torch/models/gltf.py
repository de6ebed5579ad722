"""glTF 2.0 / GLB scene loader (hand-rolled: stdlib json + numpy).

Behavioral port of the reference loader (gltf_loader.rs:57-248):

- buffers: external .bin URIs read from the glTF's directory; GLB binary
  blob; (improvement over the reference: base64 data URIs are supported
  instead of erroring, gltf_loader.rs:70-72).
- images: external URI files or embedded buffer views, decoded to RGBA8
  (gltf_loader.rs:89-127).
- materials: pbrMetallicRoughness base color / metallic / roughness factors
  + base-color texture index (gltf_loader.rs:130-148); a default material is
  appended when the file has none (gltf_loader.rs:150-153).
- meshes: one entry per primitive; positions/normals/uv0/colors read with
  defaults for missing attributes (normal=[0,1,0], uv=[0,0], color=[1,1,1]);
  indices widened to u32, defaulting to 0..N (gltf_loader.rs:156-229).
- AABB accumulated over raw vertex positions (gltf_loader.rs:166-179);
  node transforms are intentionally NOT applied, matching the reference
  (the Duck's 0.01 node scale is instead applied via SceneObjects.gltf_scale).

(numpy copy of funky_tpu/models/gltf.py: the port runs where jax is
not installed, and funky_tpu/__init__.py imports jax.)
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

from .jpeg_io import decode_image

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclasses.dataclass
class GltfVertexData:
    positions: np.ndarray  # (N, 3) f32
    normals: np.ndarray    # (N, 3) f32
    tex_coords: np.ndarray  # (N, 2) f32
    colors: np.ndarray     # (N, 3) f32


@dataclasses.dataclass
class GltfMesh:
    vertices: GltfVertexData
    indices: np.ndarray    # (M,) u32
    material_index: Optional[int]


@dataclasses.dataclass
class GltfMaterial:
    base_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32))
    metallic: float = 0.0
    roughness: float = 1.0
    base_color_texture_index: Optional[int] = None


@dataclasses.dataclass
class GltfTexture:
    width: int
    height: int
    data: np.ndarray       # (H, W, 4) u8 RGBA


@dataclasses.dataclass
class GltfScene:
    meshes: List[GltfMesh]
    materials: List[GltfMaterial]
    textures: List[GltfTexture]
    bounds_min: np.ndarray
    bounds_max: np.ndarray

    @staticmethod
    def load(path: str | Path) -> "GltfScene":
        path = Path(path)
        raw = path.read_bytes()
        if raw[:4] == b"glTF":
            doc, blob = _parse_glb(raw)
        else:
            doc, blob = json.loads(raw.decode("utf-8")), None
        return _load_scene(doc, blob, path.parent)


def _parse_glb(raw: bytes):
    magic, version, _length = struct.unpack_from("<III", raw, 0)
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    pos = 12
    doc = None
    blob = None
    while pos + 8 <= len(raw):
        chunk_len, chunk_type = struct.unpack_from("<II", raw, pos)
        chunk = raw[pos + 8:pos + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # 'JSON'
            doc = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            blob = chunk
        pos += 8 + chunk_len + ((4 - chunk_len % 4) % 4 if chunk_len % 4 else 0)
    if doc is None:
        raise ValueError("GLB missing JSON chunk")
    return doc, blob


def _read_uri(uri: str, base_dir: Path) -> bytes:
    if uri.startswith("data:"):
        _, b64 = uri.split(",", 1)
        return base64.b64decode(b64)
    from urllib.parse import unquote
    return (base_dir / unquote(uri)).read_bytes()


def _read_view_data(doc: dict, buffers: List[bytes], view_idx: int,
                    byte_offset: int, count: int, n_comp: int,
                    dtype) -> np.ndarray:
    view = doc["bufferViews"][view_idx]
    buf = buffers[view["buffer"]]
    offset = view.get("byteOffset", 0) + byte_offset
    itemsize = np.dtype(dtype).itemsize
    stride = view.get("byteStride") or n_comp * itemsize
    if stride == n_comp * itemsize:
        return np.frombuffer(buf, dtype, count * n_comp,
                             offset).reshape(count, n_comp)
    rows = np.frombuffer(buf, np.uint8,
                         stride * (count - 1) + n_comp * itemsize, offset)
    idx = (np.arange(count)[:, None] * stride
           + np.arange(n_comp * itemsize)[None, :])
    return rows[idx].copy().view(dtype).reshape(count, n_comp)


def _read_accessor(doc: dict, buffers: List[bytes], accessor_idx: int) -> np.ndarray:
    acc = doc["accessors"][accessor_idx]
    count = acc["count"]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    if "bufferView" not in acc:
        out = np.zeros((count, n_comp), dtype)
    else:
        out = _read_view_data(doc, buffers, acc["bufferView"],
                              acc.get("byteOffset", 0), count, n_comp,
                              dtype)
    sparse = acc.get("sparse")
    if sparse:
        # glTF 2.0 sparse accessors: substitute `count` values at the
        # given indices over the (possibly zero) base (spec 3.6.2.3;
        # handled by the gltf crate in the reference, gltf_loader.rs).
        s_count = sparse["count"]
        sidx = sparse["indices"]
        sval = sparse["values"]
        idx_dtype = _COMPONENT_DTYPES[sidx["componentType"]]
        indices = _read_view_data(
            doc, buffers, sidx["bufferView"], sidx.get("byteOffset", 0),
            s_count, 1, idx_dtype)[:, 0].astype(np.int64)
        values = _read_view_data(
            doc, buffers, sval["bufferView"], sval.get("byteOffset", 0),
            s_count, n_comp, dtype)
        out = out.copy()
        out[indices] = values
    return out


def _normalized_to_f32(arr: np.ndarray) -> np.ndarray:
    """KHR-normalized integer attributes -> f32 (gltf crate `into_f32` /
    `into_rgb_f32` semantics)."""
    if arr.dtype == np.float32:
        return arr
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    if arr.dtype == np.int8:
        return np.maximum(arr.astype(np.float32) / 127.0, -1.0)
    if arr.dtype == np.int16:
        return np.maximum(arr.astype(np.float32) / 32767.0, -1.0)
    return arr.astype(np.float32)


def _load_scene(doc: dict, blob: Optional[bytes], base_dir: Path) -> GltfScene:
    # -- buffers (gltf_loader.rs:66-86) --
    buffers: List[bytes] = []
    for buf in doc.get("buffers", []):
        if "uri" in buf:
            buffers.append(_read_uri(buf["uri"], base_dir))
        else:
            if blob is None:
                raise ValueError("missing binary blob for GLB buffer")
            buffers.append(blob)

    # -- images -> RGBA8 (gltf_loader.rs:89-127) --
    images: List[GltfTexture] = []
    for img in doc.get("images", []):
        if "uri" in img:
            data = _read_uri(img["uri"], base_dir)
        else:
            view = doc["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            data = buffers[view["buffer"]][off:off + view["byteLength"]]
        rgba = decode_image(bytes(data))
        images.append(GltfTexture(rgba.shape[1], rgba.shape[0], rgba))

    # glTF textures reference images via "source"; resolve so material
    # texture indices land on decoded images.
    textures: List[GltfTexture] = []
    for tex in doc.get("textures", []):
        textures.append(images[tex["source"]])
    if not textures and images:
        textures = images

    # -- materials (gltf_loader.rs:130-153) --
    materials: List[GltfMaterial] = []
    for mat in doc.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        base_color = np.asarray(
            pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]), np.float32)
        tex_idx = None
        if "baseColorTexture" in pbr:
            tex_idx = pbr["baseColorTexture"].get("index")
        materials.append(GltfMaterial(
            base_color=base_color,
            metallic=float(pbr.get("metallicFactor", 1.0)),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            base_color_texture_index=tex_idx,
        ))
    if not materials:
        materials.append(GltfMaterial(metallic=0.0, roughness=1.0))

    # -- meshes: one GltfMesh per primitive (gltf_loader.rs:156-229) --
    meshes: List[GltfMesh] = []
    bounds_min = np.full(3, np.inf, np.float32)
    bounds_max = np.full(3, -np.inf, np.float32)
    for mesh in doc.get("meshes", []):
        for prim in mesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" in attrs:
                positions = _read_accessor(
                    doc, buffers, attrs["POSITION"]).astype(np.float32)
            else:
                positions = np.zeros((0, 3), np.float32)
            n = len(positions)
            if n:
                bounds_min = np.minimum(bounds_min, positions.min(axis=0))
                bounds_max = np.maximum(bounds_max, positions.max(axis=0))

            if "NORMAL" in attrs:
                normals = _read_accessor(
                    doc, buffers, attrs["NORMAL"]).astype(np.float32)
            else:
                normals = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n, 1))

            if "TEXCOORD_0" in attrs:
                uv = _normalized_to_f32(_read_accessor(doc, buffers,
                                                       attrs["TEXCOORD_0"]))
            else:
                uv = np.zeros((n, 2), np.float32)

            if "COLOR_0" in attrs:
                col = _normalized_to_f32(_read_accessor(doc, buffers,
                                                        attrs["COLOR_0"]))[:, :3]
            else:
                col = np.ones((n, 3), np.float32)

            if "indices" in prim:
                indices = _read_accessor(
                    doc, buffers, prim["indices"]).reshape(-1).astype(np.uint32)
            else:
                indices = np.arange(n, dtype=np.uint32)

            meshes.append(GltfMesh(
                vertices=GltfVertexData(positions, normals,
                                        uv.astype(np.float32),
                                        col.astype(np.float32)),
                indices=indices,
                material_index=prim.get("material"),
            ))

    if not np.isfinite(bounds_min[0]):
        bounds_min = np.zeros(3, np.float32)
        bounds_max = np.zeros(3, np.float32)

    return GltfScene(meshes=meshes, materials=materials, textures=textures,
                     bounds_min=bounds_min, bounds_max=bounds_max)
