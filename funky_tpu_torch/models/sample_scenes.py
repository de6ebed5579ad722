"""Synthetic sample scenes (BASELINE config 3: multi-mesh PBR).

The reference ships only the Duck sample; its multi-mesh/multi-material
machinery (gltf_loader.rs:130-229 per-primitive materials,
gltf_renderer.rs:1458-1575 texture binding) is exercised here with a
generated GLB: two PBR cubes + a textured quad, optionally with a second
texture so the per-mesh texture path (beyond the reference's single
binding) has real coverage.

(numpy copy of funky_tpu/models/sample_scenes.py: the port runs where jax is
not installed, and funky_tpu/__init__.py imports jax.)
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np


def build_multimesh_glb(path, two_textures: bool = False):
    """Write a GLB with two PBR cubes + a textured ground quad to `path`.

    two_textures: also texture the first cube with a 4x4 checker (its own
    texture slot) — exercises per-mesh texturing with mixed texture sizes.
    Returns `path`.
    """
    def cube_mesh(offset, size=1.0):
        s = size / 2
        verts = np.array([
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
            [-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s],
        ], np.float32) + np.asarray(offset, np.float32)
        idx = np.array([0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4,
                        3, 2, 6, 6, 5, 3, 0, 4, 7, 7, 1, 0,
                        1, 7, 6, 6, 2, 1, 0, 3, 5, 5, 4, 0], np.uint16)
        return verts, idx

    v0, i0 = cube_mesh((-1.5, 0.5, 0.0))
    v1, i1 = cube_mesh((1.5, 0.5, 0.0))
    cube_uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2],
                        [0, 0], [0, 2], [2, 2], [2, 0]], np.float32)
    quad = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                    np.float32)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    quad_idx = np.array([0, 1, 2, 2, 3, 0], np.uint16)

    from .png_io import write_png

    tex_dir = path.parent
    tex_path = tex_dir / "tex.png"
    write_png(tex_path, np.array([[[255, 0, 0, 255], [0, 255, 0, 255]],
                                  [[0, 0, 255, 255], [255, 255, 0, 255]]],
                                 np.uint8))
    tex_blobs = [tex_path.read_bytes()]
    if two_textures:
        checker_path = tex_dir / "checker.png"
        c = np.zeros((4, 4, 4), np.uint8)
        c[..., 3] = 255
        c[(np.arange(4)[:, None] + np.arange(4)[None, :]) % 2 == 0] = \
            [255, 255, 255, 255]
        c[..., :3][(np.arange(4)[:, None] + np.arange(4)[None, :])
                   % 2 == 1] = [40, 40, 40]
        write_png(checker_path, c)
        tex_blobs.append(checker_path.read_bytes())

    blobs = []
    views = []
    accessors = []

    def add(data, target, count, ctype, atype, vmin=None, vmax=None):
        offset = sum(len(b) for b in blobs)
        pad = (-len(data)) % 4
        blobs.append(data + b"\0" * pad)
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(data)})
        acc = {"bufferView": len(views) - 1, "componentType": ctype,
               "count": count, "type": atype}
        if vmin is not None:
            acc["min"] = vmin
            acc["max"] = vmax
        accessors.append(acc)
        return len(accessors) - 1

    a_v0 = add(v0.tobytes(), 34962, len(v0), 5126, "VEC3",
               v0.min(0).tolist(), v0.max(0).tolist())
    a_i0 = add(i0.tobytes(), 34963, len(i0), 5123, "SCALAR")
    a_c0uv = add(cube_uv.tobytes(), 34962, len(cube_uv), 5126, "VEC2")
    a_v1 = add(v1.tobytes(), 34962, len(v1), 5126, "VEC3",
               v1.min(0).tolist(), v1.max(0).tolist())
    a_i1 = add(i1.tobytes(), 34963, len(i1), 5123, "SCALAR")
    a_q = add(quad.tobytes(), 34962, len(quad), 5126, "VEC3",
              quad.min(0).tolist(), quad.max(0).tolist())
    a_quv = add(quad_uv.tobytes(), 34962, len(quad_uv), 5126, "VEC2")
    a_qi = add(quad_idx.tobytes(), 34963, len(quad_idx), 5123, "SCALAR")

    image_views = []
    for blob in tex_blobs:
        off = sum(len(b) for b in blobs)
        blobs.append(blob + b"\0" * ((-len(blob)) % 4))
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(blob)})
        image_views.append(len(views) - 1)

    mat0 = {"pbrMetallicRoughness": {
        "baseColorFactor": [0.8, 0.1, 0.1, 1.0],
        "metallicFactor": 0.9, "roughnessFactor": 0.2}}
    prim0 = {"attributes": {"POSITION": a_v0}, "indices": a_i0,
             "material": 0}
    if two_textures:
        mat0["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 1}
        prim0["attributes"]["TEXCOORD_0"] = a_c0uv

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2]}],
        "nodes": [{"mesh": 0}, {"mesh": 1}, {"mesh": 2}],
        "meshes": [
            {"primitives": [prim0]},
            {"primitives": [{"attributes": {"POSITION": a_v1},
                             "indices": a_i1, "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": a_q,
                                            "TEXCOORD_0": a_quv},
                             "indices": a_qi, "material": 2}]},
        ],
        "materials": [
            mat0,
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.1, 0.1, 0.8, 1.0],
                "metallicFactor": 0.0, "roughnessFactor": 0.9}},
            {"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.5, "roughnessFactor": 0.5}},
        ],
        "textures": [{"source": i} for i in range(len(tex_blobs))],
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
    total = 12 + 8 + len(js) + 8 + len(binv)
    glb.write(struct.pack("<III", 0x46546C67, 2, total))
    glb.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
    glb.write(struct.pack("<II", len(binv), 0x004E4942) + binv)
    path.write_bytes(glb.getvalue())
    return path


def build_textured_quad_glb(path, image_bytes: bytes,
                            mime: str = "image/jpeg"):
    """Write a GLB with one textured ground quad whose texture is the given
    embedded image bytes (any format decode_image handles). Exercises the
    reference's embedded-image path with non-PNG payloads
    (gltf_loader.rs:107-116 `load_from_memory` via the `image` crate).
    Returns `path`."""
    quad = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                    np.float32)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    quad_idx = np.array([0, 1, 2, 2, 3, 0], np.uint16)

    blobs = []
    views = []
    accessors = []

    def add(data, target, count, ctype, atype, vmin=None, vmax=None):
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

    a_q = add(quad.tobytes(), 34962, len(quad), 5126, "VEC3",
              quad.min(0).tolist(), quad.max(0).tolist())
    a_quv = add(quad_uv.tobytes(), 34962, len(quad_uv), 5126, "VEC2")
    a_qi = add(quad_idx.tobytes(), 34963, len(quad_idx), 5123, "SCALAR")

    img_off = sum(len(b) for b in blobs)
    blobs.append(image_bytes + b"\0" * ((-len(image_bytes)) % 4))
    views.append({"buffer": 0, "byteOffset": img_off,
                  "byteLength": len(image_bytes)})

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": a_q, "TEXCOORD_0": a_quv},
            "indices": a_qi, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.2, "roughnessFactor": 0.8}}],
        "textures": [{"source": 0}],
        "images": [{"bufferView": len(views) - 1, "mimeType": mime}],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": sum(len(b) for b in blobs)}],
    }

    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    binv = b"".join(blobs)
    glb = io.BytesIO()
    total = 12 + 8 + len(js) + 8 + len(binv)
    glb.write(struct.pack("<III", 0x46546C67, 2, total))
    glb.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
    glb.write(struct.pack("<II", len(binv), 0x004E4942) + binv)
    path.write_bytes(glb.getvalue())
    return path
