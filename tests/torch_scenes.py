"""Seeded test scenes for the port's raster and test cases of its row
gather, in numpy only (no jax), so that the card-only tests and
chip_smoke.py can use them where jax is absent. Not a test module itself."""

from __future__ import annotations

import numpy as np


# Row types of the frame's row gathers (ops/sampling.py::take_rows):
# name -> (dtype, row shape). The deferred pass's fused rows are 46 f32;
# the compactions gather bool masks and int32 keys; f16 and f64 rows take
# the kernel's 2- and 8-byte copy units.
GATHER_ROWS = {
    "f32x4": (np.float32, (4,)),
    "f32x2": (np.float32, (2,)),
    "f32x8": (np.float32, (8,)),
    "f32x7": (np.float32, (7,)),
    "f32x16": (np.float32, (16,)),
    "f32x46": (np.float32, (46,)),
    "f32x3x12": (np.float32, (3, 12)),
    "f32": (np.float32, ()),
    "i32": (np.int32, ()),
    "bool": (np.bool_, ()),
    "f16": (np.float16, ()),
    "f64x3": (np.float64, (3,)),
}
# Index batches: name -> (table rows, index shape).
GATHER_INDICES = {
    "1d": (1000, (4099,)),
    "3d": (1000, (5, 7, 9)),
    "empty": (1000, (0,)),
    "one_row": (1, (37,)),
    "large": (100_000, (150_001,)),
    "taps": (100_000, (16, 3, 4099)),
}


def gather_case(rows: str, indices: str, seed: int = 0):
    """(table, idx) of one row-gather test case: a seeded table of
    GATHER_ROWS[rows] and int32 indices drawn from [-2N, 2N), so that
    negative ones (counted from the end) and out-of-range ones (clamped)
    both occur."""
    dtype, shape = GATHER_ROWS[rows]
    n, ishape = GATHER_INDICES[indices]
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        table = rng.random((n,) + shape) < 0.5
    elif np.issubdtype(dtype, np.integer):
        table = rng.integers(-2**31, 2**31, (n,) + shape, dtype=np.int64)
        table = table.astype(dtype)
    else:
        table = rng.standard_normal((n,) + shape).astype(dtype)
    idx = rng.integers(-2 * n, 2 * n, ishape).astype(np.int32)
    return table, idx


def random_clip_scene(seed=0, n_tris=40, width=128, height=64):
    """Random screen-space triangles as clip coordinates (V, 4) and index
    triples (T, 3), with one zero-area and one w-culled triangle
    (tests/test_raster_pallas.py's random_scene, in numpy)."""
    rng = np.random.default_rng(seed)
    v = n_tris * 3
    pts = rng.uniform([-20, -20], [width + 20, height + 20],
                      (v, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, v).astype(np.float32)
    ndc_x = pts[:, 0] / width * 2.0 - 1.0
    ndc_y = pts[:, 1] / height * 2.0 - 1.0
    clip = np.stack([ndc_x, ndc_y, z, np.ones(v, np.float32)],
                    axis=-1).astype(np.float32)
    clip[5] = clip[3]                      # zero-area
    clip[9, 3] = 1e-9                      # w <= eps cull
    tris = np.arange(v, dtype=np.int32).reshape(n_tris, 3)
    return clip, tris


def screen_clip(pts, z, width, height):
    """Clip coordinates (3n, 4), w = 1, and index triples (n, 3) of the
    screen-space triangles `pts` (n, 3, 2) in pixels at NDC depths `z`
    (n, 3). Exact for power-of-two framebuffer sizes."""
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    ndc_x = pts[:, 0] / width * 2.0 - 1.0
    ndc_y = pts[:, 1] / height * 2.0 - 1.0
    clip = np.stack([ndc_x, ndc_y, np.asarray(z, np.float32).reshape(-1),
                     np.ones(len(pts), np.float32)], -1).astype(np.float32)
    return clip, np.arange(len(pts), dtype=np.int32).reshape(-1, 3)


def small_triangles_scene(seed=0, n_tris=2000, region=(0, 0, 128, 32),
                          size=3.0, width=256, height=128):
    """`n_tris` random triangles of about `size` pixels, all inside the
    pixel rectangle `region` = (x0, y0, x1, y1): one long bin list."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = region
    centre = rng.uniform([x0 + size, y0 + size], [x1 - size, y1 - size],
                         (n_tris, 1, 2))
    pts = centre + rng.uniform(-size, size, (n_tris, 3, 2))
    z = rng.uniform(0.05, 0.95, (n_tris, 3))
    return screen_clip(pts, z, width, height)


def with_coplanar_duplicates(clip, n_dup_tris=10):
    """Appends copies of the first `n_dup_tris` triangles (higher ids,
    identical planes): every pixel they cover is an exact depth tie, which
    the first-drawn (lower) id must win."""
    clip = np.concatenate([clip, clip[:3 * n_dup_tris]])
    return clip, np.arange(len(clip), dtype=np.int32).reshape(-1, 3)


def build_large_glb(path, quads: int = 192, size: float = 40.0,
                    amplitude: float = 0.12):
    """Write a GLB past the JAX package's 4 MiB raster table limit to
    `path` (the port's K1 takes its 4.6 MiB tables): the
    multimesh scene's two cubes over a gently displaced, textured
    `quads` x `quads` terrain patch of side `size` (2 * quads**2
    triangles: 73,728 at the default). The terrain is a smooth height
    field, so it casts and receives shadows and spreads its triangles
    evenly over the screen and the shadow maps (no tile holds a large
    share of them). Returns `path`."""
    import io
    import json
    import struct

    from funky_tpu_torch.models.png_io import write_png

    def cube_mesh(offset, s=0.5):
        verts = np.array([
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
            [-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s],
        ], np.float32) + np.asarray(offset, np.float32)
        idx = np.array([0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4,
                        3, 2, 6, 6, 5, 3, 0, 4, 7, 7, 1, 0,
                        1, 7, 6, 6, 2, 1, 0, 3, 5, 5, 4, 0], np.uint16)
        return verts, idx

    n = quads + 1
    g = np.linspace(-size / 2, size / 2, n, dtype=np.float64)
    x, z = np.meshgrid(g, g)
    k1, k2 = 2 * np.pi / 5.0, 2 * np.pi / 3.1
    y = amplitude * (1.0 + np.sin(k1 * x) * np.cos(k1 * z)
                     + 0.5 * np.sin(k2 * (x + z)))
    dydx = amplitude * (k1 * np.cos(k1 * x) * np.cos(k1 * z)
                        + 0.5 * k2 * np.cos(k2 * (x + z)))
    dydz = amplitude * (-k1 * np.sin(k1 * x) * np.sin(k1 * z)
                        + 0.5 * k2 * np.cos(k2 * (x + z)))
    nrm = np.stack([-dydx, np.ones_like(y), -dydz], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tv = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    tn = nrm.reshape(-1, 3).astype(np.float32)
    tuv = (np.stack([x, z], -1).reshape(-1, 2) / size * 4.0).astype(
        np.float32)
    i = np.arange(quads)
    a = (i[:, None] * n + i[None, :]).ravel()          # quad corners
    quad_tris = np.stack([a, a + n, a + 1, a + 1, a + n, a + n + 1], -1)
    ti = quad_tris.reshape(-1).astype(np.uint16)

    top = float(y.max())
    v0, i0 = cube_mesh((-1.5, top + 0.45, 0.0))
    v1, i1 = cube_mesh((1.5, top + 0.45, 0.0))

    tex_path = path.parent / "terrain.png"
    c = np.zeros((8, 8, 4), np.uint8)
    c[..., 3] = 255
    c[..., :3] = [90, 140, 70]
    c[(np.arange(8)[:, None] + np.arange(8)[None, :]) % 2 == 0, :3] = \
        [150, 170, 90]
    write_png(tex_path, c)
    tex_blob = tex_path.read_bytes()

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

    def pos(v):
        return add(v.tobytes(), len(v), 5126, "VEC3", v.min(0).tolist(),
                   v.max(0).tolist())

    a_v0, a_i0 = pos(v0), add(i0.tobytes(), len(i0), 5123, "SCALAR")
    a_v1, a_i1 = pos(v1), add(i1.tobytes(), len(i1), 5123, "SCALAR")
    a_tv = pos(tv)
    a_tn = add(tn.tobytes(), len(tn), 5126, "VEC3")
    a_tuv = add(tuv.tobytes(), len(tuv), 5126, "VEC2")
    a_ti = add(ti.tobytes(), len(ti), 5123, "SCALAR")
    off = sum(len(b) for b in blobs)
    blobs.append(tex_blob + b"\0" * ((-len(tex_blob)) % 4))
    views.append({"buffer": 0, "byteOffset": off,
                  "byteLength": len(tex_blob)})

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2]}],
        "nodes": [{"mesh": 0}, {"mesh": 1}, {"mesh": 2}],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": a_v0},
                             "indices": a_i0, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": a_v1},
                             "indices": a_i1, "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": a_tv,
                                            "NORMAL": a_tn,
                                            "TEXCOORD_0": a_tuv},
                             "indices": a_ti, "material": 2}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.1, 0.1, 1],
                                      "metallicFactor": 0.9,
                                      "roughnessFactor": 0.2}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.1, 0.1, 0.8, 1],
                                      "metallicFactor": 0.0,
                                      "roughnessFactor": 0.9}},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "metallicFactor": 0.0,
                                      "roughnessFactor": 0.8}},
        ],
        "textures": [{"source": 0}],
        "images": [{"bufferView": len(views) - 1, "mimeType": "image/png"}],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": sum(len(b) for b in blobs)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    binv = b"".join(blobs)
    glb = io.BytesIO()
    glb.write(struct.pack("<III", 0x46546C67, 2,
                          12 + 8 + len(js) + 8 + len(binv)))
    glb.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
    glb.write(struct.pack("<II", len(binv), 0x004E4942) + binv)
    path.write_bytes(glb.getvalue())
    return path


def build_faceted_glb(path):
    """Write a GLB with the multimesh scene's two unit cubes at x = -1.5
    and 1.5 (resting on the ground), each with per-face normals (24
    vertices): from the default view the right cube's -x face is in sight
    and turned away from the light (n_dot_l <= 0), which the multimesh
    scene's cubes, without normals, never are. Returns `path`."""
    import json
    import struct

    verts, norms, idx = [], [], []
    for cx in (-1.5, 1.5):
        for a in range(3):
            for s in (1.0, -1.0):
                n = np.eye(3)[a] * s
                u, v = np.eye(3)[(a + 1) % 3], np.eye(3)[(a + 2) % 3]
                if s < 0:
                    u, v = v, u
                base = len(verts) % 24
                for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                    verts.append(np.array([cx, 0.5, 0.0]) + 0.5 * n
                                 + 0.5 * du * u + 0.5 * dv * v)
                    norms.append(n)
                idx += [base + k for k in (0, 1, 2, 2, 3, 0)]
    verts = np.asarray(verts, np.float32).reshape(2, 24, 3)
    norms = np.asarray(norms, np.float32).reshape(2, 24, 3)
    idx = np.asarray(idx, np.uint16).reshape(2, 36)

    blobs, accessors = [], []

    def add(arr, atype, ctype, bounds=False):
        acc = {"bufferView": len(blobs), "componentType": ctype,
               "count": len(arr), "type": atype}
        if bounds:
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        data = arr.tobytes()
        blobs.append(data + b"\0" * ((-len(data)) % 4))
        accessors.append(acc)
        return len(accessors) - 1

    meshes = [{"primitives": [{
        "attributes": {"POSITION": add(verts[k], "VEC3", 5126, True),
                       "NORMAL": add(norms[k], "VEC3", 5126)},
        "indices": add(idx[k], "SCALAR", 5123), "material": k}]}
        for k in range(2)]
    offsets = np.cumsum([0] + [len(b) for b in blobs])
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0}, {"mesh": 1}],
        "meshes": meshes,
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.1, 0.1, 1],
                                      "metallicFactor": 0.9,
                                      "roughnessFactor": 0.2}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.1, 0.1, 0.8, 1],
                                      "metallicFactor": 0.0,
                                      "roughnessFactor": 0.9}}],
        "bufferViews": [{"buffer": 0, "byteOffset": int(o),
                         "byteLength": len(b)}
                        for o, b in zip(offsets, blobs)],
        "accessors": accessors,
        "buffers": [{"byteLength": int(offsets[-1])}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    binv = b"".join(blobs)
    path.write_bytes(
        struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(binv))
        + struct.pack("<II", len(js), 0x4E4F534A) + js
        + struct.pack("<II", len(binv), 0x004E4942) + binv)
    return path


# Debug-panel triangle sets for the overlay kernel K4 (passes/overlay.py):
# name -> what the set holds. Each is (verts, uvs, colors, tris, n) as
# app/ui.py's Tessellator.arrays() returns them (padded with -1 rows).
OVERLAY_CASES = {
    "tiny": "triangles under 16 px^2 of |area| (the full-panel crop)",
    "slivers": "long thin and degenerate (zero-area) triangles",
    "edges": "triangles across and beyond the panel's edges, uv off the "
             "atlas",
}


def overlay_case(name: str, panel_hw=(256, 384), n_tris: int = 96,
                 seed: int = 0):
    """Seeded UI triangles of OVERLAY_CASES[name] over a panel of
    panel_hw, with premultiplied colours and atlas uvs, padded to
    n_tris + 8 slots of which n_tris are real (a padded row among them)."""
    ph, pw = panel_hw
    rng = np.random.default_rng(seed)
    centre = rng.uniform((0, 0), (pw, ph), (n_tris, 1, 2))
    if name == "tiny":
        verts = centre + rng.uniform(-2.5, 2.5, (n_tris, 3, 2))
    elif name == "slivers":
        d = rng.normal(size=(n_tris, 1, 2))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        along = rng.uniform(-80, 80, (n_tris, 3, 1))
        across = rng.uniform(-0.3, 0.3, (n_tris, 3, 1))
        verts = centre + along * d + across * d[..., ::-1] * (1, -1)
        verts[::7, 2] = verts[::7, 0]          # zero area: dropped
    elif name == "edges":
        verts = rng.uniform((-40, -40), (pw + 40, ph + 40), (n_tris, 3, 2))
    else:
        raise KeyError(name)
    verts = verts.reshape(-1, 2).astype(np.float32)
    uvs = rng.uniform(-0.1, 1.1 if name == "edges" else 1.0,
                      (len(verts), 2)).astype(np.float32)
    alpha = rng.uniform(0.2, 1.0, (len(verts), 1))
    colors = np.concatenate([rng.uniform(0, 1, (len(verts), 3)) * alpha,
                             alpha], axis=-1).astype(np.float32)
    tris = np.full((n_tris + 8, 3), -1, np.int32)
    tris[:n_tris] = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    tris[n_tris // 2] = -1                     # a padded row among the real
    return verts, uvs, colors, tris, n_tris


def overlay_chunks_case(panel_hw=(256, 384), n_rows: int = 2048,
                        every: int = 16, seed: int = 0):
    """A full triangle table for K4's chunked tile lists: n_rows drawn
    triangles (ui.MAX_TRIS = 2048 by default, more rows than one block
    stages at once), the halves of small overlapping quads of 4-12 px
    sides (tight crop boxes) across the panel in draw order, with every
    `every`-th triangle a tiny one instead (under 16 px^2 of |area|: the
    whole panel as its crop box), so that each chunk holds both. As
    overlay_case, padded with 8 rows of -1."""
    ph, pw = panel_hw
    rng = np.random.default_rng(seed)
    tris_xy = []
    while len(tris_xy) < n_rows:
        if len(tris_xy) % every == every - 1:
            c = rng.uniform((4, 4), (pw - 4, ph - 4), (1, 2))
            tris_xy.append(c + rng.uniform(-1.5, 1.5, (3, 2)))
            continue
        x, y = rng.uniform((0, 0), (pw - 12, ph - 12))
        w, h = rng.uniform(4, 12, 2)
        a, b, c, d = (x, y), (x + w, y), (x + w, y + h), (x, y + h)
        tris_xy.append(np.array([a, b, c]))
        if len(tris_xy) % every != every - 1 and len(tris_xy) < n_rows:
            tris_xy.append(np.array([a, c, d]))
    verts = np.concatenate(tris_xy).astype(np.float32)
    uvs = rng.uniform(0.0, 1.0, (len(verts), 2)).astype(np.float32)
    alpha = rng.uniform(0.2, 1.0, (len(verts), 1))
    colors = np.concatenate([rng.uniform(0, 1, (len(verts), 3)) * alpha,
                             alpha], axis=-1).astype(np.float32)
    tris = np.full((n_rows + 8, 3), -1, np.int32)
    tris[:n_rows] = np.arange(3 * n_rows, dtype=np.int32).reshape(-1, 3)
    return verts, uvs, colors, tris, n_rows


def light_map_case(size: int = 1024, seed: int = 0):
    """(plane (3,), raw (size, size)) f32 for the light-map kernel K5: the
    sloped receiver plane of tests/test_lightspace.py and its raw depth,
    with a ramp blocker (its height, and so the PCSS penumbra, spans a
    range) and seeded rectangular blockers of random heights across the
    map, some cut by its border."""
    rng = np.random.default_rng(seed)
    plane = np.array([0.0004, -0.0006, 0.55], np.float32)
    t = ((np.arange(size, dtype=np.float32) + np.float32(0.5))
         / np.float32(size))
    raw = plane[0] * t[None, :] + plane[1] * t[:, None] + plane[2]
    y0, x0 = size * 5 // 16, size * 3 // 8
    raw[y0:y0 + size // 4, x0:x0 + size // 3] -= np.linspace(
        0.02, 0.3, size // 3, dtype=np.float32)[None, :]
    for _ in range(24):
        h, w = rng.integers(4, size // 6, 2)
        y, x = rng.integers(-h // 2, size - h // 2, 2)
        raw[max(y, 0):y + h, max(x, 0):x + w] -= np.float32(
            rng.uniform(0.01, 0.4))
    return plane, raw.astype(np.float32)


def light_uniform_fields(softness: float, size: int = 1024, taa: float = 1.0,
                         frame: float = 3.0) -> dict:
    """The FrameUniforms fields (numpy f32) a light map reads, as
    tests/test_lightspace.py::_mk_uni builds them: shadow_bias[0] the
    softness, debug_flags (debug, pcss, taa, frame index); the rest
    zeros."""
    z = np.zeros((4, 4), np.float32)
    f = lambda *v: np.array(v, np.float32)   # noqa: E731
    return dict(view=z, proj=z, view_proj=z,
                camera_pos=np.zeros(3, np.float32),
                light_dir=f(0.39, 0.86, 0.32),
                light_view_proj=np.zeros((4, 4, 4), np.float32),
                cascade_splits=np.zeros(4, np.float32),
                shadow_map_size=f(size, size, 1.0 / size, 1.0 / size),
                debug_flags=f(0.0, 1.0, taa, frame),
                shadow_bias=f(softness, 0, 0, 0),
                prev_view_proj=z, models=np.zeros((2, 4, 4), np.float32))


# Edge entries of a tap set: uv NaN, infinite, far outside the map, on the
# map's edges and on texel boundaries; a NaN receiver.
_EDGE_UV = [(np.nan, 0.5), (0.5, np.nan), (np.inf, 0.5), (-np.inf, 0.5),
            (0.5, np.inf), (1e12, -1e12), (-1e12, 1e12), (0.0, 0.0),
            (1.0, 1.0), (0.0, 1.0), (-0.001, 0.5), (1.001, 0.5)]


def pair_taps_case(seed: int, n: int, size: int, layers: int = 4,
                   edges: bool = True):
    """Inputs of the shadow filter's tap sets (numpy, f32 / int32):
    (depth (layers, size, size), uv (n, 2), layer (n,), receiver (n,),
    phi (n,)). The maps are a gentle slope with random occluder blocks
    nearer the light, so entries see no, some and all blockers; uv spans
    [-0.05, 1.05) (taps off the map's edges), receivers [0.2, 1.0); with
    `edges` the first entries are _EDGE_UV's, the texel boundaries i / size
    and (i + 0.5) / size, and one NaN receiver."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    depth = np.repeat((0.55 + 0.2 * x + 0.1 * y)[None], layers, 0)
    for li in range(layers):
        for _ in range(12):
            y0, x0 = rng.integers(0, size, 2)
            h, w = rng.integers(1, max(2, size // 4), 2)
            depth[li, y0:y0 + h, x0:x0 + w] = rng.uniform(0.2, 0.5)
    uv = rng.uniform(-0.05, 1.05, (n, 2))
    layer = rng.integers(0, layers, n)
    recv = rng.uniform(0.2, 1.0, n)
    phi = rng.uniform(0.0, 6.2831853, n)
    if edges:
        k = np.arange(8)
        edge = np.array(_EDGE_UV + [(i / size, (i + 0.5) / size) for i in k]
                        + [((size - i) / size, 1 - (i + 0.5) / size)
                           for i in k])
        uv[:len(edge)] = edge
        recv[len(edge)] = np.nan
    return (depth.astype(np.float32), uv.astype(np.float32),
            layer.astype(np.int32), recv.astype(np.float32),
            phi.astype(np.float32))


def relief_maps(seed, l, s):
    """Class-map inputs (L, S, S) f32 in [0, 1] with what the kernel's
    edges meet: a random relief, blocks at BORDER_DEPTH = 1.0 (some on the
    map's edge), a checkerboard of -0 and +0, runs of one value along rows
    and columns, an occluder step, zeros at the corners."""
    rng = np.random.default_rng(seed)
    maps = (0.4 + 0.5 * rng.random((l, s, s))).astype(np.float32)
    q = max(s // 8, 2)
    maps[:, :q, -q:] = np.float32(1.0)
    maps[:, 2 * q:3 * q, q:2 * q] = np.float32(1.0)
    z = maps[:, 3 * q:4 * q, 3 * q:4 * q]
    z[...] = 0.0
    z[:, ::2, ::2] = -0.0
    z[:, 1::2, 1::2] = -0.0
    maps[:, 5 * q, :] = np.float32(0.625)
    maps[:, :, 5 * q] = np.float32(0.3125)
    maps[:, 6 * q:, 6 * q:] -= np.float32(0.25)
    maps[:, 0, 0] = -0.0
    maps[:, -1, -1] = 0.0
    return maps


def special_maps(seed, l, s):
    """relief_maps with the values a class map must carry through every
    window exactly: NaN texels, +inf and -inf texels and short runs of
    each, a long BORDER_DEPTH run along a row and a column."""
    rng = np.random.default_rng(seed)
    maps = relief_maps(seed, l, s)
    flat = maps.reshape(l, -1)
    for value in (np.nan, np.inf, -np.inf):
        at = rng.integers(0, s * s, (l, max(2, s // 16)))
        np.put_along_axis(flat, at, np.float32(value), axis=1)
        y, x = rng.integers(0, s - 3, 2)
        maps[:, y, x:x + 3] = np.float32(value)
    maps[:, s // 3, :] = np.float32(1.0)
    maps[:, :, s // 2] = np.float32(1.0)
    return maps


# 32-bit words a copy must carry bit for bit: +inf, -inf, -0.0, 0.0, quiet
# and signalling NaNs with payloads, a negative NaN, the largest NaN.
SPECIAL_WORDS = (0x7F800000, 0xFF800000, 0x80000000, 0x00000000, 0x7FC00001,
                 0x7F800001, 0xFFC12345, 0x7FFFFFFF)


def quad_pack_maps(seed, shape):
    """(..., H, W) f32 random maps whose words hold SPECIAL_WORDS at up to
    1,000 random texels and all along the last row and column (where the
    +1 neighbours clamp)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(shape).astype(np.float32)
    words = img.reshape((-1,) + img.shape[-2:]).view(np.uint32)
    specials = np.asarray(SPECIAL_WORDS, np.uint32)
    hits = rng.choice(words.size, size=min(words.size, 1000), replace=False)
    words.reshape(-1)[hits] = rng.choice(specials, size=hits.size)
    words[:, -1, :] = rng.choice(specials, size=words[:, -1, :].shape)
    words[:, :, -1] = rng.choice(specials, size=words[:, :, -1].shape)
    return img


def random_planes(seed, l):
    """(L, 3) f32 uv-space depth planes: small slopes about 0.5."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((l, 3)) * np.asarray([0.05, 0.05, 0.4])
            + np.asarray([0.0, 0.0, 0.5])).astype(np.float32)


def contact_rays(payload, seed: int, n: int, nan_share: float = 0.02):
    """(n, 7) f32 contact payload rows [march start, march dir, jitter]
    drawn from a frame's own `payload` rows (n0, 7): each a row moved
    along its direction by s in [-1.5, 1) of its length, its direction
    scaled by [0.5, 2) and a new jitter, so that the first hit falls on
    every linear probe, rays start off screen and enter it, and some miss;
    a `nan_share` of the rows hold a NaN in one column."""
    rng = np.random.default_rng(seed)
    rows = np.asarray(payload, np.float32)
    rows = rows[rng.integers(0, rows.shape[0], n)].astype(np.float64)
    s = rng.uniform(-1.5, 1.0, (n, 1))
    scale = rng.uniform(0.5, 2.0, (n, 1))
    out = np.concatenate([rows[:, 0:3] + rows[:, 3:6] * s,
                          rows[:, 3:6] * scale,
                          rng.uniform(0.0, 1.0, (n, 1))], -1)
    bad = np.flatnonzero(rng.random(n) < nan_share)
    out[bad, rng.integers(0, 7, bad.shape[0])] = np.nan
    return out.astype(np.float32)


# Binning cases of the binning kernel K12 (csrc/binning.cu) against its
# twin ops/binning.py::bin_triangles: name -> (framebuffer width, slab
# height, tile_h, tile_w, rows, capacity (None: every row), y_offset).
BINNING_CASES = {
    "main": (1920, 1080, 32, 128, 6000, None, 0),
    "cascade": (2048, 2048, 128, 256, 6000, None, 0),
    "slab": (2048, 288, 32, 128, 4000, None, 512),
    "cascade_slab": (2048, 512, 128, 256, 4000, None, 1024),
    "tight": (1920, 1080, 32, 128, 6000, 40, 0),
    "tight_cascade": (2048, 2048, 128, 256, 6000, 150, 0),
    "few_rows": (1920, 1080, 32, 128, 50, 512, 0),
    "no_rows": (1920, 1080, 32, 128, 0, 64, 0),
    "zero_capacity": (256, 128, 8, 128, 300, 0, 0),
    "rows8": (256, 128, 8, 128, 3000, None, 0),
    "ragged_chunk": (250, 130, 32, 128, 385, None, 0),
    "tiles_5x6": (128, 64, 5, 6, 700, None, 0),
}


def binning_case(name: str, seed: int = 0):
    """(data (T, 16) f32, valid (T,) bool) setup rows of one BINNING_CASES
    case over its full framebuffer (width x (y_offset + slab height) and
    the rows below), columns 0-11 random: AABBs of every size from a
    pixel to the whole frame, clamped to it as triangle setup clamps
    them, about 5% of the rows invalid with an AABB kept; every 50th row
    on tile edges, reaching the right and bottom edges exactly; and a few
    valid rows with NaN, +/-inf or out-of-range corners (the kernel's
    float -> int conversion)."""
    width, sh, th, tw, t, _, y_offset = BINNING_CASES[name]
    height = y_offset + sh + 3 * th
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((t, 16)).astype(np.float32)
    size = np.exp(rng.uniform(np.log(0.5), np.log(max(width, height)),
                              (t, 2)))
    centre = rng.uniform([-0.1 * width, -0.1 * height],
                         [1.1 * width, 1.1 * height], (t, 2))
    lo = np.clip(centre - size / 2, 0, [width, height])
    hi = np.clip(centre + size / 2, 0, [width, height])
    edge = np.arange(t) % 50 == 7
    k = edge.sum()
    lo[edge] = rng.integers(0, 4, (k, 2)) * [tw, th]
    hi[edge] = np.minimum(np.where(
        rng.random((k, 2)) < 0.5, [width, height],
        lo[edge] + rng.integers(1, 3, (k, 2)) * [tw, th]), [width, height])
    data[:, 12:14], data[:, 14:16] = lo, hi
    valid = (hi > lo).all(-1) & (rng.random(t) > 0.05)
    special = np.flatnonzero(np.arange(t) % 97 == 13)
    values = np.float32([np.nan, np.inf, -np.inf, 3e9, -3e9, -5.0])
    data[special, 12 + rng.integers(0, 4, special.size)] = rng.choice(
        values, special.size)
    valid[special] = True
    return data, valid
