"""Built-in geometry: the demo cube and the ground plane.

- Cube: 24 vertices (per-face normals), 36 indices, uniform soft-teal color
  (cube.rs:19-64). Used by the rotating-cube demo (BASELINE config 1).
- Ground plane: 20x20 units at y=0, gray, up normals, UVs 0..10
  (gltf_renderer.rs:610-678). Drawn with useTexture=0.

(numpy copy of funky_tpu/models/primitives.py: the port runs where jax is
not installed, and funky_tpu/__init__.py imports jax.)
"""

from __future__ import annotations

import numpy as np

CUBE_BASE_COLOR = (0.45, 0.70, 0.75)  # cube.rs:20


def cube_geometry():
    """Returns (positions (24,3), normals (24,3), colors (24,3),
    indices (36,)) matching cube.rs:21-64."""
    c = CUBE_BASE_COLOR
    # (position, normal) per face, 4 verts each — exact ordering of cube.rs.
    data = [
        # Front (+Z)
        ([-0.5, -0.5, 0.5], [0, 0, 1]), ([0.5, -0.5, 0.5], [0, 0, 1]),
        ([0.5, 0.5, 0.5], [0, 0, 1]), ([-0.5, 0.5, 0.5], [0, 0, 1]),
        # Back (-Z)
        ([-0.5, -0.5, -0.5], [0, 0, -1]), ([-0.5, 0.5, -0.5], [0, 0, -1]),
        ([0.5, 0.5, -0.5], [0, 0, -1]), ([0.5, -0.5, -0.5], [0, 0, -1]),
        # Top (+Y)
        ([-0.5, 0.5, -0.5], [0, 1, 0]), ([-0.5, 0.5, 0.5], [0, 1, 0]),
        ([0.5, 0.5, 0.5], [0, 1, 0]), ([0.5, 0.5, -0.5], [0, 1, 0]),
        # Bottom (-Y)
        ([-0.5, -0.5, -0.5], [0, -1, 0]), ([0.5, -0.5, -0.5], [0, -1, 0]),
        ([0.5, -0.5, 0.5], [0, -1, 0]), ([-0.5, -0.5, 0.5], [0, -1, 0]),
        # Right (+X)
        ([0.5, -0.5, -0.5], [1, 0, 0]), ([0.5, 0.5, -0.5], [1, 0, 0]),
        ([0.5, 0.5, 0.5], [1, 0, 0]), ([0.5, -0.5, 0.5], [1, 0, 0]),
        # Left (-X)
        ([-0.5, -0.5, -0.5], [-1, 0, 0]), ([-0.5, -0.5, 0.5], [-1, 0, 0]),
        ([-0.5, 0.5, 0.5], [-1, 0, 0]), ([-0.5, 0.5, -0.5], [-1, 0, 0]),
    ]
    positions = np.array([d[0] for d in data], np.float32)
    normals = np.array([d[1] for d in data], np.float32)
    colors = np.tile(np.asarray(c, np.float32), (24, 1))
    indices = np.array([
        0, 1, 2, 2, 3, 0,       # Front
        4, 5, 6, 6, 7, 4,       # Back
        8, 9, 10, 10, 11, 8,    # Top
        12, 13, 14, 14, 15, 12,  # Bottom
        16, 17, 18, 18, 19, 16,  # Right
        20, 21, 22, 22, 23, 20,  # Left
    ], np.uint32)
    return positions, normals, colors, indices


def ground_plane_geometry(size: float = 20.0):
    """Returns (positions (4,3), normals, uvs, colors, indices (6,))
    matching gltf_renderer.rs:613-628."""
    half = size * 0.5
    positions = np.array([
        [-half, 0.0, -half],
        [half, 0.0, -half],
        [half, 0.0, half],
        [-half, 0.0, half],
    ], np.float32)
    normals = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (4, 1))
    uvs = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float32)
    colors = np.tile(np.array([0.35, 0.35, 0.35], np.float32), (4, 1))
    indices = np.array([0, 1, 2, 2, 3, 0], np.uint32)
    return positions, normals, uvs, colors, indices
