"""Seeded test scenes for the port's raster, in numpy only (no jax), so that
the card-only tests and chip_smoke.py can use them where jax is absent.
Not a test module itself."""

from __future__ import annotations

import numpy as np


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


def with_coplanar_duplicates(clip, n_dup_tris=10):
    """Appends copies of the first `n_dup_tris` triangles (higher ids,
    identical planes): every pixel they cover is an exact depth tie, which
    the first-drawn (lower) id must win."""
    clip = np.concatenate([clip, clip[:3 * n_dup_tris]])
    return clip, np.arange(len(clip), dtype=np.int32).reshape(-1, 3)
