"""Vertex stage: object -> world -> clip, and per-triangle shade blocks
(port of funky_tpu/passes/geometry.py). The einsums are full fp32 on the
card: the package disables TF32 at import.
"""

from __future__ import annotations

import torch

from ..models.scene import DeviceScene

SHADE_BLOCK_WIDTH = 12


def transform_vertices(scene: DeviceScene, models: torch.Tensor,
                       view_proj: torch.Tensor):
    """geometry.py:25-58. Returns world (V, 3), clip (V, 4) and world
    normals (V, 3)."""
    num_objects = models.shape[0]
    onehot = (scene.vert_object[:, None]
              == torch.arange(num_objects, dtype=torch.int32,
                              device=models.device)[None, :]
              ).to(torch.float32)
    rot = models[:, :3, :3]
    trans = models[:, :3, 3]
    world_per_obj = torch.einsum("vj,oij->voi", scene.positions, rot)
    world = torch.einsum("vo,voi->vi", onehot, world_per_obj) + onehot @ trans

    nrm_per_obj = torch.einsum("vj,oij->voi", scene.normals, rot)
    nrm = torch.einsum("vo,voi->vi", onehot, nrm_per_obj)
    nrm = nrm / torch.clamp(
        torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-12)

    ones = torch.ones((world.shape[0], 1), dtype=torch.float32,
                      device=world.device)
    clip = torch.cat([world, ones], dim=-1) @ view_proj.T
    return world, clip, nrm


def build_shade_blocks(scene: DeviceScene, world: torch.Tensor,
                       clip: torch.Tensor,
                       normals: torch.Tensor) -> torch.Tensor:
    """Per-corner [world(3), normal(3), uv(2), color(3), inv_w(1)]:
    (T, 3, 12) (geometry.py:61-67)."""
    inv_w = 1.0 / torch.clamp(clip[:, 3:4], min=1e-12)
    per_vertex = torch.cat(
        [world, normals, scene.uvs, scene.colors, inv_w], dim=-1)
    return per_vertex[scene.tri_indices.long()]
