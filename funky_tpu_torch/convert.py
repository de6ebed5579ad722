"""Carry the JAX package's inputs and state across to the port.

Each function takes the fields of a funky_tpu object (DeviceScene,
GltfParams, FrameState, FrameUniforms) as numpy arrays, under the same
field names — any mapping, e.g. `{f: np.asarray(getattr(obj, f))}` — and
returns the port's counterpart on `device`. Both packages then compute
from bit-identical inputs. This module imports no jax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .frame import FrameState, GltfParams
from .models.scene import TENSOR_FIELDS, DeviceScene
from .passes.uniforms import FrameUniforms

SCENE_COUNTS = ("num_vertices", "num_triangles", "num_objects")


def _t(a, device) -> torch.Tensor:
    # A writable copy (jax hands out read-only buffers); np.array keeps
    # 0-d arrays 0-d, where np.ascontiguousarray would make them 1-d.
    return torch.as_tensor(np.array(a, copy=True), device=device)


def scene_from_numpy(fields: Mapping, device="cuda") -> DeviceScene:
    return DeviceScene(
        **{f: _t(fields[f], device) for f in TENSOR_FIELDS},
        **{c: int(fields[c]) for c in SCENE_COUNTS})


def params_from_numpy(fields: Mapping, device="cuda") -> GltfParams:
    return GltfParams(**{f: _t(fields[f], device).to(torch.float32)
                         for f in GltfParams.__dataclass_fields__})


def state_from_numpy(fields: Mapping, device="cuda") -> FrameState:
    return FrameState(
        shadow_history=_t(fields["shadow_history"], device),
        prev_depth=_t(fields["prev_depth"], device),
        prev_view_proj=_t(fields["prev_view_proj"], device),
        has_prev=_t(fields["has_prev"], device).to(torch.bool),
        frame_index=_t(fields["frame_index"], device).to(torch.int32),
    )


def uniforms_from_numpy(fields: Mapping, device="cuda") -> FrameUniforms:
    return FrameUniforms(**{f: _t(fields[f], device)
                            for f in FrameUniforms._fields})
