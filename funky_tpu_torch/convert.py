"""Carry the JAX package's inputs and state across to the port.

Each function takes the fields of a funky_tpu object (DeviceScene,
GltfParams, FrameState, FrameUniforms) as numpy arrays, under the same
field names — any mapping, e.g. `{f: np.asarray(getattr(obj, f))}` — and
returns the port's counterpart on `device`; `config_from_jax_fields`
takes a GltfConfig's plain Python fields. Both packages then compute
from bit-identical inputs under the same configuration. This module
imports no jax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .frame import FrameState, GltfConfig, GltfFrameFlags, GltfParams
from .models.scene import TENSOR_FIELDS, DeviceScene
from .ops.raster import RasterConfig
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


# JAX raster backends and the port's: the plain jnp raster is the plain
# torch twin, the Pallas kernels are the CUDA kernels.
RASTER_BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


def raster_config_from_jax_fields(fields: Mapping) -> RasterConfig:
    kw = dict(fields)
    kw["backend"] = RASTER_BACKENDS[kw.get("backend", "auto")]
    return RasterConfig(**kw)


def config_from_jax_fields(fields: Mapping) -> GltfConfig:
    """The port's GltfConfig from a funky_tpu GltfConfig given as plain
    Python fields, e.g. `dataclasses.asdict(jax_cfg)`: `raster` and
    `shadow_raster` as RasterConfig field mappings, `flags` as a
    GltfFrameFlags field mapping, tuples as tuples or lists."""
    kw = {}
    for name, value in fields.items():
        if name in ("raster", "shadow_raster"):
            value = raster_config_from_jax_fields(value)
        elif name == "flags":
            value = GltfFrameFlags(**value)
        elif isinstance(value, list):
            value = tuple(value)
        kw[name] = value
    return GltfConfig(**kw)
