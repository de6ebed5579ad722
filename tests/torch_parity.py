"""Shared helpers for the port parity tests (tests/test_torch_*.py).

The same numpy inputs go through a funky_tpu (JAX) function and its
funky_tpu_torch counterpart on the CPU; `funky_tpu_torch.convert` carries
JAX objects across field by field. Not a test module itself.
"""

from __future__ import annotations

import functools
import pathlib
import tempfile

import numpy as np
import torch

import funky_tpu.frame as jframe
from funky_tpu.models.gltf import GltfScene as JGltfScene
from funky_tpu.models.sample_scenes import build_multimesh_glb
from funky_tpu.models.scene import build_device_scene as jbuild_scene
from funky_tpu.ops.raster import RasterConfig as JRasterConfig

import funky_tpu_torch.frame as tframe
from funky_tpu_torch import convert
from funky_tpu_torch.models.scene import TENSOR_FIELDS
from funky_tpu_torch.ops.raster import RasterConfig as TRasterConfig

# Several xdist workers share the host: keep torch's pool small.
torch.set_num_threads(2)

SCENE_FIELDS = TENSOR_FIELDS + convert.SCENE_COUNTS
PARAM_FIELDS = tuple(tframe.GltfParams.__dataclass_fields__)
STATE_FIELDS = tframe.FrameState._fields


def fields(obj, names) -> dict:
    return {n: np.asarray(getattr(obj, n)) for n in names}


def port_scene(jscene, device="cpu"):
    return convert.scene_from_numpy(fields(jscene, SCENE_FIELDS), device)


def port_params(jparams, device="cpu"):
    return convert.params_from_numpy(fields(jparams, PARAM_FIELDS), device)


def port_state(jstate, device="cpu"):
    return convert.state_from_numpy(fields(jstate, STATE_FIELDS), device)


def port_uniforms(juni, device="cpu"):
    return convert.uniforms_from_numpy(fields(juni, juni._fields), device)


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def multimesh_gltf():
    """The repo's multimesh scene (two cubes casting onto a textured
    ground), loaded by the JAX package's loader."""
    with tempfile.TemporaryDirectory() as td:
        glb = build_multimesh_glb(pathlib.Path(td) / "multi.glb",
                                  two_textures=True)
        return JGltfScene.load(glb)


@functools.lru_cache(maxsize=None)
def multimesh_jax_scene():
    return jbuild_scene(multimesh_gltf())


def slice_configs(width=256, height=144, shadow=256, tile_h=16, tile_w=128):
    """(JAX config, port config) of the dense slice at a small size."""
    jtile = JRasterConfig(tile_h=tile_h, tile_w=tile_w, backend="jnp")
    ttile = TRasterConfig(tile_h=tile_h, tile_w=tile_w)
    common = dict(width=width, height=height, shadow_map_size=shadow,
                  valid_block_capacity=0, texture_block_capacity=0)
    jcfg = jframe.GltfConfig(
        raster=jtile, shadow_raster=jtile,
        flags=jframe.GltfFrameFlags(sparse_shadows=False,
                                    sparse_contact=False), **common)
    tcfg = tframe.GltfConfig(
        raster=ttile, shadow_raster=ttile,
        flags=tframe.GltfFrameFlags(sparse_shadows=False,
                                    sparse_contact=False), **common)
    return jcfg, tcfg


def multimesh_params():
    return jframe.default_gltf_params(
        gltf_min_y=float(multimesh_gltf().bounds_min[1]), gltf_scale=1.0)
