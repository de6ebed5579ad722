"""The system under test: funky_tpu_torch's compiled glTF frame.

Everything the benchmark takes from the program goes through here: the
scene loaded from the GLB the benchmark wrote, the shipped configuration
with the flags of the cell's configuration file, the autotune
(`entry.tune`) over the poses the window renders, and the frame
`frame.compiled_gltf_frame(cfg)`, which on the card records the committed
frame as one CUDA graph at its first call and replays it after.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import torch

from .traffic import Pose


def build_kernels() -> None:
    """The port's CUDA sources, built together at the start of set-up (a
    library already built is reused)."""
    from funky_tpu_torch.ops import cuda_build

    cuda_build.build_all(sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))


def load_scene(spec, glb_path: pathlib.Path, device):
    """The program's DeviceScene: its own loader on the GLB, or the ground
    alone where the traffic names no glTF."""
    from funky_tpu_torch.models.gltf import GltfScene
    from funky_tpu_torch.models.scene import build_device_scene

    gltf = None
    if spec is not None:
        from .scene import write_glb

        gltf = GltfScene.load(write_glb(spec, glb_path))
    return build_device_scene(gltf, device=device)


def params(pose: Pose, device):
    """The program's GltfParams of one pose, on the device."""
    from funky_tpu_torch.frame import GltfParams

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)

    return GltfParams(**{f.name: t(getattr(pose, f.name))
                         for f in dataclasses.fields(GltfParams)})


def config(cfg_file: dict, size: dict | None = None):
    """The untuned GltfConfig of a configuration file: its frame size and
    its flags. `size` replaces the frame size (the CPU tests)."""
    from funky_tpu_torch.frame import GltfConfig, GltfFrameFlags

    frame = dict(cfg_file["frame"])
    if size:
        frame.update(size)
    return GltfConfig(width=frame["width"], height=frame["height"],
                      shadow_map_size=frame["shadow_map_size"],
                      flags=GltfFrameFlags(**cfg_file["flags"]))


def tune(scene, poses: list, cfg):
    """entry.tune over the poses in order. Returns (cfg, seconds)."""
    from funky_tpu_torch import entry

    t0 = time.perf_counter()
    cfg = entry.tune(scene, poses, cfg)
    if poses[0].camera_pos.device.type == "cuda":
        torch.cuda.synchronize()
    return cfg, time.perf_counter() - t0


def overflows(scene, poses: list, cfg) -> list:
    """capacity_overflows of the tuned config over the poses in order, read
    as the autotune reads them."""
    from funky_tpu_torch.utils.autotune import capacity_overflows
    from funky_tpu_torch.utils.diagnostics import measure_sparse_occupancy

    return capacity_overflows(cfg, measure_sparse_occupancy(scene, poses,
                                                            cfg))


def compiled(cfg):
    from funky_tpu_torch import frame

    return frame.compiled_gltf_frame(cfg)


def init_state(cfg, device):
    from funky_tpu_torch import frame

    return frame.init_frame_state(cfg, device)


def release() -> None:
    """Drop the compiled frames (their graphs and static buffers)."""
    from funky_tpu_torch import frame

    frame._CACHE.clear()
