"""Device mesh over the framebuffer-rows axis (port of
funky_tpu/parallel/mesh.py:1-26).

The JAX package splits the framebuffer rows across chips: geometry is
tiny and replicated, pixel work shards, and the only traffic between
devices is the gather of finished row slabs and shadow-map slabs. Here a
device is one rank of a `torch.distributed` process group.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

ROWS_AXIS = "rows"


def make_mesh(n_devices: int | None = None, device="cuda") -> DeviceMesh:
    """A 1D mesh over the rows axis spanning the world (mesh.py:22-25).

    The default process group comes from the caller: `torchrun`'s
    environment and `dist.init_process_group()`, or an explicit
    `init_process_group(init_method=..., rank=..., world_size=...)`. For
    "cuda" the rank's card is set from LOCAL_RANK (default 0); with no card
    this raises. `n_devices` defaults to the world size and must equal it:
    a DeviceMesh spans the whole world, where JAX takes the first
    `n_devices` devices instead."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group "
                           "first (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh({n}): the mesh spans the whole world "
                         f"of {world} ranks")
    return init_device_mesh(torch.device(device).type, (n,),
                            mesh_dim_names=(ROWS_AXIS,))
