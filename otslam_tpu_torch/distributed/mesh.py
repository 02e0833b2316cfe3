"""Device-mesh construction (counterpart of otslam_tpu/distributed/mesh.py).

JAX runs `shard_map` in one process over a `Mesh` of devices; the port runs
one process per device in a `torch.distributed` process group, and a mesh is
a `DeviceMesh` over the group's ranks. The caller starts the group
(`torch.distributed.init_process_group`, or `distributed/launch.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh over the first prod(shape) ranks of the default group.

    shape=None uses every rank on a 1-D 'data' axis. For 2-D meshes pass
    e.g. shape=(4, 2), axis_names=("data", "model") — the data axis shards
    frames (partial sums, one all-reduce to merge), the model axis shards
    the voxel grid (X-slabs, no communication at integrate time). Every
    rank of the group must call it; a rank outside a smaller mesh gets a
    mesh it is not in."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {world}")
    if len(shape) != len(axis_names):
        raise ValueError("shape and axis_names rank mismatch")
    names = tuple(axis_names)
    if n == world:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)
