"""The collectives of the sharded paths, over a DeviceMesh axis.

`jax.lax.psum` -> `all_reduce_sum`, `jax.lax.all_gather` -> `all_gather`,
`axis_index` -> `axis_rank`. A collective runs on the tensor's own device
when the axis group's backend takes it (NCCL on CUDA, gloo on the CPU); a
CUDA tensor in a gloo group goes through a host copy, which lets several
ranks share one card. No other module of the port calls
`torch.distributed` collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from otslam_tpu_torch.device import resolve_device


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along `axis` (JAX's axis_index)."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in this mesh")
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: the CPU for a "cpu" mesh, else the
    current CUDA device (a "cuda" mesh sets it per rank)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    dev = resolve_device(mesh.device_type)
    return torch.device(dev.type, torch.cuda.current_device())


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and "nccl" not in str(dist.get_backend(group))


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh, axis: str
                   ) -> torch.Tensor:
    """Sum of `t` over the ranks along `axis`, in place; returns t."""
    group = mesh.get_group(axis)
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(size, *t.shape): every rank's `t` along `axis`, in rank order, on
    t's device. Bool tensors travel as uint8."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = src.contiguous()
    if _via_host(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts).to(t.device)
    return out.bool() if t.dtype == torch.bool else out
