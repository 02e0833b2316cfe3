"""Multi-device sharding of the dense fusion and the eval (counterpart of
otslam_tpu/distributed/sharding.py).

TSDF integration is an order-independent weighted sum (SURVEY.md §2.4), which
fixes the parallel decomposition:

* **data axis** — frames shard across ranks; each rank computes partial
  sums (sum_tw, sum_w, sum_cw) over its shard with the single-device dense
  fusion, and one all-reduce merges them.
* **model axis** — the voxel grid shards as X-slabs; every rank integrates
  all its frames into its own slab (slab-local origin, shifted extrinsic),
  with no integrate-time communication. Combined with the data axis for a
  2-D (data x model) mesh: the all-reduce runs over 'data' only.

One process per device, each passing the full inputs and taking its
contiguous shard; the collectives are distributed/comm.py's. Each function
returns what the JAX function returns as a logical whole, on every rank:
where JAX leaves an output sharded (the X-slab grid, the object batch) the
port all-gathers it over that axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import to_f32
from otslam_tpu_torch.distributed.comm import (
    all_gather, all_reduce_sum, axis_rank, axis_size, mesh_device)
from otslam_tpu_torch.kernels.nn import nn_distance
from otslam_tpu_torch.kernels.tsdf import (
    TSDFVolume, merge_partials, partial_integrate)


def shard_rows(x, index: int, count: int, dev: torch.device,
               dtype=torch.float32) -> torch.Tensor:
    """Rows [index * n / count, (index + 1) * n / count) of x (array or
    tensor) as a `dtype` tensor on `dev`; only the shard is uploaded."""
    per = x.shape[0] // count
    part = x[index * per:(index + 1) * per]
    if isinstance(part, torch.Tensor):
        return part.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(part), dtype=dtype, device=dev)


def _all_reduce3(parts, mesh: DeviceMesh, axis: str):
    return tuple(all_reduce_sum(p, mesh, axis) for p in parts)


def fuse_frames_data_parallel(depths, colors, extrinsics,
                              intr: PinholeIntrinsics, cfg: TSDFConfig,
                              mesh: DeviceMesh, data_axis: str = "data"
                              ) -> TSDFVolume:
    """Frame-sharded fusion: N frames split over the data axis, one
    all-reduce. N must divide by the data-axis size. Equal to the
    single-device dense fusion up to float reassociation of the reduce."""
    nd = axis_size(mesh, data_axis)
    n = depths.shape[0]
    if n % nd:
        raise ValueError(f"{n} frames not divisible by {nd} devices")
    dev = mesh_device(mesh)
    i = axis_rank(mesh, data_axis)
    d, c, e = (shard_rows(x, i, nd, dev)
               for x in (depths, colors, extrinsics))
    parts = partial_integrate(d, c, e, intr, cfg)
    return merge_partials(*_all_reduce3(parts, mesh, data_axis), cfg)


def fuse_frames_2d_sharded(depths, colors, extrinsics,
                           intr: PinholeIntrinsics, cfg: TSDFConfig,
                           mesh: DeviceMesh, data_axis: str = "data",
                           model_axis: str = "model") -> TSDFVolume:
    """2-D sharding: frames over 'data', voxel-grid X-slabs over 'model'.

    Each (data, model) rank integrates its frame shard into its X-slab
    (slab-local volume origin), all-reduces the partials over 'data' only,
    and the full volume is reassembled from the slabs (all-gather over
    'model')."""
    nd = axis_size(mesh, data_axis)
    nm = axis_size(mesh, model_axis)
    X, Y, Z = cfg.dims
    if X % nm:
        raise ValueError(f"X dim {X} not divisible by model axis {nm}")
    if depths.shape[0] % nd:
        raise ValueError("frames not divisible by data axis")
    slab_x = X // nm
    dev = mesh_device(mesh)
    i = axis_rank(mesh, data_axis)
    m = axis_rank(mesh, model_axis)
    d, c, e = (shard_rows(x, i, nd, dev)
               for x in (depths, colors, extrinsics))
    # slab-local volume: same grid, origin shifted along X by the
    # extrinsic: world' = world + (ox, 0, 0) => extrinsic' = E @ T(+ox)
    ox = np.float32(cfg.origin[0]) + np.float32(m) * np.float32(
        slab_x) * np.float32(cfg.voxel_size)
    slab_cfg = dataclasses.replace(
        cfg, dims=(slab_x, Y, Z), origin=(0.0, cfg.origin[1], cfg.origin[2]))
    shift = torch.eye(4, dtype=torch.float32, device=dev)
    shift[0, 3] = float(ox)
    parts = partial_integrate(d, c, e @ shift, intr, slab_cfg)
    sum_tw, sum_w, sum_cw = _all_reduce3(parts, mesh, data_axis)
    sum_tw = all_gather(sum_tw, mesh, model_axis).reshape(X, Y, Z)
    sum_w = all_gather(sum_w, mesh, model_axis).reshape(X, Y, Z)
    sum_cw = all_gather(sum_cw, mesh, model_axis)       # (nm, 3, slab, Y, Z)
    sum_cw = sum_cw.permute(1, 0, 2, 3, 4).reshape(3, X, Y, Z)
    return merge_partials(sum_tw, sum_w, sum_cw, cfg)


def fuse_frames_hierarchical(depths, colors, extrinsics,
                             intr: PinholeIntrinsics, cfg: TSDFConfig,
                             mesh: DeviceMesh, dcn_axis: str = "dcn",
                             ici_axis: str = "ici") -> TSDFVolume:
    """Multi-host data parallelism over a 2-level (dcn, ici) mesh.

    Frames shard over BOTH axes (flat data parallelism, dcn-major); the
    partial-volume reduction is HIERARCHICAL: all-reduce over the ici axis
    first (devices within a host), then over dcn, so the slow cross-host
    network carries one already-reduced volume per host."""
    n_dcn = axis_size(mesh, dcn_axis)
    n_ici = axis_size(mesh, ici_axis)
    ntotal = n_dcn * n_ici
    if depths.shape[0] % ntotal:
        raise ValueError(
            f"{depths.shape[0]} frames not divisible by {ntotal} devices")
    dev = mesh_device(mesh)
    i = axis_rank(mesh, dcn_axis) * n_ici + axis_rank(mesh, ici_axis)
    d, c, e = (shard_rows(x, i, ntotal, dev)
               for x in (depths, colors, extrinsics))
    parts = partial_integrate(d, c, e, intr, cfg)
    parts = _all_reduce3(parts, mesh, ici_axis)
    return merge_partials(*_all_reduce3(parts, mesh, dcn_axis), cfg)


def object_shift(origin: torch.Tensor, base) -> torch.Tensor:
    """(4, 4) world -> world' = world - (origin - base): the voxel at
    base + idx * vs in world' sits at origin + idx * vs in the world."""
    shift = torch.eye(4, dtype=torch.float32, device=origin.device)
    shift[:3, 3] = origin - torch.as_tensor(
        np.asarray(base, np.float32), device=origin.device)
    return shift


def fuse_objects_parallel(depths, colors, extrinsics, origins,
                          intr: PinholeIntrinsics, cfg: TSDFConfig,
                          mesh: DeviceMesh, axis: str = "data"):
    """OBJECT-axis parallel fusion (SURVEY §2.4: frame- and object-parallel).

    depths (O, N, H, W), colors (O, N, H, W, 3), extrinsics (O, N, 4, 4),
    origins (O, 3): each rank fuses the frames of its object shard into
    per-object volumes with no integrate-time communication. Each object's
    volume is placed at its origin by an extrinsic shift (the grid keeps
    cfg's shape). Returns (tsdf (O, X, Y, Z), weight (O, X, Y, Z),
    color (O, 3, X, Y, Z)), gathered over `axis` on every rank."""
    nd = axis_size(mesh, axis)
    if depths.shape[0] % nd:
        raise ValueError(
            f"{depths.shape[0]} objects not divisible by {nd} devices")
    dev = mesh_device(mesh)
    i = axis_rank(mesh, axis)
    d, c, e, o = (shard_rows(x, i, nd, dev)
                  for x in (depths, colors, extrinsics, origins))
    outs = []
    for k in range(d.shape[0]):
        sum_tw, sum_w, sum_cw = partial_integrate(
            d[k], c[k], e[k] @ object_shift(o[k], cfg.origin), intr, cfg)
        denom = torch.clamp(sum_w, min=1.0)
        outs.append((sum_tw / denom, sum_w, sum_cw / denom[None]))
    return tuple(
        all_gather(torch.stack([out[j] for out in outs]), mesh, axis)
        .flatten(0, 1) for j in range(3))


def padded_objects(ds, cfg, intr: PinholeIntrinsics, nd: int,
                    auto_origin: bool):
    """(names, frame counts, depths, colors, extrinsics, origins) of every
    object: frame counts padded to the dataset max with empty (depth 0,
    identity) frames, the object list to a multiple of nd by repeating the
    last object."""
    from otslam_tpu_torch.pipeline.reconstruct import auto_volume_origin

    names = ds.object_names()
    batches = {n: ds.load_object(n) for n in names}
    max_frames = max(b.depths.shape[0] for b in batches.values())
    ds_list, cs_list, es_list, os_list = [], [], [], []
    for n in names:
        b = batches[n]
        pad = max_frames - b.depths.shape[0]
        ds_list.append(np.concatenate(
            [b.depths, np.zeros((pad,) + b.depths.shape[1:], np.float32)]))
        cs_list.append(np.concatenate(
            [b.colors, np.zeros((pad,) + b.colors.shape[1:], np.float32)]))
        es_list.append(np.concatenate(
            [b.extrinsics,
             np.tile(np.eye(4, dtype=np.float32)[None], (pad, 1, 1))]))
        os_list.append(auto_volume_origin(b, intr, cfg) if auto_origin
                       else cfg.tsdf.origin)
    while len(ds_list) % nd:
        for lst in (ds_list, cs_list, es_list, os_list):
            lst.append(lst[-1])
    counts = [int(batches[n].depths.shape[0]) for n in names]
    return (names, counts, np.stack(ds_list), np.stack(cs_list),
            np.stack(es_list), np.asarray(os_list, np.float32))


def reconstruct_all_sharded(ds, cfg, mesh: DeviceMesh, axis: str = "data",
                            auto_origin: bool = True, **extract_kw) -> dict:
    """Object-sharded reconstruct_all over the dense path: every object's
    fusion runs on one rank of `axis`, then extraction and filtering run
    per object exactly like pipeline.reconstruct_object, on every rank.

    Frame counts pad to the dataset max with empty frames, which add
    nothing to the weighted sums, so the fused volumes match the serial
    dense path up to float reassociation; the extracted clouds are then
    geometrically identical up to crossing-interpolation noise (a
    reassociation-level tsdf difference can flip a boundary crossing).
    The object list pads to the device count by repeating the last object
    (dropped on return)."""
    from otslam_tpu_torch.pipeline.reconstruct import extract_filtered_cloud

    if not ds.object_names():
        return {}
    intr = PinholeIntrinsics.from_config(ds.camera)
    names, counts, d, c, e, origins = padded_objects(
        ds, cfg, intr, axis_size(mesh, axis), auto_origin)
    tsdf, weight, color = fuse_objects_parallel(d, c, e, origins, intr,
                                                cfg.tsdf, mesh, axis)
    out = {}
    for i, n in enumerate(names):
        vol = TSDFVolume(tsdf[i], weight[i], color[i],
                         tuple(float(x) for x in origins[i]),
                         float(cfg.tsdf.voxel_size),
                         float(cfg.tsdf.sdf_trunc))
        res = extract_filtered_cloud(vol, cfg, **extract_kw)
        res.num_frames = counts[i]
        out[n] = res
    return out


def chamfer_data_parallel(src, dst, mesh: DeviceMesh,
                          data_axis: str = "data") -> torch.Tensor:
    """Mean nearest-neighbour distance of src to dst: source points shard
    over the data axis, each rank finds its points' nearest neighbours in
    the whole target (K3 on the card), and the sum and the count are
    all-reduced. The src length must divide by the axis size."""
    nd = axis_size(mesh, data_axis)
    if src.shape[0] % nd:
        raise ValueError("src points not divisible by data axis size")
    dev = mesh_device(mesh)
    s = shard_rows(src, axis_rank(mesh, data_axis), nd, dev)
    dist = nn_distance(s, to_f32(dst, dev))
    total = all_reduce_sum(torch.sum(dist).reshape(1), mesh, data_axis)
    count = all_reduce_sum(
        torch.tensor([float(s.shape[0])], device=dev), mesh, data_axis)
    return (total / count)[0]
