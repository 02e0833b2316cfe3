"""Multi-device sharding of the BLOCK-SPARSE fusion path (counterpart of
otslam_tpu/distributed/sparse.py).

`distributed/sharding.py` scales the dense grid; this module scales the
block-sparse schedule of kernels/tsdf_cuda.py (the depth mips, K2, the
colour pack and K1 on the card) over a device mesh.

Decomposition (same algebra as the dense path, block-major state):

* **frame (data) axis** — frames shard contiguously across ranks. The only
  cross-frame coupling is the CREATION recurrence (created |= band,
  sequential in frame order; active = created & visible). Each rank
  classifies its frames (K2), the per-rank band unions are all-gathered
  (an (nd, NB) array), and every rank ORs the unions of the ranks BEFORE
  it into its starting `created` mask. Contiguous sharding makes this
  exactly the single-device creation prefix, so per-frame active sets
  match the serial path bit for bit. Each rank then fuses its shard into
  a zero block volume with the single-device schedule; the per-block
  partial sums (tsdf*w, w, color*w) and the created flags are
  all-reduced, and weighted means commute (SURVEY §2.4) — so the merged
  volume matches the serial running mean up to float reassociation.
* **object axis** — one BlockTSDFVolume per object, objects sharded across
  ranks, no integrate-time communication. Each object's volume is placed at
  its origin by an extrinsic shift (world -> world - (origin_o - base)).

`max_active` is the single-device schedule's per-frame cap (each frame
integrates its max_active lowest active block ids), applied to each rank's
frames; since the per-frame active sets equal the serial ones, a binding
cap gives the serial result with that cap too. JAX's `max_active` here is a
per-chunk capacity of its Pallas program instead (None sizes it so nothing
is dropped, which is the port's None). The Pallas-only arguments
(color_res, near_field, max_near, patch_rows, depth_win, color_rows,
depth_planes, interpret) are not ported: K1 samples every (block, frame)
pair exactly, so the near-field fallback has nothing to catch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.distributed.comm import (
    all_gather, all_reduce_sum, axis_rank, axis_size, mesh_device)
from otslam_tpu_torch.distributed.sharding import (
    padded_objects, object_shift, shard_rows)
from otslam_tpu_torch.kernels.marching import (
    _validate_batch, extract_meshes_block)
from otslam_tpu_torch.kernels.tsdf_block import (
    BLOCK, BlockTSDFVolume, make_block_volume)
from otslam_tpu_torch.kernels.tsdf_cuda import (
    classify_blocks, integrate_frames_cuda)

# the JAX Pallas path's frames per kernel call and blocks per grid step,
# which its capacity bound is taken over
FPC = 8
BPG = 8


def auto_max_active_sharded(vol: BlockTSDFVolume, depths, extrinsics,
                            intr: PinholeIntrinsics, n_shards: int,
                            bucket: int = 128) -> int:
    """The JAX package's static active-block capacity for its sharded
    fusion: the largest union of active blocks over any FPC-frame chunk of
    a shard, replaying the creation recurrence globally, at least BPG,
    rounded up to `bucket`. depths and extrinsics on the volume's device.

    A capacity of the Pallas program, kept because the dry run passes it
    as the JAX dry run does. Every frame's active count is at most its
    chunk's union, so as the port's per-frame cap it never binds: passing
    max_active=None gives the same volume without this extra K2 pass."""
    n = depths.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} frames not divisible by {n_shards} shards")
    nb = vol.num_blocks
    band, visible = classify_blocks(vol.meta, depths, extrinsics, intr)
    created = torch.cummax(band.to(torch.uint8), dim=0).values.bool()
    active = (created | vol.created[:nb][None]) & visible
    active = active.cpu().numpy()
    per = n // n_shards
    best = 0
    for s in range(n_shards):
        a = active[s * per:(s + 1) * per]
        pad = (-a.shape[0]) % FPC
        if pad:
            a = np.concatenate([a, np.zeros((pad, nb), bool)])
        union = a.reshape(-1, FPC, nb).any(axis=1)
        best = max(best, int(union.sum(axis=1).max()))
    best = max(best, BPG)
    return -(-best // bucket) * bucket


def _combine_partials(vol: BlockTSDFVolume, sum_tw, sum_w, sum_cw,
                      created_any) -> BlockTSDFVolume:
    """Merge all-reduced partial sums into the prior volume's running
    means. The dead row nb stays zero and uncreated."""
    nb = vol.num_blocks
    w_new = vol.weight + sum_w
    denom = torch.clamp(w_new, min=1.0)
    t_new = (vol.tsdf * vol.weight + sum_tw) / denom
    c_new = (vol.color * vol.weight.repeat(1, 3) + sum_cw) / denom.repeat(
        1, 3)
    t_new[nb] = 0.0
    w_new[nb] = 0.0
    c_new[nb] = 0.0
    created = created_any.clone()
    created[nb] = False
    return BlockTSDFVolume(t_new, w_new, c_new, created, vol.origin,
                           vol.voxel_size, vol.sdf_trunc, vol.grid_blocks)


def fuse_frames_sparse_data_parallel(
        vol: BlockTSDFVolume, depths, colors, extrinsics,
        intr: PinholeIntrinsics, mesh: DeviceMesh, data_axis: str = "data",
        max_active: int | None = None) -> BlockTSDFVolume:
    """Frame-sharded block-sparse fusion (the single-device schedule on
    each rank, one all-reduce of the per-block partial sums over the data
    axis). `vol` is the prior volume, on the mesh device of every rank;
    it is not modified, and the fused volume is returned on every rank.

    Same contract as kernels.tsdf_cuda.integrate_frames_cuda up to float
    reassociation of the cross-rank reduce (weights exact): the creation
    prefix is replayed exactly (see the module docstring), so per-frame
    active sets match the serial path. N frames must divide by the
    data-axis size. max_active: the per-frame cap (module docstring)."""
    nd = axis_size(mesh, data_axis)
    n = depths.shape[0]
    if n % nd:
        raise ValueError(f"{n} frames not divisible by {nd} devices")
    dev = mesh_device(mesh)
    if vol.device != dev:
        raise ValueError(f"prior volume on {vol.device}, mesh rank on {dev}")
    idx = axis_rank(mesh, data_axis)
    nb = vol.num_blocks
    d, c, e = (shard_rows(x, idx, nd, dev)
               for x in (depths, colors, extrinsics))
    # creation prefix: OR of the band unions of all earlier ranks
    band, _ = classify_blocks(vol.meta, d, e, intr)
    unions = all_gather(band.any(dim=0), mesh, data_axis)      # (nd, NB)
    local = BlockTSDFVolume(
        torch.zeros_like(vol.tsdf), torch.zeros_like(vol.weight),
        torch.zeros_like(vol.color), vol.created.clone(), vol.origin,
        vol.voxel_size, vol.sdf_trunc, vol.grid_blocks)
    local.created[:nb] |= unions[:idx].any(dim=0)
    integrate_frames_cuda(local, d, c, e, intr, max_active=max_active)
    # the sums are reduced in place: form every product before any reduce
    sums = (local.tsdf * local.weight, local.weight,
            local.color * local.weight.repeat(1, 3),
            local.created.to(torch.int32))
    sum_tw, sum_w, sum_cw, created = (all_reduce_sum(x, mesh, data_axis)
                                      for x in sums)
    return _combine_partials(vol, sum_tw, sum_w, sum_cw, created > 0)


def fuse_objects_sparse_parallel(depths, colors, extrinsics, origins,
                                 intr: PinholeIntrinsics, cfg,
                                 mesh: DeviceMesh, axis: str = "data",
                                 max_active: int | None = None):
    """OBJECT-axis parallel block-sparse fusion: each rank fuses the frame
    stacks of its object shard into per-object block volumes with the
    single-device schedule, no integrate-time collectives (the sparse
    analog of sharding.fuse_objects_parallel).

    depths (O, N, H, W), colors (O, N, H, W, 3), extrinsics (O, N, 4, 4),
    origins (O, 3) per-object volume origins; cfg: TSDFConfig (its
    `origin` is the placement base — each object's grid relocates to
    origins[i] by an extrinsic shift). Returns (tsdf (O, NB+1, 512),
    weight (O, NB+1, 512), color (O, NB+1, 1536), created (O, NB+1)),
    gathered over `axis` on every rank. Reassemble per-object volumes with
    BlockTSDFVolume(..., origin=tuple(origins[i]), ...)."""
    nd = axis_size(mesh, axis)
    n_obj = depths.shape[0]
    if n_obj % nd:
        raise ValueError(f"{n_obj} objects not divisible by {nd} devices")
    dev = mesh_device(mesh)
    i = axis_rank(mesh, axis)
    d, c, e, o = (shard_rows(x, i, nd, dev)
                  for x in (depths, colors, extrinsics, origins))
    outs = []
    for k in range(d.shape[0]):
        v = integrate_frames_cuda(
            make_block_volume(cfg, dev), d[k], c[k],
            e[k] @ object_shift(o[k], cfg.origin), intr,
            max_active=max_active)
        outs.append((v.tsdf, v.weight, v.color, v.created))
    return tuple(
        all_gather(torch.stack([out[j] for out in outs]), mesh, axis)
        .flatten(0, 1) for j in range(4))


def extract_meshes_sharded(vols, mesh: DeviceMesh, axis: str = "data",
                           max_blocks: int | None = None,
                           max_cells: int | None = None):
    """Object-axis sharded mesh extraction: triangle soups of B same-shape
    BlockTSDFVolumes, each rank extracting its object shard with
    marching.extract_meshes_block (the single path per volume), then the
    soups gathered over `axis`.

    Returns (verts (B, T, 9), cols (B, T, 9), masks (B, T)) with
    T = max_cells * 12, equal per volume to
    marching.extract_mesh_soup_block at the same capacities. Every rank
    passes all B volumes; the list pads to a device-count multiple by
    repeating the last volume, and padded rows are dropped on return.
    Capacities default to the max of the per-volume auto configs (shared
    by every shard)."""
    n_obj = len(vols)
    nd = axis_size(mesh, axis)
    padded = list(vols) + [vols[-1]] * ((-n_obj) % nd)
    mb, mc = _validate_batch(padded, max_blocks, max_cells)
    per = len(padded) // nd
    i = axis_rank(mesh, axis)
    soups = extract_meshes_block(padded[i * per:(i + 1) * per], mb, mc)
    return tuple(all_gather(s, mesh, axis).flatten(0, 1)[:n_obj]
                 for s in soups)


def fuse_all_sharded_sparse(ds, cfg, mesh: DeviceMesh, axis: str = "data",
                            auto_origin: bool = True,
                            max_active: int | None = None):
    """The fusion half of reconstruct_all_sharded_sparse: every object's
    frames fused on one rank of `axis` (objects sharded). Returns
    (names, frame counts, one BlockTSDFVolume an object), on every rank.

    Frame counts pad to the dataset max with empty (depth 0) frames (their
    bands are empty, so they create and integrate nothing); the object list
    pads to the device count by repeating the last object (dropped here)."""
    intr = PinholeIntrinsics.from_config(ds.camera)
    names, counts, d, c, e, origins = padded_objects(
        ds, cfg, intr, axis_size(mesh, axis), auto_origin)
    tsdf, weight, color, created = fuse_objects_sparse_parallel(
        d, c, e, origins, intr, cfg.tsdf, mesh, axis, max_active=max_active)
    grid_blocks = tuple(d // BLOCK for d in cfg.tsdf.dims)
    vols = [BlockTSDFVolume(
        tsdf[i], weight[i], color[i], created[i],
        tuple(float(x) for x in origins[i]), float(cfg.tsdf.voxel_size),
        float(cfg.tsdf.sdf_trunc), grid_blocks) for i in range(len(names))]
    return names, counts, vols


def reconstruct_all_sharded_sparse(ds, cfg, mesh: DeviceMesh,
                                   axis: str = "data",
                                   auto_origin: bool = True,
                                   max_active: int | None = None,
                                   **extract_kw) -> dict:
    """Object-sharded reconstruct_all over the block-sparse path: the
    objects fuse sharded (fuse_all_sharded_sparse), then sparse extraction
    and filtering run per object exactly like
    pipeline.reconstruct_object(backend='pallas'), on every rank."""
    from otslam_tpu_torch.pipeline.reconstruct import extract_filtered_cloud

    if not ds.object_names():
        return {}
    names, counts, vols = fuse_all_sharded_sparse(
        ds, cfg, mesh, axis, auto_origin, max_active)
    out = {}
    for n, k, vol in zip(names, counts, vols):
        res = extract_filtered_cloud(vol, cfg, **extract_kw)
        res.num_frames = k
        out[n] = res
    return out
