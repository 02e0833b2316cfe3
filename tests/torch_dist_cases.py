"""The port's side of tests/test_torch_distributed.py: every sharded case,
run on each rank of one gloo group (distributed/launch.run_ranks), with no
JAX in the rank processes.

`run_all(inputs)` returns, on rank 0, each case's outputs as numpy arrays
(or the ValueError message of a case that must raise), and on every rank a
digest of each output, so the test can hold every rank to the same logical
whole.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from otslam_tpu_torch.config import (
    CameraConfig, ReconstructionConfig, TSDFConfig)
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.distributed import (
    chamfer_data_parallel, extract_meshes_sharded, fuse_frames_2d_sharded,
    fuse_frames_data_parallel, fuse_frames_hierarchical,
    fuse_frames_sparse_data_parallel, fuse_objects_parallel,
    fuse_objects_sparse_parallel, make_mesh, reconstruct_all_sharded,
    reconstruct_all_sharded_sparse)
from otslam_tpu_torch.distributed.dryrun import dryrun_multichip
from otslam_tpu_torch.distributed.sparse import (
    auto_max_active_sharded, fuse_all_sharded_sparse)
from otslam_tpu_torch.kernels.tsdf_block import (
    BlockTSDFVolume, make_block_volume)
from otslam_tpu_torch.kernels.tsdf_cuda import integrate_frames_cuda
from otslam_tpu_torch.pipeline.dataset import CaptureDataset

INTR = PinholeIntrinsics(64, 48, 56.0, 56.0, 32.0, 24.0)
CFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 64),
                 origin=(-0.64, -0.64, -0.64))
SMALL = PinholeIntrinsics(160, 120, 141.400225, 141.400225, 80.5, 60.5)
BOX = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 32),
                 origin=(0.86, -0.14, -0.02))
DS_CAM = CameraConfig(width=64, height=48, fx=56.0, fy=56.0, cx=32.0,
                      cy=24.0)
DS_CFG = ReconstructionConfig(
    camera=DS_CAM, tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08,
                                   dims=(64, 64, 32), origin=(0.0, 0.0, -0.1)),
    surface_samples=4000)
DS_INTR = PinholeIntrinsics.from_config(DS_CAM)
MESH_CAPS = dict(max_blocks=256, max_cells=4096)


def dense_out(vol):
    return {"tsdf": vol.tsdf, "weight": vol.weight, "color": vol.color}


def block_out(vol):
    return {"tsdf": vol.tsdf, "weight": vol.weight, "color": vol.color,
            "created": vol.created}


def cloud_out(results):
    return {name: {"points": r.points, "raw": r.raw_surface_count,
                   "frames": r.num_frames} for name, r in results.items()}


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x


def digest(x) -> str:
    h = hashlib.sha1()

    def feed(v):
        if isinstance(v, dict):
            for k in sorted(v):
                h.update(str(k).encode())
                feed(v[k])
        elif isinstance(v, (tuple, list)):
            for item in v:
                feed(item)
        elif isinstance(v, np.ndarray):
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())
    feed(x)
    return h.hexdigest()


def raises(fn) -> str:
    """The message of the ValueError fn() raises; fails when it does not."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{fn} did not raise ValueError")


def run_all(inp: dict) -> dict:
    """Every case on this rank of a 4-rank group; see the module docstring."""
    rank = torch.distributed.get_rank()
    mesh = make_mesh(None, ("data",), "cpu")            # (4,) over "data"
    mesh22 = make_mesh((2, 2), ("data", "model"), "cpu")
    hier22 = make_mesh((2, 2), ("dcn", "ici"), "cpu")
    hier14 = make_mesh((1, 4), ("dcn", "ici"), "cpu")
    pair = make_mesh((2,), ("data",), "cpu")            # ranks 0 and 1
    d8, c8, e8 = inp["dense"]
    sd, sc, se = inp["sparse"]
    bd, bc, be = inp["box"]
    od, oc, oe, oo = inp["objects"]
    out = {"mesh_shape": tuple(mesh.mesh.shape),
           "mesh_too_big": raises(lambda: make_mesh((8,), ("data",), "cpu")),
           "mesh_rank_mismatch": raises(
               lambda: make_mesh((2, 2), ("data",), "cpu"))}

    out["data_parallel"] = dense_out(fuse_frames_data_parallel(
        d8, c8, e8, INTR, CFG, mesh))
    out["data_indivisible"] = raises(lambda: fuse_frames_data_parallel(
        d8[:6], c8[:6], e8[:6], INTR, CFG, mesh))
    if rank < 2:
        out["data_pair"] = dense_out(fuse_frames_data_parallel(
            d8[:2], c8[:2], e8[:2], INTR, CFG, pair))
    else:
        out["outside_mesh"] = raises(lambda: fuse_frames_data_parallel(
            d8[:2], c8[:2], e8[:2], INTR, CFG, pair))
    out["two_d"] = dense_out(fuse_frames_2d_sharded(
        d8, c8, e8, INTR, CFG, mesh22))
    odd = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(63, 64, 64),
                     origin=CFG.origin)
    out["two_d_indivisible_x"] = raises(lambda: fuse_frames_2d_sharded(
        d8, c8, e8, INTR, odd, mesh22))
    out["two_d_indivisible_frames"] = raises(lambda: fuse_frames_2d_sharded(
        d8[:7], c8[:7], e8[:7], INTR, CFG, mesh22))
    out["hier_2x2"] = dense_out(fuse_frames_hierarchical(
        d8, c8, e8, INTR, CFG, hier22))
    out["hier_1x4"] = dense_out(fuse_frames_hierarchical(
        d8, c8, e8, INTR, CFG, hier14))
    out["hier_indivisible"] = raises(lambda: fuse_frames_hierarchical(
        d8[:6], c8[:6], e8[:6], INTR, CFG, hier22))
    out["objects"] = fuse_objects_parallel(od, oc, oe, oo, INTR, CFG, mesh)
    out["objects_indivisible"] = raises(lambda: fuse_objects_parallel(
        od[:3], oc[:3], oe[:3], oo[:3], INTR, CFG, mesh))
    out["chamfer"] = float(chamfer_data_parallel(inp["src"], inp["dst"],
                                                 mesh))
    out["chamfer_indivisible"] = raises(lambda: chamfer_data_parallel(
        inp["src"][:-1], inp["dst"], mesh))

    # the block-sparse path
    vol0 = make_block_volume(CFG, "cpu")
    out["auto_max_active"] = auto_max_active_sharded(
        vol0, torch.from_numpy(sd), torch.from_numpy(se), INTR, 4)
    out["sparse"] = block_out(fuse_frames_sparse_data_parallel(
        vol0, sd, sc, se, INTR, mesh))
    out["sparse_box"] = block_out(fuse_frames_sparse_data_parallel(
        make_block_volume(BOX, "cpu"), bd, bc, be, SMALL, mesh))
    out["sparse_box_cap"] = block_out(fuse_frames_sparse_data_parallel(
        make_block_volume(BOX, "cpu"), bd, bc, be, SMALL, mesh,
        max_active=inp["box_cap"]))
    half = integrate_frames_cuda(
        make_block_volume(CFG, "cpu"), torch.from_numpy(sd[:4]),
        torch.from_numpy(sc[:4]), torch.from_numpy(se[:4]), INTR)
    before = block_out(half)
    before = {k: v.clone() for k, v in before.items()}
    out["sparse_resumed"] = block_out(fuse_frames_sparse_data_parallel(
        half, sd[4:], sc[4:], se[4:], INTR, mesh))
    out["prior_untouched"] = all(torch.equal(before[k], v)
                                 for k, v in block_out(half).items())
    dirty = make_block_volume(CFG, "cpu")
    nb = dirty.num_blocks
    dirty.tsdf[nb], dirty.weight[nb], dirty.color[nb] = 0.5, 3.0, 7.0
    dirty.created[nb] = True
    out["sparse_dirty_dead_row"] = block_out(
        fuse_frames_sparse_data_parallel(dirty, sd, sc, se, INTR, mesh))
    out["sparse_indivisible"] = raises(
        lambda: fuse_frames_sparse_data_parallel(
            vol0, sd[:6], sc[:6], se[:6], INTR, mesh))
    objs = fuse_objects_sparse_parallel(od, oc, oe, oo, INTR, CFG, mesh)
    out["objects_sparse"] = objs
    out["objects_sparse_indivisible"] = raises(
        lambda: fuse_objects_sparse_parallel(
            od[:2], oc[:2], oe[:2], oo[:2], INTR, CFG, mesh))
    vols = [BlockTSDFVolume(objs[0][i], objs[1][i], objs[2][i], objs[3][i],
                            tuple(float(x) for x in oo[i]), vol0.voxel_size,
                            vol0.sdf_trunc, vol0.grid_blocks)
            for i in range(len(oo))]
    out["meshes"] = extract_meshes_sharded(vols, mesh, **MESH_CAPS)
    out["meshes_padded"] = extract_meshes_sharded(vols[:3], mesh,
                                                  **MESH_CAPS)

    ds = CaptureDataset(inp["dataset"], DS_CAM)
    draws = torch.from_numpy(inp["draws"])
    out["reconstruct_all"] = cloud_out(reconstruct_all_sharded(
        ds, DS_CFG, mesh, draws=draws))
    out["reconstruct_all_sparse"] = cloud_out(reconstruct_all_sharded_sparse(
        ds, DS_CFG, mesh, draws=draws))
    names, _, vols = fuse_all_sharded_sparse(ds, DS_CFG, mesh)
    out["reconstruct_all_sparse_volumes"] = {
        n: {**block_out(v), "origin": np.asarray(v.origin)}
        for n, v in zip(names, vols)}
    out["dryrun"] = dryrun_multichip(mesh)

    out = to_numpy(out)
    digests = {k: digest(v) for k, v in out.items()}
    return {"digests": digests,
            "out": out if rank == 0 else {k: out[k] for k in ("outside_mesh",)
                                          if k in out}}
