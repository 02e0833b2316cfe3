"""Multi-device dry run: every sharded path against its serial result on
tiny shapes (counterpart of the JAX package's `dryrun_multichip`).

    python -m otslam_tpu_torch.distributed.dryrun --ranks 4 --device cpu

runs `dryrun_multichip` on 4 gloo ranks on the CPU (`--device cuda` puts
every rank's kernels on the card, the ranks sharing it through gloo). Each
check holds a sharded result to the serial one on the same inputs: weights
exact, tsdf <= 1e-4, sparse colour <= 1e-3, extraction masks and vertices
bit-identical, chamfer within 1e-5 + 1e-5 |want|. Every rank runs every
check and raises on the first failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.distributed.comm import mesh_device
from otslam_tpu_torch.distributed.mesh import make_mesh
from otslam_tpu_torch.distributed.sharding import (
    chamfer_data_parallel, fuse_frames_2d_sharded, fuse_frames_data_parallel,
    fuse_frames_hierarchical, fuse_objects_parallel)
from otslam_tpu_torch.distributed.sparse import (
    auto_max_active_sharded, extract_meshes_sharded,
    fuse_frames_sparse_data_parallel, fuse_objects_sparse_parallel)
from otslam_tpu_torch.kernels.marching import extract_mesh_soup_block
from otslam_tpu_torch.kernels.nn import nn_distance
from otslam_tpu_torch.kernels.tsdf import integrate_frames, make_volume
from otslam_tpu_torch.kernels.tsdf_block import (
    BlockTSDFVolume, make_block_volume)
from otslam_tpu_torch.kernels.tsdf_cuda import integrate_frames_cuda


def dryrun_multichip(mesh: DeviceMesh) -> dict:
    """Run every sharded path on the 1-D mesh's n ranks (2-D meshes of
    (n/2, 2) when n >= 4 is even) against its serial result; returns
    {"deltas": {check: max abs delta}, "weight_sum", "sparse_weight_sum",
    "triangles", "chamfer"}. Raises RuntimeError on the first check that
    breaks its tolerance."""
    n = mesh.mesh.numel()
    dev = mesh_device(mesh)
    intr = PinholeIntrinsics(width=64, height=48, fx=56.0, fy=56.0,
                             cx=32.0, cy=24.0)
    cfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 64),
                     origin=(-0.64, -0.64, -0.64))
    n_frames = max(2 * n, 8)
    rng = np.random.default_rng(0)
    depths = torch.as_tensor(rng.uniform(0.4, 1.0, (n_frames, 48, 64))
                             .astype(np.float32), device=dev)
    colors = torch.full((n_frames, 48, 64, 3), 100.0, device=dev)
    extrinsics = torch.eye(4, device=dev).repeat(n_frames, 1, 1)
    deltas: dict[str, float] = {}

    def check(name, got, ref, atol):
        d = float(torch.max(torch.abs(got.float() - ref.float())))
        deltas[name] = d
        if not d <= atol:
            raise RuntimeError(f"{name}: sharded-vs-serial max delta {d} > "
                               f"{atol}")

    ref_dense = integrate_frames(make_volume(cfg, dev), depths, colors,
                                 extrinsics, intr)
    two_d = n >= 4 and n % 2 == 0
    if two_d:
        # frames over 'data', voxel-grid slabs over 'model'
        mesh2 = make_mesh((n // 2, 2), ("data", "model"), mesh.device_type)
        vol = fuse_frames_2d_sharded(depths, colors, extrinsics, intr, cfg,
                                     mesh2)
    else:
        vol = fuse_frames_data_parallel(depths, colors, extrinsics, intr,
                                        cfg, mesh)
    if not float(vol.weight.sum()) > 0:
        raise RuntimeError("sharded fusion produced no updates")
    check("dense_w", vol.weight, ref_dense.weight, 0.0)
    check("dense_tsdf", vol.tsdf, ref_dense.tsdf, 1e-4)
    if two_d:
        # 2-level (dcn, ici) mesh: hierarchical reduce, ici first
        mesh_h = make_mesh((n // 2, 2), ("dcn", "ici"), mesh.device_type)
        vol_h = fuse_frames_hierarchical(depths, colors, extrinsics, intr,
                                         cfg, mesh_h)
        check("hier_tsdf", vol_h.tsdf, ref_dense.tsdf, 1e-4)

    # object axis: one object per rank, no collectives while fusing
    depths_o = torch.stack([depths[:2] + 0.01 * o for o in range(n)])
    colors_o = torch.stack([colors[:2]] * n)
    exts_o = torch.stack([extrinsics[:2]] * n)
    origins = torch.tensor([[-0.64 + 0.05 * o, -0.64, -0.64]
                            for o in range(n)], device=dev)
    t_o, w_o, _ = fuse_objects_parallel(depths_o, colors_o, exts_o, origins,
                                        intr, cfg, mesh)
    for o in (0, n - 1):
        cfg_o = dataclasses.replace(
            cfg, origin=tuple(float(x) for x in origins[o].tolist()))
        ref_o = integrate_frames(make_volume(cfg_o, dev), depths_o[o],
                                 colors_o[o], exts_o[o], intr)
        check(f"obj{o}_w", w_o[o], ref_o.weight, 0.0)
        check(f"obj{o}_tsdf", t_o[o], ref_o.tsdf, 1e-4)

    # the block-sparse path, frame-sharded with the creation prefix
    vol0 = make_block_volume(cfg, dev)
    ma = auto_max_active_sharded(vol0, depths, extrinsics, intr, n)
    vol_s = fuse_frames_sparse_data_parallel(vol0, depths, colors,
                                             extrinsics, intr, mesh,
                                             max_active=ma)
    ws_sparse = float(vol_s.weight.sum())
    if not ws_sparse > 0:
        raise RuntimeError("sharded sparse fusion produced no updates")
    ref_sparse = integrate_frames_cuda(make_block_volume(cfg, dev), depths,
                                       colors, extrinsics, intr,
                                       max_active=ma)
    check("sparse_w", vol_s.weight, ref_sparse.weight, 0.0)
    check("sparse_tsdf", vol_s.tsdf, ref_sparse.tsdf, 1e-4)
    check("sparse_color", vol_s.color, ref_sparse.color, 1e-3)

    # object-sharded sparse fusion of the same object batch
    t_os, w_os, c_os, cr_os = fuse_objects_sparse_parallel(
        depths_o, colors_o, exts_o, origins, intr, cfg, mesh, max_active=ma)
    cfg_s0 = dataclasses.replace(
        cfg, origin=tuple(float(x) for x in origins[0].tolist()))
    ref_s0 = integrate_frames_cuda(make_block_volume(cfg_s0, dev),
                                   depths_o[0], colors_o[0], exts_o[0],
                                   intr, max_active=ma)
    check("sobj_w", w_os[0], ref_s0.weight, 0.0)
    check("sobj_tsdf", t_os[0], ref_s0.tsdf, 1e-4)

    # sharded mesh extraction of those per-object volumes
    vols_o = [BlockTSDFVolume(t_os[i], w_os[i], c_os[i], cr_os[i],
                              tuple(float(x) for x in origins[i].tolist()),
                              vol0.voxel_size, vol0.sdf_trunc,
                              vol0.grid_blocks)
              for i in range(n)]
    verts_sh, _, tri_masks = extract_meshes_sharded(
        vols_o, mesh, max_blocks=256, max_cells=4096)
    n_tris = int(tri_masks.sum())
    if not n_tris > 0:
        raise RuntimeError("sharded extraction produced no triangles")
    v_ref, _, m_ref = extract_mesh_soup_block(vols_o[0], 256, 4096)
    check("extract_mask", tri_masks[0], m_ref, 0.0)
    check("extract_verts",
          torch.where(tri_masks[0][:, None], verts_sh[0], 0.0),
          torch.where(m_ref[:, None], v_ref, 0.0), 0.0)

    # the sharded eval reduce (mean nearest-neighbour distance)
    src = torch.as_tensor(rng.standard_normal((128 * n, 3))
                          .astype(np.float32), device=dev)
    dst = torch.as_tensor(rng.standard_normal((256, 3)).astype(np.float32),
                          device=dev)
    d = float(chamfer_data_parallel(src, dst, mesh))
    want = float(torch.mean(nn_distance(src, dst)))
    deltas["chamfer"] = abs(d - want)
    if not abs(d - want) <= 1e-5 + 1e-5 * abs(want):
        raise RuntimeError(f"chamfer: sharded {d} vs serial {want}")
    return {"deltas": deltas, "weight_sum": float(vol.weight.sum()),
            "sparse_weight_sum": ws_sparse, "triangles": n_tris,
            "chamfer": d}


def _dryrun_rank(device_type: str) -> dict:
    return dryrun_multichip(make_mesh(None, ("data",), device_type))


def main(argv=None) -> int:
    from otslam_tpu_torch.distributed.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    results = run_ranks(_dryrun_rank, (args.device,), world=args.ranks,
                        timeout=args.timeout)
    print(json.dumps({"ranks": args.ranks, "device": args.device,
                      **results[0]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
