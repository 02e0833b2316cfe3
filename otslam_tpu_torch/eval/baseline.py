"""Dense-mapping baseline and map-size comparison (counterpart of
otslam_tpu/eval/baseline.py).

The reference's headline claim is a 99.0% map-data-size reduction vs
conventional dense 3D mapping (README.md:60; RTAB-Map is the dense baseline,
1.7 MB vs 169 MB: eval/result_plot.py:17-18). This module provides the
equivalent comparison natively:

* ``dense_room_reconstruction`` — a whole-room dense TSDF map from a
  trajectory of frames (what RTAB-Map-style mapping stores), the baseline
  for accuracy/completeness and size; the fusion and extraction run on
  the device.
* ``hybrid_map_size_stats`` — byte sizes of a selective hybrid map
  (2D PGM + per-object PLYs) vs a dense map PLY, and the reduction ratio.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import torch

from otslam_tpu_torch.config import ReconstructionConfig, TSDFConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.kernels.sampling import resample_points
from otslam_tpu_torch.kernels.tsdf import extract_surface_points
from otslam_tpu_torch.pipeline.reconstruct import fuse_frames

# the active blocks fused per frame, as the JAX package's baseline caps them
DENSE_MAX_ACTIVE = 8192


def dense_volume_config(room_bounds, voxel_size: float,
                        sdf_trunc: float) -> TSDFConfig:
    """The dense baseline's volume: room_bounds (xmin, xmax, ymin, ymax,
    zmin, zmax) at `voxel_size`, each side rounded up to whole 8-voxel
    blocks."""
    xmin, xmax, ymin, ymax, zmin, zmax = room_bounds

    def rnd8(v):
        return int(-(-v // 8)) * 8

    dims = (rnd8((xmax - xmin) / voxel_size), rnd8((ymax - ymin) / voxel_size),
            rnd8((zmax - zmin) / voxel_size))
    return TSDFConfig(voxel_size=voxel_size, sdf_trunc=sdf_trunc, dims=dims,
                      origin=(xmin, ymin, zmin))


def dense_room_reconstruction(depths, colors, extrinsics,
                              intr: PinholeIntrinsics,
                              room_bounds, voxel_size: float = 0.02,
                              sdf_trunc: float = 0.08,
                              samples: int = 500_000,
                              backend: str = "sparse", seed: int = 0,
                              draws: torch.Tensor | None = None,
                              device="cuda"):
    """Dense whole-room reconstruction (the conventional-mapping baseline)
    on `device`.

    depths (N,H,W) meters, colors (N,H,W,3) [0,255], extrinsics (N,4,4)
    world->camera, as arrays or tensors. room_bounds: (xmin, xmax, ymin,
    ymax, zmin, zmax). The sample draws come from a torch.Generator seeded
    with `seed`, or from `draws` ((samples,) uniform [0, 1)). Returns
    (points, colors) (samples, 3) float32 tensors on `device`.
    """
    dev = resolve_device(device)
    cfg = ReconstructionConfig(
        tsdf=dense_volume_config(room_bounds, voxel_size, sdf_trunc),
        surface_samples=samples)
    vol = fuse_frames(depths, colors, extrinsics, intr, cfg, backend,
                      max_active=DENSE_MAX_ACTIVE, device=dev)
    pts, cols, mask = extract_surface_points(vol, capacity=4_000_000)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_pts, s_cols, _ = resample_points(pts, mask, samples, colors=cols,
                                       generator=gen, draws=draws)
    return s_pts, s_cols


@dataclass
class MapSizeStats:
    hybrid_bytes: int
    dense_bytes: int
    reduction_percent: float
    breakdown: dict


def hybrid_map_size_stats(map_pgm_path: str, object_dir: str,
                          dense_map_path: str) -> MapSizeStats:
    """Selective hybrid map (2D PGM + object PLYs) vs a dense map file."""
    pgm = os.path.getsize(map_pgm_path)
    objs = {os.path.basename(f): os.path.getsize(f)
            for f in glob.glob(os.path.join(object_dir, "*.ply"))}
    hybrid = pgm + sum(objs.values())
    dense = os.path.getsize(dense_map_path)
    reduction = 100.0 * (1.0 - hybrid / dense) if dense > 0 else 0.0
    return MapSizeStats(hybrid, dense, reduction,
                        {"pgm": pgm, "objects": objs})
