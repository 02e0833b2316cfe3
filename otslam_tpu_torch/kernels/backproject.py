"""RGB-D back-projection and depth filtering (counterpart of
otslam_tpu/kernels/backproject.py).

Reference behavior being reproduced (not translated):
  * Open3D ``RGBDImage.create_from_color_and_depth(depth_scale=1000, depth_trunc,
    convert_rgb_to_intensity=False)`` — depth/1000, returns > trunc zeroed
    (reconstruct_rgbd.py:99-104).
  * Open3D ``PointCloud.create_from_rgbd_image`` — pinhole back-projection
    (check_one_frame.py:22-30).
  * scanner_node capture clipping — NaN -> 0, > 5 m -> 0 (scanner_node.cpp:277-281).

Whole-image elementwise tensor ops: the (H, W, 3) ray grid comes from the
intrinsics and the per-frame work is one multiply.
"""

from __future__ import annotations

import numpy as np
import torch

from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.core.pointcloud import PointCloud
from otslam_tpu_torch.device import resolve_device, to_f32
from otslam_tpu_torch.kernels.tsdf import recip32


def filter_depth(depth_m: torch.Tensor, depth_trunc: float = 3.0
                 ) -> torch.Tensor:
    """Zero out invalid returns: NaN/inf, non-positive, beyond depth_trunc."""
    d = torch.nan_to_num(depth_m, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.where((d > 0.0) & (d <= depth_trunc), d, 0.0)


def backproject_depth(depth_m: torch.Tensor, rays: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """depth (H, W) x rays (H, W, 3) -> points (H, W, 3), valid (H, W)."""
    return depth_m[..., None] * rays, depth_m > 0.0


def backproject_pointcloud(depth_m, color_rgb, intr: PinholeIntrinsics,
                           depth_trunc: float = 3.0, extrinsic_inv=None,
                           device="cuda") -> PointCloud:
    """One RGB-D frame -> padded camera-frame (or world-frame) point cloud
    on `device`.

    depth_m: (H, W) meters, array or tensor. color_rgb: (H, W, 3) uint8
    (scaled by 1/255) or float [0,1], array or tensor, or None.
    extrinsic_inv: optional camera->world 4x4 that places the points in
    the world frame.
    """
    dev = resolve_device(device)
    d = filter_depth(to_f32(depth_m, dev), depth_trunc)
    pts, valid = backproject_depth(d, intr.pixel_rays(dev))
    pts = pts.reshape(-1, 3)
    cols = None
    if color_rgb is not None:
        cols = (color_rgb.to(dev) if isinstance(color_rgb, torch.Tensor)
                else torch.as_tensor(np.asarray(color_rgb), device=dev))
        cols = cols.reshape(-1, 3)
        if cols.dtype == torch.uint8:
            cols = cols.to(torch.float32) * recip32(255.0)
    if extrinsic_inv is not None:
        E = to_f32(extrinsic_inv, dev)
        pts = pts @ E[:3, :3].T + E[:3, 3]
    return PointCloud(pts, cols, valid.reshape(-1))
