"""Voxel-grid downsampling, Open3D ``voxel_down_sample`` semantics
(counterpart of otslam_tpu/kernels/voxel.py).

Reference usage: check_one_frame.py:28 (0.01 m). Open3D buckets points by
``floor((p - min_bound) / voxel)`` and emits the centroid (and mean color) of
each occupied voxel.

Points are keyed by one int64 voxel key, stably sorted by it, segment
boundaries found by key inequality, and per-voxel means summed with
``index_add_``. The output is padded to the input size N: (N, 3) + the
mask of the unique voxels, in ascending key order (x, then y, then z).
"""

from __future__ import annotations

import torch

# bits of each voxel coordinate in the key: 2^21 cells an axis (21 km at
# 1 cm) from the min bound
_AXIS_BITS = 21


def voxel_downsample(points: torch.Tensor, voxel_size: float,
                     mask: torch.Tensor | None = None,
                     colors: torch.Tensor | None = None):
    """Downsample a padded point cloud onto a voxel grid.

    Args:
      points: (N, 3) float32.
      voxel_size: scalar voxel edge.
      mask: (N,) bool validity; None = all valid.
      colors: optional (N, 3) float32 averaged alongside.

    Returns:
      (ds_points, ds_colors_or_None, ds_mask): (N, 3), (N, 3)?, (N,) padded.
    """
    n = points.shape[0]
    dev = points.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask = mask & torch.isfinite(points).all(dim=-1)

    # min bound over valid points only
    min_bound = torch.where(mask[:, None], points, 3.0e38).amin(dim=0)
    # a tensor divisor: a true division, as the JAX graph's traced one
    idx3 = torch.floor((points - min_bound)
                       / torch.full_like(points, voxel_size))
    idx3 = torch.where(mask[:, None], idx3, 0.0).to(torch.int64)
    key = ((idx3[:, 0] << (2 * _AXIS_BITS)) | (idx3[:, 1] << _AXIS_BITS)
           | idx3[:, 2])
    key = torch.where(mask, key, torch.iinfo(torch.int64).max)  # invalid last

    order = torch.argsort(key, stable=True)
    key_s = key[order]
    pts_s = points[order]
    mask_s = mask[order]

    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = key_s[1:] != key_s[:-1]
    head &= mask_s
    seg = torch.cumsum(head.to(torch.int64), dim=0) - 1   # segment per point
    seg = torch.where(mask_s, seg, n - 1)                 # invalid: last bucket

    ones = mask_s.to(torch.float32)
    counts = torch.zeros(n, device=dev).index_add_(0, seg, ones)
    sums = torch.zeros((n, 3), device=dev).index_add_(
        0, seg, pts_s * ones[:, None])
    denom = torch.clamp(counts, min=1.0)[:, None]
    ds_pts = sums / denom

    out_mask = torch.arange(n, device=dev) < head.sum()

    ds_cols = None
    if colors is not None:
        csums = torch.zeros((n, 3), device=dev).index_add_(
            0, seg, colors[order] * ones[:, None])
        ds_cols = csums / denom
    return ds_pts, ds_cols, out_mask
