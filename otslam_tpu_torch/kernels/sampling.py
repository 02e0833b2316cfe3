"""Seeded uniform resampling of point sets (counterpart of
otslam_tpu/kernels/sampling.py).

Stands in for Open3D's ``mesh.sample_points_uniformly(n)`` used at the
reference's reconstruct_rgbd_filter.py:123: the zero-crossing surface
points are already ~uniform on the surface at voxel density.
"""

from __future__ import annotations

import torch


def resample_points(points: torch.Tensor, mask: torch.Tensor,
                    num_samples: int, colors: torch.Tensor | None = None,
                    normals: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    draws: torch.Tensor | None = None):
    """Uniformly sample ``num_samples`` valid rows (with replacement).

    Valid rows must be compacted to the front (row i valid iff i < count),
    as the extraction functions return them. The uniform [0, 1) draws come
    from `draws` (shape (num_samples,)) when given — e.g. the JAX package's
    ``jax.random.uniform(key, (num_samples,))``, which makes the chosen
    indices identical to its — else from `generator` on the points' device.
    Returns (points, colors or None, normals or None)."""
    count = torch.clamp(mask.to(torch.int64).sum(), min=1)
    if draws is None:
        u = torch.rand(num_samples, generator=generator,
                       device=points.device)
    else:
        if draws.shape != (num_samples,):
            raise ValueError(f"draws shape {tuple(draws.shape)} != "
                             f"({num_samples},)")
        u = draws.to(device=points.device, dtype=torch.float32)
    # f32 product then truncation, as (u * count).astype(int32) in JAX
    idx = torch.minimum((u * count.to(torch.float32)).to(torch.int64),
                        count - 1)
    return (points[idx],
            None if colors is None else colors[idx],
            None if normals is None else normals[idx])
