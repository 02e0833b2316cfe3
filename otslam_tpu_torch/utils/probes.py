"""Stage-isolating debug probes.

Equivalents of the reference's single-purpose sanity scripts (SURVEY.md §4.2):
depth_scale.py (format probe), depth_visual.py (inverse-depth heat image),
visualize_trajectory.py (camera frame markers per pose).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from otslam_tpu_torch.core.se3 import T_FIX_OPTICAL


def depth_stats(depth: np.ndarray) -> dict:
    """dtype/min/max/validity summary of a depth image (depth_scale.py)."""
    d = np.asarray(depth)
    finite = d[np.isfinite(d)]
    valid = finite[finite > 0]
    return {
        "dtype": str(d.dtype),
        "shape": tuple(d.shape),
        "min": float(finite.min()) if finite.size else None,
        "max": float(finite.max()) if finite.size else None,
        "valid_fraction": float((d > 0).mean()),
    }


def depth_heat_image(depth_m: np.ndarray, d_min: float = 0.0,
                     d_max: float = 5.0) -> np.ndarray:
    """mm-or-m depth -> uint8 inverse-depth heat image (depth_visual.py:15-33):
    nearer = brighter, invalid = 0."""
    d = np.asarray(depth_m, np.float32)
    if d.max() > 100.0:  # looks like millimeters
        d = d / 1000.0
    valid = (d > d_min) & (d < d_max) & np.isfinite(d)
    inv = np.zeros_like(d)
    inv[valid] = 1.0 / d[valid]
    hi = inv.max() if inv.max() > 0 else 1.0
    return np.clip(inv / hi * 255.0, 0, 255).astype(np.uint8)


def trajectory_frames(poses: Sequence[np.ndarray], t_fix: np.ndarray = T_FIX_OPTICAL,
                      axis_length: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """Camera coordinate-frame markers per pose (visualize_trajectory.py:28-43).

    Returns (points (N*4, 3), colors (N*4, 3)): per pose its origin (white)
    plus the tips of its x (red) / y (green) / z (blue) axes after t_fix.
    """
    pts, cols = [], []
    palette = np.array([[1, 1, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    for pose in poses:
        T = np.asarray(pose) @ t_fix
        o = T[:3, 3]
        pts.append(o)
        for a in range(3):
            pts.append(o + T[:3, a] * axis_length)
        cols.extend(palette)
    return np.asarray(pts, np.float32), np.asarray(cols, np.float32)
