"""Fixed-capacity point cloud container (counterpart of
otslam_tpu/core/pointcloud.py).

Clouds are (capacity, 3) tensors plus a validity mask: `count` is the number
of valid points and invalid rows are padding. Host-side helpers compact to
dense numpy for IO.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from otslam_tpu_torch.device import resolve_device


@dataclass
class PointCloud:
    """Padded point cloud: points (N,3) f32, colors (N,3) f32 in [0,1],
    mask (N,) bool, all on one device."""

    points: torch.Tensor
    colors: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def valid_mask(self) -> torch.Tensor:
        if self.mask is None:
            return torch.ones(self.points.shape[0], dtype=torch.bool,
                              device=self.points.device)
        return self.mask

    def count(self) -> torch.Tensor:
        return self.valid_mask().sum()

    @classmethod
    def from_numpy(cls, points: np.ndarray, colors: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None,
                   device="cuda") -> "PointCloud":
        dev = resolve_device(device)
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        n = points.shape[0]
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        pts = np.zeros((cap, 3), dtype=np.float32)
        pts[:n] = points
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True
        cols = None
        if colors is not None:
            colors = np.asarray(colors, dtype=np.float32).reshape(-1, 3)
            cols = np.zeros((cap, 3), dtype=np.float32)
            cols[: colors.shape[0]] = colors
            cols = torch.as_tensor(cols, device=dev)
        return cls(torch.as_tensor(pts, device=dev), cols,
                   torch.as_tensor(mask, device=dev))

    def to_numpy(self) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Compact to dense (n,3) arrays of the valid points (host transfer)."""
        mask = self.valid_mask().cpu().numpy()
        pts = self.points.cpu().numpy()[mask]
        cols = (None if self.colors is None
                else self.colors.cpu().numpy()[mask])
        return pts, cols

    def transformed(self, T) -> "PointCloud":
        T = torch.as_tensor(np.asarray(T), dtype=self.points.dtype,
                            device=self.points.device)
        return PointCloud(self.points @ T[:3, :3].T + T[:3, 3], self.colors,
                          self.mask)

    def painted(self, rgb) -> "PointCloud":
        col = torch.as_tensor(rgb, dtype=torch.float32,
                              device=self.points.device)
        return PointCloud(self.points, col.expand(self.points.shape),
                          self.mask)


def concatenate(clouds: list[PointCloud]) -> PointCloud:
    """Concatenate padded clouds (capacity = sum of capacities)."""
    pts = torch.cat([c.points for c in clouds])
    masks = torch.cat([c.valid_mask() for c in clouds])
    cols = None
    if all(c.colors is not None for c in clouds):
        cols = torch.cat([c.colors for c in clouds])
    return PointCloud(pts, cols, masks)
