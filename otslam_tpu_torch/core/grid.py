"""2D occupancy grid type and world<->grid coordinate conventions
(counterpart of otslam_tpu/core/grid.py).

Two pixel conventions exist in the reference and both are preserved:

* ROS OccupancyGrid (row 0 = bottom): cell value 100 = occupied, 0 = free,
  -1 = unknown; world_x = origin_x + col * resolution (virtual_scan_node.cpp:274-281).
* PGM image (row 0 = top, slam_toolbox export): pixel < 100 = occupied,
  205 +/- 5 = unknown; world_y = origin_y + (height - 1 - row) * resolution
  (hybrid_map.py:50-55).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass
class OccupancyGrid2D:
    """ROS-convention occupancy grid: data[row, col], row 0 at origin
    (bottom). data: (H, W) int8 numpy array or tensor — 100 occupied,
    0 free, -1 unknown."""

    data: np.ndarray | torch.Tensor
    resolution: float
    origin: Tuple[float, float]  # world coords of cell (0, 0) corner

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    def _host_data(self) -> np.ndarray:
        if isinstance(self.data, torch.Tensor):
            return self.data.cpu().numpy()
        return np.asarray(self.data)

    def world_to_cell(self, xy):
        """World (..., 2) -> integer (col, row) int32 tensors, truncating
        like the reference's `(int)((x - ox) / res)`
        (virtual_scan_node.cpp:274-275)."""
        xy = torch.as_tensor(xy)
        res = torch.tensor(self.resolution, dtype=xy.dtype, device=xy.device)
        gx = torch.floor((xy[..., 0] - self.origin[0]) / res).to(torch.int32)
        gy = torch.floor((xy[..., 1] - self.origin[1]) / res).to(torch.int32)
        return gx, gy

    def in_bounds(self, gx, gy):
        return (gx >= 0) & (gx < self.width) & (gy >= 0) & (gy < self.height)

    @classmethod
    def from_pgm(cls, img: np.ndarray, resolution: float,
                 origin: Tuple[float, float], occupied_threshold: int = 100,
                 unknown_value: int = 205,
                 unknown_band: int = 5) -> "OccupancyGrid2D":
        """PGM image (row 0 = top) -> ROS occupancy grid (row 0 = bottom),
        holding a numpy array."""
        flipped = np.asarray(img)[::-1]  # row 0 now bottom
        occ = flipped < occupied_threshold
        unknown = ((flipped >= unknown_value - unknown_band)
                   & (flipped <= unknown_value + unknown_band))
        data = np.zeros(flipped.shape, dtype=np.int8)
        data[occ] = 100
        data[unknown] = -1
        return cls(data, float(resolution),
                   (float(origin[0]), float(origin[1])))

    def to_pgm(self, unknown_value: int = 205) -> np.ndarray:
        """ROS occupancy grid -> PGM image (row 0 = top)."""
        data = self._host_data()
        img = np.full(data.shape, 254, dtype=np.uint8)  # free = near-white
        img[data == 100] = 0
        img[data == -1] = unknown_value
        return img[::-1]

    def occupied_world_points(self) -> np.ndarray:
        """World (x, y) of occupied cell origins following
        hybrid_map.py:50-55: wx = ox + col*res, wy = oy + row*res."""
        rows, cols = np.nonzero(self._host_data() == 100)
        wx = self.origin[0] + cols * self.resolution
        wy = self.origin[1] + rows * self.resolution
        return np.stack([wx, wy], axis=-1)
