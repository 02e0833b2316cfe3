"""Virtual scan generation: what the saved 2D map *should* look like
(counterpart of otslam_tpu/mapping/virtual_scan.py).

Equivalent of the virtual_scan_node (virtual_scan_node.cpp:176-298): given a
latched occupancy map and the robot's map-frame pose, synthesize a LaserScan
by ray casting (kernel K5 on the card), copying the template scan's angular
configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from otslam_tpu_torch.config import LidarConfig
from otslam_tpu_torch.core.grid import OccupancyGrid2D
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.kernels.raycast import raycast_grid_fast


class VirtualScanner:
    """Owner of the latched map (the 'map_callback' state). The map lives
    on `device` as an int8 tensor, uploaded once per set_map."""

    def __init__(self, lidar: LidarConfig | None = None, device="cuda"):
        self.lidar = lidar or LidarConfig()
        self.device = resolve_device(device)
        self._map: OccupancyGrid2D | None = None
        self._grid: torch.Tensor | None = None
        self._angles: torch.Tensor | None = None

    def set_map(self, grid: OccupancyGrid2D) -> None:
        """Latched /virtual_map subscription equivalent."""
        self._map = grid
        self._grid = torch.as_tensor(np.asarray(grid._host_data(), np.int8),
                                     device=self.device).contiguous()

    @property
    def has_map(self) -> bool:
        return self._map is not None

    @property
    def grid(self) -> torch.Tensor:
        """The latched map as an (H, W) int8 tensor on the device."""
        if self._grid is None:
            raise RuntimeError("no map latched; call set_map first")
        return self._grid

    def angles(self) -> torch.Tensor:
        """(num_beams,) f32 beam angles on the device: float64
        angle_min + arange(n) * inc, then cast to f32, as the JAX package."""
        if self._angles is None:
            n = self.lidar.num_beams
            inc = (self.lidar.angle_max - self.lidar.angle_min) / n
            self._angles = torch.as_tensor(
                (self.lidar.angle_min + np.arange(n) * inc).astype(np.float32),
                device=self.device)
        return self._angles

    def scan(self, robot_x: float, robot_y: float,
             robot_yaw: float) -> torch.Tensor:
        """Ranges (num_beams,) f32 on the device, +inf = no hit. Requires a
        latched map. One K5 launch on the card."""
        if self._map is None:
            raise RuntimeError("no map latched; call set_map first")
        g = self._map
        return raycast_grid_fast(
            self.grid, float(g.resolution), float(g.origin[0]),
            float(g.origin[1]), float(robot_x), float(robot_y),
            float(robot_yaw), self.angles(), float(self.lidar.range_max))
