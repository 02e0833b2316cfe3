"""2D scan-to-map localization (counterpart of
otslam_tpu/mapping/localize.py).

The reference obtains map-frame poses from slam_toolbox's TF. Here a LiDAR
scan registers against the occupancy map's occupied cells with
point-to-point ICP on the windowed correspondence search (kernel K4 on
CUDA), refining an odometry prior into a map-frame pose. Scan returns and
map cell centers embed at z = 0; the solved transform projects back to
(x, y, yaw).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otslam_tpu_torch.core.grid import OccupancyGrid2D
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.kernels.icp import icp_point_to_point
from otslam_tpu_torch.kernels.nn import auto_nn_window, nn_window_bounds


@dataclass
class LocalizationResult:
    x: float
    y: float
    yaw: float
    fitness: float
    inlier_rmse: float


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class ScanLocalizer:
    def __init__(self, grid: OccupancyGrid2D, max_map_points: int = 20000,
                 threshold: float = 0.3, max_correction: float = 1.0,
                 max_yaw_correction: float = 0.5, device="cuda"):
        self.device = resolve_device(device)
        # occupied_world_points returns cell origins; registration wants
        # cell centers
        pts2 = grid.occupied_world_points() + grid.resolution / 2.0
        if len(pts2) > max_map_points:
            sel = np.random.default_rng(0).choice(len(pts2), max_map_points,
                                                  replace=False)
            pts2 = pts2[sel]
        self._map_np = np.concatenate(
            [pts2, np.zeros((len(pts2), 1))], -1).astype(np.float32)
        self._map3 = torch.as_tensor(self._map_np, device=self.device)
        # the dst side of the window sizing is map-invariant: computed once
        self._map_bounds = (nn_window_bounds(self._map_np)
                            if len(self._map_np) else None)
        self.threshold = threshold
        # a correction larger than this is a wrong-basin fit by
        # construction, and the prior is returned instead
        self.max_correction = max_correction
        self.max_yaw_correction = max_yaw_correction

    def localize(self, ranges, angles, prior_pose,
                 max_iterations: int = 20) -> LocalizationResult:
        """Refine (x, y, yaw) so the scan aligns with the map.

        prior_pose: odometry estimate (x, y, yaw); the scan moves into the
        map frame with it and ICP solves the residual correction. An empty
        map or a scan with no finite return yields the prior unchanged at
        fitness 0 (never an exception)."""
        r = _host(ranges)
        a = _host(angles)
        ok = np.isfinite(r) & (r > 0)
        x0, y0, yaw0 = (float(v) for v in prior_pose)
        if self._map_bounds is None or not ok.any():
            return LocalizationResult(x0, y0, yaw0, 0.0, float("inf"))
        c, s = np.cos(yaw0), np.sin(yaw0)
        lx = np.where(ok, r, 0.0) * np.cos(a)
        ly = np.where(ok, r, 0.0) * np.sin(a)
        wx = x0 + lx * c - ly * s
        wy = y0 + lx * s + ly * c
        src = np.stack([wx, wy, np.zeros_like(wx)], -1).astype(np.float32)
        # invalid beams keep their (masked) slot, parked at a valid
        # return's position so they never widen a tile's window
        src[~ok] = src[int(np.argmax(ok))]
        nn_w, nn_ax = auto_nn_window(src, self._map_np, self.threshold,
                                     round_to=4, dst_bounds=self._map_bounds)
        res = icp_point_to_point(
            torch.as_tensor(src, device=self.device), self._map3,
            threshold=self.threshold,
            src_mask=torch.as_tensor(ok, device=self.device),
            max_iterations=max_iterations, nn_window=nn_w, nn_axis=nn_ax)
        T = res.transformation.cpu().numpy()
        dyaw = float(np.arctan2(T[1, 0], T[0, 0]))
        # corrected pose: T acts on map-frame points
        cx, sx = np.cos(dyaw), np.sin(dyaw)
        nx = T[0, 3] + cx * x0 - sx * y0
        ny = T[1, 3] + sx * x0 + cx * y0
        if (not np.isfinite([nx, ny, dyaw]).all()
                or np.hypot(nx - x0, ny - y0) > self.max_correction
                or abs(dyaw) > self.max_yaw_correction):
            # wrong-basin / degenerate fit: keep the odometry prior
            return LocalizationResult(x0, y0, yaw0, 0.0, float("inf"))
        return LocalizationResult(float(nx), float(ny), yaw0 + dyaw,
                                  float(res.fitness), float(res.inlier_rmse))
