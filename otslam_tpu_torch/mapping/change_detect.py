"""Scan-diff change detection with temporal evidence grids (counterpart of
otslam_tpu/mapping/change_detect.py).

Equivalent of the diff_node (diff_node.cpp:25-242): compares each real scan
against the latest virtual scan, accumulates NEW/REMOVED evidence in two
dwell/decay grids, and emits confident cell centres as the added/removed
object clouds. The grids live on the device; the class carries them and the
last-update clock (like the node's members).
"""

from __future__ import annotations

import numpy as np
import torch

from otslam_tpu_torch.config import ChangeDetectConfig, LidarConfig
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.kernels.evidence import (evidence_points, scatter_hits,
                                               update_evidence)
from otslam_tpu_torch.kernels.scan_diff import scan_diff


def scan_hits(grid_ref: torch.Tensor, real: torch.Tensor,
              virt: torch.Tensor, angles: torch.Tensor,
              robot_pose: torch.Tensor, cfg: ChangeDetectConfig,
              range_max: float):
    """(new_hits, gone_hits) boolean grids of one scan diff: the NEW real
    returns and the REMOVED virtual returns, moved into the map frame by
    the planar pose (diff_node.cpp:223-234). Scans are (B,) with a (3,)
    pose, or (K, B) with (K, 3) poses (grids (K, GH, GW))."""
    new_mask, removed_mask = scan_diff(
        real, virt, angles, range_max, cfg.distance_threshold,
        cfg.search_window)
    x0 = robot_pose[..., 0:1]
    y0 = robot_pose[..., 1:2]
    yaw = robot_pose[..., 2:3]
    c, s = torch.cos(yaw), torch.sin(yaw)

    def to_map(r):
        lx = r * torch.cos(angles)
        ly = r * torch.sin(angles)
        return x0 + lx * c - ly * s, y0 + lx * s + ly * c

    rx, ry = to_map(torch.nan_to_num(real, posinf=0.0))
    vx, vy = to_map(torch.nan_to_num(virt, posinf=0.0))
    res = cfg.grid_resolution
    return (scatter_hits(grid_ref, rx, ry, new_mask, res),
            scatter_hits(grid_ref, vx, vy, removed_mask, res))


def _step(new_grid: torch.Tensor, gone_grid: torch.Tensor,
          real: torch.Tensor, virt: torch.Tensor, angles: torch.Tensor,
          robot_pose: torch.Tensor, dt: torch.Tensor,
          cfg: ChangeDetectConfig, range_max: float):
    """One change-detection update: scan diff, map-frame hits, and both
    dwell grids' update. Returns the new (new_grid, gone_grid)."""
    new_hits, gone_hits = scan_hits(new_grid, real, virt, angles,
                                    robot_pose, cfg, range_max)
    new_grid = update_evidence(new_grid, new_hits, dt, cfg.time_threshold,
                               cfg.decay_rate)
    gone_grid = update_evidence(gone_grid, gone_hits, dt, cfg.time_threshold,
                                cfg.decay_rate)
    return new_grid, gone_grid


class ChangeDetector:
    """Host-side state machine (one instance per robot); the grids are
    device tensors."""

    def __init__(self, cfg: ChangeDetectConfig | None = None,
                 lidar: LidarConfig | None = None, device="cuda"):
        self.cfg = cfg or ChangeDetectConfig()
        self.lidar = lidar or LidarConfig()
        self.device = resolve_device(device)
        gh, gw = self.cfg.grid_cells
        self.new_grid = torch.zeros((gh, gw), dtype=torch.float32,
                                    device=self.device)
        self.gone_grid = torch.zeros_like(self.new_grid)
        self._last_time: float | None = None
        self._last_virtual: torch.Tensor | None = None

    def on_virtual_scan(self, ranges: torch.Tensor) -> None:
        self._last_virtual = ranges

    def on_scan(self, ranges: torch.Tensor, angles: torch.Tensor,
                robot_pose, now: float) -> None:
        """Process one real scan. robot_pose = (x, y, yaw) in the map frame.

        Mirrors the node's guards: no-op without a virtual scan or on beam
        count mismatch (diff_node.cpp:83-86).
        """
        if self._last_virtual is None:
            return
        if self._last_virtual.shape[0] != ranges.shape[0]:
            return
        dt = 0.0 if self._last_time is None else now - self._last_time
        self._last_time = now
        dev = self.device
        self.new_grid, self.gone_grid = _step(
            self.new_grid, self.gone_grid,
            torch.as_tensor(ranges, dtype=torch.float32, device=dev),
            self._last_virtual, torch.as_tensor(angles, device=dev),
            torch.as_tensor(np.asarray(robot_pose, np.float32), device=dev),
            torch.tensor(dt, dtype=torch.float32, device=dev), self.cfg,
            float(self.lidar.range_max))

    def _confident(self, dwell: torch.Tensor) -> np.ndarray:
        pts, conf = evidence_points(dwell, self.cfg.grid_resolution,
                                    self.cfg.time_threshold)
        return pts[conf].cpu().numpy()

    def added_objects(self) -> np.ndarray:
        """Confident added-object cell centres, (K, 2) map-frame (compact)."""
        return self._confident(self.new_grid)

    def removed_objects(self) -> np.ndarray:
        return self._confident(self.gone_grid)
