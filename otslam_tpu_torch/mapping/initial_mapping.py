"""Initial-mapping perception: cluster and classify raw scans with no prior
map (counterpart of otslam_tpu/mapping/initial_mapping.py).

Equivalent of the lidar_cluster_publisher pipeline (SURVEY.md §3.5,
lidar_cluster_publisher.cpp:151-291): the first mapping session has no saved
map, so objects are found by classifying raw scan clusters into
WALL / OBJECT / UNKNOWN via bbox length and PCA linearity; the OBJECT points
(in the map frame) feed the same tracker as the change-detection pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from otslam_tpu_torch.config import ClusterConfig, LidarConfig
from otslam_tpu_torch.device import resolve_device, to_f32
from otslam_tpu_torch.kernels.cluster import (
    OBJECT, UNKNOWN, WALL, analyze_clusters, cluster_scan_points,
    scan_to_points)


class LidarClusterClassifier:
    """Per-scan classification on `device`: returns map-frame point sets
    per class."""

    def __init__(self, cfg: ClusterConfig | None = None,
                 lidar: LidarConfig | None = None, device="cuda"):
        self.cfg = cfg or ClusterConfig()
        self.lidar = lidar or LidarConfig()
        self.device = resolve_device(device)

    def classify(self, ranges, angles, robot_pose):
        """One scan (ranges and angles as arrays or tensors) -> dict with
        'wall' / 'object' / 'unknown' (K, 2) f32 numpy arrays of map-frame
        points (classified in the sensor frame, transformed after: the
        reference node's order) and 'stats', the ClusterStats on the
        device."""
        cfg = self.cfg
        pts, valid = scan_to_points(to_f32(ranges, self.device),
                                    to_f32(angles, self.device),
                                    self.lidar.range_max, cfg.max_range_ratio)
        labels, _ = cluster_scan_points(pts, valid, cfg.gap_threshold,
                                        cfg.max_clusters)
        stats = analyze_clusters(pts, labels, cfg)

        # one class per point (-1 outside every cluster), then one copy
        cls = torch.cat([stats.classes, torch.full(
            (1,), -1, dtype=stats.classes.dtype, device=self.device)])
        point_cls = cls[labels.to(torch.int64)].cpu().numpy()
        p = pts.cpu().numpy()
        vm = valid.cpu().numpy()
        x0, y0, yaw = robot_pose
        c, s = np.cos(yaw), np.sin(yaw)
        wx = x0 + p[:, 0] * c - p[:, 1] * s
        wy = y0 + p[:, 0] * s + p[:, 1] * c
        world = np.stack([wx, wy], -1).astype(np.float32)
        return {
            "wall": world[vm & (point_cls == WALL)],
            "object": world[vm & (point_cls == OBJECT)],
            "unknown": world[vm & (point_cls == UNKNOWN)],
            "stats": stats,
        }
