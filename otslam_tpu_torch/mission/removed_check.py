"""Removed-object check-point selection (legacy single-goal strategy).

Equivalent of ``removed_object_goal_selector.cpp:173-392``: instead of
queueing a full visiting circle per removed object (the shipping design),
this variant BFS-clusters the removed-evidence points, rings each cluster
centroid with ``num_goal_points`` candidate poses at
``goal_distance_from_center``, and emits the SINGLE candidate nearest to
the robot across all clusters ("CHECK REMOVED"): a one-goal-at-a-time
verification sweep. Kept as an alternative removed-object policy;
``nearest_check_point`` is pure array-in/array-out so it slots into the
same control loop as the queue-based path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class RemovedCheckConfig:
    """Node defaults (removed_object_goal_selector.cpp:173-178)."""

    cluster_distance_threshold: float = 0.4
    min_cluster_points: int = 4
    goal_distance_from_center: float = 0.6
    num_goal_points: int = 8


@dataclass(frozen=True)
class CheckPoint:
    x: float
    y: float
    yaw: float            # facing the cluster centroid
    cluster_id: int
    centroid: tuple       # (cx, cy) for context markers


def bfs_clusters(points: np.ndarray, dist_thresh: float,
                 min_points: int) -> List[np.ndarray]:
    """Connected components at ``dist_thresh`` (the reference's hand-rolled
    BFS "DBSCAN", removed_object_goal_selector.cpp:364-391). Vectorized:
    one (N, N) adjacency + frontier sweeps instead of the O(N^2) inner
    scan per visited point."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return []
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    adj = d2 < dist_thresh * dist_thresh
    visited = np.zeros(n, bool)
    out: List[np.ndarray] = []
    for seed in range(n):
        if visited[seed]:
            continue
        comp = np.zeros(n, bool)
        comp[seed] = True
        while True:
            grown = adj[comp].any(axis=0) & ~visited
            new = grown & ~comp
            if not new.any():
                break
            comp |= new
        visited |= comp
        if int(comp.sum()) >= min_points:
            out.append(pts[comp])
    return out


def nearest_check_point(points: np.ndarray, robot_xy: tuple,
                        cfg: RemovedCheckConfig | None = None
                        ) -> Optional[CheckPoint]:
    """The single nearest circular check pose across all removed clusters
    (removed_object_goal_selector.cpp:246-277), or None if no cluster
    passes the size gate."""
    cfg = cfg or RemovedCheckConfig()
    clusters = bfs_clusters(points, cfg.cluster_distance_threshold,
                            cfg.min_cluster_points)
    if not clusters:
        return None
    rx, ry = float(robot_xy[0]), float(robot_xy[1])
    best: Optional[CheckPoint] = None
    best_d = np.inf
    step = 2.0 * np.pi / cfg.num_goal_points
    for ci, cluster in enumerate(clusters):
        cx, cy = cluster.mean(axis=0)
        for i in range(cfg.num_goal_points):
            ang = step * i
            gx = cx + cfg.goal_distance_from_center * np.cos(ang)
            gy = cy + cfg.goal_distance_from_center * np.sin(ang)
            d = float(np.hypot(gx - rx, gy - ry))
            if d < best_d:
                best_d = d
                best = CheckPoint(float(gx), float(gy), float(ang + np.pi),
                                  ci, (float(cx), float(cy)))
    return best
