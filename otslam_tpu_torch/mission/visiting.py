"""Visiting-point generation: a circle of scan poses around each object.

Equivalent of the marker emission at 3_multi_object_goal_selector.cpp:275-308
(uniform-distance scanning): radius = lock_radius + buffer, point count =
max(min_scan_points, round(circumference / interval)), each pose at angle
2*pi*i/n facing the center (yaw = angle + pi). Marker ids are
object_index * 100 + i for added objects; removed objects use a 5 m interval
(3_multi_object_goal_selector.cpp:441-447) and ids offset by 5000 (the
GoalSender decodes removed ids as id - 5000: 3_multi_send_goal_node.cpp:113-114).

When member sub-segmentation is on (TrackerConfig.member_distance_threshold),
a merged group expands into one capture site per member body (scan_sites):
each member gets its own circle, object id, and therefore scan label —
reproducing the reference's per-object eval-scan geometry
(eval_table_chair.py:90-104) instead of one far circle around the group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from otslam_tpu_torch.config import TrackerConfig
from otslam_tpu_torch.mission.tracker import TrackedCluster

REMOVED_ID_BASE = 5000


@dataclass(frozen=True)
class VisitingPoint:
    unique_id: int
    object_id: int
    x: float
    y: float
    yaw: float          # facing the object center
    is_removed: bool = False


def _point_plan(c: TrackedCluster, cfg: TrackerConfig,
                removed: bool) -> tuple:
    """(count, angular step, id stride) for the configured placement mode.

    "uniform-distance" is the shipping design; the other two reproduce the
    superseded selector iterations kept in the reference tree (see
    TrackerConfig.visiting_mode). All modes share the same circle radius and
    face-the-center yaw; they differ only in how many poses and at what
    angular spacing.
    """
    mode = cfg.visiting_mode
    if mode == "adaptive-count":
        # object_goal_selector.cpp:247-255 — 6 or 8 points by bbox diagonal;
        # marker ids are obj*10+i ("max points might be 8, multiplier 10").
        diagonal = float(np.hypot(c.width, c.height))
        n = (cfg.points_count_big if diagonal > cfg.scan_step_threshold
             else cfg.points_count_normal)
        return n, 2.0 * np.pi / n, 10
    if mode == "degree-step":
        # multi_object_goal_selector.cpp:245-261 — fixed angular interval;
        # the last point may land closer than the step (ceil semantics).
        n = int(np.ceil(360.0 / cfg.degree_visiting_points))
        return n, np.deg2rad(cfg.degree_visiting_points), 100
    if mode != "uniform-distance":
        raise ValueError(f"unknown visiting_mode {mode!r}")
    interval = (cfg.scan_point_interval_removed if removed
                else cfg.scan_point_interval)
    vp_radius = c.lock_radius + cfg.visiting_point_buffer
    circumference = 2.0 * np.pi * vp_radius
    n = max(cfg.min_scan_points, int(round(circumference / interval)))
    return n, 2.0 * np.pi / n, 100


def scan_sites(stable_objects: Sequence[TrackedCluster]
               ) -> List[TrackedCluster]:
    """Flatten tracked objects into capture sites: a merged group carrying
    member sub-clusters (tracker._segment_members) contributes one site per
    member; everything else is its own site. Site IDENTITY is the
    tracker-assigned ``site_id`` (persistent across later member adoption),
    not the list position — mission object ids, capture labels, and
    visited-uid spaces key off it and never shift under an ongoing
    mission."""
    sites: List[TrackedCluster] = []
    for c in stable_objects:
        sites.extend(c.members if len(c.members) >= 2 else (c,))
    return sites


def visiting_points(stable_objects: Sequence[TrackedCluster],
                    cfg: TrackerConfig | None = None,
                    removed: bool = False) -> List[VisitingPoint]:
    cfg = cfg or TrackerConfig()
    out: List[VisitingPoint] = []
    for pos, c in enumerate(scan_sites(stable_objects)):
        # tracker-assigned persistent site id (stable under later member
        # adoption); positional fallback for directly-built clusters
        obj_idx = c.site_id if c.site_id >= 0 else pos
        vp_radius = c.lock_radius + cfg.visiting_point_buffer
        n, step, id_stride = _point_plan(c, cfg, removed)
        for i in range(n):
            ang = step * i
            uid = obj_idx * id_stride + i
            if removed:
                uid += REMOVED_ID_BASE
            out.append(VisitingPoint(
                unique_id=uid,
                object_id=obj_idx,
                x=float(c.cx + vp_radius * np.cos(ang)),
                y=float(c.cy + vp_radius * np.sin(ang)),
                yaw=float(ang + np.pi),
                is_removed=removed,
            ))
    return out
