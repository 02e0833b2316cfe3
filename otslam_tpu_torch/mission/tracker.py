"""Object tracker: candidate/stable cluster tracking with lock radii.

Equivalent of the ObjectClusterMarker node
(3_multi_object_goal_selector.cpp:22-249): incoming change-detection points
are gap-clustered, filtered by bbox thickness, associated to tracked clusters
by lock radius, EMA-smoothed, promoted to *stable* after ``stability_time``
seconds, and pruned if unseen. A freeze flag (the ``set_tracking_mode``
service) turns updates off while the camera is scanning.

Host-side by design (SURVEY.md §7: the control plane operates on a handful of
clusters); the per-tick clustering is host numpy (kernels/cluster.py).
A copy of otslam_tpu/mission/tracker.py with its imports pointed at the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from otslam_tpu_torch.config import TrackerConfig
from otslam_tpu_torch.kernels.cluster import cluster_points_spatial_host


@dataclass
class TrackedCluster:
    cx: float
    cy: float
    width: float
    height: float
    lock_radius: float
    first_seen: float
    last_seen: float
    stable: bool = False
    # member sub-clusters of a merged group (cfg.member_distance_threshold):
    # each is its own TrackedCluster (members=()) and becomes its own scan
    # site (visiting.scan_sites). Empty when sub-segmentation is off or the
    # group is a single body. Once stable, existing members keep frozen
    # geometry but NEWLY-DISCOVERED bodies are still adopted (the tuned
    # 1.0 s stability_time promotes groups long before the robot has seen
    # every member's evidence).
    members: tuple = ()
    # persistent scan-site identity, assigned by the tracker at promotion /
    # adoption: visiting-point uids, goal object ids, and capture labels
    # key off this, so later-adopted members never shift earlier sites'
    # ids (visited-uid sets and datasets stay valid mid-mission)
    site_id: int = -1


def _lock_radius(w: float, h: float, margin: float) -> float:
    return float(np.hypot(w, h) / 2.0 + margin)


class ObjectTracker:
    """One tracking pipeline (the node instantiates two: added + removed)."""

    def __init__(self, cfg: TrackerConfig | None = None):
        self.cfg = cfg or TrackerConfig()
        self.candidates: List[TrackedCluster] = []
        self.stable_objects: List[TrackedCluster] = []
        self.tracking_enabled: bool = True
        self._site_counter: int = 0

    def _assign_site_ids(self, cluster: TrackedCluster) -> None:
        """Give the cluster's scan sites (members, or the cluster itself)
        persistent ids in promotion/adoption order."""
        targets = cluster.members if len(cluster.members) >= 2 else (cluster,)
        for t in targets:
            if t.site_id < 0:
                t.site_id = self._site_counter
                self._site_counter += 1

    # --- service: set_tracking_mode (freeze/unfreeze) ----------------------

    def set_tracking_mode(self, enabled: bool) -> None:
        self.tracking_enabled = enabled

    # --- observation path ---------------------------------------------------

    def _cluster_observations(self, points_map: np.ndarray, now: float
                              ) -> List[TrackedCluster]:
        """Cluster map-frame points into raw observations
        (3_multi_object_goal_selector.cpp:178-215). Single-linkage spatial
        clustering rather than the reference's received-order gap chaining:
        the change cloud is an unordered grid dump, and order-dependent
        chaining shatters interleaved distant objects into thin fragments
        (see cluster_points_spatial_host)."""
        cfg = self.cfg
        if len(points_map) == 0:
            return []
        pts = np.asarray(points_map, np.float32).reshape(-1, 2)
        labels, num = cluster_points_spatial_host(
            pts, cfg.cluster_distance_threshold)
        obs = []
        for k in range(int(num)):
            member = pts[labels == k]
            if len(member) < cfg.min_cluster_points:
                continue
            mn = member.min(axis=0)
            mx = member.max(axis=0)
            w, h = float(mx[0] - mn[0]), float(mx[1] - mn[1])
            # epsilon-tolerant thin test: the points are evidence-grid cell
            # centers whose f32 coordinates differ by ulps across backends
            # (origin + idx*res on different devices), and an object spanning
            # exactly the threshold (e.g. 3 cells = 0.30 m at the tuned
            # 0.3 wall_thickness) must not flip between them
            if min(w, h) < cfg.wall_thickness_threshold - 1e-4:
                continue
            cx, cy = float((mn[0] + mx[0]) / 2), float((mn[1] + mx[1]) / 2)
            obs.append(TrackedCluster(
                cx, cy, w, h, _lock_radius(w, h, cfg.lock_margin), now, now,
                members=self._segment_members(member, now)))
        return obs

    def _segment_members(self, member_pts: np.ndarray,
                         now: float) -> tuple:
        """Sub-segment one group's evidence cells into member bodies.

        The tuned 4 m cluster radius merges near objects (table + chairs)
        into one tracked group on purpose; this re-clusters the SAME cells
        at the much smaller member_distance_threshold so each physical body
        gets its own capture circle (VERDICT r4 #5 — a single circle around
        the merged group reconstructs outer members from far oblique views).
        Members keep the wall-thickness filter (a thin fragment is no better
        a scan target as a member than as a group); a group collapsing to
        <2 surviving members reports none (the group scans as one site)."""
        cfg = self.cfg
        if cfg.member_distance_threshold <= 0.0 or len(member_pts) < 2:
            return ()
        labels, num = cluster_points_spatial_host(
            member_pts, cfg.member_distance_threshold)
        out = []
        for k in range(int(num)):
            sub = member_pts[labels == k]
            if len(sub) < cfg.min_cluster_points:
                continue
            mn, mx = sub.min(axis=0), sub.max(axis=0)
            w, h = float(mx[0] - mn[0]), float(mx[1] - mn[1])
            if min(w, h) < cfg.wall_thickness_threshold - 1e-4:
                continue
            out.append(TrackedCluster(
                float((mn[0] + mx[0]) / 2), float((mn[1] + mx[1]) / 2),
                w, h, _lock_radius(w, h, cfg.member_lock_margin), now, now))
        return tuple(out) if len(out) >= 2 else ()

    def _adopt_members(self, stable: TrackedCluster,
                       raw: TrackedCluster) -> None:
        """Adopt newly-discovered member bodies into a stable group.

        The tuned 1.0 s stability_time promotes a group long before the
        robot has circled it — evidence for far members (e.g. the south
        chairs of the full_room table group) arrives while the group is
        already stable and its geometry frozen. Existing members stay
        frozen (their circles and site ids must not move mid-mission); a
        raw member whose center is not within member_distance_threshold of
        any existing member is appended as a NEW site with a fresh id.
        A stable group that promoted memberless (single blob at promotion)
        adopts a later >=2-member split the same way — scan_sites then
        switches it from one group circle to per-member circles."""
        if not raw.members:
            return
        if not stable.members:
            stable.members = raw.members
            self._assign_site_ids(stable)
            return
        thr = self.cfg.member_distance_threshold

        def matches(m, e):
            # same body if the new center falls within the existing
            # member's footprint radius (a partially-occluded view of the
            # table re-clusters to an off-center fragment; adopting every
            # fragment as a new site over-segments the group)
            r = max(thr, np.hypot(e.width, e.height) / 2)
            return np.hypot(m.cx - e.cx, m.cy - e.cy) < r

        new = [m for m in raw.members
               if not any(matches(m, e) for e in stable.members)]
        if new:
            stable.members = stable.members + tuple(new)
            self._assign_site_ids(stable)

    def update(self, points_map: Sequence, now: float) -> None:
        """Process one cloud of (already map-frame) change points.

        When frozen, observations are ignored (the node only republishes its
        markers: 3_multi_object_goal_selector.cpp:157-160).
        """
        if not self.tracking_enabled:
            return
        cfg = self.cfg
        for raw in self._cluster_observations(np.asarray(points_map), now):
            matched = False
            for stable in self.stable_objects:
                if np.hypot(raw.cx - stable.cx, raw.cy - stable.cy) < stable.lock_radius:
                    stable.last_seen = now  # absorb, keep frozen geometry
                    self._adopt_members(stable, raw)
                    matched = True
                    break
            if matched:
                continue
            for cand in self.candidates:
                if np.hypot(raw.cx - cand.cx, raw.cy - cand.cy) < cand.lock_radius:
                    a = cfg.smoothing_factor
                    cand.last_seen = now
                    cand.cx = cand.cx * (1 - a) + raw.cx * a
                    cand.cy = cand.cy * (1 - a) + raw.cy * a
                    cand.width = cand.width * (1 - a) + raw.width * a
                    cand.height = cand.height * (1 - a) + raw.height * a
                    cand.lock_radius = _lock_radius(cand.width, cand.height,
                                                    cfg.lock_margin)
                    # members come wholesale from the LATEST observation:
                    # evidence accumulates across ticks, so the newest dump
                    # is the most complete view of the group's bodies (and
                    # EMA across changing member counts is ill-defined)
                    if raw.members:
                        cand.members = raw.members
                    matched = True
                    break
            if not matched:
                self.candidates.append(raw)

        # promotion / pruning (3_multi_object_goal_selector.cpp:233-246)
        remaining = []
        for cand in self.candidates:
            age = now - cand.first_seen
            unseen = now - cand.last_seen
            if age > cfg.stability_time:
                cand.stable = True
                self._assign_site_ids(cand)
                self.stable_objects.append(cand)
            elif unseen > cfg.unseen_prune_time:
                pass  # dropped
            else:
                remaining.append(cand)
        self.candidates = remaining
