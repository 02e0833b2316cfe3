"""Mission goal queue: sticky-then-greedy visiting-point selection.

Equivalent of the GoalSender node (3_multi_send_goal_node.cpp:33-266):

* Keeps the latest added/removed visiting-point lists (refreshed wholesale on
  every tracker update, minus already-visited ids).
* A 5 Hz control loop marks the active target visited when the robot is
  within ``reach_threshold``, then picks the next target: prefer the
  remaining points of the *current* object (sticky, added-type only), else
  the globally nearest point of any object (greedy).
* Re-emits the active goal while the robot is still far (republish logic).

The marker-id encode/decode of the ROS version (added: id/100, removed:
id-5000) lives in ``decode_marker_id`` for the adapter layer; internally
targets carry explicit ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Set

import numpy as np

from otslam_tpu_torch.config import MissionConfig
from otslam_tpu_torch.mission.visiting import REMOVED_ID_BASE, VisitingPoint


@dataclass(frozen=True)
class TargetPoint:
    unique_id: int
    object_id: int
    x: float
    y: float
    yaw: float
    is_removed: bool


def decode_marker_id(marker_id: int, is_removed: bool,
                     id_stride: int = 100) -> int:
    """Object id from a marker id (3_multi_send_goal_node.cpp:112-115).

    ``id_stride`` matches the selector's encoding: 100 for the current
    uniform-distance/degree-step selectors, 10 for the legacy adaptive-count
    variant (object_goal_selector.cpp:246-248).
    """
    return (marker_id - REMOVED_ID_BASE if is_removed
            else marker_id // id_stride)


class GoalSender:
    def __init__(self, cfg: MissionConfig | None = None):
        self.cfg = cfg or MissionConfig()
        self.added_targets: List[TargetPoint] = []
        self.removed_targets: List[TargetPoint] = []
        self.visited_ids: Set[int] = set()
        self.visited_removed_ids: Set[int] = set()
        self.active_target: Optional[TargetPoint] = None
        self.current_object_focus: int = -1
        self.robot_x = 0.0
        self.robot_y = 0.0
        self._nav_failures: dict = {}
        self.skipped_ids: Set[int] = set()

    def report_nav_failure(self, target: TargetPoint) -> None:
        """Navigation to `target` failed (Nav2 aborted). After
        cfg.max_nav_failures total failures the point is marked
        visited and skipped — a physically unreachable visiting point
        (e.g. on a circle segment inside a wall) must not livelock the
        mission (the reference retries forever, manager_node.cpp:202-207,
        and leans on Nav2; see MissionConfig.max_nav_failures)."""
        n = self._nav_failures.get(target.unique_id, 0) + 1
        self._nav_failures[target.unique_id] = n
        if n >= self.cfg.max_nav_failures:
            self.skipped_ids.add(target.unique_id)
            if target.is_removed:
                self.visited_removed_ids.add(target.unique_id)
            else:
                self.visited_ids.add(target.unique_id)
            if (self.active_target is not None
                    and self.active_target.unique_id == target.unique_id):
                self.active_target = None

    # --- subscriptions ------------------------------------------------------

    def on_odom(self, x: float, y: float) -> None:
        self.robot_x, self.robot_y = float(x), float(y)

    def on_added_points(self, points: Sequence[VisitingPoint]) -> None:
        self.added_targets = [
            TargetPoint(p.unique_id, p.object_id, p.x, p.y, p.yaw, False)
            for p in points if p.unique_id not in self.visited_ids]

    def on_removed_points(self, points: Sequence[VisitingPoint]) -> None:
        self.removed_targets = [
            TargetPoint(p.unique_id, p.object_id, p.x, p.y, p.yaw, True)
            for p in points if p.unique_id not in self.visited_removed_ids]

    # --- control loop -------------------------------------------------------

    def _dist(self, t: TargetPoint) -> float:
        return float(np.hypot(self.robot_x - t.x, self.robot_y - t.y))

    def control_step(self) -> Optional[TargetPoint]:
        """One 5 Hz tick. Returns the goal to (re)publish, or None."""
        cfg = self.cfg
        # 1. reach check
        if self.active_target is not None:
            if self._dist(self.active_target) < cfg.reach_threshold:
                if self.active_target.is_removed:
                    self.visited_removed_ids.add(self.active_target.unique_id)
                else:
                    self.visited_ids.add(self.active_target.unique_id)
                self.active_target = None

        # 2. select next if idle
        if self.active_target is None:
            candidates = [t for t in self.added_targets
                          if t.unique_id not in self.visited_ids]
            candidates += [t for t in self.removed_targets
                           if t.unique_id not in self.visited_removed_ids]
            if candidates:
                best = None
                # A. sticky: finish the current object first (added type only)
                if self.current_object_focus != -1:
                    sticky = [t for t in candidates
                              if t.object_id == self.current_object_focus
                              and not t.is_removed]
                    if sticky:
                        best = min(sticky, key=self._dist)
                # B. global greedy
                if best is None:
                    best = min(candidates, key=self._dist)
                self.active_target = best
                self.current_object_focus = best.object_id
                return best
            return None

        # 3. republish while distant
        if self._dist(self.active_target) > cfg.reach_threshold:
            return self.active_target
        return None

    # --- mission-progress checkpointing ------------------------------------
    # (the reference keeps visited ids in memory only and loses them on
    # restart, 3_multi_send_goal_node.cpp:75-76 / SURVEY.md §5; here mission
    # progress persists like every other pipeline artifact)

    def save_state(self) -> dict:
        return {
            "visited_ids": sorted(self.visited_ids),
            "visited_removed_ids": sorted(self.visited_removed_ids),
            "current_object_focus": self.current_object_focus,
        }

    def load_state(self, state: dict) -> None:
        self.visited_ids = set(state.get("visited_ids", []))
        self.visited_removed_ids = set(state.get("visited_removed_ids", []))
        self.current_object_focus = state.get("current_object_focus", -1)
        self.active_target = None

    def pending_count(self) -> int:
        return (len([t for t in self.added_targets
                     if t.unique_id not in self.visited_ids])
                + len([t for t in self.removed_targets
                       if t.unique_id not in self.visited_removed_ids]))
