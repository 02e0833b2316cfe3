"""System manager: the IDLE -> NAVIGATING -> SCANNING state machine.

Equivalent of the SystemManager node (manager_node.cpp:67-252), including the
freeze strategy documented at manager_node.cpp:26-47:

* new object id  -> unfreeze tracking (live LiDAR search for the new target);
* same object id -> stay frozen (visiting points keep the original center);
* navigation success -> force freeze, then fire the scan action;
* navigation failure -> retry the same point (no unfreeze);
* after the scan -> back to IDLE, frozen until a new object id arrives.

Dependencies are injected as callables so the manager runs against the
simulator, a real Nav2 bridge, or test doubles identically:
  navigate(x, y, yaw) -> bool        (blocking nav result)
  scan(label, x, y, radius) -> bool  (blocking scan result)
  set_tracking(enabled: bool)        (freeze service)
"""

from __future__ import annotations

import enum
from typing import Callable

import numpy as np

from otslam_tpu_torch.config import MissionConfig
from otslam_tpu_torch.mission.goal_queue import TargetPoint

# offset separating removed-check object ids from added ids in the
# manager's freeze/label bookkeeping (the per-tracker indices both start
# at 0); far above any realistic tracked-object count
REMOVED_KEY_BASE = 100_000


class ManagerState(enum.Enum):
    IDLE = 0
    NAVIGATING = 1
    SCANNING = 2


class SystemManager:
    def __init__(self, navigate: Callable, scan: Callable,
                 set_tracking: Callable, cfg: MissionConfig | None = None):
        self.cfg = cfg or MissionConfig()
        self._navigate = navigate
        self._scan = scan
        self._set_tracking = set_tracking
        self.state = ManagerState.IDLE
        self.current_obj_id = -1
        self.last_target_x = 0.0
        self.last_target_y = 0.0
        self.first_goal_received = False
        # scripted missions (mission/goal_list.py) carry their own labels
        # (goal_list.hpp:8 GoalData.label); detection-driven missions use the
        # manager's Object_<id> convention (manager_node.cpp:225)
        self.label_lookup: dict[int, str] = {}
        # optional nav-failure feedback to the goal queue (unreachable
        # visiting points get skipped after repeated failures; see
        # GoalSender.report_nav_failure)
        self.nav_failure_cb: Callable | None = None
        # initial state: tracking enabled to find the first object
        self._set_tracking(True)

    def on_goal(self, target: TargetPoint) -> bool:
        """Handle one target pose; returns True if a mission was executed.

        Mirrors goal_callback + the action chain (manager_node.cpp:137-251).
        The object id travels in the target struct (the ROS version encodes
        it in pose.position.z).
        """
        if self.state != ManagerState.IDLE:
            return False

        # removed-check targets live in their own id space: the selector's
        # object indices restart per tracker, so added Object_0 and removed
        # check 0 would otherwise share an id (and a capture label),
        # polluting the added object's reconstruction frames
        new_id = (target.object_id + REMOVED_KEY_BASE if target.is_removed
                  else target.object_id)
        if new_id != self.current_obj_id:
            self._set_tracking(True)   # new object: live LiDAR search
        # same id: stay frozen

        if self.first_goal_received:
            d = np.hypot(target.x - self.last_target_x,
                         target.y - self.last_target_y)
            if d < self.cfg.goal_dedupe_distance:
                return False

        self.last_target_x = target.x
        self.last_target_y = target.y
        self.current_obj_id = new_id
        self.first_goal_received = True

        self.state = ManagerState.NAVIGATING
        ok = self._navigate(target.x, target.y, target.yaw)
        if not ok:
            # retry the exact same point; do NOT unfreeze
            self.first_goal_received = False
            self.state = ManagerState.IDLE
            if self.nav_failure_cb is not None:
                self.nav_failure_cb(target)
            return False

        # arrival: freeze for camera time, then scan
        self._set_tracking(False)
        self.state = ManagerState.SCANNING
        if self.current_obj_id >= REMOVED_KEY_BASE:
            label = f"Removed_{self.current_obj_id - REMOVED_KEY_BASE}"
        else:
            label = self.label_lookup.get(self.current_obj_id,
                                          f"Object_{self.current_obj_id}")
        self._scan(label, self.last_target_x, self.last_target_y,
                   self.cfg.scan_radius)
        # stay frozen until a new object id arrives (manager_node.cpp:246-248)
        self.state = ManagerState.IDLE
        return True
