"""Static (pre-scripted) goal lists for scripted scan missions.

Equivalent of ``system_manager/include/system_manager/goal_list.hpp:7-23``:
a hard-coded list of ``GoalData{id, label, x, y, theta}`` entries (theta in
degrees) that the reference keeps as a placeholder for missions whose scan
targets are known in advance rather than detected online. Here the list is
a first-class mission input: it can be loaded from a file, and
``as_targets`` turns it into the same ``TargetPoint`` records the sticky
goal queue consumes, so a static mission runs through the identical
GoalSender → manager FSM → scanner path as a detection-driven one.

File format (one goal per line, ``#`` comments allowed)::

    id, label, x, y, theta_degrees
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

import numpy as np

from otslam_tpu_torch.mission.goal_queue import TargetPoint


@dataclass(frozen=True)
class GoalData:
    """One scripted scan target (goal_list.hpp:7-13; theta in degrees)."""

    id: int
    label: str
    x: float
    y: float
    theta: float


def default_goal_list() -> List[GoalData]:
    """The reference header's placeholder list (goal_list.hpp:16-22)."""
    return [
        GoalData(1, "kitchen_point", 1.5, 0.0, 0.0),
        GoalData(2, "living_chair", 2.0, 2.0, 90.0),
        GoalData(3, "entrance", -1.0, 0.5, 180.0),
    ]


def load_goal_list(path: str | Path) -> List[GoalData]:
    """Parse a goal-list file: ``id, label, x, y, theta_deg`` per line."""
    goals: List[GoalData] = []
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 5:
            raise ValueError(
                f"{path}:{lineno}: expected 'id, label, x, y, theta_deg', "
                f"got {raw!r}")
        goals.append(GoalData(int(parts[0]), parts[1], float(parts[2]),
                              float(parts[3]), float(parts[4])))
    return goals


def save_goal_list(goals: Sequence[GoalData], path: str | Path) -> None:
    lines = ["# id, label, x, y, theta_degrees"]
    lines += [f"{g.id}, {g.label}, {g.x}, {g.y}, {g.theta}" for g in goals]
    Path(path).write_text("\n".join(lines) + "\n")


def as_targets(goals: Sequence[GoalData]) -> List[TargetPoint]:
    """Goal list -> queue targets.

    Each scripted goal is its own object (one visiting point), so the
    sticky-then-greedy queue degenerates to nearest-first traversal — the
    behavior the placeholder header implies for a fixed patrol route. The
    goal's own id doubles as the object id so the manager FSM's
    freeze/unfreeze-by-id-change protocol (manager_node.cpp:146-156) works
    unchanged.
    """
    return [TargetPoint(unique_id=g.id, object_id=g.id, x=g.x, y=g.y,
                        yaw=float(np.deg2rad(g.theta)), is_removed=False)
            for g in goals]
