"""Mission control plane (host numpy): object tracker, visiting points, goal
queue, manager state machine, scanner action, scripted goal lists and the
removed-object check points. Copies of otslam_tpu/mission/ with their
imports pointed at the port."""

from otslam_tpu_torch.mission.tracker import (  # noqa: F401
    ObjectTracker, TrackedCluster)
from otslam_tpu_torch.mission.visiting import (  # noqa: F401
    VisitingPoint, scan_sites, visiting_points)
from otslam_tpu_torch.mission.goal_queue import (  # noqa: F401
    GoalSender, TargetPoint)
from otslam_tpu_torch.mission.manager import (  # noqa: F401
    ManagerState, SystemManager)
from otslam_tpu_torch.mission.scanner import (  # noqa: F401
    ScannerNode, ScanObjectGoal)
from otslam_tpu_torch.mission.goal_list import (  # noqa: F401
    GoalData, as_targets, default_goal_list, load_goal_list, save_goal_list)
from otslam_tpu_torch.mission.removed_check import (  # noqa: F401
    CheckPoint, RemovedCheckConfig, bfs_clusters, nearest_check_point)
