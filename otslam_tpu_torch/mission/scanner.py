"""Scan capture action server.

Equivalent of the ScannerNode (scanner_node.cpp:93-332): serves scan_object
goals by waiting out a stabilization period, grabbing a fresh RGB + depth
pair, looking up the camera pose, and appending the triplet to the capture
dataset with the scanner's depth clipping.

Sensor access and time are injected so the same class runs against the
simulator or live drivers:
  get_frames() -> (color_rgb (H,W,3) uint8, depth_m (H,W) f32) | None
  get_camera_pose() -> (4,4) map->camera-body matrix | None
  sleep(seconds)  — advances sim or wall time
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from otslam_tpu_torch.config import MissionConfig
from otslam_tpu_torch.pipeline.dataset import CaptureDataset


@dataclass(frozen=True)
class ScanObjectGoal:
    """otslam_interfaces/action/ScanObject.action goal fields."""

    label: str
    x: float
    y: float
    radius: float = 1.0


@dataclass
class ScanResult:
    success: bool
    message: str
    frame_number: int = -1


class ScannerNode:
    def __init__(self, dataset: CaptureDataset,
                 get_frames: Callable, get_camera_pose: Callable,
                 sleep: Callable = lambda s: None,
                 cfg: MissionConfig | None = None,
                 poll_timeout: float = 3.0):
        self.dataset = dataset
        self._get_frames = get_frames
        self._get_camera_pose = get_camera_pose
        self._sleep = sleep
        self.cfg = cfg or MissionConfig()
        self.poll_timeout = poll_timeout

    def execute(self, goal: ScanObjectGoal) -> ScanResult:
        """One scan_object action execution (scanner_node.cpp:164-258)."""
        # stabilization wait (buffer flush + wait_time)
        self._sleep(self.cfg.wait_time)

        frames = self._get_frames()
        if frames is None:
            return ScanResult(False, "Camera Timeout")
        color, depth = frames

        pose = self._get_camera_pose()
        if pose is None:
            return ScanResult(False, "TF Error")

        try:
            n = self.dataset.save_frame(goal.label, np.asarray(color),
                                        np.asarray(depth), np.asarray(pose))
        except OSError:
            return ScanResult(False, "File Write Error")

        # cool-down before releasing the robot (scanner_node.cpp:249-252)
        self._sleep(self.cfg.wait_time)
        return ScanResult(True, "Scan Saved", n)
