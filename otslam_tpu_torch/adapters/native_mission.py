"""ctypes bindings for the native mission control plane (counterpart of
otslam_tpu/adapters/native_mission.py): drop-in C++ replacements for
ObjectTracker and GoalSender with identical semantics (parity-tested against
the Python layer). Use these when the 5 Hz online loop must run with minimal
host jitter — the role the reference's rclcpp nodes play.

The port keeps its own copy of the source, `otslam_tpu_torch/native/
otslam_mission.cpp`, built by g++ under build/ as adapters/native.py
builds the host runtime.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence

import numpy as np

from otslam_tpu_torch.adapters.native import NATIVE_SRC, build_host_library
from otslam_tpu_torch.config import MissionConfig, TrackerConfig
from otslam_tpu_torch.mission.goal_queue import TargetPoint
from otslam_tpu_torch.mission.tracker import TrackedCluster
from otslam_tpu_torch.mission.visiting import VisitingPoint

MISSION_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()
_failed = False


class _TrackerParams(ctypes.Structure):
    _fields_ = [
        ("cluster_distance_threshold", ctypes.c_double),
        ("wall_thickness_threshold", ctypes.c_double),
        ("stability_time", ctypes.c_double),
        ("lock_margin", ctypes.c_double),
        ("smoothing_factor", ctypes.c_double),
        ("unseen_prune_time", ctypes.c_double),
        ("min_cluster_points", ctypes.c_int32),
    ]


class _Target(ctypes.Structure):
    _fields_ = [
        ("unique_id", ctypes.c_int32),
        ("object_id", ctypes.c_int32),
        ("is_removed", ctypes.c_int32),
        ("x", ctypes.c_double),
        ("y", ctypes.c_double),
        ("yaw", ctypes.c_double),
    ]


def load_mission_native():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = build_host_library(NATIVE_SRC / "otslam_mission.cpp",
                                  MISSION_FLAGS)
        if path is None:
            _failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.tracker_create.restype = ctypes.c_void_p
        lib.tracker_create.argtypes = [ctypes.POINTER(_TrackerParams)]
        lib.tracker_destroy.argtypes = [ctypes.c_void_p]
        lib.tracker_set_mode.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tracker_enabled.restype = ctypes.c_int
        lib.tracker_enabled.argtypes = [ctypes.c_void_p]
        lib.tracker_update.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_double]
        lib.tracker_num_stable.restype = ctypes.c_int64
        lib.tracker_num_stable.argtypes = [ctypes.c_void_p]
        lib.tracker_num_candidates.restype = ctypes.c_int64
        lib.tracker_num_candidates.argtypes = [ctypes.c_void_p]
        lib.tracker_get_stable.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sender_create.restype = ctypes.c_void_p
        lib.sender_create.argtypes = [ctypes.c_double]
        lib.sender_destroy.argtypes = [ctypes.c_void_p]
        lib.sender_on_odom.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                       ctypes.c_double]
        lib.sender_on_added.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64]
        lib.sender_on_removed.argtypes = lib.sender_on_added.argtypes
        lib.sender_control_step.restype = ctypes.c_int
        lib.sender_control_step.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(_Target)]
        lib.sender_pending.restype = ctypes.c_int64
        lib.sender_pending.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeObjectTracker:
    """C++ ObjectTracker with the Python class's interface."""

    def __init__(self, cfg: TrackerConfig | None = None):
        self.cfg = cfg or TrackerConfig()
        self._lib = load_mission_native()
        if self._lib is None:
            raise RuntimeError("native mission runtime unavailable (no g++?)")
        p = _TrackerParams(
            self.cfg.cluster_distance_threshold,
            self.cfg.wall_thickness_threshold,
            self.cfg.stability_time,
            self.cfg.lock_margin,
            self.cfg.smoothing_factor,
            self.cfg.unseen_prune_time,
            self.cfg.min_cluster_points,
        )
        self._h = self._lib.tracker_create(ctypes.byref(p))

    def set_tracking_mode(self, enabled: bool) -> None:
        self._lib.tracker_set_mode(self._h, int(enabled))

    @property
    def tracking_enabled(self) -> bool:
        return bool(self._lib.tracker_enabled(self._h))

    def update(self, points_map: Sequence, now: float) -> None:
        pts = np.ascontiguousarray(np.asarray(points_map, np.float64)
                                   .reshape(-1, 2))
        self._lib.tracker_update(
            self._h, pts.ctypes.data_as(ctypes.c_void_p), len(pts),
            float(now))

    @property
    def stable_objects(self) -> List[TrackedCluster]:
        n = self._lib.tracker_num_stable(self._h)
        out = np.empty((max(int(n), 1), 5), np.float64)
        if n:
            self._lib.tracker_get_stable(
                self._h, out.ctypes.data_as(ctypes.c_void_p))
        return [TrackedCluster(r[0], r[1], r[2], r[3], r[4], 0.0, 0.0, True)
                for r in out[:int(n)]]

    @property
    def num_candidates(self) -> int:
        return int(self._lib.tracker_num_candidates(self._h))

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.tracker_destroy(self._h)
            self._h = None


class NativeGoalSender:
    """C++ GoalSender with the Python class's interface."""

    def __init__(self, cfg: MissionConfig | None = None):
        self.cfg = cfg or MissionConfig()
        self._lib = load_mission_native()
        if self._lib is None:
            raise RuntimeError("native mission runtime unavailable (no g++?)")
        self._h = self._lib.sender_create(self.cfg.reach_threshold)

    def on_odom(self, x: float, y: float) -> None:
        self._lib.sender_on_odom(self._h, float(x), float(y))

    @staticmethod
    def _pack(points: Sequence[VisitingPoint]) -> np.ndarray:
        arr = np.zeros((len(points), 6), np.float64)
        for i, p in enumerate(points):
            arr[i] = (p.unique_id, p.object_id, p.x, p.y, p.yaw,
                      1.0 if p.is_removed else 0.0)
        return np.ascontiguousarray(arr)

    def on_added_points(self, points: Sequence[VisitingPoint]) -> None:
        arr = self._pack(points)
        self._lib.sender_on_added(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), len(arr))

    def on_removed_points(self, points: Sequence[VisitingPoint]) -> None:
        arr = self._pack(points)
        self._lib.sender_on_removed(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), len(arr))

    def control_step(self) -> Optional[TargetPoint]:
        t = _Target()
        if not self._lib.sender_control_step(self._h, ctypes.byref(t)):
            return None
        return TargetPoint(int(t.unique_id), int(t.object_id),
                           float(t.x), float(t.y), float(t.yaw),
                           bool(t.is_removed))

    def pending_count(self) -> int:
        return int(self._lib.sender_pending(self._h))

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.sender_destroy(self._h)
            self._h = None
