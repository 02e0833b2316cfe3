"""Closed-loop mission runner: the headless Gazebo replacement.

Wires the full OTSLAM update pipeline (SURVEY.md §3.1) against the analytic
simulator under deterministic sim time:

    render_lidar (world)  ->  VirtualScanner (saved map)  ->  ChangeDetector
        ->  ObjectTracker (freeze-aware)  ->  visiting_points
        ->  GoalSender (sticky/greedy)    ->  SystemManager FSM
        ->  ScannerNode captures (analytic RGB-D)  ->  CaptureDataset on disk

A "changed world" is expressed as two scenes: ``scene_map`` (what the saved
2D map knows) and ``scene_world`` (reality, with objects added/removed).
Navigation is a kinematic teleport at constant speed; every subsystem sees
the same sim clock.

Counterpart of otslam_tpu/sim/runner.py. Sensors, the virtual scanner, the
change detector and the localizer run on ``device`` (the card unless the
caller asks for the CPU); the control plane is host numpy. A perception
batch comes back to the host in one transfer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from otslam_tpu_torch.config import OTSLAMConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.core.se3 import (T_FIX_GT, T_FIX_OPTICAL, se3,
                                       yaw_to_matrix2d)
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.mapping.change_detect import ChangeDetector
from otslam_tpu_torch.mapping.object_filter import StaticWallFilter
from otslam_tpu_torch.mapping.perception import perception_ticks
from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner
from otslam_tpu_torch.mission.goal_queue import GoalSender
from otslam_tpu_torch.mission.manager import SystemManager
from otslam_tpu_torch.mission.scanner import ScannerNode, ScanObjectGoal
from otslam_tpu_torch.mission.tracker import ObjectTracker
from otslam_tpu_torch.mission.visiting import visiting_points
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.sim.sensors import (render_lidar, render_lidar_path,
                                          render_rgbd)
from otslam_tpu_torch.sim.world import Box, Scene


@dataclass
class MissionSummary:
    missions_completed: int = 0
    frames_captured: int = 0
    stable_objects: int = 0
    sim_time: float = 0.0
    labels: List[str] = field(default_factory=list)
    # label of every successful capture, in order — lets tests assert the
    # sticky (non-interleaved) object visiting order, not just completion
    capture_sequence: List[str] = field(default_factory=list)


class MissionRunner:
    def __init__(self, scene_map: Scene, scene_world: Scene, workdir: str,
                 cfg: OTSLAMConfig | None = None,
                 start_pose=(-2.0, -2.0, 0.0),
                 camera_height: float = 0.3, robot_speed: float = 0.5,
                 map_resolution: float = 0.05,
                 nav_failure_rate: float = 0.0,
                 camera_failure_rate: float = 0.0, fault_seed: int = 0,
                 odom_noise_per_m: float = 0.0, use_localizer: bool = False,
                 perception_batch: int = 1,
                 transit_tick_period: float = 0.5, device="cuda"):
        self.cfg = cfg or OTSLAMConfig()
        self.device = resolve_device(device)
        # fault injection (failure-detection behaviors under test)
        self.nav_failure_rate = nav_failure_rate
        self.camera_failure_rate = camera_failure_rate
        self._fault_rng = np.random.default_rng(fault_seed)
        self.nav_failures = 0
        self.camera_failures = 0
        self.scene_world = scene_world
        self.workdir = workdir
        self.intr = PinholeIntrinsics.from_config(self.cfg.camera)
        self.camera_height = camera_height
        self.robot_speed = robot_speed

        self.x, self.y, self.yaw = map(float, start_pose)
        self.t = 0.0
        # odometry model: the *reported* pose drifts per meter traveled;
        # optionally corrected by scan-to-map localization each tick
        self.odom_noise_per_m = odom_noise_per_m
        self.use_localizer = use_localizer
        self._odom_drift = np.zeros(3)  # (dx, dy, dyaw)
        self._localizer = None
        self.pose_estimate = (self.x, self.y, self.yaw)
        # >1 runs that many perception ticks as one batch
        # (mapping/perception.py: one ray-cast launch, one host transfer);
        # the robot is stationary between control decisions, so batched
        # semantics match the sequential path exactly
        self.perception_batch = max(1, int(perception_batch))
        # perception keeps running while the robot drives (the reference's
        # nodes are concurrent with Nav2): one transit tick per this many
        # sim seconds along every navigation segment, run as one batch
        # (<=0 disables; run_static disables — scripted missions have no
        # perception stack)
        self.transit_tick_period = float(transit_tick_period)
        self._transit_enabled = True

        self.vscanner = VirtualScanner(self.cfg.lidar, self.device)
        self.vscanner.set_map(scene_map.occupancy_grid(map_resolution))
        # removed-evidence wall gate: residual pose error during transit
        # flickers wall corners as "removed" (they pass the selector's bbox
        # thin test); true removals are SMALL map components, walls large
        self._removed_wall_filter = StaticWallFilter(self.vscanner._map)
        self.detector = ChangeDetector(self.cfg.change_detect, self.cfg.lidar,
                                       self.device)
        self.tracker = ObjectTracker(self.cfg.tracker)
        self.removed_tracker = ObjectTracker(self.cfg.tracker)
        self.sender = GoalSender(self.cfg.mission)
        self.dataset = CaptureDataset(os.path.join(workdir, "dataset"),
                                      self.cfg.camera)
        self.scanner = ScannerNode(
            self.dataset, self._grab_frames, self._camera_pose,
            sleep=self._sleep, cfg=self.cfg.mission)
        self.manager = SystemManager(
            self._navigate, self._scan_action, self._set_tracking,
            self.cfg.mission)
        # unreachable visiting points (circle segments inside geometry) get
        # skipped after repeated nav failures instead of livelocking
        self.manager.nav_failure_cb = self.sender.report_nav_failure
        self.summary = MissionSummary()
        # observability: per-tick state trace (the RViz-marker equivalent)
        self.trace: List[dict] = []

    # --- injected robot/sensor plumbing ------------------------------------

    def _sleep(self, seconds: float) -> None:
        self.t += seconds

    def _set_tracking(self, enabled: bool) -> None:
        self.tracker.set_tracking_mode(enabled)
        self.removed_tracker.set_tracking_mode(enabled)

    def _goal_in_collision(self, gx: float, gy: float,
                           robot_radius: float = 0.1) -> bool:
        """True if the goal stands inside a world solid (walls included) or
        outside the room — Nav2's planner fails such goals; the kinematic
        teleport must not drive through geometry (a robot parked inside a
        wall produces degenerate scans that can wreck localization)."""
        xmin, xmax, ymin, ymax = self.scene_world.room
        if not (xmin + robot_radius < gx < xmax - robot_radius
                and ymin + robot_radius < gy < ymax - robot_radius):
            return True
        for s in self.scene_world.objects:
            if isinstance(s, Box):
                c, sn = np.cos(-s.yaw), np.sin(-s.yaw)
                lx = (gx - s.center[0]) * c - (gy - s.center[1]) * sn
                ly = (gx - s.center[0]) * sn + (gy - s.center[1]) * c
                if (abs(lx) <= s.size[0] / 2 + robot_radius
                        and abs(ly) <= s.size[1] / 2 + robot_radius):
                    return True
            else:  # cylinder/cone footprint
                if (np.hypot(gx - s.center[0], gy - s.center[1])
                        <= s.radius + robot_radius):
                    return True
        return False

    def _navigate(self, gx: float, gy: float, gyaw: float) -> bool:
        if (self._fault_rng.random() < self.nav_failure_rate
                or self._goal_in_collision(gx, gy)):
            self.nav_failures += 1
            self.t += 2.0  # failed attempt still costs time
            return False
        d = float(np.hypot(gx - self.x, gy - self.y))
        if (self._transit_enabled and self.transit_tick_period > 0
                and d > 1e-6):
            self._transit_perception(gx, gy, d)   # advances t along the way
            self.t += 1.0                         # final alignment/settle
        else:
            self.t += d / self.robot_speed + 1.0
        self.x, self.y, self.yaw = float(gx), float(gy), float(gyaw)
        if self.odom_noise_per_m > 0.0 and d > 0:
            self._odom_drift += self._fault_rng.normal(
                0.0, self.odom_noise_per_m * d, 3) * np.array([1, 1, 0.5])
        # localization runs continuously: refresh the believed pose on
        # arrival (captures happen right after navigation)
        real, angles = self._real_scan()
        self.pose_estimate = self._estimate_pose(real, angles)
        return True

    def _body_pose(self) -> np.ndarray:
        """Body pose as the system BELIEVES it (estimate, not ground truth) —
        capture files carry this, like TF would on the reference robot."""
        ex, ey, eyaw = self.pose_estimate
        R2 = yaw_to_matrix2d(eyaw)
        R = np.eye(3)
        R[:2, :2] = R2
        return se3(R, [ex, ey, self.camera_height])

    def _true_body_pose(self) -> np.ndarray:
        R2 = yaw_to_matrix2d(self.yaw)
        R = np.eye(3)
        R[:2, :2] = R2
        return se3(R, [self.x, self.y, self.camera_height])

    def _optical_pose(self) -> np.ndarray:
        """TRUE optical camera->world pose for rendering: forward-mounted
        camera (optical z = body +x), via the body-frame axis map T_FIX_GT
        (reconstruct_rgbd_gt.py:52-57)."""
        return self._true_body_pose() @ T_FIX_GT

    def _camera_pose(self) -> np.ndarray:
        """Pose written to disk: the system's BELIEVED optical pose, encoded
        so the standard reconstruction pipeline (right-multiply
        T_FIX_OPTICAL, then invert — reconstruct_rgbd.py:93-96) recovers it
        exactly. With odometry noise this carries the estimate's error,
        exactly like TF on the reference robot."""
        return self._body_pose() @ T_FIX_GT @ T_FIX_OPTICAL.T

    def _grab_frames(self):
        if self._fault_rng.random() < self.camera_failure_rate:
            self.camera_failures += 1
            return None  # scanner aborts with "Camera Timeout"
        depth, color = render_rgbd(self.scene_world, self._optical_pose(),
                                   self.intr, far=self.cfg.camera.depth_max,
                                   device=self.device)
        return (color.cpu().numpy().astype(np.uint8), depth.cpu().numpy())

    def _scan_action(self, label, x, y, radius) -> bool:
        res = self.scanner.execute(ScanObjectGoal(label, x, y, radius))
        if res.success:
            self.summary.frames_captured += 1
            self.summary.capture_sequence.append(label)
            if label not in self.summary.labels:
                self.summary.labels.append(label)
        return res.success

    # --- perception tick ----------------------------------------------------

    def _real_scan(self):
        """The LiDAR scan at the true pose, on the device, and the angles."""
        angles = self.vscanner.angles()
        real = render_lidar(self.scene_world, self.x, self.y, self.yaw,
                            angles, self.cfg.lidar.range_min,
                            self.cfg.lidar.range_max, device=self.device)
        return real, angles

    def _estimate_pose(self, real, angles):
        """Reported pose: true + accumulated odometry drift, optionally
        corrected by scan-to-map ICP against the saved map."""
        odom = (self.x + self._odom_drift[0], self.y + self._odom_drift[1],
                self.yaw + self._odom_drift[2])
        if not self.use_localizer:
            return odom
        if self._localizer is None:
            from otslam_tpu_torch.mapping.localize import ScanLocalizer
            self._localizer = ScanLocalizer(self.vscanner._map,
                                            device=self.device)
        res = self._localizer.localize(real, angles, odom)
        return (res.x, res.y, res.yaw)

    def perception_tick(self) -> None:
        dt = 1.0 / self.cfg.lidar.rate_hz
        self.t += dt
        real, angles = self._real_scan()
        self.pose_estimate = self._estimate_pose(real, angles)
        virt = self.vscanner.scan(*self.pose_estimate)
        self.detector.on_virtual_scan(virt)
        self.detector.on_scan(real, angles, self.pose_estimate, self.t)
        self._post_perception(self.detector.added_objects(),
                              self.detector.removed_objects())

    def perception_tick_batch(self, k: int) -> None:
        """K stationary perception ticks as one batch
        (mapping/perception.perception_ticks). The robot does not move
        between control decisions, so the scan/pose are constant across the
        batch; evidence time steps replicate the sequential bookkeeping
        exactly (including the large post-navigation dt)."""
        dt = 1.0 / self.cfg.lidar.rate_hz
        real, angles = self._real_scan()
        self.pose_estimate = self._estimate_pose(real, angles)
        times = self.t + dt * (1.0 + np.arange(k))
        self._run_tick_batch(
            real[None].expand(k, -1),
            np.tile(np.asarray(self.pose_estimate, np.float32)[None],
                    (k, 1)), times)

    def _run_tick_batch(self, reals, believed: np.ndarray,
                        times: np.ndarray, true_poses=None) -> None:
        """Shared core of the batched perception paths: K ticks on the
        device given per-tick scans and believed poses, then the per-tick
        host control-plane updates. ``true_poses`` moves the actual robot
        along the batch (navigation transit)."""
        k = len(times)
        last = self.detector._last_time
        dts = np.diff(np.concatenate(
            [[times[0] if last is None else last], times]))
        g = self.vscanner._map
        angles = self.vscanner.angles()
        # detection capacity: whole grid when small, else 2048 (~2.5x the
        # cell count of two 1 m^2 objects at the 5 cm evidence resolution) —
        # the default 256 could truncate what the sequential path reports
        cap = int(self.detector.new_grid.shape[0]
                  * self.detector.new_grid.shape[1])
        dev = self.device
        batch = perception_ticks(
            self.vscanner.grid, float(g.resolution), float(g.origin[0]),
            float(g.origin[1]), self.detector.new_grid,
            self.detector.gone_grid, reals,
            torch.as_tensor(np.asarray(believed, np.float32), device=dev),
            torch.as_tensor(np.asarray(dts, np.float32), device=dev), angles,
            self.detector.cfg, float(self.cfg.lidar.range_max),
            max_points=min(cap, 2048))
        self.detector.new_grid = batch.new_grid
        self.detector.gone_grid = batch.gone_grid
        self.detector._last_time = float(times[-1])
        self.detector._last_virtual = batch.virtual[-1]
        # one transfer for all four results: points and counts packed
        # into one f32 tensor (counts <= 2048 are exact in f32)
        p = batch.added_pts.shape[1]
        host = torch.cat([batch.added_pts.reshape(k, -1),
                          batch.removed_pts.reshape(k, -1),
                          batch.added_cnt[:, None].to(torch.float32),
                          batch.removed_cnt[:, None].to(torch.float32)],
                         dim=1).cpu().numpy()
        apts = host[:, :2 * p].reshape(k, p, 2)
        rpts = host[:, 2 * p:4 * p].reshape(k, p, 2)
        acnt = host[:, 4 * p].astype(np.int64)
        rcnt = host[:, 4 * p + 1].astype(np.int64)
        for i in range(k):
            self.t = float(times[i])
            if true_poses is not None:
                self.x, self.y, self.yaw = map(float, true_poses[i])
                self.pose_estimate = tuple(map(float, believed[i]))
            self._post_perception(apts[i][:acnt[i]], rpts[i][:rcnt[i]])

    def _transit_perception(self, gx: float, gy: float, d: float) -> None:
        """Perception DURING navigation: the reference stack keeps scanning
        while Nav2 drives (its nodes are concurrent), which is how evidence
        for far group members accumulates; a blocking teleport would leave
        the trackers fed only by what was visible before the first mission.
        Steps the pose along the straight segment at transit_tick_period,
        rendering all scans in one batch (render_lidar_path) and running
        all ticks as one perception batch. Tick counts bucket to powers of
        two, as in the JAX package (where it bounds compile variants): the
        pad ticks are real perception ticks at the destination and change
        the evidence grids, so the bucketing stays to keep what the mission
        detects. Odometry drift accrues at arrival as before."""
        dur = d / self.robot_speed
        n_real = max(1, int(np.ceil(dur / self.transit_tick_period)))
        n = 1
        while n < min(n_real, 64):
            n *= 2
        travel_yaw = float(np.arctan2(gy - self.y, gx - self.x))
        frac = np.minimum(np.arange(1, n + 1) / min(n_real, n), 1.0)
        xs = self.x + frac * (gx - self.x)
        ys = self.y + frac * (gy - self.y)
        yaws = np.full(n, travel_yaw)
        true_poses = np.stack([xs, ys, yaws], axis=1)
        # believed transit poses carry the CURRENT estimate's error (the
        # localized pose at departure), not the raw accumulated odometry
        # drift: localization runs continuously on the reference robot, so
        # transit pose error stays localizer-small. Using raw drift here
        # smeared the evidence grids and spawned phantom removed-object
        # sites on long missions. Fresh drift still accrues at arrival.
        est_err = (np.asarray(self.pose_estimate, np.float64)
                   - np.array([self.x, self.y, self.yaw]))
        believed = true_poses + est_err[None]
        times = self.t + (dur / n) * (1.0 + np.arange(n))
        reals = render_lidar_path(
            self.scene_world, xs, ys, yaws, self.vscanner.angles(),
            self.cfg.lidar.range_min, self.cfg.lidar.range_max,
            device=self.device)
        self._run_tick_batch(reals, believed, times, true_poses=true_poses)

    def _post_perception(self, added: np.ndarray, removed: np.ndarray):
        """Host-side control-plane updates after one perception tick."""
        self.tracker.update(added, self.t)
        self.removed_tracker.update(
            self._removed_wall_filter.filter(removed), self.t)

        self.sender.on_odom(self.pose_estimate[0], self.pose_estimate[1])
        self.sender.on_added_points(
            visiting_points(self.tracker.stable_objects, self.cfg.tracker))
        self.sender.on_removed_points(
            visiting_points(self.removed_tracker.stable_objects,
                            self.cfg.tracker, removed=True))
        self.trace.append({
            "t": round(self.t, 2),
            "robot": (round(self.x, 3), round(self.y, 3), round(self.yaw, 3)),
            "candidates": len(self.tracker.candidates),
            "stable": [(round(s.cx, 3), round(s.cy, 3))
                       for s in self.tracker.stable_objects],
            "removed_stable": [(round(s.cx, 3), round(s.cy, 3))
                               for s in self.removed_tracker.stable_objects],
            "pending_goals": self.sender.pending_count(),
            "frozen": not self.tracker.tracking_enabled,
        })

    # --- main loop ----------------------------------------------------------

    def run_static(self, goals, max_steps: int = 100) -> MissionSummary:
        """Scripted mission from a static goal list (goal_list.hpp:16-22).

        No perception or tracking: the queue is seeded once with the
        scripted targets and the identical GoalSender -> manager FSM ->
        scanner path executes them nearest-first. Captures are saved under
        each goal's own label.
        """
        from otslam_tpu_torch.mission.goal_list import as_targets

        self._transit_enabled = False   # scripted: no perception stack
        self.manager.label_lookup = {g.id: g.label for g in goals}
        self.sender.added_targets = as_targets(goals)
        for _ in range(max_steps):
            self.sender.on_odom(self.x, self.y)
            goal = self.sender.control_step()
            if goal is not None:
                if self.manager.on_goal(goal):
                    self.summary.missions_completed += 1
            elif self.sender.pending_count() == 0:
                break
        self.summary.sim_time = self.t
        return self.summary

    def run(self, max_ticks: int = 200, settle_ticks: int = 25,
            min_ticks: int = 75) -> MissionSummary:
        """Run perception + mission until targets are exhausted.

        min_ticks gives detection + tracker stabilization time (dwell
        time_threshold + stability_time) before an idle loop may terminate.
        """
        pb = self.perception_batch
        for done in range(0, settle_ticks, pb):
            if pb > 1:
                self.perception_tick_batch(min(pb, settle_ticks - done))
            else:
                self.perception_tick()
        idle_ticks = 0
        idle_passes = 0
        for tick in range(0, max_ticks, pb):
            if pb > 1:
                self.perception_tick_batch(pb)
            else:
                self.perception_tick()
            goal = self.sender.control_step()
            if goal is not None:
                if self.manager.on_goal(goal):
                    self.summary.missions_completed += 1
                idle_ticks = 0
                idle_passes = 0
            else:
                # queue empty + manager idle = the same state as the
                # initial live search (the reference boots with tracking
                # enabled to find the first object, manager_node.cpp:67-78):
                # re-enable tracking so evidence that accumulated while
                # frozen (scans/transits of earlier missions) can surface
                # as new objects — otherwise the post-first-scan freeze
                # persists forever and anything confirmed later is
                # deadlocked out of the mission
                if self.sender.pending_count() == 0:
                    self._set_tracking(True)
                # idle shutdown needs BOTH >10 ticks of idle sim time AND
                # >=3 idle control passes: at large perception batches one
                # pass already covers >10 ticks, and a single idle pass can
                # coincide with a transiently-pruned tracked object (e.g. a
                # removed-object site occluded from the current pose) whose
                # targets would reappear next pass
                idle_ticks += pb
                idle_passes += 1
                if (idle_ticks > 10 and idle_passes >= 3
                        and self.sender.pending_count() == 0
                        and tick >= min_ticks):
                    break
        self.summary.stable_objects = len(self.tracker.stable_objects)
        self.summary.sim_time = self.t
        return self.summary
