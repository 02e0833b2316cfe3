"""The estimated-pose mission run in both packages, for
test_torch_production.py (cardboard) and test_torch_full_room.py.

MissionRunner with drifting odometry (0.01 m of noise a metre), the
scan-to-map localizer and a phantom `removed_box` at (4, -4) in the saved
map (the `mission` CLI's --odom-noise, --localizer and --removed), at
160x120, 1440 beams and perception batch 5. The mission's decisions are
held equal; the pose estimate and every believed capture pose on disk
within POSE_ATOL m and rad. Those poses differ only through the localizer:
both packages' ICP on one identical scan already differs by up to ~5e-4 m
(test_torch_full_room.py), since the map cloud is a lattice of cell
centres and JAX's XLA nearest neighbour (|a|^2 + |b|^2 - 2ab) breaks its
near-ties otherwise. Every localization starts from the odometry prior,
so the gap does not accumulate over ticks.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import types

import numpy as np
import pytest

import otslam_tpu.config as jcfg
import otslam_tpu.sim.runner as jrunner
import otslam_tpu.sim.world as jworld
import otslam_tpu_torch.config as tcfg
import otslam_tpu_torch.sim.runner as trunner
import otslam_tpu_torch.sim.world as tworld

import torch_parity  # noqa: F401  (one torch thread per test process)

JAX = types.SimpleNamespace(cfg=jcfg, runner=jrunner, world=jworld, kw={})
PORT = types.SimpleNamespace(cfg=tcfg, runner=trunner, world=tworld,
                             kw={"device": "cpu"})
PHANTOM = ((4.0, -4.0, 0.15), (0.5, 0.4, 0.3), 0.0, (0.7, 0.7, 0.7),
           "removed_box")
STARTS = {"cardboard_room": (-2.0, -2.0, 0.5),   # the mission CLI's
          "full_room": (0.5, 4.5, 0.0)}          # MISSION_r04.json's
POSE_ATOL = 1e-3                                 # m and rad
SUMMARY_FIELDS = ("missions_completed", "frames_captured", "stable_objects",
                  "labels", "capture_sequence")


def small_config(pkg):
    c = pkg.cfg
    cam = c.CameraConfig(width=160, height=120, fx=141.4002, fy=141.4002,
                         cx=80.5, cy=60.5)
    return c.OTSLAMConfig(camera=cam, lidar=c.LidarConfig(),
                          tracker=c.TrackerConfig.update_pipeline_profile())


def estimated_pose_mission(pkg, scene: str, workdir, ticks: int):
    """One package's runner on `scene` with the phantom in its saved map,
    run for `ticks`; returns (runner, summary)."""
    world = getattr(pkg.world, scene)()
    runner = pkg.runner.MissionRunner(
        scene_map=dataclasses.replace(
            world, objects=(pkg.world.Box(*PHANTOM),)),
        scene_world=world, workdir=str(workdir), cfg=small_config(pkg),
        start_pose=STARTS[scene], odom_noise_per_m=0.01, use_localizer=True,
        perception_batch=5, **pkg.kw)
    return runner, runner.run(max_ticks=ticks)


def capture_poses(workdir) -> dict:
    """{file name: 4x4 believed map->body pose} of a mission's captures."""
    return {os.path.basename(f): np.loadtxt(f) for f in sorted(glob.glob(
        os.path.join(str(workdir), "dataset", "poses", "*.txt")))}


def rotation_angle(a: np.ndarray, b: np.ndarray) -> float:
    """The angle (rad) of the rotation between two poses' rotations, from
    both the sine and the cosine of the relative rotation: arccos of the
    trace alone reads the 6-decimal rounding of the files on disk as
    ~1e-3 rad."""
    r = a[:3, :3].T @ b[:3, :3]
    w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return float(np.arctan2(np.linalg.norm(w) / 2, (np.trace(r) - 1) / 2))


def assert_missions_match(jr, js, jdir, tr, ts, tdir) -> dict:
    """The two runs' decisions equal, their poses within POSE_ATOL.
    Returns the largest pose differences seen."""
    for f in SUMMARY_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.sim_time == pytest.approx(js.sim_time, abs=1e-6)
    assert tr.sender.visited_removed_ids == jr.sender.visited_removed_ids
    np.testing.assert_allclose((tr.x, tr.y, tr.yaw), (jr.x, jr.y, jr.yaw),
                               rtol=0, atol=1e-6)
    est = np.abs(np.subtract(tr.pose_estimate, jr.pose_estimate))
    assert est.max() <= POSE_ATOL, est
    jp, tp = capture_poses(jdir), capture_poses(tdir)
    assert sorted(tp) == sorted(jp) and len(tp) == ts.frames_captured
    moved = max((float(np.abs(tp[k][:3, 3] - jp[k][:3, 3]).max())
                 for k in tp), default=0.0)
    turned = max((rotation_angle(tp[k], jp[k]) for k in tp), default=0.0)
    assert moved <= POSE_ATOL and turned <= POSE_ATOL, (moved, turned)
    return {"estimate": float(est.max()), "captures_m": moved,
            "captures_rad": turned}
