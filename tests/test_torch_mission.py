"""The mission slice of otslam_tpu_torch against otslam_tpu: the copied
control plane (tracker, visiting points, goal queue, manager, clustering,
filters, goal lists, removed-object check points), MissionRunner with
sequential and batched perception, its captures through the port's
reconstruct_object, all on the CPU (the `mission` CLI is in
test_torch_mission_cli.py).

The control plane is numpy in both packages, so its outputs are held equal.
The runner is held to equal MissionSummary fields and stable centres within
1e-3 m: its LiDAR scans come from each package's own renderer (within 1e-5
of each other), and its evidence grids within 1e-6.
"""

import dataclasses
import types

import numpy as np
import pytest

import otslam_tpu.config as jcfg
import otslam_tpu.mapping.object_filter as jof
import otslam_tpu.mission as jmission
import otslam_tpu.sim.runner as jrunner
import otslam_tpu.sim.world as jworld
import otslam_tpu_torch.config as tcfg
import otslam_tpu_torch.mapping.object_filter as tof
import otslam_tpu_torch.mission as tmission
import otslam_tpu_torch.sim.runner as trunner
import otslam_tpu_torch.sim.world as tworld
from otslam_tpu.kernels import cluster as jcluster
from otslam_tpu_torch.kernels import cluster as tcluster
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.pipeline.reconstruct import reconstruct_object

import torch_parity  # noqa: F401  (one torch thread per test process)

JAX = types.SimpleNamespace(cfg=jcfg, mission=jmission, runner=jrunner,
                            world=jworld, filters=jof, kw={})
PORT = types.SimpleNamespace(cfg=tcfg, mission=tmission, runner=trunner,
                             world=tworld, filters=tof, kw={"device": "cpu"})
BOX = (1.5, 0.5, 0.15), (0.5, 0.4, 0.3), 0.3, (0.76, 0.6, 0.42), "box"
START = (-0.5, 1.5, -1.2)       # sees the box (test_perception_batch.py)


def blob(rng, cx, cy, w=0.5, h=0.4, n=40):
    return np.stack([rng.uniform(cx - w / 2, cx + w / 2, n),
                     rng.uniform(cy - h / 2, cy + h / 2, n)], -1)


def drive_control_plane(pkg):
    """One scripted sequence through a package's tracker -> visiting points
    -> goal queue -> manager, with a fake robot: a log of every output."""
    m, c = pkg.mission, pkg.cfg
    rng = np.random.default_rng(0)
    tracker = m.ObjectTracker(c.TrackerConfig.update_pipeline_profile())
    removed = m.ObjectTracker(c.TrackerConfig.update_pipeline_profile())
    sender = m.GoalSender(c.MissionConfig())
    log = []
    robot = [0.0, 0.0]

    def nav(x, y, yaw):
        log.append(("nav", x, y, yaw))
        robot[:] = [x, y]
        return len(log) % 7 != 0          # every few calls fail

    def scan(label, x, y, r):
        log.append(("scan", label, x, y, r))
        return True

    manager = m.SystemManager(nav, scan, lambda on: (
        tracker.set_tracking_mode(on), removed.set_tracking_mode(on),
        log.append(("track", on))), c.MissionConfig())
    manager.nav_failure_cb = sender.report_nav_failure
    t = 0.0
    for tick in range(60):
        t += 0.2
        pts = [blob(rng, 2.0, 1.0)]
        if tick > 10:
            pts.append(blob(rng, -1.5, 2.5, 0.6, 0.6))
        if tick % 9 == 0:
            pts.append(blob(rng, 0.0, -3.0, 0.05, 2.0))     # a thin wall
        tracker.update(np.concatenate(pts), t)
        removed.update(blob(rng, 3.5, -2.0) if tick > 20 else [], t)
        sender.on_odom(*robot)
        vps = m.visiting_points(tracker.stable_objects, tracker.cfg)
        rvps = m.visiting_points(removed.stable_objects, removed.cfg,
                                 removed=True)
        sender.on_added_points(vps)
        sender.on_removed_points(rvps)
        goal = sender.control_step()
        if goal is not None:
            log.append(("goal", dataclasses.asdict(goal),
                        manager.on_goal(goal), manager.state.name))
        log.append(("tick", [dataclasses.asdict(x) for x in
                             tracker.candidates + tracker.stable_objects],
                    [dataclasses.asdict(v) for v in vps + rvps],
                    sender.pending_count(),
                    sorted(sender.visited_removed_ids)))
    return log


def test_control_plane_matches_jax():
    jlog, tlog = drive_control_plane(JAX), drive_control_plane(PORT)
    assert tlog == jlog
    kinds = {e[0] for e in tlog}
    assert {"nav", "scan", "track", "goal"} <= kinds


def test_clustering_and_check_points_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    pts = np.concatenate([blob(rng, 0, 0), blob(rng, 3, 1), blob(rng, 0.5, 0)])
    rng.shuffle(pts)
    for fn in ("cluster_points_host", "cluster_points_spatial_host"):
        for thr in (0.1, 0.4):
            jl, jn = getattr(jcluster, fn)(pts, thr, 8)
            tl, tn = getattr(tcluster, fn)(pts, thr, 8)
            np.testing.assert_array_equal(tl, jl)
            assert tn == jn
    cfg = jmission.RemovedCheckConfig()
    for robot in ((0.0, 0.0), (4.0, 2.0)):
        jc = jmission.nearest_check_point(pts, robot, cfg)
        tc = tmission.nearest_check_point(pts, robot,
                                          tmission.RemovedCheckConfig())
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for a, b in zip(tmission.bfs_clusters(pts, 0.3, 5),
                    jmission.bfs_clusters(pts, 0.3, 5)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    path = tmp_path / "goals.txt"
    jmission.save_goal_list(jmission.default_goal_list(), path)
    goals = tmission.load_goal_list(path)
    assert ([dataclasses.asdict(g) for g in goals]
            == [dataclasses.asdict(g) for g in jmission.load_goal_list(path)])
    assert ([dataclasses.asdict(x) for x in tmission.as_targets(goals)]
            == [dataclasses.asdict(x) for x in jmission.as_targets(
                jmission.load_goal_list(path))])


def test_object_filters_match_jax():
    grid_j = jworld.cardboard_room().occupancy_grid(0.05)
    grid_t = tworld.cardboard_room().occupancy_grid(0.05)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5.5, 5.5, (400, 2)).astype(np.float32)
    np.testing.assert_array_equal(tof.StaticWallFilter(grid_t).filter(pts),
                                  jof.StaticWallFilter(grid_j).filter(pts))
    ranges = rng.uniform(0.5, 4.0, 90).astype(np.float32)
    ranges[::7] = np.inf
    angles = np.linspace(0, 2 * np.pi, 90, endpoint=False).astype(np.float32)
    jw, tw = jof.WallProximityFilter(), tof.WallProximityFilter(device="cpu")
    assert len(tw.filter(pts)) == 0                # no wall data yet
    for f in (jw, tw):
        f.on_virtual_scan(ranges, angles, (0.3, -0.2, 0.4))
    kept = tw.filter(pts)
    np.testing.assert_array_equal(kept, jw.filter(pts))
    assert 0 < len(kept) < len(pts)


def run_mission(pkg, workdir, perception_batch, max_ticks=150):
    c = pkg.cfg
    cam = c.CameraConfig(width=160, height=120, fx=141.4002, fy=141.4002,
                         cx=80.5, cy=60.5)
    cfg = c.OTSLAMConfig(camera=cam, lidar=c.LidarConfig(num_beams=360),
                         tracker=c.TrackerConfig.update_pipeline_profile())
    runner = pkg.runner.MissionRunner(
        pkg.world.Scene(objects=()),
        pkg.world.Scene(objects=(pkg.world.Box(*BOX),)), str(workdir), cfg,
        start_pose=START, perception_batch=perception_batch, **pkg.kw)
    return runner, runner.run(max_ticks=max_ticks)


@pytest.mark.parametrize("perception_batch", [1, 5])
def test_mission_runner_matches_jax(perception_batch, tmp_path):
    jr, js = run_mission(JAX, tmp_path / "jax", perception_batch)
    tr, ts = run_mission(PORT, tmp_path / "torch", perception_batch)
    for f in ("missions_completed", "frames_captured", "stable_objects",
              "labels", "capture_sequence"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.sim_time == pytest.approx(js.sim_time, abs=1e-9)
    assert len(tr.trace) == len(jr.trace)
    np.testing.assert_allclose(
        [(s.cx, s.cy) for s in tr.tracker.stable_objects],
        [(s.cx, s.cy) for s in jr.tracker.stable_objects], atol=1e-3)
    assert ts.stable_objects == 1 and ts.missions_completed >= 4
    # the captures: the same believed poses on disk in both packages
    tds = CaptureDataset(str(tmp_path / "torch" / "dataset"))
    jds = CaptureDataset(str(tmp_path / "jax" / "dataset"))
    tb, jb = tds.load_object("Object_0"), jds.load_object("Object_0")
    np.testing.assert_array_equal(tb.poses, jb.poses)
    assert tb.depths.shape == (ts.frames_captured, 120, 160)
    assert (tb.depths > 0).mean() > 0.2
    if perception_batch == 5:
        # the mission's captures through the port's reconstruction
        rcfg = tcfg.ReconstructionConfig(
            camera=tcfg.CameraConfig(width=160, height=120, fx=141.4002,
                                     fy=141.4002, cx=80.5, cy=60.5),
            tsdf=tcfg.TSDFConfig(dims=(128, 128, 64),
                                 origin=(0.9, -0.1, -0.1)),
            surface_samples=20000)
        res = reconstruct_object(CaptureDataset(tds.root, rcfg.camera),
                                 "Object_0", rcfg, device="cpu")
        assert len(res.points) > 5000 and np.isfinite(res.points).all()
        # distance of the points to the true (yawed) box surface
        p = res.points - np.array(BOX[0])
        c, s = np.cos(-0.3), np.sin(-0.3)
        local = np.stack([p[:, 0] * c - p[:, 1] * s,
                          p[:, 0] * s + p[:, 1] * c, p[:, 2]], -1)
        q = np.abs(local) - np.array([0.25, 0.2, 0.15])
        sdf = (np.linalg.norm(np.maximum(q, 0), axis=1)
               + np.minimum(np.max(q, axis=1), 0))
        assert float(np.sqrt((sdf ** 2).mean())) < 0.02


def test_scripted_goal_list_mission_matches_jax(tmp_path):
    path = tmp_path / "goals.txt"
    jmission.save_goal_list(jmission.default_goal_list()[:2], path)
    out = []
    for pkg, name in ((JAX, "jax"), (PORT, "torch")):
        c = pkg.cfg
        cfg = c.OTSLAMConfig(camera=c.CameraConfig(
            width=80, height=60, fx=70.7, fy=70.7, cx=40.5, cy=30.5))
        world = pkg.world.cardboard_room()
        runner = pkg.runner.MissionRunner(
            world, world, str(tmp_path / name), cfg, start_pose=START,
            **pkg.kw)
        s = runner.run_static(pkg.mission.load_goal_list(path))
        out.append((s.missions_completed, s.frames_captured, s.labels,
                    s.capture_sequence, s.sim_time))
    assert out[0] == out[1]
    assert out[1][1] >= 1

