"""Driver of the mission cells: the closed-loop online mission run back to
back.

The benchmark hands the program's `MissionRunner` the scenes (the frozen
world and the saved map with its phantom removed box), a start pose and
an odometry-drift seed; everything else is the program's own simulator.
The traffic's pool of missions runs in whole rounds (every mission once a
round, in a seeded order) while the window lasts: the round running at its
end runs to its end and counts, so every seed asks for the same work. Each
mission's time runs from the runner's construction to the end of `run`;
its workdir lies under the temporary directory and is deleted after it.

While the window runs, thin wrappers around the runner's perception batch
(`sim.runner.perception_ticks`, `MissionRunner._run_tick_batch`) and pose
estimate (`MissionRunner._estimate_pose`) keep a seeded sample of their
inputs and outputs for the judge, copied when the sample keeps them, so
the judge holds whether or not the program updates its tensors in place.
Every mission's outcome is judged against the traffic's `outcome` limits
(tests/test_full_mission.py's gates). A traced run adds spans (a device
sync before and after) around the perception batch, the localizer and the
sensors, and profiles the first stretch of the window.
"""

from __future__ import annotations

import gc
import glob
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmark import harness
from benchmark.inputs.scene import Box, saved_map_scene, scene
from benchmark.reference.mission import (MissionReference, perception_gaps,
                                         range_gap)
from benchmark.trace import Trace


def program_config(cfg: dict):
    from otslam_tpu_torch.config import (CameraConfig, ChangeDetectConfig,
                                         LidarConfig, MissionConfig,
                                         OTSLAMConfig, TrackerConfig)
    cd = dict(cfg["change_detect"], grid_cells=tuple(
        cfg["change_detect"]["grid_cells"]))
    return OTSLAMConfig(camera=CameraConfig(**cfg["camera"]),
                        lidar=LidarConfig(**cfg["lidar"]),
                        change_detect=ChangeDetectConfig(**cd),
                        tracker=TrackerConfig(**cfg["tracker"]),
                        mission=MissionConfig(**cfg["mission"]))


def program_scene(frozen):
    """The frozen scene as the program's own scene classes."""
    from otslam_tpu_torch.sim import world as w
    objs = tuple(
        w.Box(o.center, o.size, o.yaw, o.color, o.name) if isinstance(o, Box)
        else w.Cone(o.center, o.radius, o.height, o.color, o.name)
        for o in frozen.objects)
    return w.Scene(objects=objs, room=frozen.room,
                   wall_height=frozen.wall_height,
                   wall_thickness=frozen.wall_thickness, floor=frozen.floor)


def copied(v):
    """A copy of a tensor or an array; anything else as it is."""
    if hasattr(v, "clone"):
        return v.clone()
    return v.copy() if isinstance(v, np.ndarray) else v


def outcome(r, s, workdir: str, traffic: dict) -> dict:
    """A finished mission's outcome, as tests/test_full_mission.py reads
    it: missions and labels completed, frames short of the labels, the
    largest group's members, the removed-object checks and whether the
    phantom was found, the capture sites missed, the final pose error."""
    ph = traffic["phantom"]
    found = any(np.hypot(o.cx - ph["at"][0], o.cy - ph["at"][1])
                < ph["within"] for o in r.removed_tracker.stable_objects)
    groups = r.tracker.stable_objects
    orbits = []
    for label in s.labels:
        ps = [np.loadtxt(f) for f in sorted(glob.glob(os.path.join(
            workdir, "dataset", "poses", f"{label}_*.txt")))]
        if ps:
            c = np.mean([q[:2, 3] for q in ps], axis=0)
            orbits.append((c, np.mean([np.linalg.norm(q[:2, 3] - c)
                                       for q in ps])))
    missed = sum(
        not any(np.linalg.norm(c - np.asarray(t)) < site["within"]
                and rad < site["radius_under"]
                for c, rad in orbits for t in site["any_of"])
        for site in traffic["sites"])
    ex, ey, _ = r.pose_estimate
    return {"missions": s.missions_completed, "labels": len(s.labels),
            "frames_short": max(0, len(s.labels) - s.frames_captured),
            "group_members": max((len(g.members) for g in groups),
                                 default=0),
            "removed_checks": len(r.sender.visited_removed_ids),
            "phantom_found": int(found), "sites_missed": missed,
            "pose_error_m": float(np.hypot(ex - r.x, ey - r.y))}


class Recorder:
    """The seeded sample of perception batches and pose estimates, and the
    spans of a traced run, installed on the program's modules."""

    def __init__(self, traffic, seed, spans, on_batch):
        from otslam_tpu_torch.mapping import localize
        from otslam_tpu_torch.pipeline import dataset
        from otslam_tpu_torch.sim import runner
        self.batches = harness.Reservoir(traffic["judged_batches"], seed)
        self.locs = harness.Reservoir(traffic["judged_localizations"],
                                      seed + 1)
        self.saved = []
        self._true = None

        def keep(mod, name, fn):
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

        orig_pt = runner.perception_ticks
        orig_batch = runner.MissionRunner._run_tick_batch
        orig_est = runner.MissionRunner._estimate_pose
        span_pt = spans.wrap("perception", orig_pt)

        def perception_ticks(grid, res, ox, oy, new_grid, gone_grid, reals,
                             poses, dts, angles, cfg, range_max,
                             max_points=256):
            put = self.batches.slot("batch")
            if put is not None:        # the inputs as the call receives them
                kept = dict(new_grid=new_grid.clone(),
                            gone_grid=gone_grid.clone(), reals=reals.clone(),
                            poses=copied(poses), dts=copied(dts),
                            max_points=max_points, true=self._true)
            out = span_pt(grid, res, ox, oy, new_grid, gone_grid, reals,
                          poses, dts, angles, cfg, range_max,
                          max_points=max_points)
            if put is not None:
                put(dict(kept, out={k: copied(v)
                                    for k, v in out._asdict().items()}))
            on_batch()
            return out

        def run_tick_batch(rself, reals, believed, times, true_poses=None):
            self._true = (np.asarray(true_poses, np.float64)
                          if true_poses is not None else
                          np.tile([rself.x, rself.y, rself.yaw],
                                  (len(times), 1)))
            return orig_batch(rself, reals, believed, times, true_poses)

        def estimate_pose(rself, real, angles):
            put = self.locs.slot("loc")
            if put is not None:
                kept = dict(real=real.clone(), true=(rself.x, rself.y,
                                                     rself.yaw),
                            drift=rself._odom_drift.copy())
            est = orig_est(rself, real, angles)
            if put is not None:
                put(dict(kept, est=tuple(float(v) for v in est)))
            return est

        keep(runner, "perception_ticks", perception_ticks)
        keep(runner.MissionRunner, "_run_tick_batch", run_tick_batch)
        keep(runner.MissionRunner, "_estimate_pose", estimate_pose)
        if spans.enabled:
            keep(localize.ScanLocalizer, "localize",
                 spans.wrap("localize", localize.ScanLocalizer.localize))
            for name in ("render_lidar", "render_lidar_path", "render_rgbd"):
                keep(runner, name, spans.wrap("sensors", getattr(runner,
                                                                 name)))
            keep(dataset.CaptureDataset, "save_frame",
                 spans.wrap("sensors", dataset.CaptureDataset.save_frame))

    def close(self):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)


def run(cfg, traffic, seed, seconds, trace, device, chips, t_start,
        control=False) -> dict:
    import torch
    from otslam_tpu_torch.sim.runner import MissionRunner

    pcfg = program_config(cfg)
    frozen = scene(traffic["scene"])
    world = program_scene(frozen)
    map_scene = program_scene(saved_map_scene(frozen, traffic["removed"]))
    rng = np.random.default_rng(seed)
    pool = traffic["missions"]
    rounds = harness.rounds(rng, list(range(len(pool))))
    root = os.path.join(tempfile.gettempdir(), "otslam_bench_mission")

    def mission(m, max_ticks):
        wd = os.path.join(root, "mission")
        shutil.rmtree(wd, ignore_errors=True)
        t0 = time.perf_counter()
        r = MissionRunner(
            scene_map=map_scene, scene_world=world, workdir=wd, cfg=pcfg,
            start_pose=tuple(pool[m]["start"]),
            camera_height=traffic["camera_height"],
            robot_speed=traffic["robot_speed"],
            map_resolution=cfg["map_resolution"],
            fault_seed=int(pool[m]["fault_seed"]),
            odom_noise_per_m=traffic["odom_noise_per_m"],
            use_localizer=traffic["localizer"],
            perception_batch=traffic["perception_batch"], device=device)
        s = r.run(max_ticks=max_ticks)
        harness.sync(device)
        wall = time.perf_counter() - t0
        got = outcome(r, s, wd, traffic)
        shutil.rmtree(wd, ignore_errors=True)
        return r, s, wall, got

    failed = 0
    try:
        mission(0, traffic["warmup_ticks"])       # warm-up
    except Exception as e:             # counts against the run
        failed += 1
        print(f"benchmark: warm-up mission failed: {e!r}", file=sys.stderr)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    spans = harness.Spans(device, trace)
    tracer = Trace(device) if trace and device.type == "cuda" else None
    stretch = {"summary": None, "t0": None}

    def on_batch():
        if (stretch["t0"] is not None and time.perf_counter() - stretch["t0"]
                >= traffic["trace_seconds"]):
            stretch["summary"] = tracer.stop()
            stretch["t0"] = None

    rec = Recorder(traffic, seed, spans, on_batch)
    limits = dict(cfg["limits"], **traffic["outcome"])
    checks = harness.Checks(limits)
    ticks, mission_s, done = 0, 0.0, 0
    gc.collect()                       # the window starts from a clean heap
    t0 = time.perf_counter()
    deadline = t0 + seconds
    if tracer is not None:
        tracer.start()
        stretch["t0"] = time.perf_counter()
    outcomes = []
    try:
        for rnd in rounds:
            for m in rnd:
                done += 1
                try:
                    r, s, wall, got = mission(m, traffic["max_ticks"])
                except Exception as e:  # a failed mission; the window goes on
                    failed += 1
                    print(f"benchmark: mission {m} failed: {e!r}",
                          file=sys.stderr)
                    continue
                ticks += len(r.trace)
                mission_s += wall
                for k, v in got.items():
                    checks.add(k, v)
                outcomes.append(dict(got, mission=m, ticks=len(r.trace),
                                     seconds=wall))
                del r
            if time.perf_counter() >= deadline:
                break
    finally:
        if stretch["t0"] is not None:
            stretch["summary"] = tracer.stop()
        rec.close()
    dev = harness.device_record(device, chips)
    shutil.rmtree(root, ignore_errors=True)

    # judge: each sampled batch and estimate against the reference
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sides = [(MissionReference(cfg, traffic, device), checks)]
    ctl = None
    if control:
        ctl = harness.Checks(limits)
        for o in outcomes:             # the control replaces the judge only
            for k in traffic["outcome"]:
                ctl.add(k, o[k])
        sides.append((MissionReference(cfg, traffic, device,
                                       dtype=torch.bfloat16), ctl))
    judged = 0
    for _, b in rec.batches.items():
        judged += 1
        reals_np = b["reals"].float().cpu().numpy()
        for ref, ch in sides:
            gap, off = range_gap(
                reals_np, ref.real_scans(b["true"]).float().cpu().numpy())
            ch.add("real_scan_gap_m", gap)
            ch.add("real_beams_off", off)
            out = ref.perception(b["new_grid"], b["gone_grid"],
                                 b["reals"].float(), b["poses"], b["dts"],
                                 b["max_points"])
            for k, v in perception_gaps(b["out"], out).items():
                ch.add(k, v)
    for _, l in rec.locs.items():
        judged += 1
        prior = (l["true"][0] + l["drift"][0], l["true"][1] + l["drift"][1],
                 l["true"][2] + l["drift"][2])
        for ref, ch in sides:
            gap, off = range_gap(
                l["real"].float().cpu().numpy(),
                ref.real_scans(np.asarray([l["true"]]))[0].float().cpu()
                .numpy())
            ch.add("real_scan_gap_m", gap)
            ch.add("real_beams_off", off)
            x, y, yaw = ref.localize(l["real"], prior)
            ch.add("pose_gap_m", float(np.hypot(x - l["est"][0],
                                                y - l["est"][1])))
            ch.add("yaw_gap_rad", abs(yaw - l["est"][2]))
    print("outcome: " + json.dumps(outcomes), file=sys.stderr)
    return {"setup_s": setup_s, "ticks": ticks, "mission_s": mission_s,
            "outcome": outcomes, "attempted": done, "failed": failed,
            "trace": stretch["summary"],
            "trace_sound": bool(stretch["summary"]
                                and stretch["summary"]["busy_s"] > 0),
            "spans": spans if trace else None, "device": dev,
            "checks": checks, "control": ctl, "judged": judged}
