"""The estimated-pose mission of otslam_tpu_torch against otslam_tpu on
full_room, MISSION_r04.json's scene and start pose, for 120 ticks
(tests/torch_missions.py has the recipe and the tolerances); and where the
two packages' pose estimates part: the localizer's ICP, not the LiDAR
scans."""

import dataclasses

import numpy as np
import pytest

import otslam_tpu.sim.world as jworld
import otslam_tpu_torch.sim.world as tworld
from otslam_tpu.mapping.localize import ScanLocalizer as JLocalizer
from otslam_tpu.sim.sensors import render_lidar as jrender
from otslam_tpu_torch.mapping.localize import ScanLocalizer as TLocalizer
from otslam_tpu_torch.sim.sensors import render_lidar as trender
from torch_missions import (JAX, PHANTOM, PORT, POSE_ATOL,
                            assert_missions_match, estimated_pose_mission)


def test_estimated_pose_mission_matches_jax_on_full_room(tmp_path):
    jr, js = estimated_pose_mission(JAX, "full_room", tmp_path / "jax", 120)
    tr, ts = estimated_pose_mission(PORT, "full_room", tmp_path / "torch",
                                    120)
    assert_missions_match(jr, js, tmp_path / "jax", tr, ts, tmp_path / "torch")
    # two object groups scanned with estimated poses by then
    assert ts.missions_completed >= 4 and len(ts.labels) >= 2
    assert ts.stable_objects >= 2


@pytest.mark.parametrize("pose", [(0.5, 4.5, 0.0), (-3.9, -1.46, 5.93),
                                  (3.2, -2.9, 2.1)])
def test_localizers_part_on_one_scan_not_on_the_scans(pose):
    """The two renderers' scans agree within 1e-4 m, and the port's
    localizer gives the same pose (within 1e-4) from either; fed the same
    scan, the two localizers stay within the mission's tolerance at an
    odometry prior a few millimetres off, as in these missions. Their gap
    is the ICP's (near-tie correspondences on the map's cell-centre
    lattice) and grows with the prior's offset: ROADMAP C."""
    angles = np.linspace(0, 2 * np.pi, 1440, endpoint=False).astype(
        np.float32)
    js, ts = jworld.full_room(), tworld.full_room()
    jmap = dataclasses.replace(js, objects=(jworld.Box(*PHANTOM),))
    tmap = dataclasses.replace(ts, objects=(tworld.Box(*PHANTOM),))
    jscan = np.asarray(jrender(js, *pose, angles, 0.12, 10.0))
    tscan = trender(ts, *pose, angles, 0.12, 10.0, device="cpu").numpy()
    np.testing.assert_array_equal(np.isfinite(tscan), np.isfinite(jscan))
    hit = np.isfinite(jscan)
    assert np.abs(tscan[hit] - jscan[hit]).max() <= 1e-4
    prior = (pose[0] + 0.005, pose[1] - 0.004, pose[2] + 0.002)
    tloc = TLocalizer(tmap.occupancy_grid(0.05), device="cpu")
    j = JLocalizer(jmap.occupancy_grid(0.05)).localize(jscan, angles, prior)
    t = tloc.localize(jscan, angles, prior)
    own = tloc.localize(tscan, angles, prior)
    np.testing.assert_allclose((own.x, own.y, own.yaw), (t.x, t.y, t.yaw),
                               rtol=0, atol=1e-4)
    gap = np.abs(np.subtract((t.x, t.y, t.yaw), (j.x, j.y, j.yaw)))
    assert gap.max() <= POSE_ATOL, gap
