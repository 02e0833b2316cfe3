"""otslam_tpu_torch's topic bus and OTSLAMSystem vs otslam_tpu's (CPU).

Mirrors tests/test_system.py::TestBusSystem::test_full_topic_flow: both
systems get the same latched map and the same real scans, and every topic
each publishes must carry the same messages in the same order.
"""

import numpy as np
import pytest

from otslam_tpu.adapters.bus import OTSLAMSystem as JSystem
from otslam_tpu.config import LidarConfig as JLidar
from otslam_tpu.config import OTSLAMConfig as JConfig
from otslam_tpu.config import TrackerConfig as JTracker
from otslam_tpu.sim.sensors import render_lidar
from otslam_tpu.sim.world import Scene as JScene
from otslam_tpu.sim.world import cardboard_room as jcardboard
from otslam_tpu_torch.adapters.bus import Bus, OTSLAMSystem
from otslam_tpu_torch.config import LidarConfig, OTSLAMConfig, TrackerConfig
from otslam_tpu_torch.sim.world import Scene

TOPICS = ("/virtual_scan", "/added_objects", "/removed_objects",
          "/object_visiting_points", "/removed_object_visiting_points",
          "/manager/target_pose")


def as_plain(topic, msg):
    """A topic message as numpy / tuples for comparison."""
    if topic == "/virtual_scan":
        r = msg["ranges"]
        return np.asarray(r.cpu() if hasattr(r, "cpu") else r)
    if topic in ("/added_objects", "/removed_objects"):
        return np.asarray(msg)
    if topic == "/manager/target_pose":
        return tuple(msg.__dict__.values())
    return [tuple(p.__dict__.values()) for p in msg]


def record(bus):
    log = {t: [] for t in TOPICS}
    for t in TOPICS:
        bus.subscribe(t, lambda m, t=t: log[t].append(as_plain(t, m)))
    return log


def run(system, scans, angles, pose):
    b = system.bus
    log = record(b)
    t = 0.0
    for real in scans:
        t += 0.2
        b.publish("/odom", (pose[0], pose[1]))
        b.publish("/scan", {"ranges": real, "angles": angles, "pose": pose,
                            "stamp": t})
    goal = system.control_step()
    frozen = b.call("set_tracking_mode", False)
    return log, goal, frozen


@pytest.fixture(scope="module")
def flows():
    lidar = dict(num_beams=360)
    jsys = JSystem(JConfig(lidar=JLidar(**lidar),
                           tracker=JTracker.update_pipeline_profile()))
    tsys = OTSLAMSystem(OTSLAMConfig(
        lidar=LidarConfig(**lidar),
        tracker=TrackerConfig.update_pipeline_profile()), Bus(),
        device="cpu")
    jsys.bus.publish("/virtual_map", JScene(objects=()).occupancy_grid(0.05))
    tsys.bus.publish("/virtual_map", Scene(objects=()).occupancy_grid(0.05))
    angles = np.array(jsys.vscanner.angles())
    np.testing.assert_array_equal(tsys.vscanner.angles().numpy(), angles)
    pose = (-1.0, -1.0, 0.5)
    scans = [np.array(render_lidar(jcardboard(), *pose, angles,
                                     jsys.cfg.lidar.range_min,
                                     jsys.cfg.lidar.range_max))] * 25
    return (run(tsys, scans, angles, pose), run(jsys, scans, angles, pose),
            tsys, jsys)


@pytest.mark.parametrize("topic", TOPICS)
def test_topic_equals_jax(flows, topic):
    (port, _, _), (ref, _, _), *_ = flows
    assert len(port[topic]) == len(ref[topic])
    for a, b in zip(port[topic], ref[topic]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_full_topic_flow(flows):
    (log, goal, frozen), (_, jgoal, jfrozen), sys_, _ = flows
    b = sys_.bus
    # topics carried data end-to-end
    assert len(b.last["/added_objects"]) > 0
    assert len(b.last["/object_visiting_points"]) > 0
    assert goal is not None and b.last["/manager/target_pose"] is goal
    assert tuple(goal.__dict__.values()) == tuple(jgoal.__dict__.values())
    # freeze service
    assert frozen == jfrozen
    assert frozen["success"] and not sys_.tracker.tracking_enabled
    assert [s.__dict__ for s in sys_.tracker.stable_objects]


def test_stable_objects_equal_jax(flows):
    """The trackers' stable objects after the flow (the numbers behind the
    visiting-point topic) equal JAX's."""
    *_, tsys, jsys = flows
    ps = [(o.cx, o.cy, o.width, o.height, o.lock_radius, o.site_id)
          for o in tsys.tracker.stable_objects]
    js = [(o.cx, o.cy, o.width, o.height, o.lock_radius, o.site_id)
          for o in jsys.tracker.stable_objects]
    assert ps and ps == js
