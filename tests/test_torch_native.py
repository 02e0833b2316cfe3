"""otslam_tpu_torch's native host runtime and mission control plane vs
otslam_tpu's (CPU): the frame ring, the depth codecs, the PLY writer, and
the C++ tracker and goal sender, on the same inputs.

Mirrors tests/test_native.py and tests/test_native_mission.py; each case
also runs the JAX package's adapter and requires the same answer.
"""

import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from otslam_tpu.adapters import native as jnative
from otslam_tpu.adapters import native_mission as jmission
from otslam_tpu.config import MissionConfig as JMission
from otslam_tpu.config import TrackerConfig as JTracker
from otslam_tpu.mission.tracker import TrackedCluster as JCluster
from otslam_tpu.mission.visiting import visiting_points as jvisiting
from otslam_tpu_torch.adapters import native as tnative
from otslam_tpu_torch.adapters import native_mission as tmission
from otslam_tpu_torch.config import MissionConfig, TrackerConfig
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.mission.goal_queue import GoalSender
from otslam_tpu_torch.mission.tracker import ObjectTracker, TrackedCluster
from otslam_tpu_torch.mission.visiting import visiting_points

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def private_jax_native(tmp_path_factory):
    """The JAX adapters build their libraries next to their sources, in the
    repo's native/, where tests/test_native*.py may be building at the same
    time: here they build copies of the sources in a private directory."""
    root = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, failed in ((jnative, "otslam_native", "_build_failed"),
                                  (jmission, "otslam_mission", "_failed")):
            src = root / f"{name}.cpp"
            shutil.copyfile(REPO / "native" / f"{name}.cpp", src)
            mp.setattr(mod, "_SRC", str(src))
            mp.setattr(mod, "_SO", str(root / f"lib{name}.so"))
            mp.setattr(mod, "_lib", None)
            mp.setattr(mod, failed, False)
        yield root


class TestNativeBuild:
    def test_builds_under_build_and_loads(self):
        assert tnative.native_available(), "g++ toolchain expected here"
        lib = Path(tnative.load_native()._name)
        assert lib.parent.parent == REPO / "build" / "otslam_tpu_torch_native"
        mission = Path(tmission.load_mission_native()._name)
        assert mission.parent.parent == lib.parent.parent
        assert lib.parent != mission.parent

    def test_jax_reference_builds_privately(self, private_jax_native):
        """The JAX adapters this module compares with load libraries built
        in the module's private directory, never the repo's native/."""
        for lib in (jnative.load_native(), jmission.load_mission_native()):
            assert Path(lib._name).parent == private_jax_native

    def test_fallback_is_reported(self, monkeypatch):
        """Without g++ the ring and codecs take the NumPy path and
        native_available() says so."""
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_build_failed", False)
        monkeypatch.setattr(tnative, "BUILD_ROOT", Path("/nonexistent"))
        monkeypatch.setattr(tnative.shutil, "which", lambda _: None)
        assert not tnative.native_available()
        ring = tnative.FrameRing(2, 2, capacity=2)
        assert ring._ring is None
        assert not tnative.write_ply_points_native("unused.ply",
                                                   np.zeros((1, 3)))


class TestDepthConversions:
    @pytest.mark.parametrize("fallback", [False, True])
    def test_roundtrip_matches_jax(self, fallback, monkeypatch, rng):
        if fallback:  # each package's NumPy path
            monkeypatch.setattr(tnative, "load_native", lambda: None)
            monkeypatch.setattr(jnative, "load_native", lambda: None)
        d = np.array([[0.5, 6.0, np.nan], [2.0011, 0.0, -1.0]], np.float32)
        d = np.concatenate([d, rng.uniform(-1, 7, (4, 3)).astype(np.float32)])
        u16 = tnative.depth_m_to_u16(d)
        np.testing.assert_array_equal(u16, jnative.depth_m_to_u16(d))
        np.testing.assert_array_equal(u16[:2], [[500, 0, 0], [2001, 0, 0]])
        back = tnative.depth_u16_to_m(u16)
        np.testing.assert_array_equal(back, jnative.depth_u16_to_m(u16))


def fill(ring, n, shape=(2, 2)):
    for i in range(n):
        ring.push(np.full(shape, float(i), np.float32),
                  np.full(shape + (3,), i, np.uint8), stamp=float(i))


def drain(ring):
    out = []
    while (item := ring.pop()) is not None:
        out.append(item)
    return out


def same_items(a, b):
    assert len(a) == len(b)
    for (da, ca, sa), (db, cb, sb) in zip(a, b):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(ca, cb)
        assert sa == sb


class TestFrameRing:
    def test_push_pop_order(self):
        rings = [m.FrameRing(4, 6, capacity=4) for m in (tnative, jnative)]
        for r in rings:
            fill(r, 3, (4, 6))
        assert [len(r) for r in rings] == [3, 3]
        d, c, s = rings[0].pop()
        assert s == 0.0 and d[0, 0] == 0.0 and c[0, 0, 0] == 0
        rings[1].pop()
        same_items(drain(rings[0]), drain(rings[1]))

    def test_drop_oldest_when_full(self):
        rings = [m.FrameRing(2, 2, capacity=2) for m in (tnative, jnative)]
        for r in rings:
            fill(r, 5)
        assert rings[0].dropped == rings[1].dropped >= 3
        port, ref = drain(rings[0]), drain(rings[1])
        same_items(port, ref)
        assert port[0][2] >= 3.0  # oldest were dropped

    def test_pop_latest_flushes(self):
        rings = [m.FrameRing(2, 2, capacity=8) for m in (tnative, jnative)]
        for r in rings:
            fill(r, 5)
        same_items([rings[0].pop_latest()], [rings[1].pop_latest()])
        assert len(rings[0]) == 0 and rings[0].pop() is None

    def test_threaded_producer_consumer(self):
        ring = tnative.FrameRing(8, 8, capacity=16)
        n = 200

        def produce():
            fill(ring, n, (8, 8))

        got = []
        t = threading.Thread(target=produce)
        t.start()
        while t.is_alive() or len(ring):
            item = ring.pop()
            if item is not None:
                got.append(item[2])
        t.join(60)
        assert not t.is_alive()
        assert len(got) + ring.dropped == n
        assert got == sorted(got)  # FIFO order preserved

    def test_fallback_ring_matches_native(self, monkeypatch):
        native = tnative.FrameRing(2, 2, capacity=3)
        monkeypatch.setattr(tnative, "load_native", lambda: None)
        plain = tnative.FrameRing(2, 2, capacity=3)
        assert plain._ring is None and native._ring is not None
        for r in (native, plain):
            fill(r, 7)
        assert native.dropped == plain.dropped == 4
        same_items(drain(native), drain(plain))


class TestNativePly:
    def test_matches_jax_writer_and_reader(self, tmp_path, rng):
        pts = rng.standard_normal((500, 3)).astype(np.float32)
        cols = rng.uniform(0, 1, (500, 3)).astype(np.float32)
        port, ref = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
        assert tnative.write_ply_points_native(port, pts, cols)
        assert jnative.write_ply_points_native(ref, pts, cols)
        back = tio.read_ply(port)
        np.testing.assert_allclose(back["points"], pts, atol=1e-6)
        np.testing.assert_allclose(back["colors"], cols, atol=1.0 / 255)
        a, b = Path(port).read_bytes(), Path(ref).read_bytes()
        # byte-equal apart from the header's comment line
        strip = [ln for ln in a.split(b"\n") if not ln.startswith(b"comment")]
        strip_ref = [ln for ln in b.split(b"\n")
                     if not ln.startswith(b"comment")]
        assert strip == strip_ref
        assert b"comment produced by otslam_tpu_torch" in a


def random_scenario(seed, steps=40):
    """A random stream of change-point clouds (two drifting blobs + noise),
    as tests/test_native_mission.py draws it."""
    rng = np.random.default_rng(seed)
    clouds = []
    for k in range(steps):
        pts = []
        for (cx, cy) in ((2.0 + 0.01 * k, 1.0), (-3.0, -2.0 + 0.005 * k)):
            if rng.random() < 0.9:
                m = rng.integers(5, 20)
                ang = rng.uniform(0, 2 * np.pi, m)
                rad = rng.uniform(0.1, 0.35, m)
                pts.append(np.stack([cx + rad * np.cos(ang),
                                     cy + rad * np.sin(ang)], -1))
        clouds.append(np.concatenate(pts) if pts else np.zeros((0, 2)))
    return clouds


def geometry(objs):
    return sorted((s.cx, s.cy, s.width, s.height) for s in objs)


TRACKER = dict(cluster_distance_threshold=1.0, min_cluster_points=5,
               wall_thickness_threshold=0.2, stability_time=1.0,
               lock_margin=0.5)


class TestTrackerParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_python_and_jax_native(self, seed):
        py = ObjectTracker(TrackerConfig(**TRACKER))
        cc = tmission.NativeObjectTracker(TrackerConfig(**TRACKER))
        jc = jmission.NativeObjectTracker(JTracker(**TRACKER))
        t = 0.0
        for cloud in random_scenario(seed):
            t += 0.2
            for tracker in (py, cc, jc):
                tracker.update(cloud, t)
        assert len(cc.stable_objects) == len(py.stable_objects) > 0
        assert all(isinstance(s, TrackedCluster) for s in cc.stable_objects)
        # the same C++ on the same points: equal to the JAX adapter's
        assert geometry(cc.stable_objects) == geometry(jc.stable_objects)
        assert cc.num_candidates == jc.num_candidates
        # the Python tracker clusters in f32, the C++ in f64
        np.testing.assert_allclose(geometry(cc.stable_objects),
                                   geometry(py.stable_objects), atol=1e-5)

    def test_freeze_parity(self):
        cfg = dict(min_cluster_points=3, stability_time=0.5)
        cc = tmission.NativeObjectTracker(TrackerConfig(**cfg))
        jc = jmission.NativeObjectTracker(JTracker(**cfg))
        for tracker in (cc, jc):
            tracker.set_tracking_mode(False)
            for i in range(10):
                tracker.update(np.random.default_rng(0).uniform(0, 1, (10, 2)),
                               0.2 * (i + 1))
        assert len(cc.stable_objects) == len(jc.stable_objects) == 0
        assert not cc.tracking_enabled and not jc.tracking_enabled


def drive(sender, points, odometry):
    """Run the queue to exhaustion, teleporting to each goal."""
    visits = []
    sender.on_added_points(points)
    sender.on_odom(*odometry)
    for _ in range(100):
        g = sender.control_step()
        if g is None and sender.pending_count() == 0:
            break
        if g is not None:
            visits.append((g.unique_id, g.object_id, g.x, g.y, g.yaw))
            sender.on_odom(g.x, g.y)
            sender.on_added_points(points)
    return visits


OBJS = [(0.0, 0.0, 0.5, 0.5, 1.0), (5.0, 0.0, 0.4, 0.6, 1.1),
        (-1.0, 4.0, 0.3, 0.3, 0.8)]


class TestSenderParity:
    @pytest.mark.parametrize("start", [(0.0, 0.0), (4.5, 0.2), (-2.0, 3.0)])
    def test_identical_visit_order(self, start):
        pts = visiting_points([TrackedCluster(*o, 0, 0, True) for o in OBJS],
                              TrackerConfig())
        jpts = jvisiting([JCluster(*o, 0, 0, True) for o in OBJS],
                         JTracker())
        py = drive(GoalSender(MissionConfig()), pts, start)
        cc = drive(tmission.NativeGoalSender(MissionConfig()), pts, start)
        jc = drive(jmission.NativeGoalSender(JMission()), jpts, start)
        assert py == cc == jc
        assert len({u for u, *_ in py}) == len(pts)

    def test_removed_merge_parity(self):
        cfg = TrackerConfig()
        added = visiting_points(
            [TrackedCluster(1.0, 0.0, 0.5, 0.5, 1.0, 0, 0, True)], cfg)
        removed = visiting_points(
            [TrackedCluster(-4.0, 0.0, 0.5, 0.5, 1.0, 0, 0, True)], cfg,
            removed=True)
        orders = []
        for s in (GoalSender(MissionConfig()),
                  tmission.NativeGoalSender(MissionConfig())):
            s.on_added_points(added)
            s.on_removed_points(removed)
            s.on_odom(0.0, 0.0)
            order = []
            for _ in range(60):
                g = s.control_step()
                if g is None and s.pending_count() == 0:
                    break
                if g is not None:
                    order.append((g.unique_id, g.is_removed))
                    s.on_odom(g.x, g.y)
                    s.on_added_points(added)
                    s.on_removed_points(removed)
            orders.append(order)
        assert orders[0] == orders[1]
        assert any(r for _, r in orders[0])  # removed points were visited
