"""The perception slice of otslam_tpu_torch against otslam_tpu: ray casting
(K5's plain version), scan diff, evidence grids, the virtual scanner and
change detector, batched perception ticks and the LiDAR path renderer.

Inputs are made with numpy (or the JAX renderer) from a seed and handed to
both packages: the cardboard room's 208 x 208 map at 0.05 m, 360 beams,
K <= 12 ticks. The JAX ray cast runs both as the XLA reference and as the
Pallas kernel in interpret mode, as tests/test_kernels_2d.py runs it.

Ray-cast ties. XLA:CPU contracts ``a*b + c`` into fused multiply-adds and
may divide by the constant resolution as a multiply by its reciprocal; the
port rounds each operation once, in the order of the C++ loop. A sample
whose cell coordinate lies within a few ulps of a cell boundary can then
truncate into the neighbouring cell in one package. `tie_beams` marks every
beam with a sample, up to its first stop, within 1e-4 (cell units) of such
a boundary where the cells on the two sides differ in stop status (out of
bounds or occupied); ranges are held equal on all other beams, and the
marked beams stay under 1 % of the beams.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import ChangeDetectConfig as JCDC
from otslam_tpu.config import LidarConfig as JLidar
from otslam_tpu.kernels import evidence as jev
from otslam_tpu.kernels.raycast import raycast_grid as j_raycast
from otslam_tpu.kernels.raycast import raycast_grid_fast as j_raycast_fast
from otslam_tpu.kernels.scan_diff import scan_diff as j_scan_diff
from otslam_tpu.mapping.change_detect import ChangeDetector as JDetector
from otslam_tpu.mapping.perception import perception_ticks as j_ticks
from otslam_tpu.mapping.virtual_scan import VirtualScanner as JScanner
from otslam_tpu.sim.sensors import render_lidar as j_render_lidar
from otslam_tpu.sim.sensors import render_lidar_path as j_render_path
from otslam_tpu.sim.world import Box as JBox
from otslam_tpu.sim.world import Scene as JScene
from otslam_tpu.sim.world import cardboard_room as j_room
from otslam_tpu_torch.config import ChangeDetectConfig, LidarConfig
from otslam_tpu_torch.kernels import evidence as tev
from otslam_tpu_torch.kernels import raycast as tray
from otslam_tpu_torch.kernels.scan_diff import scan_diff
from otslam_tpu_torch.mapping.change_detect import ChangeDetector
from otslam_tpu_torch.mapping.perception import (compact_ids,
                                                 perception_ticks)
from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner
from otslam_tpu_torch.sim.sensors import render_lidar, render_lidar_path
from otslam_tpu_torch.sim.world import Scene, cardboard_room
from otslam_tpu_torch.utils.profiling import COUNTS

import torch_parity  # noqa: F401  (one torch thread per test process)

LIDAR = LidarConfig(num_beams=360)
J_LIDAR = JLidar(num_beams=360)
BOX = (1.5, 0.5, 0.15), (0.5, 0.4, 0.3), 0.3, (0.76, 0.6, 0.42), "box"
RES = 0.05
RANGE_MAX = 10.0
STEPS = 200                        # ceil(range_max / res)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def room_map():
    g = cardboard_room().occupancy_grid(RES)
    return np.asarray(g.data), float(g.origin[0]), float(g.origin[1])


def scanner_angles():
    n = LIDAR.num_beams
    inc = (LIDAR.angle_max - LIDAR.angle_min) / n
    return (LIDAR.angle_min + np.arange(n) * inc).astype(np.float32)


def tie_beams(grid, pose, angles, first_stop, ox, oy, tol=1e-4):
    """Beams with a sample at or before `first_stop` whose cell coordinate
    lies within `tol` cells of a point where the truncating cast changes
    cell, and whose cells on the two sides differ in stop status (out of
    bounds or occupied): the samples one rounding can move to a cell that
    ends the ray elsewhere. float64 arithmetic."""
    H, W = grid.shape
    ga = (np.float32(pose[2]) + angles).astype(np.float64)
    d = (np.arange(STEPS) + 1.0) * RES
    u = (np.float32(pose[0]) + d[None, :] * np.cos(ga)[:, None] - ox) / RES
    v = (np.float32(pose[1]) + d[None, :] * np.sin(ga)[:, None] - oy) / RES

    def stop(cu, cv):
        gx, gy = np.trunc(cu), np.trunc(cv)
        oob = (gx < 0) | (gx >= W) | (gy < 0) | (gy >= H)
        cell = grid[np.clip(gy, 0, H - 1).astype(int),
                    np.clip(gx, 0, W - 1).astype(int)]
        return oob | (cell == 100)

    corners = [stop(u + a, v + b) for a in (-tol, tol) for b in (-tol, tol)]
    differ = np.any([c != corners[0] for c in corners[1:]], axis=0)
    upto = np.arange(STEPS)[None, :] <= np.asarray(first_stop)[:, None]
    return (differ & upto).any(axis=1)


def test_raycast_plain_matches_both_jax_paths(room_map):
    grid, ox, oy = room_map
    rng = np.random.default_rng(0)
    contiguous = scanner_angles()
    poses = [tuple(rng.uniform([-4.5, -4.5, -np.pi], [4.5, 4.5, np.pi]))
             for _ in range(4)]
    cases = [(p, contiguous) for p in poses]
    # off the map (the rays start out of bounds), and a beam set that is
    # not contiguous (the JAX Pallas path routes it to XLA)
    cases.append(((-7.3, 0.41, 0.3), contiguous))
    cases.append((poses[0], np.sort(rng.uniform(0, 2 * np.pi, 64))
                  .astype(np.float32)))
    ties = beams = 0
    for pose, angles in cases:
        xla = np.asarray(j_raycast(jnp.asarray(grid), RES, ox, oy, *pose,
                                   jnp.asarray(angles), RANGE_MAX))
        pal = np.asarray(j_raycast_fast(
            jnp.asarray(grid), RES, ox, oy, *pose, jnp.asarray(angles),
            RANGE_MAX, impl="pallas", interpret=True))
        cos_a, sin_a = tray.beam_trig(pose[2], t(angles))
        xy = torch.tensor([pose[:2]], dtype=torch.float32)
        fs, fo = tray.ray_keys_torch(t(grid), cos_a[None], sin_a[None], xy,
                                     RES, ox, oy, STEPS)
        ours = tray._ranges_from_keys(fs, fo, STEPS, RES).numpy()
        np.testing.assert_array_equal(
            ours, tray.raycast_grid(t(grid), RES, ox, oy, *pose, t(angles),
                                    RANGE_MAX).numpy())
        tie = tie_beams(grid, pose, angles, fs.numpy(), ox, oy)
        ties += int(tie.sum())
        beams += len(angles)
        for ref in (xla, pal):
            np.testing.assert_array_equal(np.isinf(ours[~tie]),
                                          np.isinf(ref[~tie]))
            np.testing.assert_array_equal(ours[~tie], ref[~tie])
        if pose[0] < ox:
            assert np.isinf(ours).all()
        else:
            assert np.isfinite(ours).mean() > 0.9
    print(f"raycast tie beams: {ties} of {beams}")
    assert ties <= 0.01 * beams


def test_raycast_batch_equals_single_poses(room_map):
    grid, ox, oy = room_map
    angles = t(scanner_angles())
    poses = np.array([[-0.5, 1.5, -1.2], [0.31, -0.72, 0.4],
                      [2.1, 2.2, 3.0]], np.float32)
    batch = tray.raycast_grid_fast(t(grid), RES, ox, oy, t(poses[:, 0]),
                                   t(poses[:, 1]), t(poses[:, 2]), angles,
                                   RANGE_MAX)
    assert batch.shape == (3, 360)
    for k in range(3):
        one = tray.raycast_grid_fast(t(grid), RES, ox, oy, *poses[k].tolist(),
                                     angles, RANGE_MAX)
        assert torch.equal(batch[k], one)
    # a CPU grid never reaches the kernel
    assert COUNTS["launches.otslam_raycast"] == 0


def test_raycast_c_cast_boundary():
    """A sample in (origin - res, origin) truncates to cell 0 (tested) as
    the C++ (int) cast does, instead of ending the ray."""
    grid = np.zeros((20, 20), np.int8)
    grid[0, 0] = 100
    r = tray.raycast_grid(t(grid), 0.1, 0.0, 0.0, 0.05, 0.05, 0.0,
                          torch.tensor([np.pi], dtype=torch.float32), 3.0)
    j = j_raycast(jnp.asarray(grid), 0.1, 0.0, 0.0, 0.05, 0.05, 0.0,
                  jnp.asarray([np.pi], jnp.float32), 3.0)
    assert np.isfinite(r.numpy()[0])
    np.testing.assert_array_equal(r.numpy(), np.asarray(j))


def random_scans(rng, n=360, k=None):
    shape = (n,) if k is None else (k, n)
    real = rng.uniform(0.2, 12.0, shape).astype(np.float32)
    real[rng.random(shape) < 0.1] = np.inf
    virt = real + rng.normal(0, 0.4, shape).astype(np.float32)
    virt[rng.random(shape) < 0.15] = np.inf
    return real, virt.astype(np.float32)


def test_scan_diff_matches_jax():
    rng = np.random.default_rng(1)
    angles = scanner_angles()
    real, virt = random_scans(rng, k=3)
    ours = scan_diff(t(real), t(virt), t(angles), RANGE_MAX, 0.5, 20)
    for i in range(3):
        ref = j_scan_diff(jnp.asarray(real[i]), jnp.asarray(virt[i]),
                          jnp.asarray(angles), RANGE_MAX, 0.5, 20)
        one = scan_diff(t(real[i]), t(virt[i]), t(angles), RANGE_MAX)
        for a, b, c in zip(ours, ref, one):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b))
            assert torch.equal(a[i], c)
        assert ref[0].any() and ref[1].any()
    # the window edge: i+W itself is outside the window
    real = np.full(60, np.inf, np.float32)
    virt = np.full(60, np.inf, np.float32)
    real[30], virt[50] = 2.0, 2.0
    same = np.zeros(60, np.float32)
    for w in (19, 20, 21):
        new, _ = scan_diff(t(real), t(virt), t(same), RANGE_MAX, 0.5, w)
        jn, _ = j_scan_diff(jnp.asarray(real), jnp.asarray(virt),
                            jnp.asarray(same), RANGE_MAX, 0.5, w)
        np.testing.assert_array_equal(new.numpy(), np.asarray(jn))
        assert bool(new[30]) == (w <= 20)


def test_evidence_matches_jax():
    rng = np.random.default_rng(2)
    xs = rng.uniform(-3.5, 3.5, (2, 500)).astype(np.float32)
    ys = rng.uniform(-3.5, 3.5, (2, 500)).astype(np.float32)
    mask = rng.random((2, 500)) < 0.8
    kx, ky = tev.world_to_key(t(xs), t(ys), 0.1)
    jkx, jky = jev.world_to_key(jnp.asarray(xs), jnp.asarray(ys), 0.1)
    np.testing.assert_array_equal(kx.numpy(), np.asarray(jkx))
    np.testing.assert_array_equal(ky.numpy(), np.asarray(jky))
    ref = torch.zeros((64, 48))
    both = tev.scatter_hits(ref, t(xs), t(ys), t(mask), 0.1)
    for i in range(2):
        jh = jev.scatter_hits(jnp.zeros((64, 48)), jnp.asarray(xs[i]),
                              jnp.asarray(ys[i]), jnp.asarray(mask[i]), 0.1)
        np.testing.assert_array_equal(both[i].numpy(), np.asarray(jh))
        assert torch.equal(both[i], tev.scatter_hits(
            ref, t(xs[i]), t(ys[i]), t(mask[i]), 0.1))
    dwell = rng.uniform(0, 3.5, (64, 48)).astype(np.float32)
    dwell[rng.random((64, 48)) < 0.3] = 0.0
    hits = both[0].numpy()
    for dt in (0.0, 0.2, 7.0):
        ours = tev.update_evidence(t(dwell), t(hits),
                                   torch.tensor(dt, dtype=torch.float32),
                                   2.0, 0.5)
        jo = jev.update_evidence(jnp.asarray(dwell), jnp.asarray(hits),
                                 jnp.float32(dt), 2.0, 0.5)
        np.testing.assert_allclose(ours.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-6)
    pts, conf = tev.evidence_points(t(dwell), 0.1, 2.0)
    jp, jc = jev.evidence_points(jnp.asarray(dwell), 0.1, 2.0)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jp))


def test_compact_ids_matches_a_plain_reference():
    rng = np.random.default_rng(3)
    for density, cap in ((0.0, 8), (0.01, 64), (0.3, 64), (1.0, 5)):
        act = rng.random((3, 1000)) < density
        got = compact_ids(t(act), cap).numpy()
        for row, g in zip(act, got):
            want = np.flatnonzero(row)[:cap]
            want = np.concatenate([want, np.full(cap - len(want), 1000)])
            np.testing.assert_array_equal(g, want)


def seq_scenes():
    """The JAX and port scenes of test_perception_batch.py: a saved map of
    the empty room and a world with the cardboard box."""
    from otslam_tpu_torch.sim.world import Box
    return (JScene(objects=()), JScene(objects=(JBox(*BOX),)),
            Scene(objects=()), Scene(objects=(Box(*BOX),)))


def moving_poses(k=12):
    rng = np.random.default_rng(0)
    return np.stack([np.linspace(-0.5, 0.5, k), np.linspace(1.5, 1.0, k),
                     rng.uniform(-1.5, -1.0, k)], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def sequence():
    """K moving-pose ticks: real scans (JAX renderer), and the JAX
    package's sequential VirtualScanner + ChangeDetector run over them."""
    jmap, jworld, tmap, _ = seq_scenes()
    poses = moving_poses()
    js = JScanner(J_LIDAR)
    js.set_map(jmap.occupancy_grid(RES))
    angles = np.asarray(js.angles())
    reals = np.stack([np.asarray(j_render_lidar(
        jworld, *p, jnp.asarray(angles), LIDAR.range_min, LIDAR.range_max))
        for p in poses])
    jd = JDetector(JCDC(), J_LIDAR)
    jvirt, jadded = [], []
    for i, p in enumerate(poses):
        v = js.scan(*p)
        jvirt.append(np.asarray(v))
        jd.on_virtual_scan(v)
        jd.on_scan(jnp.asarray(reals[i]), jnp.asarray(angles), p,
                   0.2 * (i + 1))
        jadded.append(jd.added_objects())
    return dict(poses=poses, angles=angles, reals=reals, tmap=tmap,
                jvirt=np.stack(jvirt), jadded=jadded,
                jnew=np.asarray(jd.new_grid), jgone=np.asarray(jd.gone_grid))


def point_set(pts):
    return set(map(tuple, np.round(np.asarray(pts), 4).tolist()))


def test_virtual_scanner_and_change_detector_match_jax(sequence):
    s = sequence
    vs = VirtualScanner(LIDAR, device="cpu")
    vs.set_map(s["tmap"].occupancy_grid(RES))
    np.testing.assert_array_equal(vs.angles().numpy(), s["angles"])
    assert vs.grid.dtype == torch.int8
    det = ChangeDetector(ChangeDetectConfig(), LIDAR, device="cpu")
    det.on_scan(t(s["reals"][0]), vs.angles(), s["poses"][0], 0.1)
    assert det._last_time is None           # no virtual scan yet: no-op
    for i, p in enumerate(s["poses"]):
        v = vs.scan(*p)
        fs = tray.ray_keys_torch(
            vs.grid, *(x[None] for x in tray.beam_trig(float(p[2]),
                                                       vs.angles())),
            t(p[None, :2]), RES, *vs._map.origin, STEPS)[0]
        tie = tie_beams(vs._map.data, p, s["angles"], fs.numpy(),
                        *vs._map.origin)
        np.testing.assert_array_equal(v.numpy()[~tie], s["jvirt"][i][~tie])
        det.on_virtual_scan(v)
        det.on_scan(t(s["reals"][i]), vs.angles(), p, 0.2 * (i + 1))
        assert point_set(det.added_objects()) == point_set(s["jadded"][i])
    det.on_scan(t(s["reals"][0][:100]), vs.angles()[:100], p, 9.0)
    assert det._last_time == pytest.approx(0.2 * 12)   # beam mismatch: no-op
    np.testing.assert_allclose(det.new_grid.numpy(), s["jnew"], atol=1e-6)
    np.testing.assert_allclose(det.gone_grid.numpy(), s["jgone"], atol=1e-6)
    assert len(s["jadded"][-1]) > 0                # the box was detected


def run_port_sequential(s):
    vs = VirtualScanner(LIDAR, device="cpu")
    vs.set_map(s["tmap"].occupancy_grid(RES))
    det = ChangeDetector(ChangeDetectConfig(), LIDAR, device="cpu")
    added, removed = [], []
    for i, p in enumerate(s["poses"]):
        det.on_virtual_scan(vs.scan(*p))
        det.on_scan(t(s["reals"][i]), vs.angles(), p, 0.2 * (i + 1))
        added.append(det.added_objects())
        removed.append(det.removed_objects())
    return vs, det, added, removed


def test_perception_ticks_match_jax_and_the_sequential_path(sequence):
    s = sequence
    vs, det, added, removed = run_port_sequential(s)
    k = len(s["poses"])
    dts = np.full(k, 0.2, np.float32)
    dts[0] = 0.0
    g = vs._map
    cfg = ChangeDetectConfig()
    zeros = torch.zeros(cfg.grid_cells)
    batch = perception_ticks(vs.grid, RES, *g.origin, zeros, zeros.clone(),
                             t(s["reals"]), t(s["poses"]), t(dts),
                             vs.angles(), cfg, RANGE_MAX, max_points=512)
    jb = j_ticks(jnp.asarray(g.data), RES, *g.origin, jnp.zeros(cfg.grid_cells),
                 jnp.zeros(cfg.grid_cells), jnp.asarray(s["reals"]),
                 jnp.asarray(s["poses"]), jnp.asarray(dts),
                 jnp.asarray(s["angles"]), JCDC(), RANGE_MAX, max_points=512)
    for grid, seq, ref in ((batch.new_grid, det.new_grid, jb.new_grid),
                           (batch.gone_grid, det.gone_grid, jb.gone_grid)):
        np.testing.assert_allclose(grid.numpy(), seq.numpy(), atol=1e-6)
        np.testing.assert_allclose(grid.numpy(), np.asarray(ref), atol=1e-6)
    assert torch.equal(batch.virtual[-1], vs.scan(*s["poses"][-1]))
    np.testing.assert_array_equal(batch.added_cnt.numpy(),
                                  np.asarray(jb.added_cnt))
    np.testing.assert_array_equal(batch.removed_cnt.numpy(),
                                  np.asarray(jb.removed_cnt))
    for i in range(k):
        a = batch.added_pts[i, :int(batch.added_cnt[i])]
        r = batch.removed_pts[i, :int(batch.removed_cnt[i])]
        assert point_set(a) == point_set(added[i])
        assert point_set(r) == point_set(removed[i])
        ja = np.asarray(jb.added_pts[i][:int(jb.added_cnt[i])])
        assert point_set(a) == point_set(ja)
        # compaction keeps the ascending cell order of evidence_points
        np.testing.assert_allclose(a.numpy(), added[i], atol=1e-6)
    assert int(batch.added_cnt[-1]) > 0


def test_perception_compaction_capacity():
    _, _, tmap, tworld = seq_scenes()
    vs = VirtualScanner(LIDAR, device="cpu")
    vs.set_map(tmap.occupancy_grid(RES))
    cfg = ChangeDetectConfig()
    pose = torch.tensor([[-0.5, 1.5, -1.2]])
    real = render_lidar(tworld, -0.5, 1.5, -1.2, vs.angles(),
                        LIDAR.range_min, LIDAR.range_max, device="cpu")[None]
    zeros = torch.zeros(cfg.grid_cells)
    # enough dwell to confirm everything in one tick
    batch = perception_ticks(vs.grid, RES, *vs._map.origin, zeros, zeros,
                             real, pose, torch.tensor([100.0]), vs.angles(),
                             cfg, RANGE_MAX, max_points=4)
    full = perception_ticks(vs.grid, RES, *vs._map.origin, zeros, zeros,
                            real, pose, torch.tensor([100.0]), vs.angles(),
                            cfg, RANGE_MAX, max_points=4096)
    assert int(full.added_cnt[0]) > 4
    assert int(batch.added_cnt[0]) == 4
    assert torch.equal(batch.added_pts[0], full.added_pts[0, :4])
    assert bool((full.added_pts[0, int(full.added_cnt[0]):] == 0).all())


def test_render_lidar_path_rows_equal_render_lidar():
    rng = np.random.default_rng(4)
    angles = scanner_angles()
    xs = rng.uniform(-4, 4, 6).astype(np.float32)
    ys = rng.uniform(-4, 4, 6).astype(np.float32)
    yaws = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    path = render_lidar_path(cardboard_room(), xs, ys, yaws, angles,
                             LIDAR.range_min, LIDAR.range_max, device="cpu")
    jpath = np.asarray(j_render_path(j_room(), xs, ys, yaws,
                                     jnp.asarray(angles), LIDAR.range_min,
                                     LIDAR.range_max))
    assert path.shape == (6, 360)
    for k in range(6):
        one = render_lidar(cardboard_room(), float(xs[k]), float(ys[k]),
                           float(yaws[k]), angles, LIDAR.range_min,
                           LIDAR.range_max, device="cpu")
        assert torch.equal(path[k], one)
    fin = np.isfinite(jpath)
    np.testing.assert_array_equal(np.isfinite(path.numpy()), fin)
    np.testing.assert_allclose(path.numpy()[fin], jpath[fin], rtol=0,
                               atol=1e-5)


def step_masks(grid, cos_a, sin_a, pose_xy, ox, oy, num_steps):
    """(oob, occ) bool (K*B, S): every step of every ray, with the
    arithmetic of ray_keys_torch."""
    H, W = grid.shape
    res, ox, oy = (torch.tensor(x, dtype=torch.float32) for x in (RES, ox,
                                                                    oy))
    d = (torch.arange(num_steps, dtype=torch.float32) + 1.0) * res
    B = cos_a.shape[-1]
    px = pose_xy[:, 0].repeat_interleave(B)[:, None]
    py = pose_xy[:, 1].repeat_interleave(B)[:, None]
    gx = ((px + d * cos_a.reshape(-1, 1) - ox) / res).to(torch.int32)
    gy = ((py + d * sin_a.reshape(-1, 1) - oy) / res).to(torch.int32)
    oob = (gx < 0) | (gx >= W) | (gy < 0) | (gy >= H)
    cell = grid[gy.clamp(0, H - 1).long(), gx.clamp(0, W - 1).long()]
    return oob.numpy(), ((cell == 100) & ~oob).numpy()


def chunked_keys(oob, occ, lanes):
    """K5's walk in plain numpy: `lanes` steps a chunk; first_stop from the
    chunk's lowest oob-or-occupied step, first_occ from its lowest
    occupied one, which ends the ray; an oob last step ends it once any
    step so far was in the grid."""
    n, steps = oob.shape
    fs = np.full(n, steps)
    fo = np.full(n, steps)
    for i in range(n):
        was_in = False
        for base in range(0, steps, lanes):
            o, c = oob[i, base:base + lanes], occ[i, base:base + lanes]
            stop = o | c
            if fs[i] == steps and stop.any():
                fs[i] = base + int(np.argmax(stop))
            if c.any():
                fo[i] = base + int(np.argmax(c))
                break
            was_in = was_in or not o.all()
            if was_in and o[-1]:
                break
    return fs, fo


@pytest.mark.parametrize("steps", [1, 37, STEPS])
def test_chunked_walk_gives_the_plain_keys(room_map, steps):
    """K5's chunk rule (csrc/raycast.cu), mirrored in numpy over the plain
    version's per-step masks, gives its keys for every lane count: on
    poses inside the room, off the map (rays that never enter, and rays
    that enter at every offset within a chunk) and near its edge."""
    grid, ox, oy = room_map
    H, W = grid.shape
    rng = np.random.default_rng(steps)
    poses = [(*rng.uniform([-4.5, -4.5], [4.5, 4.5]), 0.0) for _ in range(3)]
    # left of the map, entering it after e + 0.25 cells along +x
    poses += [(ox - RES * (e + 0.25), oy + RES * H / 2, 0.0)
              for e in range(0, 41, 3)]
    poses += [(-7.3, 0.41, 0.3), (ox + RES * 0.5, oy + RES * 0.5, 0.7)]
    poses = np.asarray(poses, np.float32)
    angles = t(np.linspace(-0.3, 0.3, 16, dtype=np.float32))
    cos_a, sin_a = tray.beam_trig(t(poses[:, 2]), angles)
    xy = t(poses[:, :2])
    ps, po = tray.ray_keys_torch(t(grid), cos_a, sin_a, xy, RES, ox, oy,
                                 steps)
    oob, occ = step_masks(t(grid), cos_a, sin_a, xy, ox, oy, steps)
    entered_mid_chunk = (oob[:, 0] & ~oob.all(axis=1)).sum()
    assert steps == 1 or entered_mid_chunk > 100
    for lanes in tray.LANE_CHOICES:
        fs, fo = chunked_keys(oob, occ, lanes)
        np.testing.assert_array_equal(fs, ps.numpy())
        np.testing.assert_array_equal(fo, po.numpy())


@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_ray_launch_shape(lanes):
    """`lanes` lanes a ray in blocks of 128 threads: the mission's 8 x 1440
    rays, 64 x 1440, a ragged count, none."""
    for rays in (0, 8 * 1440, 64 * 1440, 1000):
        blocks, threads = tray.ray_launch(rays, lanes)
        assert threads == 128 and blocks == -(-rays * lanes // 128)


@pytest.mark.parametrize("lanes, rays", [(4, 10), (12, 10), (64, 10),
                                         (1, 10), (8, -1)])
def test_ray_launch_refuses_bad_shapes(lanes, rays):
    with pytest.raises(ValueError):
        tray.ray_launch(rays, lanes)


@pytest.mark.parametrize("poses, lanes", [(1, 32), (8, 32), (16, 16),
                                          (32, 8), (64, 8)])
def test_lanes_for_fills_a_132_sm_card(poses, lanes):
    """The fewest lanes whose threads fill 132 SMs x 2048: 32 at the
    mission's 8 poses x 1440 beams, 8 at a 64-pose transit batch."""
    assert tray.lanes_for(poses * 1440, 132) == lanes
    assert tray.lanes_for(0, 132) == 32
