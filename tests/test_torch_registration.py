"""otslam_tpu_torch registration kernels vs otslam_tpu (CPU): the windowed
nearest neighbour (the plain path of kernel K4), ICP, the SE(3) maps and
pose graph, TSDF sampling and frame-to-model tracking, and scan
localization with its grid and LiDAR renderer.

Registration inputs are jittered box lattices (torch_parity.lattice_box)
moved by a few mm, so every point's nearest neighbour is unambiguous and
the JAX package's expanded NN distances pick the same correspondences as
the port's direct ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import LidarConfig
from otslam_tpu.config import TSDFConfig as JCfg
from otslam_tpu.core import volume_io as jvio
from otslam_tpu.kernels import icp as jicp
from otslam_tpu.kernels import nn as jnn
from otslam_tpu.kernels import pose_graph as jpg
from otslam_tpu.kernels import track as jtrack
from otslam_tpu.kernels import tsdf_block as jtb
from otslam_tpu.mapping.localize import ScanLocalizer as JLocalizer
from otslam_tpu.sim.sensors import render_lidar as j_render_lidar
from otslam_tpu.sim.world import cardboard_room as j_room
from otslam_tpu_torch.core import volume_io as tvio
from otslam_tpu_torch.core.grid import OccupancyGrid2D
from otslam_tpu_torch.kernels import icp as ticp
from otslam_tpu_torch.kernels import nn as tnn
from otslam_tpu_torch.kernels import pose_graph as tpg
from otslam_tpu_torch.kernels import track as ttrack
from otslam_tpu_torch.kernels import tsdf_block as ttb
from otslam_tpu_torch.mapping.localize import ScanLocalizer
from otslam_tpu_torch.sim.sensors import render_lidar
from otslam_tpu_torch.sim.world import cardboard_room
from otslam_tpu_torch.utils.profiling import COUNTS
from torch_parity import (J_SMALL, capture, lattice_box, small_motion)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


# ---------------------------------------------------------------------------
# windowed nearest neighbour
# ---------------------------------------------------------------------------

RADIUS = 0.06


@pytest.fixture(scope="module")
def sparse_clouds():
    """2048 x 8192 uniform points in [-1, 1]^3 sorted on z: about half the
    sources have a neighbour within RADIUS."""
    rng = np.random.default_rng(21)
    src = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    dst = rng.uniform(-1, 1, (8192, 3)).astype(np.float32)
    smask = rng.random(2048) > 0.1
    dmask = rng.random(8192) > 0.1
    return (src[np.argsort(src[:, 2])], dst[np.argsort(dst[:, 2])], smask,
            dmask)


def nn_gap(src, dst, dmask):
    """float64 (nearest distance, squared-distance gap to the second)."""
    d2 = ((src[:, None, :].astype(np.float64) - dst[None]) ** 2).sum(-1)
    d2[:, ~dmask] = np.inf
    part = np.partition(d2, 1, axis=1)
    return np.sqrt(part[:, 0]), part[:, 1] - part[:, 0]


def test_window_sizing_equals_jax(sparse_clouds):
    src, dst, _, _ = sparse_clouds
    for axis in (None, 0, 2):
        jb, tb = jnn.nn_window_bounds(dst, axis), tnn.nn_window_bounds(dst,
                                                                       axis)
        assert jb[0] == tb[0] and jb[3] == tb[3]
        np.testing.assert_array_equal(jb[1], tb[1])
        np.testing.assert_array_equal(jb[2], tb[2])
        for kw in ({}, {"margin": 0}, {"round_to": 4},
                   {"dst_bounds": tb}):
            assert (tnn.auto_nn_window(src, dst, RADIUS, axis, **kw)
                    == jnn.auto_nn_window(src, dst, RADIUS, axis, **kw))
    # a window that covers the whole cloud caps at the chunk count
    assert tnn.auto_nn_window(src, dst[:900], 5.0) == \
        jnn.auto_nn_window(src, dst[:900], 5.0)


@pytest.mark.parametrize("masked", [False, True])
def test_nn_distance_radius_matches_jax(sparse_clouds, masked):
    src, dst, smask, dmask = sparse_clouds
    if not masked:
        smask = np.ones_like(smask)
        dmask = np.ones_like(dmask)
    W, axis = jnn.auto_nn_window(src, dst, RADIUS, axis=2)
    assert W < -(-dst.shape[0] // 1024), "workload must exercise windows"
    args = (RADIUS, j(smask), j(dmask))
    jw_d, jw_i = jnn.nn_distance_radius(j(src), j(dst), *args,
                                        window_chunks=W, axis=axis,
                                        with_index=True, interpret=True)
    jf_d, jf_i = jnn.nn_distance(j(src), j(dst), j(smask), j(dmask),
                                 with_index=True)
    before = COUNTS["launches.otslam_nn_window"]
    td, ti = tnn.nn_distance_radius(t(src), t(dst), RADIUS, t(smask),
                                    t(dmask), window_chunks=W, axis=axis,
                                    with_index=True)
    assert COUNTS["launches.otslam_nn_window"] == before  # CPU: plain one
    td, ti = td.numpy(), ti.numpy()
    best, gap = nn_gap(src, dst, dmask)
    inl = smask & (best < RADIUS)
    assert 0.2 < inl.mean() < 0.8
    clear = inl & (gap > 1e-6)
    for jd, ji in ((jw_d, jw_i), (jf_d, jf_i)):
        jd, ji = np.asarray(jd), np.asarray(ji)
        np.testing.assert_array_equal(ti[clear], ji[clear])
        np.testing.assert_allclose(td[clear], jd[clear], rtol=1e-6)
    # beyond the radius only the lower bound holds
    out = smask & ~inl
    assert (td[out] >= best[out] - 1e-6).all()
    assert (td[out] >= RADIUS - 1e-6).all()
    assert (td[~smask] == 0).all() and (ti[~smask] == 0).all()


def test_windowed_plain_version_against_full_scan(sparse_clouds):
    """The plain K4 equals the plain K3 on every in-radius row (same d^2
    bits, same lowest index), including exact duplicate destinations; an
    unsorted destination scans every chunk and so equals K3 everywhere."""
    src, dst, _, dmask = sparse_clouds
    # 100 exact duplicates, kept sorted: the lowest index wins the tie
    dst = np.concatenate([dst[:-100], dst[200:300]])
    order = np.argsort(dst[:, 2], kind="stable")
    dst, dmask = dst[order], dmask[order]
    src_t, dst_t, dm_t = t(src), t(dst), t(dmask)
    dstp, dmaskp, c0, c1 = tnn.window_ranges(src_t, dst_t, dm_t, RADIUS, 2)
    assert dstp.shape[0] % tnn.DST_CHUNK == 0
    assert int((c1 - c0).max()) < dstp.shape[0] // tnn.DST_CHUNK
    dw, iw = tnn.nn_min_windowed_torch(src_t, dstp, dmaskp, c0, c1)
    d3, i3 = tnn.nn_min_torch(src_t, dst_t, dm_t)
    inl = d3.sqrt() < RADIUS
    assert inl.any() and (~inl).any()
    assert torch.equal(dw[inl], d3[inl]) and torch.equal(iw[inl], i3[inl])
    assert bool((dw[~inl] >= d3[~inl]).all())
    perm = np.random.default_rng(2).permutation(len(dst))
    dstp, dmaskp, c0, c1 = tnn.window_ranges(src_t, dst_t[perm], dm_t[perm],
                                             RADIUS, 2)
    assert torch.all(c0 == 0) and torch.all(c1 == dstp.shape[0] // 1024)
    du, iu = tnn.nn_min_windowed_torch(src_t, dstp, dmaskp, c0, c1)
    d3u, i3u = tnn.nn_min_torch(src_t, dst_t[perm], dm_t[perm])
    assert torch.equal(du, d3u) and torch.equal(iu, i3u)
    # a window covering the whole destination routes to the full scan
    full = tnn.nn_distance_radius(src_t, dst_t, RADIUS, window_chunks=8)
    np.testing.assert_array_equal(full.numpy(),
                                  tnn.nn_distance(src_t, dst_t).numpy())


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def icp_clouds():
    """dst: the box lattice with normals; src: the lattice moved by the
    inverse of a few-mm motion, with 0.2 mm noise and 300 outliers 0.2 m
    off the surface (never inliers), shuffled; a src mask drops 5 %."""
    dst, nrm = lattice_box()
    T = small_motion()
    rng = np.random.default_rng(4)
    Ti = np.linalg.inv(T)
    src = dst.astype(np.float64) @ Ti[:3, :3].T + Ti[:3, 3]
    src += rng.normal(0, 0.0002, src.shape)
    out = dst[:300] + 0.2 * nrm[:300]
    src = np.concatenate([src, out]).astype(np.float32)
    src = src[rng.permutation(len(src))]
    smask = rng.random(len(src)) > 0.05
    return src, dst, nrm, smask, T


def assert_icp_matches(jres, tres):
    np.testing.assert_allclose(tres.transformation.numpy(),
                               np.asarray(jres.transformation), rtol=0,
                               atol=1e-5)
    assert float(tres.fitness) == float(jres.fitness)
    np.testing.assert_allclose(float(tres.inlier_rmse),
                               float(jres.inlier_rmse), rtol=1e-5)
    assert tres.iterations == int(jres.iterations)


@pytest.mark.parametrize("windowed", [False, True])
def test_icp_point_to_point_matches_jax(icp_clouds, windowed):
    src, dst, _, smask, T = icp_clouds
    W, axis = (jnn.auto_nn_window(src, dst, 0.05) if windowed else (0, 2))
    if windowed:
        assert 0 < W < -(-len(dst) // 1024)
    jres = jicp.icp_point_to_point(j(src), j(dst), threshold=0.05,
                                   src_mask=j(smask), max_iterations=30,
                                   nn_window=W, nn_axis=axis,
                                   nn_interpret=windowed)
    tres = ticp.icp_point_to_point(t(src), t(dst), threshold=0.05,
                                   src_mask=t(smask), max_iterations=30,
                                   nn_window=W, nn_axis=axis)
    assert_icp_matches(jres, tres)
    assert 0.85 < float(tres.fitness) < 0.99   # outliers stay out
    np.testing.assert_allclose(tres.transformation.numpy(), T, atol=2e-4)


@pytest.mark.parametrize("windowed", [False, True])
def test_icp_point_to_plane_matches_jax(icp_clouds, windowed):
    src, dst, nrm, smask, T = icp_clouds
    W, axis = (jnn.auto_nn_window(src, dst, 0.05) if windowed else (0, 2))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.0005, 0.0, -0.0005]
    jres = jicp.icp_point_to_plane(j(src), j(dst), j(nrm), threshold=0.05,
                                   init=j(init), src_mask=j(smask),
                                   max_iterations=15, nn_window=W,
                                   nn_axis=axis, nn_interpret=windowed)
    tres = ticp.icp_point_to_plane(t(src), t(dst), t(nrm), threshold=0.05,
                                   init=t(init), src_mask=t(smask),
                                   max_iterations=15, nn_window=W,
                                   nn_axis=axis)
    assert_icp_matches(jres, tres)
    np.testing.assert_allclose(tres.transformation.numpy(), T, atol=2e-4)


def test_umeyama_rotation_is_unique():
    """The rotation does not depend on the SVD's sign choices: R from H
    equals R from the same system with its axes flipped."""
    rng = np.random.default_rng(8)
    p = rng.normal(size=(500, 3)).astype(np.float32)
    T = small_motion(rot=(0.3, -0.2, 0.5), trans=(0.1, 0.2, -0.1))
    q = (p @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    w = (rng.random(500) > 0.2).astype(np.float32)
    Rj, tj = jicp._umeyama_rt(j(p), j(q), j(w))
    Rt, tt = ticp._umeyama_rt(t(p), t(q), t(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), T[:3, :3], atol=1e-5)


# ---------------------------------------------------------------------------
# SE(3) maps and the pose graph
# ---------------------------------------------------------------------------

def test_exp_log_se3_match_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (64, 6)).astype(np.float32)
    xi[:16, :3] *= 1e-5                     # the small-angle branches
    xi[16] = 0.0
    je = np.asarray(jpg.exp_se3(j(xi)))
    te = tpg.exp_se3(t(xi)).numpy()
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpg.log_se3(t(je)).numpy(),
                               np.asarray(jpg.log_se3(j(je))), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tpg.log_se3(t(je)).numpy(), xi, atol=2e-6)
    # forward-mode derivatives at the identity are finite (branch guards)
    jac = torch.func.jacfwd(lambda x: tpg.log_se3(tpg.exp_se3(x)))(
        torch.zeros(6))
    np.testing.assert_allclose(jac.numpy(), np.eye(6), atol=1e-6)


def ring_graph(n=10, seed=3):
    """Poses on a circle, drifted chain edges and one loop edge."""
    rng = np.random.default_rng(seed)
    gt = np.stack([np.asarray(jpg.exp_se3(j(np.array(
        [0, 0, 2 * np.pi * k / n, np.cos(2 * np.pi * k / n),
         np.sin(2 * np.pi * k / n), 0.1], np.float32)))) for k in range(n)])
    ei = list(range(n - 1)) + [0]
    ej = list(range(1, n)) + [n - 1]
    Z = np.stack([np.linalg.inv(gt[a]) @ gt[b]
                  for a, b in zip(ei, ej)]).astype(np.float32)
    noisy = gt.copy()
    for k in range(1, n):
        step = np.asarray(jpg.exp_se3(j(rng.normal(0, 0.03, 6)
                                        .astype(np.float32))))
        noisy[k] = noisy[k - 1] @ Z[k - 1] @ step
    w = np.array([1.0] * (n - 1) + [2.0], np.float32)
    return noisy.astype(np.float32), np.array(ei), np.array(ej), Z, w, gt


def test_optimize_pose_graph_matches_jax():
    poses, ei, ej, Z, w, gt = ring_graph()
    jr = jpg.optimize_pose_graph(j(poses), j(ei.astype(np.int32)),
                                 j(ej.astype(np.int32)), j(Z), j(w))
    tr = tpg.optimize_pose_graph(t(poses), t(ei), t(ej), t(Z), t(w))
    np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tr.residual_rmse),
                               float(jr.residual_rmse), atol=1e-6)
    np.testing.assert_allclose(float(tr.initial_rmse),
                               float(jr.initial_rmse), rtol=1e-5)
    assert float(tr.residual_rmse) < 0.2 * float(tr.initial_rmse)
    # weight-0 padding (as the JAX package pads for its jit cache, with an
    # all-zero Z) leaves the poses unchanged
    pad = 6
    zero = np.zeros((pad, 4, 4), np.float32)
    tp = tpg.optimize_pose_graph(
        t(poses), t(np.concatenate([ei, np.zeros(pad, np.int64)])),
        t(np.concatenate([ej, np.zeros(pad, np.int64)])),
        t(np.concatenate([Z, zero])),
        t(np.concatenate([w, np.zeros(pad, np.float32)])))
    np.testing.assert_allclose(tp.poses.numpy(), tr.poses.numpy(), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# TSDF sampling and frame-to-model tracking
# ---------------------------------------------------------------------------

VOL = dict(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 32),
           origin=(0.86, -0.14, -0.02))


@pytest.fixture(scope="module")
def fused():
    """A block volume the JAX package fused from 8 frames, the port's copy
    of it, and one more frame's camera points + pose."""
    depths, colors, exts = capture(9)
    jvol = jtb.integrate_frames_sparse(
        jtb.make_block_volume(JCfg(**VOL)), j(depths[:8]), j(colors[:8]),
        j(exts[:8]), J_SMALL, max_active=256)
    tvol = ttb.BlockTSDFVolume.from_numpy(
        jvol.tsdf, jvol.weight, jvol.color, jvol.created, jvol.origin,
        jvol.voxel_size, jvol.sdf_trunc, jvol.grid_blocks, device="cpu")
    from otslam_tpu.pipeline.refine import _frame_points
    pts, mask = _frame_points(j(depths[8]), J_SMALL, stride=4)
    return jvol, tvol, np.asarray(pts), np.asarray(mask), exts[8]


def test_sample_tsdf_trilinear_matches_jax(fused):
    jvol, tvol, pts, mask, ext = fused
    pose = np.linalg.inv(ext.astype(np.float64))
    world = (pts @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    rng = np.random.default_rng(1)
    lo = np.asarray(VOL["origin"])
    hi = lo + np.asarray(VOL["dims"]) * VOL["voxel_size"]
    probe = np.concatenate([world, rng.uniform(lo - 0.1, hi + 0.1,
                                               (2000, 3))]).astype(np.float32)
    # jitted, as the JAX tracker runs it (XLA folds the voxel coordinate
    # into one fused multiply-add, which the port reproduces)
    js, jg, jv = jax.jit(jtrack.sample_tsdf_trilinear)(jvol, j(probe))
    ts, tg, tv = ttrack.sample_tsdf_trilinear(tvol, t(probe))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().mean() > 0.3
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    # the gradient is in 1/m (sdf units over a 2 cm voxel)
    np.testing.assert_allclose(tg.numpy() * VOL["voxel_size"],
                               np.asarray(jg) * VOL["voxel_size"], rtol=0,
                               atol=1e-6)


def track_both(jvol, tvol, pts, mask, ext):
    pose = np.linalg.inv(ext.astype(np.float64))
    prior = (small_motion(rot=(0.01, -0.008, 0.012),
                          trans=(0.01, -0.008, 0.006)) @ pose)
    prior = prior.astype(np.float32)
    jres = jtrack.track_frame_to_tsdf(jvol, j(pts), j(mask), j(prior),
                                      max_iterations=15)
    tres = ttrack.track_frame_to_tsdf(tvol, t(pts), t(mask), t(prior),
                                      max_iterations=15)
    return jres, tres, pose


def test_track_frame_to_tsdf_matches_jax(fused):
    jvol, tvol, pts, mask, ext = fused
    jres, tres, pose = track_both(jvol, tvol, pts, mask, ext)
    np.testing.assert_allclose(tres.transformation.numpy(),
                               np.asarray(jres.transformation), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(tres.rmse), float(jres.rmse),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(tres.inlier_fraction),
                               float(jres.inlier_fraction), atol=1e-6)
    # and it tracks: the prior's ~1.5 cm error shrinks
    assert np.abs(tres.transformation.numpy()[:3, 3]
                  - pose[:3, 3]).max() < 0.005


def test_track_on_a_jax_volume_file(fused, tmp_path):
    """The state carried across: a block volume the JAX package saved,
    read by the port's volume_io, tracks as the JAX volume does."""
    jvol, _, pts, mask, ext = fused
    path = str(tmp_path / "vol.npz")
    jvio.save_volume(path, jvol)
    tvol = tvio.load_volume(path, device="cpu")
    jres, tres, _ = track_both(jvio.load_volume(path), tvol, pts, mask, ext)
    np.testing.assert_allclose(tres.transformation.numpy(),
                               np.asarray(jres.transformation), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# grid, LiDAR and scan localization
# ---------------------------------------------------------------------------

LIDAR = LidarConfig(num_beams=360)
ANGLES = np.linspace(0, 2 * np.pi, 360, endpoint=False).astype(np.float32)
TRUE = (0.6, -1.1, 0.8)


@pytest.fixture(scope="module")
def grids():
    return j_room().occupancy_grid(0.05), cardboard_room().occupancy_grid(0.05)


def test_grid_and_lidar_match_jax(grids):
    jg, tg = grids
    np.testing.assert_array_equal(tg.data, np.asarray(jg.data))
    assert tg.origin == jg.origin and tg.resolution == jg.resolution
    np.testing.assert_array_equal(tg.occupied_world_points(),
                                  jg.occupied_world_points())
    np.testing.assert_array_equal(tg.to_pgm(), jg.to_pgm())
    back = OccupancyGrid2D.from_pgm(tg.to_pgm(), 0.05, tg.origin)
    np.testing.assert_array_equal(back.data, tg.data)
    xy = np.random.default_rng(0).uniform(-5.2, 5.2, (500, 2)).astype(
        np.float32)
    for a, b in zip(tg.world_to_cell(xy), jg.world_to_cell(xy)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for pose in (TRUE, (-2.0, 1.0, -0.4), (0.0, 0.0, 0.0)):
        js = np.asarray(j_render_lidar(j_room(), *pose, j(ANGLES),
                                       LIDAR.range_min, LIDAR.range_max))
        ts = render_lidar(cardboard_room(), *pose, ANGLES, LIDAR.range_min,
                          LIDAR.range_max, device="cpu").numpy()
        np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
        fin = np.isfinite(js)
        np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=1e-5)


def scan(pose=TRUE):
    return np.asarray(j_render_lidar(j_room(), *pose, j(ANGLES),
                                     LIDAR.range_min, LIDAR.range_max))


def test_localize_matches_jax(grids):
    jg, tg = grids
    prior = (TRUE[0] + 0.12, TRUE[1] - 0.08, TRUE[2] + 0.07)
    jr = JLocalizer(jg).localize(scan(), ANGLES, prior)
    tr = ScanLocalizer(tg, device="cpu").localize(scan(), ANGLES, prior)
    np.testing.assert_allclose([tr.x, tr.y, tr.yaw], [jr.x, jr.y, jr.yaw],
                               rtol=0, atol=1e-4)
    assert tr.fitness == pytest.approx(jr.fitness, abs=1e-6)
    assert np.hypot(tr.x - TRUE[0], tr.y - TRUE[1]) < 0.04
    assert abs(tr.yaw - TRUE[2]) < 0.02 and tr.fitness > 0.9


def test_localize_degraded_inputs_return_the_prior(grids):
    _, tg = grids
    blank = OccupancyGrid2D(np.full((64, 64), 205, np.uint8), 0.05,
                            (0.0, 0.0))
    res = ScanLocalizer(blank, device="cpu").localize(np.full(360, 2.0, np.float32),
                                        ANGLES, (1.0, -2.0, 0.3))
    assert (res.x, res.y, res.yaw, res.fitness) == (1.0, -2.0, 0.3, 0.0)
    res = ScanLocalizer(tg, device="cpu").localize(np.full(360, np.inf, np.float32),
                                     ANGLES, (0.5, 0.5, 0.0))
    assert (res.x, res.y, res.yaw, res.fitness) == (0.5, 0.5, 0.0, 0.0)
    # a wrong-basin fit never moves the pose beyond max_correction
    prior = (3.5, 3.5, 2.0)
    res = ScanLocalizer(tg, max_correction=0.5, device="cpu").localize(
        scan((0.0, 0.0, 0.0)), ANGLES, prior)
    assert np.hypot(res.x - prior[0], res.y - prior[1]) <= 0.5 + 1e-6


def test_localize_with_dropped_beams(grids):
    _, tg = grids
    ranges = scan().copy()
    ranges[::3] = np.inf                    # a third of the beams drop out
    prior = (TRUE[0] + 0.1, TRUE[1] - 0.06, TRUE[2] + 0.05)
    res = ScanLocalizer(tg, device="cpu").localize(t(ranges), t(ANGLES), prior)
    assert np.hypot(res.x - TRUE[0], res.y - TRUE[1]) < 0.05
    assert abs(res.yaw - TRUE[2]) < 0.03
